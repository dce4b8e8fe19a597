"""The port's roofline (``repro_torch.roofline``) against the reference's.

* ``model_flops`` equals ``repro.roofline.model_flops`` for every
  architecture and shape; ``RooflineReport``'s properties and ``to_dict``,
  and ``collective_wire_bytes``, equal the reference's on the same inputs
  under the reference's own ``Hardware`` values (a TPU v5e's).
* The walk (``roofline/cost.py``): its regions sum to its totals; a
  reduced model's training step gives the same ops, bytes, FLOPs and peak
  of live bytes on ``meta`` as on the CPU; each hand-written kernel's
  ``meta`` route charges its cost function and launches nothing.
* The per-rank matrix-product FLOPs of reduced qwen2-7b's and Big LSTM's
  training step on a (2, 2) grid (one rank, walked under a ``DryGroup``)
  against the dot FLOPs of the reference's compiled program on an
  Auto-axis (2, 2) mesh (``repro.roofline.hlo_cost``), the reference run
  in a subprocess over 4 host devices.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import (ARCHS, SHAPES, OptimizerConfig, ShapeConfig,
                                 get_arch, reduced)
from repro_torch.launch.steps import build_train_programs
from repro_torch.models import build_model
from repro_torch.roofline import (Hardware, RooflineReport,
                                  collective_wire_bytes, model_flops,
                                  region_table, step_cost)
from repro_torch.tree import tree_map

REPO = Path(__file__).resolve().parents[1]

#: the reference's Hardware defaults (a TPU v5e), which the equalities
#: below are held under
V5E = dict(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
           dcn_bw=6.25e9, hbm_bytes=16e9)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_flops_equal_reference(shape):
    from repro.configs import get_arch as ref_arch, get_shape as ref_shape
    from repro.roofline import model_flops as ref_model_flops
    for arch in sorted(ARCHS):
        assert model_flops(get_arch(arch), SHAPES[shape]) == \
            ref_model_flops(ref_arch(arch), ref_shape(shape)), arch
        assert get_arch(arch).active_param_count() == \
            ref_arch(arch).active_param_count(), arch


REPORTS = [
    dict(hlo_flops=3.1e14, hlo_bytes=2.2e12, collective_bytes=4.0e10,
         cross_pod_bytes=0.0, model_flops_total=5.0e16, n_chips=256),
    dict(hlo_flops=1.0e12, hlo_bytes=9.0e12, collective_bytes=1.0e9,
         cross_pod_bytes=3.0e9, model_flops_total=2.0e15, n_chips=512),
    dict(hlo_flops=0.0, hlo_bytes=0.0, collective_bytes=0.0,
         cross_pod_bytes=0.0, model_flops_total=0.0, n_chips=1),
]


@pytest.mark.parametrize("case", range(len(REPORTS)))
def test_report_equals_reference(case):
    from repro.roofline.analysis import Hardware as RefHardware
    from repro.roofline.analysis import RooflineReport as RefReport
    kw = dict(REPORTS[case], arch="qwen2-7b", shape="train_4k",
              mesh="16x16", collectives={"all-gather": 3.0e10,
                                         "all-reduce": 5.0e9},
              collective_counts={"all-gather": 24, "all-reduce": 2},
              bytes_per_device=7.5e9)
    ref = RefReport(**kw, hw=RefHardware(**V5E))
    mine = RooflineReport(**kw, hw=Hardware(**V5E))
    for prop in ("t_compute", "t_memory", "t_collective", "dominant",
                 "model_flops_per_chip", "useful_flop_ratio", "step_time",
                 "mfu"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.to_dict() == ref.to_dict()
    assert mine.summary() == ref.summary()


def test_wire_bytes_equal_reference():
    from repro.roofline import collective_wire_bytes as ref_wire
    for col in ({}, {"all-reduce": 100}, {"all-gather": 7, "all-to-all": 9},
                {"all-gather": 1.5e9, "all-reduce": 2.5e8,
                 "reduce-scatter": 3, "collective-permute": 11}):
        assert collective_wire_bytes(col) == ref_wire(col)


def _train_step(arch, device, *, kernels=False, workers=2):
    cfg = reduced(get_arch(arch))
    oc = OptimizerConfig(name="local_adaalter", H=4, compression="int8",
                         use_kernels=kernels)
    progs = build_train_programs(cfg, oc, n_workers=workers, device=device)
    base = build_model(cfg).init(torch.Generator().manual_seed(0))
    params, state = progs.init_fn(0, base=tree_map(lambda t: t.to(device),
                                                   base))
    tok = torch.zeros((workers, 4, 16), dtype=torch.int32, device=device)
    return progs, params, state, {"tokens": tok, "labels": tok}


def test_regions_sum_to_totals():
    progs, p, s, batch = _train_step("qwen2-7b", "meta", kernels=True)
    cost = step_cost(progs.sync_step, p, s, batch)
    tab = region_table(cost, peak_flops=989e12, hbm_bw=3.35e12, top=0)
    assert tab["n_regions"] == len(tab["regions"]) == len(cost.regions)
    assert sum(r["flops"] for r in tab["regions"]) == pytest.approx(
        tab["flops"], rel=1e-12)
    assert sum(r["bytes"] for r in tab["regions"]) == pytest.approx(
        tab["bytes"], rel=1e-12)
    kinds = {r["opcode"] for r in tab["regions"]}
    assert kinds == {"aten", "kernel"}
    kern = {r["region"]: r["trip"] for r in tab["regions"]
            if r["opcode"] == "kernel"}
    assert kern == {"adaalter_update": progs.n_payload_leaves,
                    "fused_ef": 2 * progs.n_payload_leaves}
    cut = region_table(cost, peak_flops=989e12, hbm_bw=3.35e12, top=3)
    assert len(cut["regions"]) == 3 and cut["flops"] == tab["flops"]
    assert cut["dropped_optimal_s"] == pytest.approx(sum(
        r["optimal_s"] for r in tab["regions"][3:]))


@pytest.mark.parametrize("arch", ["qwen2-7b", "biglstm", "hymba-1.5b"])
def test_walk_same_on_meta_and_cpu(arch):
    """The plain step (no kernels) walked on meta tensors and on CPU
    tensors: the same aten ops, counts, FLOPs, bytes and peak."""
    got = {}
    for dev in ("meta", "cpu"):
        progs, p, s, batch = _train_step(arch, dev)
        got[dev] = step_cost(progs.sync_step, p, s, batch)
    meta, cpu = got["meta"], got["cpu"]
    assert meta.ops == cpu.ops
    assert meta.flops == cpu.flops and meta.bytes == cpu.bytes
    assert meta.peak_bytes == cpu.peak_bytes > meta.resident_bytes > 0
    assert meta.matmul_flops > 0.5 * meta.flops


def _kernel_calls():
    """(name, call on meta tensors, its cost function's charge, counter)
    of every hand-written kernel."""
    from repro_torch.kernels import adaalter_update as au
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import sync_fused as sf

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    scal = m(2)
    n, nb = 3 * 5000, 40
    return [
        ("adaalter_update", lambda: au.fused_update(
            m(3, 5000, dtype=torch.bfloat16), m(3, 5000, dtype=torch.bfloat16),
            m(3, 5000), m(3, 5000), scal), au.update_cost(n, 2), au.launches),
        ("flat_fused_update", lambda: au.flat_fused_update(
            m(2, 1024), m(2, 1024), m(2, 1024), m(2, 1024), scal, m(8, 1)),
         au.flat_update_cost(2048), au.flat_launches),
        ("fused_ef", lambda: sf.fused_ef_leaf(
            m(3, 5000), m(3, 5000), batch_ndim=1, codes=True),
         sf.ef_cost(n, 4, codes=True), sf.launches),
        ("flat_ef", lambda: sf.flat_ef_blocks(m(nb, 256), m(nb, 256),
                                              m(nb, 1), m(nb, 1)),
         sf.ef_cost(nb * 256, 4), sf.flat_launches),
        ("quantize_blocks", lambda: qz.quantize_blocks(
            m(nb, 256, dtype=torch.bfloat16)), qz.quantize_cost(nb, 2),
         qz.quantize_launches),
        ("dequantize_blocks", lambda: qz.dequantize_blocks(
            m(nb, 256, dtype=torch.int8), m(nb, 1)), qz.dequantize_cost(nb),
         qz.dequantize_launches),
        ("ssd_scan", lambda: ssd.ssd_scan(
            m(2, 4, 64, 8, 64), m(2, 4, 64, 16), m(2, 4, 64, 16),
            m(2, 4, 64, 8)), ssd.ssd_cost(2, 4, 64, 8, 64, 16, 4),
         ssd.launches),
    ]


@pytest.mark.parametrize("which", range(7))
def test_kernel_meta_route_charges_its_cost(which):
    name, call, want, counter = _kernel_calls()[which]
    before = counter.n
    cost = step_cost(call)
    assert counter.n == before                       # nothing launched
    assert cost.kernels == {name: 1}
    region = cost.regions[name]
    assert region.opcode == "kernel" and region.trip == 1
    assert region.bytes == want["bytes"]
    assert region.flops == want["operations"]
    outs = cost.result if isinstance(cost.result, tuple) else (cost.result,)
    flat = [t for o in outs for t in (o if isinstance(o, tuple) else (o,))]
    assert flat and all(t.device.type == "meta" for t in flat)


def test_ssd_cost_is_the_tables_bound():
    """At mamba2-370m's scoring shape the cost function gives the bound
    PERF.md's kernel table states for row 7 (0.118 ms, by operations)."""
    from repro_torch.kernels.ssd_scan import ssd_cost
    c = ssd_cost(8, 32, 64, 32, 64, 128, 4)
    assert c["bound_by"] == "operations"
    assert c["bound_ms"] == pytest.approx(0.118, abs=5e-4)


REF_DOTS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.launch.mesh import resolve_plan
from repro.launch.steps import build_train_programs, train_batch_specs
from repro.roofline.hlo_cost import HloCostModel

class DotCost(HloCostModel):
    # the trip-count-aware walk, counting dots (and convolutions) alone
    def _op_flops(self, op):
        if op.opcode in ("dot", "convolution"):
            return super()._op_flops(op)
        return 0.0

out, spec = sys.argv[1], json.loads(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
strip = lambda t: jax.tree_util.tree_map(
    lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), t)
res = {}
for arch in spec["archs"]:
    cfg = reduced(get_arch(arch))
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["bs"],
                        kind="train")
    plan = resolve_plan(cfg, mesh, optimizer="local_adaalter")
    with mesh:
        progs = build_train_programs(cfg, shape,
                                     OptimizerConfig(name="local_adaalter"),
                                     mesh, plan)
        params, state = jax.eval_shape(progs.init_fn, jax.random.PRNGKey(0))
        batch = train_batch_specs(cfg, shape, progs.n_workers)
        comp = progs.local_step.lower(strip(params), strip(state),
                                      batch).compile()
    res[arch] = DotCost(comp.as_text()).entry_cost().flops
json.dump(res, open(out, "w"))
"""

#: the walk's matrix products against the compiled program's dots. The
#: two count the same products at the same per-device shapes (qwen2-7b's
#: agree exactly); XLA lowers a few outer products (contracted size 1) of
#: the Big LSTM's step as dots, which the port computes elementwise: 2^19
#: FLOPs, 0.42% of its dots at this size
DOT_RTOL = 1e-2


def test_matmul_flops_against_reference_dots(tmp_path):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import resolve_plan
    spec = {"archs": ["qwen2-7b", "biglstm"], "seq": 32, "bs": 8}
    out = tmp_path / "dots.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", REF_DOTS, str(out),
                    json.dumps(spec)], check=True, env=env, timeout=600)
    ref = json.loads(out.read_text())
    grid = {"data": 2, "model": 2}
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["bs"],
                        kind="train")
    for arch in spec["archs"]:
        cfg = reduced(get_arch(arch))
        plan = resolve_plan(cfg, grid, optimizer="local_adaalter")
        walks, *_ = dryrun.train_walks(
            cfg, shape, OptimizerConfig(name="local_adaalter"), grid, plan,
            variants=("local_step",))
        cost, counters, _ = walks["local_step"]
        assert counters["tp"]["n"] > 0                 # TP over model
        assert cost.matmul_flops == pytest.approx(ref[arch], rel=DOT_RTOL)
        assert cost.matmul_flops <= ref[arch]
    assert dataclasses.asdict(plan)["local_axes"] == ("data",)

"""The port's dry-run (``repro_torch.launch.dryrun``) against the reference.

* The plans: the port's ``resolve_plan`` and ``serve_plan`` on the
  production grids, (16, 16) and (2, 16, 16) with ``pod``, equal the
  reference's on meshes of those shapes, for every architecture and for
  Local AdaAlter and AdaAlter; ``train_batch_specs`` gives the
  reference's shapes and dtypes.
* A rank's parameter bytes on (16, 16): for every full-size config, every
  rank's parts from the port's specs equal the parts of the reference's
  ``param_shardings`` on an Auto-axis abstract (16, 16) mesh (the
  reference's tree from ``jax.eval_shape``).
* ``core.comm.DryGroup``: rank 0 of a (2, 2) grid played on ``meta``
  records the collectives, counts and bytes (``comm.wire``, ``comm.tp``,
  ``comm.side``, ``comm.shard_gather``) of a real 2 x 2 gloo CPU run of
  reduced qwen2-7b, for its FSDP + TP training step and its TP decode
  step (one ``torch.distributed.run`` launch of 4 ranks).
* A full-size record (qwen2-7b ``decode_32k``) has every key of the
  reference's record, and the CLI writes its ``--out``, ``--trace`` and
  ``--metrics`` files.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, OptimizerConfig, ShapeConfig, get_arch
from repro_torch.configs import reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import resolve_plan
from repro_torch.launch.serving import serve_plan

REPO = Path(__file__).resolve().parents[1]
GRIDS = {"single": dryrun.SINGLE, "multi": dryrun.MULTI}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_plans_equal_reference(grid):
    from repro.configs import get_arch as ref_arch
    from repro.launch.mesh import resolve_plan as ref_resolve
    from repro.launch.serving import serve_plan as ref_serve
    g = GRIDS[grid]
    mesh = types.SimpleNamespace(shape=dict(g))
    for arch in sorted(ARCHS):
        for opt in ("local_adaalter", "adaalter"):
            assert dataclasses.asdict(resolve_plan(get_arch(arch), g,
                                                   optimizer=opt)) == \
                dataclasses.asdict(ref_resolve(ref_arch(arch), mesh,
                                               optimizer=opt)), (arch, opt)
        assert dataclasses.asdict(serve_plan(get_arch(arch), g)) == \
            dataclasses.asdict(ref_serve(ref_arch(arch), mesh)), arch
    # only phi3.5-moe's Local AdaAlter plan makes the pods workers
    pods = [a for a in ARCHS if resolve_plan(get_arch(a), dryrun.MULTI)
            .local_axes == ("pod",)]
    assert pods == ["phi3.5-moe-42b-a6.6b"]


@pytest.mark.parametrize("workers", [0, 16, 32])
def test_train_batch_specs_equal_reference(workers):
    from repro.configs import get_arch as ref_arch, get_shape as ref_shape
    from repro.launch.steps import train_batch_specs as ref_specs
    from repro_torch.configs import get_shape
    from repro_torch.launch.steps import train_batch_specs
    for arch in sorted(ARCHS):
        mine = train_batch_specs(get_arch(arch), get_shape("train_4k"),
                                 workers)
        ref = ref_specs(ref_arch(arch), ref_shape("train_4k"), workers)
        assert sorted(mine) == sorted(ref), arch
        for k in ref:
            assert tuple(mine[k].shape) == tuple(ref[k].shape), (arch, k)
            assert str(mine[k].dtype).replace("torch.", "") == \
                str(ref[k].dtype), (arch, k)


def _ref_rank_bytes(arch):
    """Per-rank parameter bytes of the reference's specs on an abstract
    Auto-axis (16, 16) mesh, and whether every leaf splits evenly."""
    import jax
    from jax.sharding import AbstractMesh, AxisType
    from repro.configs import get_arch as ref_arch
    from repro.launch.mesh import resolve_plan as ref_resolve
    from repro.models import build_model
    from repro.sharding.partition import ShardingRules
    from repro.sharding.specs import param_shardings
    mesh = AbstractMesh((16, 16), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)
    cfg = ref_arch(arch)
    tree = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    shardings = param_shardings(ShardingRules(mesh, ref_resolve(cfg, mesh)),
                                tree)
    total = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(shardings)):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        n = 1
        for dim, e in zip(leaf.shape, spec):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            parts = math.prod(mesh.shape[a] for a in axes)
            assert dim % parts == 0
            n *= dim // parts
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rank_param_bytes_equal_reference_specs(arch):
    cfg = get_arch(arch)
    plan = resolve_plan(cfg, dryrun.SINGLE)
    per_rank = dryrun.rank_param_bytes(cfg, plan, dryrun.SINGLE,
                                       workers=False)
    assert len(per_rank) == 256
    assert set(per_rank) == {_ref_rank_bytes(arch)}


RANKS_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro_torch.core import comm
from repro_torch.launch import mesh
from repro_torch.launch.serving import build_serve_programs, serve_plan
from repro_torch.launch.steps import build_train_programs
from repro_torch.models import build_model

torch.set_num_threads(1)
spec = json.load(open(sys.argv[1]))
full = get_arch("qwen2-7b")
cfg = dataclasses.replace(reduced(full), param_dtype="float32")
grid = {"data": 2, "model": 2}
plan = mesh.resolve_plan(full, grid, optimizer="adaalter")
group, dev = mesh.init_ranks("gloo", "cpu", timeout_s=60, grid=grid,
                             fsdp_axes=plan.fsdp_axes)
names = ("wire", "tp", "side", "shard_gather")

def reset():
    for n in names:
        getattr(comm, n).reset()

def snap():
    return {n: {"n": getattr(comm, n).n, "bytes": getattr(comm, n).bytes}
            for n in names}

base = build_model(cfg).init(torch.Generator().manual_seed(0))
res = {}
progs = build_train_programs(cfg, OptimizerConfig(name="adaalter"),
                             n_workers=1, device="cpu", group=group,
                             plan=plan)
params, state = progs.init_fn(0, base=base)
rows = spec["bs"] // 2
tok = torch.randint(0, cfg.vocab_size, (rows, spec["seq"]),
                    generator=torch.Generator().manual_seed(1),
                    dtype=torch.int32)
reset()
progs.local_step(params, state, {"tokens": tok, "labels": tok})
res["train"] = snap()

P, N, B = spec["prompt"], spec["new"], spec["batch"]
shape = ShapeConfig("decode_32k", seq_len=P + N, global_batch=B,
                    kind="decode")
sprogs = build_serve_programs(cfg, shape, group=group,
                              plan=serve_plan(full, grid))
parts = sprogs.param_parts(base)
n = sprogs.rows.stop - sprogs.rows.start
prompts = torch.randint(0, cfg.vocab_size, (n, P), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(2))
_, cache = sprogs.prefill(parts, {"tokens": prompts})
reset()
sprogs.decode_step(parts, cache, prompts[:, :1],
                   torch.full((n,), P, dtype=torch.int32))
res["decode"] = snap()
mesh.close_ranks()
if group.rank == 0:
    json.dump(res, open(sys.argv[2], "w"))
"""


def test_dry_group_records_the_real_collectives(tmp_path):
    spec = {"bs": 4, "seq": 16, "prompt": 8, "new": 4, "batch": 4}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    script = tmp_path / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    out = tmp_path / "real.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(script), str(tmp_path / "spec.json"),
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    real = json.loads(out.read_text())

    full = get_arch("qwen2-7b")
    cfg = dataclasses.replace(reduced(full), param_dtype="float32")
    grid = {"data": 2, "model": 2}
    plan = resolve_plan(full, grid, optimizer="adaalter")
    assert plan.fsdp_axes == ("data",) and plan.remat == "full"
    walks, *_ = dryrun.train_walks(
        cfg, ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["bs"],
                         kind="train"),
        OptimizerConfig(name="adaalter"), grid, plan,
        variants=("local_step",))
    cost, counters, log = walks["local_step"]
    assert counters == real["train"]
    assert counters["wire"]["n"] > 0 and counters["tp"]["n"] > 0
    assert len(log) == sum(c["n"] for c in counters.values())
    assert cost.coll_counts["all-gather"] + cost.coll_counts[
        "all-to-all"] == len(log)
    assert {e["kind"] for e in log} == {"all-gather", "all-to-all"}
    assert not any(e["cross_pod"] for e in log)

    shape = ShapeConfig("decode_32k", seq_len=spec["prompt"] + spec["new"],
                        global_batch=spec["batch"], kind="decode")
    _, cost, counters, log, *_ = dryrun.serve_walk(
        cfg, shape, grid, serve_plan(full, grid))
    assert counters == real["decode"]
    assert counters["tp"]["n"] > 0
    assert {tuple(e["axes"]) for e in log} == {("model",)}


def test_dry_group_folds_pods():
    """On (2, 16, 16) a rank's data sub-group spans both pods (its
    collectives cross pods), its model sub-group one."""
    plan = resolve_plan(get_arch("llama3-405b"), dryrun.MULTI)
    group = dryrun.dry_group(dryrun.MULTI, dryrun.fold_plan(plan), rank=17)
    assert group.world == 512 and group.layout.workers == 32
    data = group.along(("data",))
    model = group.along(("model",))
    assert data.world == 32 and data.cross_pod and data.axes == ("pod",
                                                                  "data")
    assert model.world == 16 and not model.cross_pod
    assert model.axes == ("model",)
    assert data.global_rank == model.global_rank == 17


def test_full_size_record_has_reference_keys():
    from repro.roofline.analysis import RooflineReport as RefReport
    res = dryrun.dryrun_pair("qwen2-7b", "decode_32k", multi_pod=False,
                             verbose=False)
    (rec,) = res["records"]
    ref_keys = set(RefReport("a", "s", "m", 1, 0.0, 0.0, 0.0, {}, {},
                             0.0).to_dict())
    ref_keys |= {"variant", "plan", "cache_len", "window", "compile_s"}
    assert ref_keys <= set(rec)
    assert rec["variant"] == "decode_step" and rec["cache_len"] == 32768
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    mem = rec["memory"]            # in place of memory_analysis()
    assert set(mem["resident_bytes"]) == {"params", "caches"}
    assert mem["walk_peak_bytes"] >= mem["resident_total"] > 0
    assert mem["fits"] is True and mem["hbm_bytes"] == 80e9
    assert rec["hlo_flops_per_chip"] > 0 and rec["xla_flops"] is None
    assert rec["counters"]["tp"]["n"] > 0
    assert rec["collective_counts"]["all-gather"] == \
        rec["counters"]["tp"]["n"] + rec["counters"]["side"]["n"]


def test_cli_writes_out_trace_metrics(tmp_path, capsys):
    out, trace, metrics = (tmp_path / "out", tmp_path / "t.json",
                           tmp_path / "m.jsonl")
    dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(out), "--trace", str(trace),
                 "--metrics", str(metrics)])
    assert "dry-run complete: 2 ok, 0 failed" in capsys.readouterr().out
    files = sorted(p.name for p in out.iterdir())
    assert files == ["mamba2-370m_decode_32k_multi.json",
                     "mamba2-370m_decode_32k_single.json"]
    rec = json.loads((out / files[0]).read_text())
    assert rec["mesh"] == "2x16x16" and rec["records"][0]["variant"] == \
        "decode_step"
    from repro_torch.trace import Trace
    t = Trace.load(str(trace))
    assert t.meta["kind"] == "dryrun"
    assert {s.name for s in t.spans} == {"eval", "local_step"}
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows if "step" in r] == [0, 1]   # a pair each
    assert (tmp_path / "m.prom").exists()

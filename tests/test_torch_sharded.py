"""The sharded flat plane on a (workers × shards) grid of gloo ranks.

Groups of 2 ranks (a 1 × 2 grid) and 4 ranks (2 × 2) on the CPU
(``torch.distributed.run --standalone``) train reduced Big LSTM over the
flat plane, each rank holding one sub-plane of its worker's planes
(``launch/steps.py::_flat_programs``); one subprocess drives the JAX
package's ``train_loop`` on Auto-axis ``(1, 1)`` and ``(2, 2)``
``("data", "model")`` meshes over 4 host devices, the reference's sharded
plane. What must hold (the port's form of ``tests/test_flat_sharded.py``):

  * a sharded run equals the port's stacked flat run of as many workers
    bit for bit after 3 steps with a mid-window sync: losses, schedule,
    comm bytes, and every plane of the final state (the sharded plane's
    longer zero tail trimmed, and checked zero), for fp32, int8 with and
    without the kernels, int8 three-pass, and bf16;
  * the 2 × 2 runs match the reference's to LOSS_RTOL, schedules and comm
    bytes exactly;
  * a flat checkpoint restores across grids, (1, 1) → (2, 2) → (1, 1), in
    the middle of an adaptive window: the 2 × 2 leg equals the stacked
    2-worker leg bit for bit, and the chain the reference's chain;
  * each rank's round is one collective over its worker sub-group moving
    ``round_bytes_per_shard`` plus its share of the plane's padding, and
    each step one params gather over its shard sub-group.

Every spawned group runs under a subprocess timeout and opens its process
group with a 60 s timeout, so a hung rank fails its fixture, not the suite.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import (OptimizerConfig, ShapeConfig, SyncConfig,
                                 get_arch, reduced)
from repro_torch.core.flatspace import ALIGN, FlatSpace
from repro_torch.launch.train import train_loop
from repro_torch.sharding import GridLayout

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
VOCAB, SEQ, STEPS, H = 128, 16, 3, 2
GROUP_TIMEOUT = 240         # seconds a spawned group may take in all
GRIDS = ((1, 2), (2, 2))

# name: (SyncConfig kwargs, OptimizerConfig kwargs); flat, lr 0.5, H 2,
# warm-up 3 (the reference's pin), 4 sequences a worker
CASES = {
    "fp32": (dict(), dict()),
    "int8": (dict(compression="int8"), dict(use_kernels=True)),
    "int8_plain": (dict(compression="int8"), dict()),
    "int8_unfused": (dict(compression="int8", fused=False),
                     dict(use_kernels=True)),
    "bf16": (dict(compression="bf16"), dict()),
}
# the cross-grid chain: the reference pin's adaptive int8 run, global batch
# 4 on every grid, checkpoints at steps 3 and 6
CHAIN = (dict(compression="int8", policy="adaptive", threshold=0.02,
              h_min=2, h_max=8), dict(use_kernels=True, H=4,
                                      warmup_steps=2))
CHAIN_BATCH = 4


def _cfg():
    return reduced(get_arch("biglstm"), vocab=VOCAB)


def _opt(sync_kw, opt_kw):
    return OptimizerConfig.from_sync(SyncConfig(**sync_kw), **{
        "name": "local_adaalter", "lr": 0.5, "H": H, "warmup_steps": 3,
        "flat": True, **opt_kw})


def _shape(batch):
    return ShapeConfig("t", seq_len=SEQ, global_batch=batch, kind="train")


REF_SCRIPT = r"""
import json, os, sys, tempfile
# 4 host devices; one Eigen thread each (the suite runs beside it)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.launch.train import train_loop
from repro.models import build_model

out, spec = sys.argv[1], json.loads(sys.argv[2])
cfg = reduced(get_arch("biglstm"), vocab=spec["vocab"])
params0 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
leaves, _ = jax.tree_util.tree_flatten_with_path(params0)
np.savez(out + ".tmp.npz", **{jax.tree_util.keystr(k): np.asarray(v).view(np.uint16)
                              for k, v in leaves})
os.replace(out + ".tmp.npz", out + ".npz")      # the weights first

def mesh(w, s):
    return jax.make_mesh((w, s), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:w * s])

def shape(batch):
    return ShapeConfig("t", seq_len=spec["seq"], global_batch=batch,
                       kind="train")

def opt(sync_kw, opt_kw):
    return OptimizerConfig.from_sync(SyncConfig(**sync_kw), **opt_kw)

def result(r):
    return dict(losses=r.losses, sync_steps=r.sync_steps,
                n_workers=r.n_workers, start_step=r.start_step,
                comm_bytes_total=r.comm_bytes_total,
                comm_bytes_modeled=r.comm_bytes_modeled)

res = {"runs": {}, "chain": []}
for name, (sync_kw, opt_kw) in spec["cases"].items():
    r = train_loop(cfg, shape(spec["batch"]), opt(sync_kw, opt_kw),
                   steps=spec["steps"], seed=0, mesh=mesh(2, 2),
                   verbose=False)
    res["runs"][name] = result(r)
sync_kw, opt_kw = spec["chain"]
with tempfile.TemporaryDirectory() as d:
    for grid, steps in (((1, 1), 3), ((2, 2), 6), ((1, 1), 8)):
        r = train_loop(cfg, shape(spec["chain_batch"]), opt(sync_kw, opt_kw),
                       steps=steps, seed=0, mesh=mesh(*grid),
                       checkpoint_dir=d, checkpoint_every=3, verbose=False)
        res["chain"].append(result(r))
json.dump(res, open(out + ".json", "w"))
"""

# one process group runs every case of its grid in turn; rank 0 writes the
# results
RANKS_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import OptimizerConfig, ShapeConfig, SyncConfig, get_arch, reduced
from repro_torch.core import comm
from repro_torch.launch import mesh
from repro_torch.launch.train import train_loop

torch.set_num_threads(1)
# rows of the reduced model are chunked too (the CLI runs take the default)
comm.MEAN_CHUNK = 4096
spec = json.load(open(sys.argv[1]))
out = sys.argv[2]
workers, shards = spec["grid"]
group, dev = mesh.init_ranks("gloo", "cpu", timeout_s=60,
                             grid={"data": workers, "model": shards})
params0 = torch.load(spec["params0"])
cfg = reduced(get_arch("biglstm"), vocab=spec["vocab"])
res = {}
for case in spec["runs"]:
    oc = OptimizerConfig.from_sync(SyncConfig(**case["sync"]), **case["opt"])
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=case["batch"],
                        kind="train")
    r = train_loop(cfg, shape, oc, steps=case["steps"], seed=0,
                   n_workers=workers, verbose=False, device="cpu",
                   init_params=params0, group=group, digest=True,
                   checkpoint_dir=case["dir"], checkpoint_every=3,
                   **case.get("loop", {}))
    res[case["name"]] = dataclasses.asdict(r)
mesh.close_ranks()
if group.rank == 0:
    json.dump(res, open(out, "w"))
"""


def load_jax_params(npz_path, cfg):
    with np.load(npz_path) as z:
        flat = dict(z)
    as_bf16 = lambda k: flat[k].view(ml_dtypes.bfloat16)
    return convert.to_torch({
        "embed": as_bf16("['embed']"), "head_w": as_bf16("['head_w']"),
        "head_b": as_bf16("['head_b']"),
        "cells": [{n: as_bf16(f"['cells'][{i}]['{n}']")
                   for n in ("b", "wh", "wp", "wx")}
                  for i in range(cfg.n_layers)]})


def _launch(script, spec, out, nproc):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), str(script), str(spec), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc, what):
    try:
        log, _ = proc.communicate(timeout=GROUP_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
        raise AssertionError(f"{what} did not finish in {GROUP_TIMEOUT} s:\n"
                             f"{log[-4000:]}")
    assert proc.returncode == 0, f"{what} failed:\n{log[-4000:]}"
    return log


def _fields(sync_kw, opt_kw):
    opt = _opt(sync_kw, opt_kw)
    sync = {f: getattr(opt.sync, f) for f in SyncConfig.__dataclass_fields__}
    return sync, {k: getattr(opt, k) for k in (
        "name", "lr", "H", "warmup_steps", "use_kernels", "flat")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, the port's stacked runs and its runs on
    the two grids, and the checkpoints of each."""
    root = tmp_path_factory.mktemp("sharded")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    to_ref = lambda o: {("use_pallas" if k == "use_kernels" else k): v
                        for k, v in o.items()}
    ref_cases = {n: (s, to_ref({**_fields(s, o)[1], "flat": True}))
                 for n, (s, o) in CASES.items()}
    chain_ref = (CHAIN[0], to_ref(_fields(*CHAIN)[1]))
    ref_out = str(root / "ref")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, ref_out, json.dumps({
            "vocab": VOCAB, "seq": SEQ, "steps": STEPS, "batch": 8,
            "cases": ref_cases, "chain": chain_ref,
            "chain_batch": CHAIN_BATCH})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    while not os.path.exists(ref_out + ".npz"):
        if ref.poll() is not None or time.monotonic() - t0 > GROUP_TIMEOUT:
            ref.kill()
            raise AssertionError("reference: no initial weights\n"
                                 + ref.communicate()[0][-4000:])
        time.sleep(0.2)
    params0 = load_jax_params(ref_out + ".npz", _cfg())
    torch.save(params0, root / "params0.pt")
    torch.set_num_threads(1)
    # one thing at a time: the reference, each group, then the stacked runs
    # (the fewer processes at once, the less the suite's timed tests
    # beside this file feel it)
    try:
        log, _ = ref.communicate(timeout=GROUP_TIMEOUT)
    except subprocess.TimeoutExpired:
        ref.kill()
        raise
    assert ref.returncode == 0, log[-4000:]
    with open(ref_out + ".json") as f:
        reference = json.load(f)

    # the chain's first leg, stacked (1, 1): both later legs resume it
    chain_opt = _opt(*CHAIN)
    for tag in ("chain_stacked", "chain_grid"):
        first = train_loop(_cfg(), _shape(CHAIN_BATCH), chain_opt, steps=3,
                           seed=0, verbose=False, device="cpu",
                           init_params=params0,
                           checkpoint_dir=str(root / tag),
                           checkpoint_every=3)
    script = root / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    procs = {}
    for workers, shards in GRIDS:
        tag = f"{workers}x{shards}"
        spec_runs = []
        for name, (s, o) in CASES.items():
            sync, opt = _fields(s, o)
            spec_runs.append({"name": name, "sync": sync, "opt": opt,
                              "batch": 4 * workers, "steps": STEPS,
                              "dir": str(root / f"{tag}_{name}")})
        if workers == 2:
            sync, opt = _fields(*CHAIN)
            spec_runs.append({"name": "chain", "sync": sync, "opt": opt,
                              "batch": CHAIN_BATCH, "steps": 6,
                              "dir": str(root / "chain_grid")})
            sync, opt = _fields(*CASES["int8"])
            spec_runs.append({"name": "obs", "sync": sync, "opt": opt,
                              "batch": 8, "steps": STEPS,
                              "dir": str(root / "obs_grid"), "loop": {
                                  "metrics_out": str(root / "grid.jsonl"),
                                  "trace_out": str(root / "grid.json")}})
        spec = root / f"spec_{tag}.json"
        spec.write_text(json.dumps({
            "params0": str(root / "params0.pt"), "grid": [workers, shards],
            "vocab": VOCAB, "seq": SEQ, "runs": spec_runs}))
        procs[tag] = (spec, workers * shards)

    for tag, (spec, nproc) in procs.items():
        _wait(_launch(script, spec, root / f"out_{tag}.json", nproc),
              f"the {tag} grid")
    grids = {tag: json.loads((root / f"out_{tag}.json").read_text())
             for tag in procs}
    stacked = {}
    for workers in sorted({w for w, _ in GRIDS}):
        for name, (s, o) in CASES.items():
            stacked[(workers, name)] = train_loop(
                _cfg(), _shape(4 * workers), _opt(s, o), steps=STEPS, seed=0,
                n_workers=workers, verbose=False, device="cpu",
                init_params=params0, digest=True,
                checkpoint_dir=str(root / f"stacked{workers}_{name}"),
                checkpoint_every=3)
    train_loop(_cfg(), _shape(8), _opt(*CASES["int8"]), steps=STEPS,
               seed=0, n_workers=2, verbose=False, device="cpu",
               init_params=params0, metrics_out=str(root / "stacked.jsonl"),
               trace_out=str(root / "stacked.json"),
               checkpoint_dir=str(root / "obs_stacked"), checkpoint_every=3)
    chain = {"stacked": [first], "grid": [first]}
    chain["stacked"].append(train_loop(
        _cfg(), _shape(CHAIN_BATCH), chain_opt, steps=6, seed=0, n_workers=2,
        verbose=False, device="cpu", init_params=params0,
        checkpoint_dir=str(root / "chain_stacked"), checkpoint_every=3))
    chain["grid"].append(grids["2x2"].pop("chain"))
    for tag in ("stacked", "grid"):      # the last leg, back on (1, 1)
        chain[tag].append(train_loop(
            _cfg(), _shape(CHAIN_BATCH), chain_opt, steps=8, seed=0,
            verbose=False, device="cpu", init_params=params0,
            checkpoint_dir=str(root / f"chain_{tag}"), checkpoint_every=0))
    return dict(root=root, reference=reference, stacked=stacked,
                grids=grids, chain=chain)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _asdict(r):
    return r if isinstance(r, dict) else r.__dict__


def _arrays(directory: Path):
    with np.load(directory / "arrays.npz") as z:
        return dict(z)


#: the adaptive policy's accumulated drift (the SyncState's): a sharded
#: run adds its per-shard partial sums in shard order, so the last bits may
#: differ from the replicated run's, as in the reference
DRIFT_RTOL = 1e-6


def _same_state(a: Path, b: Path):
    """Every array of two checkpoints equal; a flat plane's longer zero
    tail (a sharded plane's padding) trimmed, and checked zero. The
    SyncState's drift to DRIFT_RTOL."""
    x, y = _arrays(a), _arrays(b)
    assert sorted(x) == sorted(y)
    for k in x:
        u, v = x[k], y[k]
        if k == "#2/drift":
            np.testing.assert_allclose(u, v, rtol=DRIFT_RTOL)
            continue
        if u.ndim == 2 and u.shape[-1] != v.shape[-1]:
            n = min(u.shape[-1], v.shape[-1])
            longer = u if u.shape[-1] > n else v
            assert not longer[..., n:].any(), f"{k}: nonzero shard tail"
            u, v = u[..., :n], v[..., :n]
        assert u.shape == v.shape and np.array_equal(u, v), k


# --------------------------------------------------------------------------- #
# sharded = stacked, bitwise; against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_stacked_bitwise(runs, grid, name):
    workers, shards = grid
    got = runs["grids"][f"{workers}x{shards}"][name]
    want = _asdict(runs["stacked"][(workers, name)])
    for k in ("losses", "sync_steps", "comm_bytes_total", "n_workers",
              "state_digest"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["sync_steps"] == [1]            # the mid-window sync
    assert set(got["state_digest"]) >= {"params", "b2_local", "b2_sync"}
    assert len(got["ranks"]) == workers * shards
    _same_state(runs["root"] / f"{workers}x{shards}_{name}" / "step_3",
                runs["root"] / f"stacked{workers}_{name}" / "step_3")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_grid_matches_reference(runs, name):
    ref, got = runs["reference"]["runs"][name], runs["grids"]["2x2"][name]
    assert got["sync_steps"] == ref["sync_steps"]
    assert got["comm_bytes_total"] == ref["comm_bytes_total"]
    assert got["comm_bytes_modeled"] == ref["comm_bytes_modeled"]
    assert got["n_workers"] == ref["n_workers"] == 2
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)


def test_flat_checkpoint_crosses_grids(runs):
    """(1, 1) for 3 steps, then a 2 × 2 grid resumes to 6 in the middle of
    the adaptive window, then (1, 1) again to 8: the grid's leg equals the
    stacked 2-worker leg bit for bit, both last legs agree, and the chain
    matches the reference's."""
    stacked, grid = runs["chain"]["stacked"], runs["chain"]["grid"]
    ref = runs["reference"]["chain"]
    st = [_asdict(r) for r in stacked]
    gr = [_asdict(r) for r in grid]
    assert [r["start_step"] for r in gr] == [0, 3, 6] == [
        r["start_step"] for r in ref]
    assert gr[1]["n_workers"] == 2 and gr[2]["n_workers"] == 1
    for a, b in zip(gr[1:], st[1:]):
        assert a["losses"] == b["losses"]
        assert a["sync_steps"] == b["sync_steps"]
    assert all(math.isfinite(v) for r in gr for v in r["losses"])
    root = runs["root"]
    _same_state(root / "chain_grid" / "step_6",
                root / "chain_stacked" / "step_6")
    for a, b in zip(gr, ref):
        assert a["sync_steps"] == b["sync_steps"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=LOSS_RTOL)


# --------------------------------------------------------------------------- #
# what each rank moves
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_collectives_and_bytes_per_round(runs, grid, name):
    """A round: one collective over the rank's worker sub-group carrying
    its two sub-plane halves, ``round_bytes_per_shard`` plus its share of
    the plane's padding. A step: one params gather over its shard
    sub-group, the buckets' bytes in their dtypes (all bf16 here)."""
    from repro_torch.core.sync_engine import make_sync_engine
    from repro_torch.models import build_model
    from repro_torch.models.counting import count_params
    workers, shards = grid
    got = runs["grids"][f"{workers}x{shards}"][name]
    opt = _opt(*CASES[name])
    n_params = count_params(_cfg())
    abstract = build_model(_cfg()).init(None, "meta")
    fs = FlatSpace.build(abstract, batch_ndim=0, shards=shards, eps=opt.eps)
    engine = make_sync_engine(opt, H=H)
    per_elem = {"": 4, "bf16": 2, "int8": 1 + 4 / 256}[
        opt.sync.compression]
    rounds = len(got["sync_steps"])
    want = engine.round_bytes_per_shard(n_params, shards)
    pad = 2 * (fs.shard_size - n_params / shards) * per_elem
    layout = GridLayout(workers, shards)
    for rep in got["ranks"]:
        assert (rep["worker"], rep["shard"]) == layout.coords(rep["rank"])
        assert rep["collectives"] == rounds
        assert rep["wire_bytes"] / rounds == pytest.approx(want + pad,
                                                           rel=1e-12)
        assert rep["wire_bytes"] == 2 * fs.shard_size * per_elem * rounds
        assert rep["shard_gathers"] == STEPS
        parts = [fs.bucket_parts(s) for s in range(shards)]
        biggest = max(sum(2 * (hi - lo) for _, lo, hi in p) for p in parts)
        # bf16 parts: the buffer is aligned to their 2-byte elements
        assert rep["shard_gather_bytes"] == STEPS * (biggest
                                                     + (-biggest) % 2)


def _rows(path):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return lines[0], lines[1:]


def test_metrics_and_trace_carry_the_shards(runs):
    """Rank 0's metrics rows of the 2 × 2 run are the stacked run's (but
    the step walls), plus the shard count and a shard's round bytes; its
    trace meta and collective spans carry them too, and its spans are the
    stacked run's otherwise."""
    from repro_torch.core.sync_engine import make_sync_engine
    from repro_torch.models.counting import count_params
    root = runs["root"]
    per_shard = make_sync_engine(_opt(*CASES["int8"]), H=H
                                 ).round_bytes_per_shard(
        count_params(_cfg()), 2)
    head_g, rows_g = _rows(root / "grid.jsonl")
    head_s, rows_s = _rows(root / "stacked.jsonl")
    assert head_g == head_s and len(rows_g) == len(rows_s) == STEPS
    extra = {"n_shards": 2.0, "round_wire_bytes_per_shard": per_shard}
    for g, w in zip(rows_g, rows_s):
        assert {k: g["metrics"].pop(k) for k in extra} == extra
        for row in (g, w):
            row.pop("t_s")
            row["hists"].pop("step_time_s")
        assert g == w
    grid = json.loads((root / "grid.json").read_text())
    stacked = json.loads((root / "stacked.json").read_text())
    assert grid["meta"]["n_shards"] == 2
    assert grid["meta"]["round_wire_bytes_per_shard"] == per_shard
    spans = [sp for sp in grid["spans"] if sp["name"] == "collective"]
    assert spans and all(sp["args"]["n_shards"] == 2 and sp["args"][
        "wire_bytes_per_shard"] == per_shard for sp in spans)
    skip = ("t0", "dur", "dir", "n_shards", "wire_bytes_per_shard")
    timeless = lambda sp: (sp["name"], sp.get("worker"), sp.get("step"), {
        k: v for k, v in sp.get("args", {}).items() if k not in skip})
    assert ([timeless(sp) for sp in grid["spans"]]
            == [timeless(sp) for sp in stacked["spans"]])


# --------------------------------------------------------------------------- #
# the geometry (no group)
# --------------------------------------------------------------------------- #
def _tree():
    return {"a": torch.zeros((1, 300, 257), dtype=torch.bfloat16),
            "b": torch.zeros((1, 77)),
            "c": torch.zeros((1, 1), dtype=torch.bfloat16)}


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shard_views(shards):
    """Sub-planes tile the plane at ALIGN boundaries; their sidecar rows
    and bf16 ranges are the whole plane's, sliced; gathering every
    sub-plane's bucket parts into the bucket buffers unpacks to the
    whole plane's leaves, dtypes included."""
    from repro_torch.kernels.adaalter_update import LANES
    fs = FlatSpace.build(_tree(), batch_ndim=1, shards=shards, align=512)
    gen = torch.Generator().manual_seed(shards)
    tree = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
            for k, v in _tree().items()}
    plane = fs.pack(tree)
    bufs = fs.bucket_buffers("cpu")
    elems = fs.round16_elems()
    for s in range(shards):
        a, b = fs.shard_range(s)
        assert a % 512 == 0 and b - a == fs.shard_size
        sub = fs.shard_of(plane, s)
        assert torch.equal(sub, plane[..., a:b])
        np.testing.assert_array_equal(fs.round16_rows(LANES, s),
                                      fs.round16_rows(LANES)[a // LANES:
                                                             b // LANES])
        np.testing.assert_array_equal(fs.round16_elems(s), elems[a:b])
        mask = np.zeros(b - a, np.bool_)
        for lo, hi in fs.round16_ranges(s):
            mask[lo:hi] = True
        np.testing.assert_array_equal(mask, elems[a:b])
        for dest, part in zip(fs.bucket_views(bufs, s),
                              fs.shard_parts(sub, s)):
            assert dest.dtype == part.dtype
            dest.copy_(part)
    got, want = fs.unpack_buckets(bufs), fs.unpack(plane)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


@pytest.mark.parametrize("grid", [{"data": 2, "model": 1},
                                  {"data": 2, "model": 2},
                                  {"data": 1, "model": 4}])
@pytest.mark.parametrize("optimizer", ["local_adaalter", "adaalter"])
def test_plane_axes_are_the_references(grid, optimizer):
    """plane_shard_axes and plane_shard_count give the reference's answers
    for its plans on the same mesh shape (the reference reads only
    ``mesh.shape`` there), the plans above 20 B parameters included."""
    from types import SimpleNamespace
    from repro.configs import get_arch as jax_get_arch
    from repro.launch.mesh import resolve_plan as jax_resolve_plan
    from repro.sharding import partition as jp
    from repro.sharding.specs import plane_shard_count as jax_count
    from repro_torch.launch.mesh import resolve_plan
    from repro_torch.sharding import plane_shard_axes, plane_shard_count
    jmesh = SimpleNamespace(shape=dict(grid))
    for arch in ("biglstm", "qwen2-7b", "phi3.5-moe-42b-a6.6b"):
        plan = resolve_plan(get_arch(arch), grid, optimizer=optimizer)
        jplan = jax_resolve_plan(jax_get_arch(arch), jmesh,
                                 optimizer=optimizer)
        assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
        assert plane_shard_axes(grid, plan) == jp.plane_shard_axes(jmesh,
                                                                   jplan)
        assert plane_shard_count(grid, plan) == jax_count(jmesh, jplan)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
def test_stacked_flat_run_keeps_whole_planes_under_a_plan_above_20b(arch):
    """Under the plans above 20 B parameters (FSDP over ``data``, no
    worker axes) a local optimizer trains one model, as the reference's
    one-model branch does: ``flat`` is refused (ValueError), two workers
    are refused, and the one model per leaf runs ``local_step`` and the
    identity-mean sync (the int8 EF encode) every step, bit for bit a
    stacked run of one worker syncing every step (H = 1) under the
    paper-style plan (the reduced Big LSTM, whose forward no plan changes,
    stands in for the full-width model)."""
    from repro_torch.launch.mesh import resolve_plan
    from repro_torch.launch.steps import build_train_programs
    plan = resolve_plan(get_arch(arch), {"data": 2, "model": 1},
                        optimizer="local_adaalter")
    assert plan.fsdp_axes == ("data",) and not plan.local_axes
    opt = _opt(*CASES["int8"])
    with pytest.raises(ValueError, match="flat requires a local"):
        build_train_programs(_cfg(), opt, n_workers=1, device="cpu",
                             plan=plan)
    # the stacked run's fused update kernel (plain version here) rounds
    # apart from local_step, which the one-model branch runs: compare the
    # plain optimizer's steps
    opt = dataclasses.replace(opt, flat=False, use_kernels=False)
    with pytest.raises(ValueError, match="one model"):
        build_train_programs(_cfg(), opt, n_workers=2, device="cpu",
                             plan=plan)
    kw = dict(steps=STEPS, seed=0, n_workers=1, verbose=False,
              device="cpu", digest=True)
    got = train_loop(_cfg(), _shape(4), opt, plan=plan, **kw)
    want = train_loop(_cfg(), _shape(4), dataclasses.replace(opt, H=1), **kw)
    assert got.n_workers == 1 and got.sync_steps == list(range(STEPS))
    assert got.losses == want.losses and want.sync_steps == got.sync_steps
    assert got.state_digest == want.state_digest
    assert {"res_params", "res_b2"} <= set(got.state_digest)


@pytest.mark.parametrize("workers,shards", [(1, 2), (2, 2), (3, 2), (2, 3)])
def test_grid_layout(workers, shards):
    """Rank r is worker r // S, shard r % S (the reference's row-major
    mesh); the worker sub-groups hold one shard index each, the shard
    sub-groups one worker each, and together they cover every rank once."""
    layout = GridLayout(workers, shards)
    for r in range(layout.world):
        w, s = layout.coords(r)
        assert layout.rank(w, s) == r and (w, s) == divmod(r, shards)
        assert layout.worker_groups()[s][w] == r
        assert layout.shard_groups()[w][s] == r
    assert sorted(r for g in layout.worker_groups() for r in g) == list(
        range(layout.world))
    fs = FlatSpace.build(_tree(), batch_ndim=1, shards=shards)
    assert fs.plane_size % (shards * ALIGN) == 0

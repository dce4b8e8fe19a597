"""Local AdaAlter workers as ``torch.distributed`` ranks, one worker a rank.

Process groups of 2 and 3 gloo ranks on the CPU (``torch.distributed.run``
with ``--standalone``) train reduced Big LSTM at ``test_torch_train.py``'s
sizes; one subprocess drives the JAX package's ``train_loop`` on an
R-device Auto-axis mesh. What must hold:

  * ``core.comm.gather_mean_`` at R = 2 and 3, fp32 and bf16, with the
    flat plane's bf16 rounding: bitwise equal to ``worker_mean_`` over the
    stacked rows and to the reference's jitted ``jnp.mean``;
  * a run with ranks equals the port's stacked run of as many workers bit
    for bit: losses, schedule, comm bytes, and the final state, compared
    as checkpoint files written byte for byte alike (int8 per leaf and
    flat, one-pass and three-pass, bf16 adaptive, ``local_sgd`` fp32,
    R = 3); the same runs match the reference to LOSS_RTOL, schedules and
    comm bytes exactly; the synchronous AdaAlter over two ranks matches
    one model over the whole batch to LOSS_RTOL, which an η 2% larger
    must exceed;
  * each sync round issues ``round_collectives`` collectives per leaf (one
    over the flat plane), and each rank contributes the accounted bytes:
    int8 codes and one fp32 scale per 256-block, within one block's padding
    per leaf (per leaf) and the plane's slot padding (flat);
  * a stacked checkpoint resumed by ranks, and the ranks' metrics rows and
    trace spans, equal the stacked run's;
  * NCCL refuses two ranks on one card, and the CLI refuses a worker
    count that does not divide the world size (one that does makes a
    workers x shards grid).

Every spawned group runs under a subprocess timeout and opens its process
group with a 60 s timeout, so a hung rank fails its fixture, not the suite.
"""
import filecmp
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
from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, SyncConfig, get_arch, reduced)
from repro_torch.core import comm
from repro_torch.launch import mesh
from repro_torch.launch.train import train_loop

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
THRESHOLD = 0.0025          # test_torch_train.py's adaptive bf16 threshold
SEQ, STEPS = 16, 8
GROUP_TIMEOUT = 240         # seconds a spawned group may take in all

# name: (SyncConfig kwargs, OptimizerConfig kwargs, workers); lr 0.5, H 4,
# warm-up 0; 4 sequences a worker (BATCH 8 at R = 2)
RUNS = {
    "int8": (dict(compression="int8"), dict(use_kernels=True), 2),
    "int8_unfused": (dict(compression="int8", fused=False),
                     dict(use_kernels=True), 2),
    "flat_int8": (dict(compression="int8"),
                  dict(use_kernels=True, flat=True), 2),
    "flat_int8_unfused": (dict(compression="int8", fused=False),
                          dict(use_kernels=True, flat=True), 2),
    "adaptive_bf16": (dict(policy="adaptive", threshold=THRESHOLD,
                           compression="bf16"), dict(use_kernels=True), 2),
    "local_sgd": (dict(), dict(name="local_sgd"), 2),
    "r3_int8": (dict(compression="int8"), dict(use_kernels=True), 3),
}
# held against the reference too
JAX_RUNS = ("int8", "flat_int8", "adaptive_bf16", "local_sgd", "r3_int8")
# the synchronous baseline, world 2, BATCH 8; at lr 2 an η 2% off moves
# its losses past LOSS_RTOL (at 0.5 by 6e-5)
SYNC = dict(name="adaalter", lr=2.0)


def _batch(workers: int) -> int:
    return 4 * workers


def _opt(name, lr=0.5):
    if name == "sync":
        return OptimizerConfig(**{"warmup_steps": 0, **SYNC,
                                  "lr": SYNC["lr"] * lr / 0.5})
    sync_kw, opt_kw, _ = RUNS[name]
    return OptimizerConfig.from_sync(SyncConfig(**sync_kw), **{
        "lr": lr, "H": 4, "warmup_steps": 0, **opt_kw})


def _cfg():
    return reduced(get_arch("biglstm"))


REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.launch.train import train_loop
from repro.models import build_model

out, runs, seq, steps = sys.argv[1], json.loads(sys.argv[2]), *map(int, sys.argv[3:5])
cfg = reduced(get_arch("biglstm"))
params0 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
leaves, _ = jax.tree_util.tree_flatten_with_path(params0)
np.savez(out + ".tmp.npz", **{jax.tree_util.keystr(k): np.asarray(v).view(np.uint16)
                              for k, v in leaves})
os.replace(out + ".tmp.npz", out + ".npz")      # the weights first
res = {}
for name, (sync_kw, opt_kw, workers, batch) in runs.items():
    mesh = jax.make_mesh((workers, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:workers])
    shape = ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), **{
        "lr": 0.5, "H": 4, "warmup_steps": 0, **opt_kw})
    r = train_loop(cfg, shape, oc, steps=steps, seed=0, mesh=mesh,
                   verbose=False)
    res[name] = dict(losses=r.losses, sync_steps=r.sync_steps,
                     n_workers=r.n_workers,
                     comm_bytes_total=r.comm_bytes_total,
                     comm_bytes_modeled=r.comm_bytes_modeled)
json.dump(res, open(out + ".json", "w"))
"""

# one process group runs every case of its world size in turn; rank 0
# writes the results
RANKS_SCRIPT = r"""
import dataclasses, json, os, sys
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
group, dev = mesh.init_ranks("gloo", "cpu", timeout_s=60)
R, r = group.world, group.rank
params0 = torch.load(spec["params0"])
cfg = reduced(get_arch("biglstm"))
res = {"means": {}, "runs": {}}
for name, dtype, r16 in spec["means"]:
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((R, 3, 700), generator=gen).to(getattr(torch, dtype))
    row = x[r:r + 1].clone()
    comm.gather_mean_(row, group, round16=[tuple(v) for v in r16])
    res["means"][name] = row[0].float().tolist()
for case in spec["runs"]:
    oc = OptimizerConfig.from_sync(SyncConfig(**case["sync"]), **case["opt"])
    shape = ShapeConfig("t", seq_len=case["seq"], global_batch=case["batch"],
                        kind="train")
    res_ = train_loop(cfg, shape, oc, steps=case["steps"], seed=0,
                      n_workers=case["workers"], verbose=False, device="cpu",
                      init_params=params0, group=group,
                      **case.get("loop", {}))
    res["runs"][case["name"]] = dataclasses.asdict(res_)
mesh.close_ranks()
if r == 0:
    json.dump(res, open(out, "w"))
"""

# the CLI run by the test of the CLI, stacked and under torchrun
CLI = ["-m", "repro_torch.launch.train", "--device", "cpu", "--workers", "2",
       "--arch", "biglstm", "--reduced", "--use-kernels", "--compress",
       "int8", "--flat", "--batch", "8", "--seq", str(SEQ), "--steps",
       str(STEPS), "--checkpoint-every", "8"]
TORCHRUN = ["-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2"]

# (name, dtype, round16 ranges of the last axis)
MEANS = [("fp32", "float32", []), ("bf16", "bfloat16", []),
         ("fp32_round16", "float32", [[0, 100], [350, 700]])]


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests compare: the reference's results, the port's
    stacked runs and its runs with ranks (groups of 2 and of 3 ranks, side
    by side with the reference's subprocess), and their files."""
    root = tmp_path_factory.mktemp("ranks")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    ref_runs = {n: (RUNS[n][0], RUNS[n][1], RUNS[n][2], _batch(RUNS[n][2]))
                for n in JAX_RUNS}
    ref_runs = {n: (s, {("use_pallas" if k == "use_kernels" else k): v
                        for k, v in o.items()}, w, b)
                for n, (s, o, w, b) in ref_runs.items()}
    ref_runs["sync"] = ({}, SYNC, 2, 8)
    ref_out = str(root / "ref")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, ref_out, json.dumps(ref_runs),
         str(SEQ), str(STEPS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    while not os.path.exists(ref_out + ".npz"):
        if ref.poll() is not None or time.monotonic() - t0 > GROUP_TIMEOUT:
            ref.kill()
            raise AssertionError("reference: no initial weights\n"
                                 + ref.communicate()[0][-4000:])
        time.sleep(0.2)
    params0 = load_jax_params(ref_out + ".npz", _cfg())
    torch.save(params0, root / "params0.pt")

    def case(name, workers, **loop):
        opt = _opt(name)
        sync = {f.name: getattr(opt.sync, f.name)
                for f in SyncConfig.__dataclass_fields__.values()}
        fields = {k: getattr(opt, k) for k in (
            "name", "lr", "H", "warmup_steps", "use_kernels", "flat")}
        return {"name": name, "sync": sync, "opt": fields,
                "workers": workers, "batch": _batch(workers) if name !=
                "sync" else 8, "seq": SEQ, "steps": STEPS, "loop": loop}

    def ck(tag):
        return dict(checkpoint_dir=str(root / tag), checkpoint_every=4)

    specs = {2: [case(n, 2, **ck(f"ranks_{n}")) for n in RUNS
                 if RUNS[n][2] == 2]
             + [case("sync", 1),
                dict(case("int8", 2, checkpoint_dir=str(root / "resumed"),
                          checkpoint_every=4), name="int8_resumed"),
                dict(case("int8", 2, metrics_out=str(root / "ranks.jsonl"),
                          trace_out=str(root / "ranks_trace.json")),
                     name="int8_obs")],
             3: [case("r3_int8", 3, **ck("ranks_r3_int8"))]}

    # the stacked runs first: the resume case starts from their checkpoint
    stacked = {}
    torch.set_num_threads(1)
    shape = lambda w: ShapeConfig("t", seq_len=SEQ, global_batch=w,
                                  kind="train")
    for name, (_, _, w) in RUNS.items():
        stacked[name] = train_loop(
            _cfg(), shape(_batch(w)), _opt(name), steps=STEPS, seed=0,
            n_workers=w, verbose=False, device="cpu", init_params=params0,
            **ck(f"stacked_{name}"))
    stacked["int8_obs"] = train_loop(
        _cfg(), shape(8), _opt("int8"), steps=STEPS, seed=0, n_workers=2,
        verbose=False, device="cpu", init_params=params0,
        metrics_out=str(root / "stacked.jsonl"),
        trace_out=str(root / "stacked_trace.json"))
    for tag, lr in (("sync", 0.5), ("sync_eta_2pct_high", 0.5 * 1.02)):
        stacked[tag] = train_loop(
            _cfg(), shape(8), _opt("sync", lr), steps=STEPS, seed=0,
            verbose=False, device="cpu", init_params=params0)
    # the ranks resume the stacked int8 run's step-4 checkpoint
    os.makedirs(root / "resumed")
    os.system(f"cp -r {root / 'stacked_int8' / 'step_4'} {root / 'resumed'}")

    script = root / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    procs = {f"cli_{tag}": subprocess.Popen(
        [sys.executable, *cmd, "--out", str(root / f"cli_{tag}.json"),
         "--checkpoint-dir", str(root / f"cli_{tag}")],
        env={**env, "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for tag, cmd in (("stacked", CLI), ("ranks", TORCHRUN + CLI + [
            "--dist-backend", "gloo"]))}
    for world, spec_runs in specs.items():
        spec = root / f"spec{world}.json"
        spec.write_text(json.dumps({
            "params0": str(root / "params0.pt"), "runs": spec_runs,
            "means": MEANS}))
        procs[f"the group of {world} ranks"] = _launch(
            script, spec, root / f"out{world}.json", world)
    logs = {name: _wait(proc, f"{name}") for name, proc in procs.items()}
    try:
        log, _ = ref.communicate(timeout=GROUP_TIMEOUT)
    except subprocess.TimeoutExpired:
        ref.kill()
        raise
    assert ref.returncode == 0, log[-4000:]
    ranks = {}
    for world in specs:
        ranks[world] = json.loads((root / f"out{world}.json").read_text())
    with open(ref_out + ".json") as f:
        reference = json.load(f)
    cli = {tag: json.loads((root / f"cli_{tag}.json").read_text())
           for tag in ("stacked", "ranks")}
    cli["log"] = logs["cli_ranks"]
    return dict(root=root, reference=reference, stacked=stacked,
                ranks={**ranks[2]["runs"], **ranks[3]["runs"]},
                means={2: ranks[2]["means"], 3: ranks[3]["means"]}, cli=cli)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# the collective helper
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name,dtype,r16", MEANS)
def test_gather_mean_bitwise(runs, world, name, dtype, r16):
    """Every rank's row of the mean equals worker_mean_ over the stacked
    rows, and the reference's jitted jnp.mean (with the flat plane's bf16
    rounding of the given ranges)."""
    import jax
    import jax.numpy as jnp
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((world, 3, 700), generator=gen).to(getattr(torch,
                                                               dtype))
    want = comm.worker_mean_(x.clone(), [tuple(v) for v in r16])[0]
    got = torch.tensor(runs["means"][world][name], dtype=torch.float32)
    assert torch.equal(got, want.float())
    xj = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)

    def jmean(a):
        m = jnp.mean(a, axis=0)
        for start, stop in r16:
            m = m.at[..., start:stop].set(
                m[..., start:stop].astype(jnp.bfloat16).astype(m.dtype))
        return m
    ref = np.asarray(jax.jit(jmean)(xj).astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("chunk", [256, 768, 4096])
def test_chunked_rank_mean_equals_whole(chunk):
    """RankGroup.mean_ a chunk at a time (round16 ranges across chunk
    ends, a ragged last chunk) equals worker_mean_ over the stacked rows;
    dequantize_range equals the whole row's dequantize."""
    from repro_torch.kernels.quantize import (dequantize, dequantize_range,
                                              quantize)
    group = object.__new__(comm.RankGroup)
    group.world, group.timed = 3, False
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((3, 1, 2000), generator=gen)
    r16 = [(100, 300), (700, 1900)]
    want = comm.worker_mean_(x.clone().squeeze(1), r16)[0]
    got = x[0].clone()
    group.mean_(got, lambda r, a, b: x[r].view(-1)[a:b], r16, chunk=chunk)
    assert torch.equal(got[0], want)
    q, s = quantize(x[1], use_kernels=True)
    whole = dequantize(q, s, (2000,), use_kernels=True)
    for a in range(0, 2000, 256):
        b = min(2000, a + chunk)
        assert torch.equal(dequantize_range(q, s, a, b), whole[a:b])


def test_ef_codes_decode_to_the_wire():
    """The codes and scales the EF encode returns decode (dequantize,
    clamp, cast) to its wire bit for bit: per leaf, ragged rows included,
    and over a flat plane with its sidecars."""
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.sync_engine import ef_decode, ef_decode_range
    from repro_torch.kernels import sync_fused as sf
    from repro_torch.kernels.ref import F32_MIN, dequantize_blocks_ref
    gen = torch.Generator().manual_seed(3)
    codec = get_codec("int8", use_kernels=True)
    for dtype, nonneg in ((torch.bfloat16, False), (torch.float32, True)):
        x = torch.randn((1, 37, 29), generator=gen).to(dtype)
        if nonneg:
            x = x.abs()
        e = torch.randn((1, 37, 29), generator=gen) * 1e-3
        wire, _, (q, s) = sf.fused_ef_leaf(x, e.clone(), batch_ndim=1,
                                           clamp_nonneg=nonneg, codes=True)
        assert q.shape == (5, 256) and s.shape == (5, 1)
        assert not q.view(-1)[37 * 29:].any()      # the padding codes 0
        assert torch.equal(ef_decode(codec, (q, s), x, 1, nonneg), wire)
        for a, b in ((0, 37 * 29), (256, 768), (768, 37 * 29)):
            assert torch.equal(ef_decode_range(codec, (q, s), x, a, b,
                                               nonneg), wire.view(-1)[a:b])
    plane = torch.randn((1, 1024), generator=gen)
    rnd = torch.tensor([[1.0], [0.0], [1.0], [0.0]])
    low = torch.full((4, 1), F32_MIN)
    wire, _, (q, s) = sf.flat_ef_plane(plane, torch.zeros_like(plane), rnd,
                                       low, codes=True)
    assert torch.equal(sf.flat_wire(dequantize_blocks_ref(q, s), rnd, low)
                       .reshape(1, -1), wire)
    assert torch.equal(sf.flat_wire(codec.decode_range((q, s), 256, 768)
                                    .view(-1, 256), rnd[1:3], low[1:3]),
                       wire.view(-1, 256)[1:3])


# --------------------------------------------------------------------------- #
# runs with ranks against the stacked runs and the reference
# --------------------------------------------------------------------------- #
def _same_files(a: Path, b: Path) -> bool:
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        filecmp.cmp(a / n, b / n, shallow=False) for n in names)


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_equal_stacked_bitwise(runs, name):
    got, want = runs["ranks"][name], runs["stacked"][name]
    assert got["losses"] == want.losses
    assert got["sync_steps"] == want.sync_steps
    assert got["comm_bytes_total"] == want.comm_bytes_total
    assert got["n_workers"] == want.n_workers == RUNS[name][2]
    if RUNS[name][0].get("policy") != "adaptive":
        assert got["sync_steps"] == [3, 7]
    else:
        assert got["sync_steps"], "threshold never crossed: pins nothing"
    root = runs["root"]
    for step in ("step_4", "step_8"):     # the whole state, byte for byte
        assert _same_files(root / f"ranks_{name}" / step,
                           root / f"stacked_{name}" / step), (name, step)


@pytest.mark.parametrize("name", list(JAX_RUNS) + ["sync"])
def test_ranks_match_reference(runs, name):
    ref, got = runs["reference"][name], runs["ranks"][name]
    assert got["sync_steps"] == ref["sync_steps"]
    assert got["comm_bytes_total"] == ref["comm_bytes_total"]
    assert got["comm_bytes_modeled"] == ref["comm_bytes_modeled"]
    assert got["n_workers"] == ref["n_workers"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)


def test_sync_baseline_two_ranks_vs_one_model(runs):
    """AdaAlter with the batch over two ranks and the gradients averaged
    equals one model over the whole batch to LOSS_RTOL; an η 2% larger is
    outside it."""
    got = np.array(runs["ranks"]["sync"]["losses"])
    one = np.array(runs["stacked"]["sync"].losses)
    off = np.array(runs["stacked"]["sync_eta_2pct_high"].losses)
    np.testing.assert_allclose(got, one, rtol=LOSS_RTOL)
    assert np.max(np.abs(off - got) / np.abs(got)) > LOSS_RTOL
    assert runs["ranks"]["sync"]["sync_steps"] == list(range(STEPS))


@pytest.mark.parametrize("name", list(RUNS) + ["sync"])
def test_collectives_and_wire_bytes_per_round(runs, name):
    """Each rank's sync rounds: round_collectives per leaf (1 flat), and
    the bytes it contributed beside the accounting's round bytes: int8
    codes + one fp32 scale per 256-block, padded by under one block a
    leaf (the flat plane: by its slot padding, exactly); bf16 and fp32 as
    accounted. The synchronous baseline, FSDP over the two ranks, issues
    a params gather and one collective a leaf a step, and moves
    comm.fsdp_step_bytes: the bf16 params' parts and the fp32 gradient's
    (4 P at float32 params)."""
    from repro_torch.core.flatspace import FlatSpace
    from repro_torch.core.sync_engine import make_sync_engine
    from repro_torch.models import build_model
    from repro_torch.models.counting import count_params
    from repro_torch.tree import leaves
    got = runs["ranks"][name]
    opt = _opt(name)
    n_params = count_params(_cfg())
    n_leaves = len(leaves(build_model(_cfg()).init(None, "meta")))
    engine = make_sync_engine(opt, is_local=name != "sync", H=4)
    rounds = len(got["sync_steps"])
    for rep in got["ranks"]:
        if name == "sync":
            from repro_torch.launch.mesh import resolve_plan
            from repro_torch.sharding import (ShardingRules, leaf_split,
                                              param_shardings)
            grid = {"data": 2, "model": 1}
            tree = build_model(_cfg()).init(None, "meta")
            specs = param_shardings(ShardingRules(grid, resolve_plan(
                _cfg(), grid, optimizer="adaalter")), tree)
            n_split = sum(t.numel() for t, sp in zip(leaves(tree), specs)
                          if leaf_split(t.shape, sp, grid,
                                        {"data": 0, "model": 0}).split)
            assert rep["collectives"] == (1 + n_leaves) * STEPS
            assert rep["wire_bytes"] == STEPS * comm.fsdp_step_bytes(
                n_params, n_split, 2, param_bytes=2)
            assert comm.fsdp_step_bytes(n_params, n_split, 2) == 4 * n_params
            # and the loss, one fp32 a step
            assert rep["side_collectives"] == STEPS
            assert rep["side_bytes"] == STEPS * 4
            continue
        flat = opt.flat
        assert rep["collectives"] == rounds * engine.round_collectives(
            n_leaves, flat=flat)
        per_round = rep["wire_bytes"] / rounds
        want = engine.round_bytes(n_params)
        if flat:
            fs = FlatSpace.build(build_model(_cfg()).init(None, "meta"),
                                 batch_ndim=0, eps=opt.eps)
            pad = 2 * (fs.plane_size - n_params) * (1 + 4 / 256)
            assert per_round == want + pad
        elif engine.codec.name == "int8":
            assert 0 <= per_round - want < 260 * 2 * n_leaves
        else:
            assert per_round == want
        # beside the wire: one gather of the step's statistics a step,
        # and one a state leaf for each of the two checkpoints
        manifest = json.loads((runs["root"] / f"stacked_{name}" / "step_4"
                               / "manifest.json").read_text())
        n_state = sum(not k.startswith("#2/") for k in manifest["keys"])
        assert rep["side_collectives"] == STEPS + 2 * n_state


def test_checkpoint_resumed_by_ranks_bitwise(runs):
    """The stacked int8 run's step-4 checkpoint resumed by two ranks:
    losses 4-7 and the step-8 files equal the stacked straight run's."""
    got, want = runs["ranks"]["int8_resumed"], runs["stacked"]["int8"]
    assert got["start_step"] == 4
    assert got["losses"] == want.losses[4:]
    root = runs["root"]
    assert _same_files(root / "resumed" / "step_8",
                       root / "stacked_int8" / "step_8")


def _rows(path):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return lines[0], lines[1:]


def test_metrics_rows_equal_stacked(runs):
    """Rank 0's metrics stream, from the ranks' gathered values, has the
    stacked run's rows: every value but the step walls."""
    root = runs["root"]
    head_r, rows_r = _rows(root / "ranks.jsonl")
    head_s, rows_s = _rows(root / "stacked.jsonl")
    assert head_r == head_s
    assert len(rows_r) == len(rows_s) == STEPS

    def strip(row):
        row = {k: v for k, v in row.items() if k != "t_s"}
        row["hists"] = {k: v for k, v in row.get("hists", {}).items()
                        if k != "step_time_s"}
        return row
    for a, b in zip(rows_r, rows_s):
        assert strip(a) == strip(b)
        assert any(k.startswith("b2{") for k in a["metrics"])
        assert "grad_norm{worker=1}" in a["metrics"]


def test_trace_spans_equal_stacked(runs):
    """Rank 0's trace: the stacked run's spans, one a worker a step, with
    the same decisions, losses and health values (times differ)."""
    root = runs["root"]
    got = json.loads((root / "ranks_trace.json").read_text())
    want = json.loads((root / "stacked_trace.json").read_text())
    assert got["meta"]["n_workers"] == want["meta"]["n_workers"] == 2
    timeless = lambda sp: (sp["name"], sp.get("worker"), sp.get("step"), {
        k: v for k, v in sp.get("args", {}).items()
        if k not in ("t0", "dur", "dir")})
    assert ([timeless(s) for s in got["spans"]]
            == [timeless(s) for s in want["spans"]])


# --------------------------------------------------------------------------- #
# rank layout, plans and refusals (no group)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend,local_world,cards,refused", [
    ("nccl", 2, 1, True), ("nccl", 4, 2, True), ("nccl", 2, 2, False),
    ("nccl", 1, 1, False), ("gloo", 2, 1, False), ("gloo", 4, 1, False)])
def test_nccl_refuses_two_ranks_on_one_card(backend, local_world, cards,
                                            refused):
    assert comm.nccl_shares_a_card(backend, local_world, cards) == refused
    if refused:
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            mesh.check_backend(backend, local_world, cards)
    else:
        mesh.check_backend(backend, local_world, cards)


def test_resolve_plan():
    import dataclasses
    from repro_torch.sharding import GridLayout, plane_shard_count
    lstm = get_arch("biglstm")
    grid22 = {"data": 2, "model": 2}
    for grid in (2, {"data": 2, "model": 1}, grid22):
        assert mesh.resolve_plan(lstm, grid) == ParallelismPlan(
            local_axes=("data",), grad_axes=(), fsdp_axes=())
    sync = mesh.resolve_plan(lstm, 2, optimizer="adaalter")
    assert sync.local_axes == () and sync.grad_axes == ("data",)
    assert sync.fsdp_axes == ("data",)        # FSDP at every size
    # the paper-style plan splits the flat plane down "model"; per leaf it
    # is tensor parallelism, for every family; sequence parallelism and a
    # synchronous run with shards (FSDP beside tensor parallelism) pass
    assert plane_shard_count(grid22, mesh.resolve_plan(lstm, grid22)) == 2
    mesh.check_plan(mesh.resolve_plan(lstm, grid22), grid22, flat=True)
    mesh.check_plan(mesh.resolve_plan(lstm, grid22), grid22, flat=False,
                    cfg=lstm)
    ssm = get_arch("mamba2-370m")
    mesh.check_plan(mesh.resolve_plan(ssm, grid22), grid22, flat=False,
                    cfg=ssm)
    ssm = dataclasses.replace(ssm, seq_parallel=True)
    mesh.check_plan(mesh.resolve_plan(ssm, grid22), grid22, flat=False,
                    cfg=ssm)
    mesh.check_plan(sync, grid22, flat=False)
    mesh.check_plan(mesh.resolve_plan(lstm, grid22, optimizer="adaalter"),
                    grid22, flat=False, cfg=lstm)
    big = dataclasses.replace(get_arch("qwen2-7b"), n_layers=100)
    assert big.param_count() > 20e9
    for opt in ("local_adaalter", "adaalter"):
        plan = mesh.resolve_plan(big, 2, optimizer=opt)
        assert plan.fsdp_axes == ("data",) and plan.remat == "full"
        mesh.check_plan(plan, {"data": 2, "model": 1}, flat=False)
    # a run with ranks is built from the plan: workers along local_axes, or
    # one model along grad_axes; the worker count must be the plan's, and
    # a flat plane splits into the grid's shards
    from types import SimpleNamespace
    from repro_torch.launch.steps import build_train_programs
    small = reduced(lstm, vocab=64)
    ranks = SimpleNamespace(world=2, grid={"data": 2, "model": 1},
                            layout=GridLayout(2, 1), shard=0, workers=None,
                            rank=0)
    ranks.along = lambda axes: ranks if axes else None
    for opt, workers in (("local_adaalter", 2), ("adaalter", 1)):
        progs = build_train_programs(small, OptimizerConfig(name=opt),
                                     n_workers=workers, device="cpu",
                                     group=ranks)
        plan = mesh.resolve_plan(small, 2, optimizer=opt)
        assert progs.is_local == bool(plan.local_axes)
        assert progs.plan == plan and progs.n_shards == 1
    with pytest.raises(ValueError, match="one worker a rank"):
        build_train_programs(small, OptimizerConfig(), n_workers=3,
                             device="cpu", group=ranks)
    # above 20 B a local optimizer trains one model, its leaves FSDP-split
    progs = build_train_programs(big, OptimizerConfig(), n_workers=1,
                                 device="cpu", group=ranks)
    assert not progs.is_local and progs.leaf_layout.sharded
    with pytest.raises(ValueError, match="one model"):
        build_train_programs(big, OptimizerConfig(), n_workers=2,
                             device="cpu", group=ranks)
    grid = SimpleNamespace(world=4, grid=grid22, layout=GridLayout(2, 2),
                           shard=1, workers=None, shards=None)
    progs = build_train_programs(small, OptimizerConfig(flat=True),
                                 n_workers=2, device="cpu", group=grid)
    fs = progs.flatspace
    assert progs.n_shards == fs.shards == 2 and progs.shard == 1
    assert fs.plane_size % (2 * fs.align) == 0
    with pytest.raises(ValueError, match="one worker a rank"):
        build_train_programs(small, OptimizerConfig(flat=True), n_workers=4,
                             device="cpu", group=grid)


@pytest.mark.parametrize("world,workers,grid", [
    (2, 3, None), (4, 2, {"data": 2, "model": 2})])
def test_cli_refuses_workers_other_than_world(monkeypatch, capsys, world,
                                              workers, grid):
    """--workers must divide the world: 3 on 2 ranks is refused, naming
    the counts that fit; 2 on 4 ranks is a 2 x 2 grid."""
    from repro_torch.launch.train import main
    monkeypatch.setenv("WORLD_SIZE", str(world))
    argv = ["--device", "cpu", "--reduced", "--flat", "--workers",
            str(workers)]
    if grid is None:
        with pytest.raises(SystemExit):
            main(argv)
        assert "--workers 2" in capsys.readouterr().err
        return
    seen = {}

    def opened(backend, device, grid=None, **kw):
        seen["grid"] = grid
        raise RuntimeError("no process group in this test")
    monkeypatch.setattr(mesh, "init_ranks", opened)
    with pytest.raises(RuntimeError, match="no process group"):
        main(argv)
    assert seen["grid"] == grid


@pytest.mark.parametrize("workers", [2, 3])
def test_rank_batches_are_slices_of_the_stacked_batch(workers):
    """Rank r draws worker r's rows (local optimizers) or its share of the
    global batch (synchronous): bit for bit the stacked run's."""
    from repro_torch.data import SyntheticLM, make_train_batch
    cfg = reduced(get_arch("llama-3.2-vision-11b"))
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=4 * workers,
                        kind="train")
    for n in (workers, 1):
        ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         n_workers=n, seed=0)
        whole = make_train_batch(cfg, shape, ds, 3,
                                 n_workers=n if n > 1 else 0)
        for r in range(workers):
            part = make_train_batch(cfg, shape, ds, 3,
                                    n_workers=n if n > 1 else 0,
                                    rank=(r, workers))
            per = 4 * workers // (n if n > 1 else workers)
            for k, v in whole.items():
                want = v[r:r + 1] if n > 1 else v[r * 4:(r + 1) * 4]
                assert part[k].shape == want.shape and (part[k] == want).all()
        assert per


DYING_SCRIPT = r"""
import sys, torch
from repro_torch.core import comm
from repro_torch.launch import mesh
group, dev = mesh.init_ranks("gloo", "cpu", timeout_s=float(sys.argv[1]))
if group.rank == 1:
    sys.exit(3)                   # dies before the round
comm.gather_mean_(torch.ones((1, 8)), group)
"""


def test_a_rank_that_dies_fails_its_peer(tmp_path):
    """A rank that exits before a sync round fails the launch within the
    group's timeout; its peer does not hang."""
    script = tmp_path / "dying.py"
    script.write_text(DYING_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, *TORCHRUN, str(script), "10"], env=env,
        capture_output=True, text=True, timeout=GROUP_TIMEOUT)
    assert proc.returncode != 0
    assert time.monotonic() - t0 < 60


def test_cli_ranks_equal_stacked(runs):
    """The torchrun CLI: two gloo ranks on the CPU train flat int8 with the
    kernels' plain versions to the stacked CLI run's result and checkpoint
    files."""
    root, out = runs["root"], runs["cli"]
    assert "2 ranks, one worker each" in out["log"]
    got, want = out["ranks"], out["stacked"]
    assert got["losses"] == want["losses"]
    assert all(math.isfinite(v) for v in got["losses"])
    assert got["sync_steps"] == want["sync_steps"] == [3, 7]
    assert len(got["ranks"]) == 2 and not want["ranks"]
    assert got["state_digest"] == want["state_digest"]
    assert set(got["state_digest"]) == {"b2_local", "b2_sync", "params",
                                        "res_b2", "res_params"}
    assert all(len(v) == 2 for v in got["state_digest"].values())
    assert _same_files(root / "cli_ranks" / "step_8",
                       root / "cli_stacked" / "step_8")

"""FSDP beside tensor parallelism: one model on a (data × model) grid of
ranks, each leaf split over ``data`` and ``model`` (a tile a rank), the
synchronous plan and the plans above 20 B parameters on model ranks,
gathered-weight serving, sequence parallelism and remat "dots" under TP.

One group of 4 gloo ranks on the CPU (``torch.distributed.run
--standalone``) runs every case in turn on a (2, 2) grid (and, last, on
(4, 1)), beside one subprocess that drives the JAX package on Auto-axis
``("data", "model")`` meshes over 4 host devices. Each plan is the full
config's (``resolve_plan``, ``serve_plan``), passed explicitly: a reduced
config is under 20 B parameters. What must hold:

  * training (``launch/steps.py::_leaf_programs``) reduced qwen2-7b and
    llama3-405b under synchronous AdaAlter (Alg. 3) and reduced
    phi3.5-moe under its one-model Local AdaAlter with the int8 wire,
    3 steps, matches the reference's ``train_loop`` on an Auto (2, 2) mesh
    (losses to LOSS_RTOL, schedule and comm bytes exactly), and equals the
    data-replicated TP run (``fsdp_axes=()``) bit for bit in its losses
    and state; η 2% off falls outside LOSS_RTOL;
  * gathered-weight serving (``launch/serving.py::WeightGather``) of
    reduced llama3-405b and phi3.5-moe on (2, 2), and llama3-405b on
    (4, 1), matches the reference's ``build_serve_programs`` under the
    same plan (prefill logits and 4 decode steps' logits to SERVE_RTOL)
    and equals TP-only serving (the weights whole over ``data``) bit for
    bit in its logits and caches;
  * sequence parallelism equals no SP bit for bit (reduced qwen2-7b,
    mamba2, phi3.5-moe), and remat "dots" under TP equals "none" bit for
    bit (reduced hymba, qwen2-7b);
  * a rank's tiles are the parts of the whole leaves that the
    reference's specs give (``P('data', 'model')``, ``P(None, 'model',
    'data', None)``, ...); row 3's plain version on a tile whose runs hold
    whole 256-blocks is the whole leaf's encode, block for block;
  * an FSDP + TP checkpoint holds whole leaves: the JAX package restores
    it, and every rank's tiles are parts of the restored leaves; a flat
    checkpoint restores into a tensor-parallel per-leaf run bit for bit.

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

import numpy as np
import pytest
import torch

from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, SyncConfig, get_arch, reduced)
from repro_torch.launch import mesh
from repro_torch.launch.serving import serve_plan
from repro_torch.launch.train import state_digest, train_loop
from repro_torch.models import build_model
from repro_torch.sharding import TileSplit, leaf_split, tile_parts
from repro_torch.tree import leaves

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 300          # seconds a spawned group may take in all
GRID = {"data": 2, "model": 2}
#: training losses, float32 on the CPU, against the reference's train_loop
#: on an Auto (2, 2) mesh: measured 7.6e-8 (qwen2-7b, llama3-405b) and
#: 1.5e-6 (phi3.5-moe: the row-parallel sums add in another order, and its
#: routing amplifies it); η 2% off moves them 3.4e-5
LOSS_RTOL = 1e-5
#: serving logits against the reference, float32: measured ≤ 1.4e-6
SERVE_RTOL = 1e-5
STEPS, BATCH, SEQ = 3, 8, 16
PROMPT, NEW, SERVE_BATCH, DECODE = 12, 6, 4, 4
ARCHS = {"qwen": "qwen2-7b", "llama": "llama3-405b",
         "phi": "phi3.5-moe-42b-a6.6b", "mamba": "mamba2-370m",
         "hymba": "hymba-1.5b"}
#: training cases: arch key, optimizer, the wire
TRAIN = {"qwen_sync": ("qwen", "adaalter", ""),
         "llama_sync": ("llama", "adaalter", ""),
         "phi_local": ("phi", "local_adaalter", "int8")}
#: serving cases: arch key, grid
SERVE = {"llama_2x2": ("llama", (2, 2)), "phi_2x2": ("phi", (2, 2)),
         "llama_4x1": ("llama", (4, 1))}
#: sequence parallelism: the run it must equal bit for bit
SP = {"qwen": "qwen_sync", "phi": "phi_local", "mamba": None}
DOTS = ("hymba", "qwen")
LR = 0.5


def _cfg(key, **kw):
    return dataclasses.replace(reduced(get_arch(ARCHS[key])),
                               param_dtype="float32", **kw)


def _opt(name, compression, lr=LR):
    return OptimizerConfig.from_sync(
        SyncConfig(compression=compression), name=name, lr=lr, H=2,
        warmup_steps=0, use_kernels=bool(compression))


def _plan(key, optimizer):
    """The full config's plan on the (2, 2) grid."""
    return mesh.resolve_plan(get_arch(ARCHS[key]), GRID, optimizer=optimizer)


def _plan_dict(plan):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(plan).items()}


REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import ParallelismPlan, SyncConfig
from repro.data import SyntheticLM
from repro.launch.serving import (build_serve_programs, decode_cache_specs,
                                  serve_plan)
from repro.launch.train import train_loop
from repro.models import build_model
from repro.sharding.partition import ShardingRules
from repro.sharding.specs import param_shardings

out, spec = sys.argv[1], json.loads(sys.argv[2])
arrays, res = {}, {"train": {}, "specs": {}, "serve": {}}

def cfg_of(key):
    return dataclasses.replace(reduced(get_arch(spec["archs"][key])),
                               param_dtype="float32")

def mesh(w, s):
    return jax.make_mesh((w, s), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:w * s])

def specs(tree):
    return [[list(e) if isinstance(e, tuple) else e for e in sh.spec]
            for sh in jax.tree_util.tree_leaves(tree)]

for key in spec["archs"]:
    p = jax.jit(build_model(cfg_of(key)).init)(jax.random.PRNGKey(0))
    for i, leaf in enumerate(jax.tree_util.tree_leaves(p)):
        arrays[f"{key}/params/{i}"] = np.asarray(leaf)
np.savez(out + ".tmp.npz", **arrays)
os.replace(out + ".tmp.npz", out + ".params.npz")   # the weights first
arrays = {}

m = mesh(2, 2)
for name, case in spec["train"].items():
    cfg = cfg_of(case["key"])
    oc = OptimizerConfig.from_sync(SyncConfig(compression=case["wire"]),
                                   **case["opt"])
    plan = ParallelismPlan(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in case["plan"].items()})
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["bs"],
                        kind="train")
    r = train_loop(cfg, shape, oc, steps=spec["steps"], seed=0, mesh=m,
                   plan=plan, verbose=False)
    res["train"][name] = dict(losses=r.losses, sync_steps=r.sync_steps,
                              comm_bytes_total=r.comm_bytes_total,
                              n_workers=r.n_workers)
    params = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    res["specs"][name] = specs(param_shardings(ShardingRules(m, plan),
                                               params))

P, N, B, D = spec["prompt"], spec["new"], spec["batch"], spec["decode"]
for name, (key, grid) in spec["serve"].items():
    cfg = cfg_of(key)
    sm = mesh(*grid)
    plan = serve_plan(get_arch(spec["archs"][key]), sm)
    shape = ShapeConfig("decode_32k", seq_len=P + N, global_batch=B,
                        kind="decode")
    with sm:
        progs = build_serve_programs(cfg, shape, sm, plan)
        params = progs.init_fn(jax.random.PRNGKey(0))
        prompts = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=P,
                              n_workers=1, seed=0).worker_batch(
                                  0, 0, B)["tokens"]
        logits, _ = progs.prefill(params, {"tokens": prompts})
        arrays[f"{name}/prefill_logits"] = np.asarray(logits)
        cache = jax.tree_util.tree_map(lambda l: np.zeros(l.shape, l.dtype),
                                       decode_cache_specs(cfg, shape))
        for pos in range(D):
            logits, cache = progs.decode_step(
                params, cache, prompts[:, pos:pos + 1],
                np.full((B,), pos, np.int32))
            arrays[f"{name}/decode_logits/{pos}"] = np.asarray(logits)
        res["serve"][name] = {
            "plan": [plan.weight_gather_serving, list(plan.fsdp_axes)],
            "param_specs": specs(progs.param_sharding)}
np.savez(out + ".tmp.npz", **arrays)
os.replace(out + ".tmp.npz", out + ".npz")
json.dump(res, open(out + ".json", "w"))
"""

# one process group runs every case in turn on (2, 2), then re-lays its
# ranks out as (4, 1); every rank writes its arrays, rank 0 the results
RANKS_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np, torch
from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, SyncConfig, get_arch, reduced)
from repro_torch.core import comm
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh
from repro_torch.launch.serving import build_serve_programs, serve_plan
from repro_torch.models import build_model
from repro_torch.sharding import GridLayout
from repro_torch.tree import leaves, tree_map
import repro_torch.launch.train as train_mod

torch.set_num_threads(1)
comm.MEAN_CHUNK = 4096
spec = json.load(open(sys.argv[1]))
out = sys.argv[2]
group, dev = mesh.init_ranks("gloo", "cpu", timeout_s=60,
                             grid={"data": 2, "model": 2},
                             fsdp_axes=("data",))
me = group.rank
params0 = torch.load(spec["params0"])
arrays, res = {}, {}
captured = {}
real_digest = train_mod.state_digest
def capture(params, opt_state, **kw):       # the run's final state
    captured["state"] = (params, opt_state)
    return real_digest(params, opt_state, **kw)
train_mod.state_digest = capture

def cfg_of(key, **kw):
    return dataclasses.replace(reduced(get_arch(spec["archs"][key])),
                               param_dtype="float32", **kw)

def plan_of(d, **kw):
    return dataclasses.replace(ParallelismPlan(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}),
        **kw)

def train(name, case, *, plan_kw=None, cfg_kw=None, keep=False, **loop):
    cfg = cfg_of(case["key"], **(cfg_kw or {}))
    oc = OptimizerConfig.from_sync(SyncConfig(compression=case["wire"]),
                                   **case["opt"])
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["bs"],
                        kind="train")
    r = train_mod.train_loop(
        cfg, shape, oc, steps=loop.pop("steps", spec["steps"]), seed=0,
        verbose=False, device="cpu", init_params=params0[case["key"]],
        group=group, digest=True,
        plan=plan_of(case["plan"], **(plan_kw or {})), **loop)
    res[name] = dataclasses.asdict(r)
    if keep:                      # this rank's final tiles of the params
        for i, t in enumerate(leaves(captured["state"][0])):
            arrays[f"{name}/params/{i}"] = t.numpy()

for name, case in spec["train"].items():
    train(f"{name}/fsdp", case, keep=True,
          checkpoint_dir=spec["ckpt"] if name == "qwen_sync" else "",
          checkpoint_every=spec["steps"] if name == "qwen_sync" else 0)
    train(f"{name}/repl", case, plan_kw={"fsdp_axes": ()})
# each rank's first tiles: the parts of the weights it was given
if spec.get("tiles"):
    from repro_torch.launch.steps import build_train_programs
    for name in spec["tiles"]:
        case = spec["train"][name]
        oc = OptimizerConfig.from_sync(SyncConfig(compression=case["wire"]),
                                       **case["opt"])
        progs = build_train_programs(cfg_of(case["key"]), oc, n_workers=1,
                                     device="cpu", group=group,
                                     plan=plan_of(case["plan"]))
        p, _ = progs.init_fn(0, params0[case["key"]])
        for i, t in enumerate(leaves(p)):
            arrays[f"{name}/tiles/{i}"] = t.numpy()
        res[f"{name}/tile_kinds"] = [type(s).__name__ for s in
                                     progs.leaf_layout.tiles]
for key, base in spec["sp"].items():
    case = spec["train"][base] if base else dict(
        spec["train"]["qwen_sync"], key=key)
    train(f"sp/{key}", case, cfg_kw={"seq_parallel": True})
    if base is None:
        train(f"sp/{key}/base", case)
for key in spec["dots"]:
    case = dict(spec["train"]["qwen_sync"], key=key)
    for remat in ("dots", "none"):
        train(f"dots/{key}/{remat}", case, plan_kw={"remat": remat})
# a flat checkpoint into a tensor-parallel per-leaf run (2 workers x 2)
flat = spec["flat"]
fcase = {"key": "qwen", "wire": "int8", "opt": flat["opt"],
         "plan": flat["plan"]}
for steps in (flat["at"], flat["to"]):
    cfg = cfg_of("qwen")
    oc = OptimizerConfig.from_sync(SyncConfig(compression="int8"),
                                   **flat["opt"])
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["bs"],
                        kind="train")
    r = train_mod.train_loop(cfg, shape, oc, steps=steps, seed=0,
                             verbose=False, device="cpu", n_workers=2,
                             init_params=params0["qwen"], group=group,
                             digest=True, checkpoint_dir=flat["dir"])
    res[f"flat_restore/{steps}"] = dataclasses.asdict(r)

def serve(name, key, plan):
    cfg = cfg_of(key)
    P, N, B = spec["prompt"], spec["new"], spec["batch"]
    shape = ShapeConfig("decode_32k", seq_len=P + N, global_batch=B,
                        kind="decode")
    progs = build_serve_programs(cfg, shape, group=group, plan=plan)
    parts = progs.param_parts(params0[key])
    prompts = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=P, n_workers=1,
        seed=0).worker_batch(0, 0, B)["tokens"])[progs.rows]
    n0, b0 = comm.shard_gather.n, comm.shard_gather.bytes
    logits, cache = progs.prefill(parts, {"tokens": prompts})
    arrays[f"{name}/prefill_logits"] = logits.numpy()
    for i, c in enumerate(leaves(cache)):
        arrays[f"{name}/prefill_cache/{i}"] = c.numpy()
    whole = build_model(cfg).init_cache(B, P + N, device="meta")
    cache = tree_map(torch.zeros_like, progs.cache_parts(
        tree_map(lambda t: torch.empty(t.shape), whole)))
    for pos in range(spec["decode"]):
        logits, cache = progs.decode_step(
            parts, cache, prompts[:, pos:pos + 1],
            torch.full((prompts.shape[0],), pos, dtype=torch.int32))
        arrays[f"{name}/decode_logits/{pos}"] = logits.numpy()
    for i, c in enumerate(leaves(cache)):
        arrays[f"{name}/decode_cache/{i}"] = c.numpy()
    res[name] = {"rows": [progs.rows.start, progs.rows.stop],
                 "gathers": comm.shard_gather.n - n0,
                 "gather_bytes": comm.shard_gather.bytes - b0,
                 "weight_values": sum(t.numel() for t in leaves(parts))}

for grid in ((2, 2), (4, 1)):
    if grid != (2, 2):            # the ranks laid out again
        group.split(GridLayout(*grid), ("data",))
    for name, (key, g) in spec["serve"].items():
        if tuple(g) != grid:
            continue
        plan = serve_plan(get_arch(spec["archs"][key]), group.grid)
        serve(f"{name}/gather", key, plan)
        serve(f"{name}/tp", key, dataclasses.replace(
            plan, fsdp_axes=(), weight_gather_serving=False))
mesh.close_ranks()
np.savez(f"{out}.rank{me}.npz", **arrays)
if me == 0:
    json.dump(res, open(out, "w"))
"""


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


def _jax_params(npz, key):
    """The reference's float32 weights of ``key``'s reduced config, carried
    across with ``repro_torch.convert``."""
    import jax
    from repro import configs as jcfgs
    from repro.models import build_model as jax_build_model
    from repro_torch import convert
    jcfg = dataclasses.replace(jcfgs.reduced(jcfgs.get_arch(ARCHS[key])),
                               param_dtype="float32")
    abstract = jax.eval_shape(jax_build_model(jcfg).init,
                              jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten(abstract)
    return convert.to_torch(jax.tree_util.tree_unflatten(
        treedef, [npz[f"{key}/params/{i}"] for i in range(len(flat))]))


def _case(key, optimizer, wire):
    opt = _opt(optimizer, wire)
    return {"key": key, "wire": wire,
            "opt": {k: getattr(opt, k) for k in ("name", "lr", "H",
                                                  "warmup_steps",
                                                  "use_kernels")},
            "plan": _plan_dict(_plan(key, optimizer))}


def _shape():
    return ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the flat checkpoint's run: Local AdaAlter, 2 workers, int8, H 2
FLAT_OPT = dict(name="local_adaalter", lr=LR, H=2, warmup_steps=0,
                use_kernels=True)
FLAT_AT, FLAT_TO = 2, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, the port's on the 4 ranks, and the
    stacked runs around the flat checkpoint."""
    root = tmp_path_factory.mktemp("fsdp_tp")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    cases = {n: _case(k, o, w) for n, (k, o, w) in TRAIN.items()}
    ref_cases = {n: {**c, "opt": {("use_pallas" if k == "use_kernels"
                                   else k): (False if k == "use_kernels"
                                             else v)
                                  for k, v in c["opt"].items()}}
                 for n, c in cases.items()}
    ref_out = str(root / "ref")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, ref_out, json.dumps({
            "archs": ARCHS, "train": ref_cases, "serve": SERVE,
            "prompt": PROMPT, "new": NEW, "batch": SERVE_BATCH,
            "decode": DECODE, "seq": SEQ, "bs": BATCH, "steps": STEPS})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    while not os.path.exists(ref_out + ".params.npz"):
        if ref.poll() is not None or time.monotonic() - t0 > GROUP_TIMEOUT:
            ref.kill()
            raise AssertionError("reference: no initial weights\n"
                                 + ref.communicate()[0][-4000:])
        time.sleep(0.2)
    with np.load(ref_out + ".params.npz") as z:
        npz = dict(z)
    params0 = {k: _jax_params(npz, k) for k in ARCHS}
    torch.save(params0, root / "params0.pt")
    # the flat checkpoint, from the stacked run of the two workers
    flat_dir = root / "flat"
    flat_oc = OptimizerConfig.from_sync(SyncConfig(compression="int8"),
                                        flat=True, **FLAT_OPT)
    train_loop(_cfg("qwen"), _shape(), flat_oc, steps=FLAT_AT, seed=0,
               n_workers=2, verbose=False, device="cpu",
               init_params=params0["qwen"], checkpoint_dir=str(flat_dir),
               checkpoint_every=FLAT_AT)
    paper = mesh.resolve_plan(_cfg("qwen"), GRID)
    script = root / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    spec = root / "spec.json"
    spec.write_text(json.dumps({
        "params0": str(root / "params0.pt"), "archs": ARCHS,
        "train": cases, "tiles": list(TRAIN), "sp": SP,
        "dots": list(DOTS), "ckpt": str(root / "ck"),
        "flat": {"opt": FLAT_OPT, "plan": _plan_dict(paper),
                 "dir": str(flat_dir), "at": FLAT_AT, "to": FLAT_TO},
        "serve": SERVE, "prompt": PROMPT, "new": NEW, "batch": SERVE_BATCH,
        "decode": DECODE, "seq": SEQ, "bs": BATCH, "steps": STEPS}))
    out = root / "out.json"
    ranks = _launch(script, spec, out, 4)
    # the stacked per-leaf run restored from the flat checkpoint, and
    # carried on
    leaf_oc = OptimizerConfig.from_sync(SyncConfig(compression="int8"),
                                        **FLAT_OPT)
    stacked = {steps: train_loop(
        _cfg("qwen"), _shape(), leaf_oc, steps=steps, seed=0, n_workers=2,
        verbose=False, device="cpu", init_params=params0["qwen"],
        checkpoint_dir=str(flat_dir), digest=True)
        for steps in (FLAT_AT, FLAT_TO)}
    _wait(ranks, "the 4 ranks")
    _wait(ref, "the reference")
    with np.load(ref_out + ".npz") as z:
        ref_arrays = dict(z)
    return {"root": root, "params0": params0, "stacked": stacked,
            "ref": json.loads(Path(ref_out + ".json").read_text()),
            "ref_arrays": ref_arrays,
            "result": json.loads(out.read_text()),
            "arrays": [dict(np.load(f"{out}.rank{r}.npz"))
                       for r in range(4)]}


def _same_run(a, b):
    return all(a[k] == b[k] for k in ("losses", "sync_steps",
                                      "comm_bytes_total", "state_digest"))


def _max_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# --------------------------------------------------------------------------- #
# the plans and the tile (no ranks)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key,optimizer", [("qwen", "adaalter"),
                                           ("llama", "adaalter"),
                                           ("llama", "local_adaalter"),
                                           ("phi", "local_adaalter")])
def test_plans_build_on_model_ranks(key, optimizer):
    """The synchronous plan and the plans above 20 B parameters, with
    ``seq_parallel`` and gathered-weight serving, pass the checks on a
    (2, 2) grid."""
    full = get_arch(ARCHS[key])
    plan = mesh.resolve_plan(full, GRID, optimizer=optimizer)
    assert plan.local_axes == () and plan.fsdp_axes == ("data",)
    for cfg in (full, dataclasses.replace(full, seq_parallel=True)):
        mesh.check_plan(plan, GRID, flat=False, cfg=cfg)
        sp = serve_plan(cfg, GRID)
        assert sp.weight_gather_serving == (full.param_count() > 20e9)
        mesh.check_serve_plan(cfg, sp, GRID)


@pytest.mark.parametrize("shape,spec,coords,whole", [
    ((512, 1024), ("data", "model"), {"data": 1, "model": 0}, True),
    ((1024, 512), ("model", "data"), {"data": 0, "model": 1}, True),
    ((2, 4, 256, 6400), (None, "model", "data", None),
     {"data": 1, "model": 1}, True),
    ((4096, 32064), ("data", "model"), {"data": 0, "model": 1}, False),
    ((2, 256, 96), (None, "data", "model"), {"data": 1, "model": 1}, False)])
def test_a_tile_is_the_part_of_the_parts(shape, spec, coords, whole):
    """A spec that splits two dimensions gives a TileSplit: the FSDP part
    of the rank's part over ``model``; the four tiles put back in place
    are the whole leaf; ``whole_blocks`` says whether each tile's runs of
    the leaf's row-major order hold whole 256-blocks (phi3.5-moe's
    ``lm_head``, 16,032 columns a ``model`` part, does not)."""
    grid = {"data": 2, "model": 2}
    s = leaf_split(shape, spec, grid, coords)
    assert isinstance(s, TileSplit) and s.split
    assert s.whole_blocks(256) == whole
    tp, fsdp = tile_parts(s, grid)
    assert tp.axes == ("model",) and fsdp.axes == ("data",)
    assert fsdp.shape == tp.part_shape and s.part_shape == fsdp.part_shape
    if math.prod(shape) > 1 << 22:
        return
    x = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    back = torch.zeros_like(x)
    for d in range(2):
        for m in range(2):
            t = leaf_split(shape, spec, grid, {"data": d, "model": m})
            part = t.take(x)
            assert part.is_contiguous() and tuple(part.shape) == t.part_shape
            t.part(back).copy_(part)
    assert torch.equal(back, x)


@pytest.mark.parametrize("spec", [("data", None), ("model", "data"),
                                  ("data", "model")])
def test_a_part_holds_no_reference_to_the_whole(spec):
    """``take`` copies a rank's part, contiguous or not, so the whole leaf
    it was cut from can be freed (a part along the first dimension was a
    view, and kept the whole alive for the run)."""
    x = torch.arange(64.0).reshape(8, 8)
    for d in range(2):
        for m in range(2):
            s = leaf_split((8, 8), spec, GRID, {"data": d, "model": m})
            part = s.take(x)
            assert part.is_contiguous()
            assert part.untyped_storage().data_ptr() != \
                x.untyped_storage().data_ptr()
            assert torch.equal(part, s.part(x))


def test_two_axes_on_one_dimension_keep_the_one_dimension_form():
    """2-D experts put ``("model", "data")`` on one dimension: a LeafSplit
    over both, whose tensor-parallel part is the ``model`` part and its
    FSDP part the ``data`` part inside it."""
    grid = {"data": 2, "model": 2}
    s = leaf_split((8, 4, 6), (("model", "data"), None, None), grid,
                   {"data": 1, "model": 1})
    assert not isinstance(s, TileSplit) and (s.parts, s.index) == (4, 3)
    tp, fsdp = tile_parts(s, grid)
    assert (tp.parts, tp.index, tp.part_shape) == (2, 1, (4, 4, 6))
    assert (fsdp.parts, fsdp.index, fsdp.part_shape) == (2, 1, (2, 4, 6))
    x = torch.arange(8 * 4 * 6.0).reshape(8, 4, 6)
    assert torch.equal(fsdp.take(tp.take(x)), s.take(x))


@pytest.mark.parametrize("shape,spec", [
    ((512, 1024), ("data", "model")), ((1024, 512), ("model", "data")),
    ((2, 4, 256, 640), (None, "model", "data", None))])
@pytest.mark.parametrize("nonneg", [False, True])
def test_row3_on_a_tile_is_the_whole_leaf_encode(shape, spec, nonneg):
    """Row 3's plain version on a tile whose runs hold whole 256-blocks
    gives that tile of the whole leaf's encode, block for block: wire and
    residual bit for bit, and the codes of its blocks."""
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.sync_engine import ef_apply
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(shape, generator=gen)
    x = x.abs() if nonneg else x
    e = torch.randn(shape, generator=gen) * 1e-2
    codec = get_codec("int8", use_kernels=True)
    want_w, want_r = ef_apply(x, e.clone(), codec, 0, clamp_nonneg=nonneg)
    for d in range(2):
        for m in range(2):
            s = leaf_split(shape, spec, GRID, {"data": d, "model": m})
            assert s.whole_blocks(256)
            w, r = ef_apply(s.take(x), s.take(e), codec, 0,
                            clamp_nonneg=nonneg)
            assert torch.equal(w, s.take(want_w))
            assert torch.equal(r, s.take(want_r))


# --------------------------------------------------------------------------- #
# training on the 4 ranks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(TRAIN))
def test_fsdp_tp_equals_data_replicated_tp_bitwise(runs, name):
    got, want = (runs["result"][f"{name}/{t}"] for t in ("fsdp", "repl"))
    assert _same_run(got, want), (got["losses"], want["losses"])
    assert got["n_workers"] == 1 and got["sync_steps"] == list(range(STEPS))
    assert all(math.isfinite(v) for v in got["losses"])


@pytest.mark.parametrize("name", list(TRAIN))
def test_fsdp_tp_matches_the_reference(runs, name):
    ref, got = runs["ref"]["train"][name], runs["result"][f"{name}/fsdp"]
    assert got["sync_steps"] == ref["sync_steps"]
    assert got["comm_bytes_total"] == ref["comm_bytes_total"]
    assert got["n_workers"] == ref["n_workers"] == 1
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)


def test_a_wrong_step_size_leaves_the_tolerance(runs):
    """The same model on one device with η 2% larger, from the same
    weights, under the same plan: off the reference by more than
    LOSS_RTOL."""
    key, optimizer, wire = TRAIN["qwen_sync"]
    r = train_loop(_cfg(key), _shape(), _opt(optimizer, wire, lr=LR * 1.02),
                   steps=STEPS, seed=0, verbose=False, device="cpu",
                   init_params=runs["params0"][key],
                   plan=_plan(key, optimizer))
    assert _max_rel(r.losses,
                    runs["ref"]["train"]["qwen_sync"]["losses"]) > LOSS_RTOL


def _spec_part(a, spec, coords):
    """The part of ``a`` that the rank at ``coords`` holds under a
    reference spec (a list of entries, as the JSON carries them)."""
    for d, entry in enumerate(spec):
        axes = [] if entry is None else ([entry] if isinstance(entry, str)
                                         else entry)
        n, idx = 1, 0
        for ax in axes:
            idx = idx * GRID[ax] + coords[ax]
            n *= GRID[ax]
        if n > 1:
            size = a.shape[d] // n
            a = a.take(range(idx * size, (idx + 1) * size), axis=d)
    return a


@pytest.mark.parametrize("name", list(TRAIN))
def test_tiles_are_the_reference_specs_parts(runs, name):
    """Each rank's first parameters are the parts of the whole weights
    that the reference's specs give under the plan: tiles where the spec
    splits two dimensions, as ``P('data', 'model')`` and phi3.5-moe's
    experts' ``P(None, 'model', 'data', None)`` do."""
    key = TRAIN[name][0]
    specs = runs["ref"]["specs"][name]
    whole = [t.numpy() for t in leaves(runs["params0"][key])]
    assert len(specs) == len(whole)
    kinds = runs["result"][f"{name}/tile_kinds"]
    assert "TileSplit" in kinds
    two = [sp for sp in specs if sum(e is not None for e in sp) == 2]
    assert len(two) == kinds.count("TileSplit")
    if key == "phi":
        assert [None, "model", "data", None] in specs
    for r in range(4):
        coords = {"data": r // 2, "model": r % 2}
        for i, (w, sp) in enumerate(zip(whole, specs)):
            got = runs["arrays"][r][f"{name}/tiles/{i}"]
            assert np.array_equal(got, _spec_part(w, sp, coords)), (r, i, sp)


@pytest.mark.parametrize("key", list(SP))
def test_sequence_parallel_equals_no_sp_bitwise(runs, key):
    """Under ``seq_parallel`` the residual stream between the blocks is a
    rank's slice of the sequence (the row-parallel outputs
    reduce-scattered in rank order, the stream gathered for each norm):
    the run equals the run without it bit for bit."""
    base = SP[key]
    want = runs["result"][f"{base}/fsdp" if base else f"sp/{key}/base"]
    got = runs["result"][f"sp/{key}"]
    assert _same_run(got, want), (got["losses"], want["losses"])
    # the slices and gathers are TP collectives the run without SP lacks
    assert (got["ranks"][0]["tp_collectives"]
            > want["ranks"][0]["tp_collectives"])


@pytest.mark.parametrize("key", DOTS)
def test_remat_dots_under_tp_equals_none_bitwise(runs, key):
    """Remat "dots" under tensor parallelism: the recomputation issues its
    TP collectives again, and the run equals remat "none" bit for bit."""
    got, want = (runs["result"][f"dots/{key}/{r}"] for r in ("dots", "none"))
    assert _same_run(got, want), (got["losses"], want["losses"])
    assert (got["ranks"][0]["tp_collectives"]
            > want["ranks"][0]["tp_collectives"])


def test_fsdp_tp_rank_state_is_a_quarter(runs):
    """A rank of the FSDP + TP run holds about a quarter of the state, the
    data-replicated TP run's ranks about half."""
    for name in TRAIN:
        got = runs["result"][f"{name}/fsdp"]["ranks"]
        want = runs["result"][f"{name}/repl"]["ranks"]
        whole = sum(r["state_bytes"] for r in got)
        assert max(r["state_bytes"] for r in got) < 0.3 * whole
        assert max(r["state_bytes"] for r in want) > 0.4 * whole


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def test_fsdp_tp_checkpoint_restores_in_the_jax_package(runs):
    """The FSDP + TP run's checkpoint holds whole leaves in the reference's
    format: the JAX package restores it (its AdaAlter state as the
    template), every leaf the array on disk."""
    import jax
    from repro.checkpoint import restore_checkpoint as jax_restore
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    from repro.configs.base import OptimizerConfig as JaxOpt
    from repro.core import optimizers as jax_opt
    from repro.core.sync_engine import SyncState
    from repro.models import build_model as jax_build_model
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(ARCHS["qwen"])),
                               param_dtype="float32")
    oc = JaxOpt(name="adaalter", lr=LR, warmup_steps=0)
    params = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    state = jax.eval_shape(jax_opt.make_optimizer(oc).init, params)
    directory = runs["root"] / "ck"
    got, step = jax_restore(str(directory), (params, state, SyncState.make()))
    assert step == STEPS
    with np.load(directory / f"step_{STEPS}" / "arrays.npz") as z:
        disk = [z[k] for k in z.files if not k.startswith("#2/")]
    flat = [np.asarray(a) for a in jax.tree_util.tree_leaves(got[:2])]
    assert sorted((a.shape, a.dtype.str) for a in flat) == sorted(
        (a.shape, a.dtype.str) for a in disk)
    assert sorted(float(np.sum(a, dtype=np.float64)) for a in flat) == sorted(
        float(np.sum(a, dtype=np.float64)) for a in disk)


def test_fsdp_tp_checkpoint_restores_on_one_rank(runs):
    """Restored on one rank, the checkpoint's whole parameters hold every
    rank's final tiles as the specs' parts, bit for bit, and its state's
    digest is the run's."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.core.sync_engine import make_sync_engine
    oc = _opt("adaalter", "")
    params = build_model(_cfg("qwen")).init(None, "meta")
    state = make_optimizer(oc).init(params)
    sync = make_sync_engine(oc, is_local=False, H=1).export_state()
    (p, s, _), step = restore_checkpoint(str(runs["root"] / "ck"),
                                         (params, state, sync))
    assert step == STEPS
    got = runs["result"]["qwen_sync/fsdp"]
    assert state_digest(p, s, worker_axis=False) == got["state_digest"]
    specs = runs["ref"]["specs"]["qwen_sync"]
    for r in range(4):
        coords = {"data": r // 2, "model": r % 2}
        for i, (w, sp) in enumerate(zip(leaves(p), specs)):
            assert np.array_equal(
                runs["arrays"][r][f"qwen_sync/fsdp/params/{i}"],
                _spec_part(w.numpy(), sp, coords))


def test_flat_checkpoint_restores_into_a_tp_per_leaf_run(runs):
    """A stacked flat run's checkpoint restores into the paper-style
    plan's tensor-parallel per-leaf run on (2, 2): its state is the
    stacked per-leaf restore's bit for bit, and the run carries on as the
    stacked one does (to LOSS_RTOL: the row-parallel sums add in another
    order)."""
    got = runs["result"]
    want = runs["stacked"]
    assert got[f"flat_restore/{FLAT_AT}"]["start_step"] == FLAT_AT
    assert (got[f"flat_restore/{FLAT_AT}"]["state_digest"]
            == want[FLAT_AT].state_digest)
    cont = got[f"flat_restore/{FLAT_TO}"]
    assert cont["sync_steps"] == want[FLAT_TO].sync_steps
    np.testing.assert_allclose(cont["losses"], want[FLAT_TO].losses,
                               rtol=LOSS_RTOL)


# --------------------------------------------------------------------------- #
# gathered-weight serving
# --------------------------------------------------------------------------- #
def _rank_rows(runs, name, what):
    """Every row's ``what`` of serving case ``name``: the arrays of the
    ranks at ``model`` index 0, in ``data`` order (a row's ``model`` ranks
    hold the same)."""
    models = SERVE[name][1][1]
    return np.concatenate([runs["arrays"][r][f"{name}/gather/{what}"]
                           for r in range(0, 4, models)], 0)


@pytest.mark.parametrize("name", list(SERVE))
def test_gathered_weight_serving_equals_tp_only_bitwise(runs, name):
    """Each rank's prefill logits and cache parts and 4 decode steps'
    logits and cache under the plan with gathered weights equal the same
    grid's with the weights whole over ``data``, bit for bit; a rank holds
    its tiles at rest (fewer values than TP-only) and gathers a layer
    group's parts as it runs."""
    res = runs["result"]
    got, want = res[f"{name}/gather"], res[f"{name}/tp"]
    assert got["rows"] == want["rows"]
    assert got["weight_values"] < want["weight_values"]
    assert got["gathers"] > 0 and want["gathers"] == 0
    for r in range(4):
        a = runs["arrays"][r]
        keys = [k.split("/", 2)[2] for k in a
                if k.startswith(f"{name}/gather/")]
        assert keys
        for k in keys:
            assert np.array_equal(a[f"{name}/gather/{k}"],
                                  a[f"{name}/tp/{k}"]), (r, k)


@pytest.mark.parametrize("name", list(SERVE))
def test_gathered_weight_serving_matches_the_reference(runs, name):
    """The prefill's last logits and 4 decode steps' logits of every row
    against the reference's ``build_serve_programs`` under the same plan
    (``weight_gather_serving``, FSDP over ``data``), to SERVE_RTOL."""
    ref = runs["ref"]["serve"][name]
    assert ref["plan"] == [True, ["data"]]
    want = runs["ref_arrays"]
    for what in ["prefill_logits"] + [f"decode_logits/{p}"
                                      for p in range(DECODE)]:
        got = _rank_rows(runs, name, what)
        assert _rel(got, want[f"{name}/{what}"]) < SERVE_RTOL, what

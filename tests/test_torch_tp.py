"""Tensor parallelism over the ``model`` ranks: Big LSTM and the dense
family, served and trained with each rank holding its parts of the
weights.

Groups of 2 (a 1 × 2 grid), 3 (1 × 3) and 4 (2 × 2) gloo ranks on the CPU
(``torch.distributed.run --standalone``), one launch a grid running every
case in turn, beside one subprocess that drives the JAX package on
Auto-axis ``("data", "model")`` meshes over 4 host devices. What must
hold:

  * the collectives (``core/comm.py``: ``tp_copy``, ``tp_sum``,
    ``tp_gather``) forward and backward equal their one-rank arithmetic
    bit for bit at M = 2 and 3 (float32 sums in rank order);
  * serving (``launch/serving.py``) reduced qwen2-7b and Big LSTM on
    (1, 2) and (2, 2), and qwen2-7b with ``attn_tp_pad`` on (1, 3),
    matches the reference's ``build_serve_programs`` on the same mesh:
    the prefill's last logits, each rank's cache part against the
    reference cache's shard (its spec the reference's), 8 decode steps'
    logits and the decode cache, to SERVE_RTOL; a prefill where every
    rank but the first drops its partial products falls outside it; a
    rank's weights are the specs' parts;
  * training (``launch/steps.py``) reduced Big LSTM and qwen2-7b, per
    leaf, Local AdaAlter with the int8 wire, H = 2, on (2, 2) matches the
    reference's ``train_loop`` on an Auto (2, 2) mesh (losses to
    LOSS_RTOL, schedule and comm bytes exactly) and the port's stacked
    2-worker run; η 2% off falls outside; each rank holds its parts of
    the reference's shape-safe specs; leaves the specs leave whole are
    equal bit for bit on a worker's two ranks;
  * a vocabulary the TP size does not divide leaves the vocabulary leaves
    whole and serves as one rank does;
  * remat ``"save_tp"`` equals ``"none"`` bit for bit on one rank and on
    two, and issues fewer TP collectives than ``"full"``;
  * a (2, 2) checkpoint resumes bit for bit and restores on one rank;
  * what this slice refused (FSDP beside TP, sequence parallelism, remat
    "dots" under TP) passes the checks and runs on a reduced config.

Every spawned group runs under a subprocess timeout and opens its process
group with a 60 s timeout, so a hung rank fails its fixture, not the suite.
"""
import dataclasses
import json
import os
import shutil
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
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.sharding import ShardingRules, param_shardings
from repro_torch.tree import leaves, unflatten_like

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 240          # seconds a spawned group may take in all
#: the port under tensor parallelism against the reference, float32 on
#: the CPU: the largest difference over the largest magnitude. Measured
#: 8.4e-7 to 1.25e-6 over the prefill and 8 decode steps' logits (the
#: row-parallel sums add their partials in another order); a prefill with
#: all partials but the first dropped is far outside.
SERVE_RTOL = 1e-5
#: training losses, float32 on the CPU, int8 wire, against the reference
#: and the stacked run: measured 3.8e-7 (qwen2-7b) and 7.6e-8 (Big LSTM);
#: η 2% off moves them 2.3e-4 and 1.1e-5
LOSS_RTOL = 2e-6
#: the metrics rows' norms and quantiles against the stacked run's:
#: measured ≤ 2.6e-6 (a worker's gradient norm; its gradients differ as
#: the losses do)
METRICS_RTOL = 1e-5
STEPS, H, BATCH, SEQ = 4, 2, 8, 16
PROMPT, NEW, SERVE_BATCH, DECODE = 12, 6, 4, 8
ARCHS = {"qwen": "qwen2-7b", "lstm": "biglstm"}
# serving cases: (arch, grid, attn_tp_pad)
SERVE = {"qwen_1x2": ("qwen", (1, 2), False),
         "lstm_1x2": ("lstm", (1, 2), False),
         "qwen_2x2": ("qwen", (2, 2), False),
         "lstm_2x2": ("lstm", (2, 2), False),
         "qwen_1x3_pad": ("qwen", (1, 3), True)}
OPT = dict(name="local_adaalter", lr=0.5, H=H, warmup_steps=0)


def _cfg(key, pad=False, **kw):
    return dataclasses.replace(reduced(get_arch(ARCHS[key]), **kw),
                               param_dtype="float32", attn_tp_pad=pad)


def _opt(**kw):
    return OptimizerConfig.from_sync(SyncConfig(compression="int8"),
                                     **{**OPT, "use_kernels": True, **kw})


def _shape():
    return ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")


REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.data import SyntheticLM
from repro.launch.mesh import resolve_plan
from repro.launch.serving import build_serve_programs, decode_cache_specs
from repro.launch.train import train_loop
from repro.models import build_model
from repro.sharding.partition import ShardingRules
from repro.sharding.specs import param_shardings

out, spec = sys.argv[1], json.loads(sys.argv[2])
arrays, res = {}, {"serve": {}, "train": {}, "train_specs": {}}

def cfg_of(key, pad=False):
    return dataclasses.replace(reduced(get_arch(spec["archs"][key])),
                               param_dtype="float32", attn_tp_pad=pad)

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

P, N, B, D = spec["prompt"], spec["new"], spec["batch"], spec["decode"]
for name, (key, grid, pad) in spec["serve"].items():
    cfg = cfg_of(key, pad)
    m = mesh(*grid)
    shape = ShapeConfig("decode_32k", seq_len=P + N, global_batch=B,
                        kind="decode")
    with m:
        progs = build_serve_programs(cfg, shape, m)
        params = progs.init_fn(jax.random.PRNGKey(0))
        prompts = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=P,
                              n_workers=1, seed=0).worker_batch(
                                  0, 0, B)["tokens"]
        logits, cache = progs.prefill(params, {"tokens": prompts})
        arrays[f"{name}/prefill_logits"] = np.asarray(logits)
        for i, c in enumerate(jax.tree_util.tree_leaves(cache)):
            arrays[f"{name}/prefill_cache/{i}"] = np.asarray(c)
        res["serve"][name] = {
            "prefill_cache_specs": specs(jax.tree_util.tree_map(
                lambda a: a.sharding, cache)),
            "cache_specs": specs(progs.cache_sharding),
            "param_specs": specs(progs.param_sharding)}
        cache = jax.tree_util.tree_map(lambda l: np.zeros(l.shape, l.dtype),
                                       decode_cache_specs(cfg, shape))
        for pos in range(D):
            logits, cache = progs.decode_step(
                params, cache, prompts[:, pos:pos + 1],
                np.full((B,), pos, np.int32))
            arrays[f"{name}/decode_logits/{pos}"] = np.asarray(logits)
        for i, c in enumerate(jax.tree_util.tree_leaves(cache)):
            arrays[f"{name}/decode_cache/{i}"] = np.asarray(c)

for key in spec["train"]:
    cfg = cfg_of(key)
    oc = OptimizerConfig.from_sync(SyncConfig(compression="int8"),
                                   **spec["opt"])
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["bs"],
                        kind="train")
    m = mesh(2, 2)
    r = train_loop(cfg, shape, oc, steps=spec["steps"], seed=0, mesh=m,
                   verbose=False)
    res["train"][key] = dict(losses=r.losses, sync_steps=r.sync_steps,
                             comm_bytes_total=r.comm_bytes_total,
                             n_workers=r.n_workers)
    plan = resolve_plan(cfg, m)
    stacked = jax.eval_shape(lambda k: jax.tree_util.tree_map(
        lambda x: x[None].repeat(2, 0), build_model(cfg).init(k)),
        jax.random.PRNGKey(0))
    res["train_specs"][key] = specs(param_shardings(
        ShardingRules(m, plan), stacked, with_workers=True))
np.savez(out + ".tmp.npz", **arrays)
os.replace(out + ".tmp.npz", out + ".npz")
json.dump(res, open(out + ".json", "w"))
"""

# one process group runs every case of its grid in turn; every rank writes
# its arrays, rank 0 the results
RANKS_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np, torch
from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, SyncConfig, get_arch, reduced)
from repro_torch.core import comm
from repro_torch.data import SyntheticLM
from repro_torch.launch import mesh
from repro_torch.launch.serving import build_serve_programs
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.sharding import ShardingRules
from repro_torch.sharding.partition import TensorParallel
from repro_torch.tree import leaves, tree_map, unflatten_like

torch.set_num_threads(1)
comm.MEAN_CHUNK = 4096
spec = json.load(open(sys.argv[1]))
out = sys.argv[2]
workers, shards = spec["grid"]
group, dev = mesh.init_ranks("gloo", "cpu", timeout_s=60,
                             grid={"data": workers, "model": shards})
me = group.rank
params0 = torch.load(spec["params0"])
arrays, res = {}, {}

def cfg_of(key, pad=False, **kw):
    return dataclasses.replace(reduced(get_arch(spec["archs"][key]), **kw),
                               param_dtype="float32", attn_tp_pad=pad)

def tp_of():
    plan = ParallelismPlan(local_axes=(), grad_axes=("data",), fsdp_axes=())
    return TensorParallel(group.along(("model",)),
                          ShardingRules(group.grid, plan))

# ---- the collectives against their one-rank arithmetic ------------------ #
if spec.get("collectives"):
    tp = tp_of()
    M, r = tp.size, tp.rank
    g = torch.Generator().manual_seed(5)
    xs = [torch.randn(3, 4 * M, generator=g) for _ in range(M)]
    ys = [torch.randn(3, 4 * M, generator=g) for _ in range(M)]
    def ordered(rows):
        acc = rows[0].clone()
        for t in rows[1:]:
            acc = acc + t
        return acc
    errs = {}
    x = xs[r].clone().requires_grad_()
    y = comm.tp_copy(x, tp.group)
    (gx,) = torch.autograd.grad(y, x, ys[r])
    errs["copy_fwd"] = bool(torch.equal(y, xs[r]))
    errs["copy_bwd"] = bool(torch.equal(gx, ordered(ys)))
    x = xs[r].clone().requires_grad_()
    y = comm.tp_sum(x, tp.group)
    (gx,) = torch.autograd.grad(y, x, ys[0])
    errs["sum_fwd"] = bool(torch.equal(y, ordered(xs)))
    errs["sum_bwd"] = bool(torch.equal(gx, ys[0]))
    x = xs[r].clone().requires_grad_()
    y = comm.tp_gather(x, tp.group, 1)
    (gx,) = torch.autograd.grad(y, x, ys[0].repeat(1, M))
    errs["gather_fwd"] = bool(torch.equal(y, torch.cat(xs, 1)))
    errs["gather_bwd"] = bool(torch.equal(
        gx, ys[0].repeat(1, M)[:, r * 4 * M:(r + 1) * 4 * M]))
    xb = xs[r].to(torch.bfloat16)      # a bf16 sum rounds once
    errs["sum_bf16"] = bool(torch.equal(comm.tp_sum(xb, tp.group), ordered(
        [t.to(torch.bfloat16).float() for t in xs]).to(torch.bfloat16)))
    # the backward on another thread, as autograd's CUDA engine runs it
    import threading
    box = {}
    x = xs[r].clone().requires_grad_()
    y = comm.tp_copy(x, tp.group)
    t = threading.Thread(target=lambda: box.update(g=torch.autograd.grad(
        y, x, ys[r])[0]))
    t.start(); t.join()
    errs["copy_bwd_thread"] = bool(torch.equal(box["g"], ordered(ys)))
    res["collectives"] = errs

# ---- serving ------------------------------------------------------------ #
P, N, B, D = spec["prompt"], spec["new"], spec["batch"], spec["decode"]
for name, (key, grid, pad) in spec["serve"].items():
    cfg = cfg_of(key, pad)
    shape = ShapeConfig("decode_32k", seq_len=P + N, global_batch=B,
                        kind="decode")
    progs = build_serve_programs(cfg, shape, group=group)
    parts = progs.param_parts(params0[key])
    prompts = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=P, n_workers=1,
        seed=0).worker_batch(0, 0, B)["tokens"])[progs.rows]
    logits, cache = progs.prefill(parts, {"tokens": prompts})
    arrays[f"{name}/prefill_logits"] = logits.numpy()
    for i, c in enumerate(leaves(cache)):
        arrays[f"{name}/prefill_cache/{i}"] = c.numpy()
    model = build_model(cfg)
    whole = model.init_cache(B, P + N, device="meta")
    cache = tree_map(torch.zeros_like, progs.cache_parts(
        tree_map(lambda t: torch.empty(t.shape), whole)))
    for pos in range(D):
        logits, cache = progs.decode_step(
            parts, cache, prompts[:, pos:pos + 1],
            torch.full((prompts.shape[0],), pos, dtype=torch.int32))
        arrays[f"{name}/decode_logits/{pos}"] = logits.numpy()
    for i, c in enumerate(leaves(cache)):
        arrays[f"{name}/decode_cache/{i}"] = c.numpy()
    res[name] = {"rows": [progs.rows.start, progs.rows.stop],
                 "part_shapes": [list(t.shape) for t in leaves(parts)],
                 "cache_specs": [[list(e) if isinstance(e, tuple) else e
                                  for e in sp] for sp in progs.cache_specs]}
    if name in spec.get("faults", ()):
        # every rank but the first drops its partial products
        real = comm.ordered_sum
        def first_only(g, x, count=None):
            real(g, x, count)
            return x.float().clone().to(x.dtype) if g.rank == 0 else \
                torch.zeros_like(x)
        comm.ordered_sum = first_only
        try:
            arrays[f"{name}/fault_logits"] = progs.prefill(
                parts, {"tokens": prompts})[0].numpy()
        finally:
            comm.ordered_sum = real

# ---- a vocabulary the TP size does not divide --------------------------- #
if spec.get("odd_vocab"):
    cfg = cfg_of("lstm", vocab=511)
    model = build_model(cfg)
    full = model.init(torch.Generator().manual_seed(0))
    shape = ShapeConfig("decode_32k", seq_len=P + N, global_batch=B,
                        kind="decode")
    progs = build_serve_programs(cfg, shape, group=group)
    parts = progs.param_parts(full)
    tokens = torch.randint(0, 511, (B, P), generator=torch.Generator(
        ).manual_seed(3))
    a = progs.prefill(parts, {"tokens": tokens})[0]
    b = model.prefill(full, {"tokens": tokens})[0]
    vocab = {n: list(parts[n].shape) for n in ("embed", "head_w", "head_b")}
    res["odd_vocab"] = {"shapes": vocab,
                        "cell_wx": list(parts["cells"][0]["wx"].shape),
                        "err": float((a - b).abs().max()
                                     / b.abs().max())}

# ---- remat on two ranks: save_tp = none bitwise, fewer collectives ------ #
if spec.get("remat"):
    cfg = cfg_of("qwen")
    tp = tp_of()
    model = build_model(cfg)
    from repro_torch.launch.serving import rank_parts
    from repro_torch.sharding import param_shardings
    splits = rank_parts(params0["qwen"], param_shardings(tp.rules,
                        params0["qwen"]), group.grid,
                        group.layout.coords_of(me))
    parts = unflatten_like(params0["qwen"], [
        s.take(t) for s, t in zip(splits, leaves(params0["qwen"]))])
    g = torch.Generator().manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (2, spec["seq"]), generator=g)
    batch = {"tokens": tok, "labels": torch.roll(tok, 1, 1)}
    runs = {}
    for remat in ("none", "full", "save_tp"):
        p = tree_map(lambda t: t.detach().requires_grad_(), parts)
        n0 = comm.tp.n
        loss, _ = model.loss_fn(p, batch, remat=remat, tp=tp)
        grads = torch.autograd.grad(loss, leaves(p))
        runs[remat] = (loss.detach(), grads, comm.tp.n - n0)
    res["remat"] = {
        r: {"equal": bool(torch.equal(runs[r][0], runs["none"][0]) and all(
            torch.equal(a, b) for a, b in zip(runs[r][1], runs["none"][1]))),
            "collectives": runs[r][2]} for r in runs}

# ---- training ----------------------------------------------------------- #
import repro_torch.launch.train as train_mod
captured = {}
real_digest = train_mod.state_digest
def capture(params, opt_state, **kw):       # the run's final state
    captured["state"] = (params, opt_state)
    return real_digest(params, opt_state, **kw)
train_mod.state_digest = capture
for case in spec.get("train", []):
    cfg = cfg_of(case["key"])
    oc = OptimizerConfig.from_sync(SyncConfig(**case["sync"]), **case["opt"])
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=case["batch"],
                        kind="train")
    r = train_loop(cfg, shape, oc, steps=case["steps"], seed=0,
                   n_workers=workers, verbose=False, device="cpu",
                   init_params=params0[case["key"]], group=group,
                   digest=True, checkpoint_dir=case.get("dir", ""),
                   checkpoint_every=case.get("every", 0),
                   **case.get("loop", {}))
    res[case["name"]] = dataclasses.asdict(r)
    if case.get("keep"):          # this rank's final parts of the params
        for i, t in enumerate(leaves(captured["state"][0])):
            arrays[f"{case['name']}/params/{i}"] = t.numpy()
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


def _train_case(name, key, **kw):
    opt = _opt()
    sync = {f: getattr(opt.sync, f) for f in SyncConfig.__dataclass_fields__}
    fields = {k: getattr(opt, k) for k in ("name", "lr", "H",
                                            "warmup_steps", "use_kernels")}
    return {"name": name, "key": key, "sync": sync, "opt": fields,
            "batch": BATCH, "steps": STEPS, **kw}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, the port's results on the three grids,
    its stacked runs, and the checkpoints."""
    root = tmp_path_factory.mktemp("tp")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    ref_out = str(root / "ref")
    ref_opt = {("use_pallas" if k == "use_kernels" else k): v
               for k, v in {**OPT, "use_kernels": False}.items()}
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, ref_out, json.dumps({
            "archs": ARCHS, "serve": SERVE, "train": ["lstm", "qwen"],
            "prompt": PROMPT, "new": NEW, "batch": SERVE_BATCH,
            "decode": DECODE, "opt": ref_opt, "seq": SEQ, "bs": BATCH,
            "steps": STEPS})],
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
    script = root / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    common = {"params0": str(root / "params0.pt"), "archs": ARCHS,
              "prompt": PROMPT, "new": NEW, "batch": SERVE_BATCH,
              "decode": DECODE, "seq": SEQ}
    groups = {
        (1, 2): {"collectives": True, "remat": True, "odd_vocab": True,
                 "faults": ["qwen_1x2"]},
        (1, 3): {"collectives": True},
        (2, 2): {"train": [
            _train_case("lstm", "lstm"),
            _train_case("qwen", "qwen", dir=str(root / "ck_a"), every=2,
                        keep=True),
            _train_case("qwen_first", "qwen", steps=2,
                        dir=str(root / "ck_b"), every=2),
            _train_case("qwen_resumed", "qwen", dir=str(root / "ck_b"),
                        every=2),
            _train_case("qwen_obs", "qwen", loop={
                "metrics_out": str(root / "tp.jsonl"),
                "trace_out": str(root / "tp.json")})]},
    }
    grids = {}
    for grid, extra in groups.items():
        tag = f"{grid[0]}x{grid[1]}"
        spec = root / f"spec_{tag}.json"
        spec.write_text(json.dumps({
            **common, **extra, "grid": list(grid),
            "serve": {n: c for n, c in SERVE.items()
                      if tuple(c[1]) == grid}}))
        out = root / f"out_{tag}.json"
        _wait(_launch(script, spec, out, grid[0] * grid[1]),
              f"the {tag} grid")
        grids[tag] = {"result": json.loads(out.read_text()), "arrays": [
            dict(np.load(f"{out}.rank{r}.npz"))
            for r in range(grid[0] * grid[1])]}
    restore = root / "ck_one"
    restore.mkdir()
    shutil.copytree(root / "ck_b" / "step_2", restore / "step_2")
    stacked = {}
    for key in ARCHS:
        for lr in (OPT["lr"], OPT["lr"] * 1.02):
            stacked[(key, lr)] = train_loop(
                _cfg(key), _shape(), _opt(lr=lr), steps=STEPS, seed=0,
                n_workers=2, verbose=False, device="cpu",
                init_params=params0[key], digest=True)
    train_loop(_cfg("qwen"), _shape(), _opt(), steps=STEPS, seed=0,
               n_workers=2, verbose=False, device="cpu",
               init_params=params0["qwen"],
               metrics_out=str(root / "stacked.jsonl"))
    stacked["restored"] = train_loop(
        _cfg("qwen"), _shape(), _opt(), steps=STEPS, seed=0, n_workers=2,
        verbose=False, device="cpu", init_params=params0["qwen"],
        checkpoint_dir=str(restore))
    try:
        log, _ = ref.communicate(timeout=GROUP_TIMEOUT)
    except subprocess.TimeoutExpired:
        ref.kill()
        raise
    assert ref.returncode == 0, log[-4000:]
    with np.load(ref_out + ".npz") as z:
        ref_arrays = dict(z)
    return dict(root=root, grids=grids, stacked=stacked, params0=params0,
                ref=json.loads(Path(ref_out + ".json").read_text()),
                ref_arrays=ref_arrays)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _spec_part(x, spec, grid, coords):
    from repro_torch.launch.serving import spec_part
    return spec_part(torch.from_numpy(np.ascontiguousarray(x)),
                     [tuple(e) if isinstance(e, list) else e for e in spec],
                     grid, coords).numpy()


# --------------------------------------------------------------------------- #
# the collectives
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tag", ["1x2", "1x3"])
def test_collectives_equal_one_rank(runs, tag):
    got = runs["grids"][tag]["result"]["collectives"]
    assert got and all(got.values()), got


# --------------------------------------------------------------------------- #
# serving against the reference's build_serve_programs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(SERVE))
def test_serving_matches_reference(runs, name):
    key, grid, _ = SERVE[name]
    tag = f"{grid[0]}x{grid[1]}"
    res = runs["grids"][tag]["result"][name]
    ref, ra = runs["ref"]["serve"][name], runs["ref_arrays"]
    gshape = {"data": grid[0], "model": grid[1]}
    # the port's cache specs are the reference's cache_shardings
    assert res["cache_specs"] == ref["cache_specs"]
    for r, arrays in enumerate(runs["grids"][tag]["arrays"]):
        coords = {"data": r // grid[1], "model": r % grid[1]}
        rows = slice(r // grid[1] * SERVE_BATCH // grid[0],
                     (r // grid[1] + 1) * SERVE_BATCH // grid[0])
        assert _rel(arrays[f"{name}/prefill_logits"],
                    ra[f"{name}/prefill_logits"][rows]) < SERVE_RTOL
        i = 0
        while f"{name}/prefill_cache/{i}" in ra:
            want = _spec_part(ra[f"{name}/prefill_cache/{i}"],
                              ref["prefill_cache_specs"][i], gshape, coords)
            got = arrays[f"{name}/prefill_cache/{i}"]
            assert got.shape == want.shape, (i, got.shape, want.shape)
            assert _rel(got, want) < SERVE_RTOL
            want = _spec_part(ra[f"{name}/decode_cache/{i}"],
                              ref["cache_specs"][i], gshape, coords)
            got = arrays[f"{name}/decode_cache/{i}"]
            assert got.shape == want.shape and _rel(got, want) < SERVE_RTOL
            i += 1
        assert i > 0
        for pos in range(DECODE):
            assert _rel(arrays[f"{name}/decode_logits/{pos}"],
                        ra[f"{name}/decode_logits/{pos}"][rows]) < SERVE_RTOL
        # a rank's weights are the reference's specs' parts
        for shape_, sp, t in zip(res["part_shapes"], ref["param_specs"],
                                 leaves(runs["params0"][key])):
            want = list(t.shape)
            for d, e in enumerate(sp):
                for a in ([] if e is None else e if isinstance(e, list)
                          else [e]):
                    want[d] //= gshape[a]
            assert shape_ == want


def test_serving_fault_exceeds_tolerance(runs):
    """Every rank but the first dropping its partial products (the
    row-parallel sums of wo, w2 and the vocab-split embedding)."""
    a = runs["grids"]["1x2"]["arrays"][0]
    ra = runs["ref_arrays"]
    assert _rel(a["qwen_1x2/fault_logits"],
                ra["qwen_1x2/prefill_logits"]) > 100 * SERVE_RTOL


def test_serving_splits_the_cache_sequence(runs):
    """On (1, 2) the KV cache is split along its sequence, each rank half
    of the one-rank cache's slots."""
    res = runs["grids"]["1x2"]["result"]["qwen_1x2"]
    assert res["cache_specs"][0] == [None, "data", "model", None, None]
    a = runs["grids"]["1x2"]["arrays"][0]
    assert a["qwen_1x2/decode_cache/0"].shape[2] == (PROMPT + NEW) // 2
    assert a["qwen_1x2/prefill_cache/0"].shape[2] == PROMPT // 2


def test_odd_vocabulary_stays_whole(runs):
    res = runs["grids"]["1x2"]["result"]["odd_vocab"]
    cfg = _cfg("lstm", vocab=511)
    assert res["shapes"] == {"embed": [511, cfg.lstm_proj],
                             "head_w": [cfg.lstm_proj, 511],
                             "head_b": [511]}
    assert res["cell_wx"] == [cfg.lstm_proj, 4 * cfg.d_model // 2]
    assert res["err"] < SERVE_RTOL


# --------------------------------------------------------------------------- #
# training against the reference's train_loop and the stacked run
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key", list(ARCHS))
def test_training_matches_reference(runs, key):
    got = runs["grids"]["2x2"]["result"][key]
    ref = runs["ref"]["train"][key]
    st = runs["stacked"][(key, OPT["lr"])]
    assert got["sync_steps"] == ref["sync_steps"] == st.sync_steps == [1, 3]
    assert got["comm_bytes_total"] == ref["comm_bytes_total"]
    assert got["n_workers"] == ref["n_workers"] == 2
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], st.losses, rtol=LOSS_RTOL)
    off = runs["stacked"][(key, OPT["lr"] * 1.02)]
    assert _rel(off.losses, ref["losses"]) > LOSS_RTOL


@pytest.mark.parametrize("key", list(ARCHS))
def test_training_ranks_hold_their_parts(runs, key):
    """Each rank's state is its parts of the reference's shape-safe specs
    ``with_workers`` (the worker axis over data, the rest over model)."""
    got = runs["grids"]["2x2"]["result"][key]
    specs = runs["ref"]["train_specs"][key]
    whole = leaves(runs["params0"][key])
    n = 0
    for t, sp in zip(whole, specs):
        size = t.numel()
        for e in sp[1:]:
            if e is not None:
                size //= 2
        n += size
    # params and B² sync/local, two residuals: fp32 each
    for rep in got["ranks"]:
        assert rep["state_bytes"] == 4 * 5 * n, (rep["rank"], n)
    assert any(e is not None for sp in specs for e in sp[1:])


def test_training_replicated_leaves_equal_on_a_workers_ranks(runs):
    arrays = runs["grids"]["2x2"]["arrays"]
    params = runs["params0"]["qwen"]
    rules = ShardingRules({"data": 2, "model": 2}, ParallelismPlan(
        local_axes=("data",)))
    specs = param_shardings(rules, params)
    n_whole = 0
    for i, sp in enumerate(specs):
        if any(e is not None for e in sp):
            continue
        for w in range(2):
            a, b = (arrays[2 * w + s][f"qwen/params/{i}"] for s in (0, 1))
            assert np.array_equal(a, b), i
        n_whole += 1
    assert n_whole >= 3                  # the norms at least


def test_checkpoint_resumes_bitwise_and_restores_on_one_rank(runs):
    res = runs["grids"]["2x2"]["result"]
    a, first, resumed = (res[k] for k in ("qwen", "qwen_first",
                                           "qwen_resumed"))
    assert resumed["start_step"] == 2
    assert resumed["losses"] == a["losses"][2:]
    assert resumed["sync_steps"] == [s for s in a["sync_steps"] if s >= 2]
    assert resumed["state_digest"] == a["state_digest"]
    assert first["losses"] == a["losses"][:2]
    one = runs["stacked"]["restored"]
    assert one.start_step == 2
    assert one.sync_steps == resumed["sync_steps"]
    np.testing.assert_allclose(one.losses, a["losses"][2:], rtol=LOSS_RTOL)
    # the checkpoint holds whole leaves, as the one-rank run writes them
    with np.load(runs["root"] / "ck_a" / "step_2" / "arrays.npz") as z:
        shapes = {k: z[k].shape for k in z.files}
    whole = build_model(_cfg("qwen")).init(None, "meta")
    assert shapes["#0/embed"] == (2,) + tuple(whole["embed"].shape)
    assert shapes["#0/blocks/#0/attn/wq"] == (2,) + tuple(
        whole["blocks"][0]["attn"]["wq"].shape)


# --------------------------------------------------------------------------- #
# remat
# --------------------------------------------------------------------------- #
def test_save_tp_equals_none_on_two_ranks(runs):
    got = runs["grids"]["1x2"]["result"]["remat"]
    assert got["full"]["equal"] and got["save_tp"]["equal"]
    assert got["save_tp"]["collectives"] < got["full"]["collectives"]
    assert got["none"]["collectives"] == got["save_tp"]["collectives"]


def test_save_tp_equals_none_on_one_rank(runs):
    cfg = _cfg("qwen")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (2, SEQ), generator=g)
    batch = {"tokens": tok, "labels": torch.roll(tok, 1, 1)}
    out = {}
    for remat in ("none", "save_tp"):
        p = {k: v for k, v in runs["params0"]["qwen"].items()}
        from repro_torch.tree import tree_map
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = model.loss_fn(p, batch, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, leaves(p)))
    assert torch.equal(out["none"][0], out["save_tp"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1],
                                                 out["save_tp"][1]))


# --------------------------------------------------------------------------- #
# what an earlier slice refused, now built
# --------------------------------------------------------------------------- #
#: per arch, a case that raised on model ranks before FSDP beside tensor
#: parallelism was ported: the plans above 20 B parameters (FSDP beside
#: TP), sequence parallelism, remat "dots" under TP, the synchronous plan,
#: gathered serving weights. Each passes the checks on a (2, 2) grid and
#: runs on a reduced config (on ranks: tests/test_torch_fsdp_tp.py)
REFUSED = {"phi3.5-moe-42b-a6.6b": "fsdp_plans",
           "llama4-maverick-400b-a17b": "fsdp_plans",
           "mamba2-370m": "seq_parallel",
           "hymba-1.5b": "remat_dots",
           "llama-3.2-vision-11b": "synchronous",
           "seamless-m4t-large-v2": "weight_gather_serving"}


def _one_step(cfg, opt, plan):
    """One step of ``cfg`` under ``plan`` on one device: its finite loss."""
    r = train_loop(cfg, ShapeConfig("t", seq_len=8, global_batch=2,
                                    kind="train"), opt, steps=1, seed=0,
                   verbose=False, device="cpu", plan=plan)
    assert all(np.isfinite(r.losses))
    return r


def _serve_once(cfg, plan):
    """The serving programs of ``cfg`` under ``plan`` on one device: a
    prefill's finite logits."""
    from repro_torch.launch.serving import build_serve_programs
    model = build_model(cfg)
    progs = build_serve_programs(cfg, ShapeConfig(
        "decode_32k", seq_len=8, global_batch=2, kind="decode"), plan=plan)
    batch = {"tokens": torch.zeros((2, 6), dtype=torch.int32)}
    if cfg.cross_attn_every:
        batch["image_embeds"] = torch.zeros((2, cfg.n_image_tokens,
                                             cfg.d_model))
    if cfg.is_encdec:
        batch["audio_frames"] = torch.zeros((2, 6, cfg.d_model))
    logits, _ = progs.prefill(model.init(torch.Generator().manual_seed(0)),
                              batch)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", list(REFUSED))
def test_other_families_refused_on_model_ranks(arch):
    """Every family trains and serves on model ranks at its reduced size
    (tensor parallelism over its layers); what an earlier slice refused
    (it raised naming ROADMAP item 9c-2b) now passes the checks on a
    (2, 2) grid and runs on the reduced config."""
    cfg = reduced(get_arch(arch))
    grid, serve_grid = {"data": 2, "model": 2}, {"data": 1, "model": 2}
    mesh.check_plan(mesh.resolve_plan(cfg, grid), grid, flat=False, cfg=cfg)
    mesh.check_serve_plan(cfg, serve_plan(cfg, serve_grid), serve_grid)
    case = REFUSED[arch]
    local = OptimizerConfig.from_sync(SyncConfig(compression="int8"),
                                      name="local_adaalter", lr=0.5, H=2,
                                      warmup_steps=0, use_kernels=True)
    if case == "fsdp_plans":          # the full config, > 20 B parameters
        full = get_arch(arch)
        plan = mesh.resolve_plan(full, grid)
        assert plan.local_axes == () and plan.fsdp_axes == ("data",)
        mesh.check_plan(plan, grid, flat=False, cfg=full)
        mesh.check_serve_plan(full, serve_plan(full, grid), grid)
        _one_step(cfg, local, plan)
        _serve_once(cfg, serve_plan(full, grid))
    elif case == "seq_parallel":
        sp = dataclasses.replace(cfg, seq_parallel=True)
        mesh.check_plan(mesh.resolve_plan(sp, grid), grid, flat=False,
                        cfg=sp)
        mesh.check_serve_plan(sp, serve_plan(sp, serve_grid), serve_grid)
        sync = OptimizerConfig(name="adaalter", lr=0.5, warmup_steps=0)
        plan = mesh.resolve_plan(sp, grid, optimizer="adaalter")
        a = _one_step(sp, sync, plan)
        b = _one_step(cfg, sync, plan)
        assert a.losses == b.losses and a.state_digest == b.state_digest
    elif case == "remat_dots":
        from repro_torch.models import transformer as tfm
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        x = torch.randn((1, 4, cfg.d_model),
                        generator=torch.Generator().manual_seed(1)).to(
                            getattr(torch, cfg.param_dtype))
        pos = torch.arange(4)[None]
        outs = [tfm.apply_stack(params["blocks"], cfg, x, pos,
                                remat=r)[0] for r in ("dots", "none")]
        assert torch.equal(*outs)
    elif case == "synchronous":
        plan = mesh.resolve_plan(cfg, grid, optimizer="adaalter")
        mesh.check_plan(plan, grid, flat=False, cfg=cfg)
        _one_step(cfg, OptimizerConfig(name="adaalter", lr=0.5,
                                       warmup_steps=0), plan)
    else:
        plan = dataclasses.replace(serve_plan(cfg, serve_grid),
                                   weight_gather_serving=True)
        mesh.check_serve_plan(cfg, plan, serve_grid)
        _serve_once(cfg, plan)


def test_synchronous_plan_refused_on_model_ranks():
    """The synchronous plan on a (2, 2) grid and the serving plan of a
    model above 20 B parameters pass the checks (they raised before FSDP
    beside tensor parallelism was ported); a synchronous run of reduced
    qwen2-7b under the plan builds and steps on one device."""
    cfg = reduced(get_arch("qwen2-7b"))
    grid = {"data": 2, "model": 2}
    plan = mesh.resolve_plan(cfg, grid, optimizer="adaalter")
    mesh.check_plan(plan, grid, flat=False, cfg=cfg)
    big = dataclasses.replace(get_arch("qwen2-7b"), n_layers=100)
    assert serve_plan(big, grid).weight_gather_serving
    mesh.check_serve_plan(big, serve_plan(big, grid), grid)
    _one_step(cfg, OptimizerConfig(name="adaalter", lr=0.5,
                                   warmup_steps=0), plan)
    # the earlier slices pass as before
    for arch in ("biglstm", "qwen2-7b", "phi4-mini-3.8b"):
        c = reduced(get_arch(arch))
        mesh.check_plan(mesh.resolve_plan(c, grid), grid, flat=False, cfg=c)
        mesh.check_serve_plan(c, serve_plan(c, grid), grid)


# --------------------------------------------------------------------------- #
# the command lines under torchrun
# --------------------------------------------------------------------------- #
def _cli(module, nproc, args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, "--device", "cpu",
         "--dist-backend", "gloo", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_command_lines_on_model_ranks(tmp_path):
    """``repro_torch.launch.serve --data 1`` on 3 ranks generates the
    one-rank tokens; ``repro_torch.launch.train --workers 2`` on 4 ranks
    (2 workers x 2 TP shards, per leaf) trains reduced qwen2-7b as the
    stacked run does (losses to LOSS_RTOL, schedule and bytes exactly)."""
    from repro_torch.launch.serve import serve_session
    out = tmp_path / "train.json"
    serve = _cli("repro_torch.launch.serve", 3, [
        "--data", "1", "--arch", "qwen2-7b", "--reduced", "--batch", "3",
        "--prompt-len", "6", "--new-tokens", "3"])
    train = _cli("repro_torch.launch.train", 4, [
        "--workers", "2", "--arch", "qwen2-7b", "--reduced",
        "--param-dtype", "float32", "--use-kernels", "--compress", "int8",
        "--lr", "0.5", "--warmup", "0", "--batch", "8", "--seq", "16",
        "--steps", "4", "--H", "2", "--out", str(out)])
    gen, _ = serve_session(reduced(get_arch("qwen2-7b")), batch=3,
                           prompt_len=6, new_tokens=3, device="cpu",
                           verbose=False)
    st = train_loop(_cfg("qwen"),
                    ShapeConfig("t", seq_len=16, global_batch=8,
                                kind="train"), _opt(), steps=4, seed=0,
                    n_workers=2, verbose=False, device="cpu")
    log = _wait(serve, "the serve command line")
    rows = [line.split("[", 1)[1].rstrip("]").split(", ")
            for line in log.splitlines() if line.strip().startswith("[")
            and line.strip()[1:2].isdigit()]
    assert [[int(v) for v in r] for r in rows] == gen.tolist()
    _wait(train, "the train command line")
    got = json.loads(out.read_text())
    assert got["sync_steps"] == st.sync_steps
    assert got["comm_bytes_total"] == st.comm_bytes_total
    assert len(got["ranks"]) == 4
    np.testing.assert_allclose(got["losses"], st.losses, rtol=LOSS_RTOL)


def test_checkpoint_restores_in_the_jax_package(runs):
    """The (2, 2) TP run's checkpoint is the reference's format with every
    leaf whole and both workers stacked: the JAX package restores it (its
    vmapped Local AdaAlter state as the template), every leaf the array on
    disk."""
    import jax
    from repro.checkpoint import restore_checkpoint as jax_restore
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    from repro.configs.base import OptimizerConfig as JaxOpt
    from repro.configs.base import SyncConfig as JaxSync
    from repro.core import optimizers as jax_opt
    from repro.core.sync_engine import SyncState
    from repro.models import build_model as jax_build_model
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(ARCHS["qwen"])),
                               param_dtype="float32")
    oc = JaxOpt.from_sync(JaxSync(compression="int8"), name=OPT["name"],
                          lr=OPT["lr"], H=H, warmup_steps=OPT["warmup_steps"])
    params = jax.eval_shape(lambda k: jax.tree_util.tree_map(
        lambda x: x[None].repeat(2, 0), jax_build_model(jcfg).init(k)),
        jax.random.PRNGKey(0))
    state = jax.eval_shape(jax.vmap(jax_opt.make_optimizer(oc).init), params)
    directory = runs["root"] / "ck_a"
    got, step = jax_restore(str(directory), (params, state, SyncState.make()))
    assert step == STEPS
    with np.load(directory / f"step_{STEPS}" / "arrays.npz") as z:
        disk = [z[k] for k in z.files if not k.startswith("#2/")]
    flat = [np.asarray(a) for a in jax.tree_util.tree_leaves(got[:2])]
    assert sorted((a.shape, a.dtype.str) for a in flat) == sorted(
        (a.shape, a.dtype.str) for a in disk)
    assert sorted(float(np.sum(a, dtype=np.float64)) for a in flat) == sorted(
        float(np.sum(a, dtype=np.float64)) for a in disk)


def _numbers(tree, path=()):
    """The numbers of a nested dict of a metrics row, by path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _numbers(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _numbers(sub, path + (i,)).items()}
    return {path: tree}


def test_metrics_rows_over_the_parts(runs):
    """Rank 0's metrics rows of the (2, 2) run hold the stacked run's
    numbers: the B² quantiles, residual norms and gradient norms taken
    over every rank's parts (a leaf the specs leave whole counted once)
    agree to METRICS_RTOL, the counts exactly; the trace has a span a
    worker a step."""
    root = runs["root"]
    with open(root / "tp.jsonl") as f:
        got = [json.loads(line) for line in f]
    with open(root / "stacked.jsonl") as f:
        want = [json.loads(line) for line in f]
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got[1:], want[1:]):
        for row in (g, w):
            row.pop("t_s", None)
            row["hists"].pop("step_time_s")
        # a rank's collectives move its parts: the shard count, a shard's
        # round bytes
        assert g["metrics"].pop("n_shards") == 2.0
        assert g["metrics"].pop("round_wire_bytes_per_shard") > 0
        a, b = _numbers(g), _numbers(w)
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], float) and not float(b[k]).is_integer():
                np.testing.assert_allclose(a[k], b[k], rtol=METRICS_RTOL,
                                           err_msg=str(k))
            else:
                assert a[k] == b[k], k
    trace = json.loads((root / "tp.json").read_text())
    steps = [sp for sp in trace["spans"] if sp["name"] == "local_step"]
    assert len(steps) == 2 * STEPS

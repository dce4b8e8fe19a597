"""Tensor parallelism over the ``model`` ranks for the SSM, hybrid, MoE,
VLM and encoder-decoder families, served and trained with each rank
holding its parts of the weights.

Groups of 2 (a 1 × 2 grid) and 4 (2 × 2 and 1 × 4) gloo ranks on the CPU
(``torch.distributed.run --standalone``), one launch a grid running every
case in turn, beside one subprocess that drives the JAX package on Auto-axis
``("data", "model")`` meshes over 4 host devices (serving and scoring,
then training). What must hold:

  * serving (``launch/serving.py``) reduced mamba2-370m, hymba-1.5b (its
    window cut to 6, so that 8 decode steps wrap its ring buffer),
    phi3.5-moe, llama4 (its shared expert row-parallel), llama-3.2-vision
    (gate 0.7) and seamless-m4t on (1, 2) and (2, 2) matches the
    reference's ``build_serve_programs`` on the same mesh: the prefill's
    last logits, each rank's cache part against the reference cache's
    shard (the SSM state's heads, the conv tail's channels, the KV and
    cross caches' sequence), 8 decode steps' logits from a cache holding
    the prefill's cross keys, and the decode cache, to SERVE_RTOL; a
    prefill where every rank but the first drops its partials (out_proj,
    the experts' combine) falls outside it; a rank's weights are the
    specs' parts;
  * a split inside an SSM head (reduced hymba at d_model 192 with heads
    of 64: 6 heads over 4 ranks, the whole SSM on every rank) and the
    SSM by heads beside a whole ``in_proj`` (reduced mamba2 at state 15)
    on (1, 4), the same way;
  * the TP scoring forward with ``ssm_pallas`` (the SSD on a rank's
    heads, its plain version on the CPU) against the reference's
    ``logits_fn`` with ``ssm_pallas`` on the same mesh (the reference's
    Pallas kernel in interpret mode);
  * training (``launch/steps.py``) reduced mamba2, hymba and phi3.5-moe,
    per leaf, Local AdaAlter with the int8 wire, H = 2, on (2, 2) matches
    the reference's ``train_loop`` on an Auto (2, 2) mesh (losses to
    LOSS_RTOL, schedule and comm bytes exactly) and the port's stacked
    2-worker run; η 2% off falls outside; each rank holds its parts of
    the reference's shape-safe specs.

Every spawned group runs under a subprocess timeout and opens its process
group with a 60 s timeout, so a hung rank fails its fixture, not the suite.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (OptimizerConfig, ShapeConfig, SyncConfig,
                                 get_arch, reduced)
from repro_torch.launch.train import train_loop
from repro_torch.tree import leaves

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 300          # seconds a spawned group may take in all
#: the port under tensor parallelism against the reference, float32 on
#: the CPU: the largest difference over the largest magnitude, as in
#: tests/test_torch_tp.py. Measured ≤ 1.3e-6 over every family's prefill
#: logits, ≤ 1.8e-6 over 8 decode steps', ≤ 1.1e-6 over the caches and
#: ≤ 1.3e-6 over the scoring forwards' (the row-parallel sums, and the
#: SSM's sum of squares over d_inner, add their partials in another
#: order); a prefill with all partials but the first dropped is 1.1-1.3
#: off.
SERVE_RTOL = 1e-5
#: the SSM state (float32) of the prefill and the decode, against the
#: reference's: its values decay through exp(Σ dt·A) over the sequence,
#: which turns the ulps of dt into relative errors of the state. Measured
#: 1.5e-6 in one run and up to 1.6e-5 in another (hymba, whose heads
#: decay to 1e-23; mamba2 at state 15): CPU products differ from run to
#: run in their last bits. The logits it feeds hold SERVE_RTOL
STATE_RTOL = 5e-5
#: training losses, float32, int8 wire, against the reference and the
#: stacked run: measured 6.0e-7 / 3.0e-7 (mamba2), 2.3e-7 / 3.0e-7
#: (hymba); η 2% off moves them 1.6e-4 and 1.8e-4
LOSS_RTOL = 2e-6
#: phi3.5-moe's last loss: the one-device run itself, its weights
#: perturbed by 1e-7 relative, lands on either of two branches at step 3
#: (6.25238 or 6.25353: a near-tied routing choice or int8 code), and the
#: TP run and the stacked run each take either from run to run (CPU
#: products differ in their last bits): measured 9.8e-7 against the
#: reference and 1.8e-4 against the stacked run in one run, 1.8e-4
#: against the reference in another. Its first three losses hold
#: LOSS_RTOL; η 2% off moves them 6.2e-4
BRANCH_RTOL = 3e-4
STEPS, H, BATCH, SEQ = 4, 2, 8, 16
PROMPT, NEW, SERVE_BATCH, DECODE = 12, 6, 4, 8
SCORE_SEQ = 32               # the scoring forward: two SSD chunks of 16
#: key -> (arch, changes to its reduced config)
ARCHS = {
    "mamba2": ("mamba2-370m", {}),
    # a window of 6 slots: 8 decode steps wrap the ring buffer, 3 slots a
    # rank at M = 2
    "hymba": ("hymba-1.5b", {"sliding_window": 6}),
    "phi": ("phi3.5-moe-42b-a6.6b", {}),
    "llama4": ("llama4-maverick-400b-a17b", {}),
    "vision": ("llama-3.2-vision-11b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
    # 6 SSM heads of 64 over 4 ranks: d_inner splits mid-head
    "hymba_mid": ("hymba-1.5b", {"sliding_window": 6, "d_model": 192,
                                 "ssm_head_dim": 64}),
    # in_proj's 1,070 and conv_w's 542 columns do not split over 4 ranks,
    # the 16 heads do
    "mamba2_n15": ("mamba2-370m", {"ssm_state": 15}),
}
FAMILIES = ("mamba2", "hymba", "phi", "llama4", "vision", "seamless")
SERVE = {**{f"{k}_1x2": (k, (1, 2)) for k in FAMILIES},
         **{f"{k}_2x2": (k, (2, 2)) for k in FAMILIES},
         "hymba_mid_1x4": ("hymba_mid", (1, 4)),
         "mamba2_n15_1x4": ("mamba2_n15", (1, 4))}
FAULTS = ("mamba2_1x2", "phi_1x2")
SCORE = ("mamba2", "hymba")
TRAIN = ("mamba2", "hymba", "phi")
CROSS_GATE = 0.7             # the VLM's tanh gate (0 at init)
OPT = dict(name="local_adaalter", lr=0.5, H=H, warmup_steps=0)


def _cfg(key, **kw):
    arch, changes = ARCHS[key]
    return dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32",
                               **changes, **kw)


def _opt(**kw):
    return OptimizerConfig.from_sync(SyncConfig(compression="int8"),
                                     **{**OPT, "use_kernels": True, **kw})


# the batch of a key, made with numpy from a seed, shared by both packages
EXTRAS = r"""
def extras(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.cross_attn_every:
        out["image_embeds"] = rng.standard_normal(
            (n, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.n_encoder_layers:
        out["audio_frames"] = rng.standard_normal(
            (n, spec["prompt"] + spec["new"], cfg.d_model)).astype(np.float32)
    return out
"""

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
from repro.launch.serving import (build_serve_programs, decode_cache_specs,
                                  serve_plan)
from repro.launch.train import train_loop
from repro.models import build_model
from repro.sharding.partition import ShardingRules, use_rules
from repro.sharding.specs import param_shardings

out, spec = sys.argv[1], json.loads(sys.argv[2])
arrays, res = {}, {"serve": {}, "score": {}, "train": {}, "train_specs": {}}
""" + EXTRAS + r"""
def cfg_of(key, **kw):
    arch, changes = spec["archs"][key]
    return dataclasses.replace(reduced(get_arch(arch)),
                               param_dtype="float32", **changes, **kw)

def mesh(w, s):
    return jax.make_mesh((w, s), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:w * s])

def specs(tree):
    return [[list(e) if isinstance(e, tuple) else e for e in sh.spec]
            for sh in jax.tree_util.tree_leaves(tree)]

def with_gates(params):
    # the VLM's tanh gates at CROSS_GATE (0 at init: the image layers
    # would add nothing)
    def one(path, x):
        if getattr(path[-1], "key", None) == "gate":
            return jax.device_put(np.full(x.shape, spec["gate"], x.dtype),
                                  x.sharding)
        return x
    return jax.tree_util.tree_map_with_path(one, params)

P, N, B, D = spec["prompt"], spec["new"], spec["batch"], spec["decode"]
# serving and scoring first, then training
for key in spec["archs"]:
    p = jax.jit(build_model(cfg_of(key)).init)(jax.random.PRNGKey(0))
    for i, leaf in enumerate(jax.tree_util.tree_leaves(p)):
        arrays[f"{key}/params/{i}"] = np.asarray(leaf)
np.savez(out + ".tmp.npz", **arrays)
os.replace(out + ".tmp.npz", out + ".params.npz")   # the weights first
arrays = {}
for name, (key, grid) in spec["serve"].items():
    cfg = cfg_of(key)
    m = mesh(*grid)
    shape = ShapeConfig("decode_32k", seq_len=P + N, global_batch=B,
                        kind="decode")
    with m:
        progs = build_serve_programs(cfg, shape, m)
        params = with_gates(progs.init_fn(jax.random.PRNGKey(0)))
        prompts = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=P,
                              n_workers=1, seed=0).worker_batch(
                                  0, 0, B)["tokens"]
        logits, pre = progs.prefill(params, {"tokens": prompts,
                                             **extras(cfg, B)})
        arrays[f"{name}/prefill_logits"] = np.asarray(logits)
        for i, c in enumerate(jax.tree_util.tree_leaves(pre)):
            arrays[f"{name}/prefill_cache/{i}"] = np.asarray(c)
        res["serve"][name] = {
            "prefill_cache_specs": specs(jax.tree_util.tree_map(
                lambda a: a.sharding, pre)),
            "cache_specs": specs(progs.cache_sharding),
            "param_specs": specs(progs.param_sharding)}
        # decode from a zero cache holding the prefill's cross keys
        cache = jax.tree_util.tree_map(
            lambda l: np.zeros(l.shape, l.dtype),
            decode_cache_specs(cfg, shape))
        for entry, got in zip(cache, pre):
            if "xkv" in entry:
                entry["xkv"] = tuple(np.asarray(t) for t in got["xkv"])
        for pos in range(D):
            logits, cache = progs.decode_step(
                params, cache, prompts[:, pos:pos + 1],
                np.full((B,), pos, np.int32))
            arrays[f"{name}/decode_logits/{pos}"] = np.asarray(logits)
        for i, c in enumerate(jax.tree_util.tree_leaves(cache)):
            arrays[f"{name}/decode_cache/{i}"] = np.asarray(c)
# the scoring forward on (1, 2) with the SSD kernel (interpret mode)
for key in spec["score"]:
    cfg = cfg_of(key, ssm_pallas=True)
    m = mesh(1, 2)
    rules = ShardingRules(m, serve_plan(cfg, m))
    model = build_model(cfg)
    p_sh = param_shardings(rules, jax.eval_shape(
        model.init, jax.random.PRNGKey(0)), with_workers=False)
    toks = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=spec["score_seq"],
                       n_workers=1, seed=2).worker_batch(0, 0, B)["tokens"]

    def score(p, b):
        with use_rules(rules):
            return model.logits_fn(p, b)
    with m:
        params = jax.jit(model.init, out_shardings=p_sh)(
            jax.random.PRNGKey(0))
        arrays[f"score/{key}"] = np.asarray(jax.jit(score)(
            params, {"tokens": toks}))
    res["score"][key] = {"tokens": toks.tolist()}
np.savez(out + ".tmp.npz", **arrays)
os.replace(out + ".tmp.npz", out + ".serve.npz")
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
from repro_torch.tree import leaves, tree_map

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
""" + EXTRAS + r"""
def cfg_of(key, **kw):
    arch, changes = spec["archs"][key]
    return dataclasses.replace(reduced(get_arch(arch)),
                               param_dtype="float32", **changes, **kw)

def batch_of(cfg, prompts, rows):
    return {"tokens": prompts, **{k: torch.from_numpy(v)[rows] for k, v in
                                  extras(cfg, spec["batch"]).items()}}

# ---- serving ------------------------------------------------------------ #
P, N, B, D = spec["prompt"], spec["new"], spec["batch"], spec["decode"]
for name, (key, grid) in spec["serve"].items():
    cfg = cfg_of(key)
    shape = ShapeConfig("decode_32k", seq_len=P + N, global_batch=B,
                        kind="decode")
    progs = build_serve_programs(cfg, shape, group=group)
    parts = progs.param_parts(params0[key])
    prompts = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=P, n_workers=1,
        seed=0).worker_batch(0, 0, B)["tokens"])[progs.rows]
    batch = batch_of(cfg, prompts, progs.rows)
    logits, pre = progs.prefill(parts, batch)
    arrays[f"{name}/prefill_logits"] = logits.numpy()
    for i, c in enumerate(leaves(pre)):
        arrays[f"{name}/prefill_cache/{i}"] = c.numpy()
    model = build_model(cfg)
    whole = model.init_cache(B, max(progs.cache_len, 1),
                             windowed=bool(progs.window),
                             cross_len=progs.cross_len, device="meta")
    cache = tree_map(torch.zeros_like, progs.cache_parts(
        tree_map(lambda t: torch.empty(t.shape), whole)))
    for entry, got in zip(cache, pre):     # the prefill's cross keys
        if "xkv" in entry:
            entry["xkv"] = got["xkv"]
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
        # every rank but the first drops its partials (out_proj's, the
        # experts' combine, every other row-parallel sum)
        real = comm.ordered_sum
        def first_only(g, x, count=None):
            real(g, x, count)
            return x.float().clone().to(x.dtype) if g.rank == 0 else \
                torch.zeros_like(x)
        comm.ordered_sum = first_only
        try:
            arrays[f"{name}/fault_logits"] = progs.prefill(
                parts, batch)[0].numpy()
        finally:
            comm.ordered_sum = real

# ---- the scoring forward with the SSD kernel on a rank's heads ---------- #
for key in spec.get("score", []):
    cfg = cfg_of(key, ssm_pallas=True)
    progs = build_serve_programs(cfg, ShapeConfig(
        "decode_32k", seq_len=P + N, global_batch=B, kind="decode"),
        group=group)
    tp = TensorParallel(group.along(("model",)), ShardingRules(
        group.grid, ParallelismPlan(local_axes=(), grad_axes=("data",))))
    toks = torch.from_numpy(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=spec["score_seq"], n_workers=1,
        seed=2).worker_batch(0, 0, B)["tokens"])
    with torch.inference_mode():
        arrays[f"score/{key}"] = build_model(cfg).logits_fn(
            progs.param_parts(params0[key]), {"tokens": toks},
            tp=tp).numpy()

# ---- training ----------------------------------------------------------- #
for case in spec.get("train", []):
    cfg = cfg_of(case["key"])
    oc = OptimizerConfig.from_sync(SyncConfig(**case["sync"]), **case["opt"])
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=case["batch"],
                        kind="train")
    r = train_loop(cfg, shape, oc, steps=case["steps"], seed=0,
                   n_workers=workers, verbose=False, device="cpu",
                   init_params=params0[case["key"]], group=group)
    res[case["name"]] = dataclasses.asdict(r)
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
    across with ``repro_torch.convert``; the VLM's gates at CROSS_GATE."""
    import jax
    from repro import configs as jcfgs
    from repro.models import build_model as jax_build_model
    from repro_torch import convert
    arch, changes = ARCHS[key]
    jcfg = dataclasses.replace(jcfgs.reduced(jcfgs.get_arch(arch)),
                               param_dtype="float32", **changes)
    abstract = jax.eval_shape(jax_build_model(jcfg).init,
                              jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten(abstract)
    params = convert.to_torch(jax.tree_util.tree_unflatten(
        treedef, [npz[f"{key}/params/{i}"] for i in range(len(flat))]))
    for block in params["blocks"]:
        if "gate" in block:
            block["gate"].fill_(CROSS_GATE)
    return params


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
    """The reference's results, the port's results on the three grids and
    its stacked runs. One reference subprocess and one group at a time
    (the groups one after another), as tests/test_torch_tp.py runs them:
    the suite's other workers share the CPU."""
    root = tmp_path_factory.mktemp("tp_families")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    ref_out = str(root / "ref")
    ref_opt = {("use_pallas" if k == "use_kernels" else k): v
               for k, v in {**OPT, "use_kernels": False}.items()}
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, ref_out, json.dumps({
            "archs": ARCHS, "serve": SERVE, "score": list(SCORE),
            "train": list(TRAIN), "prompt": PROMPT, "new": NEW,
            "batch": SERVE_BATCH, "decode": DECODE, "gate": CROSS_GATE,
            "score_seq": SCORE_SEQ, "opt": ref_opt, "seq": SEQ, "bs": BATCH,
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
              "decode": DECODE, "seq": SEQ, "score_seq": SCORE_SEQ}
    groups = {
        (1, 2): {"faults": list(FAULTS), "score": list(SCORE)},
        (2, 2): {"train": [_train_case(k, k) for k in TRAIN]},
        (1, 4): {},
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
    # the port's stacked runs, at the lr and with η 2% off
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    stacked = {(key, lr): train_loop(
        _cfg(key), shape, _opt(lr=lr), steps=STEPS, seed=0, n_workers=2,
        verbose=False, device="cpu", init_params=params0[key])
        for key in TRAIN for lr in (OPT["lr"], OPT["lr"] * 1.02)}
    _wait(ref, "the reference")
    with np.load(ref_out + ".serve.npz") as z:
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


def _close(got, want, rtol=SERVE_RTOL) -> bool:
    """Within ``rtol`` of the largest magnitude, or equal where the
    reference is zero (an untouched cache slot)."""
    if not np.abs(want).max():
        return not np.abs(got).max()
    return _rel(got, want) < rtol


def _state_leaves(key) -> set:
    """Indices of the SSM states among the cache's leaves (tree order)."""
    from repro_torch.models import build_model
    from repro_torch.tree import paths
    cache = build_model(_cfg(key)).init_cache(1, 6, cross_len=2,
                                              device="meta")
    return {i for i, p in enumerate(paths(cache))
            if "ssm" in p and p[-1] == "[0]"}


# --------------------------------------------------------------------------- #
# serving against the reference's build_serve_programs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(SERVE))
def test_serving_matches_reference(runs, name):
    key, grid = SERVE[name]
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
        err = _rel(arrays[f"{name}/prefill_logits"],
                   ra[f"{name}/prefill_logits"][rows])
        assert err < SERVE_RTOL, err
        i, states = 0, _state_leaves(key)
        while f"{name}/prefill_cache/{i}" in ra:
            tol = STATE_RTOL if i in states else SERVE_RTOL
            want = _spec_part(ra[f"{name}/prefill_cache/{i}"],
                              ref["prefill_cache_specs"][i], gshape, coords)
            got = arrays[f"{name}/prefill_cache/{i}"]
            assert got.shape == want.shape, (i, got.shape, want.shape)
            assert _close(got, want, tol), (i, _rel(got, want))
            want = _spec_part(ra[f"{name}/decode_cache/{i}"],
                              ref["cache_specs"][i], gshape, coords)
            got = arrays[f"{name}/decode_cache/{i}"]
            assert got.shape == want.shape, (i, got.shape, want.shape)
            assert _close(got, want, tol), (i, _rel(got, want))
            i += 1
        assert i > 0
        for pos in range(DECODE):
            err = _rel(arrays[f"{name}/decode_logits/{pos}"],
                       ra[f"{name}/decode_logits/{pos}"][rows])
            assert err < SERVE_RTOL, (pos, err)
        # a rank's weights are the reference's specs' parts
        for shape_, sp, t in zip(res["part_shapes"], ref["param_specs"],
                                 leaves(runs["params0"][key])):
            want = list(t.shape)
            for d, e in enumerate(sp):
                for a in ([] if e is None else e if isinstance(e, list)
                          else [e]):
                    want[d] //= gshape[a]
            assert shape_ == want


@pytest.mark.parametrize("name", FAULTS)
def test_serving_fault_exceeds_tolerance(runs, name):
    """Every rank but the first dropping its partials: out_proj's and the
    gated norm's sums in the SSM, the experts' combine in the MoE."""
    a = runs["grids"]["1x2"]["arrays"][0]
    ra = runs["ref_arrays"]
    assert _rel(a[f"{name}/fault_logits"],
                ra[f"{name}/prefill_logits"]) > 100 * SERVE_RTOL


def test_serving_splits_the_ssm_state_and_caches(runs):
    """On (1, 2) the SSM state splits by heads, the conv tail by channels,
    hymba's 6-slot ring into 3 slots a rank, the VLM's and the audio
    decoder's cross caches along their sequence; the experts by halves."""
    res = runs["grids"]["1x2"]["result"]
    a = runs["grids"]["1x2"]["arrays"][0]
    m2 = _cfg("mamba2")
    assert res["mamba2_1x2"]["cache_specs"] == [
        [None, "data", "model", None, None], [None, "data", None, "model"]]
    assert a["mamba2_1x2/decode_cache/0"].shape[2] == m2.n_ssm_heads // 2
    assert a["mamba2_1x2/decode_cache/1"].shape[3] == (
        m2.d_inner + 2 * m2.ssm_state) // 2
    # hymba's cache leaves: kv k, kv v, ssm S, ssm conv tail
    assert a["hymba_1x2/decode_cache/0"].shape[2] == 3
    assert a["vision_1x2/decode_cache/2"].shape[2] == (
        _cfg("vision").n_image_tokens // 2)
    assert a["seamless_1x2/decode_cache/2"].shape[2] == (PROMPT + NEW) // 2
    phi = _cfg("phi")
    w1 = [s for s in res["phi_1x2"]["part_shapes"]
          if len(s) == 4 and s[-1] == phi.d_ff]
    assert w1 and all(s[1] == phi.n_experts // 2 for s in w1)


def test_split_inside_an_ssm_head(runs):
    """6 heads of 64 over 4 ranks: out_proj and norm split mid-head, so
    every rank runs the whole SSM from the gathered parts, and the state
    stays whole; mamba2 at state 15 keeps in_proj and conv_w whole while
    its 16 heads split 4 a rank."""
    res = runs["grids"]["1x4"]["result"]
    cfg = _cfg("hymba_mid")
    assert cfg.n_ssm_heads % 4 and cfg.d_inner % 4 == 0
    specs = res["hymba_mid_1x4"]["cache_specs"]
    assert specs[2] == [None, "data", None, None, None]      # S whole
    specs = res["mamba2_n15_1x4"]["cache_specs"]
    assert specs[0] == [None, "data", "model", None, None]
    assert specs[1] == [None, "data", None, None]            # 542 % 4
    shapes = res["mamba2_n15_1x4"]["part_shapes"]
    m2 = _cfg("mamba2_n15")
    proj = 2 * m2.d_inner + 2 * m2.ssm_state + m2.n_ssm_heads
    assert [m2.n_layers, m2.d_model, proj] in shapes          # in_proj whole


# --------------------------------------------------------------------------- #
# the scoring forward with ssm_pallas
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key", SCORE)
def test_scoring_with_the_ssd_kernel_on_a_ranks_heads(runs, key):
    """logits_fn with ssm_pallas on (1, 2): the SSD on 8 of 16 heads a
    rank (its plain version on the CPU), against the reference's
    logits_fn with its Pallas kernel in interpret mode on the same mesh;
    both ranks hold the whole logits."""
    want = runs["ref_arrays"][f"score/{key}"]
    assert want.shape == (SERVE_BATCH, SCORE_SEQ, _cfg(key).vocab_size)
    for arrays in runs["grids"]["1x2"]["arrays"]:
        assert _rel(arrays[f"score/{key}"], want) < SERVE_RTOL


# --------------------------------------------------------------------------- #
# training against the reference's train_loop and the stacked run
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key", TRAIN)
def test_training_matches_reference(runs, key):
    got = runs["grids"]["2x2"]["result"][key]
    ref = runs["ref"]["train"][key]
    st = runs["stacked"][(key, OPT["lr"])]
    assert got["sync_steps"] == ref["sync_steps"] == st.sync_steps == [1, 3]
    assert got["comm_bytes_total"] == ref["comm_bytes_total"]
    assert got["n_workers"] == ref["n_workers"] == 2
    strict = STEPS - 1 if key == "phi" else STEPS
    tol = BRANCH_RTOL if key == "phi" else LOSS_RTOL
    for want in (ref["losses"], st.losses):
        np.testing.assert_allclose(got["losses"][:strict], want[:strict],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], want, rtol=tol)
    off = runs["stacked"][(key, OPT["lr"] * 1.02)]
    assert _rel(off.losses, ref["losses"]) > tol


@pytest.mark.parametrize("key", TRAIN)
def test_training_ranks_hold_their_parts(runs, key):
    """Each rank's state is its parts of the reference's shape-safe specs
    ``with_workers`` (the worker axis over data, the rest over model): the
    MoE's experts, the SSM's in_proj, conv_w, norm and out_proj split."""
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

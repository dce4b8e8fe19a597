"""FSDP over the data ranks: one model whose leaves the ranks hold in parts.

The synchronous plan (``grad_axes=fsdp_axes=("data",)``) and the plans
above 20 B parameters split each parameter leaf and its optimizer state
over the ``data`` ranks as the reference's per-leaf specs say
(``sharding/specs.py``); a local optimizer under a plan without worker
axes trains one model (the reference's one-model branch). What must hold:

  * the port's specs are the reference's (``logical_for_leaf``,
    ``ShardingRules.resolve``, ``shape_safe_spec``, which read only
    ``mesh.shape``) for every architecture under the paper-style,
    synchronous and above-20 B plans on four grids, and the reference's
    own expectations (its ``tests/test_sharding.py``) hold of the port;
  * groups of 2 and 3 gloo ranks on the CPU (``torch.distributed.run``)
    train reduced Big LSTM, qwen2-7b and phi3.5-moe under the FSDP plan
    bit for bit as under the replicated plan (``fsdp_axes=()``): losses,
    schedule, comm bytes and state digest; at ``data`` = 3 no reduced
    dimension divides, so nothing splits;
  * the 2-rank runs match the reference's ``train_loop`` on an Auto-axis
    ``(2, 1)`` mesh with the same plan to LOSS_RTOL; a run with η 2% off
    falls outside it;
  * each rank issues one params gather and one collective a leaf a step,
    moving ``comm.fsdp_step_bytes`` (4P at float32), and holds Σ part
    numel × itemsize of state;
  * FSDP ranks write the replicated run's checkpoint files byte for byte,
    which the JAX package restores; resumes cross the two plans bitwise;
    the metrics rows equal the replicated run's (counts exactly, norms to
    1e-6); with ``grad_clip`` the losses stay within 1e-6;
  * the one-model int8 encode of a part equals the whole leaf's encode,
    where the part holds whole 256-blocks and where it does not.

Every spawned group runs under a subprocess timeout and opens its process
group with a 60 s timeout, so a hung rank fails its fixture, not the suite.
"""
import dataclasses
import filecmp
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCHS, OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, SyncConfig, get_arch, reduced)
from repro_torch.core import comm
from repro_torch.launch import mesh
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.sharding import (GridLayout, LeafSplit, ShardingRules,
                                  leaf_split, logical_for_leaf,
                                  param_shardings, shape_safe_spec)
from repro_torch.tree import leaves, paths, unflatten_like

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
SEQ, BATCH, STEPS = 16, 8, 6
GROUP_TIMEOUT = 240         # seconds a spawned group may take in all
FSDP = ParallelismPlan(local_axes=(), grad_axes=("data",),
                       fsdp_axes=("data",))
REPL = dataclasses.replace(FSDP, fsdp_axes=())
INT8 = {"compression": "int8"}

# name: (arch, OptimizerConfig kwargs, SyncConfig kwargs); float32 params,
# warm-up 0, H 2 for the local runs (a one-model run syncs every step)
RUNS = {
    "sgd": ("biglstm", dict(name="sgd", lr=2.0), {}),
    "adagrad": ("biglstm", dict(name="adagrad", lr=0.5), {}),
    "adaalter": ("biglstm", dict(name="adaalter", lr=2.0), {}),
    "local_fp32": ("biglstm", dict(name="local_adaalter", lr=2.0), {}),
    "local_int8": ("biglstm", dict(name="local_adaalter", lr=2.0,
                                   use_kernels=True), INT8),
    "local_int8_3pass": ("biglstm", dict(name="local_adaalter", lr=2.0,
                                         use_kernels=True),
                         dict(compression="int8", fused=False)),
    "qwen2_adaalter": ("qwen2-7b", dict(name="adaalter", lr=2.0), {}),
    "qwen2_local_fp32": ("qwen2-7b", dict(name="local_adaalter", lr=2.0),
                         {}),
    # at lr 2 the int8 wire's rounding flips amplify qwen2's 1e-6 float
    # differences to 1.5e-4 by step 5, the port's one-device run as its
    # ranks (the fp32 wire holds 1.6e-7); at lr 0.5, 1.8e-5
    "qwen2_local_int8": ("qwen2-7b", dict(name="local_adaalter", lr=0.5,
                                          use_kernels=True), INT8),
    "phi_adaalter": ("phi3.5-moe-42b-a6.6b", dict(name="adaalter", lr=2.0),
                     {}),
    "phi_local_int8": ("phi3.5-moe-42b-a6.6b", dict(
        name="local_adaalter", lr=2.0, use_kernels=True), INT8),
}
# held against the reference on an Auto-axis (2, 1) mesh
REF_RUNS = ("adaalter", "sgd", "local_int8", "qwen2_local_fp32",
            "qwen2_local_int8", "phi_adaalter")
# with grad_clip, and with bf16 parameters (the gather moves 2 bytes)
EXTRA = {
    "clip": ("biglstm", dict(name="adaalter", lr=2.0, grad_clip=0.5), {}),
    "bf16_local_int8": ("biglstm", dict(name="local_adaalter", lr=2.0,
                                        use_kernels=True), INT8),
    # a bf16 model with a float32 leaf (the router): mixed itemsizes
    "bf16_phi_adaalter": ("phi3.5-moe-42b-a6.6b", dict(name="adaalter",
                                                      lr=2.0), {}),
}
CKPT = "local_int8"         # checkpoints, resumes and metrics
# also run under remat "full": the MoE's routing over the ranks recomputed
MOE_REMAT = ("phi_adaalter", "phi_local_int8")
ARCH_NAMES = sorted({a for a, _, _ in RUNS.values()})


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(reduced(get_arch(arch)), param_dtype=dtype)


def _opt(opt_kw, sync_kw, lr_scale=1.0):
    kw = {"H": 2, "warmup_steps": 0, **opt_kw}
    kw["lr"] *= lr_scale
    return OptimizerConfig.from_sync(SyncConfig(**sync_kw), **kw)


REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import ParallelismPlan, SyncConfig
from repro.launch.train import train_loop
from repro.models import build_model

out, spec = sys.argv[1], json.loads(sys.argv[2])
arrays = {}
for arch in spec["archs"]:
    cfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32")
    p0 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    arrays.update({f"{arch}/{i}": np.asarray(x) for i, x in
                   enumerate(jax.tree_util.tree_leaves(p0))})
np.savez(out + ".tmp.npz", **arrays)
os.replace(out + ".tmp.npz", out + ".npz")      # the weights first
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
plan = ParallelismPlan(local_axes=(), grad_axes=("data",),
                       fsdp_axes=("data",))
shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["batch"],
                    kind="train")
res = {}
for name, (arch, opt_kw, sync_kw) in spec["runs"].items():
    cfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32")
    opt_kw = {("use_pallas" if k == "use_kernels" else k): v
              for k, v in opt_kw.items()}
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), **{
        "H": 2, "warmup_steps": 0, **opt_kw})
    r = train_loop(cfg, shape, oc, steps=spec["steps"], seed=0, mesh=mesh,
                   plan=plan, verbose=False)
    res[name] = dict(losses=r.losses, sync_steps=r.sync_steps,
                     n_workers=r.n_workers,
                     comm_bytes_total=r.comm_bytes_total,
                     comm_bytes_modeled=r.comm_bytes_modeled)
json.dump(res, open(out + ".json", "w"))
"""

# one process group runs every case in turn; rank 0 writes the results
RANKS_SCRIPT = r"""
import dataclasses, json, shutil, sys
import torch
import torch.distributed as dist
from repro_torch.configs import (OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, SyncConfig, get_arch, reduced)
from repro_torch.core import comm
from repro_torch.launch import mesh
from repro_torch.launch.train import train_loop
from repro_torch.tree import unflatten_like

torch.set_num_threads(1)
# rows of the reduced models are chunked too (the CLI runs take the default)
comm.MEAN_CHUNK = 4096
spec = json.load(open(sys.argv[1]))
out = sys.argv[2]
group, dev = mesh.init_ranks("gloo", "cpu", timeout_s=60,
                             grid={"data": spec["world"], "model": 1},
                             fsdp_axes=("data",))
params0 = torch.load(spec["params0"])
res = {}
for case in spec["runs"]:
    cfg = dataclasses.replace(reduced(get_arch(case["arch"])),
                              param_dtype=case["dtype"])
    oc = OptimizerConfig.from_sync(SyncConfig(**case["sync"]), **case["opt"])
    shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=case["batch"],
                        kind="train")
    if case.get("resume_from"):
        if group.rank == 0:
            shutil.copytree(case["resume_from"], case["loop"]["checkpoint_dir"]
                            + "/" + case["resume_from"].split("/")[-1])
        dist.barrier()
    init = params0[case["arch"]] if case["dtype"] == "float32" else None
    r = train_loop(cfg, shape, oc, steps=case["steps"], seed=0,
                   verbose=False, device="cpu", init_params=init, group=group,
                   digest=True, plan=ParallelismPlan(**case["plan"]),
                   **case.get("loop", {}))
    res[case["name"]] = dataclasses.asdict(r)
if spec.get("backward_thread"):
    # reduced phi3.5-moe's loss and gradients on this rank's rows, routed
    # with the other ranks' as one batch: remat "none" with the backward
    # here, remat "full" with the backward (and so the groups'
    # recomputation) on another thread, as autograd runs it on CUDA
    import threading
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(reduced(get_arch("phi3.5-moe-42b-a6.6b")),
                              param_dtype="float32")
    model = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (spec["world"] * 4, spec["seq"] + 1),
                         generator=torch.Generator().manual_seed(0))
    mine = toks[group.rank * 4:(group.rank + 1) * 4]
    batch = {"tokens": mine[:, :-1], "labels": mine[:, 1:]}

    def grads(remat, elsewhere):
        p = [t.clone().requires_grad_() for t in
             leaves(params0["phi3.5-moe-42b-a6.6b"])]
        tree = unflatten_like(params0["phi3.5-moe-42b-a6.6b"], p)
        loss, _ = model.loss_fn(tree, batch, remat=remat, batch_group=group)
        out = {}
        run = lambda: out.update(g=torch.autograd.grad(loss, p))
        if elsewhere:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            run()
        return loss.detach(), out.get("g")

    (l0, g0), (l1, g1) = grads("none", False), grads("full", True)
    res["backward_thread"] = {
        "loss": bool(torch.equal(l0, l1)),
        "grads": g1 is not None and all(torch.equal(a, b)
                                        for a, b in zip(g0, g1))}
mesh.close_ranks()
if group.rank == 0:
    json.dump(res, open(out, "w"))
"""


def _params0(z, arch):
    """The reference's initial weights, poured into the port's tree (both
    walk their leaves in sorted-key order)."""
    abstract = build_model(_cfg(arch)).init(None, "meta")
    return unflatten_like(abstract, [
        torch.from_numpy(z[f"{arch}/{i}"])
        for i in range(len(leaves(abstract)))])


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and initial weights, and the port's runs
    with ranks under both plans (groups of 2 and of 3 ranks, side by side
    with the reference's subprocess), with their files."""
    import time
    root = tmp_path_factory.mktemp("fsdp")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    ref_out = str(root / "ref")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, ref_out, json.dumps({
            "archs": ARCH_NAMES, "seq": SEQ, "batch": BATCH,
            "steps": STEPS, "runs": {n: RUNS[n] for n in REF_RUNS}})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.monotonic()
    while not os.path.exists(ref_out + ".npz"):
        if ref.poll() is not None or time.monotonic() - t0 > GROUP_TIMEOUT:
            ref.kill()
            raise AssertionError("reference: no initial weights\n"
                                 + ref.communicate()[0][-4000:])
        time.sleep(0.2)
    with np.load(ref_out + ".npz") as z:
        params0 = {a: _params0(z, a) for a in ARCH_NAMES}
    torch.save(params0, root / "params0.pt")

    def case(name, plan, tag, *, batch=BATCH, steps=STEPS, dtype="float32",
             **loop):
        arch, opt_kw, sync_kw = {**RUNS, **EXTRA}[name]
        oc = _opt(opt_kw, sync_kw)
        sync = {f: getattr(oc.sync, f)
                for f in SyncConfig.__dataclass_fields__}
        fields = {k: getattr(oc, k) for k in (
            "name", "lr", "H", "warmup_steps", "use_kernels", "grad_clip")}
        return {"name": f"{name}/{tag}", "arch": arch, "dtype": dtype,
                "sync": sync, "opt": fields, "batch": batch, "steps": steps,
                "plan": dataclasses.asdict(plan), "loop": loop}

    ck = lambda tag: dict(checkpoint_dir=str(root / tag), checkpoint_every=3,
                          metrics_out=str(root / f"{tag}.jsonl"))
    two = [case(n, p, t) for n in RUNS for p, t in ((FSDP, "fsdp"),
                                                    (REPL, "repl"))]
    two += [case("clip", FSDP, "fsdp"), case("clip", REPL, "repl"),
            case("bf16_local_int8", FSDP, "fsdp", dtype="bfloat16"),
            case("bf16_local_int8", REPL, "repl", dtype="bfloat16"),
            case("bf16_phi_adaalter", FSDP, "fsdp", dtype="bfloat16"),
            case("bf16_phi_adaalter", REPL, "repl", dtype="bfloat16"),
            case(CKPT, FSDP, "ck_fsdp", **ck("ck_fsdp")),
            case(CKPT, REPL, "ck_repl", **ck("ck_repl")),
            dict(case(CKPT, FSDP, "resume_fsdp",
                      checkpoint_dir=str(root / "resume_fsdp"),
                      checkpoint_every=3),
                 resume_from=str(root / "ck_repl" / "step_3")),
            dict(case(CKPT, REPL, "resume_repl",
                      checkpoint_dir=str(root / "resume_repl"),
                      checkpoint_every=3),
                 resume_from=str(root / "ck_fsdp" / "step_3"))]
    remat = dataclasses.replace(FSDP, remat="full")
    two += [case(n, remat, "fsdp_remat") for n in MOE_REMAT]
    three = [case(n, p, t, batch=12) for n in ("adaalter", "local_int8")
             for p, t in ((FSDP, "fsdp"), (REPL, "repl"))]
    script = root / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    procs = {}
    for world, spec_runs in ((2, two), (3, three)):
        spec = root / f"spec{world}.json"
        spec.write_text(json.dumps({
            "params0": str(root / "params0.pt"), "runs": spec_runs,
            "world": world, "seq": SEQ, "backward_thread": world == 2}))
        procs[world] = _launch(script, spec, root / f"out{world}.json", world)
    for world, proc in procs.items():
        _wait(proc, f"the group of {world} ranks")
    try:
        log, _ = ref.communicate(timeout=GROUP_TIMEOUT)
    except subprocess.TimeoutExpired:
        ref.kill()
        raise
    assert ref.returncode == 0, log[-4000:]
    ranks = {w: json.loads((root / f"out{w}.json").read_text())
             for w in procs}
    with open(ref_out + ".json") as f:
        reference = json.load(f)
    return dict(root=root, reference=reference, ranks=ranks,
                params0=params0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_run(a, b):
    return all(a[k] == b[k] for k in ("losses", "sync_steps",
                                      "comm_bytes_total", "state_digest"))


def _max_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _same_files(a: Path, b: Path) -> bool:
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        filecmp.cmp(a / n, b / n, shallow=False) for n in names)


# --------------------------------------------------------------------------- #
# specs against the reference's
# --------------------------------------------------------------------------- #
GRIDS = [{"data": 2, "model": 1}, {"data": 2, "model": 2},
         {"data": 3, "model": 1}, {"data": 16, "model": 16}]
ABOVE_20B = ParallelismPlan(local_axes=(), grad_axes=("data",),
                            fsdp_axes=("data",), remat="full",
                            weight_gather_serving=True)


def _port_specs(arch, grid, plan):
    """The port's per-leaf specs of the full-width architecture (a leading
    worker axis under a plan with ``local_axes``)."""
    from repro_torch.sharding.partition import rule_overrides
    tree = build_model(get_arch(arch)).init(None, "meta")
    local = bool(plan.local_axes)
    if local:
        R = math.prod(grid[a] for a in plan.local_axes)
        tree = unflatten_like(tree, [torch.empty((R,) + tuple(x.shape),
                                                 device="meta")
                                     for x in leaves(tree)])
    rules = ShardingRules(grid, plan, rule_overrides(get_arch(arch)))
    return tree, param_shardings(rules, tree, with_workers=local)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_are_the_references(arch):
    """For the paper-style, synchronous and above-20 B plans on four
    grids: the port's resolved plans and per-leaf specs equal what the
    reference's logical_for_leaf, ShardingRules.resolve and
    shape_safe_spec give on the same paths and shapes."""
    import jax
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.base import ParallelismPlan as JaxPlan
    from repro.launch.mesh import resolve_plan as jax_resolve_plan
    from repro.models import build_model as jax_build_model
    from repro.sharding import partition as jp
    from repro.sharding import specs as js
    jcfg = jax_get_arch(arch)
    abstract = jax.eval_shape(jax_build_model(jcfg).init,
                              jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
    for grid in GRIDS:
        jmesh = SimpleNamespace(shape=dict(grid))
        plans = []
        for opt in ("local_adaalter", "adaalter"):
            plan = mesh.resolve_plan(get_arch(arch), grid, optimizer=opt)
            jplan = jax_resolve_plan(jcfg, jmesh, optimizer=opt)
            assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
            plans.append(plan)
        plans.append(ABOVE_20B)
        for plan in plans:
            jplan = JaxPlan(**dataclasses.asdict(plan))
            local = bool(plan.local_axes)
            tree, specs = _port_specs(arch, grid, plan)
            overrides = {}
            if getattr(jcfg, "expert_axes_2d", False):
                overrides["experts"] = ("model", "data")
            rules = jp.ShardingRules(jmesh, jplan, overrides or None)
            w = tuple(plan.local_axes)
            w = (w if len(w) > 1 else w[0]) if w else None
            assert len(flat) == len(specs)
            for (path, leaf), spec, names, t in zip(flat, specs, paths(tree),
                                                    leaves(tree)):
                shape = ((1,) if local else ()) + tuple(leaf.shape)
                assert tuple(t.shape[1 if local else 0:]) == leaf.shape
                jlog = js.logical_for_leaf(
                    path, SimpleNamespace(shape=shape, ndim=len(shape)),
                    skip_leading=1 if local else 0)
                assert logical_for_leaf(names, shape, skip_leading=1
                                        if local else 0) == jlog
                want = tuple(js.shape_safe_spec(leaf.shape,
                                                rules.resolve(jlog), jmesh))
                want += (None,) * (len(leaf.shape) - len(want))
                assert spec == (((w,) + want) if local else want), names


def _flat_specs(arch, plan, grid, with_workers):
    tree, specs = (build_model(get_arch(arch)).init(None, "meta"), None)
    if with_workers:
        tree, specs = _port_specs(arch, grid, plan)
    else:
        specs = param_shardings(ShardingRules(grid, plan), tree)
    return {"/".join(n.strip("[]") for n in p): s
            for p, s in zip(paths(tree), specs)}


def test_reference_sharding_expectations():
    """The expectations of the reference's tests/test_sharding.py, held of
    the port: the worker-axis regression (w1/w2/wq/wo keep their 'model'
    entry behind a prepended worker axis), the synchronous plan's w1/wo,
    the worker tuple of a multi-pod plan, the shape-safe drops, and the
    MoE expert axis."""
    grid = {"data": 16, "model": 16}
    pod = {"pod": 2, "data": 16, "model": 16}
    paper = ParallelismPlan(local_axes=("data",), grad_axes=(), fsdp_axes=())
    flat = _flat_specs("qwen2-7b", paper, grid, True)
    assert flat["blocks/0/mlp/w1"] == ("data", None, None, "model")
    assert flat["blocks/0/mlp/w2"] == ("data", None, "model", None)
    assert flat["blocks/0/attn/wq"] == ("data", None, None, "model")
    assert flat["blocks/0/attn/wo"] == ("data", None, "model", None)
    assert flat["embed"] == ("data", "model", None)
    assert flat["lm_head"] == ("data", None, "model")
    flat = _flat_specs("llama3-405b", FSDP, grid, False)
    assert flat["blocks/0/mlp/w1"] == (None, "data", "model")
    assert flat["blocks/0/attn/wo"] == (None, "model", "data")
    pods = ParallelismPlan(local_axes=("pod", "data"), grad_axes=(),
                           fsdp_axes=())
    flat = _flat_specs("qwen2-7b", pods, pod, True)
    assert flat["blocks/0/mlp/w1"] == (("pod", "data"), None, None, "model")
    assert shape_safe_spec((28, 128), ("model", None), grid) == (None, None)
    assert shape_safe_spec((32, 128), ("model", None), grid) == ("model",
                                                                 None)
    assert shape_safe_spec((4, 8), (("pod", "data"), None), pod) == ("pod",
                                                                     None)
    flat = _flat_specs("phi3.5-moe-42b-a6.6b", FSDP, grid, False)
    assert flat["blocks/0/moe/w1"] == (None, "model", "data", None)


def test_rules_and_overrides():
    """resolve maps the placeholders to the plan's axes and takes an axis
    once; 2-D experts override the table."""
    from repro_torch.sharding.partition import rule_overrides
    rules = ShardingRules({"data": 2, "model": 2}, FSDP)
    assert rules.resolve(("batch", "embed_fsdp", "mlp")) == ("data", None,
                                                            "model")
    assert rules.resolve(("workers", None)) == (None, None)
    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"),
                              expert_axes_2d=True)
    rules = ShardingRules({"data": 2, "model": 1}, FSDP,
                          rule_overrides(cfg))
    assert rules.resolve(("experts", "embed_fsdp")) == (("model", "data"),
                                                        None)


@pytest.mark.parametrize("shape,spec,parts,dim,whole", [
    ((512, 64), (None, "data"), 2, 1, False),    # runs of 32
    ((64, 1024), ("data", None), 2, 0, True),    # runs of 32 x 1024
    ((2, 256, 256), (None, "data", None), 2, 1, True),
    ((2, 256, 256), (None, None, "data"), 2, 2, False),
    ((512,), (None,), 1, None, True),
])
def test_leaf_split_take_and_part(shape, spec, parts, dim, whole):
    """A LeafSplit's parts tile the whole leaf along its dimension, take
    gives this rank's part contiguous, and whole_blocks says whether every
    256-block of the row-major order lies in one part."""
    grid = {"data": 2, "model": 1}
    x = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    got = []
    for r in range(2):
        s = leaf_split(shape, spec, grid, {"data": r, "model": 0})
        assert (s.parts, s.dim, s.split) == (parts, dim, parts > 1)
        assert s.whole_blocks(256) == whole
        part = s.take(x)
        assert part.is_contiguous() and tuple(part.shape) == s.part_shape
        got.append(part)
    if parts > 1:
        assert torch.equal(torch.cat(got, dim), x)
    else:
        assert got[0] is x


def test_leaf_split_refuses_two_split_dimensions():
    """A spec that splits two dimensions, one over ``data`` and one over
    ``model``, no longer raises: it gives each rank a tile (the ``data``
    part of its ``model`` part), and the four tiles put back in place are
    the whole leaf."""
    from repro_torch.sharding import TileSplit, tile_parts
    grid = {"data": 2, "model": 2}
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    back = torch.zeros_like(x)
    for d in range(2):
        for m in range(2):
            s = leaf_split((4, 4), ("data", "model"), grid,
                           {"data": d, "model": m})
            assert isinstance(s, TileSplit) and s.part_shape == (2, 2)
            tp, fsdp = tile_parts(s, grid)
            assert (tp.dim, tp.index, fsdp.dim, fsdp.index) == (1, m, 0, d)
            assert torch.equal(s.take(x), x[2 * d:2 * d + 2, 2 * m:2 * m + 2])
            s.part(back).copy_(s.take(x))
    assert torch.equal(back, x)


@pytest.mark.parametrize("workers,shards", [(2, 1), (2, 2), (3, 2)])
def test_grid_groups_along(workers, shards):
    """groups_along partitions the ranks by the other axes' indices; along
    data they are the worker sub-groups, along model the shard
    sub-groups; index_along is a rank's place in its sub-group."""
    layout = GridLayout(workers, shards)
    assert layout.groups_along(("data",)) == layout.worker_groups()
    assert layout.groups_along(("model",)) == layout.shard_groups()
    assert layout.groups_along(("data", "model")) == [list(range(
        layout.world))]
    assert layout.groups_along(()) == [[r] for r in range(layout.world)]
    for r in range(layout.world):
        w, s = layout.coords(r)
        assert layout.coords_of(r) == {"data": w, "model": s}
        assert layout.index_along(r, ("data",)) == (w, workers)


class _Parts:
    """A stand-in FSDP sub-group over every part of the whole leaves it
    was given: gather_leaves returns the wholes."""

    rank = 0

    def __init__(self, wholes):
        self.wholes = wholes

    def gather_leaves(self, parts, splits, count=None):
        return [self.wholes[id(p)] for p in parts]


@pytest.mark.parametrize("shape,spec", [((512, 64), (None, "data")),
                                        ((64, 1024), ("data", None)),
                                        ((2, 256, 256), (None, None, "data"))])
@pytest.mark.parametrize("nonneg", [False, True])
def test_part_encode_is_the_whole_leaf_encode(shape, spec, nonneg):
    """The one-model sync's int8 EF encode of each rank's part (in place
    where its runs hold whole 256-blocks, else from the gathered leaf) is
    that rank's part of the whole leaf's encode, bit for bit."""
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.sync_engine import ef_apply
    from repro_torch.launch.steps import LeafLayout
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(shape, generator=gen)
    x = x.abs() if nonneg else x
    e = torch.randn(shape, generator=gen) * 1e-2
    codec = get_codec("int8", use_kernels=True)
    want_w, want_r = ef_apply(x, e.clone(), codec, 0, clamp_nonneg=nonneg)
    for r in range(2):
        s = leaf_split(shape, spec, {"data": 2, "model": 1},
                       {"data": r, "model": 0})
        xp, ep = s.take(x), s.take(e)
        layout = LeafLayout([s], _Parts({id(xp): x, id(ep): e.clone()}))
        (w,), (res,) = layout.encode(codec, 256)([xp], [ep],
                                                 clamp_nonneg=nonneg)
        assert torch.equal(w, s.take(want_w))
        assert torch.equal(res, s.take(want_r))


def test_llama3_405b_registered():
    """llama3-405b, the synchronous FSDP plan's largest user: its count on
    the meta device is the reference's, resolve_plan gives it the
    synchronous FSDP plan, and its per-rank state on a 16 x 16 grid is
    printed from the specs (building it waits for several cards)."""
    from repro.configs import get_arch as jax_get_arch
    from repro.models.counting import count_params as jax_count
    from repro_torch.models.counting import count_params
    cfg = get_arch("llama3-405b")
    tree = build_model(cfg).init(None, "meta")
    n = sum(t.numel() for t in leaves(tree))
    assert n == count_params(cfg) == jax_count(jax_get_arch("llama3-405b"))
    assert n == 405_853_388_800
    grid = {"data": 16, "model": 16}
    for opt in ("local_adaalter", "adaalter"):
        plan = mesh.resolve_plan(cfg, grid, optimizer=opt)
        assert (plan.local_axes, plan.grad_axes, plan.fsdp_axes,
                plan.remat) == ((), ("data",), ("data",), "full")
    specs = param_shardings(ShardingRules(grid, plan), tree)
    part = sum(math.prod(t.shape) // math.prod(
        grid[a] for e in sp if e for a in ((e,) if isinstance(e, str)
                                           else e))
               for t, sp in zip(leaves(tree), specs))
    # bf16 params, fp32 B² (adaalter): each rank of the 256
    print(f"llama3-405b on 16 x 16: {part:,} values a rank, "
          f"{part * (2 + 4) / 1e9:.2f} GB of params and B²")
    assert n / 256 <= part < n / 16


# --------------------------------------------------------------------------- #
# runs with ranks: FSDP against the replicated plan and the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(RUNS) + list(EXTRA))
def test_fsdp_equals_replicated_bitwise(runs, name):
    got, want = (runs["ranks"][2][f"{name}/{t}"] for t in ("fsdp", "repl"))
    if name == "clip":           # the norm's parts add in another order
        assert _max_rel(got["losses"], want["losses"]) <= 1e-6
        assert got["sync_steps"] == want["sync_steps"]
        return
    assert _same_run(got, want), (got["losses"], want["losses"])
    assert got["n_workers"] == 1
    assert got["sync_steps"] == list(range(STEPS))   # every step syncs
    assert all(math.isfinite(v) for v in got["losses"])


@pytest.mark.parametrize("name", ["adaalter", "local_int8"])
def test_three_ranks_split_nothing_and_stay_bitwise(runs, name):
    """At data = 3 no reduced dimension divides: every leaf stays whole,
    the run is the replicated one, and no params gather runs."""
    got, want = (runs["ranks"][3][f"{name}/{t}"] for t in ("fsdp", "repl"))
    assert _same_run(got, want)
    n_leaves = len(leaves(build_model(_cfg("biglstm")).init(None, "meta")))
    for rep in got["ranks"]:
        assert rep["collectives"] == STEPS * n_leaves


@pytest.mark.parametrize("name", MOE_REMAT)
def test_moe_remat_on_ranks_equals_no_remat_bitwise(runs, name):
    """Reduced phi3.5-moe on two FSDP ranks under remat "full" (the plan
    of every model above 1e9 parameters): each group's recomputation routes
    the rank's rows with the other rank's as one batch again, so the run
    is the remat "none" run bit for bit."""
    got, want = (runs["ranks"][2][f"{name}/{t}"]
                 for t in ("fsdp_remat", "fsdp"))
    assert _same_run(got, want), (got["losses"], want["losses"])


@pytest.mark.parametrize("what", ["loss", "grads"])
def test_moe_recompute_on_another_thread_routes_the_whole_batch(runs, what):
    """On CUDA autograd runs the backward, and so remat's recomputation,
    on a thread of its own: with the backward on another thread, remat
    "full" gives remat "none"'s loss and gradients bit for bit."""
    assert runs["ranks"][2]["backward_thread"][what]


@pytest.mark.parametrize("name", REF_RUNS)
def test_fsdp_matches_reference(runs, name):
    ref, got = runs["reference"][name], runs["ranks"][2][f"{name}/fsdp"]
    assert got["sync_steps"] == ref["sync_steps"]
    assert got["comm_bytes_total"] == ref["comm_bytes_total"]
    assert got["comm_bytes_modeled"] == ref["comm_bytes_modeled"]
    assert got["n_workers"] == ref["n_workers"] == 1
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["adaalter", "local_int8"])
def test_a_wrong_step_size_leaves_the_tolerance(runs, name):
    """One model on one device with η 2% larger, from the same weights:
    off the reference by more than LOSS_RTOL."""
    arch, opt_kw, sync_kw = RUNS[name]
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    r = train_loop(_cfg(arch), shape, _opt(opt_kw, sync_kw, 1.02),
                   steps=STEPS, seed=0, verbose=False, device="cpu",
                   init_params=runs["params0"][arch], plan=FSDP)
    assert _max_rel(r.losses, runs["reference"][name]["losses"]) > LOSS_RTOL


@pytest.mark.parametrize("name", ["adaalter", "local_int8", "qwen2_adaalter",
                                  "bf16_local_int8", "bf16_phi_adaalter"])
def test_collectives_bytes_and_state_per_rank(runs, name):
    """Each FSDP step: one params gather and one collective a leaf (an
    all-to-all a split leaf, a gather_mean_ an unsplit one), moving
    fsdp_step_bytes (4P at float32 params, less with bf16 params, a float32
    leaf's 4 bytes a value in a bf16 model); each rank holds Σ part numel ×
    itemsize of params and state, which the replicated run holds whole."""
    from repro_torch.models.counting import count_params
    got = runs["ranks"][2][f"{name}/fsdp"]
    repl = runs["ranks"][2][f"{name}/repl"]
    arch, opt_kw, _ = {**RUNS, **EXTRA}[name]
    dtype = "bfloat16" if name.startswith("bf16") else "float32"
    cfg = _cfg(arch, dtype)
    tree = build_model(cfg).init(None, "meta")
    specs = param_shardings(ShardingRules({"data": 2, "model": 1}, FSDP),
                            tree)
    n_params = count_params(cfg)
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    isz = [t.element_size() for t in leaves(tree)]   # the router: float32
    n_entries = {"adaalter": 1, "local_adaalter": 4}[opt_kw["name"]]
    for rep, rep_repl in zip(got["ranks"], repl["ranks"]):
        splits = [leaf_split(t.shape, sp, {"data": 2, "model": 1},
                             {"data": rep["rank"], "model": 0})
                  for t, sp in zip(leaves(tree), specs)]
        n_split = sum(math.prod(s.shape) for s in splits if s.split)
        assert n_split > 0
        assert rep["collectives"] == STEPS * (1 + len(splits))
        split_b = sum(math.prod(s.shape) * b for s, b in zip(splits, isz)
                      if s.split)
        want = comm.fsdp_step_bytes(n_params, n_split, 2,
                                    split_bytes=split_b)
        assert rep["wire_bytes"] == STEPS * want
        if dtype == "float32":
            assert want == 4 * n_params
        if set(isz) == {item}:
            assert want == comm.fsdp_step_bytes(n_params, n_split, 2, item)
        else:      # a float32 leaf in a bf16 model moves 4 bytes a value
            assert want > comm.fsdp_step_bytes(n_params, n_split, 2, item)
        assert rep["state_bytes"] == sum(
            s.part_numel * (b + 4 * n_entries) for s, b in zip(splits, isz))
        assert rep_repl["state_bytes"] == sum(
            math.prod(s.shape) * (b + 4 * n_entries)
            for s, b in zip(splits, isz))
        assert rep_repl["collectives"] == STEPS * len(splits)


# --------------------------------------------------------------------------- #
# checkpoints, resumes and metrics under FSDP
# --------------------------------------------------------------------------- #
def test_checkpoints_equal_replicated_and_jax_restores(runs):
    """FSDP ranks write the replicated run's files byte for byte, at each
    checkpoint; the JAX package restores them, every leaf the bits on
    disk."""
    import jax
    import ml_dtypes
    from repro.checkpoint import restore_checkpoint as jax_restore
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    from repro.configs.base import OptimizerConfig as JaxOpt
    from repro.configs.base import SyncConfig as JaxSync
    from repro.core import optimizers as jax_opt
    from repro.core.sync_engine import SyncState
    from repro.models import build_model as jax_build_model
    root = runs["root"]
    for step in ("step_3", "step_6"):
        assert _same_files(root / "ck_fsdp" / step, root / "ck_repl" / step)
    arch, opt_kw, sync_kw = RUNS[CKPT]
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)),
                               param_dtype="float32")
    oc = JaxOpt.from_sync(JaxSync(**sync_kw), name=opt_kw["name"],
                          lr=opt_kw["lr"], H=2, warmup_steps=0)
    params = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    state = jax.eval_shape(jax_opt.make_optimizer(oc).init, params)
    got, step = jax_restore(str(root / "ck_fsdp"),
                            (params, state, SyncState.make()))
    assert step == STEPS
    with np.load(root / "ck_fsdp" / "step_6" / "arrays.npz") as z:
        disk = {k: z[k] for k in z.files}
    flat = jax.tree_util.tree_leaves(got[:2])
    assert len(flat) == len(disk) - 2            # and the SyncState's two
    assert sum(np.asarray(a).nbytes for a in flat) == sum(
        v.nbytes for k, v in disk.items() if not k.startswith("#2/"))
    for a in flat:
        assert np.asarray(a).dtype != ml_dtypes.bfloat16


@pytest.mark.parametrize("tag,straight", [("resume_fsdp", "ck_repl"),
                                          ("resume_repl", "ck_fsdp")])
def test_resume_across_the_plans_bitwise(runs, tag, straight):
    """A replicated run's step-3 checkpoint resumed under FSDP, and an FSDP
    run's under the replicated plan: losses 3-5 and the step-6 files equal
    the straight run's."""
    got = runs["ranks"][2][f"{CKPT}/{tag}"]
    want = runs["ranks"][2][f"{CKPT}/{straight}"]
    assert got["start_step"] == 3
    assert got["losses"] == want["losses"][3:]
    root = runs["root"]
    assert _same_files(root / tag / "step_6", root / straight / "step_6")


def _rows(path):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return lines[0], lines[1:]


def test_metrics_rows_equal_replicated(runs):
    """Rank 0's metrics stream under FSDP has the replicated run's rows:
    the B² quantiles (exact counts over the parts) and every count exactly,
    the gradient and residual norms to 1e-6."""
    root = runs["root"]
    head_f, rows_f = _rows(root / "ck_fsdp.jsonl")
    head_r, rows_r = _rows(root / "ck_repl.jsonl")
    assert head_f == head_r
    assert len(rows_f) == len(rows_r) == STEPS
    norms = ("grad_norm", "ef_residual_norm", "quant_mse")
    for a, b in zip(rows_f, rows_r):
        ma, mb = a["metrics"], b["metrics"]
        assert set(ma) == set(mb)
        assert any(k.startswith("b2{") for k in ma)
        assert any(k.startswith("ef_residual_norm") for k in ma)
        for k in ma:
            if k.startswith(norms):
                assert math.isclose(ma[k], mb[k], rel_tol=1e-6), k
            else:
                assert ma[k] == mb[k], k

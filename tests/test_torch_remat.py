"""Rematerialisation in training against the run without it and against
the JAX package's ``loss_fn(..., remat=)``.

Reduced hymba-1.5b, qwen2-7b and phi3.5-moe (its load-balance aux loss
included) in float32, weights carried across from the reference's
``init`` with ``repro_torch.convert``, one batch drawn with NumPy; the
reference runs in one subprocess. What must hold:

  * ``loss_fn(..., remat="full" | "dots")``, with and without
    ``attn_remat``, gives the loss and every gradient of ``remat="none"``
    bit for bit (the recomputed forward is the same program);
  * the port's loss and gradients match the reference's jitted
    ``value_and_grad`` of its ``loss_fn(..., remat=)`` to RTOL: the loss
    (and the aux loss) relative, each gradient leaf as its largest
    difference over its largest magnitude;
  * ``attn_remat`` on the blockwise path (2,100 tokens, past two 1,024-key
    blocks) as well;
  * the stacked run's plan takes its ``remat`` from ``resolve_plan`` as the
    reference's ``train_loop`` does, for every registered architecture,
    ``train_loop(plan=)`` overrides it, and the training step passes it to
    ``loss_fn``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.launch.mesh import resolve_plan as jax_resolve_plan
from repro.models import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import (ARCHS, OptimizerConfig, ParallelismPlan,
                                 ShapeConfig, get_arch, reduced)
from repro_torch.launch import mesh
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.tree import leaves, unflatten_like

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-4
FAMILIES = ("hymba-1.5b", "qwen2-7b", "phi3.5-moe-42b-a6.6b")
BATCH, SEQ = 2, 40
LONG = (2100, 1)            # (seq, batch): the blockwise path
# (arch, remat, attn_remat, seq, batch) the reference computes
REF_CASES = ([(a, r, False, SEQ, BATCH) for a in FAMILIES
              for r in ("none", "full", "dots")]
             + [("qwen2-7b", "save_tp", False, SEQ, BATCH)]
             + [("qwen2-7b", r, True, *LONG) for r in ("none", "full")])

# the reference's weights, and its loss, aux loss and gradient leaves for
# each case, in a subprocess whose XLA runs one Eigen thread (the suite
# runs beside it)
REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch, reduced
from repro.models import build_model

out, cases = sys.argv[1], json.loads(sys.argv[2])
arrays = {}
for arch, remat, attn_remat, seq, batch in cases:
    cfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32",
                              attn_remat=attn_remat)
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        arrays[f"{arch}/params/{i}"] = np.asarray(leaf)
    rng = np.random.default_rng(7)
    b = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (batch, seq))
                        .astype(np.int32)) for k in ("tokens", "labels")}

    def f(p):
        loss, metrics = model.loss_fn(p, b, remat=remat)
        return loss, metrics["aux"]
    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    key = f"{arch}|{remat}|{int(attn_remat)}|{seq}|{batch}"
    arrays[key + "/loss"] = np.asarray(loss)
    arrays[key + "/aux"] = np.asarray(aux)
    for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
        arrays[f"{key}/grad/{i}"] = np.asarray(g)
np.savez(out + ".tmp.npz", **arrays)
os.replace(out + ".tmp.npz", out + ".npz")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("remat") / "ref")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, out, json.dumps(REF_CASES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with np.load(out + ".npz") as z:
        return dict(z)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: CPU reductions split over threads add in an
    order that varies from call to call, which would make even two plain
    runs differ."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, attn_remat=False):
    kw = dict(param_dtype="float32", attn_remat=attn_remat)
    return (dataclasses.replace(jax_reduced(jax_get_arch(arch)), **kw),
            dataclasses.replace(reduced(get_arch(arch)), **kw))


_PARAMS = {}


def _setup(arch, reference, seq=SEQ, batch=BATCH):
    """The reference's float32 weights carried across, and one batch of
    tokens and labels drawn as the reference's subprocess draws it."""
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        abstract = jax.eval_shape(jax_build_model(jcfg).init,
                                  jax.random.PRNGKey(0))
        flat, treedef = jax.tree_util.tree_flatten(abstract)
        _PARAMS[arch] = convert.to_torch(jax.tree_util.tree_unflatten(
            treedef, [reference[f"{arch}/params/{i}"]
                      for i in range(len(flat))]))
    _, cfg = _cfgs(arch)
    rng = np.random.default_rng(7)
    b = {k: rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
         for k in ("tokens", "labels")}
    return _PARAMS[arch], b


_PORT = {}


def _port(reference, arch, remat, attn_remat=False, seq=SEQ, batch=BATCH):
    """(loss, aux, gradient leaves) of the port's loss_fn."""
    key = (arch, remat, attn_remat, seq, batch)
    if key not in _PORT:
        _, cfg = _cfgs(arch, attn_remat)
        params, b = _setup(arch, reference, seq, batch)
        p = [t.detach().clone().requires_grad_() for t in leaves(params)]
        loss, metrics = build_model(cfg).loss_fn(
            unflatten_like(params, p),
            {k: torch.from_numpy(v).long() for k, v in b.items()},
            remat=remat)
        grads = torch.autograd.grad(loss, p)
        _PORT[key] = (loss.detach(), metrics["aux"].detach(), grads)
    return _PORT[key]


def _reference(reference, arch, remat, attn_remat=False, seq=SEQ,
               batch=BATCH):
    key = f"{arch}|{remat}|{int(attn_remat)}|{seq}|{batch}"
    n = sum(k.startswith(key + "/grad/") for k in reference)
    return (float(reference[key + "/loss"]), float(reference[key + "/aux"]),
            [reference[f"{key}/grad/{i}"] for i in range(n)])


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("attn_remat", [False, True])
def test_remat_equals_plain_bitwise(reference, arch, remat, attn_remat):
    loss, aux, grads = _port(reference, arch, remat, attn_remat)
    want_loss, want_aux, want = _port(reference, arch, "none")
    assert torch.equal(loss, want_loss) and torch.equal(aux, want_aux)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def _close(got, ref):
    loss, aux, grads = got
    ref_loss, ref_aux, ref_grads = ref
    np.testing.assert_allclose(float(loss), ref_loss, rtol=RTOL)
    np.testing.assert_allclose(float(aux), ref_aux, rtol=RTOL, atol=1e-7)
    assert len(grads) == len(ref_grads)
    for g, r in zip(grads, ref_grads):
        g = g.numpy()
        assert g.shape == r.shape
        scale = max(float(np.max(np.abs(r))), 1e-30)
        assert float(np.max(np.abs(g - r))) <= RTOL * scale


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_matches_reference(reference, arch, remat):
    _close(_port(reference, arch, remat), _reference(reference, arch, remat))


def test_moe_aux_loss_is_trained(reference):
    """The MoE run's loss carries its load-balance term."""
    _, aux, _ = _port(reference, "phi3.5-moe-42b-a6.6b", "full")
    assert float(aux) > 0


@pytest.mark.parametrize("remat", ["none", "full"])
def test_attn_remat_on_the_blockwise_path(reference, remat):
    """2,100 tokens take the blockwise path (over 2 × 1,024 keys): with
    ``attn_remat`` bitwise the plain run, and the reference to RTOL."""
    arch = "qwen2-7b"
    got = _port(reference, arch, remat, True, *LONG)
    plain = _port(reference, arch, "none", False, *LONG)
    assert torch.equal(got[0], plain[0])
    assert all(torch.equal(g, w) for g, w in zip(got[2], plain[2]))
    _close(got, _reference(reference, arch, remat, True, *LONG))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stacked_plan_remat_is_the_references(arch):
    """``resolve_plan`` on a stacked run's grid (its workers along
    ``data``) gives the reference's ``remat`` for its mesh, for a local
    and a synchronous optimizer, and the stacked programs carry it."""
    from types import SimpleNamespace
    from repro_torch.launch.steps import build_train_programs
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert cfg.param_count() == jcfg.param_count()
    jmesh = SimpleNamespace(shape={"data": 1, "model": 1})
    for opt in ("local_adaalter", "adaalter"):
        plan = mesh.resolve_plan(cfg, {"data": 1, "model": 1}, optimizer=opt)
        want = jax_resolve_plan(jcfg, jmesh, optimizer=opt)
        assert plan.remat == want.remat
        assert (plan.local_axes, plan.grad_axes) == (want.local_axes,
                                                     want.grad_axes)
    progs = build_train_programs(cfg, OptimizerConfig(), n_workers=1,
                                 device="cpu")
    assert progs.plan.remat == ("full" if cfg.param_count() > 1e9
                                else "none")


def test_train_loop_trains_through_the_plans_remat(monkeypatch):
    """Reduced hymba (the plan: no remat) trained with ``plan=`` set to
    ``remat="full"``: the step calls ``loss_fn`` with it, every group is
    rematerialised, and the run equals the one without, bit for bit."""
    from repro_torch.launch.train import train_loop
    seen = []
    wrapped = tfm._rematerialised
    monkeypatch.setattr(tfm, "_rematerialised", lambda fn, remat: (
        seen.append(remat), wrapped(fn, remat))[1])
    cfg = dataclasses.replace(reduced(get_arch("hymba-1.5b")),
                              param_dtype="float32")
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    oc = OptimizerConfig(compression="int8", use_kernels=True, H=2,
                         warmup_steps=0)
    runs = {}
    for remat in ("none", "full"):
        seen.clear()
        plan = ParallelismPlan(remat=remat) if remat != "none" else None
        runs[remat] = train_loop(cfg, shape, oc, steps=3, n_workers=2,
                                 verbose=False, device="cpu", plan=plan,
                                 digest=True)
        # one stack per worker a step, each under the plan's policy
        assert seen == [remat] * (2 * 3)
    assert runs["full"].losses == runs["none"].losses
    assert runs["full"].state_digest == runs["none"].state_digest


@pytest.mark.parametrize("remat", ["save_tp", "everything"])
def test_unported_policies_raise(reference, remat):
    """A policy the reference does not name raises. ``"save_tp"`` is
    ported (it keeps the outputs of tensor parallelism's sums; on one rank
    it is ``"full"``): ``"none"``'s loss and gradients bit for bit, the
    reference's to RTOL."""
    if remat == "save_tp":
        got = _port(reference, "qwen2-7b", remat)
        plain = _port(reference, "qwen2-7b", "none")
        assert torch.equal(got[0], plain[0])
        assert all(torch.equal(g, w) for g, w in zip(got[2], plain[2]))
        _close(got, _reference(reference, "qwen2-7b", remat))
        return
    with pytest.raises(ValueError, match="remat"):
        _port(reference, "qwen2-7b", remat)

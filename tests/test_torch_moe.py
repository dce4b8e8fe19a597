"""The port's Mixture-of-Experts layer and MoE family against the JAX package's.

The router, the capacity drops, both forms of the layer (the reference's
one-hot ``moe_apply_einsum`` and its gather/scatter ``moe_apply_grouped``,
picked by ``cfg.moe_group_tokens``), the load-balance loss, llama4's shared
expert and period-2 group, and the reduced phi3.5-moe (16 experts cut to 4,
top-2) and llama4-maverick (128 cut to 4, top-1, shared expert, MoE every
other layer) through the Model API and ``serve_session``. Inputs come from
numpy seeds or the synthetic stream; weights from the reference's ``init``,
carried with ``repro_torch.convert``; the JAX side is jitted.

A zero router makes every probability tie: ``lax.top_k`` then picks the
lowest expert ids, and so must the port, so every token goes to experts 0
(and 1) and capacity drops most choices.

Tolerances, and why:
  * router: gate ids, positions and the kept mask exactly (they decide the
    routing); probabilities and gates rtol 1e-5 (a float32 softmax and a
    renormalising division each, which round apart by an ulp or two:
    measured 1.6e-6).
  * float32 layer and models: rtol 1e-4, atol 1e-5 (measured: ~2e-6 on
    logits of magnitude ~1.4). The same float32 products and sums in other
    orders; XLA contracts some into FMAs.
  * bfloat16 (the default dtype): rtol 2e-2, atol 3e-2 on values ~1-4, two
    bf16 ulps (measured: 1.4e-2 on logits, 3.9e-2 on one cache value of
    ~5): the compiled reference keeps some bf16 intermediates in float32.
    Caches to atol 5e-2. Losses rtol 1e-3, the aux loss rtol 1e-3.
  * greedy tokens of ``serve_session`` exactly, in float32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.launch import serving as jax_serving
from repro.launch.serve import serve_session as jax_serve_session
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.counting import count_active_params as jax_count_active
from repro.models.counting import count_params as jax_count_params
from repro_torch import convert
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch.serve import serve_session
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.counting import count_active_params, count_params
from repro_torch.tree import leaves

BF16 = ml_dtypes.bfloat16
PHI, LLAMA4 = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"
MOE = [PHI, LLAMA4]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=3e-2)}
CACHE_TOL = {"float32": TOL["float32"], "bfloat16": dict(rtol=2e-2, atol=5e-2)}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# the four full configs of this family and the next: the reference's counts
FULL_COUNTS = {PHI: 41_872_527_360, LLAMA4: 403_731_747_840,
               "llama-3.2-vision-11b": 9_775_157_256,
               "seamless-m4t-large-v2": 1_632_131_072}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_reduced(jax_get_arch(arch)),
                                param_dtype=dtype, **kw),
            dataclasses.replace(reduced(get_arch(arch)), param_dtype=dtype,
                                **kw))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol)


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #
def _layer(arch, dtype, seed=0, zero_router=False):
    """The reduced arch's MoE parameters from the reference's init_moe, in
    both packages."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    return jcfg, tcfg, jp, convert.to_torch(_np(jp))


def _x(shape, dtype, seed=1, skew=0.0):
    """Standard normal tokens plus ``skew`` times one shared direction,
    which tilts a random router towards some experts, each scaled to a
    root mean square of 1, as the layer's RMSNorm-ed inputs are."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
    x = (x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))).astype(
        np.float32)
    return x.astype(BF16) if dtype == "bfloat16" else x


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("tokens", [8, 96])
def test_router_matches_jax(arch, zero_router, tokens):
    jcfg, tcfg, jp, tp = _layer(arch, "float32", zero_router=zero_router)
    xt = _x((tokens, tcfg.d_model), "float32", skew=3.0)
    want = jax.jit(lambda p, x: jmoe._router(p, x, jcfg))(jp, jnp.asarray(xt))
    got = moe._router(tp, torch.from_numpy(xt), tcfg)
    gate_vals, gate_idx, probs, pos, keep, cap = got
    assert cap == want[5] == moe._capacity(tokens, tcfg.n_experts,
                                           tcfg.top_k, tcfg.capacity_factor)
    for g, w in ((gate_idx, want[1]), (pos, want[3]), (keep, want[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in ((gate_vals, want[0]), (probs, want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    if zero_router:                 # ties: the lowest ids, in order
        assert (gate_idx.numpy() == np.arange(tcfg.top_k)).all()
        assert np.allclose(probs.numpy(), 1.0 / tcfg.n_experts)
    if tokens == 96:                # cap 60 (top-2) or 30 (top-1) of 96
        assert not keep.all()
        dropped = ~keep.numpy()
        assert (gate_vals.numpy()[dropped] == 0).all()


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("grouped", [False, True])
def test_moe_layer_matches_both_jax_forms(arch, dtype, zero_router, grouped):
    """The port's moe_apply under each flag value against the reference's
    moe_apply_einsum and moe_apply_grouped, each; 2 x 48 tokens, so
    capacity drops choices (all but the first cap with a zero router)."""
    jcfg, tcfg, jp, tp = _layer(arch, dtype, zero_router=zero_router)
    tcfg = dataclasses.replace(tcfg, moe_group_tokens=grouped)
    x = _x((2, 48, tcfg.d_model), dtype, skew=3.0)
    with torch.inference_mode():
        out, aux = moe.moe_apply(tp, convert.to_torch(x), tcfg)
    assert out.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    for jfn in (jmoe.moe_apply_einsum, jmoe.moe_apply_grouped):
        want, jaux = jax.jit(lambda p, x: jfn(p, x, jcfg))(jp, jnp.asarray(x))
        _close(out, want, TOL[dtype])
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    _, _, _, _, keep, _ = moe._router(
        tp, convert.to_torch(x).reshape(96, -1), tcfg)
    assert not keep.all()             # capacity dropped some choices
    if zero_router:                   # all but cap of each expert's 96
        assert keep.float().mean() < 0.7


@pytest.mark.parametrize("arch", MOE)
def test_aux_loss_and_shared_expert(arch):
    """aux = router_aux_loss · E · Σ frac·prob, frac over every choice; the
    llama4 shared expert is an always-on MLP added to the routed output."""
    jcfg, tcfg, jp, tp = _layer(arch, "float32", seed=3)
    x = _x((2, 20, tcfg.d_model), "float32", seed=4)
    xt = torch.from_numpy(x).reshape(40, -1)
    _, gate_idx, probs, _, _, _ = moe._router(tp, xt, tcfg)
    counts = np.zeros(tcfg.n_experts)
    for e in gate_idx.numpy().ravel():
        counts[e] += 1
    expect = (tcfg.router_aux_loss * tcfg.n_experts
              * np.sum(counts / 40 * probs.numpy().mean(axis=0)))
    with torch.inference_mode():
        out, aux = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(float(aux), expect, rtol=1e-5)
        assert ("shared" in tp) == tcfg.shared_expert == (arch == LLAMA4)
        if tcfg.shared_expert:
            routed, _ = moe.moe_apply({k: v for k, v in tp.items()
                                       if k != "shared"}, torch.from_numpy(x),
                                      dataclasses.replace(tcfg,
                                                          shared_expert=False))
            from repro_torch.models.layers import mlp_apply
            shared = mlp_apply(tp["shared"], torch.from_numpy(x), tcfg.act)
            _close(out, routed + shared, TOL["float32"])


def test_llama4_period_two_group_and_widths():
    jcfg, tcfg = _cfgs(LLAMA4)
    assert tfm.group_kinds(tcfg) == jtfm.group_kinds(jcfg) == [
        "self_dense", "self_moe"]
    params = build_model(tcfg).init(torch.Generator().manual_seed(0))
    dense, sparse = params["blocks"]
    g = tcfg.n_layers // 2
    assert tuple(dense["mlp"]["w1"].shape) == (g, tcfg.d_model, tcfg.dense_d_ff)
    assert tuple(sparse["moe"]["w1"].shape) == (g, tcfg.n_experts,
                                                tcfg.d_model, tcfg.d_ff)
    assert tuple(sparse["moe"]["shared"]["w2"].shape) == (g, tcfg.dense_d_ff,
                                                          tcfg.d_model)


def test_router_is_float32_in_a_bf16_model():
    _, tcfg = _cfgs(PHI, "bfloat16")
    p = build_model(tcfg).init(torch.Generator().manual_seed(0))
    blk = p["blocks"][0]["moe"]
    assert blk["router"].dtype == torch.float32
    assert {blk[k].dtype for k in ("w1", "w3", "w2")} == {torch.bfloat16}


# --------------------------------------------------------------------------- #
# the Model API
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jp, convert.to_torch(_np(jp))


def _batch(seq, batch=2, seed=1):
    return SyntheticLM(vocab_size=512, seq_len=seq, seed=seed).worker_batch(
        0, 0, batch)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_logits_loss_and_aux_match_jax(arch, dtype):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    b = _batch(40)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = jax.jit(jm.logits_fn)(jp, jb)
    jloss, jmet = jax.jit(jm.loss_fn)(jp, jb)
    with torch.inference_mode():
        got = tm.logits_fn(tp, tb)
        loss, met = tm.loss_fn(tp, tb)
    assert got.shape == (2, 40, 512)
    _close(got, want, TOL[dtype])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL[dtype])
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(met["xent"]), float(jmet["xent"]),
                               rtol=LOSS_RTOL[dtype])
    assert float(met["aux"]) > 0
    np.testing.assert_allclose(float(loss), float(met["xent"] + met["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_caches_match_jax(arch, dtype):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    tokens = _batch(40)["tokens"]
    want, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    _close(got, want, TOL[dtype])
    jl, tl = jax.tree_util.tree_leaves(jcache), leaves(cache)
    assert [tuple(t.shape) for t in tl] == [x.shape for x in jl]
    for t, j in zip(tl, jl):
        _close(t, j, CACHE_TOL[dtype])


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_over_a_prompt_matches_jax(arch, dtype):
    """decode_step over 16 positions from a zero cache (each step routes the
    batch's 2 tokens: capacity 4, nothing dropped)."""
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, dtype)
    tokens = _batch(16)["tokens"]
    B, S = tokens.shape
    jcache, tcache = jm.init_cache(B, S), tm.init_cache(B, S)
    for t, j in zip(leaves(tcache), jax.tree_util.tree_leaves(jcache)):
        assert tuple(t.shape) == j.shape and not t.any()
    jstep = jax.jit(jm.decode_step)
    with torch.inference_mode():
        for p in range(S):
            pos = np.full((B,), p, np.int32)
            jl, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, p:p + 1]),
                               jnp.asarray(pos))
            tl, tcache = tm.decode_step(tp, tcache,
                                        torch.from_numpy(tokens[:, p:p + 1]),
                                        torch.from_numpy(pos))
            _close(tl, jl, TOL[dtype])


@pytest.mark.parametrize("arch", MOE)
def test_serve_session_generates_the_reference_tokens(arch):
    jcfg, tcfg = _cfgs(arch)
    batch, prompt_len, new_tokens, seed = 2, 12, 8, 0
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    shape = JaxShapeConfig(name="decode_32k", seq_len=prompt_len + new_tokens,
                           global_batch=batch, kind="decode")
    with mesh:
        jparams = jax_serving.build_serve_programs(jcfg, shape, mesh).init_fn(
            jax.random.PRNGKey(seed))
        want, _ = jax_serve_session(jcfg, batch=batch, prompt_len=prompt_len,
                                    new_tokens=new_tokens, seed=seed,
                                    mesh=mesh, verbose=False)
    stats = {}
    got, tps = serve_session(tcfg, batch=batch, prompt_len=prompt_len,
                             new_tokens=new_tokens, seed=seed, device="cpu",
                             params=convert.to_torch(_np(jparams)),
                             verbose=False, stats=stats)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert tps > 0 and stats["logits_finite"]


# --------------------------------------------------------------------------- #
# configurations and parameter counts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list(FULL_COUNTS))
def test_config_and_counts_match_reference(arch):
    assert arch in ARCHS
    jcfg, tcfg = jax_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(tcfg)) == dataclasses.asdict(
        jax_reduced(jcfg))
    assert count_params(tcfg) == jax_count_params(jcfg) == FULL_COUNTS[arch]
    assert count_active_params(tcfg) == jax_count_active(jcfg)
    small = reduced(tcfg)
    tree = build_model(small).init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in leaves(tree)) == count_params(small)


@pytest.mark.parametrize("arch", MOE)
def test_param_tree_has_the_reference_layout(arch):
    jcfg, tcfg, jm, tm, jp, tp = _setup(arch, "bfloat16")
    fresh = tm.init(torch.Generator().manual_seed(0))
    want = [(tuple(x.shape), str(x.dtype)) for x in
            jax.tree_util.tree_leaves(jp)]
    for tree in (tp, fresh):
        assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in leaves(tree)] == want

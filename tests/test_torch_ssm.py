"""The port's mamba2 (SSM) inference path against the JAX package's.

Inputs are drawn with numpy from a seed; weights come from the JAX
package's ``init`` and cross with ``repro_torch.convert``. JAX runs on the
CPU, its Pallas SSD kernel in interpret mode.

Tolerances, and why:
  * SSD chunk scan: 1e-4 (rtol and atol) for float32 inputs and 3e-2 for
    bfloat16 inputs, the reference's own (``tests/test_kernels.py``). Both
    sides compute in float32, but ``jnp.cumsum`` / ``torch.cumsum`` and the
    two frameworks' CPU matrix products sum in other orders.
  * Model in float32: rtol 1e-4, atol 1e-5 (measured: ~1.5e-6 on logits of
    magnitude ~1.3) — the same products summed in other orders. The
    softplus of ``dt`` is ``logaddexp(x, 0)`` on both sides (PyTorch's
    ``F.softplus`` would switch to x above its threshold of 20).
  * Model in bfloat16 (the default): atol 3e-2, a few bf16 ulps of values
    ~1, as ``tests/test_torch_model.py`` states for the Big LSTM: the two
    frameworks round the bf16 products at other places. The fp32 loss to
    rtol 1e-3, the fp32 SSM state to rtol 1e-3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JaxModelConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.models.counting import count_params as jax_count_params
from repro_torch import convert
from repro_torch.configs import ModelConfig, get_arch, reduced
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import (ssd_chunk_output_ref, ssd_chunk_states_ref,
                                    ssd_chunked, ssd_ref, ssd_state_pass_ref)
from repro_torch.models import build_model, ssm
from repro_torch.models.counting import count_params
from repro_torch.models.model import softmax_xent
from repro_torch.tree import leaves

SSD_SHAPES = [
    # (b, nz, c, nh, hd, n), as tests/test_kernels.py
    (1, 2, 8, 2, 16, 8),
    (2, 4, 16, 4, 32, 16),
    (2, 3, 32, 2, 64, 32),
    (1, 8, 64, 2, 64, 128),      # production-like chunk/state dims
]
VOCAB = 128


def _ssd_inputs(dims, dtype):
    b, nz, c, nh, hd, n = dims
    rng = np.random.default_rng(sum(dims))
    xbar = rng.standard_normal((b, nz, c, nh, hd)) * 0.2
    Bm = rng.standard_normal((b, nz, c, n)) * 0.3
    Cm = rng.standard_normal((b, nz, c, n)) * 0.3
    dA = (-np.abs(rng.standard_normal((b, nz, c, nh))) * 0.1).astype(np.float32)
    return [a.astype(dtype) for a in (xbar, Bm, Cm)] + [dA]


@pytest.mark.parametrize("dims", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_ssd_ref_matches_jax_kernel_and_oracle(dims, dtype):
    arrays = _ssd_inputs(dims, dtype)
    y_kernel = np.asarray(jax.jit(functools.partial(
        jax_ssd_scan, interpret=True))(*map(jnp.asarray, arrays)))
    y_oracle = np.asarray(jax.jit(jax_ssd_ref)(*map(jnp.asarray, arrays)))
    y = ssd_ref(*convert.to_torch(arrays))
    assert y.dtype == torch.float32 and y.shape == dims[:5]
    tol = 1e-4 if dtype == np.float32 else 3e-2
    for want in (y_kernel, y_oracle):
        np.testing.assert_allclose(y.numpy(), want, rtol=tol, atol=tol)


def test_ssd_scan_wrapper_on_cpu_is_the_plain_version():
    for dtype in (np.float32, ml_dtypes.bfloat16):
        args = convert.to_torch(_ssd_inputs(SSD_SHAPES[1], dtype))
        ssd_mod.launches.reset()
        y = ssd_mod.ssd_scan(*args)
        assert ssd_mod.launches.n == 0          # no kernel on the CPU
        assert torch.equal(y, ssd_ref(*args))


def test_ssd_scan_refuses_autograd_and_bad_shapes():
    xbar, Bm, Cm, dA = convert.to_torch(_ssd_inputs(SSD_SHAPES[0], np.float32))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_mod.ssd_scan(xbar.requires_grad_(True), Bm, Cm, dA)
    with torch.no_grad():                      # nothing recorded: allowed
        ssd_mod.ssd_scan(xbar, Bm, Cm, dA)
    xbar = xbar.detach()
    with pytest.raises(ValueError, match="dA"):
        ssd_mod.ssd_scan(xbar, Bm, Cm, dA[..., :1])
    with pytest.raises(ValueError, match="Bm and Cm"):
        ssd_mod.ssd_scan(xbar, Bm, Cm[..., :4], dA)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_mod.ssd_scan(xbar.double(), Bm, Cm, dA)


def _np_cum(dA):
    return np.cumsum(dA.astype(np.float64), axis=2)                # (b,nz,c,nh)


@pytest.mark.parametrize("dims", SSD_SHAPES)
def test_ssd_chunk_states_ref_is_the_einsum(dims):
    """Stage 1 against the einsum it replaces, in float64: each chunk's
    state Σₛ B[s]ᵀ·exp(cum_last − cum[s])·x̄[s] and its decay."""
    xbar, Bm, _, dA = _ssd_inputs(dims, np.float32)
    cum = _np_cum(dA)
    seg = np.exp(cum[:, :, -1:, :] - cum)
    want = np.einsum("bzsn,bzsh,bzshp->bzhnp", Bm.astype(np.float64), seg,
                     xbar.astype(np.float64))
    states, decay = ssd_chunk_states_ref(*convert.to_torch([xbar, Bm, dA]))
    assert states.dtype == torch.float32 and decay.dtype == torch.float32
    np.testing.assert_allclose(states.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(decay.numpy(), np.exp(cum[:, :, -1, :]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dims", SSD_SHAPES)
def test_ssd_state_pass_ref_is_the_loop(dims):
    """Stage 2 against the recurrence written as a loop in float64: the
    state entering chunk z is Σ_{z' < z} states[z']·Π_{z' < u < z} decay[u]."""
    xbar, Bm, _, dA = _ssd_inputs(dims, np.float32)
    states, decay = ssd_chunk_states_ref(*convert.to_torch([xbar, Bm, dA]))
    S_before, S_last = ssd_state_pass_ref(states, decay)
    st, dc = states.numpy().astype(np.float64), decay.numpy().astype(np.float64)
    want = np.zeros_like(st)
    S = np.zeros_like(st[:, 0])
    for z in range(st.shape[1]):
        want[:, z] = S
        S = S * dc[:, z, :, None, None] + st[:, z]
    assert S_before.shape == states.shape and S_last.shape == S.shape
    np.testing.assert_allclose(S_before.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(S_last.numpy(), S, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dims", SSD_SHAPES)
def test_ssd_chunk_output_ref_is_the_sum(dims):
    """Stage 3 against y[l] = Σ_{s ≤ l} (C[l]·B[s]) exp(cum[l] − cum[s]) x̄[s]
    + exp(cum[l]) C[l]·S in float64, row by row, with the state S entering
    each chunk; and ssd_chunked is the three stages composed."""
    xbar, Bm, Cm, dA = _ssd_inputs(dims, np.float32)
    args = convert.to_torch([xbar, Bm, Cm, dA])
    S_before, S_last = ssd_state_pass_ref(
        *ssd_chunk_states_ref(args[0], args[1], args[3]))
    y = ssd_chunk_output_ref(*args, S_before)
    x, B, C = (a.astype(np.float64) for a in (xbar, Bm, Cm))
    cum, S = _np_cum(dA), S_before.numpy().astype(np.float64)
    want = np.zeros(x.shape)
    for l in range(x.shape[2]):
        w = np.einsum("bzn,bzsn->bzs", C[:, :, l], B[:, :, :l + 1])[..., None] \
            * np.exp(cum[:, :, l:l + 1, :] - cum[:, :, :l + 1, :])  # (b,nz,s,nh)
        want[:, :, l] = (np.einsum("bzsh,bzshp->bzhp", w, x[:, :, :l + 1])
                         + np.exp(cum[:, :, l, :])[..., None]
                         * np.einsum("bzn,bzhnp->bzhp", C[:, :, l], S))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)
    y_all, S_all = ssd_chunked(*args)
    assert torch.equal(y_all, y) and torch.equal(S_all, S_last)


# --------------------------------------------------------------------------- #
# the mixer
# --------------------------------------------------------------------------- #
def _cfgs(param_dtype="float32", ssm_pallas=False):
    kw = dict(param_dtype=param_dtype, ssm_pallas=ssm_pallas)
    return (dataclasses.replace(jax_reduced(jax_get_arch("mamba2-370m"),
                                            vocab=VOCAB), **kw),
            dataclasses.replace(reduced(get_arch("mamba2-370m"), vocab=VOCAB),
                                **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mixer(L, seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = jax_ssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    x = (np.random.default_rng(seed).standard_normal(
        (2, L, jcfg.d_model)) * 0.5).astype(np.float32)
    return jcfg, tcfg, jp, convert.to_torch(_np(jp)), x


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("L", [32, 23])           # 23: padded to the chunk
@pytest.mark.parametrize("ssm_pallas", [False, True])
def test_ssm_forward_matches_jax(ssm_pallas, L):
    jcfg, tcfg, jp, tp, x = _mixer(L, ssm_pallas=ssm_pallas)
    want = jax.jit(functools.partial(jax_ssm.ssm_forward, cfg=jcfg))(
        jp, jnp.asarray(x))
    got = ssm.ssm_forward(tp, torch.from_numpy(x), tcfg)
    assert got.shape == (2, L, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("L", [23, 2])            # 2: shorter than the conv
def test_ssm_forward_state_matches_jax(L):
    # ssm_pallas on: a forward that returns the state still takes the
    # chunked path, as in the JAX package
    jcfg, tcfg, jp, tp, x = _mixer(L, ssm_pallas=True)
    want, (jS, jtail) = jax.jit(functools.partial(
        jax_ssm.ssm_forward, cfg=jcfg, return_state=True))(jp, jnp.asarray(x))
    got, (S, tail) = ssm.ssm_forward(tp, torch.from_numpy(x), tcfg,
                                     return_state=True)
    assert S.dtype == torch.float32
    assert S.shape == (2, tcfg.n_ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim)
    assert tail.shape == (2, tcfg.ssm_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_state)
    _close(got, want)
    _close(S, jS)
    _close(tail, jtail)


def test_ssm_decode_step_matches_jax():
    jcfg, tcfg, jp, tp, x = _mixer(5, seed=3)
    rng = np.random.default_rng(4)
    state = (rng.standard_normal((2, tcfg.n_ssm_heads, tcfg.ssm_state,
                                  tcfg.ssm_head_dim)).astype(np.float32) * 0.1,
             rng.standard_normal((2, tcfg.ssm_conv - 1, tcfg.d_inner
                                  + 2 * tcfg.ssm_state)).astype(np.float32))
    jstate, tstate = tuple(map(jnp.asarray, state)), convert.to_torch(state)
    jstep = jax.jit(functools.partial(jax_ssm.ssm_decode_step, cfg=jcfg))
    for t in range(x.shape[1]):                     # a few steps in a row
        jout, jstate = jstep(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        tout, tstate = ssm.ssm_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                           tstate, tcfg)
        _close(tout, jout)
    for a, b in zip(tstate, jstate):
        _close(a, b)


# --------------------------------------------------------------------------- #
# configuration and parameter count
# --------------------------------------------------------------------------- #
def test_mamba2_config_is_the_reference_config():
    for full in (True, False):
        jcfg, tcfg = jax_get_arch("mamba2-370m"), get_arch("mamba2-370m")
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert (tcfg.d_inner, tcfg.n_ssm_heads) == (jcfg.d_inner,
                                                    jcfg.n_ssm_heads)


def test_param_count_matches_reference_and_tree():
    full = get_arch("mamba2-370m")
    assert count_params(full) == jax_count_params(jax_get_arch("mamba2-370m"))
    assert count_params(full) == 419_714_560
    _, tcfg = _cfgs()
    params = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in leaves(params)) == count_params(tcfg)
    moe = dict(name="d", family="moe", n_layers=1, d_model=8, n_heads=1,
               n_kv_heads=1, d_ff=8, vocab_size=8, n_experts=2)
    assert count_params(ModelConfig(**moe)) == jax_count_params(
        JaxModelConfig(**moe))


def test_fresh_init_is_seeded_and_has_reference_structure():
    jcfg, tcfg = _cfgs("bfloat16")
    jshapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    jshapes = [(tuple(s.shape), str(s.dtype))
               for s in jax.tree_util.tree_leaves(jshapes)]
    model = build_model(tcfg)
    a = model.init(torch.Generator().manual_seed(5))
    b = model.init(torch.Generator().manual_seed(5))
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in leaves(a)] == jshapes
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_unported_families_raise():
    """The hybrid family is ported: mamba2's mixer beside attention builds
    (hymba-1.5b too); llama3-405b is registered, an unknown arch is a
    KeyError."""
    hybrid = dataclasses.replace(reduced(get_arch("mamba2-370m")),
                                 family="hybrid", hybrid=True, n_heads=8,
                                 n_kv_heads=2, head_dim=32, d_ff=64)
    params = build_model(hybrid).init(torch.Generator().manual_seed(0))
    assert sorted(params["blocks"][0]) == [
        "attn", "ln1", "ln2", "mlp", "norm_attn", "norm_ssm", "ssm"]
    assert get_arch("hymba-1.5b").hybrid
    assert get_arch("llama3-405b").family == "dense"
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


# --------------------------------------------------------------------------- #
# the Model API against the JAX package's
# --------------------------------------------------------------------------- #
def _models(param_dtype, ssm_pallas=False, seed=1):
    jcfg, tcfg = _cfgs(param_dtype, ssm_pallas)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    return jm, jp, tm, convert.to_torch(_np(jp))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


@pytest.mark.parametrize("ssm_pallas", [False, True])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_jax(param_dtype, ssm_pallas):
    jm, jp, tm, tp = _models(param_dtype, ssm_pallas)
    batch = {"tokens": _tokens((2, 40)), "labels": _tokens((2, 40), seed=1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, (jloss, jmet) = jax.jit(
        lambda p, b: (jm.logits_fn(p, b), jm.loss_fn(p, b)))(jp, jb)
    with torch.no_grad():
        tlogits = tm.logits_fn(tp, tb)
        tloss, tmet = tm.loss_fn(tp, tb)
    assert tlogits.dtype == getattr(torch, param_dtype)
    assert tlogits.shape == (2, 40, VOCAB)
    assert float(tmet["aux"]) == 0.0
    if param_dtype == "float32":
        _close(tlogits, jlogits)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    else:
        _close(tlogits, jlogits, rtol=0, atol=3e-2)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
    np.testing.assert_allclose(float(tmet["xent"]), float(jmet["xent"]),
                               rtol=1e-3)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_caches_match_jax(param_dtype):
    jm, jp, tm, tp = _models(param_dtype, ssm_pallas=True)
    tokens = _tokens((2, 23))                   # not a multiple of the chunk
    jlogits, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tlogits, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    assert tlogits.shape == (2, 1, VOCAB)
    g = tm.cfg.n_layers
    got, want = leaves(tcache), jax.tree_util.tree_leaves(jcache)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert got[0].shape[0] == g and got[0].dtype == torch.float32
    if param_dtype == "float32":
        _close(tlogits, jlogits)
        for a, b in zip(got, want):
            _close(a, b)
    else:
        _close(tlogits, jlogits, rtol=0, atol=3e-2)
        _close(got[0], want[0], rtol=1e-3, atol=1e-4)        # fp32 S
        _close(got[1], want[1], rtol=0, atol=3e-2)           # bf16 conv tail


def _decode(step, params, cache, tokens, as_pos):
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = step(params, cache, tokens[:, t:t + 1], as_pos(t))
        outs.append(logits[:, 0])
    return outs, cache


def test_teacher_forced_decode_matches_jax_and_own_forward():
    """Decode by the recurrence, one token at a time from a zero cache,
    against the JAX package's decode (per-step logits and the final cache),
    and against the port's own full-sequence forward through the SSD
    kernel's plain version, position by position (as
    tests/test_serving.py does for the JAX package, there to 3e-2; float32
    agrees to rtol 1e-4 here)."""
    jm, jp, tm, tp = _models("float32", ssm_pallas=True)
    B, S = 2, 20
    tokens = _tokens((B, S), seed=2)
    jouts, jcache = _decode(jax.jit(jm.decode_step), jp, jm.init_cache(B, S),
                            jnp.asarray(tokens),
                            lambda t: jnp.full((B,), t, jnp.int32))
    with torch.no_grad():
        touts, tcache = _decode(tm.decode_step, tp, tm.init_cache(B, S),
                                torch.from_numpy(tokens),
                                lambda t: torch.full((B,), t,
                                                     dtype=torch.int32))
        full = tm.logits_fn(tp, {"tokens": torch.from_numpy(tokens)})
    for a, b in zip(touts, jouts):
        _close(a, b)
    for a, b in zip(leaves(tcache), jax.tree_util.tree_leaves(jcache)):
        _close(a, b)
    _close(torch.stack(touts, dim=1), full.numpy())


def test_convert_round_trips_params_and_cache_bit_exactly():
    jm, jp, tm, tp = _models("bfloat16")
    _, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(_tokens((2, 16)))})
    for tree in (jp, jcache):
        want = _np(tree)
        tt = convert.to_torch(want)
        back = convert.to_numpy(tt, ml_dtypes.bfloat16)
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(want))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(want)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    cache = convert.to_torch(_np(jcache))
    assert isinstance(cache, list) and isinstance(cache[0]["ssm"], tuple)
    assert cache[0]["ssm"][0].dtype == torch.float32
    assert cache[0]["ssm"][1].dtype == torch.bfloat16


def test_softmax_xent_mask():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    from repro.models.model import softmax_xent as jax_xent
    for m in (None, mask):
        want = jax_xent(jnp.asarray(logits), jnp.asarray(labels),
                        None if m is None else jnp.asarray(m))
        got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

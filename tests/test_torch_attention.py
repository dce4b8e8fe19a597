"""The port's attention, RoPE and MLPs against the JAX package's.

Inputs are drawn with numpy from a seed; the JAX functions run jitted on
the CPU, the port's on CPU tensors. Grouped-query ratios H / KV of 1, 4 and
7, in float32 and bfloat16.

Tolerances, and why:
  * RoPE frequencies bitwise: the port takes the power in float64, which
    rounds as XLA's float32 power does on these head sizes.
  * float32: rtol 1e-5, atol 1e-6 (measured: ~5e-7). Both sides take the
    same float32 products and sums, in other orders, and XLA contracts
    some products and sums into FMAs; sin and cos differ by an ulp.
  * bfloat16: the outputs are rounded to bfloat16 after the same float32
    work, so an output lies one bf16 ulp away where the float32 values
    straddle a rounding boundary: atol 2e-2 against values of magnitude
    ~1-3 (an ulp is 2^-7 of the value), rtol 1e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import attention as attn
from repro_torch.models import layers

BF16 = ml_dtypes.bfloat16
DTYPES = [np.float32, BF16]
TOL = {np.float32: dict(rtol=1e-5, atol=1e-6), BF16: dict(rtol=1e-2, atol=2e-2)}
# (H, KV): GQA ratios 1, 4 and 7
HEADS = [(4, 4), (8, 2), (7, 1)]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _qkv(h, kvh, sq, skv, dtype, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, h, hd)).astype(dtype)
    k = rng.standard_normal((2, skv, kvh, hd)).astype(dtype)
    v = rng.standard_normal((2, skv, kvh, hd)).astype(dtype)
    return q, k, v


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


# --------------------------------------------------------------------------- #
# RoPE and the MLPs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_freqs_are_the_reference_bitwise(hd, theta):
    want = np.asarray(jax.jit(jlayers.rope_freqs, static_argnums=(0, 1))(
        hd, theta))
    got = layers.rope_freqs(hd, theta)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 200, 3, 64)).astype(dtype)
    pos = _pos(2, 200, start=2900)            # angles of thousands of radians
    want = jax.jit(jlayers.apply_rope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(convert.to_torch(x), torch.from_numpy(pos), theta)
    assert got.dtype == convert.to_torch(x).dtype
    _close(got, want, dtype)


def test_apply_rope_rotates_halves_not_pairs():
    # position 1, theta 1: the first frequency is 1 rad; x = e_0 rotates
    # into e_{hd/2} (halves), not into e_1 (interleaved pairs)
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    out = layers.apply_rope(x, torch.ones((1, 1), dtype=torch.int32), 1.0)
    np.testing.assert_allclose(out[0, 0, 0, [0, 4, 1]].numpy(),
                               [np.cos(1.0), np.sin(1.0), 0.0], atol=1e-7)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_apply_matches_jax(act, dtype):
    jp = jlayers.init_mlp(jax.random.PRNGKey(2), 64, 256, act,
                          dtype=jnp.dtype(dtype))
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(dtype)
    want = jax.jit(functools.partial(jlayers.mlp_apply, act=act))(
        jp, jnp.asarray(x))
    tp = convert.to_torch(_np(jp))
    assert sorted(tp) == sorted(layers.init_mlp(
        torch.Generator().manual_seed(0), 64, 256, act))
    _close(layers.mlp_apply(tp, convert.to_torch(x), act), want, dtype)


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; the exact erf form is off
    it by far more than the float32 tolerance."""
    jp = jlayers.init_mlp(jax.random.PRNGKey(2), 64, 256, "gelu")
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jlayers.mlp_apply,
                                                act="gelu"))(jp, jnp.asarray(x)))
    tp = convert.to_torch(_np(jp))
    exact = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w1"]) @ tp["w2"]
    assert not np.allclose(exact.numpy(), want, **TOL[np.float32])
    _close(layers.mlp_apply(tp, torch.from_numpy(x), "gelu"), want, np.float32)


def test_dropout_keeps_and_scales():
    x = torch.ones((400, 500))
    gen = torch.Generator().manual_seed(0)
    out = layers.dropout(gen, x, 0.1, False)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    assert torch.equal(out[kept], (x / torch.tensor(0.9))[kept])
    assert layers.dropout(gen, x, 0.1, True) is x
    assert layers.dropout(None, x, 0.0, False) is x


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_direct_attention_matches_jax(heads, dtype, causal, window):
    q, k, v = _qkv(*heads, 9, 9, dtype)
    pos = _pos(2, 9)
    fn = functools.partial(jattn.direct_attention, causal=causal,
                           window=window)
    want = jax.jit(fn)(*map(jnp.asarray, (q, k, v, pos, pos)))
    got = attn.direct_attention(*convert.to_torch([q, k, v]),
                                torch.from_numpy(pos), torch.from_numpy(pos),
                                causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == convert.to_torch(q).dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bf16_probs", [False, True])
@pytest.mark.parametrize("window", [0, 11])
def test_blockwise_attention_matches_jax(heads, dtype, bf16_probs, window):
    # 37 keys in blocks of 8: past two blocks, so the online softmax runs
    # over five blocks, the last padded with three keys
    q, k, v = _qkv(*heads, 37, 37, dtype, seed=4)
    pos = _pos(2, 37)
    kw = dict(causal=True, window=window, kv_block=8, bf16_probs=bf16_probs)
    want = jax.jit(functools.partial(jattn.blockwise_attention, **kw))(
        *map(jnp.asarray, (q, k, v, pos, pos)))
    got = attn.blockwise_attention(*convert.to_torch([q, k, v]),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(pos), **kw)
    _close(got, want, dtype)


def test_blockwise_attention_scales_q_as_the_compiled_reference():
    """The blockwise path scales q by the scale rounded to q's dtype (JAX's
    weak-typed scalar), and the compiled reference keeps that product in
    float32: in bfloat16 the port's outputs then equal the reference's but
    for a rare last-bit rounding of the float32 sums. Rounding the product
    to bfloat16 (the source read literally, as eager JAX runs it) would
    move q on most elements."""
    q, k, v = _qkv(8, 2, 37, 37, BF16, seed=5)
    q = (q.astype(np.float32) * 3).astype(BF16)
    pos = _pos(2, 37)
    for bf16_probs in (False, True):
        kw = dict(causal=True, kv_block=8, bf16_probs=bf16_probs)
        want = np.asarray(jax.jit(functools.partial(
            jattn.blockwise_attention, **kw))(*map(jnp.asarray,
                                                   (q, k, v, pos, pos))))
        tq, tk, tv = convert.to_torch([q, k, v])
        got = attn.blockwise_attention(tq, tk, tv, torch.from_numpy(pos),
                                       torch.from_numpy(pos), **kw)
        assert (got.float().numpy() != want.astype(np.float32)).mean() < 1e-3
    s_bf16 = torch.tensor(32 ** -0.5, dtype=torch.bfloat16)
    rounded = (tq * s_bf16).float()
    assert (rounded != tq.float() * float(s_bf16)).float().mean() > 0.5


def _attn_cfgs(heads, dtype):
    h, kvh = heads
    kw = dict(n_heads=h, n_kv_heads=kvh, head_dim=32, d_model=128,
              param_dtype=np.dtype(dtype).name)
    return (dataclasses.replace(jax_reduced(jax_get_arch("qwen2-7b")), **kw),
            dataclasses.replace(reduced(get_arch("qwen2-7b")), **kw))


def _attn_params(jcfg, dtype, seed=6):
    """The reference's init with non-zero QKV biases, so the bias path is
    exercised."""
    jp = _np(jattn.init_attention(jax.random.PRNGKey(seed), jcfg,
                                  jnp.dtype(dtype)))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        jp[name] = (rng.standard_normal(jp[name].shape) * 0.5).astype(dtype)
    return jp, convert.to_torch(jp)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_self_attention_matches_jax(heads, dtype):
    jcfg, tcfg = _attn_cfgs(heads, dtype)
    jp, tp = _attn_params(jcfg, dtype)
    assert sorted(tp) == sorted(attn.init_attention(
        torch.Generator().manual_seed(0), tcfg))
    x = np.random.default_rng(7).standard_normal((2, 12, 128)).astype(dtype)
    pos = _pos(2, 12, start=40)
    want, (wk, wv) = jax.jit(functools.partial(jattn.self_attention,
                                               cfg=jcfg))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    got, (k, v) = attn.self_attention(tp, convert.to_torch(x),
                                      torch.from_numpy(pos), tcfg)
    for a, b in ((got, want), (k, wk), (v, wv)):
        _close(a, b, dtype)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("windowed", [False, True])
def test_decode_self_attention_matches_jax(heads, dtype, windowed):
    """Several steps in a row from a random cache. Windowed: a ring of 6
    slots driven from position 4 to 16, past two wraps; otherwise 20 slots
    and positions 4 to 16."""
    jcfg, tcfg = _attn_cfgs(heads, dtype)
    jp, tp = _attn_params(jcfg, dtype)
    L = 6 if windowed else 20
    rng = np.random.default_rng(8)
    cache = [rng.standard_normal((2, L, heads[1], 32)).astype(dtype)
             for _ in range(2)]
    jk, jv = map(jnp.asarray, cache)
    tk, tv = convert.to_torch(cache)
    jspec = jattn.KVCacheSpec(cache_len=L, windowed=windowed)
    tspec = attn.KVCacheSpec(cache_len=L, windowed=windowed)
    step = jax.jit(functools.partial(jattn.decode_self_attention, cfg=jcfg,
                                     spec=jspec))
    for p in range(4, 16):
        x = rng.standard_normal((2, 1, 128)).astype(dtype)
        pos = np.array([p, p + 1], dtype=np.int32)    # rows at other places
        want, jk, jv = step(jp, jnp.asarray(x), jk, jv, jnp.asarray(pos))
        before = tk.clone()
        got, tk, tv = attn.decode_self_attention(
            tp, convert.to_torch(x), tk, tv, torch.from_numpy(pos), tcfg,
            tspec)
        assert not torch.equal(tk, before)           # a new cache, written
        for a, b in ((got, want), (tk, jk), (tv, jv)):
            _close(a, b, dtype)

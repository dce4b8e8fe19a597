"""The port's quantize/dequantize pair (its plain versions, on CPU tensors)
against the JAX package's Pallas kernels in interpret mode and its jitted
oracles, and the int8 codec's three-pass encode that the pair carries.

Tolerances: none. Codes, scales and x̂ are held bitwise (compared as
integer views), as are the three-pass encode's wire and residual against
the one-pass encode's. The quantization error is held to the relative
bound amax/253 per block (half a code step is amax/254), not to an absolute
one, which a wide input exceeds.

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them against these same plain versions.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codecs import get_codec as jax_get_codec
from repro.core.sync_engine import ef_apply as jax_ef_apply
from repro.kernels import quantize as jq
from repro.kernels.ref import dequantize_blocks_ref as jax_dequantize_ref
from repro.kernels.ref import quantize_blocks_ref as jax_quantize_ref
from repro_torch import charges, convert
from repro_torch.core.codecs import get_codec
from repro_torch.core.sync_engine import ef_apply
from repro_torch.kernels import _build
from repro_torch.kernels import quantize as qz

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode())


def _bits(x) -> np.ndarray:
    a = convert.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _pair(x: np.ndarray, dtype: str):
    """fp32 numpy -> (port tensor, JAX array) of ``dtype``, same bits."""
    j = jnp.asarray(x).astype(DTYPES[dtype][1])
    return convert.to_torch(np.asarray(j)), j


def _blocks(nb: int, seed: int) -> np.ndarray:
    """(nb, 256) fp32 with the edge cases: an all-zero block, -0 and tiny
    negatives whose codes round to -0, a huge value, a denormal-scale
    block."""
    x = (np.random.default_rng(seed).standard_normal((nb, 256)) * 3.0
         ).astype(np.float32)
    if nb > 6:
        x[2] = 0.0
        x[3, :5] = -0.0
        x[4, :] = -1e-9
        x[4, 0] = 1.0
        x[5, 7] = 1e30
        x[6] = 1e-30
    return x


@pytest.mark.parametrize("nb", [1, 7, 600, 1030])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_pair_bitwise_vs_jax_kernels(nb, dtype):
    xt, xj = _pair(_blocks(nb, _seed(nb, dtype)), dtype)
    q, s = qz.quantize_blocks(xt)
    assert q.dtype == torch.int8 and s.shape == (nb, 1)
    qk, sk = jq.quantize_blocks(xj, interpret=True)
    qr, sr = jax.jit(jax_quantize_ref)(xj)
    for want_q, want_s in ((qk, sk), (qr, sr)):
        np.testing.assert_array_equal(_bits(q), _bits(want_q))
        np.testing.assert_array_equal(_bits(s), _bits(want_s))
    y = qz.dequantize_blocks(q, s)
    yk = jq.dequantize_blocks(qk, sk, interpret=True)
    yr = jax.jit(jax_dequantize_ref)(qr, sr)
    for want in (yk, yr):
        np.testing.assert_array_equal(_bits(y), _bits(want))
    assert not bool((torch.signbit(y) & (y == 0)).any())    # no -0 out


@pytest.mark.parametrize("shape,batch_ndim", [
    ((1000,), 0), ((3, 1000), 1), ((2, 3, 130), 1), ((48, 257), 0),
    ((2, 512, 128), 1)])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_leaf_wrappers_match_jax(shape, batch_ndim, use_kernels):
    x = (np.random.default_rng(_seed(shape, batch_ndim)).standard_normal(
        shape) * 0.5).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    q, s = qz.quantize(xt, batch_ndim=batch_ndim, use_kernels=use_kernels)
    # compiled: eager op-by-op JAX divides by 127 where XLA multiplies
    qj, sj = jax.jit(lambda a: jq.quantize(
        a, batch_ndim=batch_ndim, use_pallas=use_kernels, interpret=True))(xj)
    np.testing.assert_array_equal(_bits(q), _bits(qj))
    np.testing.assert_array_equal(_bits(s), _bits(sj))
    y = qz.dequantize(q, s, shape, batch_ndim=batch_ndim,
                      use_kernels=use_kernels)
    yj = jax.jit(lambda a, b: jq.dequantize(
        a, b, shape, batch_ndim=batch_ndim, use_pallas=use_kernels,
        interpret=True))(qj, sj)
    assert y.shape == shape
    np.testing.assert_array_equal(_bits(y), _bits(yj))
    fq = qz.fake_quantize(xt, batch_ndim=batch_ndim, use_kernels=use_kernels)
    np.testing.assert_array_equal(_bits(fq), _bits(y))


def test_quantization_error_within_relative_bound():
    """|x̂ − x| ≤ amax/253 per block, at the (600, 256) input whose error
    exceeds the reference test's absolute 1e-2."""
    x = (np.random.default_rng(0).standard_normal((600, 256)) * 3.0
         ).astype(np.float32)
    xt = torch.from_numpy(x)
    err = (qz.fake_quantize(xt) - xt).abs()
    amax = xt.abs().amax(dim=1, keepdim=True)
    assert bool((err <= amax / 253).all())
    assert float(err.max()) > 1e-2             # the absolute bound fails here


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("clamp", [False, True])
def test_three_pass_encode_bitwise_equals_one_pass_and_jax(dtype, clamp):
    """ef_apply through the unfused int8 codec (quantize, dequantize,
    residual) gives the one-pass encode's wire and residual, and the
    reference's three-pass encode's."""
    rng = np.random.default_rng(_seed("ef", dtype, clamp))
    shapes = {"a": (2, 40, 33), "b": (2, 700), "c": (2, 5)}
    x = {k: (rng.standard_normal(s) * 0.5 + (2.0 if clamp else 0.0)
             ).astype(np.float32) for k, s in shapes.items()}
    e = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    if clamp:
        e["b"][:, :100] = -5.0                  # the clamp at 0 fires
    xt = {k: _pair(v, dtype)[0] for k, v in x.items()}
    xj = {k: _pair(v, dtype)[1] for k, v in x.items()}
    runs = {}
    for fused in (True, False):
        codec = get_codec("int8", use_kernels=True, fused=fused)
        assert (codec.ef_roundtrip is None) == (not fused)
        et = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
        runs[fused] = ef_apply(xt, et, codec, 1, clamp_nonneg=clamp)
    want = jax.jit(lambda a, b: jax_ef_apply(
        a, b, jax_get_codec("int8", fused=False), 1, clamp_nonneg=clamp))(
        xj, {k: jnp.asarray(v) for k, v in e.items()})
    for k in shapes:
        for part in (0, 1):
            np.testing.assert_array_equal(_bits(runs[False][part][k]),
                                          _bits(runs[True][part][k]))
            np.testing.assert_array_equal(_bits(runs[False][part][k]),
                                          _bits(want[part][k]))


def test_cpu_wrappers_take_plain_versions_and_count_no_launch(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "load", no_build)
    before = (qz.quantize_launches.n, qz.dequantize_launches.n)
    q, s = qz.quantize_blocks(torch.ones(3, 256))
    qz.dequantize_blocks(q, s)
    get_codec("int8", use_kernels=True, fused=False).roundtrip(
        torch.ones(2, 300), 1)
    assert (qz.quantize_launches.n, qz.dequantize_launches.n) == before


def test_wrappers_raise_rather_than_fall_back(monkeypatch):
    """Off the CPU the wrappers never take their plain versions: on
    ``meta`` tensors (the dry-run's route) they return empty ``meta``
    outputs and launch nothing; another device and bad operands raise."""
    def no_plain(*a, **k):
        raise AssertionError("a meta tensor reached the plain version")

    monkeypatch.setattr(qz, "quantize_blocks_ref", no_plain)
    monkeypatch.setattr(qz, "dequantize_blocks_ref", no_plain)
    before = (qz.quantize_launches.n, qz.dequantize_launches.n)
    q, s = qz.quantize_blocks(torch.empty(4, 256, device="meta"))
    y = qz.dequantize_blocks(torch.empty(4, 256, dtype=torch.int8,
                                         device="meta"),
                             torch.empty(4, 1, device="meta"))
    assert (q.dtype, tuple(s.shape), y.dtype) == (torch.int8, (4, 1),
                                                 torch.float32)
    assert {t.device.type for t in (q, s, y)} == {"meta"}
    assert (qz.quantize_launches.n, qz.dequantize_launches.n) == before
    # a device a wrapper does not take raises (meta, once it is not one)
    monkeypatch.setattr(charges, "DEVICES", ("cpu", "cuda"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        qz.quantize_blocks(torch.empty(4, 256, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        qz.dequantize_blocks(torch.empty(4, 256, dtype=torch.int8,
                                         device="meta"),
                             torch.empty(4, 1, device="meta"))
    with pytest.raises(ValueError, match="nblocks"):
        qz.quantize_blocks(torch.ones(4, 128))
    with pytest.raises(TypeError):
        qz.quantize_blocks(torch.ones(4, 256, dtype=torch.float16))
    with pytest.raises(ValueError, match="scales"):
        qz.dequantize_blocks(torch.ones(4, 256, dtype=torch.int8),
                             torch.ones(3, 1))
    with pytest.raises(ValueError, match="256-element blocks"):
        qz.quantize(torch.ones(512), block=128)

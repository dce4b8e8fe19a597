"""The port's kernel wrappers (their plain versions, on CPU tensors) against
the JAX package's Pallas kernels in interpret mode and its jitted oracles.

Tolerances:
  * fused update: y to rtol 1e-6 (fp32) / 8e-3 (bf16), atol 1e-6 — the JAX
    package's own (tests/test_kernels.py): rsqrt·mul against div/sqrt, and
    XLA's and PyTorch's rsqrt, may differ by an ulp of the dtype, which a
    bf16 store can turn into one bf16 ulp. b2_local + g·g is held bitwise
    against the separately rounded sum (eager JAX, the port's oracle), which
    is what the CUDA kernel computes. XLA's CPU compile contracts the same
    expression into one FMA (a single rounding: ~0.2% of elements land one
    ulp away), so against the compiled JAX kernel and oracle b2_local is
    held to 1 ulp.
  * EF encode: wire and residual bitwise (compared as integer views), for
    fp32 and bf16 payloads, with and without the accumulator clamp, for
    whole leaves (batch_ndim 0) and per-worker rows (batch_ndim 1). The
    JAX side is compiled (interpret-mode kernel under jit, jitted oracle):
    eager op-by-op JAX is not the reference.

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them against these same plain versions.
"""
import importlib
import pkgutil
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adaalter_update import fused_update as jax_fused_update
from repro.kernels.ref import fused_ef_blocks_ref as jax_ef_ref
from repro.kernels.ref import fused_update_ref as jax_update_ref
from repro.kernels.ref import quantize_blocks_ref as jax_quantize_ref
from repro.kernels.sync_fused import fused_ef_blocks as jax_ef_blocks
from repro.kernels.sync_fused import fused_ef_leaf as jax_ef_leaf
from repro.kernels.tiling import pad_rows as jax_pad_rows
from repro.kernels.tiling import to_blocks as jax_to_blocks
from repro_torch import convert
from repro_torch.kernels import _build, adaalter_update, ref, sync_fused
from repro_torch.kernels.tiling import from_blocks, pad_rows, to_blocks

SHAPES = [
    (128,),                  # tiny 1-D
    (1000,),                 # non-multiple 1-D
    (512, 128),              # one TPU tile
    (4096, 128),             # several TPU tiles
    (48, 257),               # ragged 2-D
    (3, 5, 64),              # 3-D leaf
    (2048, 512),             # big leaf
]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode())


def _t(a: np.ndarray, dtype: str) -> torch.Tensor:
    """fp32 numpy -> port tensor of ``dtype`` (bf16 via JAX's own rounding,
    so both sides start from the same bits)."""
    j = jnp.asarray(a).astype(DTYPES[dtype][1])
    return convert.to_torch(np.asarray(j))


def _j(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(DTYPES[dtype][1])


def _bits(x) -> np.ndarray:
    a = convert.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _update_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    bs = rng.uniform(1.0, 5.0, shape).astype(np.float32)
    bl = (bs + rng.uniform(0.0, 2.0, shape)).astype(np.float32)
    return x, g, bs, bl


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_update_matches_jax_kernel_and_oracle(shape, dtype):
    x, g, bs, bl = _update_inputs(shape, _seed(shape, dtype))
    eta, extra = 0.37, 3.0
    y, nbl = adaalter_update.fused_update(
        _t(x, dtype), _t(g, dtype), torch.from_numpy(bs),
        torch.from_numpy(bl), adaalter_update.update_scalars(eta, extra, "cpu"))
    assert y.dtype == DTYPES[dtype][0] and nbl.dtype == torch.float32
    jx, jg = _j(x, dtype), _j(g, dtype)
    yk, nblk = jax_fused_update(jx, jg, jnp.asarray(bs), jnp.asarray(bl), eta,
                                extra, interpret=True, block_rows=256)
    yr, nblr = jax.jit(jax_update_ref)(jx, jg, jnp.asarray(bs),
                                       jnp.asarray(bl), eta, extra)
    # the port's plain version of the JAX oracle agrees too
    yp, nblp = ref.fused_update_ref(_t(x, dtype), _t(g, dtype),
                                    torch.from_numpy(bs),
                                    torch.from_numpy(bl), eta, extra)
    rtol = 1e-6 if dtype == "float32" else 8e-3
    for want in (yk, yr, yp.float().numpy()):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=1e-6)
    np.testing.assert_array_equal(_bits(nbl), _bits(nblp))
    np.testing.assert_array_equal(
        _bits(nbl), _bits(jax_update_ref(jx, jg, jnp.asarray(bs),
                                         jnp.asarray(bl), eta, extra)[1]))
    for want in (nblk, nblr):
        np.testing.assert_array_max_ulp(nbl.numpy(), np.asarray(want),
                                        maxulp=1)


def _ef_inputs(shape, dtype, clamp, seed):
    rng = np.random.default_rng(seed)
    if clamp:     # accumulator payload around 1, a stripe driven negative
        x = (1.0 + rng.uniform(0.0, 1.0, shape)).astype(np.float32)
        e = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
        e.reshape(-1)[:100] = -4.0
    else:
        x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        e = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    n = x.size
    x.reshape(-1)[n // 2:n // 2 + 300] = 0.0    # covers a whole block
    e.reshape(-1)[n // 2:n // 2 + 300] = 0.0
    return x, e


EF_CASES = [("bfloat16", False), ("float32", True), ("float32", False),
            ("bfloat16", True)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch_ndim", [0, 1])
@pytest.mark.parametrize("dtype,clamp", EF_CASES)
def test_fused_ef_leaf_bitwise_vs_jax(shape, batch_ndim, dtype, clamp):
    x, e = _ef_inputs(shape, dtype, clamp, _seed(shape, batch_ndim, dtype, clamp))
    e_port = torch.from_numpy(e.copy())
    w, r = sync_fused.fused_ef_leaf(_t(x, dtype), e_port,
                                    batch_ndim=batch_ndim, clamp_nonneg=clamp)
    assert r is e_port                     # the residual is written in place
    wk, rk = jax_ef_leaf(_j(x, dtype), jnp.asarray(e), batch_ndim=batch_ndim,
                         clamp_nonneg=clamp, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(_bits(w), _bits(wk))
    np.testing.assert_array_equal(_bits(r), _bits(rk))
    # and against the jitted oracle on the same blocked view
    bnd = min(batch_ndim, len(shape))
    x2d = jax_to_blocks(_j(x, dtype), 256, bnd)
    e2d = jax_to_blocks(jnp.asarray(e), 256, bnd)
    wr, rr = jax.jit(jax_ef_ref, static_argnames=("clamp_nonneg",))(
        x2d, e2d, clamp_nonneg=clamp)
    np.testing.assert_array_equal(
        _bits(w), _bits(from_blocks(convert.to_torch(np.asarray(wr)), shape, bnd)))
    np.testing.assert_array_equal(
        _bits(r), _bits(from_blocks(torch.from_numpy(np.array(rr)), shape, bnd)))


@pytest.mark.parametrize("dtype,clamp", EF_CASES)
def test_fused_ef_blocks_bitwise_vs_jax_kernel(dtype, clamp):
    """The (nblocks, 256) entry point, all-zero and extreme rows included."""
    rng = np.random.default_rng(_seed("blocks", dtype, clamp))
    x = (rng.standard_normal((64, 256)) * 3.0).astype(np.float32)
    e = (rng.standard_normal((64, 256)) * 1e-2).astype(np.float32)
    x[5] = 0.0
    e[5] = 0.0                                   # all-zero block
    x[7, 3] = 1e30                               # one huge value per row
    x[9] = 1e-30                                 # denormal-scale row
    if clamp:
        x = np.abs(x)
        e[11] = -10.0                            # whole row clamps to 0
    w, r = sync_fused.fused_ef_blocks(_t(x, dtype),
                                      torch.from_numpy(e.copy()),
                                      clamp_nonneg=clamp)
    wk, rk = jax_ef_blocks(_j(x, dtype), jnp.asarray(e), clamp_nonneg=clamp,
                           interpret=True)
    np.testing.assert_array_equal(_bits(w), _bits(wk))
    np.testing.assert_array_equal(_bits(r), _bits(rk))
    assert not w[5].any() and not r[5].any()


@pytest.mark.parametrize("shape,batch_ndim", [((1000,), 0), ((3, 1000), 1),
                                              ((2, 3, 130), 1)])
def test_blocked_view_round_trips(shape, batch_ndim):
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    x2d = to_blocks(x, 256, batch_ndim)
    want = jax_to_blocks(jnp.asarray(x.numpy()), 256, batch_ndim)
    np.testing.assert_array_equal(x2d.numpy(), np.asarray(want))
    assert torch.equal(from_blocks(x2d, shape, batch_ndim), x)
    np.testing.assert_array_equal(pad_rows(x2d, 8).numpy(),
                                  np.asarray(jax_pad_rows(want, 8)))


def test_cpu_wrappers_take_plain_versions_and_count_no_launch(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "load", no_build)
    before = (adaalter_update.launches.n, sync_fused.launches.n)
    x = torch.ones(300, dtype=torch.bfloat16)
    adaalter_update.fused_update(
        x, x, torch.ones(300), torch.ones(300),
        adaalter_update.update_scalars(0.1, 1.0, "cpu"))
    sync_fused.fused_ef_leaf(x, torch.zeros(300))
    assert (adaalter_update.launches.n, sync_fused.launches.n) == before


def test_wrappers_raise_rather_than_fall_back():
    m = torch.empty(8, device="meta")
    s = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        adaalter_update.fused_update(m, m, m, m, s)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sync_fused.fused_ef_leaf(m, m)
    with pytest.raises(TypeError):
        adaalter_update.fused_update(torch.ones(4, dtype=torch.float16),
                                     torch.ones(4, dtype=torch.float16),
                                     torch.ones(4), torch.ones(4),
                                     torch.ones(2))
    with pytest.raises(ValueError, match="shape"):
        adaalter_update.fused_update(torch.ones(4), torch.ones(5),
                                     torch.ones(4), torch.ones(4),
                                     torch.ones(2))


def test_importing_builds_nothing():
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    assert _build._lib is None


def test_build_is_keyed_by_source_content(tmp_path, monkeypatch):
    """One library for every source, named by a hash of their contents
    and of the headers they share."""
    assert [p.name for p in _build.sources()] == ["adaalter_update.cu",
                                                  "quantize.cu",
                                                  "ssd_scan.cu",
                                                  "sync_fused.cu"]
    assert [p.name for p in _build.headers()] == ["mma_tf32.cuh",
                                                  "numerics.cuh"]
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    for src in _build.sources() + _build.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path() == path
    seen = {path}
    for name in ("sync_fused.cu", "numerics.cuh", "mma_tf32.cuh"):
        with open(tmp_path / name, "a") as f:
            f.write("\n")
        assert _build.library_path() not in seen
        seen.add(_build.library_path())
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_scale_is_times_float32_reciprocal_of_127():
    """XLA compiles max|v|/127 as max|v|·f32(1/127): the port follows."""
    assert np.float32(ref.INV_127) == np.float32(1) / np.float32(127)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4096, 256)).astype(np.float32) * 7)
    _, s = ref.quantize_blocks_ref(v)
    _, sj = jax.jit(jax_quantize_ref)(jnp.asarray(v.numpy()))
    np.testing.assert_array_equal(_bits(s), _bits(sj))

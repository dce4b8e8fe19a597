"""The numerics that the SSD chunk scan's tensor-core products rest on,
emulated on the CPU.

``csrc/mma_tf32.cuh`` runs the SSD kernels' four products (C·Bᵀ, M·x̄,
C·S and the chunk states Bᵀ·(seg ⊙ x̄)) on the tensor cores as 3xTF32:
each fp32 operand x is split into big = tf32(x) and small = tf32(x − big),
and the product is summed as small·big + big·small + big·big. Here the
``cvt.rna.tf32.f32`` rounding is emulated on the float32 bits (add 0x1000
to the int32 view, clear the low 13 bits: round to nearest, ties away from
zero) and the chunked SSD is run the kernels' way with its products done
in one TF32 pass and in 3xTF32, at the kernels' full-width chunk dims
(c 64, N 128, hd 64) over 8 chunks and 4 heads, with ``chip_smoke.py``'s
input distribution. 3xTF32 must hold the kernel check's 1e-4 against the
plain ``ssd_chunked``, and one pass must miss it: the check has to be able
to see the mistake that the design avoids.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import ssd_chunked, ssd_state_pass_ref

SSD_TOL = 1e-4                   # chip_smoke.py's SSD kernel check
DIMS = (1, 8, 64, 4, 64, 128)    # (b, nz, c, nh, hd, n)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, nearest,
    ties away from zero, kept as float32."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mm_one_pass(a, b):
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_fp32(a, b):
    return a @ b


def ssd_by_products(xbar, Bm, Cm, dA, mm):
    """The chunked SSD as the CUDA kernels compute it, every product through
    ``mm``: chunk states Bᵀ·(seg ⊙ x̄), the state pass, C·Bᵀ, M formed
    elementwise and masked by selection, y = M·x̄ + exp(cum) ⊙ (C·S)."""
    c = xbar.shape[2]
    cum = torch.cumsum(dA, dim=2)                                  # (b,nz,c,nh)
    seg = torch.exp(cum[:, :, -1:, :] - cum)
    xh = xbar.permute(0, 1, 3, 2, 4)                               # (b,nz,nh,c,hd)
    states = mm(Bm.transpose(-1, -2)[:, :, None],
                (xbar * seg[..., None]).permute(0, 1, 3, 2, 4))    # (b,nz,nh,N,hd)
    S_before, _ = ssd_state_pass_ref(states, torch.exp(cum[:, :, -1, :]))
    ch = cum.permute(0, 1, 3, 2)                                   # (b,nz,nh,c)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool))
    logd = torch.where(tri, ch[..., :, None] - ch[..., None, :], 0.0)
    CB = mm(Cm, Bm.transpose(-1, -2))[:, :, None]                  # (b,nz,1,c,c)
    M = torch.where(tri, CB * torch.exp(logd), 0.0)
    y = mm(M, xh) + torch.exp(ch)[..., None] * mm(Cm[:, :, None], S_before)
    return y.permute(0, 1, 3, 2, 4)


def _inputs(seed, dtype):
    b, nz, c, nh, hd, n = DIMS
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, nz, c, nh, hd)) * 0.2,
              rng.standard_normal((b, nz, c, n)) * 0.3,
              rng.standard_normal((b, nz, c, n)) * 0.3]
    dA = -np.abs(rng.standard_normal((b, nz, c, nh))) * 0.1
    # bf16 inputs widen exactly to the fp32 the kernels compute in
    out = [torch.from_numpy(a.astype(np.float32)).to(dtype).float()
           for a in arrays]
    return out + [torch.from_numpy(dA.astype(np.float32))]


def test_tf32_rounding_is_cvt_rna():
    one_ulp = 2.0 ** -10                        # tf32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -11 - 2 ** -23,
                      -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 0.0, -0.0, 2.0 ** -126])
    want = torch.tensor([1.0, 1 + one_ulp, 1.0, -(1 + one_ulp),
                         1 + 2 * one_ulp, 0.0, -0.0, 2.0 ** -126])
    assert torch.equal(tf32(x).view(torch.int32), want.view(torch.int32))
    r = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    t = tf32(r)
    assert not (t.view(torch.int32) & 0x1FFF).any()
    assert ((t - r).abs() <= r.abs() * 2.0 ** -11).all()


def test_3xtf32_split_keeps_fp32_accuracy():
    """big + small is within 2⁻²² of x, relative: the split keeps 21 of
    fp32's 24 bits, where one pass keeps 11."""
    r = torch.randn(10000, generator=torch.Generator().manual_seed(1)) * 10
    big = tf32(r)
    small = tf32(r - big)
    err = (r.double() - big.double() - small.double()).abs()
    assert (err <= r.double().abs() * 2.0 ** -22).all()
    assert ((r - big).abs() > r.abs() * 2.0 ** -22).any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_emulation_with_fp32_products_is_ssd_chunked(seed, dtype):
    """The kernels' order of work, with exact fp32 products, is the plain
    version up to fp32 rounding: any gap below comes from the products."""
    args = _inputs(seed, dtype)
    y = ssd_by_products(*args, mm_fp32)
    torch.testing.assert_close(y, ssd_chunked(*args)[0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_3xtf32_products_hold_the_kernel_tolerance(seed, dtype):
    args = _inputs(seed, dtype)
    y = ssd_by_products(*args, mm_3xtf32)
    want = ssd_chunked(*args)[0]
    assert torch.allclose(y, want, rtol=SSD_TOL, atol=SSD_TOL), float(
        (y - want).abs().max())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_tf32_pass_misses_the_kernel_tolerance(seed, dtype):
    args = _inputs(seed, dtype)
    y = ssd_by_products(*args, mm_one_pass)
    want = ssd_chunked(*args)[0]
    assert not torch.allclose(y, want, rtol=SSD_TOL, atol=SSD_TOL)
    assert float((y - want).abs().max()) > 5 * SSD_TOL

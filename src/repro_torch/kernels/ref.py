"""Plain PyTorch versions of the kernels' functions.

Expression for expression the JAX package's ``kernels/ref.py`` and
``kernels/quantize.py::block_quantize``, as XLA compiles them: the CPU
tests hold these bitwise against the JAX oracles, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.

Every scalar operand is a float32 tensor on the data's device. On CUDA,
PyTorch turns a division by a Python number into a multiplication by its
reciprocal, which would round differently from the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.tiling import round_through_bf16

#: XLA rewrites ``max|v| / 127.0`` (a division by a constant) into a
#: multiplication by the float32 reciprocal; the jitted JAX reference, its
#: kernel in interpret mode and the port all compute the scale this way.
INV_127 = float(np.float32(1.0) / np.float32(127.0))
F32_MIN = float(torch.finfo(torch.float32).min)


def f32(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-dim tensor on ``like``'s device."""
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def fused_update_ref(x, g, b2_sync, b2_local, eta, extra):
    """y = x − η·g/sqrt(b2_sync + extra);  b2_local += g²  (all math fp32)."""
    g32 = g.float()
    denom = torch.sqrt(b2_sync.float() + f32(extra, x))
    y = (x.float() - f32(eta, x) * g32 / denom).to(x.dtype)
    return y, b2_local.float() + g32 * g32


def block_quantize(v: torch.Tensor):
    """Symmetric per-block int8 quantization of a (rows, block) fp32 view:
    scale = max|v|·f32(1/127), q = round_half_even(v·(1/scale)) clipped to
    ±127 (all-zero rows quantize to 0). Returns (q int8, scale (rows, 1))."""
    scale = v.abs().amax(dim=1, keepdim=True) * f32(INV_127, v)
    pos = scale > 0
    inv = torch.where(pos, f32(1.0, v) / torch.where(pos, scale, 1.0), 0.0)
    q = torch.clamp(torch.round(v * inv), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_blocks_ref(x2d):
    """Per-block int8 quantization: (q int8 (nb, block), scales fp32 (nb, 1))."""
    return block_quantize(x2d.float())


def dequantize_blocks_ref(q2d, scales):
    """Inverse of :func:`quantize_blocks_ref`: x̂ = q · scale (fp32)."""
    return q2d.float() * scales


def fused_ef_blocks_ref(x2d, e2d, *, clamp_nonneg: bool = False,
                        out_dtype=None, codes: bool = False):
    """The error-feedback sync encode of a (nblocks, block) view:
    v = x + e; v̂ = max(dequantize(quantize(v)), lower) with lower 0 for
    accumulator payloads and float32-min otherwise; wire = v̂ cast to the
    payload dtype; residual' = v − wire. Returns (wire, residual'), and
    with ``codes`` also the int8 codes and scales of v."""
    v = x2d.float() + e2d
    q, s = quantize_blocks_ref(v)
    vhat = torch.maximum(dequantize_blocks_ref(q, s),
                         f32(0.0 if clamp_nonneg else F32_MIN, v))
    w = vhat.to(out_dtype or x2d.dtype)
    return (w, v - w.float(), q, s) if codes else (w, v - w.float())


def flat_fused_update_ref(plane, g_plane, bs_plane, bl_plane, eta, extra,
                          rnd16):
    """The flat-plane Local AdaAlter step without the kernel: the same bits
    the per-leaf ``LocalOptimizer.local_step`` produces, which computes the
    update in fp32, casts it to the parameter dtype and subtracts there. So
    16-bit slots (``rnd16``, a bool mask broadcastable to the plane) take
    ``bf16(x) − bf16(upd)``, not the rounded fp32 difference that the
    kernel's plain version takes: each mirrors its own per-leaf path."""
    upd = f32(eta, plane) * g_plane / torch.sqrt(bs_plane + f32(extra, plane))
    y32 = plane - upd
    y16 = (plane.to(torch.bfloat16) - upd.to(torch.bfloat16)).float()
    return torch.where(rnd16, y16, y32), bl_plane + torch.square(g_plane)


def flat_ef_blocks_ref(x2d, e2d, rnd, low, codes: bool = False):
    """The flat EF sync encode of (nblocks, block) fp32 views: the int8
    roundtrip with a per-block lower clamp ``low`` and bf16 wire rounding
    where ``rnd`` > 0 (both (nblocks, 1) fp32). Returns (wire, residual'),
    both fp32, and with ``codes`` also the int8 codes and scales of v."""
    v = x2d + e2d
    q, s = quantize_blocks_ref(v)
    vhat = torch.maximum(dequantize_blocks_ref(q, s), low)
    w = torch.where(rnd > 0, round_through_bf16(vhat), vhat)
    return (w, v - w, q, s) if codes else (w, v - w)


def _chunk_cumsum(dA):
    """cum = cumsum(dA) over each chunk, float32: (B, NZ, c, NH)."""
    return torch.cumsum(dA.float(), dim=2)


def ssd_chunk_states_ref(xbar, Bm, dA):
    """Stage 1 of the chunked SSD: each chunk's own contribution to the
    state, from a zero state, and its decay across the chunk.

    Returns (states (B, NZ, NH, N, hd) = (seg ⊙ B)ᵀ·x̄ with seg =
    exp(cum_last − cum), decay (B, NZ, NH) = exp(cum_last)), float32."""
    cum = _chunk_cumsum(dA)
    seg = torch.exp(cum[:, :, -1:, :] - cum)                       # decay to chunk end
    states = torch.einsum("bzsn,bzsh,bzshp->bzhnp", Bm.float(), seg,
                          xbar.float())
    return states, torch.exp(cum[:, :, -1, :])


def ssd_state_pass_ref(states, decay):
    """Stage 2: the recurrence across chunks, S ← S·decay[z] + states[z]
    from S = 0. Returns (the state entering each chunk (B, NZ, NH, N, hd),
    the state after the last chunk (B, NH, N, hd))."""
    S = torch.zeros_like(states[:, 0])
    S_before = []
    for z in range(states.shape[1]):                               # lax.scan
        S_before.append(S)
        S = S * decay[:, z, :, None, None] + states[:, z]
    return torch.stack(S_before, dim=1), S


def ssd_chunk_output_ref(xbar, Bm, Cm, dA, S_before):
    """Stage 3: y = tril(C·Bᵀ ⊙ exp(cumᵢ − cumⱼ))·x̄ + exp(cum) ⊙ (C·S),
    with S the state entering the chunk; the upper triangle is set to −inf
    before ``exp``. Returns y (B, NZ, c, NH, hd) float32."""
    c = xbar.shape[2]
    xbar, Bm, Cm = xbar.float(), Bm.float(), Cm.float()
    cum = _chunk_cumsum(dA)                                        # (B,nz,c,nh)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xbar.device))
    CB = torch.einsum("bzln,bzsn->bzls", Cm, Bm)                   # (B,nz,c,c)
    logdecay = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nz,l,s,nh)
    logdecay = torch.where(tri[None, None, :, :, None], logdecay,
                           f32(float("-inf"), logdecay))
    M = CB[..., None] * torch.exp(logdecay)
    y = torch.einsum("bzlsh,bzshp->bzlhp", M, xbar)
    return y + torch.einsum("bzln,bzlh,bzhnp->bzlhp", Cm, torch.exp(cum),
                            S_before)


def ssd_chunked(xbar, Bm, Cm, dA):
    """The chunked Mamba-2 SSD in plain PyTorch, all in float32: within a
    chunk the dual (attention-like) form, across chunks the state carried
    by a loop. The composition of the three stages the CUDA kernel
    launches: :func:`ssd_chunk_states_ref`, :func:`ssd_state_pass_ref`,
    :func:`ssd_chunk_output_ref`.

    xbar: (B, NZ, c, NH, hd) dt-scaled inputs; Bm/Cm: (B, NZ, c, N);
    dA: (B, NZ, c, NH), dt·A. Returns (y (B, NZ, c, NH, hd) without the
    D-skip term, S_last (B, NH, N, hd), the state after the last chunk)."""
    states, decay = ssd_chunk_states_ref(xbar, Bm, dA)
    S_before, S_last = ssd_state_pass_ref(states, decay)
    return ssd_chunk_output_ref(xbar, Bm, Cm, dA, S_before), S_last


def ssd_ref(xbar, Bm, Cm, dA):
    """Plain version of the SSD chunk-scan kernel: y (B, NZ, c, NH, hd)
    float32, without the D-skip term (see :func:`ssd_chunked`)."""
    return ssd_chunked(xbar, Bm, Cm, dA)[0]

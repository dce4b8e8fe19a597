"""One-pass error-feedback int8 sync encode: wrapper, plain version, CUDA kernel.

The sync round's device-side work, fused into one pass: read (x, e), write
(wire, e'). Per quantization block of one worker's payload:

    v = x + e ; (q, s) = quantize(v) ; v̂ = max(q·s, lower)
    wire = v̂ cast to x's dtype ; e' = v − wire

With ``codes=True`` the encode also returns the wire's int8 form, the
block codes and scales ``(q (nblocks, 256) int8, s (nblocks, 1) fp32)``, the
blocks of every worker row zero-padded: what a rank sends on the wire when
each worker is a rank (``launch/steps.py``); a peer's dequantize of them,
clamped and cast as above, gives this wire bit for bit.

The CUDA kernels are in ``csrc/sync_fused.cu``. :func:`fused_ef_leaf` (one
payload leaf) replaces the TPU kernel
``repro/kernels/sync_fused.py:fused_ef_blocks``. Unlike that kernel's
wrapper it pads nothing: it takes each leaf's (workers, elements per
worker) geometry and masks the ragged end of every worker's row.
:func:`flat_ef_blocks` (a whole fp32 flat plane, per-block sidecars for
the lower clamp and the bf16 wire rounding) replaces ``flat_ef_blocks``
there. Both write the new residual over ``e`` in place (the sync round
drops the old residual anyway; at full Big LSTM width that saves about
13 GB).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (INV_127, dequantize_blocks_ref,
                                     flat_ef_blocks_ref, fused_ef_blocks_ref,
                                     quantize_blocks_ref)
from repro_torch.kernels.tiling import (from_blocks, lead_body,
                                        round_through_bf16, tile_rows,
                                        to_blocks)

BLOCK = 256               # elements per quantization block (one warp x 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (the plain version on CPU tensors counts none)
launches = _build.LaunchCount()


def fused_ef_leaf_plain(x, e, *, block: int = BLOCK, batch_ndim: int = 0,
                        clamp_nonneg: bool = False, codes: bool = False):
    """The encode in plain PyTorch ops on the zero-padded blocked view.
    Returns (wire like x, new residual fp32), and with ``codes`` the
    wire's (q, scales); ``e`` is left untouched."""
    batch_ndim = min(batch_ndim, x.ndim)
    w2d, r2d, *qs = fused_ef_blocks_ref(to_blocks(x, block, batch_ndim),
                                        to_blocks(e, block, batch_ndim),
                                        clamp_nonneg=clamp_nonneg,
                                        out_dtype=x.dtype, codes=codes)
    out = (from_blocks(w2d, x.shape, batch_ndim),
           from_blocks(r2d, x.shape, batch_ndim))
    return (*out, tuple(qs)) if codes else out


def _kernel():
    fn = _build.load().fused_ef
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _codes_like(lead: int, body: int, device):
    """Empty (q, scales) for ``lead`` rows of ``body`` elements."""
    nb = lead * -(-body // BLOCK)
    return (torch.empty((nb, BLOCK), dtype=torch.int8, device=device),
            torch.empty((nb, 1), dtype=torch.float32, device=device))


def fused_ef_leaf(x, e, *, block: int = BLOCK, batch_ndim: int = 0,
                  clamp_nonneg: bool = False, codes: bool = False):
    """Encode one payload leaf of any shape; blocks never straddle the
    leading ``batch_ndim`` (worker) axes. Returns ``(wire, e)``: wire in
    x's dtype and ``e`` itself, overwritten with the new residual; with
    ``codes``, ``(wire, e, (q, scales))``.

    CPU tensors take :func:`fused_ef_leaf_plain`; CUDA tensors launch the
    kernel."""
    if x.dtype not in _DTYPES or e.dtype != torch.float32:
        raise TypeError(f"x must be float32/bfloat16 and e float32, got "
                        f"{x.dtype} and {e.dtype}")
    if e.shape != x.shape or e.device != x.device:
        raise ValueError(f"e {tuple(e.shape)} on {e.device} must match x "
                         f"{tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        w, r, *qs = fused_ef_leaf_plain(
            x, e, block=block, batch_ndim=batch_ndim,
            clamp_nonneg=clamp_nonneg, codes=codes)
        e.copy_(r)
        return (w, e, *qs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ef_leaf runs on cuda or cpu, not {x.device}")
    if block != BLOCK:
        raise ValueError(f"the CUDA kernel quantizes {BLOCK}-element blocks, "
                         f"got block={block}")
    if not (x.is_contiguous() and e.is_contiguous()):
        raise ValueError("x and e must be contiguous")
    lead, body = lead_body(x.shape, min(batch_ndim, x.ndim))
    wire = torch.empty_like(x)
    qs = _codes_like(lead, body, x.device) if codes else (None, None)
    rc = _kernel()(x.data_ptr(), e.data_ptr(), wire.data_ptr(),
                   *(t.data_ptr() if codes else None for t in qs), lead,
                   body, _DTYPES[x.dtype], int(clamp_nonneg), INV_127,
                   _build.stream_ptr(x))
    _build.check(rc, "fused_ef")
    launches.n += 1
    return (wire, e, qs) if codes else (wire, e)


def fused_ef_blocks(x2d, e2d, *, clamp_nonneg: bool = False):
    """The encode of a (nblocks, BLOCK) view, one quantization block per
    row — the signature of the TPU kernel's entry point."""
    if x2d.ndim != 2 or x2d.shape[1] != BLOCK:
        raise ValueError(f"expected a (nblocks, {BLOCK}) view, got "
                         f"{tuple(x2d.shape)}")
    return fused_ef_leaf(x2d, e2d, batch_ndim=1, clamp_nonneg=clamp_nonneg)


# --------------------------------------------------------------------------- #
# flat-plane variant: one launch for a whole payload plane
# --------------------------------------------------------------------------- #
#: launches of the flat CUDA kernel (the plain version counts none)
flat_launches = _build.LaunchCount()


def flat_ef_blocks_plain(x2d, e2d, rnd, low, codes: bool = False):
    """The flat kernel's arithmetic in plain PyTorch ops
    (``ref.flat_ef_blocks_ref``), the sidecars tiled over the blocks.
    Returns (wire, new residual), and with ``codes`` the wire's (q,
    scales); ``e2d`` is left untouched."""
    nb = x2d.shape[0]
    w, r, *qs = flat_ef_blocks_ref(x2d, e2d, tile_rows(rnd, nb),
                                   tile_rows(low, nb), codes=codes)
    return (w, r, tuple(qs)) if codes else (w, r)


def flat_ef_blocks(x2d, e2d, rnd, low, codes: bool = False):
    """One-pass EF encode of a flat payload viewed as (nblocks, 256) fp32
    blocks, with per-block fp32 sidecars ``rnd`` (> 0: the wire rounds
    through bf16) and ``low`` (the lower clamp), each (nblocks, 1) or of
    one plane row's blocks, which then serve every worker. Returns
    ``(wire, e2d)``: the fp32 wire, and ``e2d`` itself overwritten with the
    new residual; with ``codes``, ``(wire, e2d, (q, scales))``.

    CPU tensors take :func:`flat_ef_blocks_plain`; CUDA tensors launch the
    kernel."""
    if x2d.ndim != 2 or x2d.shape[1] != BLOCK:
        raise ValueError(f"expected a (nblocks, {BLOCK}) view, got "
                         f"{tuple(x2d.shape)}")
    nb = x2d.shape[0]
    for name, t in (("x2d", x2d), ("e2d", e2d), ("rnd", rnd), ("low", low)):
        if t.dtype != torch.float32 or t.device != x2d.device:
            raise TypeError(f"{name} must be float32 on {x2d.device}, got "
                            f"{t.dtype} on {t.device}")
    if e2d.shape != x2d.shape:
        raise ValueError(f"e2d {tuple(e2d.shape)} != x2d {tuple(x2d.shape)}")
    for name, t in (("rnd", rnd), ("low", low)):
        if t.ndim != 2 or t.shape[1] != 1 or not t.shape[0] or nb % t.shape[0]:
            raise ValueError(f"{name} {tuple(t.shape)} does not tile {nb} "
                             "blocks")
    if rnd.shape != low.shape:
        raise ValueError(f"rnd {tuple(rnd.shape)} != low {tuple(low.shape)}")
    if x2d.device.type == "cpu":
        w, r, *qs = flat_ef_blocks_plain(x2d, e2d, rnd, low, codes)
        e2d.copy_(r)
        return (w, e2d, *qs)
    if x2d.device.type != "cuda":
        raise ValueError(f"flat_ef_blocks runs on cuda or cpu, not {x2d.device}")
    for name, t in (("x2d", x2d), ("e2d", e2d), ("rnd", rnd), ("low", low)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    wire = torch.empty_like(x2d)
    qs = _codes_like(nb, BLOCK, x2d.device) if codes else (None, None)
    fn = _build.load().flat_ef
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(x2d.data_ptr(), e2d.data_ptr(), wire.data_ptr(),
                    *(t.data_ptr() if codes else None for t in qs),
                    rnd.data_ptr(), low.data_ptr(), nb, rnd.shape[0], INV_127,
                    _build.stream_ptr(x2d)), "flat_ef")
    flat_launches.n += 1
    return (wire, e2d, qs) if codes else (wire, e2d)


def flat_ef_plane(plane, residual, rnd_blocks, low_blocks, *,
                  block: int = BLOCK, use_kernels: bool = True,
                  fused: bool = True, codes: bool = False):
    """EF encode of one whole ``(..., M)`` fp32 payload plane, M a multiple
    of ``block`` (FlatSpace slot alignment guarantees it, so blocks never
    straddle leaves or workers). ``rnd_blocks``/``low_blocks`` are the
    (M // block, 1) sidecars of one plane row. ``fused`` runs the one-pass
    kernel (:func:`flat_ef_blocks`, or its plain version without
    ``use_kernels``); ``fused=False`` composes the same numerics from the
    quantize/dequantize pair (``kernels/quantize.py``). Returns
    ``(wire_plane, residual)``, ``residual`` overwritten with the new one,
    and with ``codes`` the wire's ``(q, scales)`` (nblocks of 256)."""
    shape = plane.shape
    if shape[-1] % block or residual.shape != shape:
        raise ValueError(f"plane {tuple(shape)} and residual "
                         f"{tuple(residual.shape)} must match, rows a "
                         f"multiple of {block}")
    x2d = plane.reshape(-1, block)
    e2d = residual.view(-1, block)
    if fused and use_kernels:
        wire, _, *qs = flat_ef_blocks(x2d, e2d, rnd_blocks, low_blocks,
                                      codes)
        return (wire.reshape(shape), residual, *qs)
    nb = x2d.shape[0]
    rnd, low = tile_rows(rnd_blocks, nb), tile_rows(low_blocks, nb)
    if fused:
        wire, r, *qs = flat_ef_blocks_ref(x2d, e2d, rnd, low, codes=codes)
        qs = [tuple(qs)] if codes else []
    else:
        # three passes over the same blocked view (the generic ef_apply
        # composition, with its separately materialised v̂)
        from repro_torch.kernels.quantize import (dequantize_blocks,
                                                  quantize_blocks)
        v = x2d + e2d
        q, s = (quantize_blocks if use_kernels else quantize_blocks_ref)(v)
        vhat = (dequantize_blocks if use_kernels
                else dequantize_blocks_ref)(q, s)
        wire = flat_wire(vhat, rnd, low)
        r = v - wire
        qs = [(q, s)] if codes else []
    e2d.copy_(r)
    return (wire.reshape(shape), residual, *qs)


def flat_wire(vhat, rnd, low):
    """The flat wire from dequantized blocks ``vhat`` (nblocks, 256):
    clamped below at ``low`` and, where ``rnd`` > 0, rounded through bf16
    (both (nblocks, 1) sidecars)."""
    vhat = torch.maximum(vhat, low)
    return torch.where(rnd > 0, round_through_bf16(vhat), vhat)

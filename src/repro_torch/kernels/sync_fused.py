"""One-pass error-feedback int8 sync encode: wrapper, plain version, CUDA kernel.

The sync round's device-side work, fused into one pass: read (x, e), write
(wire, e'). Per quantization block of one worker's payload:

    v = x + e ; (q, s) = quantize(v) ; v̂ = max(q·s, lower)
    wire = v̂ cast to x's dtype ; e' = v − wire

The CUDA kernel is ``csrc/sync_fused.cu``; it replaces the TPU kernel
``repro/kernels/sync_fused.py:fused_ef_blocks``. Unlike that kernel's
wrapper it pads nothing: it takes each leaf's (workers, elements per
worker) geometry and masks the ragged end of every worker's row, and it
writes the new residual over ``e`` in place (the sync round drops the old
residual anyway; at full Big LSTM width that saves about 13 GB).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import INV_127, fused_ef_blocks_ref
from repro_torch.kernels.tiling import from_blocks, lead_body, to_blocks

BLOCK = 256               # elements per quantization block (one warp x 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (the plain version on CPU tensors counts none)
launches = _build.LaunchCount()


def fused_ef_leaf_plain(x, e, *, block: int = BLOCK, batch_ndim: int = 0,
                        clamp_nonneg: bool = False):
    """The encode in plain PyTorch ops on the zero-padded blocked view.
    Returns (wire like x, new residual fp32); ``e`` is left untouched."""
    batch_ndim = min(batch_ndim, x.ndim)
    w2d, r2d = fused_ef_blocks_ref(to_blocks(x, block, batch_ndim),
                                   to_blocks(e, block, batch_ndim),
                                   clamp_nonneg=clamp_nonneg,
                                   out_dtype=x.dtype)
    return (from_blocks(w2d, x.shape, batch_ndim),
            from_blocks(r2d, x.shape, batch_ndim))


def _kernel():
    fn = _build.load().fused_ef
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_ef_leaf(x, e, *, block: int = BLOCK, batch_ndim: int = 0,
                  clamp_nonneg: bool = False):
    """Encode one payload leaf of any shape; blocks never straddle the
    leading ``batch_ndim`` (worker) axes. Returns ``(wire, e)``: wire in
    x's dtype and ``e`` itself, overwritten with the new residual.

    CPU tensors take :func:`fused_ef_leaf_plain`; CUDA tensors launch the
    kernel."""
    if x.dtype not in _DTYPES or e.dtype != torch.float32:
        raise TypeError(f"x must be float32/bfloat16 and e float32, got "
                        f"{x.dtype} and {e.dtype}")
    if e.shape != x.shape or e.device != x.device:
        raise ValueError(f"e {tuple(e.shape)} on {e.device} must match x "
                         f"{tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        w, r = fused_ef_leaf_plain(x, e, block=block, batch_ndim=batch_ndim,
                                   clamp_nonneg=clamp_nonneg)
        e.copy_(r)
        return w, e
    if x.device.type != "cuda":
        raise ValueError(f"fused_ef_leaf runs on cuda or cpu, not {x.device}")
    if block != BLOCK:
        raise ValueError(f"the CUDA kernel quantizes {BLOCK}-element blocks, "
                         f"got block={block}")
    if not (x.is_contiguous() and e.is_contiguous()):
        raise ValueError("x and e must be contiguous")
    lead, body = lead_body(x.shape, min(batch_ndim, x.ndim))
    wire = torch.empty_like(x)
    rc = _kernel()(x.data_ptr(), e.data_ptr(), wire.data_ptr(), lead, body,
                   _DTYPES[x.dtype], int(clamp_nonneg), INV_127,
                   _build.stream_ptr(x))
    _build.check(rc, "fused_ef")
    launches.n += 1
    return wire, e


def fused_ef_blocks(x2d, e2d, *, clamp_nonneg: bool = False):
    """The encode of a (nblocks, BLOCK) view, one quantization block per
    row — the signature of the TPU kernel's entry point."""
    if x2d.ndim != 2 or x2d.shape[1] != BLOCK:
        raise ValueError(f"expected a (nblocks, {BLOCK}) view, got "
                         f"{tuple(x2d.shape)}")
    return fused_ef_leaf(x2d, e2d, batch_ndim=1, clamp_nonneg=clamp_nonneg)

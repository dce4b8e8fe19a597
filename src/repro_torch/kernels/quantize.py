"""Per-block int8 quantize / dequantize: wrappers, plain versions, CUDA kernels.

The kernel pair of the three-pass sync encode (``--unfused-sync``) and of
the int8 codec's separate encode and decode. A payload is flattened into
``(nblocks, BLOCK)`` rows that never straddle the leading ``batch_ndim``
(worker) axes, each worker's row zero-padded to whole blocks; each row is
one quantization block:

    scale = max|v|·f32(1/127) ;  q = clip(round(v / scale), ±127)  (int8)
    x̂     = q · scale

The CUDA kernels are ``csrc/quantize.cu``; they replace the TPU kernels
``repro/kernels/quantize.py:quantize_blocks`` and ``dequantize_blocks``.
Their plain versions are ``ref.quantize_blocks_ref`` and
``ref.dequantize_blocks_ref`` (``ref.block_quantize``), the numerics the
one-pass EF kernels share, so the three-pass and one-pass encodes agree
bitwise.

Each kernel has a cost function (:func:`quantize_cost`,
:func:`dequantize_cost`) and a ``meta`` route: on ``meta`` tensors a
wrapper returns its outputs as empty ``meta`` tensors and charges the
cost to the walk in progress (``charges.kernel_call``), launching nothing;
on the card it charges the same cost where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (INV_127, dequantize_blocks_ref,
                                     quantize_blocks_ref)
from repro_torch.kernels.tiling import from_blocks, to_blocks
from repro_torch.charges import kernel_call, route

BLOCK = 256               # elements per quantization block (one warp x 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of each CUDA kernel (the plain versions on CPU tensors count none)
quantize_launches = _build.LaunchCount()
dequantize_launches = _build.LaunchCount()


def quantize_cost(nb: int, itemsize: int) -> dict:
    """Quantizing ``nb`` blocks of ``itemsize``-byte values: read them,
    write the int8 codes and a fp32 scale a block; a block's max, and a
    division, rounding and clip an element."""
    n = nb * BLOCK
    return {"bytes": n * itemsize + n + nb * 4, "operations": 4 * n}


def dequantize_cost(nb: int) -> dict:
    """Dequantizing ``nb`` blocks: read the codes and scales, write fp32;
    one product an element."""
    n = nb * BLOCK
    return {"bytes": n + nb * 4 + n * 4, "operations": n}


def _blocked(name, t, dtypes):
    if t.ndim != 2 or t.shape[1] != BLOCK:
        raise ValueError(f"{name} must be a (nblocks, {BLOCK}) view, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")


def quantize_blocks(x2d):
    """Quantize a (nblocks, 256) fp32 or bf16 view. Returns (q int8
    (nblocks, 256), scales fp32 (nblocks, 1)).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _blocked("x2d", x2d, tuple(_DTYPES))
    kind = route(x2d, "quantize_blocks")
    if kind == "cpu":
        return quantize_blocks_ref(x2d)
    if not x2d.is_contiguous():
        raise ValueError("x2d must be contiguous")
    nb = x2d.shape[0]
    q = torch.empty(x2d.shape, dtype=torch.int8, device=x2d.device)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=x2d.device)
    if kernel_call("quantize_blocks", quantize_cost(nb, x2d.element_size()),
                   kind):
        return q, scales
    fn = _build.load().quantize_blocks
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(x2d.data_ptr(), q.data_ptr(), scales.data_ptr(), nb,
                    _DTYPES[x2d.dtype], INV_127, _build.stream_ptr(x2d)),
                 "quantize_blocks")
    quantize_launches.n += 1
    return q, scales


def dequantize_blocks(q2d, scales):
    """x̂ = q · scale of a (nblocks, 256) int8 view and its (nblocks, 1)
    fp32 scales, in fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _blocked("q2d", q2d, (torch.int8,))
    if scales.dtype != torch.float32 or scales.shape != (q2d.shape[0], 1):
        raise ValueError(f"scales must be fp32 ({q2d.shape[0]}, 1), got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if scales.device != q2d.device:
        raise ValueError(f"scales on {scales.device}, q2d on {q2d.device}")
    kind = route(q2d, "dequantize_blocks")
    if kind == "cpu":
        return dequantize_blocks_ref(q2d, scales)
    if not (q2d.is_contiguous() and scales.is_contiguous()):
        raise ValueError("q2d and scales must be contiguous")
    y = torch.empty(q2d.shape, dtype=torch.float32, device=q2d.device)
    if kernel_call("dequantize_blocks", dequantize_cost(q2d.shape[0]), kind):
        return y
    fn = _build.load().dequantize_blocks
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(q2d.data_ptr(), scales.data_ptr(), y.data_ptr(),
                    q2d.shape[0], _build.stream_ptr(q2d)), "dequantize_blocks")
    dequantize_launches.n += 1
    return y


def _check_block(block: int, use_kernels: bool) -> None:
    if use_kernels and block != BLOCK:
        raise ValueError(f"the kernels quantize {BLOCK}-element blocks, got "
                         f"block={block}")


def quantize(x, *, block: int = BLOCK, batch_ndim: int = 0,
             use_kernels: bool = True):
    """Per-block int8 quantization of a tensor of any shape. Returns
    ``(q int8 (nblocks, block), scales fp32 (nblocks, 1))``; round-trip
    with :func:`dequantize` and the same arguments. ``use_kernels=False``
    runs the plain version on any device."""
    _check_block(block, use_kernels)
    x2d = to_blocks(x, block, batch_ndim)
    return quantize_blocks(x2d) if use_kernels else quantize_blocks_ref(x2d)


def dequantize(q, scales, shape, *, block: int = BLOCK, batch_ndim: int = 0,
               use_kernels: bool = True):
    """Inverse of :func:`quantize`: an fp32 tensor of ``shape``."""
    _check_block(block, use_kernels)
    y2d = (dequantize_blocks(q, scales) if use_kernels
           else dequantize_blocks_ref(q, scales))
    return from_blocks(y2d, shape, batch_ndim)


def dequantize_range(q, scales, start: int, stop: int, *,
                     block: int = BLOCK, use_kernels: bool = True):
    """Elements ``start:stop`` of one worker row's dequantized values, from
    the row's (nblocks, block) codes and (nblocks, 1) scales (its blocks
    zero-padded past the row's end); ``start`` a multiple of ``block``.
    Returns fp32 (stop - start,)."""
    _check_block(block, use_kernels)
    if start % block:
        raise ValueError(f"start {start} is not a multiple of {block}")
    b0, b1 = start // block, -(-stop // block)
    fn = dequantize_blocks if use_kernels else dequantize_blocks_ref
    return fn(q[b0:b1], scales[b0:b1]).view(-1)[:stop - start]


def fake_quantize(x, *, block: int = BLOCK, batch_ndim: int = 0,
                  use_kernels: bool = True):
    """dequantize(quantize(x)): the fp32 value a receiver reconstructs."""
    q, s = quantize(x, block=block, batch_ndim=batch_ndim,
                    use_kernels=use_kernels)
    return dequantize(q, s, x.shape, block=block, batch_ndim=batch_ndim,
                      use_kernels=use_kernels)

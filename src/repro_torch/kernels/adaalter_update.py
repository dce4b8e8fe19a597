"""Fused (Local) AdaAlter parameter update: wrapper, plain version, CUDA kernel.

One pass over device memory per optimizer step and leaf: reads
(x, g, b2_sync, b2_local), writes (y, new_b2_local) — the paper's line-6/7
pair

    y           = x − (η · g) · rsqrt(b2_sync + t'·ε²)
    b2_local    = b2_local + g∘g

The CUDA kernel is ``csrc/adaalter_update.cu``; it replaces the TPU kernel
``repro/kernels/adaalter_update.py:fused_update_2d``. η and t'·ε² travel as
a 2-float tensor on the data's device (:func:`update_scalars`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (the plain version on CPU tensors counts none)
launches = _build.LaunchCount()


def update_scalars(eta, extra, device) -> torch.Tensor:
    """(η, t'·ε²) as the kernel's 2-float operand on ``device``."""
    return torch.tensor([float(eta), float(extra)], dtype=torch.float32,
                        device=device)


def fused_update_plain(x, g, b2_sync, b2_local, scalars):
    """The kernel's arithmetic in plain PyTorch ops:
    y = x − (η·g)·rsqrt(b2_sync + t'ε²) rounded once to x's dtype,
    b2_local + g·g in fp32."""
    eta, extra = scalars[0], scalars[1]
    g32 = g.float()
    y = (x.float() - eta * g32 * torch.rsqrt(b2_sync + extra)).to(x.dtype)
    return y, b2_local + g32 * g32


def _check(x, g, b2_sync, b2_local, scalars):
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(f"x and g must share a float32/bfloat16 dtype, got "
                        f"{x.dtype} and {g.dtype}")
    for name, t in (("b2_sync", b2_sync), ("b2_local", b2_local),
                    ("scalars", scalars)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("g", g), ("b2_sync", b2_sync), ("b2_local", b2_local)):
        if t.shape != x.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != x shape "
                             f"{tuple(x.shape)}")
    if scalars.shape != (2,):
        raise ValueError(f"scalars must have shape (2,), got {tuple(scalars.shape)}")
    for t in (g, b2_sync, b2_local, scalars):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {t.device}")


def _kernel():
    fn = _build.load().adaalter_update
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_update(x, g, b2_sync, b2_local, scalars):
    """Fused update of one leaf of any shape. Returns (y, new_b2_local).

    CPU tensors take :func:`fused_update_plain`; CUDA tensors launch the
    kernel. ``scalars`` comes from :func:`update_scalars`."""
    _check(x, g, b2_sync, b2_local, scalars)
    if x.device.type == "cpu":
        return fused_update_plain(x, g, b2_sync, b2_local, scalars)
    if x.device.type != "cuda":
        raise ValueError(f"fused_update runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("g", g), ("b2_sync", b2_sync),
                    ("b2_local", b2_local), ("scalars", scalars)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty_like(x)
    b2_out = torch.empty_like(b2_local)
    rc = _kernel()(x.data_ptr(), g.data_ptr(), b2_sync.data_ptr(),
                   b2_local.data_ptr(), scalars.data_ptr(), y.data_ptr(),
                   b2_out.data_ptr(), x.numel(), _DTYPES[x.dtype],
                   _build.stream_ptr(x))
    _build.check(rc, "adaalter_update")
    launches.n += 1
    return y, b2_out

"""Mamba-2 SSD chunk scan (forward): wrapper, plain version, CUDA kernel.

For each (batch, head), chunks in order, with an fp32 state S (N, hd)
carried across chunks:

    y = tril(C·Bᵀ ⊙ exp(cumᵢ − cumⱼ))·x̄ + exp(cum)·(C·S)
    S ← exp(cum_last)·S + Bᵀ·(exp(cum_last − cum)·x̄)

The CUDA kernel is ``csrc/ssd_scan.cu``; it replaces the TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan``. Its plain version is
``ref.ssd_ref``. Like the TPU kernel it is forward-only: there is no
backward, so the wrapper refuses inputs that autograd would record.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref

#: the largest chunk, state and head sizes the kernel's shared memory holds
MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 64, 128, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (the plain version on CPU tensors counts none)
launches = _build.LaunchCount()


def _check(xbar, Bm, Cm, dA):
    if xbar.ndim != 5:
        raise ValueError(f"xbar must be (B, NZ, c, NH, hd), got "
                         f"{tuple(xbar.shape)}")
    b, nz, c, nh, hd = xbar.shape
    n = Bm.shape[-1] if Bm.ndim == 4 else -1
    if Bm.shape != (b, nz, c, n) or Cm.shape != (b, nz, c, n):
        raise ValueError(f"Bm and Cm must be ({b}, {nz}, {c}, N), got "
                         f"{tuple(Bm.shape)} and {tuple(Cm.shape)}")
    if dA.shape != (b, nz, c, nh):
        raise ValueError(f"dA must be ({b}, {nz}, {c}, {nh}), got "
                         f"{tuple(dA.shape)}")
    for name, t in (("xbar", xbar), ("Bm", Bm), ("Cm", Cm), ("dA", dA)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.device != xbar.device:
            raise ValueError(f"{name} on {t.device}, xbar on {xbar.device}")
    if xbar.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {xbar.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xbar, Bm, Cm, dA)):
        raise RuntimeError("ssd_scan has no backward (as the TPU kernel): "
                           "call it under torch.no_grad() or "
                           "torch.inference_mode(), or train with "
                           "ssm_pallas=False")
    return b, nz, c, nh, hd, n


def smem_bytes(c: int, n: int, hd: int) -> int:
    """Dynamic shared memory of one kernel block at chunk ``c``, state ``n``
    and head dimension ``hd`` (builds and loads the kernels)."""
    fn = _build.load().ssd_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(c, n, hd)


def ssd_scan(xbar, Bm, Cm, dA):
    """Fused SSD forward, without the D-skip term (elementwise; the caller
    adds it).

    xbar: (B, NZ, c, NH, hd) dt-scaled inputs; Bm/Cm: (B, NZ, c, N);
    dA: (B, NZ, c, NH), dt·A (negative). fp32 or bf16 inputs; returns
    y (B, NZ, c, NH, hd) fp32. CPU tensors take the plain version; CUDA
    tensors launch the kernel (c ≤ 64, N ≤ 128, hd ≤ 64)."""
    b, nz, c, nh, hd, n = _check(xbar, Bm, Cm, dA)
    if xbar.device.type == "cpu":
        return ssd_ref(xbar, Bm, Cm, dA)
    if c > MAX_CHUNK or n > MAX_STATE or hd > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes c <= {MAX_CHUNK}, N <= "
                         f"{MAX_STATE}, hd <= {MAX_HEAD_DIM}; got c={c}, "
                         f"N={n}, hd={hd}")
    if not (xbar.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"xbar, Bm and Cm must share a dtype, got "
                        f"{xbar.dtype}, {Bm.dtype}, {Cm.dtype}")
    dA = dA.float()
    y = torch.empty(xbar.shape, dtype=torch.float32, device=xbar.device)
    strides = (ctypes.c_longlong * 17)(*xbar.stride(), *Bm.stride(),
                                       *Cm.stride(), *dA.stride())
    fn = _build.load().ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(xbar.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    dA.data_ptr(), y.data_ptr(), strides, _DTYPES[xbar.dtype],
                    b, nz, c, nh, hd, n, _build.stream_ptr(xbar)), "ssd_scan")
    launches.n += 1
    return y

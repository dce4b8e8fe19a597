"""Mamba-2 SSD chunk scan (forward): wrapper, plain version, CUDA kernels.

For each (batch, head), with an fp32 state S (N, hd) carried across
chunks:

    y = tril(C·Bᵀ ⊙ exp(cumᵢ − cumⱼ))·x̄ + exp(cum)·(C·S)
    S ← exp(cum_last)·S + Bᵀ·(exp(cum_last − cum)·x̄)

``csrc/ssd_scan.cu`` computes it in three launches on the current stream:
each chunk's own state (``ssd_chunk_states``), the recurrence across
chunks (``ssd_state_pass``) and y (``ssd_chunk_output``), with the
products on the tensor cores as 3xTF32 (``csrc/mma_tf32.cuh``). It
replaces the TPU kernel ``repro/kernels/ssd_scan.py:ssd_scan``. Its plain
version is ``ref.ssd_ref``, the composition of the three stages'
``ref.ssd_chunk_states_ref``, ``ref.ssd_state_pass_ref`` and
``ref.ssd_chunk_output_ref``. Like the TPU kernel it is forward-only:
there is no backward, so the wrapper refuses inputs that autograd would
record.

:func:`ssd_cost` gives the bytes and operations of one call (the bound of
``PERF.md``'s kernel table). On ``meta`` tensors the wrapper returns y as
an empty ``meta`` tensor and charges that cost to the walk in progress
(``charges.kernel_call``), launching nothing; on the card it charges the
same cost where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.hardware import H100
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref
from repro_torch.charges import kernel_call, route

#: the largest chunk, state and head sizes the kernels' tiles hold
MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 64, 128, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: calls that launched the CUDA kernels (three launches each; the plain
#: version on CPU tensors counts none)
launches = _build.LaunchCount()


def ssd_cost(b, nz, c, nh, hd, n, in_bytes) -> dict:
    """The least work of one SSD chunk scan: bytes (x̄, B, C in the input
    dtype and dA fp32 read once, y fp32 written once) and operations (C·Bᵀ
    once per (batch, chunk) and M·x̄ over the lower triangle only, C·S and
    the state update per head, one FMA = 2 operations); its bound on the
    H100, the larger of the bytes over the HBM rate and the operations
    three times over, as the kernels' 3xTF32 products do them, over the
    dense TF32 tensor-core rate. ``bound_fp32_cores_ms`` is the same work
    once over the fp32 rate outside the tensor cores."""
    tri = c * (c + 1) // 2
    nbytes = (b * nz * c * (nh * hd + 2 * n) * in_bytes + b * nz * c * nh * 4
              + b * nz * c * nh * hd * 4)
    ops = 2 * b * nz * (tri * n + nh * (tri * hd + 2 * c * n * hd))
    t_bytes = 1e3 * nbytes / H100.hbm_bw
    t_ops = 1e3 * 3 * ops / H100.tf32_flops
    return dict(bytes=nbytes, operations=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_fp32_cores_ms=max(t_bytes,
                                        1e3 * ops / H100.fp32_flops))


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
    kind = route(xbar, "ssd_scan")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xbar, Bm, Cm, dA)):
        raise RuntimeError("ssd_scan has no backward (as the TPU kernel): "
                           "call it under torch.no_grad() or "
                           "torch.inference_mode(), or train with "
                           "ssm_pallas=False")
    return kind, (b, nz, c, nh, hd, n)


def launch_plan(b: int, nz: int, nh: int, hd: int, n: int) -> dict:
    """The kernels' launch geometry at these sizes (fp32 inputs): heads per
    block of the chunk kernels, threads a block, and for each of the three
    kernels its blocks, the dynamic shared memory of one block (bytes) and
    the blocks an SM holds at once (builds and loads the library)."""
    fn = _build.load().ssd_scan_plan
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 11)()
    _build.check(fn(b, nz, nh, hd, n, out), "ssd_scan_plan")
    plan = {"heads_per_block": out[0], "threads_per_block": out[1]}
    for i, name in enumerate(("ssd_chunk_states", "ssd_state_pass",
                              "ssd_chunk_output")):
        plan[name] = {"blocks": out[2 + 3 * i],
                      "smem_bytes": out[3 + 3 * i],
                      "blocks_per_sm": out[4 + 3 * i]}
    return plan


def mma_selftest(a, b, transposed: bool = False):
    """a·b for a (64, 128) and b (128, 64) float32 CUDA tensors through the
    kernels' warp-level 3xTF32 product helper alone. ``transposed`` stages
    the operands in the other layouts the SSD kernels read them in."""
    if a.shape != (64, 128) or b.shape != (128, 64):
        raise ValueError(f"want a (64, 128) and b (128, 64), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_cuda and b.is_cuda and a.dtype == b.dtype == torch.float32):
        raise ValueError("mma_selftest takes float32 CUDA tensors")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    fn = _build.load().ssd_mma_selftest
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), int(transposed),
                    _build.stream_ptr(a)), "ssd_mma_selftest")
    return c


def ssd_scan(xbar, Bm, Cm, dA):
    """Fused SSD forward, without the D-skip term (elementwise; the caller
    adds it).

    xbar: (B, NZ, c, NH, hd) dt-scaled inputs; Bm/Cm: (B, NZ, c, N);
    dA: (B, NZ, c, NH), dt·A (negative). fp32 or bf16 inputs; returns
    y (B, NZ, c, NH, hd) fp32. CPU tensors take the plain version; CUDA
    tensors launch the kernel (c ≤ 64, N ≤ 128, hd ≤ 64)."""
    kind, (b, nz, c, nh, hd, n) = _check(xbar, Bm, Cm, dA)
    if kind == "cpu":
        return ssd_ref(xbar, Bm, Cm, dA)
    if c > MAX_CHUNK or n > MAX_STATE or hd > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes c <= {MAX_CHUNK}, N <= "
                         f"{MAX_STATE}, hd <= {MAX_HEAD_DIM}; got c={c}, "
                         f"N={n}, hd={hd}")
    if not (xbar.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"xbar, Bm and Cm must share a dtype, got "
                        f"{xbar.dtype}, {Bm.dtype}, {Cm.dtype}")
    dA = dA.float()
    dev = xbar.device
    states = torch.empty((b, nz, nh, n, hd), dtype=torch.float32, device=dev)
    decay = torch.empty((b, nz, nh), dtype=torch.float32, device=dev)
    y = torch.empty(xbar.shape, dtype=torch.float32, device=dev)
    if kernel_call("ssd_scan", ssd_cost(b, nz, c, nh, hd, n,
                                        xbar.element_size()), kind):
        return y
    strides = (ctypes.c_longlong * 17)(*xbar.stride(), *Bm.stride(),
                                       *Cm.stride(), *dA.stride())
    fn = _build.load().ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(xbar.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    dA.data_ptr(), states.data_ptr(), decay.data_ptr(),
                    y.data_ptr(), strides, _DTYPES[xbar.dtype], b, nz, c, nh,
                    hd, n, _build.stream_ptr(xbar)), "ssd_scan")
    launches.n += 1
    return y

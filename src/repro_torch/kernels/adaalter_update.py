"""Fused (Local) AdaAlter parameter update: wrapper, plain version, CUDA kernel.

One pass over device memory per optimizer step and leaf: reads
(x, g, b2_sync, b2_local), writes (y, new_b2_local) — the paper's line-6/7
pair

    y           = x − (η · g) · rsqrt(b2_sync + t'·ε²)
    b2_local    = b2_local + g∘g

The CUDA kernels are in ``csrc/adaalter_update.cu``: :func:`fused_update`
(one leaf) replaces the TPU kernel
``repro/kernels/adaalter_update.py:fused_update_2d``, and
:func:`flat_fused_update` (whole flat planes) replaces ``flat_fused_update``
there. Both evaluate one device expression, so a flat plane and the
per-leaf tensors get bitwise the same update. η and t'·ε² travel as a
2-float tensor on the data's device (:func:`update_scalars`).

Each kernel has a cost function (:func:`update_cost`,
:func:`flat_update_cost`: the bytes it must move and the operations it
does, the bound of ``PERF.md``'s kernel table) and a ``meta`` route: on
``meta`` tensors a wrapper returns its outputs as empty ``meta`` tensors
and charges the cost to the walk in progress (``charges.kernel_call``),
launching nothing and counting no launch. On the card it charges the same
cost where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiling import tile_rows
from repro_torch.charges import kernel_call, route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (the plain version on CPU tensors counts none)
launches = _build.LaunchCount()


#: operations an element: η·g, b2_sync + t'ε², rsqrt, the product, x − it,
#: g·g and its sum
UPDATE_OPS = 7


def update_cost(n: int, itemsize: int) -> dict:
    """One leaf's update of ``n`` elements of ``itemsize`` bytes (x and g):
    reads x, g, b2_sync, b2_local, writes y, b2_local'."""
    return {"bytes": n * (3 * itemsize + 3 * 4), "operations": UPDATE_OPS * n}


def flat_update_cost(n: int) -> dict:
    """The flat update of ``n`` fp32 plane elements: four planes read, two
    written."""
    return {"bytes": n * 6 * 4, "operations": UPDATE_OPS * n}


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
    kind = route(x, "fused_update")
    if kind == "cpu":
        return fused_update_plain(x, g, b2_sync, b2_local, scalars)
    for name, t in (("x", x), ("g", g), ("b2_sync", b2_sync),
                    ("b2_local", b2_local), ("scalars", scalars)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty_like(x)
    b2_out = torch.empty_like(b2_local)
    if kernel_call("adaalter_update",
                   update_cost(x.numel(), x.element_size()), kind):
        return y, b2_out
    rc = _kernel()(x.data_ptr(), g.data_ptr(), b2_sync.data_ptr(),
                   b2_local.data_ptr(), scalars.data_ptr(), y.data_ptr(),
                   b2_out.data_ptr(), x.numel(), _DTYPES[x.dtype],
                   _build.stream_ptr(x))
    _build.check(rc, "adaalter_update")
    launches.n += 1
    return y, b2_out


# --------------------------------------------------------------------------- #
# flat-plane variant: one launch for the whole parameter plane
# --------------------------------------------------------------------------- #
LANES = 128               # elements per row of the rnd sidecar

#: launches of the flat CUDA kernel (the plain version counts none)
flat_launches = _build.LaunchCount()


def flat_fused_update_plain(plane, g_plane, bs_plane, bl_plane, scalars,
                            rnd_rows):
    """The flat kernel's arithmetic in plain PyTorch ops: the per-leaf
    kernel's y and b2_local on fp32 planes, y rounded through bf16 on the
    128-element rows whose ``rnd_rows`` flag is > 0."""
    eta, extra = scalars[0], scalars[1]
    y = (plane - eta * g_plane * torch.rsqrt(bs_plane + extra)).reshape(
        -1, LANES)
    rnd = tile_rows(rnd_rows, y.shape[0])
    y = torch.where(rnd > 0, y.to(torch.bfloat16).float(), y)
    return y.reshape(plane.shape), bl_plane + g_plane * g_plane


def flat_fused_update(plane, g_plane, bs_plane, bl_plane, scalars, rnd_rows,
                      *, y=None, b2_out=None):
    """One-launch Local AdaAlter step over whole fp32 planes ``(..., P)``,
    P a multiple of 128. ``rnd_rows`` is the (rows, 1) fp32 bf16-rounding
    sidecar of the whole ``(..., P)`` row space or of ONE plane row
    (``P // 128`` rows), which then serves every worker. ``y`` and
    ``b2_out`` name the output buffers (``plane`` and ``bl_plane`` are
    allowed: each element is read before it is written); new tensors by
    default. Returns ``(y, b2_out)``.

    CPU tensors take :func:`flat_fused_update_plain`; CUDA tensors launch
    the kernel."""
    planes = {"plane": plane, "g_plane": g_plane, "bs_plane": bs_plane,
              "bl_plane": bl_plane}
    planes.update({k: v for k, v in (("y", y), ("b2_out", b2_out))
                   if v is not None})
    for name, t in {**planes, "rnd_rows": rnd_rows, "scalars": scalars}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != plane.device:
            raise ValueError(f"all operands must be on {plane.device}, got "
                             f"{t.device}")
    for name, t in planes.items():
        if t.shape != plane.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != plane shape "
                             f"{tuple(plane.shape)}")
    per_row = plane.shape[-1] // LANES
    if plane.shape[-1] % LANES or scalars.shape != (2,):
        raise ValueError(f"plane rows must be multiples of {LANES} and "
                         f"scalars (2,), got {tuple(plane.shape)}, "
                         f"{tuple(scalars.shape)}")
    if rnd_rows.shape not in ((plane.numel() // LANES, 1), (per_row, 1)):
        raise ValueError(f"rnd_rows must be ({plane.numel() // LANES}, 1) or "
                         f"({per_row}, 1), got {tuple(rnd_rows.shape)}")
    kind = route(plane, "flat_fused_update")
    if kind == "cpu":
        y_new, b2_new = flat_fused_update_plain(plane, g_plane, bs_plane,
                                                bl_plane, scalars, rnd_rows)
        return (y_new if y is None else y.copy_(y_new),
                b2_new if b2_out is None else b2_out.copy_(b2_new))
    planes["y"] = y = torch.empty_like(plane) if y is None else y
    planes["b2_out"] = b2_out = (torch.empty_like(bl_plane) if b2_out is None
                                 else b2_out)
    for name, t in {**planes, "rnd_rows": rnd_rows, "scalars": scalars}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kernel_call("flat_fused_update", flat_update_cost(plane.numel()),
                   kind):
        return y, b2_out
    for name, t in planes.items():        # read and written as float4s
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = _build.load().flat_update
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(plane.data_ptr(), g_plane.data_ptr(), bs_plane.data_ptr(),
                    bl_plane.data_ptr(), rnd_rows.data_ptr(),
                    scalars.data_ptr(), y.data_ptr(), b2_out.data_ptr(),
                    plane.numel(), rnd_rows.shape[0], _build.stream_ptr(plane)),
                 "flat_update")
    flat_launches.n += 1
    return y, b2_out

"""Padding and blocked views shared by the kernels' plain versions.

``to_blocks`` flattens a leaf to ``(nblocks, block)`` rows that never
straddle the leading ``batch_ndim`` axes (the per-worker payload boundary),
zero-padding each worker's row to a whole number of blocks;
``from_blocks`` strips that padding again. The CUDA kernels read the same
geometry from ``(lead, body)`` and mask each worker row's ragged tail
instead of materializing the padded copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pad_rows(a: torch.Tensor, tile: int) -> torch.Tensor:
    """Zero-pad axis 0 of ``a`` up to a multiple of ``tile`` rows."""
    pad = (-a.shape[0]) % tile
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], 0)


def lead_body(shape, batch_ndim: int):
    """(workers, elements per worker) of a leaf whose leading ``batch_ndim``
    axes enumerate workers."""
    return math.prod(shape[:batch_ndim]), math.prod(shape[batch_ndim:])


def to_blocks(x: torch.Tensor, block: int, batch_ndim: int) -> torch.Tensor:
    """Flatten to (nblocks, block), zero-padded; blocks never straddle the
    leading ``batch_ndim`` axes."""
    lead, body = lead_body(x.shape, batch_ndim)
    flat = x.reshape(lead, body)
    pad = (-body) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def from_blocks(y2d: torch.Tensor, shape, batch_ndim: int) -> torch.Tensor:
    """Inverse of :func:`to_blocks`: strip the per-lead padding and restore
    ``shape``."""
    lead, body = lead_body(shape, batch_ndim)
    return y2d.reshape(lead, -1)[:, :body].reshape(shape)


def tile_rows(side: torch.Tensor, rows: int) -> torch.Tensor:
    """A (rows, 1) sidecar: ``side`` as given, or the sidecar of one flat
    plane row repeated over the workers' rows."""
    if side.shape[0] == rows:
        return side
    if not side.shape[0] or rows % side.shape[0]:
        raise ValueError(f"a sidecar of {side.shape[0]} rows does not tile "
                         f"{rows} rows")
    return side.repeat(rows // side.shape[0], 1)


def padded_size(n: int, align: int) -> int:
    """``n`` rounded up to a multiple of ``align`` (elements)."""
    return n + (-n) % align


def round_through_bf16(x: torch.Tensor) -> torch.Tensor:
    """The nearest-bfloat16 value of float32 ``x`` (round half to even), as
    float32: how a flat plane, which holds 16-bit leaves in float32, keeps
    the exact bits a bfloat16 store would have produced."""
    return x.to(torch.bfloat16).float()

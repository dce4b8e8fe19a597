"""FlatSpace: the whole train state as a few contiguous, aligned fp32 planes.

The port's own copy of the JAX package's ``core/flatspace.py``, with the
same layout, so a flat train state crosses between the two packages as it
is (``repro_torch.convert``). At init every parameter-shaped tree (params,
B² accumulators, error-feedback residuals, gradient anchors) is packed into
ONE fp32 plane per state tensor:

  * **dtype-bucketed**: leaves are ordered so same-dtype leaves are
    contiguous (buckets by dtype name, stable within a bucket). The
    ``round16`` sidecars tell the flat kernels where the parameter and wire
    values round through bfloat16: an fp32 slot holds a bf16 value exactly,
    and re-rounding after every write keeps the plane bitwise equal to the
    per-leaf layout;
  * **aligned**: each leaf's slot is padded to ``ALIGN`` elements once, at
    pack time, so every slot row starts 16-byte aligned and no
    quantization block straddles two leaves;
  * **cheap to view**: :meth:`FlatSpace.unpack` is a slice + reshape (+ cast
    for 16-bit slots) per leaf, so the model consumes ordinary trees while
    the update and the sync round run over the plane.

A flat Local AdaAlter step is then one update launch over the plane
(``kernels.adaalter_update.flat_fused_update``) instead of one per leaf,
and a sync round one EF encode per half of the ``[params ‖ B²]`` payload
(``kernels.sync_fused.flat_ef_plane``) and one mean (:func:`mean_planes`)
instead of one per leaf. ``launch/steps.py`` routes both through here under
``OptimizerConfig.flat``.

Invariant the bitwise guarantees lean on: slot padding is zero and stays
zero. Gradients pack to zero pads, so the update writes
``0 − η·0·rsqrt(B² + t'·ε²) = 0`` back (ε > 0 keeps the rsqrt finite on
zero pads), and the sync encode turns zero blocks into zero wire and zero
residual.

Leaves are walked in ``repro_torch.tree.leaves`` order, which is
``jax.tree_util``'s. Geometry needs only shapes and dtypes: built from meta
tensors it costs no memory at any width.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm import worker_mean_
from repro_torch.kernels.tiling import padded_size
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map, unflatten_like

#: slot alignment: the JAX package's update-kernel tile (512 x 128), kept so
#: that the two packages lay out a plane the same way. A multiple of every
#: quantization block size in use (256), so the sync plane's block
#: partition matches the per-leaf one exactly.
ALIGN = 512 * 128

#: optimizer-state keys that are per-worker scalars, not param-shaped trees.
SCALAR_STATE_KEYS = ("step", "tprime")


def dtype_name(dtype: torch.dtype) -> str:
    """'bfloat16', 'float32', ...: the NumPy/JAX name the buckets sort by."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's home in the plane (offsets in elements, per batch row)."""

    index: int                 # position in the tree's leaf order
    shape: Tuple[int, ...]     # body shape (batch axes stripped)
    dtype: torch.dtype         # the leaf's dtype (what unpack restores)
    size: int                  # prod(shape)
    offset: int                # start element within the plane
    padded: int                # slot length (size rounded up to align)


class FlatSpace:
    """Geometry of one packed plane: the leaves of a tree whose leaves all
    carry the same ``batch_ndim`` leading (worker) axes. Every
    parameter-shaped plane (params, B², residuals, anchors) shares it; only
    the dtype :meth:`unpack` restores differs."""

    def __init__(self, template, slots: List[LeafSlot],
                 batch_shape: Tuple[int, ...], align: int,
                 shards: int = 1, eps: Optional[float] = None) -> None:
        if eps is not None and eps <= 0:
            raise ValueError(
                "FlatSpace requires eps > 0: zero slot padding only stays "
                "zero through the update because rsqrt(B² + t'·eps²) is "
                "finite on zero pads — with eps == 0 the pads would train "
                f"on garbage (got eps={eps!r})")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.template = template               # the tree, leaves None
        self.slots = slots                     # in PLANE order (dtype buckets)
        self.batch_shape = batch_shape
        self.batch_ndim = len(batch_shape)
        self.align = align
        self.shards = shards
        # tail padding only: slot offsets do not depend on the shard count,
        # and each of the ``shards`` sub-planes is a whole number of tiles
        end = (slots[-1].offset + slots[-1].padded) if slots else 0
        self.plane_size = padded_size(end, shards * align) if end else 0
        self.shard_size = self.plane_size // shards if shards else 0

    @classmethod
    def build(cls, tree, *, batch_ndim: int = 0, align: int = ALIGN,
              shards: int = 1, eps: Optional[float] = None) -> "FlatSpace":
        """Lay out ``tree``'s leaves (tensors of any device, meta included)
        into dtype buckets of aligned slots."""
        if align % 128:
            raise ValueError(f"align must be a multiple of 128, got {align}")
        leaves = tree_leaves(tree)
        if not leaves:
            raise ValueError("cannot build a FlatSpace over an empty tree")
        batch_shape = tuple(leaves[0].shape[:batch_ndim])
        order = sorted(range(len(leaves)),
                       key=lambda i: (dtype_name(leaves[i].dtype), i))
        slots: List[LeafSlot] = []
        offset = 0
        for i in order:
            leaf = leaves[i]
            if tuple(leaf.shape[:batch_ndim]) != batch_shape:
                raise ValueError(
                    f"leaf {i} batch axes {tuple(leaf.shape[:batch_ndim])} "
                    f"!= {batch_shape}")
            if not leaf.dtype.is_floating_point:
                raise ValueError(f"non-float leaf dtype {leaf.dtype} "
                                 "unsupported")
            body = tuple(leaf.shape[batch_ndim:])
            size = int(np.prod(body, dtype=np.int64)) if body else 1
            padded = padded_size(size, align)
            slots.append(LeafSlot(index=i, shape=body, dtype=leaf.dtype,
                                  size=size, offset=offset, padded=padded))
            offset += padded
        return cls(tree_map(lambda _: None, tree), slots, batch_shape, align,
                   shards=shards, eps=eps)

    # ------------------------------------------------------------------ #
    # pack / unpack
    # ------------------------------------------------------------------ #
    def pack(self, tree) -> torch.Tensor:
        """tree -> fp32 plane of shape ``batch_shape + (plane_size,)`` on the
        leaves' device, each slot's padding and the tail zero. A leaf may be
        an expanded view (e.g. one worker's weights broadcast over the
        workers): nothing but the plane is allocated."""
        leaves = tree_leaves(tree)
        if len(leaves) != len(self.slots):
            raise ValueError(f"tree has {len(leaves)} leaves, the plane "
                             f"{len(self.slots)}")
        plane = torch.zeros(self.batch_shape + (self.plane_size,),
                            dtype=torch.float32, device=leaves[0].device)
        for slot in self.slots:
            plane[..., slot.offset:slot.offset + slot.size].copy_(
                leaves[slot.index].reshape(self.batch_shape + (slot.size,)))
        return plane

    def unpack(self, plane: torch.Tensor, *,
               dtype: Optional[torch.dtype] = None):
        """plane -> tree of leaves: ``dtype=None`` restores each slot's dtype
        (params); a dtype (fp32 for the accumulator, residual and anchor
        planes) overrides it. Slots already in the asked dtype come back as
        views of the plane, writable into it."""
        flat: List[Any] = [None] * len(self.slots)
        for slot in self.slots:
            seg = plane[..., slot.offset:slot.offset + slot.size]
            flat[slot.index] = seg.reshape(self.batch_shape + slot.shape).to(
                dtype or slot.dtype)
        return unflatten_like(self.template, flat)

    # ------------------------------------------------------------------ #
    # shard views: each of the ``shards`` contiguous sub-planes
    # ------------------------------------------------------------------ #
    def shard_range(self, shard: int) -> Tuple[int, int]:
        """(start, stop) of sub-plane ``shard`` in plane elements."""
        if not 0 <= shard < self.shards:
            raise ValueError(f"shard {shard} of {self.shards}")
        return shard * self.shard_size, (shard + 1) * self.shard_size

    def shard_of(self, plane: torch.Tensor, shard: int) -> torch.Tensor:
        """Sub-plane ``shard`` of ``plane`` (its last axis), a new
        contiguous tensor (the rest of the plane can be freed)."""
        a, b = self.shard_range(shard)
        return plane[..., a:b].clone()

    def bucket_parts(self, shard: int) -> List[Tuple[str, int, int]]:
        """Where sub-plane ``shard`` meets the dtype buckets: (dtype_name,
        start, stop) plane ranges, in plane order. The tail past the last
        slot belongs to no bucket and is left out."""
        a, b = self.shard_range(shard)
        return [(name, max(a, lo), min(b, hi))
                for name, lo, hi in self.bucket_ranges()
                if lo < b and hi > a]

    def bucket_buffers(self, device) -> Dict[str, torch.Tensor]:
        """One uninitialised 1-D tensor a dtype bucket, in that dtype, for
        :meth:`unpack_buckets` (one batch row: a gathered worker)."""
        return {name: torch.empty(hi - lo, dtype=getattr(torch, name),
                                  device=device)
                for name, lo, hi in self.bucket_ranges()}

    def bucket_views(self, bufs: Dict[str, torch.Tensor],
                     shard: int) -> List[torch.Tensor]:
        """The parts of ``bufs`` that sub-plane ``shard`` fills, in the
        order of :meth:`bucket_parts`."""
        starts = {name: lo for name, lo, _ in self.bucket_ranges()}
        return [bufs[name][lo - starts[name]:hi - starts[name]]
                for name, lo, hi in self.bucket_parts(shard)]

    def shard_parts(self, sub: torch.Tensor,
                    shard: int) -> List[torch.Tensor]:
        """Sub-plane ``shard`` (``(plane_shard,)`` or one batch row) cut
        at the buckets and cast to each bucket's dtype: what it sends to
        fill :meth:`bucket_views`. Exact: a 16-bit slot of a params plane
        holds 16-bit values, and padding is zero."""
        a, _ = self.shard_range(shard)
        row = sub.reshape(-1)
        return [row[lo - a:hi - a].to(getattr(torch, name))
                for name, lo, hi in self.bucket_parts(shard)]

    def unpack_buckets(self, bufs: Dict[str, torch.Tensor]):
        """The params tree of one batch row as views of the bucket buffers
        (``bucket_buffers``, filled): what :meth:`unpack` of the whole plane
        gives, without a whole fp32 plane."""
        starts = {name: lo for name, lo, _ in self.bucket_ranges()}
        flat: List[Any] = [None] * len(self.slots)
        for slot in self.slots:
            name = dtype_name(slot.dtype)
            lo = slot.offset - starts[name]
            flat[slot.index] = bufs[name][lo:lo + slot.size].reshape(
                (1,) + slot.shape)
        return unflatten_like(self.template, flat)

    # ------------------------------------------------------------------ #
    # sidecars for the flat kernels (numpy, built once)
    # ------------------------------------------------------------------ #
    def _is16(self, slot: LeafSlot) -> bool:
        return slot.dtype.itemsize == 2

    def round16_elems(self, shard: Optional[int] = None) -> np.ndarray:
        """(plane_size,) bool: True where the slot's dtype is 16-bit — the
        elements whose parameter and wire writes round through bfloat16.
        With ``shard``: sub-plane ``shard``'s (plane_shard,) part."""
        mask = np.zeros(self.plane_size, np.bool_)
        for a, b in self.round16_ranges():
            mask[a:b] = True
        if shard is None:
            return mask
        a, b = self.shard_range(shard)
        return mask[a:b].copy()

    def round16_ranges(self, shard: Optional[int] = None
                       ) -> List[Tuple[int, int]]:
        """The (start, stop) ranges of :meth:`round16_elems`, merged; with
        ``shard``, those inside sub-plane ``shard``, relative to its
        start."""
        out: List[Tuple[int, int]] = []
        for slot in self.slots:
            if not self._is16(slot):
                continue
            if out and out[-1][1] == slot.offset:
                out[-1] = (out[-1][0], slot.offset + slot.padded)
            else:
                out.append((slot.offset, slot.offset + slot.padded))
        if shard is None:
            return out
        a, b = self.shard_range(shard)
        return [(max(lo, a) - a, min(hi, b) - a) for lo, hi in out
                if lo < b and hi > a]

    def round16_rows(self, row: int, shard: Optional[int] = None
                     ) -> np.ndarray:
        """``rows_sidecar(round16_elems(), row)`` built from the slots,
        without the plane-sized mask; with ``shard``, sub-plane
        ``shard``'s rows (its kernels' sidecar)."""
        if self.align % row:
            raise ValueError(f"row {row} must divide the alignment "
                             f"{self.align}")
        side = np.zeros((self.plane_size // row, 1), np.float32)
        for a, b in self.round16_ranges():
            side[a // row:b // row] = 1.0
        if shard is None:
            return side
        a, b = self.shard_range(shard)
        return side[a // row:b // row].copy()

    @staticmethod
    def rows_sidecar(elems: np.ndarray, row: int) -> np.ndarray:
        """Per-row (n_rows, 1) fp32 sidecar from a per-element mask; every
        ``row``-element run must be constant (slot alignment guarantees it
        when ``row`` divides ``align``)."""
        rows = elems.reshape(-1, row)
        if not (rows == rows[:, :1]).all():
            raise ValueError("mask not constant per row")
        return rows[:, :1].astype(np.float32)

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #
    @property
    def n_leaves(self) -> int:
        return len(self.slots)

    @property
    def n_real(self) -> int:
        return sum(s.size for s in self.slots)

    @property
    def pad_elems(self) -> int:
        """Padding paid once by the plane."""
        return self.plane_size - self.n_real

    def bucket_ranges(self) -> List[Tuple[str, int, int]]:
        """Contiguous (dtype_name, start, stop) plane ranges, one per dtype
        bucket."""
        out: List[Tuple[str, int, int]] = []
        for slot in self.slots:
            name = dtype_name(slot.dtype)
            if out and out[-1][0] == name and out[-1][2] == slot.offset:
                out[-1] = (name, out[-1][1], slot.offset + slot.padded)
            else:
                out.append((name, slot.offset, slot.offset + slot.padded))
        return out


# --------------------------------------------------------------------------- #
# whole-train-state conversion
# --------------------------------------------------------------------------- #
def pack_opt_state(fs: FlatSpace, state: Dict[str, Any]) -> Dict[str, Any]:
    """Per-leaf optimizer state -> flat: every param-shaped subtree
    (b2_sync, b2_local, res_*, g_anchor) becomes one fp32 plane; the
    per-worker scalar counters pass through."""
    return {k: (v if k in SCALAR_STATE_KEYS else fs.pack(v))
            for k, v in state.items()}


def unpack_opt_state(fs: FlatSpace, flat_state: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """Inverse of :func:`pack_opt_state`: planes -> fp32 per-leaf subtrees
    (views of the planes)."""
    return {k: (v if k in SCALAR_STATE_KEYS
                else fs.unpack(v, dtype=torch.float32))
            for k, v in flat_state.items()}


def adapt_flat_state(plane, flat_state: Dict[str, Any], *,
                     workers: int, plane_size: int):
    """Reshard a restored flat train state (NumPy arrays) across worker and
    shard counts. The plane is tail-pad-only, so a state written under one
    shard count fits another by padding or truncating the trailing zero
    tail. Worker-count changes replicate rows (grow) or merge row groups
    (shrink: identical rows pass through exactly, diverged rows take the
    fp32 mean). Scalar counters replicate on grow and take the group head
    on shrink."""
    def _cols(a):
        have = a.shape[-1]
        if have == plane_size:
            return a
        if have < plane_size:
            return np.pad(a, [(0, 0)] * (a.ndim - 1) +
                          [(0, plane_size - have)])
        if np.any(a[..., plane_size:]):
            raise ValueError(
                f"cannot truncate flat plane {have} -> {plane_size}: "
                "dropped tail is not all-zero (checkpoint was written by an "
                "incompatible slot layout, not just a larger shard pad)")
        return np.ascontiguousarray(a[..., :plane_size])

    def _rows(a, scalar):
        have = a.shape[0]
        if have == workers:
            return a
        if workers % have == 0:
            return np.repeat(a, workers // have, axis=0)
        if have % workers == 0:
            g = a.reshape((workers, have // workers) + a.shape[1:])
            if scalar or bool((g == g[:, :1]).all()):
                return np.ascontiguousarray(g[:, 0])
            return g.mean(axis=1).astype(a.dtype)
        raise ValueError(
            f"cannot reshard {have} checkpointed workers onto {workers}: "
            "one count must divide the other")

    plane = _rows(_cols(np.asarray(plane)), scalar=False)
    state = {}
    for k, v in flat_state.items():
        v = np.asarray(v)
        if k in SCALAR_STATE_KEYS:
            state[k] = _rows(v, scalar=True)
        else:
            state[k] = _rows(_cols(v), scalar=False)
    return plane, state


def is_flat_checkpoint(keys) -> bool:
    """Whether a checkpoint's flat leaf keys describe the packed-plane
    layout: params are ONE array (bare '#0' key) instead of a subtree."""
    return any(k == "#0" for k in keys)


# --------------------------------------------------------------------------- #
# the single sync mean
# --------------------------------------------------------------------------- #
def mean_planes(plane: torch.Tensor, round16=()) -> torch.Tensor:
    """Cross-worker mean of one wire plane, written in place, bitwise equal
    to the per-leaf means: the same fp32 worker mean
    (``core.comm.worker_mean_``), with the 16-bit slots' ranges
    (``FlatSpace.round16_ranges``) rounded through bfloat16, which is what
    the per-leaf bf16 mean stores."""
    return worker_mean_(plane, round16)

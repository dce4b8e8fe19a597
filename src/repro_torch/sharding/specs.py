"""Per-leaf sharding specs, and the layouts of a grid of ranks.

The JAX package's ``sharding/specs.py`` maps every parameter leaf, by its
path in the parameter tree, to logical axes (:func:`logical_for_leaf`),
resolves them through ``ShardingRules`` and drops the grid axes that do
not divide a dimension (:func:`shape_safe_spec`). The port computes the
same specs over the grid's shape: one spec per leaf, a tuple of grid-axis
entries (None, an axis name, or a tuple of names) per dimension, the
reference's ``PartitionSpec`` as a tuple. :class:`LeafSplit` is the
port's own piece: which dimension of a leaf a spec splits over which
ranks, into how many parts, which part a rank holds (``take``), and where
each rank's part lies in the whole leaf (``part``, which a gather writes).
Where a spec splits two dimensions, one over ``model`` and one over the
FSDP axes, a rank holds a *tile* (:class:`TileSplit`): the FSDP part of
its tensor-parallel part (:func:`tile_parts`).

:class:`GridLayout` describes the grid of ranks: on ``(data, model)``
rank r is ``r // S`` along ``data`` and ``r % S`` along ``model``, the
row-major device order of the reference's ``(R, S)`` mesh, and on
``(pod, data, model)`` the reference's production mesh, pod-major. The
ranks that differ only along some axes form a sub-group
(:meth:`GridLayout.groups_along`): along the first axis the worker
sub-groups (the sync mean's: ``data``'s, or ``pod``'s where the pods are
the workers), along the rest a worker's ranks (a sharded flat plane's
params gather), along ``data`` alone the FSDP sub-groups and along
``model`` alone tensor parallelism's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.sharding.partition import (Entry, ShardingRules,
                                            plane_shard_axes)

Spec = Tuple[Entry, ...]

_STACKED_ROOTS = ("blocks", "encoder")

#: the grid axis tensor parallelism splits weights over
TP_AXIS = "model"

_BY_NAME = {
    "embed": ("vocab", "embed_fsdp"),
    "lm_head": ("embed_fsdp", "vocab"),
    "head_w": ("embed_fsdp", "vocab"),
    "head_b": ("vocab",),
    "wq": ("embed_fsdp", "q_heads"),
    "wk": ("embed_fsdp", "q_heads"),
    "wv": ("embed_fsdp", "q_heads"),
    "wo": ("q_heads", "embed_fsdp"),
    "bq": ("q_heads",),
    "bk": ("q_heads",),
    "bv": ("q_heads",),
    "in_proj": ("embed_fsdp", "ssm_inner"),
    "conv_w": (None, "ssm_inner"),
    "out_proj": ("ssm_inner", "embed_fsdp"),
    "norm": ("ssm_inner",),
    "router": ("embed_fsdp", None),
    "wx": ("embed_fsdp", "lstm_hidden"),
    "wh": ("embed_fsdp", "lstm_hidden"),
    "b": ("lstm_hidden",),
    "wp": ("lstm_hidden", "embed_fsdp"),
}


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def logical_for_leaf(names: Sequence[str], shape: Sequence[int], *,
                     skip_leading: int = 0) -> Tuple[Optional[str], ...]:
    """Logical axes of the parameter leaf at path ``names`` (dict keys, and
    list indices as ``"[i]"``: ``repro_torch.tree.paths``) of ``shape``,
    without its ``skip_leading`` leading axes (a stacked worker axis)."""
    name = names[-1]
    in_moe = "moe" in names
    stacked = names[0] in _STACKED_ROOTS
    if name in ("w1", "w3"):
        log = (("experts", "embed_fsdp", "mlp") if in_moe
               else ("embed_fsdp", "mlp"))
    elif name == "w2":
        log = (("experts", "mlp", "embed_fsdp") if in_moe
               else ("mlp", "embed_fsdp"))
    elif name in _BY_NAME:
        log = _BY_NAME[name]
    else:
        log = ()                                  # norms, gates, scalars
    body = len(shape) - skip_leading - (1 if stacked else 0)
    log = tuple(log)[:body]
    log = (None,) * (body - len(log)) + log
    return ((None,) + log) if stacked else log


def shape_safe_spec(shape: Sequence[int], spec: Spec,
                    grid: Mapping[str, int]) -> Spec:
    """``spec`` without the grid axes whose product does not divide their
    dimension (kept in order while the running product divides it)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        kept, prod = [], 1
        for a in _axes(entry):
            if dim % (prod * grid[a]) == 0:
                kept.append(a)
                prod *= grid[a]
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept
                                                      else None))
    return tuple(out)


def _worker_entry(plan) -> Entry:
    w = tuple(plan.local_axes)
    return (w if len(w) > 1 else w[0]) if w else None


def param_shardings(rules: ShardingRules, params, *,
                    with_workers: bool = False) -> List[Spec]:
    """The spec of every leaf of ``params``, in ``tree.leaves`` order.
    ``with_workers``: every leaf carries a leading worker axis, split over
    the plan's ``local_axes``."""
    from repro_torch.tree import leaves, paths
    out = []
    for names, leaf in zip(paths(params), leaves(params)):
        shape = tuple(leaf.shape)
        skip = 1 if with_workers else 0
        spec = shape_safe_spec(shape[skip:], rules.resolve(logical_for_leaf(
            names, shape, skip_leading=skip)), rules.grid)
        out.append(((_worker_entry(rules.plan),) + spec) if with_workers
                   else spec)
    return out


def _copy(part):
    """A contiguous copy of ``part`` (a view of a whole leaf)."""
    return part.clone() if part.is_contiguous() else part.contiguous()


@dataclasses.dataclass(frozen=True)
class LeafSplit:
    """A leaf of ``shape`` split along ``dim`` into ``parts`` equal
    contiguous parts over the grid axes ``axes``; this rank holds part
    ``index``. ``dim`` None: every rank holds the whole leaf."""
    shape: Tuple[int, ...]
    dim: Optional[int] = None
    parts: int = 1
    index: int = 0
    axes: Tuple[str, ...] = ()

    @property
    def split(self) -> bool:
        return self.parts > 1

    @property
    def part_shape(self) -> Tuple[int, ...]:
        if not self.split:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.parts
        return tuple(s)

    @property
    def part_numel(self) -> int:
        return math.prod(self.part_shape)

    def part(self, whole, index: Optional[int] = None):
        """Part ``index`` (default: this rank's) of the whole leaf: a view
        (``whole`` itself unsplit)."""
        if not self.split:
            return whole
        n = self.shape[self.dim] // self.parts
        i = self.index if index is None else index
        return whole.narrow(self.dim, i * n, n)

    def take(self, whole):
        """This rank's part of the whole leaf, a new contiguous tensor
        that holds no reference to ``whole`` (which can then be freed);
        ``whole`` itself unsplit."""
        return _copy(self.part(whole)) if self.split else whole

    def whole_blocks(self, block: int) -> bool:
        """Whether every ``block``-element block of the leaf's row-major
        order lies in one part: each part's runs in that order are a
        multiple of ``block`` long (always, unsplit)."""
        if not self.split:
            return True
        run = (self.shape[self.dim] // self.parts) * math.prod(
            self.shape[self.dim + 1:])
        return run % block == 0


@dataclasses.dataclass(frozen=True)
class TileSplit:
    """A leaf split along two dimensions: ``tp`` (a :class:`LeafSplit` of
    the whole leaf over ``model``: this rank's tensor-parallel part) and
    ``fsdp`` (a :class:`LeafSplit` of that part over the FSDP axes); this
    rank holds ``fsdp``'s part of ``tp``'s part, its *tile*. The same
    interface as :class:`LeafSplit` for this rank's tile."""
    tp: LeafSplit
    fsdp: LeafSplit

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.tp.shape

    @property
    def split(self) -> bool:
        return True

    @property
    def axes(self) -> Tuple[str, ...]:
        return self.tp.axes + self.fsdp.axes

    @property
    def part_shape(self) -> Tuple[int, ...]:
        return self.fsdp.part_shape

    @property
    def part_numel(self) -> int:
        return self.fsdp.part_numel

    def part(self, whole, index=None):
        """This rank's tile of the whole leaf, a view (``index``, a
        ``(tp index, fsdp index)`` pair, another rank's)."""
        t, f = (None, None) if index is None else index
        return self.fsdp.part(self.tp.part(whole, t), f)

    def take(self, whole):
        return _copy(self.part(whole))

    def whole_blocks(self, block: int) -> bool:
        """Whether every ``block``-element block of the whole leaf's
        row-major order lies in one tile: the runs a tile holds in that
        order (its innermost split dimension's part, times the dimensions
        after it) are a multiple of ``block`` long."""
        inner = max(self.tp.dim, self.fsdp.dim)
        size = (self.fsdp.part_shape[inner] if inner == self.fsdp.dim
                else self.tp.part_shape[inner])
        return (size * math.prod(self.shape[inner + 1:])) % block == 0


def leaf_split(shape: Sequence[int], spec: Spec, grid: Mapping[str, int],
               coords: Mapping[str, int]):
    """The split of a leaf of ``shape`` under ``spec`` (shape safe) on
    ``grid``, for the rank at ``coords`` (its index along each axis): a
    :class:`LeafSplit` where the spec splits one dimension (over one or
    several axes) or none, a :class:`TileSplit` where it splits two, one
    over ``model`` (tensor parallelism) and one over the other axes
    (FSDP). Axes of size 1 split nothing."""
    shape = tuple(int(n) for n in shape)
    found = []
    for d, entry in enumerate(spec):
        axes = tuple(a for a in _axes(entry) if grid[a] > 1)
        if not axes:
            continue
        parts = math.prod(grid[a] for a in axes)
        index = 0
        for a in axes:                  # row-major over the entry's axes
            index = index * grid[a] + coords[a]
        found.append(LeafSplit(shape, d, parts, index, axes))
    if not found:
        return LeafSplit(shape)
    if len(found) == 1:
        return found[0]
    tp = [s for s in found if TP_AXIS in s.axes]
    if len(found) > 2 or len(tp) != 1 or tp[0].axes != (TP_AXIS,):
        raise ValueError(f"a leaf of shape {shape} split along "
                         f"{len(found)} dimensions ({spec}): a tile splits "
                         f"one over {TP_AXIS!r} and one over the others")
    other = next(s for s in found if s is not tp[0])
    return TileSplit(tp[0], dataclasses.replace(
        other, shape=tp[0].part_shape))


def tile_parts(split, grid: Optional[Mapping[str, int]] = None
               ) -> Tuple[LeafSplit, LeafSplit]:
    """``(tp, fsdp)`` of a rank's split of a whole leaf on ``grid`` (a
    :class:`LeafSplit` or :class:`TileSplit`): ``tp`` splits the whole
    leaf over ``model`` (this rank's tensor-parallel part, the part the
    layers take), ``fsdp`` that part over the other axes (the part this
    rank holds of it). A dimension over ``model`` and other axes at once
    (``("model", "data")``, 2-D experts) is a part over ``model`` split
    again along the same dimension (``grid`` gives ``model``'s size)."""
    if isinstance(split, TileSplit):
        return split.tp, split.fsdp
    if not split.split or TP_AXIS not in split.axes:
        return LeafSplit(split.shape), split
    if split.axes == (TP_AXIS,):
        return split, LeafSplit(split.part_shape)
    if split.axes[0] != TP_AXIS:
        raise ValueError(f"a dimension split over {split.axes}: the "
                         f"{TP_AXIS!r} part must come first")
    inner = split.parts // grid[TP_AXIS]
    tp = LeafSplit(split.shape, split.dim, grid[TP_AXIS],
                   split.index // inner, (TP_AXIS,))
    return tp, LeafSplit(tp.part_shape, split.dim, inner,
                         split.index % inner, split.axes[1:])


def plane_shard_count(grid: Mapping[str, int], plan) -> int:
    """How many tile-aligned sub-planes the flat plane splits into."""
    n = 1
    for a in plane_shard_axes(grid, plan):
        n *= grid[a]
    return n


#: the grid axes in the order a grid lays them out (the reference's
#: ``(pod, data, model)`` production mesh)
GRID_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True, init=False)
class GridLayout:
    """Ranks laid out row-major along the grid axes ``axes`` with sizes
    ``sizes``: ``GridLayout(R, S)`` is the reference's ``("data",
    "model")`` mesh of R × S, ``GridLayout(P, D, M)`` its ``("pod",
    "data", "model")`` mesh, pod-major, so that rank r holds the part the
    reference's ``P(("pod", "data"), ...)`` gives it. The first axis
    indexes the *workers* (``data`` on two axes, ``pod`` on three), the
    rest a worker's *shards*: rank r is worker ``r // shards`` and shard
    ``r % shards``."""
    sizes: Tuple[int, ...]
    axes: Tuple[str, ...]

    def __init__(self, *sizes: int, axes: Optional[Sequence[str]] = None):
        sizes = tuple(int(n) for n in sizes)
        axes = tuple(axes) if axes is not None else GRID_AXES[-len(sizes):]
        if len(axes) != len(sizes) or not 2 <= len(sizes) <= 3:
            raise ValueError(f"a grid of {sizes} along {axes}")
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "axes", axes)

    @classmethod
    def of(cls, grid: Mapping[str, int]) -> "GridLayout":
        """The layout of a grid given as the reference's mesh shape
        (``{"data": R, "model": S}``, or with ``"pod"``)."""
        unknown = set(grid) - set(GRID_AXES)
        if unknown:
            raise ValueError(f"the grid has no axes {sorted(unknown)}")
        axes = tuple(a for a in GRID_AXES if a in grid or a != "pod")
        return cls(*(grid.get(a, 1) for a in axes), axes=axes)

    @property
    def workers(self) -> int:
        return self.sizes[0]

    @property
    def shards(self) -> int:
        return math.prod(self.sizes[1:])

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    @property
    def shape(self) -> Dict[str, int]:
        """The grid's shape as the reference's mesh shape."""
        return dict(zip(self.axes, self.sizes))

    def coords(self, rank: int) -> Tuple[int, int]:
        """(worker, shard) of ``rank``."""
        return divmod(rank, self.shards)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """``rank``'s index along each axis."""
        out = {}
        for a, n in zip(self.axes[::-1], self.sizes[::-1]):
            rank, out[a] = divmod(rank, n)
        return {a: out[a] for a in self.axes}

    def rank(self, worker: int, shard: int) -> int:
        return worker * self.shards + shard

    def groups_along(self, axes: Sequence[str]) -> List[List[int]]:
        """The ranks that differ only along ``axes``: one list a
        combination of the other axes' indices (row-major), each in
        row-major order of ``axes``."""
        unknown = set(axes) - set(self.axes)
        if unknown:
            raise ValueError(f"the grid has no axes {sorted(unknown)}")
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(self.world):
            c = self.coords_of(r)
            key = tuple(c[a] for a in self.axes if a not in axes)
            groups.setdefault(key, []).append(r)
        return [groups[k] for k in sorted(groups)]

    def index_along(self, rank: int, axes: Sequence[str]) -> Tuple[int, int]:
        """(index, count) of ``rank`` among the ranks of its sub-group
        along ``axes``."""
        group = next(g for g in self.groups_along(axes) if rank in g)
        return group.index(rank), len(group)

    def worker_groups(self) -> List[List[int]]:
        """Per shard index, the ranks holding it: each sync mean's ranks."""
        return self.groups_along(self.axes[:1])

    def shard_groups(self) -> List[List[int]]:
        """Per worker, its ranks in shard order: each params gather's."""
        return self.groups_along(self.axes[1:])


def plane_shardings(grid: Mapping[str, int], plan) -> Tuple[GridLayout,
                                                            Tuple[str, ...]]:
    """The planes' layout over ``grid`` under ``plan``: ``(GridLayout,
    shard_axes)``. The workers are the product of the plan's
    ``local_axes``, the shards that of the shard axes; ``shard_axes == ()``
    is the replicated plane, one rank a worker."""
    shard_axes = plane_shard_axes(grid, plan)
    workers = 1
    for a in plan.local_axes:
        workers *= grid.get(a, 1)
    return GridLayout(workers, plane_shard_count(grid, plan)), shard_axes

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

:class:`GridLayout` describes the grid of ranks: rank r is ``r // S``
along ``data`` and ``r % S`` along ``model``, the row-major device order
of the reference's ``(R, S)`` mesh; the ranks that differ only along some
axes form a sub-group (:meth:`GridLayout.groups_along`): along ``data``
the worker sub-groups (the sync mean's, or a synchronous plan's FSDP
sub-group), along ``model`` the shard sub-groups (a sharded flat plane's
params gather).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.sharding.partition import (Entry, ShardingRules,
                                            plane_shard_axes)

Spec = Tuple[Entry, ...]

_STACKED_ROOTS = ("blocks", "encoder")

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
        """This rank's part of the whole leaf, contiguous (``whole``
        itself unsplit)."""
        return self.part(whole).contiguous() if self.split else whole

    def whole_blocks(self, block: int) -> bool:
        """Whether every ``block``-element block of the leaf's row-major
        order lies in one part: each part's runs in that order are a
        multiple of ``block`` long (always, unsplit)."""
        if not self.split:
            return True
        run = (self.shape[self.dim] // self.parts) * math.prod(
            self.shape[self.dim + 1:])
        return run % block == 0


def leaf_split(shape: Sequence[int], spec: Spec, grid: Mapping[str, int],
               coords: Mapping[str, int]) -> LeafSplit:
    """The :class:`LeafSplit` of a leaf of ``shape`` under ``spec`` (shape
    safe) on ``grid``, for the rank at ``coords`` (its index along each
    axis). Axes of size 1 split nothing. More than one split dimension is
    tensor parallelism beside FSDP, which the port does not build (ROADMAP
    Queue 1 item 9c-2b): NotImplementedError."""
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
    if len(found) > 1:
        raise NotImplementedError(
            f"a leaf of shape {shape} split along {len(found)} dimensions "
            f"({spec}): tensor parallelism beside FSDP is not ported yet "
            "(ROADMAP Queue 1 item 9c-2b)")
    return found[0] if found else LeafSplit(shape)


def plane_shard_count(grid: Mapping[str, int], plan) -> int:
    """How many tile-aligned sub-planes the flat plane splits into."""
    n = 1
    for a in plane_shard_axes(grid, plan):
        n *= grid[a]
    return n


@dataclasses.dataclass(frozen=True)
class GridLayout:
    """``workers`` × ``shards`` ranks, row-major, along the grid axes
    ``axes`` (``("data", "model")``, the reference's mesh axes): rank r is
    ``r // shards`` along the first and ``r % shards`` along the second."""
    workers: int
    shards: int
    axes: Tuple[str, str] = ("data", "model")

    @property
    def world(self) -> int:
        return self.workers * self.shards

    @property
    def shape(self) -> Dict[str, int]:
        """The grid's shape as the reference's mesh shape."""
        return dict(zip(self.axes, (self.workers, self.shards)))

    def coords(self, rank: int) -> Tuple[int, int]:
        """(worker, shard) of ``rank``."""
        return divmod(rank, self.shards)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """``rank``'s index along each axis."""
        return dict(zip(self.axes, self.coords(rank)))

    def rank(self, worker: int, shard: int) -> int:
        return worker * self.shards + shard

    def groups_along(self, axes: Sequence[str]) -> List[List[int]]:
        """The ranks that differ only along ``axes``: one list a
        combination of the other axes' indices (row-major), each in
        row-major order of ``axes``."""
        sizes = self.shape
        unknown = set(axes) - set(sizes)
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

"""The flat plane's layout over a grid of ranks.

The JAX package's ``sharding/specs.py`` describes each plane with a
``NamedSharding``: the worker (``local_axes``) axes on its leading axis,
the shard axes (:func:`~repro_torch.sharding.partition.plane_shard_axes`)
on its element axis. Over ranks the same layout is a description of the
grid (:class:`GridLayout`): rank r is worker ``r // S`` and shard ``r %
S``, the row-major device order of the reference's ``(R, S)`` mesh; the
ranks of one shard index form a *worker sub-group* (the sync mean), the
ranks of one worker a *shard sub-group* (the params gather). The per-leaf
specs (``param_shardings``, ``opt_state_shardings``, ``logical_for_leaf``)
go with FSDP (ROADMAP Queue 1 item 9b).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Tuple

from repro_torch.sharding.partition import plane_shard_axes


def plane_shard_count(grid: Mapping[str, int], plan) -> int:
    """How many tile-aligned sub-planes the flat plane splits into."""
    n = 1
    for a in plane_shard_axes(grid, plan):
        n *= grid[a]
    return n


@dataclasses.dataclass(frozen=True)
class GridLayout:
    """``workers`` × ``shards`` ranks, row-major: rank r holds shard
    ``r % shards`` of worker ``r // shards``'s planes."""
    workers: int
    shards: int

    @property
    def world(self) -> int:
        return self.workers * self.shards

    def coords(self, rank: int) -> Tuple[int, int]:
        """(worker, shard) of ``rank``."""
        return divmod(rank, self.shards)

    def rank(self, worker: int, shard: int) -> int:
        return worker * self.shards + shard

    def worker_groups(self) -> List[List[int]]:
        """Per shard index, the ranks holding it: each sync mean's ranks."""
        return [[self.rank(w, s) for w in range(self.workers)]
                for s in range(self.shards)]

    def shard_groups(self) -> List[List[int]]:
        """Per worker, its ranks in shard order: each params gather's."""
        return [[self.rank(w, s) for s in range(self.shards)]
                for w in range(self.workers)]


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

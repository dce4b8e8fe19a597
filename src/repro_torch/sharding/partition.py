"""The flat plane's shard axes over a grid of ranks.

The JAX package's ``sharding/partition.py`` maps logical axis names to
mesh axes (``ShardingRules``) for its GSPMD annotations; the port runs no
GSPMD, and what it shards is the flat plane, down :func:`plane_shard_axes`
over the grid's shape (``{"data": R, "model": S}``, the reference's mesh
shape). The logical-axis rules come with FSDP and tensor parallelism
(ROADMAP Queue 1 items 9b and 9c).
"""
from __future__ import annotations

from typing import Mapping, Tuple


def plane_shard_axes(grid: Mapping[str, int], plan) -> Tuple[str, ...]:
    """Grid axes the flat parameter plane splits its element axis over:
    the plan's FSDP axes, then its tensor-parallel axis, without the worker
    (``local_axes``) axes, which split the plane's leading axis, and
    without axes the grid lacks or holds at size 1. Empty: a replicated
    plane."""
    local = set(plan.local_axes)
    cand = tuple(plan.fsdp_axes)
    if getattr(plan, "tp_axis", ""):
        cand = cand + (plan.tp_axis,)
    out, seen = [], set()
    for a in cand:
        if (a and grid.get(a, 1) > 1 and a not in local and a not in seen):
            out.append(a)
            seen.add(a)
    return tuple(out)

"""Logical-axis sharding rules over a grid of ranks, and the flat plane's
shard axes.

The JAX package's ``sharding/partition.py`` maps the *logical* axis names
its models and parameter specs use to mesh axes (:class:`ShardingRules`),
and GSPMD partitions the program from those annotations. The port resolves
the same names to the same entries over the grid's shape (``{"data": R,
"model": S}``, the reference's mesh shape), and ``sharding/specs.py``
turns each parameter leaf's entries into the part of the leaf a rank
holds; the train steps then move the parts with explicit collectives
(``core/comm.py``). Nothing here partitions a program, so the reference's
``use_rules``/``constraint`` annotations have no counterpart: tensor
parallelism (:class:`TensorParallel`) reaches the layers as an argument,
never as a thread-local (autograd runs a CUDA backward, and with it
remat's recomputation, on a thread of its own), and the layers call the
collectives themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

#: one dimension's entry of a spec: unsplit, one grid axis, or several
Entry = Union[None, str, Tuple[str, ...]]

#: logical axis -> grid axis (the reference's table); ``__local__``,
#: ``__data__`` and ``__fsdp__`` resolve to the plan's ``local_axes``,
#: ``grad_axes`` and ``fsdp_axes``
DEFAULT_RULES: Dict[str, Optional[str]] = {
    # activations
    "workers": "__local__",
    "batch": "__data__",
    "seq": None,
    "seq_sp": None,             # residual-stream seq axis (model under SP)
    "embed": None,
    "q_heads": "model",
    "kv_heads": "model",
    "heads_tp": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "capacity": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_inner": "model",
    "frames": None,
    "image": None,
    # weights
    "embed_fsdp": "__fsdp__",   # embed dim of weights, ZeRO-sharded
    "lstm_hidden": "model",
}


def rule_overrides(cfg) -> Optional[Dict[str, Entry]]:
    """The config's changes to :data:`DEFAULT_RULES`, as the reference's
    ``build_train_programs`` makes them: sequence parallelism puts
    ``seq_sp`` on ``model``, 2-D experts put ``experts`` on (model,
    data)."""
    out: Dict[str, Entry] = {}
    if getattr(cfg, "seq_parallel", False):
        out["seq_sp"] = "model"
    if getattr(cfg, "expert_axes_2d", False):
        out["experts"] = ("model", "data")
    return out or None


class ShardingRules:
    """Logical names resolved to grid-axis entries under a plan.

    ``grid`` is the grid's shape (``{"data": R, "model": S}``), ``plan`` a
    ``configs.ParallelismPlan``, ``overrides`` changes to
    :data:`DEFAULT_RULES`."""

    def __init__(self, grid: Mapping[str, int], plan,
                 overrides: Optional[Dict[str, Entry]] = None) -> None:
        self.grid = dict(grid)
        self.plan = plan
        self.rules: Dict[str, Entry] = dict(DEFAULT_RULES)
        if overrides:
            self.rules.update(overrides)

    def resolve(self, logical: Sequence[Optional[str]]) -> Tuple[Entry, ...]:
        """One entry per logical name: the grid axes it maps to that the
        grid has and that no earlier name took (an axis splits one
        dimension at most), a single axis as its name, none as None."""
        axes, used = [], set()
        for name in logical:
            if name is None:
                axes.append(None)
                continue
            ax = self.rules.get(name, None)
            if ax == "__local__":
                ax = tuple(self.plan.local_axes) or None
            elif ax == "__data__":
                ax = tuple(self.plan.grad_axes) or None
            elif ax == "__fsdp__":
                ax = tuple(self.plan.fsdp_axes) or None
            if isinstance(ax, str):
                ax = (ax,)
            if ax:
                ax = tuple(a for a in ax if a in self.grid and a not in used)
                used.update(ax)
                axes.append(ax if len(ax) > 1 else ax[0] if ax else None)
            else:
                axes.append(None)
        return tuple(axes)


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


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """Tensor parallelism over the ``model`` axis: the layers' context.

    ``group`` is the ``model`` sub-group (a ``core.comm.RankGroup``:
    ``RankGroup.along(("model",))``, its ranks in ``model`` order), and
    ``rules`` the run's :class:`ShardingRules` (its grid and plan). A layer
    asks :meth:`split` how the spec splits a weight it holds, and moves
    its parts with ``core.comm.tp_copy`` / ``tp_sum`` / ``tp_gather`` over
    the group: shape-safety decides which leaf splits, never the layer.
    Under FSDP beside it (a leaf split over ``data`` too) the layers take
    the rank's tensor-parallel parts, gathered over ``data`` from its
    tiles: :meth:`split` is the split over ``model`` alone.
    ``sum_log`` (a ``core.comm.TPSumLog``) is set inside a group
    rematerialised under ``"save_tp"``. ``seq`` (sequence parallelism,
    set by ``models/transformer.py`` for a block's sub-layers) makes a
    sub-layer's output leave it as this rank's slice of the sequence
    (dimension 1): :meth:`out_sum` reduce-scatters a row-parallel output,
    :meth:`out_whole` cuts a whole one."""
    group: Any
    rules: ShardingRules
    sum_log: Any = None
    seq: bool = False

    @property
    def size(self) -> int:
        return self.group.world

    @property
    def rank(self) -> int:
        return self.group.rank

    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis, as far as a weight's split
        needs it (the weights split along ``model`` alone)."""
        return {a: (self.rank if a == "model" else 0) for a in self.rules.grid}

    def split(self, name: str, shape: Sequence[int],
              path: Sequence[str] = ()):
        """The ``sharding.specs.LeafSplit`` of an (unstacked) weight named
        ``name`` whose whole shape is ``shape``, as
        ``sharding.specs.param_shardings`` splits it; ``path``: the keys
        above it that its spec reads (``("moe",)`` for an expert weight,
        ``("moe", "shared")`` for the shared expert's)."""
        from repro_torch.sharding.specs import (leaf_split, logical_for_leaf,
                                                shape_safe_spec, tile_parts)
        spec = shape_safe_spec(shape, self.rules.resolve(
            logical_for_leaf(tuple(path) + (name,), shape)), self.rules.grid)
        return tile_parts(leaf_split(shape, spec, self.rules.grid,
                                     self.coords()), self.rules.grid)[0]

    def cache_split(self, shape: Sequence[int], dim: int):
        """The split of a cache entry of ``shape`` along its dimension
        ``dim`` over ``model`` (the reference's ``cache_shardings``, shape
        safe: a KV cache's sequence, the SSM state's heads, the conv
        tail's channels; the batch, split over ``data``, is this rank's
        already)."""
        from repro_torch.sharding.specs import leaf_split, shape_safe_spec
        spec = [None] * len(shape)
        spec[dim] = "model"
        spec = shape_safe_spec(shape, tuple(spec), self.rules.grid)
        return leaf_split(shape, spec, self.rules.grid, self.coords())

    def with_log(self, log) -> "TensorParallel":
        return dataclasses.replace(self, sum_log=log)

    def out_sum(self, y):
        """A row-parallel sub-layer output's partials summed over the
        ranks (``core.comm.tp_sum``), or under :attr:`seq` reduce-scattered
        along the sequence (``core.comm.sp_sum_scatter``: the same float32
        sum in rank order, this rank's slice)."""
        from repro_torch.core.comm import sp_sum_scatter, tp_sum
        if self.seq:
            return sp_sum_scatter(y, self.group, 1, self.sum_log)
        return tp_sum(y, self.group, self.sum_log)

    def out_whole(self, y):
        """A sub-layer output that is whole on every rank, or under
        :attr:`seq` this rank's slice of its sequence
        (``core.comm.sp_split``)."""
        if not self.seq:
            return y
        from repro_torch.core.comm import sp_split
        return sp_split(y, self.group, 1)

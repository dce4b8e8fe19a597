"""Serving programs: batched prefill + single-token decode with a cache.

The JAX package's ``launch/serving.py`` on one device. Shape semantics:

  * ``prefill_32k``  runs ``prefill`` — full forward over S tokens,
    returning last-position logits + primed caches.
  * ``decode_32k`` / ``long_500k`` run ``decode_step`` — ONE new token
    against a pre-allocated cache of ``cache_len`` entries.

The cache is what the model's ``init_cache`` lays out: stacked ``"kv"``
ring buffers (g, B, cache_len, KV, hd) for attention layers, the SSM state
for mamba2, and the Big LSTM's list of (h_proj, c) pairs.

On a ``group`` of ranks laid out as a ``{"data": D, "model": M}`` grid
(``launch/mesh.py``) the programs are the reference's sharded ones:
:func:`serve_plan` splits the batch over ``data`` and the weights over
``model`` (tensor parallelism, ``sharding.partition.TensorParallel``),
:func:`cache_shardings` splits the KV and cross caches' sequence, the
SSM state's heads and the conv tail's channels over ``model`` (shape
safe), and each rank runs on its parts (``param_parts``,
``cache_parts``) and its rows of the batch. The Big LSTM's state is split
over ``data`` and the same on every ``model`` rank. Above 20 B parameters
the plan's ``weight_gather_serving`` adds FSDP over ``data``: each rank
holds its tiles at rest (the ``data`` part of its ``model`` part of each
weight) and :class:`WeightGather` gathers a layer group's parts over
``data`` as the group runs, freeing them after it, in the prefill and in
each decode step. The programs run eagerly under
``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelismPlan, ShapeConfig
from repro_torch.models import build_model
from repro_torch.sharding.specs import (LeafSplit, Spec, leaf_split,
                                        shape_safe_spec, tile_parts)
from repro_torch.tree import leaves, paths, tree_map, unflatten_like

DEFAULT_LONG_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated (the counterpart of
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def cache_geometry(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[int, int, int]:
    """-> (cache_len, window, cross_len) for a decode shape."""
    window = 0
    cache_len = shape.seq_len
    if shape.seq_len > 65536:
        # long-context decode: bounded state required. SSM archs are O(1)
        # natively; others fall back to their sliding-window variant.
        if cfg.family not in ("ssm",):
            window = cfg.sliding_window or DEFAULT_LONG_WINDOW
            cache_len = window
    elif cfg.sliding_window and cfg.long_context_mode != "sliding_window":
        # architectural SWA (e.g. hymba): windowed at every context length
        window = cfg.sliding_window
        cache_len = min(cache_len, window)
    if cfg.family == "ssm":
        cache_len = 0                     # no attention cache at all
    cross_len = 0
    if cfg.cross_attn_every:
        cross_len = cfg.n_image_tokens
    if cfg.is_encdec:
        cross_len = min(shape.seq_len, 32768)   # encoder output length
    return cache_len, window, cross_len


def _data_axes(grid) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in grid)


def serve_plan(cfg: ModelConfig, grid: Dict[str, int]) -> ParallelismPlan:
    """The reference's serving plan on ``grid`` (its mesh shape): the batch
    over every non-model axis, tensor parallelism over ``model``, and
    above 20 B parameters FSDP over the batch axes with the weights
    gathered for serving."""
    dp = _data_axes(grid)
    big = cfg.param_count() > 20e9
    return ParallelismPlan(
        local_axes=(), grad_axes=dp, fsdp_axes=dp if big else (),
        weight_gather_serving=big, remat="none")


def cache_shardings(rules, cache_abstract, family: str) -> List[Spec]:
    """The reference's spec of every cache leaf (in ``tree.leaves``
    order), shape safe on ``rules.grid``: the batch over the data axes;
    a KV cache (g, B, L, KV, hd) also its sequence over ``model``; the SSM
    state its heads, its conv tail its channels; the LSTM state (B, H)
    the batch only."""
    grid = rules.grid
    dp = _data_axes(grid)
    b_entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    out = []
    for names, leaf in zip(paths(cache_abstract), leaves(cache_abstract)):
        nd = len(leaf.shape)
        # the entry's key: "kv", "xkv", "ssm" (tuples add an index)
        name = next((n for n in reversed(names) if not n.startswith("[")),
                    "")
        if family == "lstm":
            spec = (b_entry,) + (None,) * (nd - 1)
        elif name in ("kv", "xkv") and nd == 5:
            spec = (None, b_entry, "model", None, None)
        elif name == "ssm" and nd == 5:
            spec = (None, b_entry, "model", None, None)
        elif name == "ssm" and nd == 4:
            spec = (None, b_entry, None, "model")
        else:
            spec = ((None,) * nd if nd < 2
                    else (None, b_entry) + (None,) * (nd - 2))
        out.append(shape_safe_spec(tuple(leaf.shape), spec, grid))
    return out


def rank_parts(tree, specs, grid, coords):
    """This rank's part of every leaf of ``tree`` under ``specs`` (the
    rank at ``coords`` on ``grid``): ``sharding.specs.LeafSplit``s, one a
    leaf."""
    return [leaf_split(tuple(t.shape), sp, grid, coords)
            for t, sp in zip(leaves(tree), specs)]


def _batch_rows(grid, coords, batch: int) -> slice:
    """This rank's rows of a batch split over the data axes; every row
    where the ranks do not divide the batch (the reference's shape-safe
    spec then leaves the batch whole, as a single 500k-token sequence)."""
    n = 1
    idx = 0
    for a in _data_axes(grid):
        idx = idx * grid[a] + coords[a]
        n *= grid[a]
    if batch % n:
        return slice(0, batch)
    per = batch // n
    return slice(idx * per, (idx + 1) * per)


class WeightGather:
    """Serving with gathered weights: a rank's stored parts of the weights
    (``params``, its tiles) to the parts the layers take (its
    tensor-parallel parts; the whole weights without ``model``), gathered
    over the FSDP sub-group ``group`` as each is needed: a top-level
    weight (:meth:`leaf`), one layer group of a stack (:meth:`stack`,
    ``models/transformer.py``'s ctx ``"fetch"``), or every weight at once
    (:meth:`tree`). ``splits``: per leaf (``tree.leaves`` order of
    ``abstract``) the split of its tensor-parallel part over the FSDP
    sub-group. Counted in ``comm.shard_gather`` (a params gather)."""

    def __init__(self, abstract, splits, group) -> None:
        self.group = group
        self.splits = unflatten_like(abstract, list(splits))

    def _gather(self, xs, splits):
        from repro_torch.core import comm
        return self.group.gather_leaves(xs, splits, comm.shard_gather)

    def leaf(self, params, key):
        """``params[key]``, a leaf, as the layers take it."""
        return self._gather([params[key]], [self.splits[key]])[0]

    def stack(self, key):
        """The gather of one group of the stack ``params[key]`` (a group's
        weights, the stacked leaves indexed at one group)."""
        per_group = [LeafSplit(s.shape[1:], None if s.dim is None
                               else s.dim - 1, s.parts, s.index, s.axes)
                     for s in leaves(self.splits[key])]

        def fetch(gp):
            return unflatten_like(gp, self._gather(leaves(gp), per_group))
        return fetch

    def tree(self, params):
        """Every weight of ``params`` as the layers take it."""
        return unflatten_like(params, self._gather(leaves(params),
                                                   leaves(self.splits)))


@dataclasses.dataclass
class ServePrograms:
    init_fn: Any                  # (gen: torch.Generator) -> params
    prefill: Any                  # (params, batch) -> (logits, caches)
    decode_step: Any              # (params, caches, token, pos) -> (logits, caches)
    cache_len: int
    window: int
    cross_len: int
    # a group's programs: the grid and this rank's coordinates on it, the
    # splits of the params (tree.leaves order: LeafSplits, tiles under
    # weight_gather_serving), the decode cache's cache_shardings, and this
    # rank's batch rows
    grid: Any = None
    coords: Any = None
    param_splits: Any = None
    cache_specs: Any = None
    rows: Any = None

    def param_parts(self, params):
        """This rank's parts of a tree of whole parameters."""
        if self.param_splits is None:
            return params
        return unflatten_like(params, [
            s.take(t) for s, t in zip(self.param_splits, leaves(params))])

    def cache_parts(self, cache):
        """This rank's part of every leaf of a whole cache (its batch rows
        and, where split, its share of the sequence)."""
        if self.cache_specs is None:
            return cache
        return unflatten_like(cache, [
            spec_part(t, sp, self.grid, self.coords)
            for t, sp in zip(leaves(cache), self.cache_specs)])


def spec_part(t, spec, grid, coords):
    """The part of ``t`` that the rank at ``coords`` holds under ``spec``,
    along every dimension the spec splits (a cache splits two: the batch
    over ``data``, the sequence over ``model``)."""
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n, idx = 1, 0
        for a in axes:                        # row-major over the entry
            idx = idx * grid[a] + coords[a]
            n *= grid[a]
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, idx * size, size)
    return t


def build_serve_programs(cfg: ModelConfig, shape: ShapeConfig, group=None,
                         plan: ParallelismPlan = None) -> ServePrograms:
    """The model's programs for ``shape``; they run on the device of the
    tensors they are given (``init_fn`` on its generator's). With a
    ``group`` (a ``core.comm.RankGroup`` laid out as a ``{"data": D,
    "model": M}`` grid) the reference's sharded programs under ``plan``
    (default :func:`serve_plan`): ``init_fn`` returns this rank's parts,
    ``prefill`` and ``decode_step`` take this rank's parts of the weights
    and of the cache and its rows of the batch, and return the whole
    vocabulary's logits of those rows and the rank's cache parts. Under
    ``plan.weight_gather_serving`` a rank's parts of the weights are its
    tiles, gathered over the FSDP axes as each layer group runs
    (:class:`WeightGather`); the logits and caches are those of the same
    grid with the weights whole over ``data``, bit for bit."""
    model = build_model(cfg)
    cache_len, window, cross_len = cache_geometry(cfg, shape)
    tp = extra = None
    kw = {}
    if group is not None:
        from repro_torch.launch.mesh import check_serve_plan
        from repro_torch.sharding import ShardingRules, param_shardings
        from repro_torch.sharding.partition import (TensorParallel,
                                                    rule_overrides)
        grid = group.grid
        plan = plan or serve_plan(cfg, grid)
        check_serve_plan(cfg, plan, grid)
        rules = ShardingRules(grid, plan, rule_overrides(cfg))
        coords = group.layout.coords_of(group.rank)
        abstract = model.init(None, "meta")
        cache_abs = model.init_cache(shape.global_batch, max(cache_len, 1),
                                     windowed=bool(window),
                                     cross_len=cross_len, device="meta")
        extra = dict(grid=grid, coords=coords, param_splits=rank_parts(
            abstract, param_shardings(rules, abstract), grid, coords),
            cache_specs=cache_shardings(rules, cache_abs, cfg.family),
            rows=_batch_rows(grid, coords, shape.global_batch))
        mgroup = group.along(("model",))
        if mgroup is not None:
            tp = TensorParallel(mgroup, rules)
            kw = {"tp": tp}
        # weights split over the FSDP axes (the plan of weight_gather_
        # serving) are gathered as they run
        fgroup = group.along(plan.fsdp_axes)
        if fgroup is not None:
            kw["gather"] = WeightGather(
                abstract, [tile_parts(t, grid)[1]
                           for t in extra["param_splits"]], fgroup)
        # the ranks along data hold one batch's rows: the MoE routes them
        # as one, as the reference's one program over the global batch
        dgroup = group.along(_data_axes(grid))
        if dgroup is not None and extra["rows"].stop - extra[
                "rows"].start < shape.global_batch:
            kw["batch_group"] = dgroup

    @torch.inference_mode()
    def prefill_fn(params, batch):
        lens = {"cache_len": cache_len, "cross_len": cross_len} if tp else {}
        return model.prefill(params, batch, window=window, **lens, **kw)

    @torch.inference_mode()
    def decode_fn(params, caches, token, pos):
        return model.decode_step(params, caches, token, pos, window=window,
                                 cache_len=cache_len if tp else 0,
                                 cross_len=cross_len if tp else 0, **kw)

    programs = ServePrograms(init_fn=None, prefill=prefill_fn,
                             decode_step=decode_fn, cache_len=cache_len,
                             window=window, cross_len=cross_len,
                             **(extra or {}))

    @torch.inference_mode()
    def init_fn(gen):
        return programs.param_parts(model.init(gen))

    programs.init_fn = init_fn
    return programs


def serve_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """TensorSpecs of the prefill batch and the decode-step inputs."""
    B, S = shape.global_batch, shape.seq_len
    dtype = getattr(torch, cfg.param_dtype)
    prefill_batch = {"tokens": TensorSpec((B, S), torch.int32)}
    if cfg.cross_attn_every:
        prefill_batch["image_embeds"] = TensorSpec(
            (B, cfg.n_image_tokens, cfg.d_model), dtype)
    if cfg.is_encdec:
        prefill_batch["audio_frames"] = TensorSpec(
            (B, min(S, 32768), cfg.d_model), dtype)
    return {
        "prefill": prefill_batch,
        "token": TensorSpec((B, 1), torch.int32),
        "pos": TensorSpec((B,), torch.int32),
    }


def decode_cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """TensorSpecs of the decode cache (nothing allocated)."""
    model = build_model(cfg)
    cache_len, window, cross_len = cache_geometry(cfg, shape)
    meta = model.init_cache(shape.global_batch, max(cache_len, 1),
                            windowed=bool(window), cross_len=cross_len,
                            device="meta")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), meta)

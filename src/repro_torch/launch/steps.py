"""Train steps, R workers stacked on one device or one model.

Every family of ``models.build_model`` trains: a worker's loss is the
model's ``loss_fn`` (the cross-entropy plus the MoE load-balance loss),
its gradient autograd's. The SSD kernel has no backward, so a model with
``ssm_pallas`` cannot train; the plain chunked SSD trains, as in the JAX
package.

With a local optimizer (``local_sgd``, ``local_adaalter``) every parameter
and accumulator carries a leading worker axis R, as in the JAX package's
``launch/steps.py``; replicas diverge between syncs.

* ``local_step`` — H-1 out of H steps — moves nothing between workers;
* ``sync_step`` adds the params + accumulator average (Alg. 4 lines
  11-12): here a mean over axis 0, since the workers are stacked on one
  device, exactly as the reference stacks them on its worker axis.

With a ``group`` (``core.comm.RankGroup``: one worker a rank, the ranks of
a ``torchrun`` launch) each rank holds its own worker, a leading axis of 1,
so every kernel wrapper, ``FlatSpace`` and the checkpoint format keep their
shapes' meaning. The sync round's mean is then a collective
(:class:`RankMean`): every rank's wire all-gathered and summed in rank
order, the stacked mean's arithmetic, so R ranks give the stacked run of R
workers bit for bit. The int8 wire carries the codes and scales the EF
kernel writes beside its output, one collective per payload leaf (one per
round over the flat plane), and each rank dequantizes every contribution.
The per-step statistics (loss, drift, gradient norm) are reduced to one
scalar per worker first, then gathered and averaged, so every rank takes
the same schedule decisions.

Each worker's loss and gradient come from its own slice of the stacked
tensors and of the batch (tokens, labels, and the VLM's image embeddings
or the encoder-decoder's audio frames), one worker at a time, so peak
memory holds one worker's activations (at full Big LSTM width, its ~2 GB
of float32 logits).

With ``OptimizerConfig.use_kernels`` Local AdaAlter's update is the fused
CUDA kernel, one launch per stacked leaf (``kernels/ops.py``), and an int8
sync round is the one-pass EF kernel, one launch per payload leaf.
Without it the update is the optimizer's own ``local_step``.

With ``OptimizerConfig.flat`` (Local AdaAlter only) the params and the
optimizer state the steps exchange are FlatSpace planes
(``core/flatspace.py``): the update is one launch over the parameter plane
and the sync round one EF encode per half of the ``[params ‖ B²]`` payload
and one mean per half. Given the same schedule the train state is bitwise
equal to the per-leaf layout's.

With a synchronous optimizer (``sgd``, ``adagrad``, ``adaalter``: the
paper's Algorithms 1 and 3, its baselines), or a local one under a plan
without worker axes (the reference's one-model branch, the plans above
20 B parameters), one model takes the whole global batch
(:func:`_leaf_programs`): ``opt.update(grads, g∘g, ...)`` every step, or
``opt.local_step`` every step and the identity-mean sync (the EF encode
of a lossy wire) on the policy's sync steps, as the reference's
non-local branch does. On one device there is no all-reduce;
``train_loop`` charges the bytes it would move. With a ``group`` each rank
takes its share of the global batch, split over ``grad_axes``, and holds
each parameter leaf and its state as the plan's per-leaf spec says
(``sharding/specs.py``): split over the FSDP sub-group (``fsdp_axes``),
over ``model`` (tensor parallelism, on a grid with ``model`` > 1), over
both (a tile), or whole. A step gathers the parts over the FSDP
sub-group into the rank's tensor-parallel parts, runs the forward and
backward (under ``TensorParallel`` where ``model`` > 1), frees them, and
averages the gradient over the ``grad_axes`` ranks, a split part's slice
by an all-to-all, an unsplit one by :func:`core.comm.gather_mean_` (fp32
on the wire): bit for bit the data-replicated run's mean, which is the
same code under ``fsdp_axes=()``.

With a ``group`` of workers × S shards and S > 1, per leaf (no ``flat``),
each rank holds its parts of its worker's leaves, split over the
worker's S ranks as the specs ``with_workers`` say (tensor parallelism
under the paper-style plan, ``sharding.partition.TensorParallel``): the
worker's loss and gradient come from its ranks' parts
(``loss_fn(..., tp=)``, every rank of a worker the same batch), the
update (row 1) runs on the parts, and the sync round encodes each part
(row 3; a part whose quantization blocks straddle its boundary is
gathered for the encode) and averages it over the worker sub-group of
its shard index (row 6 decoding, the ordered float32 sum). The norms and
drift statistics add the parts' partial sums in shard order, a leaf the
specs leave whole counted once. Replicated leaves stay equal on a
worker's ranks: the collectives give every rank the same bits.

With a ``group`` on a grid with pods (``{"pod": P, "data": D, "model":
M}``) under the 20-100 B plan (``local_axes=("pod",)``, ``grad_axes =
fsdp_axes = ("data",)``) each pod is one Local AdaAlter worker, as the
reference's vmapped worker ``spmd_axis_name=("pod",)`` is. A rank holds
its tiles of its pod's worker (a leading worker axis of 1: the part over
``data`` of its part over ``model``, :func:`leaf_layout`), gathers them
over the pod's ``data`` ranks into its tensor-parallel parts, runs the
forward and backward on its rows of its pod's batch, takes each leaf's
gradient mean over the pod's ``data`` ranks back to its tiles
(:meth:`LeafLayout.grad_mean`), and runs the update (row 1) on the
tiles. A sync round averages each tile over the ``pod`` sub-group (the
ranks at its ``(data, model)`` coordinates in every pod): the stacked
mean of P workers, bit for bit. Under ``fsdp_axes=()`` no leaf splits
over ``data``: the pod's data-replicated run, equal bit for bit. With
``flat`` a pod's planes split over its D × M ranks (the sharded plane
below), the gradient taken as the per-leaf run takes it: its state equals
the per-leaf run's bit for bit.

With ``OptimizerConfig.obs_metrics`` every step also returns
``metrics['grad_norm']``: the L2 norm of the raw (pre-clip) gradients, one
per worker on the local paths, a scalar on the one-model one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.core import comm
from repro_torch.core import flatspace as fsp
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.comm import gather_mean_, worker_mean_
from repro_torch.core.sync_engine import drift_statistic
from repro_torch.kernels.ref import F32_MIN
from repro_torch.kernels.tiling import round_through_bf16
from repro_torch.launch.mesh import resolve_plan
from repro_torch.models import build_model
from repro_torch.tree import leaves, tree_map, unflatten_like


def mean_over_workers(tree):
    """The sync mean: every worker's row replaced by the mean over axis 0
    as the reference computes it (``core.comm.worker_mean_``), written in
    place. The sync round hands it tensors that nothing else holds — the
    wire values, or the step's freshly updated state — and writing over
    them keeps a second copy of the synced state (10 GB at full Big LSTM
    width with 2 workers) from being allocated."""
    return tree_map(worker_mean_, tree)


class RankMean:
    """The sync mean of a run with one worker a rank: a ``mean_fn`` of
    ``LocalOptimizer.sync`` over a :class:`core.comm.RankGroup`.

    Called on a tree, every leaf is :func:`core.comm.gather_mean_`'d with
    ``wire_dtype`` on the wire (fp32 for the lossless wire, bf16 for the
    bf16 codec, whose wire values are bf16 numbers). The int8 wire goes
    through :meth:`of_payloads`, ``compressed_sync``'s ``payload_mean``."""

    def __init__(self, group, wire_dtype: torch.dtype) -> None:
        self.group = group
        self.wire_dtype = wire_dtype

    def __call__(self, tree):
        return tree_map(lambda x: gather_mean_(
            x, self.group, wire_dtype=self.wire_dtype), tree)

    def of_payloads(self, wires, payloads, decode) -> None:
        """Per leaf of ``wires``: its payload's parts (int8 codes, fp32
        scales) packed into one collective, every rank's decoded by
        ``decode(parts, like, start, stop)`` into wire values a chunk at a
        time, the ordered mean written over the leaf. A
        :class:`WholePayload` is a whole leaf's, of which ``x`` is this
        rank's part: each rank's is decoded whole and cut."""
        for x, parts in zip(leaves(wires), payloads):
            whole = parts if isinstance(parts, WholePayload) else None
            got = self.group.all_gather(whole.payload if whole else parts)
            if whole is None:
                self.group.mean_(x, lambda r, a, b, x=x, got=got: decode(
                    tuple(g[r] for g in got), x, a, b))
                continue
            n = math.prod(whole.split.shape)
            rows = [whole.split.part(decode(tuple(g[r] for g in got), x, 0,
                                            n).view(whole.split.shape))
                    .reshape(-1) for r in range(self.group.world)]
            self.group.mean_(x, lambda r, a, b, rows=rows: rows[r][a:b])


@dataclasses.dataclass
class WholePayload:
    """The encoded payload of a whole leaf of which a rank sends its part
    (``split``, a ``sharding.specs.LeafSplit``): a part whose quantization
    blocks straddle its boundary is encoded whole."""
    payload: Any
    split: Any


def _sq_norms(fn, *trees, layout=None) -> torch.Tensor:
    """Per-worker Σ over the leaves of ``trees`` (stacked alike) of the
    squared norms of ``fn(*leaf_i)``, leaf by leaf (no whole-tree
    temporary), each worker's row reduced on its own
    (``core.optimizers.worker_sums``). With a ``layout`` (a
    :class:`LeafLayout` of parts) over the leaves this rank owns, the
    partial sums added over its sub-group in part order."""
    picked = list(zip(*(leaves(t) for t in trees)))
    if layout is not None:
        picked = [picked[i] for i, _ in layout.owned_leaves(trees[0])]
    out = sum((opt_lib.worker_sums(torch.square(fn(*xs))) for xs in picked),
              torch.zeros(leaves(trees[0])[0].shape[:1], device=leaves(
                  trees[0])[0].device))
    if layout is None or layout.ranks is None:
        return out
    return comm.ordered_sum(layout.ranks, out, comm.side)


def _drift_per_worker(new_params, params, layout=None) -> torch.Tensor:
    """(rows,): ||x_i' − x_i|| / (||x_i|| + tiny) of each worker."""
    d = torch.sqrt(_sq_norms(lambda n, p: n.float() - p.float(), new_params,
                             params, layout=layout))
    p = torch.sqrt(_sq_norms(lambda p: p.float(), params, layout=layout))
    return d / (p + 1e-12)


def _staleness_per_worker(grads, anchor, layout=None) -> torch.Tensor:
    """(rows,): ‖g_i,t − g_i,last_sync‖² / (‖g_i,t‖² + tiny) of each
    worker."""
    d2 = _sq_norms(lambda g, a: g.float() - a, grads, anchor, layout=layout)
    g2 = _sq_norms(lambda g: g.float(), grads, layout=layout)
    return d2 / (g2 + 1e-12)


def worker_metrics(per_worker: dict, group=None) -> dict:
    """A step's metrics from per-worker values ((rows,) each): ``loss``
    and ``drift`` the mean over all workers, ``grad_norm`` the (R,)
    vector. With a ``group`` the ranks' values are gathered first, one
    collective for all of them, so each mean is the stacked run's
    ``torch.mean`` over the same (R,) values and every rank holds the
    same bits (the sync engine decides on each rank)."""
    if group is not None:
        keys = list(per_worker)
        (got,) = group.all_gather(
            [torch.stack([per_worker[k].reshape(()).float() for k in keys])],
            count=comm.side)
        per_worker = {k: got[:, i].contiguous() for i, k in enumerate(keys)}
    out = {k: torch.mean(v) for k, v in per_worker.items()
           if k in ("loss", "drift")}
    if "grad_norm" in per_worker:
        out["grad_norm"] = per_worker["grad_norm"]
    return out


def worker_grads(params, batch, model, grads=None, remat: str = "none",
                 tp=None):
    """Each worker's loss (``model.loss_fn``: xent + aux) and gradient, one
    worker at a time, the transformer groups rematerialised as ``remat``
    says (the plan's). ``grads`` (stacked like ``params``, any float dtype,
    e.g. fp32 views of a flat plane) receives the gradients; new tensors
    like ``params`` by default. ``tp``: tensor parallelism, ``params``
    this rank's parts. Returns (losses (R,), grads)."""
    if grads is None:
        grads = tree_map(torch.empty_like, params)
    losses = []
    kw = {} if tp is None else {"tp": tp}
    for w in range(leaves(params)[0].shape[0]):
        p_w = tree_map(lambda t: t[w].detach().requires_grad_(), params)
        loss, _ = model.loss_fn(p_w, {k: v[w] for k, v in batch.items()},
                                remat=remat, **kw)
        for dst, g in zip(leaves(grads),
                          torch.autograd.grad(loss, leaves(p_w))):
            dst[w].copy_(g)
        losses.append(loss.detach())
    return torch.stack(losses), grads


@dataclasses.dataclass
class TrainPrograms:
    """Step functions of one run. A step consumes the ``params`` and
    ``opt_state`` it is given, as the JAX package's step donates them: the
    update and the sync round may write over their tensors. With
    ``is_flat`` the params are a FlatSpace plane and the state's
    param-shaped entries planes too; ``to_flat``/``to_legacy`` translate
    between the layouts (set for every Local AdaAlter run)."""
    init_fn: Callable[..., Any]  # (seed, base=None) -> (params, opt_state)
    local_step: Callable[..., Any]  # (params, opt_state, batch) -> (params, opt_state, metrics)
    sync_step: Callable[..., Any]   # same signature; ends with the sync round
    n_workers: int               # the run's workers (over all ranks)
    H: int
    is_local: bool = True        # False: a synchronous optimizer, R = 1
    n_payload_leaves: int = 0    # param leaves a sync round touches
    is_flat: bool = False
    flatspace: Any = None        # FlatSpace geometry (local_adaalter runs)
    # (params, opt_state) of the per-leaf and the flat layout on the meta
    # device: the restore templates of checkpoints written in the layout
    # this run does not train in (local_adaalter runs)
    legacy_abstract: Any = None
    flat_abstract: Any = None
    to_flat: Any = None          # per-leaf (params, opt_state) -> planes
    to_legacy: Any = None        # planes -> per-leaf (params, opt_state)
    group: Any = None            # core.comm.RankGroup: the run's ranks
    plan: Any = None             # configs.ParallelismPlan it was built from
    n_shards: int = 1            # sub-planes a worker's flat plane splits
                                 # into, one a rank (sharded flat runs)
    shard: int = 0               # this rank's sub-plane
    leaf_layout: Any = None      # LeafLayout: the parts of each leaf this
                                 # rank holds (one-model runs, and tensor
                                 # parallelism's parts of a worker)
    tp: Any = None               # sharding.partition.TensorParallel of a
                                 # per-leaf run on a grid with model > 1


def shard_state(fs, shard: int, plane, state):
    """This rank's sub-plane of a flat ``plane`` and of every plane of
    ``state`` (the counters pass through): new contiguous tensors."""
    return fs.shard_of(plane, shard), {
        k: (v if k in fsp.SCALAR_STATE_KEYS else fs.shard_of(v, shard))
        for k, v in state.items()}


def build_train_programs(cfg, opt_cfg, *, n_workers: int, device,
                         group=None, plan=None) -> TrainPrograms:
    """The step functions of a run of ``n_workers`` workers stacked on
    ``device``, or with a ``group`` spread over its ranks, laid out as its
    (workers × shards) grid: one worker a rank, or with shards each
    worker's flat plane split into sub-planes, one a rank. ``plan``
    (default: ``launch.mesh.resolve_plan`` on the grid, a stacked run's
    grid being its workers along ``data``, as the reference's
    ``train_loop`` resolves it) decides between workers along
    ``local_axes`` (a local optimizer under a plan with them) and one model
    whose gradient is averaged along ``grad_axes`` and whose leaves are
    split over ``fsdp_axes`` (:func:`_leaf_programs`: a synchronous
    optimizer, or a local one under a plan without worker axes, the
    reference's one-model branch), how many shards a flat plane takes
    (``tp_axis``), and the rematerialisation of the transformer groups
    (``remat``)."""
    from repro_torch.launch.mesh import check_plan
    from repro_torch.sharding.specs import plane_shardings
    opt = opt_lib.make_optimizer(opt_cfg)
    grid = group.grid if group is not None else {"data": n_workers,
                                                 "model": 1}
    plan = plan or resolve_plan(cfg, grid, optimizer=opt_cfg.name)
    local = opt_lib.is_local(opt) and bool(plan.local_axes)
    if opt_cfg.flat and not (local and opt_cfg.name == "local_adaalter"):
        raise ValueError("OptimizerConfig.flat requires a local Local "
                         f"AdaAlter run (got optimizer={opt_cfg.name!r}, "
                         f"local={local})")
    layout, _ = plane_shardings(grid, plan)
    # a stacked run holds whole planes, whatever shard axes its plan has
    n_shards = group.layout.shards if (group is not None
                                       and opt_cfg.flat) else 1
    if group is not None:
        check_plan(plan, grid, flat=opt_cfg.flat, cfg=cfg)
        if plan.local_axes and not local:
            raise ValueError(f"the plan {plan} does not fit "
                             f"{opt_cfg.name!r} (a synchronous optimizer)")
        if local and n_workers != layout.workers:
            raise ValueError(f"{n_workers} workers on a {grid['data']} x "
                             f"{grid['model']} grid of ranks: a run with "
                             "ranks holds one worker a rank, or a row of "
                             "ranks a worker")
    if not local:
        if n_workers != 1:
            why = ("is a synchronous optimizer" if not opt_lib.is_local(opt)
                   else f"has no worker axes under the plan {plan}")
            raise ValueError(
                f"{opt_cfg.name!r} {why}: one model takes the whole global "
                f"batch (R = 1), so it trains with one worker, not "
                f"{n_workers}")
        return _leaf_programs(cfg, opt_cfg, torch.device(device), group,
                              plan)
    R = 1 if group is not None else n_workers     # workers on this device
    device = torch.device(device)
    model = build_model(cfg)
    tp = layout = None
    # a worker of several ranks (the pods): its gradient averaged over
    # their data ranks every step; a pod of one rank is one worker a rank
    pods = group is not None and bool(plan.grad_axes) and (
        group.layout.shards > 1)
    grad_group = group.along(plan.grad_axes) if pods else None
    if group is not None and group.layout.shards > 1 and (
            pods or not opt_cfg.flat):
        tp, layout = leaf_layout(cfg, plan, group, model.init(None, "meta"),
                                 worker_axis=True)
        # the clip needs the norm over the worker's parts: applied here
        opt = opt_lib.make_optimizer(dataclasses.replace(opt_cfg,
                                                         grad_clip=0.0))
    pod = None
    if pods:
        pod = PodGrads(model, layout, tp, grad_group, plan.remat,
                       _freeable(plan, cfg, layout))
        if opt_cfg.flat:      # planes: the parts serve the gradient alone
            layout = None
    mean_fn = mean_over_workers
    sync_kw = {}
    if group is not None:
        mean_fn = RankMean(group.workers, torch.bfloat16 if
                           opt_cfg.sync.compression == "bf16"
                           else torch.float32)
        if opt_cfg.sync.compression == "int8":
            sync_kw = {"payload_mean": mean_fn.of_payloads}
            if layout is not None:
                from repro_torch.core.codecs import get_codec
                sync_kw["encode"] = layout.encode(get_codec(
                    "int8", block=opt_cfg.sync.block,
                    use_kernels=opt_cfg.use_kernels,
                    fused=opt_cfg.sync.fused), opt_cfg.sync.block,
                    batch_ndim=1)
    fused = opt_cfg.use_kernels and opt_cfg.name == "local_adaalter"
    stat = drift_statistic(opt_cfg.sync)
    staleness = stat == "grad_staleness"
    # shapes and dtypes of the stacked parameters, on the meta device
    abstract = tree_map(lambda x: x[None].expand((R,) + x.shape),
                        model.init(None, "meta"))

    def base_params(seed: int, base):
        """One worker's parameters: ``base`` (e.g. carried across with
        ``repro_torch.convert``) or fresh weights from a seeded
        ``torch.Generator``."""
        if base is None:
            base = model.init(torch.Generator(device).manual_seed(seed))
        return tree_map(lambda x: x.to(device), base)

    def init_fn(seed: int, base=None):
        """Stacked (params, opt_state), one worker's parameters copied to
        all R workers (this rank's parts of them, under ``tp``)."""
        params = tree_map(lambda x: x[None].repeat((R,) + (1,) * x.ndim),
                          base_params(seed, base))
        if layout is not None:
            params = layout.take(params)
        return params, opt.init(params, workers=R)

    def step(params, opt_state, batch, *, do_sync: bool):
        if pod is None:
            loss, grads = worker_grads(params, batch, model,
                                       remat=plan.remat, tp=tp)
        else:
            loss, grads = pod.tiles(params, batch)
        stats = {"loss": loss}
        norm = None
        if opt_cfg.obs_metrics or (layout is not None
                                   and opt_cfg.grad_clip > 0):
            norm = (opt_lib.global_norm(grads, batch_ndim=1) if layout is None
                    else torch.sqrt(_sq_norms(lambda g: g.float(), grads,
                                              layout=layout)))
        if opt_cfg.obs_metrics:
            stats["grad_norm"] = norm
        if staleness:
            stats["drift"] = _staleness_per_worker(
                grads, opt_state["g_anchor"], layout)
        if fused or layout is not None:
            # the kernel bypasses opt.local_step, so the grad_clip wrapper
            # never sees these grads (under tp it would see parts): clip
            # per worker here. `grads` stays raw for the drift statistics,
            # as on the reference.
            applied = grads
            if opt_cfg.grad_clip > 0:
                applied, _ = opt_lib.clip_by_global_norm(
                    grads, opt_cfg.grad_clip, batch_ndim=1, norm=norm)
        if fused:
            step_no = opt_state["step"] + 1
            tprime = opt_state["tprime"] + 1
            eta, extra = opt_lib.local_scalars(
                opt_cfg.lr, opt_cfg.eps, opt_cfg.warmup_steps,
                int(step_no[0]), int(tprime[0]))
            from repro_torch.kernels.adaalter_update import update_scalars
            from repro_torch.kernels.ops import tree_fused_update
            new_params, new_b2 = tree_fused_update(
                params, applied, opt_state["b2_sync"], opt_state["b2_local"],
                update_scalars(eta, extra, device))
            new_state = {**opt_state, "step": step_no, "tprime": tprime,
                         "b2_local": new_b2}
        else:
            new_params, new_state = opt.local_step(
                applied if layout is not None else grads, opt_state, params)
        if stat is not None and not staleness:
            stats["drift"] = _drift_per_worker(new_params, params, layout)
        # a worker's ranks hold the same statistics: one a worker
        metrics = worker_metrics(stats, group if layout is None
                                 else group.workers)
        if do_sync:
            with (contextlib.nullcontext() if group is None
                  else group.workers.round_()):
                new_params, new_state = opt.sync(new_params, new_state,
                                                 mean_fn, **sync_kw)
            if staleness:
                new_state = {**new_state,
                             "g_anchor": tree_map(lambda g: g.float(), grads)}
        return new_params, new_state, metrics

    local_step = partial(step, do_sync=False)
    sync_step = partial(step, do_sync=True)
    flat_fields = {}
    if opt_cfg.name == "local_adaalter":
        fs = fsp.FlatSpace.build(abstract, batch_ndim=1, shards=n_shards,
                                 eps=opt_cfg.eps if opt_cfg.flat else None)
        state_abs = opt.init(abstract, workers=R)
        plane_abs = torch.empty((R, fs.plane_size), dtype=torch.float32,
                                device="meta")
        flat_fields = dict(
            flatspace=fs, legacy_abstract=(abstract, state_abs),
            flat_abstract=(plane_abs, {
                k: (v if k in fsp.SCALAR_STATE_KEYS else plane_abs)
                for k, v in state_abs.items()}),
            to_flat=lambda p_, s_: (fs.pack(p_), fsp.pack_opt_state(fs, s_)),
            to_legacy=lambda pl_, st_: (fs.unpack(pl_),
                                        fsp.unpack_opt_state(fs, st_)))
        if opt_cfg.flat:
            init_fn, local_step, sync_step = _flat_programs(
                fs, model, opt_cfg, opt, abstract, base_params, device,
                group, plan.remat, pod)
    if layout is not None:
        n_shards = group.layout.shards
    return TrainPrograms(init_fn=init_fn, local_step=local_step,
                         sync_step=sync_step, n_workers=n_workers, H=opt.H,
                         n_payload_leaves=len(leaves(abstract)),
                         is_flat=opt_cfg.flat, group=group, plan=plan,
                         n_shards=n_shards,
                         shard=group.shard if n_shards > 1 else 0,
                         leaf_layout=layout, tp=tp, **flat_fields)


def leaf_layout(cfg, plan, group, abstract, *, worker_axis: bool = False):
    """The parts of a per-leaf run's parameter leaves (``abstract``, one
    model's, on the ``meta`` device) that this rank holds, as
    ``sharding.specs.param_shardings`` splits them under ``plan`` on the
    grid of ``group`` (None: one device, every leaf whole): the
    :class:`LeafLayout`, and the ``sharding.partition.TensorParallel`` the
    layers take where the grid has ``model`` > 1 (None elsewhere).

    ``worker_axis``: the parts of this rank's worker (its leaves carry a
    leading worker axis of 1), split over the worker's ranks: along
    ``model`` under the paper-style plan, as tiles over a pod's ``data``
    (``plan.fsdp_axes``) and ``model`` ranks where the pods are the
    workers; else one model's tiles over the whole grid, each the part
    over the FSDP sub-group (``plan.fsdp_axes``) of the rank's part over
    ``model``."""
    from repro_torch.sharding import ShardingRules, leaf_split, param_shardings
    from repro_torch.sharding.partition import TensorParallel, rule_overrides
    grid = group.grid if group is not None else {"data": 1, "model": 1}
    rules = ShardingRules(grid, plan, rule_overrides(cfg))
    coords = dict.fromkeys(grid, 0)
    if group is not None:
        coords = group.layout.coords_of(group.rank)
        if worker_axis:                   # a part of the worker's
            coords.update(dict.fromkeys(plan.local_axes, 0))
    tiles = [leaf_split(t.shape, sp, grid, coords)
             for t, sp in zip(leaves(abstract),
                              param_shardings(rules, abstract))]
    if worker_axis:
        tiles = [_with_worker_axis(s) for s in tiles]
    tp_group = group.along(("model",)) if group is not None else None
    tp = None if tp_group is None else TensorParallel(tp_group, rules)
    index = (coords["data"], coords["model"])
    fsdp = group.along(plan.fsdp_axes) if group is not None else None
    ranks = (None if group is None else group.shards if worker_axis
             else group)
    return tp, LeafLayout(tiles, fsdp, tp=tp_group, ranks=ranks,
                          index=index, grid=grid)


def _with_worker_axis(split):
    """``split`` (a ``LeafSplit`` or ``TileSplit`` of one worker's leaf)
    of the leaf with a leading worker axis of 1."""
    from repro_torch.sharding import LeafSplit, TileSplit
    if isinstance(split, TileSplit):
        return TileSplit(_with_worker_axis(split.tp),
                         _with_worker_axis(split.fsdp))
    return LeafSplit((1,) + split.shape, None if split.dim is None
                     else split.dim + 1, split.parts, split.index,
                     split.axes)


# --------------------------------------------------------------------------- #
# one model, per leaf (the synchronous optimizers, and a local optimizer under
# a plan without worker axes), each leaf held as its spec says
# --------------------------------------------------------------------------- #
class LeafLayout:
    """The part of each parameter leaf a rank holds: ``tiles`` (a
    ``sharding.specs.LeafSplit`` or ``TileSplit`` of each whole leaf, in
    ``tree.leaves`` order, on ``grid``: ``sharding.specs.tile_parts``). A
    rank's part of a leaf is the part over ``fsdp`` (the FSDP sub-group:
    :attr:`splits`) of its part over ``tp`` (the ``model`` sub-group:
    :attr:`tp_splits`, tensor parallelism's part, which the layers take);
    either group None: no split over it. ``ranks``: every rank holding a
    part of one model (its sums over the parts run over it), this rank at
    ``index`` (its ``(data, model)`` coordinates among them). The
    optimizer state's params-shaped entries are split as the params, its
    counters whole."""

    def __init__(self, tiles, fsdp=None, *, tp=None, ranks=None,
                 index=(0, 0), grid=None) -> None:
        from repro_torch.sharding import tile_parts
        self.tiles = list(tiles)
        parts = [tile_parts(t, grid) for t in self.tiles]
        self.tp_splits = [t for t, _ in parts]
        self.splits = [f for _, f in parts]
        self.group, self.tp_group, self.ranks = fsdp, tp, ranks
        self._index = tuple(index)

    @property
    def sharded(self) -> bool:
        return any(t.split for t in self.tiles)

    def owned_leaves(self, tree) -> list:
        """``(index, leaf)`` of each leaf of a params-shaped tree of parts
        this rank counts in sums over :attr:`ranks`: each part of a leaf
        once over both axes (a leaf unsplit along one of them on that
        axis's first rank only)."""
        f0, t0 = self._index
        return [(i, x) for i, (x, f, t) in enumerate(zip(
            leaves(tree), self.splits, self.tp_splits))
                if (f.split or f0 == 0) and (t.split or t0 == 0)]

    def take(self, tree):
        """This rank's parts of a params-shaped tree of whole leaves."""
        return unflatten_like(tree, [s.take(x) for s, x in
                                     zip(self.tiles, leaves(tree))])

    def gather(self, tree, count=comm.wire):
        """The tensor-parallel parts of a tree of this rank's parts (the
        whole leaves without tensor parallelism), on its device: one
        all-gather over the FSDP sub-group (``tree`` itself if no leaf is
        split over it)."""
        if not any(s.split for s in self.splits):
            return tree
        return unflatten_like(tree, self.group.gather_leaves(
            leaves(tree), self.splits, count))

    def _whole(self, i: int, xs: list, count) -> list:
        """The whole leaves of tensors ``xs`` split as leaf ``i``, on the
        device: gathered over the FSDP sub-group, then over ``model``."""
        for split, group in ((self.splits[i], self.group),
                             (self.tp_splits[i], self.tp_group)):
            if split.split:
                xs = group.gather_leaves(xs, [split] * len(xs), count)
        return xs

    def gather_whole(self, tree, count=comm.side):
        """Every leaf of a tree of parts whole on this rank's device, a
        leaf at a time."""
        return unflatten_like(tree, [
            self._whole(i, [x], count)[0]
            for i, x in enumerate(leaves(tree))])

    def whole(self, tree):
        """Every leaf whole on the host (a checkpoint), a leaf at a time,
        counted in ``comm.side``."""
        return unflatten_like(tree, [
            self._whole(i, [x], comm.side)[0].cpu()
            for i, x in enumerate(leaves(tree))])

    def whole_like(self, tree):
        """``meta`` templates of the whole leaves of a tree of parts (a
        checkpoint's restore template)."""
        return unflatten_like(tree, [
            torch.empty(s.shape, dtype=x.dtype, device="meta")
            for x, s in zip(leaves(tree), self.tiles)])

    def state(self, fn, opt_state):
        """``fn`` applied to every params-shaped entry of an optimizer
        state; the counters pass."""
        return {k: v if k in fsp.SCALAR_STATE_KEYS else fn(v)
                for k, v in opt_state.items()}

    def grad_mean(self, i: int, g, group):
        """The mean over ``group`` (the ranks along ``grad_axes``) of leaf
        ``i``'s tensor-parallel part's gradient ``g``, as this rank's
        part: split over the FSDP sub-group by ``RankGroup.mean_slices``
        (a new tensor, its tile), else by ``core.comm.gather_mean_``
        (written over ``g``), fp32 on the wire; bit for bit the replicated
        run's mean."""
        s = self.splits[i]
        if s.split:
            return self.group.mean_slices(g, s)
        return gather_mean_(g, group, wire_dtype=torch.float32)

    def sums(self, partials: list) -> list:
        """Per leaf, a float32 sum over the whole leaf from each rank's sum
        over its part (``partials``, scalars): the parts' partials
        gathered over the FSDP sub-group, then over ``model`` (one
        collective each where a leaf splits over it, ``comm.side``), each
        added in part order."""
        out = list(partials)
        for splits, group in ((self.splits, self.group),
                              (self.tp_splits, self.tp_group)):
            idx = [i for i, s in enumerate(splits) if s.split]
            if not idx:
                continue
            (got,) = group.all_gather(
                [torch.stack([out[i].float() for i in idx])],
                count=comm.side)
            for j, i in enumerate(idx):
                acc = got[0, j]
                for r in range(1, got.shape[0]):
                    acc = acc + got[r, j]
                out[i] = acc
        return out

    def norm(self, tree) -> torch.Tensor:
        """The fp32 global L2 norm of a tree of parts
        (``core.optimizers.global_norm`` of the whole leaves, but for the
        order of the split leaves' sums)."""
        return torch.sqrt(sum(self.sums([torch.sum(torch.square(g.float()))
                                         for g in leaves(tree)])))

    def encode(self, codec, block: int, batch_ndim: int = 0):
        """``compressed_sync``'s ``encode`` over this rank's parts: the
        error-feedback encode of each whole leaf
        (``core.sync_engine.ef_apply``, quantization blocks of the leaf's
        row-major order, a worker's row at a time with ``batch_ndim`` 1).
        A part or tile whose runs hold whole blocks (``whole_blocks``) is
        encoded in place, block for block the whole leaf's; elsewhere the
        leaf and its residual are gathered whole (``comm.side``), encoded
        whole, and this rank keeps its part (and, asked for the
        ``codes``, sends the whole leaf's, a :class:`WholePayload`)."""
        from repro_torch.core.sync_engine import ef_apply
        blocked = codec.name == "int8"

        def enc(tree, residual, *, clamp_nonneg=False, codes=False):
            wires, res, pays = [], [], []
            for i, (x, e, s) in enumerate(zip(leaves(tree), leaves(residual),
                                              self.tiles)):
                whole = s.split and blocked and not s.whole_blocks(block)
                if whole:
                    x, e = self._whole(i, [x, e], comm.side)
                w, r, *p = ef_apply(x, e, codec, batch_ndim,
                                    clamp_nonneg=clamp_nonneg, codes=codes)
                wires.append(s.take(w) if whole else w)
                res.append(s.take(r) if whole else r)
                if codes:
                    pays.append(WholePayload(p[0][0], s) if whole
                                else p[0][0])
            out = unflatten_like(tree, wires), unflatten_like(tree, res)
            return (*out, pays) if codes else out
        return enc


#: elements of a leaf a one-model synchronous update takes at a time
UPDATE_CHUNK = 1 << 25


def _freeable(plan, cfg, layout) -> list:
    """Per leaf, whether a gathered part may be freed before the backward
    (:func:`backward_means`): where no recomputation reads it again (remat
    and the attention's checkpoint re-run the forward from it)."""
    if plan.remat != "none" or getattr(cfg, "attn_remat", False):
        return []
    return [s.split for s in layout.splits]


def _note_storage(saved, t):
    """A tensor autograd saves for the backward: its storage noted."""
    saved.add(t.untyped_storage().data_ptr())
    return t


def backward_means(model, p, batch, *, remat: str, batch_group, tp,
                   reduce: Callable, free=()):
    """The loss and gradient of one model's parameters ``p`` (leaves that
    require grad: this rank's tensor-parallel parts) on this rank's rows
    ``batch``, each leaf's gradient handed to ``reduce(i, g)`` as soon as
    the backward has summed it (the same leaf order on every rank), so the
    whole gradients are never all held beside the parameters: returns
    (the loss, averaged over ``batch_group``, the ranks whose rows form
    one batch, the MoE routing them as one; the list of ``reduce``'s
    results). ``free``: per leaf, whether its storage (a gathered part)
    may be freed before the backward if autograd saved none of it (an
    embedding table: its lookup saves the indices)."""
    grads = [None] * len(leaves(p))

    def take(i, leaf):
        g, leaf.grad = leaf.grad, None
        grads[i] = reduce(i, g)
    hooks = [t.register_post_accumulate_grad_hook(partial(take, i))
             for i, t in enumerate(leaves(p))]
    saved = set()
    kw = {} if tp is None else {"tp": tp}
    with torch.autograd.graph.saved_tensors_hooks(
            partial(_note_storage, saved), lambda t: t):
        loss, _ = model.loss_fn(p, batch, remat=remat,
                                batch_group=batch_group, **kw)
    for t, f in zip(leaves(p), free):
        if f and t.untyped_storage().data_ptr() not in saved:
            t.untyped_storage().resize_(0)
    loss.backward()
    for h in hooks:
        h.remove()
    loss = loss.detach()
    if batch_group is not None:       # the loss's mean over the ranks
        loss = worker_metrics({"loss": loss}, batch_group)["loss"]
    return loss, grads


@dataclasses.dataclass
class PodGrads:
    """The gradient of a worker whose rows split over several ``data``
    ranks (a pod, under the 20-100 B plan): the reference's vmapped
    worker over ``spmd_axis_name=("pod",)``, its batch split over
    ``grad_axes``. ``layout`` (a :class:`LeafLayout` of the worker's
    leaves with their leading worker axis of 1) gives this rank's parts,
    ``tp`` the ``model`` sub-group's context, ``group`` the pod's ``data``
    ranks (None: one); ``remat`` the plan's, ``free`` the gathered parts
    :func:`backward_means` may free (:func:`_freeable`)."""
    model: Any
    layout: Any
    tp: Any
    group: Any
    remat: str
    free: list

    def _backward(self, parts, batch, reduce, free=()):
        p = tree_map(lambda t: t[0].detach().requires_grad_(), parts)
        loss, grads = backward_means(
            self.model, p, {k: v[0] for k, v in batch.items()},
            remat=self.remat, batch_group=self.group, tp=self.tp,
            reduce=reduce, free=free)
        return loss.reshape(1), grads

    def tiles(self, params, batch):
        """(the worker's loss (1,), this rank's tiles of the worker's
        gradient mean) from its tiles ``params``: gathered over the pod's
        ``data`` ranks into tensor-parallel parts, each leaf's gradient
        mean over them back to tiles (:meth:`LeafLayout.grad_mean`)."""
        lay = self.layout

        def reduce(i, g):
            g = g[None]
            return g if self.group is None else lay.grad_mean(i, g,
                                                              self.group)
        loss, grads = self._backward(lay.gather(params), batch, reduce,
                                     self.free)
        return loss, unflatten_like(params, grads)

    def into(self, whole, batch, dests):
        """The worker's loss (1,), its gradient mean written whole into
        ``dests`` (its leaves, e.g. float32 views of a gradient plane),
        from its whole leaves ``whole``: the forward and backward on this
        rank's tensor-parallel parts, each leaf's gradient averaged over
        the pod's ``data`` ranks (``gather_mean_``: bit for bit the part
        :meth:`tiles` takes) and gathered over ``model``."""
        lay = self.layout
        parts = unflatten_like(whole, [s.take(w) for s, w in zip(
            lay.tp_splits, leaves(whole))])

        def reduce(i, g):
            g = g[None]
            return g if self.group is None else gather_mean_(
                g, self.group, wire_dtype=torch.float32)
        loss, means = self._backward(parts, batch, reduce)
        del parts
        if lay.tp_group is not None:
            means = lay.tp_group.gather_leaves(means, lay.tp_splits,
                                               comm.side)
        for d, m in zip(leaves(dests), means):
            d.copy_(m)
        return loss


def _leaf_programs(cfg, opt_cfg, device, group, plan) -> TrainPrograms:
    """One model over the global batch, each leaf as its spec over the grid
    says (``sharding.specs.param_shardings`` under ``plan``): split over
    the FSDP sub-group (``plan.fsdp_axes``), over ``model`` (tensor
    parallelism, on a grid with ``model`` > 1), both (a tile: the FSDP
    part of the rank's tensor-parallel part), or whole
    (:func:`leaf_layout`). A synchronous optimizer runs ``opt.update``
    every step (the paper's baselines, Algorithms 1 and 3); a local one
    (the reference's one-model branch) ``opt.local_step`` every step and
    on the policy's sync steps ``opt.sync`` with the identity mean, whose
    only work is the error-feedback encode of a lossy wire
    (:meth:`LeafLayout.encode`).

    A step, on each rank: its parts gathered over the FSDP sub-group into
    its tensor-parallel parts (the whole leaves without ``model``); the
    forward and backward on this rank's share of the batch (split over
    ``grad_axes``; the ``model`` ranks of a data row take the same rows),
    the layers under ``TensorParallel`` on a grid with ``model`` > 1;
    each leaf's gradient mean over the ``grad_axes`` ranks taken as the
    backward produces it, a part split over the FSDP sub-group by an
    all-to-all of its slices (:meth:`LeafLayout.grad_mean`), back to this
    rank's parts; the gathered parts freed; the update on the parts,
    elementwise, leaf by leaf. Leaves whole on ``model`` get the
    same gradient on a data row's ranks (the TP collectives give every
    rank the same bits), so they stay equal without a mean over
    ``model``. Sums over a split leaf (the gradient norm of ``grad_clip``
    and ``obs_metrics``) add the parts' partial sums in part order. Under
    ``fsdp_axes=()`` (or on one device) no leaf splits over ``data`` and
    this is the data-replicated run, whose state the FSDP run's equals bit
    for bit; the norm may differ in its last bits. The loss is the mean of
    the data ranks'. No kernel runs but the int8 encode's (row 3) with
    ``use_kernels``, as in the reference's one-model branch."""
    model = build_model(cfg)
    # the clip needs the norm over every rank's parts: it is applied here,
    # not by make_optimizer's with_grad_clip
    opt = opt_lib.make_optimizer(dataclasses.replace(opt_cfg, grad_clip=0.0))
    local = opt_lib.is_local(opt)
    tp, layout = leaf_layout(cfg, plan, group, model.init(None, "meta"))
    grad_group = group.along(plan.grad_axes) if group is not None else None
    if layout.group is not None and layout.group is not grad_group:
        raise ValueError(f"the plan {plan} splits leaves over "
                         f"{plan.fsdp_axes}, not over every rank of its "
                         f"gradient mean ({plan.grad_axes})")
    # Alg. 3 folds g∘g into B²; Alg. 1 and plain SGD never read it, and the
    # reference's compiled step drops it as dead code
    wants_sq = opt_cfg.name == "adaalter"
    sync_kw = {}
    if local:
        from repro_torch.core.codecs import get_codec
        codec = get_codec(opt_cfg.sync.compression,
                          block=opt_cfg.sync.block,
                          use_kernels=opt_cfg.use_kernels,
                          fused=opt_cfg.sync.fused)
        if not codec.lossless:
            sync_kw = {"encode": layout.encode(codec, opt_cfg.sync.block)}

    def init_fn(seed: int, base=None):
        if base is None:
            base = model.init(torch.Generator(device).manual_seed(seed))
        params = layout.take(tree_map(lambda x: x.to(device), base))
        return params, opt.init(params)

    free = _freeable(plan, cfg, layout)

    def reduce(i, g):
        """Leaf ``i``'s gradient mean over ``grad_axes`` as this rank's
        part."""
        return g if grad_group is None else layout.grad_mean(i, g,
                                                             grad_group)

    def step(params, opt_state, batch, *, do_sync: bool):
        p = tree_map(lambda t: t.detach().requires_grad_(),
                     layout.gather(params))
        loss, grads = backward_means(model, p, batch, remat=plan.remat,
                                     batch_group=grad_group, tp=tp,
                                     reduce=reduce, free=free)
        del p                         # the gathered parts
        grads = unflatten_like(params, grads)
        metrics = {"loss": loss}
        norm = None
        if opt_cfg.obs_metrics or opt_cfg.grad_clip > 0:
            norm = layout.norm(grads)
        if opt_cfg.obs_metrics:
            metrics["grad_norm"] = norm
        applied, factor = opt_lib.clip_by_global_norm(
            grads, opt_cfg.grad_clip, norm=norm)
        if local:
            new_params, new_state = opt.local_step(applied, opt_state,
                                                   params)
            if do_sync:
                new_params, new_state = opt.sync(new_params, new_state,
                                                 **sync_kw)
            return new_params, new_state, metrics
        # the update leaf by leaf and a chunk of a leaf at a time (the
        # optimizers are elementwise): g∘g is made just before its chunk's
        # update and each gradient dropped once used, so the step holds a
        # chunk's temporaries beside the old and new state, not a tree of
        # g∘g and of the update's float32 intermediates
        g_list, a_list = leaves(grads), leaves(applied)
        del grads, applied
        entries = [k for k in opt_state if k not in fsp.SCALAR_STATE_KEYS]
        new_p, new_s, counters = [], {k: [] for k in entries}, {}
        for i, p_i in enumerate(leaves(params)):
            olds = {k: leaves(opt_state[k])[i] for k in entries}
            out_p = torch.empty_like(p_i)
            outs = {k: torch.empty_like(v) for k, v in olds.items()}
            n = p_i.numel()
            for a in range(0, n, UPDATE_CHUNK):
                b = min(n, a + UPDATE_CHUNK)

                def cut(t):
                    return t.reshape(-1)[a:b]
                sq = None
                if wants_sq:
                    sq = [torch.square(cut(g_list[i]).float())]
                    if opt_cfg.grad_clip > 0:
                        sq = [sq[0] * torch.square(factor)]
                one = {k: (v if k in fsp.SCALAR_STATE_KEYS
                           else [cut(olds[k])]) for k, v in opt_state.items()}
                np_c, ns_c = opt.update([cut(a_list[i])], sq, one,
                                        [cut(p_i)])
                cut(out_p).copy_(np_c[0])
                for k, v in ns_c.items():
                    if k in entries:
                        cut(outs[k]).copy_(v[0])
                    else:
                        counters[k] = v
                del np_c, ns_c, sq
            g_list[i] = a_list[i] = None
            new_p.append(out_p)
            for k in entries:
                new_s[k].append(outs[k])
        new_state = {**counters, **{k: unflatten_like(opt_state[k], v)
                                    for k, v in new_s.items()}}
        return unflatten_like(params, new_p), new_state, metrics

    return TrainPrograms(init_fn=init_fn, local_step=partial(
        step, do_sync=False), sync_step=partial(step, do_sync=True),
        n_workers=1, H=opt.H if local else 1, is_local=False,
        n_payload_leaves=len(layout.tiles), group=group, plan=plan,
        leaf_layout=layout, tp=tp)


# --------------------------------------------------------------------------- #
# flat-plane steps (OptimizerConfig.flat; core/flatspace.py)
# --------------------------------------------------------------------------- #
def _bf16_ef(x, e, lower: float, round16=()):
    """The bf16 wire's error-feedback encode of one flat half, elementwise:
    v = x + e; v̂ = max(bf16(v), lower), rounded through bf16 again on the
    16-bit slots (the wire's cast to the leaf dtype); e' = v − v̂ (written
    over ``e``). Returns (wire, e)."""
    v = x + e
    w = torch.maximum(round_through_bf16(v),
                      torch.as_tensor(lower, dtype=torch.float32,
                                      device=v.device))
    for a, b in round16:
        w[..., a:b] = round_through_bf16(w[..., a:b])
    torch.sub(v, w, out=e)
    return w, e


def _flat_programs(fs, model, opt_cfg, opt, abstract, base_params, device,
                   group=None, remat: str = "none", pod=None):
    """Local AdaAlter over FlatSpace planes: the update is ONE launch over
    the parameter plane, and the sync round one EF encode of each half of
    the ``[params ‖ B²]`` payload and one mean of each (the halves are
    encoded in place rather than concatenated: at full Big LSTM width the
    concatenation and its wire would take ~27 GB more). With a ``group``
    the round is ONE collective over the packed ``[params ‖ B²]`` wire, as
    the reference's flat sync is one all-reduce. Given the same
    schedule the state is bitwise equal to the per-leaf path's, with the
    kernels (the same device expressions) and without them (the plain
    versions mirror each other's cast orders). The loss and the drift
    statistic, summed over the plane rather than leaf by leaf, may differ
    in the last bits.

    With ``fs.shards`` = S > 1 (a sharded flat run: ``group`` a grid of
    workers × S) each rank holds sub-plane ``group.shard`` of its worker's
    planes, the reference's ``shard_map`` branch. A step gathers the
    worker's params sub-planes over the shard sub-group into the leaves
    the forward reads (each bucket in its dtype: the bf16 slots move as
    bf16), runs the forward and backward whole, keeps its slice of the
    fp32 gradient plane, and runs the update and the EF encode on its
    sub-planes with its shard's sidecar rows (shard boundaries are tile and
    block boundaries, so every tile and block holds the elements the
    replicated plane's would). The sync mean runs over the worker
    sub-group only. The drift statistics are per-shard partial sums added
    over the shard sub-group in shard order. The state equals the
    replicated run's bit for bit; the drift, summed in another order, may
    differ in its last bits, as in the reference.

    With ``pod`` (a :class:`PodGrads`: the pods as workers) the worker's
    ranks are a pod's ``data`` × ``model`` ranks, and the gradient is
    taken as the per-leaf pod run takes it (each rank's rows, its
    tensor-parallel parts, the mean over the pod's ``data`` ranks), then
    gathered whole over ``model``: the state equals the per-leaf pod
    run's bit for bit.

    The update writes the new b2_local over the old one unless b2_sync
    shares its tensor (right after a sync), and the new parameters over the
    old plane unless the update-norm drift statistic still needs it.
    Returns ``(init_fn, local_step, sync_step)``; the state is
    (plane, {counters + per-state planes}), sub-planes when sharded."""
    from repro_torch.kernels.adaalter_update import (LANES,
                                                     flat_fused_update,
                                                     update_scalars)
    from repro_torch.core.codecs import get_codec
    from repro_torch.kernels.ref import flat_fused_update_ref
    from repro_torch.kernels.sync_fused import flat_ef_plane, flat_wire

    sync_cfg = opt_cfg.sync
    psize = fs.plane_size
    R = fs.batch_shape[0]
    block = sync_cfg.block
    if psize % block or fs.align % block:
        raise ValueError(f"sync block {block} must divide the FlatSpace "
                         f"alignment {fs.align}")
    S = fs.shards
    shard = group.shard if S > 1 else 0
    mean_group = None if group is None else group.workers
    compression = sync_cfg.compression or "fp32"
    round16 = fs.round16_ranges(shard)
    # sidecars of this rank's (sub-)plane row, on the device once: the
    # update's per-row bf16 flags, and the params half's per-block wire
    # rounding and clamp
    upd_rnd = torch.from_numpy(fs.round16_rows(LANES, shard)).to(device)
    enc_rnd = torch.from_numpy(fs.round16_rows(block, shard)).to(device)
    enc_low = torch.full_like(enc_rnd, F32_MIN)
    enc_zero = torch.zeros_like(enc_rnd)
    rnd16 = None
    if not opt_cfg.use_kernels:           # the plain update's element mask
        rnd16 = torch.from_numpy(fs.round16_elems(shard)).to(device)
    stat = drift_statistic(sync_cfg)
    staleness = stat == "grad_staleness"
    state_keys = list(opt.init(abstract, workers=R))

    def mine(plane):
        """This rank's sub-plane of a whole plane (the plane itself
        unsharded)."""
        return plane if S == 1 else fs.shard_of(plane, shard)

    def init_fn(seed: int, base=None):
        """The planes, built directly from one worker's parameters: no
        per-leaf state is materialised (at full Big LSTM width it would
        hold ~30 GB beside the planes). Padding is zero in every plane."""
        stacked = tree_map(lambda x: x[None].expand((R,) + x.shape),
                           base_params(seed, base))
        state = {}
        for k in state_keys:
            if k in fsp.SCALAR_STATE_KEYS:
                state[k] = torch.zeros((R,), dtype=torch.int32)
            else:       # accumulators start at b0², residuals, anchors at 0
                fill = torch.tensor(opt_cfg.b0 * opt_cfg.b0 if k in (
                    "b2_sync", "b2_local") else 0.0, device=device)
                state[k] = mine(fs.pack(tree_map(
                    lambda x: fill.expand(x.shape), stacked)))
        return mine(fs.pack(stacked)), state

    def leaf_params(plane):
        """The params tree the forward reads: views of the plane, or with
        shards the worker's sub-planes gathered over the shard sub-group
        into per-bucket leaves (``RankGroup.gather_into``)."""
        if S == 1:
            return fs.unpack(plane)
        bufs = fs.bucket_buffers(device)
        group.shards.gather_into(
            fs.shard_parts(plane, shard),
            [fs.bucket_views(bufs, s) for s in range(S)])
        return fs.unpack_buckets(bufs)

    def shard_sums(*parts):
        """Per-worker partial sums of this rank's sub-planes ((R,) each)
        added over the shard sub-group in shard order: the worker's sums
        over its whole plane (the parts themselves unsharded)."""
        if S == 1:
            return parts
        (got,) = group.shards.all_gather([torch.stack(parts)],
                                         count=comm.side)
        acc = got[0].clone()
        for r in range(1, S):
            acc = acc + got[r]
        return tuple(acc)

    codec = get_codec(compression, block=block,
                      use_kernels=opt_cfg.use_kernels)

    def rank_means(wire_p, wire_b, codes):
        """The two halves' means over the worker sub-group, one
        collective: the packed ``[params ‖ B²]`` wire (the int8 codes and
        scales, or the values in the wire's dtype) of every rank, decoded
        row by row."""
        if compression == "int8":
            (qp, sp), (qb, sb) = codes
            got = mean_group.all_gather([qp, sp, qb, sb])

            def row(half, r, a, b):
                blocks = slice(a // block, b // block)
                rnd, low = (enc_rnd, enc_low) if half == 0 else (enc_zero,
                                                                enc_zero)
                # the decoded chunk is flat_wire's argument alone, so it is
                # freed as flat_wire rebinds it (one fp32 chunk less)
                return flat_wire(codec.decode_range(
                    (got[2 * half][r], got[2 * half + 1][r]), a, b).view(
                        -1, block), rnd[blocks], low[blocks]).view(-1)
        else:
            dt = torch.bfloat16 if compression == "bf16" else torch.float32
            got = mean_group.all_gather([wire_p.to(dt), wire_b.to(dt)])

            def row(half, r, a, b):
                return got[half][r].view(-1)[a:b]
        mean_group.mean_(wire_p, partial(row, 0), round16)
        mean_group.mean_(wire_b, partial(row, 1))

    def flat_sync(plane, state):
        """Alg. 4 lines 11-12 over the packed payload, half by half."""
        b2 = state["b2_local"]
        out = {**state, "tprime": torch.zeros_like(state["tprime"])}
        codes = []
        with (contextlib.nullcontext() if group is None
              else mean_group.round_()):
            if compression == "fp32":
                wire_p, wire_b = plane, b2
            elif compression == "int8":
                kw = dict(block=block, use_kernels=opt_cfg.use_kernels,
                          fused=sync_cfg.fused, codes=group is not None)
                wire_p, out["res_params"], *codes = flat_ef_plane(
                    plane, state["res_params"], enc_rnd, enc_low, **kw)
                wire_b, out["res_b2"], *codes_b = flat_ef_plane(
                    b2, state["res_b2"], enc_zero, enc_zero, **kw)
                codes += codes_b
            else:                     # bf16 wire: elementwise EF roundtrip
                wire_p, out["res_params"] = _bf16_ef(
                    plane, state["res_params"], F32_MIN, round16)
                wire_b, out["res_b2"] = _bf16_ef(b2, state["res_b2"], 0.0)
            if group is None:
                fsp.mean_planes(wire_p, round16)
                fsp.mean_planes(wire_b)
            else:
                rank_means(wire_p, wire_b, codes)
        out["b2_sync"] = out["b2_local"] = wire_b
        return wire_p, out

    def step(plane, fstate, batch, *, do_sync: bool):
        # the whole fp32 gradient plane, then this rank's slice of it
        g_full = torch.zeros(fs.batch_shape + (psize,), dtype=torch.float32,
                             device=plane.device)
        dests = fs.unpack(g_full, dtype=torch.float32)
        if pod is None:
            loss, _ = worker_grads(leaf_params(plane), batch, model,
                                   grads=dests, remat=remat)
        else:
            loss = pod.into(leaf_params(plane), batch, dests)
        del dests
        stats = {"loss": loss}
        if opt_cfg.obs_metrics:       # over the per-leaf views, leaf by leaf
            stats["grad_norm"] = opt_lib.global_norm(
                fs.unpack(g_full, dtype=torch.float32), batch_ndim=1)
        a_full = g_full               # raw gradients stay for the statistics
        if opt_cfg.grad_clip > 0:     # clip the per-leaf grads, then pack
            applied, _ = opt_lib.clip_by_global_norm(
                fs.unpack(g_full), opt_cfg.grad_clip, batch_ndim=1)
            a_full = fs.pack(applied)
        g_plane = mine(g_full)
        a_plane = g_plane if a_full is g_full else mine(a_full)
        del g_full, a_full
        step_no = fstate["step"] + 1
        tprime = fstate["tprime"] + 1
        eta, extra = opt_lib.local_scalars(
            opt_cfg.lr, opt_cfg.eps, opt_cfg.warmup_steps, int(step_no[0]),
            int(tprime[0]))
        bs, bl = fstate["b2_sync"], fstate["b2_local"]
        if opt_cfg.use_kernels:
            new_plane, new_b2 = flat_fused_update(
                plane, a_plane, bs, bl, update_scalars(eta, extra, device),
                upd_rnd, y=None if stat == "update_norm" else plane,
                b2_out=None if bl.data_ptr() == bs.data_ptr() else bl)
        else:
            new_plane, new_b2 = flat_fused_update_ref(
                plane, a_plane, bs, bl, eta, extra, rnd16)
        del a_plane
        new_state = {**fstate, "step": step_no, "tprime": tprime,
                     "b2_local": new_b2}
        rows = opt_lib.worker_sums
        if staleness:
            d2, g2 = shard_sums(rows(torch.square(g_plane
                                                  - fstate["g_anchor"])),
                                rows(torch.square(g_plane)))
            stats["drift"] = d2 / (g2 + 1e-12)
        elif stat is not None:
            d2, p2 = shard_sums(rows(torch.square(new_plane - plane)),
                                rows(torch.square(plane)))
            stats["drift"] = torch.sqrt(d2) / (torch.sqrt(p2) + 1e-12)
        metrics = worker_metrics(stats, mean_group)
        if not staleness:
            del g_plane               # freed before the sync round's wires
        if do_sync:
            new_plane, new_state = flat_sync(new_plane, new_state)
            if staleness:
                new_state["g_anchor"] = g_plane
        return new_plane, new_state, metrics

    return (init_fn, partial(step, do_sync=False),
            partial(step, do_sync=True))


# --------------------------------------------------------------------------- #
# abstract input specs (TensorSpecs: never allocated)
# --------------------------------------------------------------------------- #
def train_batch_specs(cfg, shape, n_workers: int = 0):
    """The reference's ``train_batch_specs``: ``TensorSpec``s of a train
    batch, with a leading worker axis of per-worker slices where
    ``n_workers`` > 0."""
    from repro_torch.launch.serving import TensorSpec
    S = shape.seq_len
    if n_workers:
        if shape.global_batch % n_workers:
            raise ValueError(f"{shape.global_batch} rows over {n_workers} "
                             "workers")
        lead = (n_workers, shape.global_batch // n_workers)
    else:
        lead = (shape.global_batch,)
    toks = TensorSpec(lead + (S,), torch.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.cross_attn_every:
        batch["image_embeds"] = TensorSpec(
            lead + (cfg.n_image_tokens, cfg.d_model), torch.bfloat16)
    if cfg.is_encdec:
        batch["audio_frames"] = TensorSpec(lead + (S, cfg.d_model),
                                           torch.bfloat16)
    return batch

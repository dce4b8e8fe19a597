"""Train steps, R workers stacked on one device or one synchronous model.

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
paper's Algorithms 1 and 3, its baselines) one model takes the whole
global batch and ``opt.update(grads, g∘g, ...)`` applies the gradient every
step, as the reference's non-local branch does: plain tensor ops, no
kernel (no Pallas kernel is reachable from that branch either). On one
device there is no all-reduce; ``train_loop`` charges the bytes it would
move.

With ``OptimizerConfig.obs_metrics`` every step also returns
``metrics['grad_norm']``: the L2 norm of the raw (pre-clip) gradients, one
per worker on the local paths, a scalar on the synchronous one.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.core import flatspace as fsp
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.comm import worker_mean_
from repro_torch.core.sync_engine import drift_statistic
from repro_torch.kernels.ref import F32_MIN
from repro_torch.kernels.tiling import round_through_bf16
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


def _sq_norms(pairs) -> torch.Tensor:
    """Per-worker Σ over the given stacked tensors of their squared norms,
    leaf by leaf (no whole-tree temporary)."""
    return sum(torch.sum(torch.square(d), dim=tuple(range(1, d.ndim)))
               for d in pairs)


def _drift_stat(new_params, params) -> torch.Tensor:
    """mean over workers of ||x_i' − x_i|| / (||x_i|| + tiny)."""
    d = torch.sqrt(_sq_norms(n.float() - p.float() for n, p in
                             zip(leaves(new_params), leaves(params))))
    p = torch.sqrt(_sq_norms(p.float() for p in leaves(params)))
    return torch.mean(d / (p + 1e-12))


def _staleness_stat(grads, anchor) -> torch.Tensor:
    """mean over workers of ‖g_i,t − g_i,last_sync‖² / (‖g_i,t‖² + tiny)."""
    d2 = _sq_norms(g.float() - a for g, a in zip(leaves(grads),
                                                 leaves(anchor)))
    g2 = _sq_norms(g.float() for g in leaves(grads))
    return torch.mean(d2 / (g2 + 1e-12))


def worker_grads(params, batch, model, grads=None):
    """Each worker's loss (``model.loss_fn``: xent + aux) and gradient, one
    worker at a time. ``grads`` (stacked like ``params``, any float dtype,
    e.g. fp32 views of a flat plane) receives the gradients; new tensors
    like ``params`` by default. Returns (losses (R,), grads)."""
    if grads is None:
        grads = tree_map(torch.empty_like, params)
    losses = []
    for w in range(leaves(params)[0].shape[0]):
        p_w = tree_map(lambda t: t[w].detach().requires_grad_(), params)
        loss, _ = model.loss_fn(p_w, {k: v[w] for k, v in batch.items()})
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
    n_workers: int
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


def build_train_programs(cfg, opt_cfg, *, n_workers: int,
                         device) -> TrainPrograms:
    if opt_cfg.flat and opt_cfg.name != "local_adaalter":
        raise ValueError("OptimizerConfig.flat requires a local Local "
                         f"AdaAlter run (got optimizer={opt_cfg.name!r})")
    opt = opt_lib.make_optimizer(opt_cfg)
    if not opt_lib.is_local(opt):
        if n_workers != 1:
            raise ValueError(
                f"{opt_cfg.name!r} is a synchronous optimizer: one model "
                "takes the whole global batch (R = 1), so it trains with "
                f"one worker, not {n_workers}. The reference runs a local "
                "optimizer on its synchronous branch only for models over "
                "100 B parameters, which the port does not build")
        return _sync_programs(cfg, opt_cfg, opt, torch.device(device))
    R = n_workers
    device = torch.device(device)
    model = build_model(cfg)
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
        all R workers."""
        params = tree_map(lambda x: x[None].repeat((R,) + (1,) * x.ndim),
                          base_params(seed, base))
        return params, opt.init(params, workers=R)

    def step(params, opt_state, batch, *, do_sync: bool):
        loss, grads = worker_grads(params, batch, model)
        if fused:
            # the kernel bypasses opt.local_step, so the grad_clip wrapper
            # never sees these grads: clip per worker here. `grads` stays
            # raw for the drift statistics, as on the reference.
            applied = grads
            if opt_cfg.grad_clip > 0:
                applied, _ = opt_lib.clip_by_global_norm(
                    grads, opt_cfg.grad_clip, batch_ndim=1)
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
            new_params, new_state = opt.local_step(grads, opt_state, params)
        metrics = {"loss": torch.mean(loss)}
        if opt_cfg.obs_metrics:
            metrics["grad_norm"] = opt_lib.global_norm(grads, batch_ndim=1)
        if staleness:
            metrics["drift"] = _staleness_stat(grads, opt_state["g_anchor"])
        elif stat is not None:
            metrics["drift"] = _drift_stat(new_params, params)
        if do_sync:
            new_params, new_state = opt.sync(new_params, new_state,
                                             mean_over_workers)
            if staleness:
                new_state = {**new_state,
                             "g_anchor": tree_map(lambda g: g.float(), grads)}
        return new_params, new_state, metrics

    local_step = partial(step, do_sync=False)
    sync_step = partial(step, do_sync=True)
    flat_fields = {}
    if opt_cfg.name == "local_adaalter":
        fs = fsp.FlatSpace.build(abstract, batch_ndim=1,
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
                fs, model, opt_cfg, opt, abstract, base_params, device)
    return TrainPrograms(init_fn=init_fn, local_step=local_step,
                         sync_step=sync_step, n_workers=R, H=opt.H,
                         n_payload_leaves=len(leaves(abstract)),
                         is_flat=opt_cfg.flat, **flat_fields)


# --------------------------------------------------------------------------- #
# synchronous steps (sgd, adagrad, adaalter: the paper's baselines)
# --------------------------------------------------------------------------- #
def _sync_programs(cfg, opt_cfg, opt, device) -> TrainPrograms:
    """One model over the global batch; ``opt.update`` every step. Both
    step functions are the same step (a synchronous optimizer has no round
    to skip; ``train_loop`` runs the sync step every step, as the
    reference's H = 1 schedule does)."""
    model = build_model(cfg)
    # Alg. 3 folds g∘g into B²; Alg. 1 and plain SGD never read it, and the
    # reference's compiled step drops it as dead code
    wants_sq = opt_cfg.name == "adaalter"

    def init_fn(seed: int, base=None):
        if base is None:
            base = model.init(torch.Generator(device).manual_seed(seed))
        params = tree_map(lambda x: x.to(device), base)
        return params, opt.init(params)

    def step(params, opt_state, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = model.loss_fn(p, batch)
        grads = unflatten_like(params, list(
            torch.autograd.grad(loss, leaves(p))))
        sq = (tree_map(lambda g: torch.square(g.float()), grads)
              if wants_sq else None)
        new_params, new_state = opt.update(grads, sq, opt_state, params)
        metrics = {"loss": loss.detach()}
        if opt_cfg.obs_metrics:
            metrics["grad_norm"] = opt_lib.global_norm(grads)
        return new_params, new_state, metrics

    n_leaves = len(leaves(model.init(None, "meta")))
    return TrainPrograms(init_fn=init_fn, local_step=step, sync_step=step,
                         n_workers=1, H=1, is_local=False,
                         n_payload_leaves=n_leaves)


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


def _flat_programs(fs, model, opt_cfg, opt, abstract, base_params, device):
    """Local AdaAlter over FlatSpace planes: the update is ONE launch over
    the parameter plane, and the sync round one EF encode of each half of
    the ``[params ‖ B²]`` payload and one mean of each (the halves are
    encoded in place rather than concatenated: at full Big LSTM width the
    concatenation and its wire would take ~27 GB more). Given the same
    schedule the state is bitwise equal to the per-leaf path's, with the
    kernels (the same device expressions) and without them (the plain
    versions mirror each other's cast orders). The loss and the drift
    statistic, summed over the plane rather than leaf by leaf, may differ
    in the last bits.

    The update writes the new b2_local over the old one unless b2_sync
    shares its tensor (right after a sync), and the new parameters over the
    old plane unless the update-norm drift statistic still needs it.
    Returns ``(init_fn, local_step, sync_step)``; the state is
    (plane, {counters + per-state planes})."""
    from repro_torch.kernels.adaalter_update import (LANES,
                                                     flat_fused_update,
                                                     update_scalars)
    from repro_torch.kernels.ref import flat_fused_update_ref
    from repro_torch.kernels.sync_fused import flat_ef_plane

    sync_cfg = opt_cfg.sync
    psize = fs.plane_size
    R = fs.batch_shape[0]
    block = sync_cfg.block
    if psize % block or fs.align % block:
        raise ValueError(f"sync block {block} must divide the FlatSpace "
                         f"alignment {fs.align}")
    compression = sync_cfg.compression or "fp32"
    round16 = fs.round16_ranges()
    # sidecars of one plane row, on the device once: the update's per-row
    # bf16 flags, and the params half's per-block wire rounding and clamp
    upd_rnd = torch.from_numpy(fs.round16_rows(LANES)).to(device)
    enc_rnd = torch.from_numpy(fs.round16_rows(block)).to(device)
    enc_low = torch.full_like(enc_rnd, F32_MIN)
    enc_zero = torch.zeros_like(enc_rnd)
    rnd16 = None
    if not opt_cfg.use_kernels:           # the plain update's element mask
        rnd16 = torch.from_numpy(fs.round16_elems()).to(device)
    stat = drift_statistic(sync_cfg)
    staleness = stat == "grad_staleness"
    state_keys = list(opt.init(abstract, workers=R))

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
                state[k] = fs.pack(tree_map(lambda x: fill.expand(x.shape),
                                            stacked))
        return fs.pack(stacked), state

    def flat_sync(plane, state):
        """Alg. 4 lines 11-12 over the packed payload, half by half."""
        b2 = state["b2_local"]
        out = {**state, "tprime": torch.zeros_like(state["tprime"])}
        if compression == "fp32":
            wire_p, wire_b = plane, b2
        elif compression == "int8":
            kw = dict(block=block, use_kernels=opt_cfg.use_kernels,
                      fused=sync_cfg.fused)
            wire_p, out["res_params"] = flat_ef_plane(
                plane, state["res_params"], enc_rnd, enc_low, **kw)
            wire_b, out["res_b2"] = flat_ef_plane(
                b2, state["res_b2"], enc_zero, enc_zero, **kw)
        else:                         # bf16 wire: elementwise EF roundtrip
            wire_p, out["res_params"] = _bf16_ef(
                plane, state["res_params"], F32_MIN, round16)
            wire_b, out["res_b2"] = _bf16_ef(b2, state["res_b2"], 0.0)
        fsp.mean_planes(wire_p, round16)
        fsp.mean_planes(wire_b)
        out["b2_sync"] = out["b2_local"] = wire_b
        return wire_p, out

    def step(plane, fstate, batch, *, do_sync: bool):
        g_plane = torch.zeros_like(plane)
        loss, _ = worker_grads(fs.unpack(plane), batch, model,
                               grads=fs.unpack(g_plane, dtype=torch.float32))
        a_plane = g_plane             # raw gradients stay for the statistics
        if opt_cfg.grad_clip > 0:     # clip the per-leaf grads, then pack
            applied, _ = opt_lib.clip_by_global_norm(
                fs.unpack(g_plane), opt_cfg.grad_clip, batch_ndim=1)
            a_plane = fs.pack(applied)
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
        metrics = {"loss": torch.mean(loss)}
        if opt_cfg.obs_metrics:       # over the per-leaf views, leaf by leaf
            metrics["grad_norm"] = opt_lib.global_norm(
                fs.unpack(g_plane, dtype=torch.float32), batch_ndim=1)
        if staleness:
            d2 = torch.sum(torch.square(g_plane - fstate["g_anchor"]), -1)
            g2 = torch.sum(torch.square(g_plane), -1)
            metrics["drift"] = torch.mean(d2 / (g2 + 1e-12))
        elif stat is not None:
            d = torch.sqrt(torch.sum(torch.square(new_plane - plane), -1))
            pn = torch.sqrt(torch.sum(torch.square(plane), -1))
            metrics["drift"] = torch.mean(d / (pn + 1e-12))
        if not staleness:
            del g_plane               # freed before the sync round's wires
        if do_sync:
            new_plane, new_state = flat_sync(new_plane, new_state)
            if staleness:
                new_state["g_anchor"] = g_plane
        return new_plane, new_state, metrics

    return (init_fn, partial(step, do_sync=False),
            partial(step, do_sync=True))

"""Train steps of the local optimizers, R workers stacked on one device.

Every parameter and accumulator carries a leading worker axis R, as in the
JAX package's ``launch/steps.py``; replicas diverge between syncs.

* ``local_step`` — H-1 out of H steps — moves nothing between workers;
* ``sync_step`` adds the params + accumulator average (Alg. 4 lines
  11-12): here a mean over axis 0, since the workers are stacked on one
  device, exactly as the reference stacks them on its worker axis.

Each worker's loss and gradient come from its own slice of the stacked
tensors, one worker at a time, so peak memory holds one worker's
activations (at full Big LSTM width, its ~2 GB of float32 logits).

With ``OptimizerConfig.use_kernels`` Local AdaAlter's update is the fused
CUDA kernel, one launch per stacked leaf (``kernels/ops.py``), and an int8
sync round is the one-pass EF kernel, one launch per payload leaf.
Without it the update is the optimizer's own ``local_step``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.core import optimizers as opt_lib
from repro_torch.core.sync_engine import drift_statistic
from repro_torch.models import lstm
from repro_torch.tree import leaves, tree_map


def mean_over_workers(tree):
    """The sync mean: every worker's row replaced by the mean over axis 0,
    written in place. The sync round hands it tensors that nothing else
    holds — the wire values, or the step's freshly updated state — and
    writing over them keeps a second copy of the synced state (10 GB at
    full Big LSTM width with 2 workers) from being allocated."""
    return tree_map(
        lambda x: x.copy_(x.mean(dim=0, keepdim=True).expand_as(x)), tree)


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


def worker_grads(params, batch, cfg):
    """Each worker's loss and gradient, one worker at a time.
    Returns (losses (R,), grads stacked like ``params``)."""
    grads = tree_map(torch.empty_like, params)
    losses = []
    for w in range(leaves(params)[0].shape[0]):
        p_w = tree_map(lambda t: t[w].detach().requires_grad_(), params)
        loss, _ = lstm.loss_fn(p_w, {k: v[w] for k, v in batch.items()}, cfg)
        for dst, g in zip(leaves(grads),
                          torch.autograd.grad(loss, leaves(p_w))):
            dst[w].copy_(g)
        losses.append(loss.detach())
    return torch.stack(losses), grads


@dataclasses.dataclass
class TrainPrograms:
    """Step functions of one run. A step consumes the ``params`` and
    ``opt_state`` it is given, as the JAX package's step donates them: the
    sync round may write over their tensors (``LocalOptimizer``)."""
    init_fn: Callable[..., Any]  # (seed, base=None) -> (params, opt_state)
    local_step: Callable[..., Any]  # (params, opt_state, batch) -> (params, opt_state, metrics)
    sync_step: Callable[..., Any]   # same signature; ends with the sync round
    n_workers: int
    H: int


def build_train_programs(cfg, opt_cfg, *, n_workers: int,
                         device) -> TrainPrograms:
    if cfg.family != "lstm":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet (ROADMAP "
            "Queue 1)")
    opt = opt_lib.make_optimizer(opt_cfg)
    if not opt_lib.is_local(opt):
        raise NotImplementedError(
            f"{opt_cfg.name!r} trains on the synchronous data-parallel path, "
            "which is not ported yet (ROADMAP Queue 1); the port trains the "
            "local optimizers local_sgd and local_adaalter")
    R = n_workers
    device = torch.device(device)
    dtype = getattr(torch, cfg.param_dtype)
    fused = opt_cfg.use_kernels and opt_cfg.name == "local_adaalter"
    stat = drift_statistic(opt_cfg.sync)
    staleness = stat == "grad_staleness"

    def init_fn(seed: int, base=None):
        """Stacked (params, opt_state): ``base`` (one worker's parameters,
        e.g. carried across with ``repro_torch.convert``) or fresh weights
        from a seeded ``torch.Generator``, copied to all R workers."""
        if base is None:
            gen = torch.Generator(device).manual_seed(seed)
            base = lstm.init_lstm(gen, cfg, dtype, device)
        params = tree_map(lambda x: x.to(device)[None].repeat(
            (R,) + (1,) * x.ndim), base)
        return params, opt.init(params, workers=R)

    def step(params, opt_state, batch, *, do_sync: bool):
        loss, grads = worker_grads(params, batch, cfg)
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

    return TrainPrograms(init_fn=init_fn,
                         local_step=partial(step, do_sync=False),
                         sync_step=partial(step, do_sync=True),
                         n_workers=R, H=opt.H)

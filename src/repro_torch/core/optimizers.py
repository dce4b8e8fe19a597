"""The paper's algorithms over nested dicts of tensors.

Algorithm 1  Distributed AdaGrad       -> :func:`adagrad`
Algorithm 2  Local SGD                 -> :func:`local_sgd`
Algorithm 3  Distributed AdaAlter      -> :func:`adaalter`
Algorithm 4  Local AdaAlter            -> :func:`local_adaalter`

The two-level API of the JAX package's ``core/optimizers.py``:

* ``Optimizer`` (init/update) — the fully synchronous methods (Alg. 1, 3),
  consuming the averaged gradient and the averaged squared gradient;
* ``LocalOptimizer`` (init/local_step/sync) — the local methods (Alg. 2, 4):
  ``local_step`` is applied per worker with no communication; ``sync``
  averages parameters (and Local AdaAlter's accumulators) across workers.

Stacked layout: ``init(params, workers=R)`` takes parameters that already
carry a leading worker axis R; every accumulator then carries it too and
the step counters have shape (R,), as ``jax.vmap(opt.init)`` gives. All
updates are elementwise, so one call on the stacked tensors is the
per-worker ``vmap(local_step)`` of the reference.

The step counters ``step``/``tprime`` are int32 tensors kept on the host:
every worker shares them, and the float32 scalars derived from them (η,
t'·ε²) are computed on the host, so a step never waits on the device.
Accumulators are fp32 regardless of the parameter dtype.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map

Tree = Any


def _cast_like(x, ref):
    return x.to(ref.dtype) if x.dtype != ref.dtype else x


def _f32(value, like) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def _first(counter: torch.Tensor) -> int:
    """The shared value of a (possibly per-worker) host counter."""
    return int(counter.reshape(-1)[0])


def _counter(workers: int) -> torch.Tensor:
    return torch.zeros((workers,) if workers else (), dtype=torch.int32)


def warmup_lr(base_lr: float, step: int, warmup_steps: int) -> np.float32:
    """Paper §6.2.1: η_t = η · min(1, t / warm_up_steps), in float32 as the
    jitted reference computes it (XLA turns the division by the constant
    warm-up length into a multiplication by its float32 reciprocal)."""
    if warmup_steps <= 0:
        return np.float32(base_lr)
    inv = np.float32(1.0) / np.float32(warmup_steps)
    return np.float32(base_lr) * np.minimum(np.float32(1.0),
                                            np.float32(step) * inv)


def local_scalars(lr: float, eps: float, warmup_steps: int, step: int,
                  tprime: int) -> Tuple[np.float32, np.float32]:
    """(η_t, t'·ε²) of a Local AdaAlter local step, float32."""
    return (warmup_lr(lr, step, warmup_steps),
            np.float32(tprime) * np.float32(eps * eps))


def worker_sums(t: torch.Tensor) -> torch.Tensor:
    """(R,): the sum of each row of ``t``'s leading (worker) axis, each row
    reduced on its own, so a worker's sum has the same bits whether its
    row is stacked with others or alone on a rank (a reduction over the
    trailing axes of an (R, ...) tensor adds in an order that depends on
    R)."""
    return torch.stack([torch.sum(row) for row in t])


def global_norm(tree: Tree, batch_ndim: int = 0) -> torch.Tensor:
    """fp32 L2 norm over all leaves; with ``batch_ndim=1`` one norm per row
    of the leading (worker) axis, shape (R,) (:func:`worker_sums`)."""
    if batch_ndim not in (0, 1):
        raise ValueError(f"batch_ndim must be 0 or 1, got {batch_ndim}")
    reduce = worker_sums if batch_ndim else torch.sum
    return torch.sqrt(sum(reduce(torch.square(g.float()))
                          for g in leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float, batch_ndim: int = 0,
                        norm: Optional[torch.Tensor] = None):
    """Scale ``grads`` so their global L2 norm is <= ``max_norm``.
    Returns ``(clipped, factor)``; ``max_norm <= 0`` disables clipping.
    ``batch_ndim=1`` clips each worker's gradient independently. ``norm``:
    the global norm, where the caller has it (e.g. summed over the parts
    of sharded leaves); :func:`global_norm` of ``grads`` by default."""
    if max_norm <= 0:
        return grads, 1.0
    if norm is None:
        norm = global_norm(grads, batch_ndim)
    factor = torch.minimum(_f32(1.0, norm), _f32(max_norm, norm)
                           / torch.maximum(norm, _f32(1e-16, norm)))

    def scale(g):
        f = factor.reshape(tuple(factor.shape) + (1,) * (g.ndim - batch_ndim))
        return (g.float() * f).to(g.dtype)

    return tree_map(scale, grads), factor


# --------------------------------------------------------------------------- #
# fully synchronous optimizers (consume averaged gradients)
# --------------------------------------------------------------------------- #
#: the synchronous algorithms: one model, the gradient applied every step
SYNC_OPTIMIZERS = ("sgd", "adagrad", "adaalter")

class Optimizer(NamedTuple):
    init: Callable[..., Tree]
    # update(grads, sq_grads, state, params) -> (new_params, new_state)
    update: Callable[..., Tuple[Tree, Tree]]


def _full_like(value: float):
    return lambda p: torch.full(p.shape, value, dtype=torch.float32,
                                device=p.device)


def sgd(lr: float = 0.1, warmup_steps: int = 0) -> Optimizer:
    def init(params, workers: int = 0):
        return {"step": _counter(workers)}

    def update(grads, sq_grads, state, params):
        step = state["step"] + 1
        eta = warmup_lr(lr, _first(step), warmup_steps)
        new_params = tree_map(
            lambda p, g: p - _cast_like(_f32(eta, g) * g.float(), p),
            params, grads)
        return new_params, {"step": step}

    return Optimizer(init, update)


def adagrad(lr: float = 0.5, eps: float = 1.0, b0: float = 0.0,
            warmup_steps: int = 0) -> Optimizer:
    """Algorithm 1. B²_t += Ḡ_t∘Ḡ_t, THEN x_t = x − η Ḡ_t/sqrt(B²_t + ε²)."""

    def init(params, workers: int = 0):
        return {"step": _counter(workers),
                "b2": tree_map(_full_like(b0 * b0), params)}

    def update(grads, sq_grads, state, params):
        step = state["step"] + 1
        eta = warmup_lr(lr, _first(step), warmup_steps)
        b2 = tree_map(lambda a, g: a + torch.square(g.float()),
                      state["b2"], grads)
        new_params = tree_map(
            lambda p, g, a: p - _cast_like(
                _f32(eta, g) * g.float() / torch.sqrt(a + _f32(eps * eps, a)),
                p),
            params, grads, b2)
        return new_params, {"step": step, "b2": b2}

    return Optimizer(init, update)


def adaalter(lr: float = 0.5, eps: float = 1.0, b0: float = 1.0,
             warmup_steps: int = 0) -> Optimizer:
    """Algorithm 3. x_t = x − η Ḡ_t/sqrt(B²_{t-1} + ε²), THEN
    B²_t = B²_{t-1} + (1/n)Σᵢ Gᵢ∘Gᵢ."""

    def init(params, workers: int = 0):
        return {"step": _counter(workers),
                "b2": tree_map(_full_like(b0 * b0), params)}

    def update(grads, sq_grads, state, params):
        step = state["step"] + 1
        eta = warmup_lr(lr, _first(step), warmup_steps)
        new_params = tree_map(
            lambda p, g, a: p - _cast_like(
                _f32(eta, g) * g.float() / torch.sqrt(a + _f32(eps * eps, a)),
                p),
            params, grads, state["b2"])
        b2 = tree_map(lambda a, s: a + s.float(), state["b2"], sq_grads)
        return new_params, {"step": step, "b2": b2}

    return Optimizer(init, update)


# --------------------------------------------------------------------------- #
# local (communication-skipping) optimizers
# --------------------------------------------------------------------------- #
class LocalOptimizer(NamedTuple):
    """``local_step`` writes over none of its inputs. ``sync`` consumes
    the ``params`` and ``state`` it is given, as the JAX package's jitted
    step donates them: ``mean_fn`` may average in place (the train step's
    ``mean_over_workers`` does), and the error feedback may write the new
    residuals over the old ones (the int8 kernel path does). A caller that
    keeps the state it passes in hands ``sync`` clones."""
    init: Callable[..., Tree]
    # local_step(grads, state, params) -> (new_params, new_state)   [no comm]
    local_step: Callable[..., Tuple[Tree, Tree]]
    # sync(params, state, mean_fn) -> (new_params, new_state)
    sync: Callable[..., Tuple[Tree, Tree]]
    H: int


def _identity(tree):
    return tree


def local_sgd(lr: float = 0.1, H: int = 4,
              warmup_steps: int = 0) -> LocalOptimizer:
    """Algorithm 2: plain local SGD, params averaged every H steps."""

    def init(params, workers: int = 0):
        return {"step": _counter(workers)}

    def local_step(grads, state, params):
        step = state["step"] + 1
        eta = warmup_lr(lr, _first(step), warmup_steps)
        new_params = tree_map(
            lambda p, g: p - _cast_like(_f32(eta, g) * g.float(), p),
            params, grads)
        return new_params, {"step": step}

    def sync(params, state, mean_fn=_identity):
        return mean_fn(params), state

    return LocalOptimizer(init, local_step, sync, H)


def local_adaalter(lr: float = 0.5, eps: float = 1.0, b0: float = 1.0,
                   H: int = 4, warmup_steps: int = 0) -> LocalOptimizer:
    """Algorithm 4 — the paper's main contribution.

    local_step:  t' = tprime + 1 ; y = x − η_t·G/sqrt(b2_sync + t'·ε²) ;
                 b2_local += G∘G
    sync:        x <- mean(x) ; b2_local <- mean(b2_local) ;
                 b2_sync <- b2_local ; tprime <- 0
    """

    def init(params, workers: int = 0):
        return {"step": _counter(workers), "tprime": _counter(workers),
                "b2_sync": tree_map(_full_like(b0 * b0), params),
                "b2_local": tree_map(_full_like(b0 * b0), params)}

    def local_step(grads, state, params):
        step = state["step"] + 1
        tprime = state["tprime"] + 1
        eta, extra = local_scalars(lr, eps, warmup_steps, _first(step),
                                   _first(tprime))
        new_params = tree_map(
            lambda p, g, a: p - _cast_like(
                _f32(eta, g) * g.float() / torch.sqrt(a + _f32(extra, a)), p),
            params, grads, state["b2_sync"])
        b2_local = tree_map(lambda a, g: a + torch.square(g.float()),
                            state["b2_local"], grads)
        return new_params, {"step": step, "tprime": tprime,
                            "b2_sync": state["b2_sync"], "b2_local": b2_local}

    def sync(params, state, mean_fn=_identity):
        new_params = mean_fn(params)
        b2 = mean_fn(state["b2_local"])
        # b2_sync and b2_local share the averaged tensors. The next local
        # step reads b2_sync and returns a new b2_local, so the next sync's
        # in-place mean writes over that new tensor, never over b2_sync
        return new_params, {"step": state["step"],
                            "tprime": torch.zeros_like(state["tprime"]),
                            "b2_sync": b2, "b2_local": b2}

    return LocalOptimizer(init, local_step, sync, H)


# --------------------------------------------------------------------------- #
# gradient clipping
# --------------------------------------------------------------------------- #
def with_grad_clip(opt, max_norm: float):
    """Global-norm-clip gradients before every update/local_step.

    For an :class:`Optimizer` the averaged gradient is clipped and
    ``sq_grads`` rescaled by factor²; for a :class:`LocalOptimizer` each
    worker's gradient is clipped independently (stacked state, counters of
    shape (R,), clips per row of the worker axis — the reference's vmap).
    ``max_norm <= 0`` returns the optimizer unchanged.
    """
    if max_norm <= 0:
        return opt
    if isinstance(opt, LocalOptimizer):
        def local_step(grads, state, params):
            bnd = 1 if state["step"].ndim > 0 else 0
            clipped, _ = clip_by_global_norm(grads, max_norm, bnd)
            return opt.local_step(clipped, state, params)

        return LocalOptimizer(opt.init, local_step, opt.sync, opt.H)

    def update(grads, sq_grads, state, params):
        clipped, factor = clip_by_global_norm(grads, max_norm)
        sq = None
        if sq_grads is not None:      # None where the update never reads it
            sq = tree_map(
                lambda s: (s.float() * torch.square(factor)).to(s.dtype),
                sq_grads)
        return opt.update(clipped, sq, state, params)

    return Optimizer(opt.init, update)


# --------------------------------------------------------------------------- #
# compressed sync (error-feedback residual state around the base sync)
# --------------------------------------------------------------------------- #
_RESIDUAL_KEYS = ("res_params", "res_b2")


def compressed_sync(base: LocalOptimizer, compression="int8", *,
                    block: int = 256, use_kernels: bool = False,
                    fused: bool = True) -> LocalOptimizer:
    """Wrap a LocalOptimizer so its sync payload rides a lossy wire codec
    with error feedback (numerics in ``core.sync_engine.ef_apply``):

        v = payload + residual ; v̂ = codec.roundtrip(v)
        residual' = v − v̂ ;      synced = mean_workers(v̂)

    The payload is params (and ``b2_local`` for Local AdaAlter). State gains
    ``res_params`` and ``res_b2`` leaves mirroring the param tree. A
    lossless codec returns ``base`` unchanged.

    Like every ``LocalOptimizer.sync``, this one consumes its inputs: with
    ``use_kernels`` the int8 encode writes the new residuals over the
    ``res_params`` and ``res_b2`` tensors it is given (at full Big LSTM
    width this saves ~13 GB per round), and ``mean_fn`` gets the fresh wire
    tensors.

    ``sync``'s ``payload_mean(wires, payloads, decode)``, given (a run with
    one worker a rank, ``launch/steps.py::RankMean.of_payloads``), takes
    the round's means from the wire as it travels between ranks, each
    leaf's encoded payload (the int8 codes and scales), and writes them
    over the wire tensors; ``decode(payload, like, start, stop)``
    (``core.sync_engine.ef_decode_range``) turns a range of a rank's
    payload into its wire values. The base sync then takes no mean.
    """
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.sync_engine import ef_apply, ef_decode_range

    codec = get_codec(compression, block=block, use_kernels=use_kernels,
                      fused=fused)
    if codec.lossless:
        return base

    def init(params, workers: int = 0):
        state = base.init(params, workers)
        state["res_params"] = tree_map(_full_like(0.0), params)
        if "b2_local" in state:
            state["res_b2"] = tree_map(_full_like(0.0), params)
        return state

    def local_step(grads, state, params):
        inner = {k: v for k, v in state.items() if k not in _RESIDUAL_KEYS}
        new_params, new_inner = base.local_step(grads, inner, params)
        for k in _RESIDUAL_KEYS:
            if k in state:
                new_inner[k] = state[k]
        return new_params, new_inner

    def sync(params, state, mean_fn=_identity, payload_mean=None,
             encode=None):
        inner = {k: v for k, v in state.items() if k not in _RESIDUAL_KEYS}
        # stacked state (counters of shape (R,)): quantization blocks never
        # straddle workers, each of whom sends its own payload
        bnd = 1 if state["step"].ndim > 0 else 0
        codes = payload_mean is not None
        if encode is None:
            encode = partial(ef_apply, codec=codec, batch_ndim=bnd)
        wire_p, res_p, *pay_p = encode(params, state["res_params"],
                                       codes=codes)
        res_b2 = None
        if "res_b2" in state:
            wire_b2, res_b2, *pay_b2 = encode(
                inner["b2_local"], state["res_b2"], clamp_nonneg=True,
                codes=codes)
            inner = {**inner, "b2_local": wire_b2}
        if codes:     # the base sync's means, taken from the payloads
            payload_mean(wire_p, pay_p[0], partial(ef_decode_range, codec))
            if res_b2 is not None:
                payload_mean(wire_b2, pay_b2[0], partial(
                    ef_decode_range, codec, clamp_nonneg=True))
            mean_fn = _identity
        new_params, new_inner = base.sync(wire_p, inner, mean_fn)
        new_inner["res_params"] = res_p
        if res_b2 is not None:
            new_inner["res_b2"] = res_b2
        return new_params, new_inner

    return LocalOptimizer(init, local_step, sync, base.H)


# --------------------------------------------------------------------------- #
# gradient-staleness anchor (CADA-proper drift statistic)
# --------------------------------------------------------------------------- #
_ANCHOR_KEY = "g_anchor"


def with_grad_anchor(opt: LocalOptimizer) -> LocalOptimizer:
    """Carry a per-worker ``g_anchor`` leaf: the gradient seen at the last
    sync round, against which ``drift_metric='grad_staleness'`` measures
    ‖g_t − g_anchor‖². The train step writes it on sync steps."""

    def init(params, workers: int = 0):
        state = opt.init(params, workers)
        state[_ANCHOR_KEY] = tree_map(_full_like(0.0), params)
        return state

    def local_step(grads, state, params):
        inner = {k: v for k, v in state.items() if k != _ANCHOR_KEY}
        new_params, new_inner = opt.local_step(grads, inner, params)
        new_inner[_ANCHOR_KEY] = state[_ANCHOR_KEY]
        return new_params, new_inner

    def sync(params, state, mean_fn=_identity):
        inner = {k: v for k, v in state.items() if k != _ANCHOR_KEY}
        new_params, new_inner = opt.sync(params, inner, mean_fn)
        new_inner[_ANCHOR_KEY] = state[_ANCHOR_KEY]
        return new_params, new_inner

    return LocalOptimizer(init, local_step, sync, opt.H)


# --------------------------------------------------------------------------- #
# factory
# --------------------------------------------------------------------------- #
def make_optimizer(cfg) -> Any:
    """cfg: OptimizerConfig -> Optimizer | LocalOptimizer.

    Assembly order: base algorithm -> ``with_grad_clip`` ->
    ``with_grad_anchor`` (adaptive policy on gradient staleness) ->
    ``compressed_sync`` (wire codec + error feedback on sync rounds).
    """
    sync = cfg.sync
    compression = sync.compression
    if cfg.name in SYNC_OPTIMIZERS:
        if compression and compression != "fp32":
            raise ValueError(
                f"compression={compression!r} requires a local optimizer "
                f"(local_sgd / local_adaalter), got {cfg.name!r}")
        if cfg.name == "sgd":
            opt = sgd(cfg.lr, cfg.warmup_steps)
        elif cfg.name == "adagrad":
            opt = adagrad(cfg.lr, cfg.eps, cfg.b0, cfg.warmup_steps)
        else:
            opt = adaalter(cfg.lr, cfg.eps, cfg.b0, cfg.warmup_steps)
        return with_grad_clip(opt, cfg.grad_clip)
    if cfg.name == "local_sgd":
        opt = local_sgd(cfg.lr, cfg.H, cfg.warmup_steps)
    elif cfg.name == "local_adaalter":
        opt = local_adaalter(cfg.lr, cfg.eps, cfg.b0, cfg.H, cfg.warmup_steps)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    opt = with_grad_clip(opt, cfg.grad_clip)
    from repro_torch.core.sync_engine import drift_statistic
    if drift_statistic(sync) == "grad_staleness":
        opt = with_grad_anchor(opt)
    if compression:
        opt = compressed_sync(opt, compression, block=sync.block,
                              use_kernels=cfg.use_kernels, fused=sync.fused)
    return opt


def is_local(opt) -> bool:
    return isinstance(opt, LocalOptimizer)

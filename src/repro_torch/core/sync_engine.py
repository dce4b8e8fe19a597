"""The sync round as one owned subsystem: SyncEngine = policy + codec + kernel.

  *when*  a host-side :class:`~repro_torch.core.sync_policy.SyncPolicy`;
  *what*  a :class:`~repro_torch.core.codecs.WireCodec`;
  *how*   the device-side error-feedback encode — the codec's one-pass
          kernel or the generic encode/decode composition
          (:func:`ef_apply` picks).

:class:`SyncEngine` composes the three behind the object ``train_loop``
drives, and answers the accounting queries ``TrainResult`` reports. Its
:class:`SyncState` is the policy's schedule-critical host state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.codecs import WireCodec, get_codec
from repro_torch.core.sync_policy import SyncPolicy, make_sync_policy
from repro_torch.kernels.ref import F32_MIN
from repro_torch.tree import leaves, unflatten_like

Tree = Any

#: drift statistics the local steps can emit for the adaptive policy.
DRIFT_METRICS = ("update_norm", "grad_staleness")

#: policy names that consume ``metrics['drift']``.
_DRIFT_CONSUMERS = ("adaptive",)


def drift_statistic(sync_cfg) -> Optional[str]:
    """Which drift statistic the steps must emit for this SyncConfig —
    ``None`` unless a drift-consuming policy is configured."""
    return (sync_cfg.drift_metric if sync_cfg.policy in _DRIFT_CONSUMERS
            else None)


@dataclasses.dataclass
class SyncState:
    """Schedule-critical host state of the sync policy: ``since`` completed
    local steps since the last sync, ``drift`` accumulated over them
    (float64, as the host accumulates it)."""

    since: np.ndarray
    drift: np.ndarray

    @staticmethod
    def make(since: int = 0, drift: float = 0.0) -> "SyncState":
        return SyncState(since=np.asarray(since, np.int64),
                         drift=np.asarray(drift, np.float64))


def ef_apply(tree: Tree, residual: Tree, codec: WireCodec, batch_ndim: int,
             *, clamp_nonneg: bool = False, codes: bool = False):
    """-> (wire values cast like ``tree``, new residual), per leaf:

        v     = x + e                       # fp32
        v̂     = codec.roundtrip(v)          # what the wire carries
        wire  = max(v̂, lower) cast to x.dtype
        e'    = v − wire

    ``lower`` is 0 for accumulator payloads (they feed rsqrt) and
    float32-min otherwise. A codec with a one-pass ``ef_roundtrip`` (int8)
    runs the whole chain in one pass per leaf. Blocked codecs never let a
    block straddle the leading ``batch_ndim`` (per-worker) axes. With
    ``codes`` a third element lists each leaf's encoded payload
    (``codec.encode(v)``; :func:`ef_decode` of it gives the leaf's wire).
    """
    flat_x = leaves(tree)
    flat_e = leaves(residual)
    if codec.ef_roundtrip is not None:
        outs = [codec.ef_roundtrip(x, e, min(batch_ndim, x.ndim),
                                   clamp_nonneg, codes=codes)
                for x, e in zip(flat_x, flat_e)]
        out = (unflatten_like(tree, [o[0] for o in outs]),
               unflatten_like(tree, [o[1] for o in outs]))
        return (*out, [o[2] for o in outs]) if codes else out
    wires, residuals, payloads = [], [], []
    for x, e in zip(flat_x, flat_e):
        v = x.float() + e
        bnd = min(batch_ndim, v.ndim)
        payload = codec.encode(v, bnd)
        w = ef_decode(codec, payload, x, bnd, clamp_nonneg)
        wires.append(w)
        residuals.append(v - w.float())
        if codes:                 # else each leaf's payload is freed here
            payloads.append(payload)
    out = unflatten_like(tree, wires), unflatten_like(tree, residuals)
    return (*out, payloads) if codes else out


def ef_decode(codec: WireCodec, payload, like, batch_ndim: int,
              clamp_nonneg: bool = False):
    """The wire values of one leaf from its encoded payload: decoded,
    clamped below as :func:`ef_apply` clamps them, cast like ``like``."""
    return _clamp_cast(codec.decode(payload, like.shape, batch_ndim),
                       like.dtype, clamp_nonneg)


def ef_decode_range(codec: WireCodec, payload, like, start: int, stop: int,
                    clamp_nonneg: bool = False):
    """Elements ``start:stop`` of one worker row's wire values (``like``
    that row) from the row's encoded payload, as it travels between ranks:
    ``codec.decode_range``, clamped and cast as :func:`ef_decode`."""
    return _clamp_cast(codec.decode_range(payload, start, stop), like.dtype,
                       clamp_nonneg)


def _clamp_cast(vq, dtype, clamp_nonneg: bool):
    lower = torch.as_tensor(0.0 if clamp_nonneg else F32_MIN,
                            dtype=torch.float32, device=vq.device)
    return torch.maximum(vq, lower).to(dtype)


class SyncEngine:
    """One object owning the sync round end-to-end.

    Host protocol: reset(start_step) -> want_sync(step) -> [run step] ->
    observe(...); plus the accounting queries TrainResult reports.
    """

    def __init__(self, policy: SyncPolicy, codec: WireCodec, *,
                 algorithm: str = "local_adaalter", H: int = 1,
                 drift_metric: str = "update_norm",
                 block: int = 256) -> None:
        if drift_metric not in DRIFT_METRICS:
            raise ValueError(f"unknown drift_metric {drift_metric!r} "
                             f"(expected one of {DRIFT_METRICS})")
        self.policy = policy
        self.codec = codec
        self.algorithm = algorithm
        self.H = H
        self.drift_metric = drift_metric
        self.block = block

    # ---------------- schedule (delegates to the policy) ----------------- #
    def reset(self, start_step: int = 0) -> None:
        self.policy.reset(start_step)

    def want_sync(self, step: int) -> bool:
        return self.policy.want_sync(step)

    def observe(self, step: int, synced: bool,
                metrics: Optional[Dict[str, float]] = None) -> None:
        self.policy.observe(step, synced, metrics)

    @property
    def name(self) -> str:
        return self.policy.name

    @property
    def sync_count(self) -> int:
        return self.policy.sync_count

    @property
    def sync_steps(self) -> List[int]:
        return self.policy.sync_steps

    @property
    def wants_drift(self) -> bool:
        """Whether the steps must emit ``metrics['drift']``."""
        return self.policy.name in _DRIFT_CONSUMERS

    def export_state(self) -> SyncState:
        since, drift = self.policy.host_state()
        return SyncState.make(since, drift)

    def import_state(self, state: SyncState) -> None:
        self.policy.load_host_state(int(np.asarray(state.since)),
                                    float(np.asarray(state.drift)))

    # ---------------- accounting ------------------------------------------ #
    def round_bytes(self, n_params: int) -> float:
        """Per-worker wire bytes of ONE sync round under this codec."""
        return comm.sync_payload_bytes(
            self.algorithm, n_params, compression=self.codec,
            block=self.block)

    def round_bytes_per_shard(self, n_params: int, n_shards: int = 1
                              ) -> float:
        """Per-device wire bytes of one sync round when each worker's plane
        is split ``n_shards`` ways: ``round_bytes / n_shards`` (the number
        the alpha-beta model and the replay charge a device's collective
        with). ``n_shards == 1`` is :meth:`round_bytes`."""
        return self.round_bytes(n_params) / max(1, int(n_shards))

    def modeled_bytes_per_step(self, n_params: int) -> float:
        """The static fixed-H formula (the paper's 2P/H claim)."""
        return comm.sync_bytes_per_step(
            self.algorithm, n_params, self.H, compression=self.codec,
            block=self.block)

    def grad_allreduce_bytes(self, n_params: int) -> float:
        """Per-step gradient all-reduce of synchronous execution: what
        moves when there is no sync round to skip."""
        return comm.payload_bytes(n_params)

    def encode_hbm_bytes(self, n_params: int, *,
                         fused: Optional[bool] = None) -> float:
        """Modeled device-memory traffic of one int8 EF encode
        (``comm.ef_sync_hbm_bytes``); other codecs run no such pipeline,
        so asking is a caller bug."""
        if self.codec.name != "int8":
            raise ValueError(
                f"ef_sync_hbm_bytes models the int8 quantize pipeline; "
                f"this engine's codec is {self.codec.name!r}")
        if fused is None:
            fused = self.codec.ef_roundtrip is not None
        return comm.ef_sync_hbm_bytes(
            int(n_params * comm.sync_round_multiplier(self.algorithm)),
            fused=fused, block=self.block)

    def modeled_encode_hbm_bytes(self, n_params: int) -> float:
        """Modeled device-memory traffic of one sync round's EF encode for
        any codec (the trace's ``ef_encode`` span): int8 the pipeline model
        above, bf16 one pass reading x and the residual and writing the
        wire and the residual (16 bytes an element), fp32 none."""
        if self.codec.name == "int8":
            return self.encode_hbm_bytes(n_params)
        n = int(n_params * comm.sync_round_multiplier(self.algorithm))
        if self.codec.name == "bf16":
            return 16.0 * n
        return 0.0

    def round_collectives(self, n_payload_leaves: int, *,
                          flat: bool = False) -> int:
        """Collectives ONE sync round issues: one for the flat plane's
        single wire array, else one per payload leaf times the algorithm's
        round multiplier."""
        return comm.round_collectives(self.algorithm, n_payload_leaves,
                                      flat=flat)

    def __repr__(self) -> str:
        return (f"SyncEngine(policy={self.policy.name!r}, "
                f"codec={self.codec.name!r}, H={self.H}, "
                f"drift_metric={self.drift_metric!r}, "
                f"fused={self.codec.ef_roundtrip is not None})")


def make_sync_engine(opt_cfg, *, is_local: bool = True,
                     H: int = 0) -> SyncEngine:
    """OptimizerConfig (with its SyncConfig block) -> SyncEngine."""
    sync = opt_cfg.sync
    policy = make_sync_policy(opt_cfg, is_local=is_local, H=H)
    codec = get_codec(sync.compression, block=sync.block,
                      use_kernels=opt_cfg.use_kernels, fused=sync.fused)
    return SyncEngine(policy, codec, algorithm=opt_cfg.name,
                      H=H or opt_cfg.H, drift_metric=sync.drift_metric,
                      block=sync.block)

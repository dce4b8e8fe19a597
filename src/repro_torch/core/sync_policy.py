"""Pluggable *when-to-sync* decision for local (communication-skipping) SGD.

The paper fixes the sync period at H (Alg. 2/4: average every H-th step).
This module makes that decision a first-class, host-side policy consulted by
``train_loop`` between compiled steps, so the schedule can instead react to
the training dynamics (CADA lineage — Chen et al. 2020, PAPERS.md):

  fixed_h    the paper's schedule: sync when ``(step+1) % H == 0``, anchored
             at global step 0 so a checkpoint restore into the middle of an
             H-window continues the *pre-restore* schedule bit-identically;
  adaptive   accumulate the cheap device-side divergence statistic the step
             functions emit (``metrics['drift']``: per-worker parameter-drift
             norm of the step, relative to the parameter norm) and trigger
             the sync round once the accumulated drift since the last sync
             crosses ``threshold`` — never before ``h_min`` local steps,
             always by ``h_max``.

A copy of the JAX package's ``core/sync_policy.py``. Policies are pure
host-side Python: the policy only picks whether the next step is a local
step or a sync step. Every policy records the *measured* sync schedule (``sync_count`` /
``sync_steps``) so ``TrainResult`` reports what actually moved instead of
the static ``2P/H`` formula — which a mid-window restore silently violates.

Degenerate cases (tested): ``threshold=0`` syncs every ``h_min`` steps,
``threshold=inf`` every ``h_max``; ``h_min == h_max == H`` is fixed-H
regardless of drift.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

#: policy names accepted by OptimizerConfig.sync_policy / --sync-policy.
POLICY_NAMES = ("fixed_h", "adaptive")


class SyncPolicy:
    """Host-side sync schedule. Subclasses implement :meth:`want_sync`.

    Protocol (driven by ``launch.train.train_loop``):
      reset(start_step)          once before the loop (restore re-anchor);
      want_sync(step)            pick sync_step vs local_step for ``step``;
      observe(step, synced, metrics)
                                 after the step ran — feeds back the
                                 divergence stat and records the schedule.
    """

    name = "base"

    def __init__(self) -> None:
        self.sync_count = 0
        self.sync_steps: List[int] = []

    def reset(self, start_step: int = 0) -> None:
        self.sync_count = 0
        self.sync_steps = []

    def want_sync(self, step: int) -> bool:
        raise NotImplementedError

    def observe(self, step: int, synced: bool,
                metrics: Dict[str, float] | None = None) -> None:
        if synced:
            self.sync_count += 1
            self.sync_steps.append(step)

    def host_state(self) -> Tuple[int, float]:
        """(window position, drift accumulator) — the schedule-critical
        state a checkpoint must carry (``core.sync_engine.SyncState``).
        Stateless policies (fixed_h anchors on the global step) have none.
        """
        return 0, 0.0

    def load_host_state(self, since: int, drift: float) -> None:
        """Inverse of :meth:`host_state`; no-op for stateless policies."""


class FixedHPolicy(SyncPolicy):
    """The paper's schedule: sync on every H-th global step.

    Anchored to global step 0 (not the restore point), so restoring a
    checkpoint saved mid-window keeps the exact pre-restore schedule — the
    property the bit-identity tests pin down.
    """

    name = "fixed_h"

    def __init__(self, H: int) -> None:
        super().__init__()
        if H < 1:
            raise ValueError(f"H must be >= 1, got {H}")
        self.H = H

    def want_sync(self, step: int) -> bool:
        return (step + 1) % self.H == 0


class AdaptiveSyncPolicy(SyncPolicy):
    """CADA-style divergence-triggered sync, bounded by [h_min, h_max].

    The k-th local step since the last sync (k = 1, 2, ...) is a sync step
    iff ``k >= h_max`` or (``k >= h_min`` and the drift accumulated from the
    steps since the last sync ``>= threshold``). The drift of the step being
    decided is not yet known — the policy is consulted *before* the step
    runs — so the trigger always lags the statistic by one step, which is
    what keeps the decision free (no extra device round-trip).
    """

    name = "adaptive"

    def __init__(self, threshold: float, h_min: int = 1,
                 h_max: int = 16) -> None:
        super().__init__()
        if h_min < 1:
            raise ValueError(f"h_min must be >= 1, got {h_min}")
        if h_max < h_min:
            raise ValueError(f"h_max ({h_max}) must be >= h_min ({h_min})")
        if threshold < 0 or math.isnan(threshold):
            raise ValueError(f"sync_threshold must be >= 0, got {threshold}")
        self.threshold = float(threshold)
        self.h_min = h_min
        self.h_max = h_max
        self._since = 0          # completed local steps since last sync
        self._drift = 0.0        # accumulated divergence since last sync

    def reset(self, start_step: int = 0) -> None:
        super().reset(start_step)
        # Without a restored SyncState the window re-anchors at the restore
        # point (conservative: at most h_max extra local steps vs the
        # uninterrupted run); ``load_host_state`` afterwards resumes the
        # exact pre-save window instead.
        self._since = 0
        self._drift = 0.0

    def host_state(self) -> Tuple[int, float]:
        return self._since, self._drift

    def load_host_state(self, since: int, drift: float) -> None:
        self._since = int(since)
        self._drift = float(drift)

    def want_sync(self, step: int) -> bool:
        k = self._since + 1
        if k >= self.h_max:
            return True
        if k < self.h_min:
            return False
        return self._drift >= self.threshold

    def observe(self, step: int, synced: bool,
                metrics: Dict[str, float] | None = None) -> None:
        super().observe(step, synced, metrics)
        if synced:
            self._since = 0
            self._drift = 0.0
        else:
            self._since += 1
            if metrics is not None:
                self._drift += float(metrics.get("drift", 0.0))


def make_sync_policy(cfg, *, is_local: bool = True, H: int = 0) -> SyncPolicy:
    """OptimizerConfig -> SyncPolicy.

    ``H`` overrides ``cfg.H`` (train_loop passes the resolved programs.H;
    synchronous optimizers get H=1 == sync every step). ``cfg.h_max == 0``
    defaults to ``4 * H`` so plain ``--sync-policy adaptive`` brackets the
    paper's period from both sides.
    """
    name = getattr(cfg, "sync_policy", "fixed_h") or "fixed_h"
    H = H or getattr(cfg, "H", 1)
    if name == "fixed_h":
        return FixedHPolicy(H)
    if name == "adaptive":
        if not is_local:
            raise ValueError(
                "sync_policy='adaptive' requires local-SGD execution: a "
                "local optimizer (local_sgd / local_adaalter) AND a "
                "parallelism plan with a worker axis (plan.local_axes). "
                "This run executes fully synchronously — gradients are "
                "all-reduced every step, so there is no sync to skip")
        h_max = getattr(cfg, "h_max", 0) or 4 * H
        return AdaptiveSyncPolicy(
            threshold=getattr(cfg, "sync_threshold", 0.0),
            h_min=max(1, getattr(cfg, "h_min", 1)),
            h_max=h_max)
    raise ValueError(f"unknown sync_policy {name!r} "
                     f"(expected one of {POLICY_NAMES})")

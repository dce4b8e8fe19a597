"""Step-level timeline recorder: structured spans on one monotonic clock.

The port's copy of the JAX package's ``trace/events.py``: the same span
kinds, the same versioned JSON (``SCHEMA_VERSION`` 1), so either package
loads, exports and replays the other's traces. A run is recorded as a
stream of spans, one timeline row per worker:

  local_step   one train step, host-measured; the span covers the step and
               ``torch.cuda.synchronize``, so the device's work is inside
               it (the health probe runs after it). Carries the sync
               decision the ``SyncEngine`` took (``synced``, the window
               position ``sync_since`` and drift ``sync_drift`` at decision
               time, the step's ``drift``), the loss, and under
               instrumentation the health numbers of
               :func:`health_span_args` (``grad_norm``, ``b2``). Port
               traces carry no ``hlo_optimal_s``: there is no HLO on the
               card;
  ef_encode    the device-side error-feedback encode of one sync round,
               MODELED: ``SyncEngine.modeled_encode_hbm_bytes`` over the
               card's HBM rate (``repro_torch.hardware``);
  collective   the wire transfer of one sync round, MODELED by the
               alpha-beta ``core.comm.FabricModel`` (workers stacked on one
               card move no bytes between cards);
  ckpt         one checkpoint save, host-measured;
  eval         host-side logging, host-measured.

All host times share ``time.perf_counter``, rebased so the first span
starts at 0. Modeled spans are flagged ``modeled=True`` and laid out after
the step span that produced them. Non-finite floats are tagged in the
JSON (strict RFC JSON, which Perfetto needs).
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

#: the span vocabulary — new kinds require a schema version bump.
SPAN_KINDS = ("local_step", "ef_encode", "collective", "ckpt", "eval")

#: bump when the JSON layout changes shape (not when meta grows keys).
SCHEMA_VERSION = 1


def to_jsonable(x: Any) -> Any:
    """Strict-JSON encode: tag non-finite floats (a supported
    ``--sync-threshold inf`` lands in the meta) instead of letting
    ``json.dump`` emit the non-RFC ``Infinity`` literal Perfetto and
    ``chrome://tracing`` reject. Inverse: :func:`from_jsonable`."""
    if isinstance(x, float) and not math.isfinite(x):
        return {"__nonfinite__": "inf" if x > 0 else
                "-inf" if x < 0 else "nan"}
    if isinstance(x, dict):
        return {k: to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    return x


def from_jsonable(x: Any) -> Any:
    if isinstance(x, dict):
        if set(x) == {"__nonfinite__"}:
            return float(x["__nonfinite__"])
        return {k: from_jsonable(v) for k, v in x.items()}
    if isinstance(x, list):
        return [from_jsonable(v) for v in x]
    return x


@dataclasses.dataclass
class Span:
    """One timed interval on one worker's timeline row.

    ``t0``/``dur`` are seconds on the trace's rebased perf_counter clock.
    ``modeled`` marks durations that come from the fabric/roofline models
    rather than a host measurement. ``args`` is free-form JSON-safe detail
    (loss, drift, codec, wire bytes, ...).
    """

    name: str
    worker: int
    step: int
    t0: float
    dur: float
    modeled: bool = False
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "worker": self.worker, "step": self.step,
                "t0": self.t0, "dur": self.dur, "modeled": self.modeled,
                "args": dict(self.args)}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Span":
        return Span(name=d["name"], worker=int(d["worker"]),
                    step=int(d["step"]), t0=float(d["t0"]),
                    dur=float(d["dur"]), modeled=bool(d["modeled"]),
                    args=dict(d.get("args", {})))


@dataclasses.dataclass
class Trace:
    """A recorded run: metadata + the span stream, JSON round-trippable."""

    meta: Dict[str, Any]
    spans: List[Span]

    @property
    def workers(self) -> List[int]:
        return sorted({s.worker for s in self.spans})

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def to_dict(self) -> Dict[str, Any]:
        return {"version": SCHEMA_VERSION, "meta": dict(self.meta),
                "spans": [s.to_dict() for s in self.spans]}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Trace":
        v = d.get("version")
        if v != SCHEMA_VERSION:
            raise ValueError(f"trace schema version {v!r} != {SCHEMA_VERSION}")
        return Trace(meta=dict(d.get("meta", {})),
                     spans=[Span.from_dict(s) for s in d.get("spans", [])])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(to_jsonable(self.to_dict()), f, indent=1,
                      allow_nan=False)

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            return Trace.from_dict(from_jsonable(json.load(f)))


def health_span_args(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The subset of a ``obs.health.SyncHealthProbe.step_summary`` that
    belongs on the step span: ``grad_norm`` and the per-bucket ``b2``
    quantile summary. The trace and the metrics registry are fed from the
    SAME summary dict, so the two exports report the same numbers (drift
    already rides the span as the replay engine's input; the sync-round
    residual/MSE probes stay registry-only — they describe the round, not
    the step). Values are already plain floats (JSON-safe, lossless
    round-trip through save/load and the Chrome exporter)."""
    out: Dict[str, Any] = {}
    if "grad_norm" in summary:
        out["grad_norm"] = summary["grad_norm"]
    if "b2" in summary:
        out["b2"] = {name: dict(qs) for name, qs in summary["b2"].items()}
    return out


class TraceRecorder:
    """Builds a :class:`Trace` while a run executes.

    All timestamps come from :meth:`now` — ``time.perf_counter`` rebased to
    the recorder's first call — so every span shares one monotonic clock
    (the train loop's own wall measurement uses the same source).
    """

    def __init__(self, meta: Optional[Dict[str, Any]] = None) -> None:
        self.meta: Dict[str, Any] = dict(meta or {})
        self.spans: List[Span] = []
        self._origin: Optional[float] = None

    # ---------------- clock ---------------------------------------------- #
    def now(self) -> float:
        t = time.perf_counter()
        if self._origin is None:
            self._origin = t
        return t - self._origin

    # ---------------- recording ------------------------------------------ #
    def add(self, name: str, *, worker: int = 0, step: int = -1,
            t0: float, dur: float, modeled: bool = False,
            **args: Any) -> Span:
        if name not in SPAN_KINDS:
            raise ValueError(f"unknown span kind {name!r} "
                             f"(expected one of {SPAN_KINDS})")
        span = Span(name=name, worker=worker, step=step, t0=t0, dur=dur,
                    modeled=modeled, args=args)
        self.spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, *, worker: int = 0, step: int = -1,
             **args: Any) -> Iterator[Dict[str, Any]]:
        """Host-measured span context; the yielded dict lets the body attach
        args computed inside the interval. The partial interval is recorded
        even when the body raises (a crash is exactly when the timeline
        matters)."""
        t0 = self.now()
        try:
            yield args
        finally:
            self.add(name, worker=worker, step=step, t0=t0,
                     dur=self.now() - t0, **args)

    # ---------------- finalize -------------------------------------------- #
    def freeze(self) -> Trace:
        return Trace(meta=dict(self.meta), spans=list(self.spans))

    def save(self, path: str) -> None:
        self.freeze().save(path)

"""Lossless Chrome ``trace_event`` export: open a recorded run in Perfetto.

The port's copy of the JAX package's ``trace/chrome.py``. ``to_chrome``
maps the span stream onto the Trace Event Format that ``chrome://tracing``
and https://ui.perfetto.dev render: one process per worker, one thread row
per span kind, complete ``"X"`` events in microseconds, and one flow arrow
per worker per sync round (step span -> its ``collective`` span). Every
``"X"`` event embeds its span verbatim and the meta rides in
``otherData``, so ``from_chrome(to_chrome(t))`` gives back the exact
trace.

CLI:  python -m repro_torch.trace.chrome run.trace.json -o run.chrome.json
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List

from repro_torch.trace.events import (SCHEMA_VERSION, SPAN_KINDS, Span, Trace,
                                from_jsonable, to_jsonable)

#: stable thread row per span kind (Perfetto sorts rows by tid).
_TIDS = {name: i for i, name in enumerate(SPAN_KINDS)}
_TID_LABELS = {
    "local_step": "steps (measured)",
    "ef_encode": "EF encode (modeled)",
    "collective": "wire (modeled)",
    "ckpt": "checkpoint",
    "eval": "host bookkeeping",
}


def to_chrome(trace: Trace) -> Dict[str, Any]:
    """Trace -> Chrome trace_event JSON object (``traceEvents`` + metadata)."""
    events: List[Dict[str, Any]] = []
    for w in trace.workers:
        events.append({"ph": "M", "name": "process_name", "pid": w,
                       "args": {"name": f"worker {w}"}})
        for kind, tid in _TIDS.items():
            events.append({"ph": "M", "name": "thread_name", "pid": w,
                           "tid": tid,
                           "args": {"name": _TID_LABELS[kind]}})

    for i, s in enumerate(trace.spans):
        events.append({
            "name": s.name, "ph": "X",
            "pid": s.worker, "tid": _TIDS[s.name],
            "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
            "cat": "modeled" if s.modeled else "measured",
            # the verbatim span (plus its stream position) makes the export
            # lossless — from_chrome() rebuilds the Trace from these alone
            # (strict-JSON encoded: Perfetto rejects Infinity/NaN literals)
            "args": {"span": to_jsonable(s.to_dict()), "span_index": i},
        })

    # flow arrows: step -> its sync round's wire transfer, per worker.
    # Sources resolve in STREAM order (most recent step span for the
    # (worker, step) key) — dryrun traces restart step indices per
    # (arch, shape, mesh) pair, so a global dict would key-collide across
    # pairs and anchor arrows on the wrong pair's span.
    steps: Dict[Any, Span] = {}
    n_flow = 0
    for s in trace.spans:
        if s.name == "local_step":
            steps[(s.worker, s.step)] = s
            continue
        if s.name != "collective":
            continue
        src = steps.get((s.worker, s.step))
        if src is None:
            continue
        fid = f"sync-{s.step}-w{s.worker}-{n_flow}"
        n_flow += 1
        events.append({"ph": "s", "name": "sync_round", "cat": "sync",
                       "id": fid, "pid": src.worker,
                       "tid": _TIDS["local_step"],
                       "ts": (src.t0 + src.dur) * 1e6})
        events.append({"ph": "f", "name": "sync_round", "cat": "sync",
                       "id": fid, "bp": "e", "pid": s.worker,
                       "tid": _TIDS["collective"], "ts": s.t0 * 1e6})

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema_version": SCHEMA_VERSION,
                          "meta": to_jsonable(dict(trace.meta))}}


def from_chrome(doc: Dict[str, Any]) -> Trace:
    """Inverse of :func:`to_chrome` — exact span stream + meta back."""
    other = doc.get("otherData", {})
    v = other.get("schema_version")
    if v != SCHEMA_VERSION:
        raise ValueError(f"trace schema version {v!r} != {SCHEMA_VERSION}")
    indexed = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        if "span" not in args:
            raise ValueError(f"X event without embedded span: {ev['name']!r}")
        indexed.append((int(args["span_index"]),
                        Span.from_dict(from_jsonable(args["span"]))))
    indexed.sort(key=lambda p: p[0])
    return Trace(meta=from_jsonable(dict(other.get("meta", {}))),
                 spans=[s for _, s in indexed])


def export(trace_path: str, chrome_path: str) -> Dict[str, Any]:
    doc = to_chrome(Trace.load(trace_path))
    with open(chrome_path, "w") as f:
        json.dump(doc, f, allow_nan=False)
    return doc


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="recorded trace JSON (train --trace)")
    ap.add_argument("-o", "--out", default="",
                    help="Chrome trace path (default: <trace>.chrome.json)")
    args = ap.parse_args()
    out = args.out or (args.trace.rsplit(".json", 1)[0] + ".chrome.json")
    doc = export(args.trace, out)
    print(f"wrote {out} ({len(doc['traceEvents'])} events) — open in "
          f"chrome://tracing or https://ui.perfetto.dev")


if __name__ == "__main__":
    main()

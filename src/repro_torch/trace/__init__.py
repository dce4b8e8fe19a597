"""Trace subsystem of the port: record where a run's time goes, replay it
under what-ifs. The same span schema as the JAX package's ``repro.trace``:
each package reads, exports and replays the other's traces.

  events.py   TraceRecorder: structured spans (local_step / ef_encode /
              collective / ckpt / eval) on one perf_counter clock;
  chrome.py   lossless Chrome trace_event export (Perfetto);
  replay.py   the trace-driven what-if engine and its ``validate`` gate.
"""
from repro_torch.trace.events import (SCHEMA_VERSION, SPAN_KINDS, Span, Trace,
                                      TraceRecorder)

#: chrome/replay are also ``python -m`` entry points: importing them here
#: would run them twice under runpy, so they load on attribute access. The
#: ``replay`` function is not re-exported (the submodule of the same name
#: would shadow it): use ``repro_torch.trace.replay.replay``.
_LAZY = {
    "from_chrome": "chrome", "to_chrome": "chrome",
    "DEFAULT_TOL": "replay", "REPLAY_CODECS": "replay",
    "ReplayKnobs": "replay", "ReplayResult": "replay",
    "sweep_H": "replay", "sweep_codecs": "replay",
    "sweep_workers": "replay", "validate": "replay",
}

__all__ = ["SCHEMA_VERSION", "SPAN_KINDS", "Span", "Trace", "TraceRecorder",
           *sorted(_LAZY)]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"repro_torch.trace.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

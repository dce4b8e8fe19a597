"""Observability of the port: the training-health metrics registry and the
sync-health probe that feeds it and the trace spans (``train_loop``'s
``metrics_out``, ``--metrics`` on the CLI), and the bench-regression gate
(``python -m repro_torch.obs.regress``)."""
import importlib

# each name loads its module on first use: the gate's CLI then starts
# without torch (the probe imports it), and ``python -m
# repro_torch.obs.regress`` does not find its module imported already
_HOMES = {"Counter": "metrics", "Gauge": "metrics", "Histogram": "metrics",
          "MetricsRegistry": "metrics", "NULL_REGISTRY": "metrics",
          "SyncHealthProbe": "health", "TOLERANCES": "regress",
          "compare_files": "regress", "compare_rows": "regress"}

__all__ = list(_HOMES)


def __getattr__(name):
    if name in _HOMES:
        module = importlib.import_module(f"{__name__}.{_HOMES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

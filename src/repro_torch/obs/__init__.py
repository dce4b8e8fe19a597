"""Observability of the port: the training-health metrics registry and the
sync-health probe that feeds it and the trace spans (``train_loop``'s
``metrics_out``, ``--metrics`` on the CLI)."""
from repro_torch.obs.health import SyncHealthProbe
from repro_torch.obs.metrics import (NULL_REGISTRY, Counter, Gauge,
                                     Histogram, MetricsRegistry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_REGISTRY", "SyncHealthProbe"]

"""Lightweight metrics registry: counters / gauges / histograms.

The port's copy of the JAX package's ``obs/metrics.py`` (framework-free),
with the same outputs, so a consumer reads either package's stream:

* instruments are registered once, set as values appear, and the loop
  *collects* the registry once per step into a JSONL row (a header line
  ``{"stream": "repro.obs.metrics", "labels": ...}``, then one row a step,
  non-finite values as ``null``, flushed per line);
* :meth:`MetricsRegistry.write_prom` writes a Prometheus textfile
  (``repro_``-prefixed names, atomically replaced);
* :data:`NULL_REGISTRY` (any ``MetricsRegistry(enabled=False)``) is falsy
  and every instrument it hands out is a no-op: call sites guard the
  host-side work that feeds it with ``if registry:``.

A metric is ``(name, sorted label pairs)``; one name may carry many label
sets, and kind collisions on one name raise. Histograms keep exact
count/sum/min/max plus a bounded reservoir of the latest observations for
the exported quantiles (p50/p90/p99).
"""
from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_REGISTRY", "prom_sanitize"]

#: quantiles the JSONL rows and the Prometheus summary both export.
QUANTILES = (0.5, 0.9, 0.99)

#: observations a histogram keeps for quantile estimation.
RESERVOIR = 1024


def _labels_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labels_suffix(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


def prom_sanitize(name: str) -> str:
    """A metric name Prometheus accepts: ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _finite(x: float) -> float:
    x = float(x)
    return x if math.isfinite(x) else float("nan")


class _Metric:
    """Base instrument; the shared no-op when its registry is disabled."""

    kind = "none"

    def __init__(self, name: str = "", key: Tuple = (), help: str = ""):
        self.name = name
        self.key = key
        self.help = help

    # every instrument answers the whole API so the null object can stand
    # in for any kind without isinstance checks at the call sites
    def inc(self, by: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


class Counter(_Metric):
    """Monotone accumulator (steps run, sync rounds, wire bytes moved)."""

    kind = "counter"

    def __init__(self, name: str, key: Tuple, help: str = ""):
        super().__init__(name, key, help)
        self.value = 0.0

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name} cannot decrease (by={by})")
        self.value += by


class Gauge(_Metric):
    """Last-value instrument (loss, residual norm, compression ratio)."""

    kind = "gauge"

    def __init__(self, name: str, key: Tuple, help: str = ""):
        super().__init__(name, key, help)
        self.value = float("nan")

    def set(self, value: float) -> None:
        self.value = _finite(value)


class Histogram(_Metric):
    """Distribution instrument: exact count/sum/min/max, reservoir quantiles."""

    kind = "histogram"

    def __init__(self, name: str, key: Tuple, help: str = "",
                 reservoir: int = RESERVOIR):
        super().__init__(name, key, help)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._window = collections.deque(maxlen=reservoir)

    def observe(self, value: float) -> None:
        v = _finite(value)
        if math.isnan(v):
            return
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._window.append(v)

    def quantile(self, q: float) -> float:
        if not self._window:
            return float("nan")
        xs = sorted(self._window)
        i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[i]

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        out = {"count": self.count, "sum": self.sum,
               "min": self.min, "max": self.max}
        for q in QUANTILES:
            out[f"p{int(q * 100)}"] = self.quantile(q)
        return out


class MetricsRegistry:
    """Per-run metric store + JSONL/Prometheus exporters.

    ``bool(registry)`` is the enabled flag — instrumented code guards any
    host-side value computation with it, which is what makes the disabled
    path genuinely free (no device readback, no quantile pass, no dict
    churn; the no-op instrument is belt and braces on top).
    """

    def __init__(self, enabled: bool = True,
                 labels: Optional[Dict[str, Any]] = None) -> None:
        self.enabled = bool(enabled)
        self.labels = dict(labels or {})        # run-constant, exported once
        self._metrics: Dict[Tuple[str, Tuple], _Metric] = {}
        self._null = _Metric("<disabled>")
        self._jsonl = None
        self._jsonl_path = ""
        self._t0: Optional[float] = None
        self.rows: List[Dict[str, Any]] = []

    def __bool__(self) -> bool:
        return self.enabled

    # ---------------- instruments ---------------------------------------- #
    def _get(self, cls, name: str, help: str, labels: Dict[str, Any]):
        if not self.enabled:
            return self._null
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(name, key[1], help=help)
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._get(Histogram, name, help, labels)

    def set_many(self, values: Dict[str, float], **labels) -> None:
        """Gauge-set a flat ``{name: value}`` dict (one probe's output)."""
        for k, v in values.items():
            self.gauge(k, **labels).set(v)

    # ---------------- collection ----------------------------------------- #
    def now(self) -> float:
        t = time.perf_counter()
        if self._t0 is None:
            self._t0 = t
        return t - self._t0

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{name{labels}: value}`` of every scalar instrument plus a
        ``{name{labels}: summary}`` map of the histograms."""
        scalars: Dict[str, float] = {}
        hists: Dict[str, Dict[str, float]] = {}
        for (name, lkey), m in sorted(self._metrics.items()):
            tag = name + _labels_suffix(lkey)
            if isinstance(m, Histogram):
                hists[tag] = m.summary()
            else:
                scalars[tag] = m.value
        return {"metrics": scalars, "hists": hists}

    def collect(self, step: int) -> Dict[str, Any]:
        """One JSONL row: the registry's state after this step. Appends to
        ``rows`` and to the attached JSONL stream (flushed per line, so a
        crashed run keeps every completed step)."""
        if not self.enabled:
            return {}
        row = {"step": int(step), "t_s": round(self.now(), 6),
               **self.snapshot()}
        self.rows.append(row)
        if self._jsonl is not None:
            json.dump(_jsonable(row), self._jsonl)
            self._jsonl.write("\n")
            self._jsonl.flush()
        return row

    # ---------------- exporters ------------------------------------------ #
    def open_jsonl(self, path: str) -> None:
        if not self.enabled:
            return
        self._jsonl_path = path
        self._jsonl = open(path, "w")
        header = {"stream": "repro.obs.metrics", "labels": self.labels}
        json.dump(_jsonable(header), self._jsonl)
        self._jsonl.write("\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def prom_text(self) -> str:
        """The registry as Prometheus text exposition format (v0.0.4)."""
        base_labels = {str(k): str(v) for k, v in self.labels.items()}
        by_name: Dict[str, List[_Metric]] = {}
        for (name, _), m in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append(m)
        lines: List[str] = []

        def fmt(v: float) -> str:
            return "NaN" if math.isnan(v) else repr(float(v))

        def labelstr(key, extra=None) -> str:
            items = dict(base_labels)
            items.update({k: v for k, v in key})
            if extra:
                items.update(extra)
            if not items:
                return ""
            inner = ",".join(f'{prom_sanitize(k)}="{_prom_escape(v)}"'
                             for k, v in sorted(items.items()))
            return "{" + inner + "}"

        for name, ms in by_name.items():
            pname = prom_sanitize("repro_" + name)
            kind = ms[0].kind
            help_txt = next((m.help for m in ms if m.help), "")
            if help_txt:
                lines.append(f"# HELP {pname} {help_txt}")
            lines.append(f"# TYPE {pname} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for m in ms:
                if isinstance(m, Histogram):
                    for q in QUANTILES:
                        lines.append(
                            f"{pname}{labelstr(m.key, {'quantile': str(q)})} "
                            f"{fmt(m.quantile(q))}")
                    lines.append(f"{pname}_sum{labelstr(m.key)} {fmt(m.sum)}")
                    lines.append(f"{pname}_count{labelstr(m.key)} {m.count}")
                else:
                    lines.append(f"{pname}{labelstr(m.key)} {fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def write_prom(self, path: str) -> None:
        """Atomic replace — the node-exporter textfile-collector contract
        (a scrape must never see a half-written file)."""
        if not self.enabled:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.prom_text())
        os.replace(tmp, path)


def _jsonable(x: Any) -> Any:
    if isinstance(x, float) and not math.isfinite(x):
        return None                     # JSONL stays strict-RFC parseable
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


#: the shared disabled registry — instrument against it unconditionally,
#: pay nothing (see module docstring).
NULL_REGISTRY = MetricsRegistry(enabled=False)

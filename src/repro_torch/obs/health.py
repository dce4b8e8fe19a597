"""Sync-health probes: the convergence-relevant state the papers gate on.

The port's counterpart of the JAX package's ``obs/health.py``, with the
same summary keys and bucket names, so the metrics rows and trace spans of
the two packages compare key for key:

  grad_norm          per-worker L2 of the raw gradients (pre-clip), read
                     from the step metrics (``OptimizerConfig.obs_metrics``);
  drift              the adaptive policy's per-step statistic;
  ef_residual_norm   per dtype bucket, L2 of the error-feedback residual
                     after the last sync round;
  quant_mse          mean squared wire error of the last round (the residual
                     is that error, ``res = v − wire``);
  b2 quantiles       p50/p90/p99/max of the B² accumulator per bucket;
  wire_compression_ratio   static: fp32 round bytes / codec round bytes.

Buckets are the FlatSpace dtype buckets (``bucket_ranges``, padding slots
included) on flat runs and the parameter-dtype leaf groups on per-leaf
runs, named ``bfloat16``/``float32``. As in the reference, only Local
AdaAlter runs know their leaf dtypes; other runs name every leaf
``float32``, and only a ``b2_local`` accumulator is summarised (the
synchronous AdaAlter's ``b2`` is not).

The B² quantiles equal ``jnp.quantile`` (linear interpolation, float32
index arithmetic) without sorting: at full Big LSTM width one bucket holds
1.66 G values, which ``torch.quantile`` refuses (over 2^24) and a sort would
need 20 GB for. :func:`order_statistics` finds each order statistic it
needs by a binary search over the values' bit patterns, counting with one
comparison pass over the bucket's leaves a step: no sort, no
concatenation, and no histogram, whose atomic adds would all land in one
bin (B² is exactly b0² = 1 wherever a gradient was zero).

In a one-model run whose leaves the ranks hold in parts (FSDP, tensor
parallelism, or both: tiles; ``launch/steps.py::LeafLayout``) every rank
probes the parts it holds (each part once over both axes, a leaf unsplit
along one on that axis's first rank only), and the ranks' counts, bounds
and partial sums are combined over every rank: the quantiles stay exact
(integer counts add), the residual norms add their partial sums in part
order. Under tensor parallelism (a worker's leaves in parts over its
ranks) they are combined over every rank, all workers' parts together,
a leaf the specs leave whole counted on its worker's first rank only.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import comm

__all__ = ["SyncHealthProbe", "bounds", "order_statistics", "quantiles"]

#: B² quantiles exported per bucket.
B2_QS = (0.5, 0.9, 0.99)


def _key(v: float) -> int:
    """The float32 ``v`` as an integer that orders like the values: its bit
    pattern, with a negative value's magnitude bits flipped."""
    bits = int(np.array([v], np.float32).view(np.int32)[0])
    return bits ^ 0x7FFFFFFF if bits < 0 else bits


def _value(key: int) -> float:
    bits = key ^ 0x7FFFFFFF if key < 0 else key
    return float(np.array([bits], np.int32).view(np.float32)[0])


def _gathered(group, values: Sequence, dtype) -> torch.Tensor:
    """Every rank of ``group``'s ``values`` (one collective, counted in
    ``comm.side``): a (world, len(values)) host tensor."""
    (got,) = group.all_gather([torch.tensor(list(values), dtype=dtype)],
                              count=comm.side, to_device=False)
    return got.cpu()


def _count_sum(group, n: int) -> int:
    """``n`` summed over the ranks of ``group`` (``n`` without one)."""
    return n if group is None else int(_gathered(group, [n],
                                                 torch.int64).sum())


def bounds(pieces: Sequence[torch.Tensor],
           group=None) -> Tuple[float, float]:
    """(min, max) of all values in ``pieces`` (over the ranks of
    ``group``, each with its pieces), one pass each; NaN if any value is
    NaN."""
    lo, hi = math.inf, -math.inf
    if pieces:
        mm = torch.stack([torch.stack(torch.aminmax(p)) for p in pieces])
        lo, hi = (float(v) for v in (mm[:, 0].min(), mm[:, 1].max()))
    if group is not None:
        got = _gathered(group, [lo, hi], torch.float64)
        lo, hi = (math.nan if bool(torch.isnan(got).any()) else v
                  for v in (float(got[:, 0].min()), float(got[:, 1].max())))
    if math.isnan(lo) or math.isnan(hi):
        return math.nan, math.nan
    return lo, hi


def order_statistics(pieces: Sequence[torch.Tensor], ranks: Sequence[int],
                     lo_hi: Tuple[float, float], group=None) -> List[float]:
    """The ``ranks``-th smallest (0-based) of all float32 values in
    ``pieces`` taken together, between ``lo_hi`` = (min, max) (no NaN),
    without a sort: for each rank, a binary search over the float32 values
    between the minimum and the maximum (at most 32 halvings of their bit
    patterns), each step counting the values ``<= t`` with one comparison
    pass over every piece. The searches run side by side, one halving of
    each a round. The minimum is tried first: where a bucket holds mostly
    its least value (B² = b0² wherever the gradients were zero), one count
    settles the rank. With a ``group`` the values are every rank's pieces:
    a round's counts are summed over the ranks in one collective, so a
    bucket costs at most 33 collectives, whatever the number of ranks."""
    def counts(ts: Sequence[float]) -> List[int]:
        local = [sum(int(torch.count_nonzero(p <= t)) for p in pieces)
                 for t in ts]
        if group is None:
            return local
        return _gathered(group, local, torch.int64).sum(dim=0).tolist()

    (at_min,) = counts([lo_hi[0]])
    # rank -> [lo, hi): the least key whose count exceeds the rank
    search = {r: [_key(lo_hi[0]) + 1, _key(lo_hi[1])] for r in ranks
              if at_min <= r}
    while True:
        live = [r for r, (lo, hi) in search.items() if lo < hi]
        if not live:
            break
        mids = [(search[r][0] + search[r][1]) // 2 for r in live]
        for r, mid, c in zip(live, mids, counts([_value(m) for m in mids])):
            if c > r:
                search[r][1] = mid
            else:
                search[r][0] = mid + 1
    return [_value(search[r][0]) if r in search else lo_hi[0]
            for r in ranks]


def quantiles(pieces: Sequence[torch.Tensor], qs: Sequence[float],
              lo_hi: Optional[Tuple[float, float]] = None,
              group=None) -> List[float]:
    """``jnp.quantile(concat(pieces), qs)`` (linear method) as the JAX
    package's jitted probe computes it: the index q·(n−1), its floor and
    ceiling and the interpolation weights in float32, the interpolation as
    XLA fuses it, NaN if any value is NaN. ``lo_hi``: the pieces'
    :func:`bounds`, if known. ``group``: the values are every rank's
    pieces."""
    lo_hi = lo_hi or bounds(pieces, group)
    if math.isnan(lo_hi[0]):
        return [math.nan] * len(qs)
    f32 = np.float32
    n = f32(_count_sum(group, sum(p.numel() for p in pieces)))
    pos = [f32(q) * (n - f32(1)) for q in qs]
    lo = [min(max(np.floor(p), f32(0)), n - f32(1)) for p in pos]
    hi = [min(max(np.ceil(p), f32(0)), n - f32(1)) for p in pos]
    ranks = sorted({int(v) for v in lo + hi})
    stat = dict(zip(ranks, order_statistics(pieces, ranks, lo_hi, group)))
    out = []
    for p, a, b in zip(pos, lo, hi):
        hw = f32(p - a)
        lw = f32(1) - hw
        # XLA contracts low·lw + high·hw into fma(low, lw, high·hw): the
        # float64 product of two float32 values is exact, so one rounding
        # of the float64 sum to float32 emulates it (but for a double-
        # rounding tie, which needs the sum to span over 53 bits)
        high = f32(f32(stat[int(b)]) * hw)
        out.append(float(f32(np.float64(stat[int(a)]) * np.float64(lw)
                             + np.float64(high))))
    return out


class SyncHealthProbe:
    """Host-side per-step health summary of one training run.

    Build with :meth:`build`; call :meth:`step_summary` once per executed
    step. Returns a JSON-safe nested dict (keys in the module docstring);
    entries whose inputs don't exist for this run are absent.
    """

    def __init__(self, *, is_flat: bool, flatspace: Any,
                 leaf_dtypes: Sequence[str], engine: Any,
                 n_params: int, n_shards: int = 1,
                 leaf_layout: Any = None, group: Any = None) -> None:
        self.is_flat = bool(is_flat)
        # leaves in parts: each rank probes its own, combined over the
        # ranks holding one model's parts (or ``group``, where it holds
        # more: every worker's ranks under the paper-style plan's tensor
        # parallelism), in part order
        self.parts = (leaf_layout if leaf_layout is not None
                      and (leaf_layout.sharded or group is not None)
                      else None)
        self.group = (None if self.parts is None
                      else group or self.parts.ranks)
        self.fs = flatspace
        self.engine = engine
        self.n_params = int(n_params)
        self.n_shards = int(n_shards)
        self._leaf_dtypes = list(leaf_dtypes)

    @staticmethod
    def build(engine, programs, n_params: int) -> "SyncHealthProbe":
        from repro_torch.core.flatspace import dtype_name
        from repro_torch.tree import leaves
        dtypes = []
        if not programs.is_flat and programs.legacy_abstract is not None:
            dtypes = [dtype_name(t.dtype)
                      for t in leaves(programs.legacy_abstract[0])]
        return SyncHealthProbe(
            is_flat=programs.is_flat, flatspace=programs.flatspace,
            leaf_dtypes=dtypes, engine=engine, n_params=n_params,
            n_shards=programs.n_shards, leaf_layout=programs.leaf_layout,
            group=programs.group if programs.is_local
            and programs.leaf_layout is not None else None)

    def static_summary(self) -> Dict[str, float]:
        """Run-constant facts: wire bytes and compression ratio of one
        sync round under the engine's codec; with a sharded flat plane also
        the shard count and the wire bytes of one shard's round (what a
        rank's collective moves)."""
        n = self.n_params
        round_b = float(self.engine.round_bytes(n))
        fp32_b = float(comm.sync_payload_bytes(self.engine.algorithm, n))
        out = {
            "round_wire_bytes": round_b,
            "wire_compression_ratio": fp32_b / round_b if round_b else 1.0,
        }
        if self.n_shards > 1:
            out["n_shards"] = float(self.n_shards)
            out["round_wire_bytes_per_shard"] = float(
                self.engine.round_bytes_per_shard(n, self.n_shards))
        return out

    def _buckets(self, entry) -> List[Tuple[str, List[torch.Tensor]]]:
        """``(bucket name, [float32 pieces])`` of one opt-state entry (a
        plane on flat runs, a params-shaped tree otherwise), in the
        reference's concatenation order."""
        from repro_torch.tree import leaves
        out: Dict[str, List[torch.Tensor]] = {}
        if self.is_flat:          # row by row: each slice is contiguous
            rows = entry.reshape(-1, entry.shape[-1])
            for name, start, stop in self.fs.bucket_ranges():
                out.setdefault(name, []).extend(
                    row[start:stop] for row in rows)
        else:
            dtypes = self._leaf_dtypes or ["float32"] * len(leaves(entry))
            for dt in dtypes:              # every rank has every bucket
                out.setdefault(dt, [])
            picked = (self.parts.owned_leaves(entry) if self.parts is not None
                      else enumerate(leaves(entry)))
            for i, leaf in picked:
                out[dtypes[i]].append(leaf.float())
        return sorted(out.items())

    def _b2(self, b2_local) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, pieces in self._buckets(b2_local):
            lo_hi = bounds(pieces, self.group)
            qs = quantiles(pieces, B2_QS, lo_hi, self.group)
            out[name] = {**{f"p{int(q * 100)}": v
                            for q, v in zip(B2_QS, qs)}, "max": lo_hi[1]}
        return out

    def _residuals(self, opt_state) -> Tuple[Dict[str, float], float]:
        sums, total_n = {}, 0
        for key in ("res_params", "res_b2"):
            if key not in opt_state:
                continue
            tag = "params" if key == "res_params" else "b2"
            for name, pieces in self._buckets(opt_state[key]):
                sums[f"{tag}/{name}"] = sum(
                    (torch.sum(torch.square(p)) for p in pieces),
                    torch.zeros((), dtype=torch.float32))
                total_n += sum(p.numel() for p in pieces)
        vals = (torch.stack([v.cpu() for v in sums.values()])
                if sums else None)
        if vals is not None and self.group is not None:
            got = _gathered(self.group, vals.tolist(), torch.float32)
            vals = got[0]
            for r in range(1, got.shape[0]):    # in part order
                vals = vals + got[r]
        total_n = _count_sum(self.group, total_n)
        vals = vals.tolist() if vals is not None else []
        sq = dict(zip(sums, vals))
        total = np.float32(sum(np.float32(v) for v in vals))
        mse = float(total / np.float32(total_n)) if total_n else 0.0
        return {k: float(np.sqrt(np.float32(v))) for k, v in sq.items()}, mse

    def step_summary(self, opt_state, metrics: Dict[str, Any], *,
                     synced: bool) -> Dict[str, Any]:
        """One step's health dict. The residual probes run only when
        ``synced`` (sync rounds rewrite the EF residual; it is constant in
        between)."""
        out: Dict[str, Any] = {}
        if "grad_norm" in metrics:
            g = np.asarray(metrics["grad_norm"].detach().float().cpu()
                           ).reshape(-1)
            out["grad_norm"] = float(g.mean())
            if g.size > 1:
                out["grad_norm_per_worker"] = [float(v) for v in g]
        if "drift" in metrics:
            out["drift"] = float(metrics["drift"])
        has_state = isinstance(opt_state, dict)
        if has_state and "b2_local" in opt_state:
            out["b2"] = self._b2(opt_state["b2_local"])
        if synced and has_state and "res_params" in opt_state:
            out["ef_residual_norm"], out["quant_mse"] = self._residuals(
                opt_state)
        return out

    def record(self, registry, summary: Dict[str, Any], *,
               step: int, synced: bool) -> None:
        """Feed one step's summary into a metrics registry (labeled gauges;
        grad-norm additionally per worker)."""
        if not registry:
            return
        if "grad_norm" in summary:
            registry.gauge("grad_norm",
                           help="L2 of raw grads, mean over workers"
                           ).set(summary["grad_norm"])
        for w, v in enumerate(summary.get("grad_norm_per_worker", [])):
            registry.gauge("grad_norm", worker=w).set(v)
        if "drift" in summary:
            registry.gauge("drift",
                           help="adaptive policy drift statistic"
                           ).set(summary["drift"])
        for name, qs in summary.get("b2", {}).items():
            for q, v in qs.items():
                registry.gauge("b2", help="B2 accumulator quantiles",
                               bucket=name, q=q).set(v)
        for tag, v in summary.get("ef_residual_norm", {}).items():
            plane, _, bucket = tag.partition("/")
            registry.gauge("ef_residual_norm",
                           help="L2 of the EF residual after last sync",
                           plane=plane, bucket=bucket).set(v)
        if "quant_mse" in summary:
            registry.gauge("quant_mse",
                           help="mean squared wire error of last sync round"
                           ).set(summary["quant_mse"])
        if synced:
            registry.counter("sync_rounds_total").inc()
            registry.counter(
                "wire_bytes_total",
                help="cumulative sync wire bytes (modeled codec payload)"
            ).inc(self.static_summary()["round_wire_bytes"])

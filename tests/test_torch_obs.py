"""The port's observability: the metrics registry, the B² quantile
selection, and the health stream against the JAX package's.

* The registry alone (``repro_torch.obs.metrics``), as
  ``tests/test_obs.py`` holds the reference's: counters, gauges,
  histograms, labels, kind collisions, the JSONL stream (NaN -> null), the
  Prometheus text, the null registry.
* ``quantiles`` equals jitted ``jnp.quantile`` bitwise: over 2^24
  elements (where ``torch.quantile`` refuses), with ties, negative values,
  interpolated positions, a bucket split over many pieces.
* The metrics stream of an instrumented run against the reference's on
  the same run (reduced Big LSTM from the same weights, 2 workers, Local
  AdaAlter with the adaptive policy and the int8 wire, per leaf and flat;
  and the synchronous AdaAlter): one row a step after the header, the same
  keys in every row, the residual fields on the sync steps only, a
  Prometheus textfile beside the JSONL, and the values within the
  tolerances stated at the top of this file. The reference runs in a
  subprocess on a 2-device Auto-axis CPU mesh.
* One probe feeds both exports: the port's trace spans and metrics rows
  report the same numbers.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import (OptimizerConfig, ShapeConfig, SyncConfig,
                                 get_arch, reduced)
from repro_torch.launch.train import train_loop
from repro_torch.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                             NULL_REGISTRY)
from repro_torch.obs import health
from repro_torch.trace import Trace

REPO = Path(__file__).resolve().parents[1]
SEQ, BATCH, STEPS = 16, 8, 9
THRESHOLD = 0.002            # sync at [2, 5, 8], >= 20% margins (see
                             # tests/test_torch_checkpoint.py)
# Tolerances against the reference, relative, each above the largest
# difference measured on this run. The loss: LOSS_RTOL of
# tests/test_torch_train.py (measured 1.9e-5). The gradients are bfloat16
# (8 significant bits), and the two frameworks round the bf16 products and
# the embedding's scatter-add at different places, so one element's
# gradient can differ by a last bit (0.4-0.8%): the raw-gradient norm
# differs by up to 0.25%, and B² = 1 + Σ g∘g, whose largest entry sums the
# squares of the largest gradients, by up to 3.0e-4 of its ~1.008. The
# drift (relative movement of bf16 parameters) agrees to DRIFT_RTOL of
# tests/test_torch_train.py (measured 0.5%). The EF residual is each
# block's int8 rounding error: a last-bit difference in a value moves it
# across a rounding edge, so the residual norms differ by up to 2.3% and
# the quantization MSE by 0.1%.
RTOL = {"loss": 1e-4, "grad_norm": 5e-3, "b2": 1e-3, "drift": 1e-2,
        "ef_residual_norm": 5e-2, "quant_mse": 1e-2}

RUNS = {
    # name: (optimizer, flat, SyncConfig kwargs, workers)
    "leaf": ("local_adaalter", False,
             dict(policy="adaptive", threshold=THRESHOLD,
                  compression="int8"), 2),
    "flat": ("local_adaalter", True,
             dict(policy="adaptive", threshold=THRESHOLD,
                  compression="int8"), 2),
    "adaalter": ("adaalter", False, dict(), 1),
}

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.launch.train import train_loop
from repro.models import build_model

out, runs = sys.argv[1], json.loads(sys.argv[2])
seq, batch, steps = map(int, sys.argv[3:6])
cfg = reduced(get_arch("biglstm"))
shape = ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
params0 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
leaves, _ = jax.tree_util.tree_flatten_with_path(params0)
np.savez(os.path.join(out, "params0.npz"),
         **{jax.tree_util.keystr(k): np.asarray(v).view(np.uint16)
            for k, v in leaves})
res = {}
for name, (opt, flat, sync_kw, _) in runs.items():
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), name=opt, lr=0.5,
                                   H=4, warmup_steps=0, flat=flat)
    r = train_loop(cfg, shape, oc, steps=steps, seed=0, mesh=mesh,
                   verbose=False,
                   metrics_out=os.path.join(out, f"ref_{name}.jsonl"),
                   trace_out=os.path.join(out, f"ref_{name}.trace.json"))
    res[name] = dict(sync_steps=r.sync_steps, losses=r.losses)
json.dump(res, open(os.path.join(out, "ref.json"), "w"))
"""


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #
def test_counter_is_monotone():
    r = MetricsRegistry()
    c = r.counter("steps_total")
    c.inc()
    c.inc(2.5)
    assert isinstance(c, Counter) and c.value == pytest.approx(3.5)
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)


def test_gauge_keeps_last_value_and_tags_nonfinite():
    g = MetricsRegistry().gauge("loss")
    g.set(2.0)
    g.set(1.5)
    assert isinstance(g, Gauge) and g.value == 1.5
    g.set(float("inf"))
    assert math.isnan(g.value)


def test_histogram_summary_quantiles():
    h = MetricsRegistry().histogram("step_time_s")
    for v in range(1, 101):
        h.observe(float(v))
    s = h.summary()
    assert isinstance(h, Histogram)
    assert s["count"] == 100 and s["min"] == 1.0 and s["max"] == 100.0
    assert s["sum"] == pytest.approx(5050.0)
    assert 45 <= s["p50"] <= 55 and 85 <= s["p90"] <= 95
    assert s["p99"] >= 98


def test_labeled_metrics_are_distinct():
    r = MetricsRegistry()
    r.gauge("b2", bucket="float32", q="p50").set(1.0)
    r.gauge("b2", bucket="bfloat16", q="p50").set(2.0)
    snap = r.snapshot()["metrics"]
    assert snap["b2{bucket=float32,q=p50}"] == 1.0
    assert snap["b2{bucket=bfloat16,q=p50}"] == 2.0


def test_kind_collision_raises():
    r = MetricsRegistry()
    r.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("x")


def test_collect_appends_rows_and_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    r = MetricsRegistry(labels={"arch": "t"})
    r.open_jsonl(path)
    r.counter("steps_total").inc()
    r.gauge("loss").set(3.0)
    r.collect(0)
    r.gauge("loss").set(float("nan"))
    r.collect(1)
    r.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0] == {"stream": "repro.obs.metrics", "labels": {"arch": "t"}}
    assert lines[1]["step"] == 0 and lines[1]["metrics"]["loss"] == 3.0
    assert lines[2]["metrics"]["loss"] is None
    assert len(r.rows) == 2


def test_prom_text_format(tmp_path):
    r = MetricsRegistry(labels={"run": "a b"})
    r.gauge("loss", help="train loss").set(2.5)
    r.counter("steps_total").inc(3)
    r.histogram("step_time_s").observe(1.0)
    txt = r.prom_text()
    assert "# HELP repro_loss train loss" in txt
    assert "# TYPE repro_loss gauge" in txt
    assert 'repro_loss{run="a b"} 2.5' in txt
    assert "# TYPE repro_steps_total counter" in txt
    assert "# TYPE repro_step_time_s summary" in txt
    assert 'quantile="0.5"' in txt
    assert 'repro_step_time_s_count{run="a b"} 1' in txt
    path = str(tmp_path / "m.prom")
    r.write_prom(path)
    assert open(path).read() == txt
    assert not os.path.exists(path + ".tmp")


def test_null_registry_is_free_and_falsy():
    assert not NULL_REGISTRY
    NULL_REGISTRY.counter("a").inc()
    NULL_REGISTRY.gauge("b").set(1.0)
    NULL_REGISTRY.histogram("c").observe(1.0)
    assert NULL_REGISTRY.collect(0) == {}
    assert NULL_REGISTRY.snapshot() == {"metrics": {}, "hists": {}}
    NULL_REGISTRY.open_jsonl("/nonexistent/dir/never_opened.jsonl")
    NULL_REGISTRY.write_prom("/nonexistent/dir/never_written.prom")


def test_uninstrumented_config_has_no_grad_norm():
    """obs_metrics is off by default and an uninstrumented step returns no
    grad_norm (the instrumented one does)."""
    from repro_torch.launch.steps import build_train_programs
    from repro_torch.data import SyntheticLM, make_train_batch
    assert OptimizerConfig().obs_metrics is False
    cfg = reduced(get_arch("biglstm"))
    shape = ShapeConfig("t", seq_len=8, global_batch=4, kind="train")
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, n_workers=2)
    batch = {k: torch.from_numpy(v) for k, v in
             make_train_batch(cfg, shape, ds, 0, n_workers=2).items()}
    for on in (False, True):
        p = build_train_programs(cfg, OptimizerConfig(obs_metrics=on),
                                 n_workers=2, device="cpu")
        params, state = p.init_fn(0)
        _, _, metrics = p.local_step(params, state, batch)
        assert ("grad_norm" in metrics) == on


# --------------------------------------------------------------------------- #
# B² quantiles without a sort
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jnp_quantile():
    import jax
    import jax.numpy as jnp
    fn = jax.jit(lambda x: jnp.quantile(x, jnp.asarray(health.B2_QS)))
    return lambda a: [float(v) for v in np.asarray(fn(a))]


def test_quantiles_match_jnp_over_2_pow_24(jnp_quantile):
    """B²-like values (>= 1, many ties), more than 2^24 of them, split over
    leaves of different sizes: bitwise jnp.quantile of the concatenation."""
    rng = np.random.default_rng(0)
    n = (1 << 24) + 4097
    a = (1.0 + rng.integers(0, 3000, size=n) / 1024.0).astype(np.float32)
    a[rng.integers(0, n, size=1000)] = 7.5
    cuts = [0, 5, 1 << 20, (1 << 24) - 3, n]
    pieces = [torch.from_numpy(a[i:j]) for i, j in zip(cuts, cuts[1:])]
    assert health.quantiles(pieces, health.B2_QS) == jnp_quantile(a)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4099])
def test_quantiles_match_jnp_interpolated(jnp_quantile, n):
    """Small arrays, where q·(n−1) falls between order statistics, and
    negative values and zeros of both signs."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n).astype(np.float32)
    a[: n // 3] = np.round(a[: n // 3])
    pieces = [torch.from_numpy(a[: n // 2]), torch.from_numpy(a[n // 2:])]
    pieces = [p for p in pieces if p.numel()]
    assert health.quantiles(pieces, health.B2_QS) == jnp_quantile(a)


def test_order_statistics_match_a_sort():
    """Every rank of a bucket with ties, zeros of both signs, negative
    values and infinities, split over pieces, against ``np.sort``."""
    rng = np.random.default_rng(1)
    a = rng.gamma(0.5, size=20_011).astype(np.float32)
    a[::7] = 1.0
    a[::11] = -a[::11]
    a[5], a[6], a[7], a[8] = 0.0, -0.0, np.inf, -np.inf
    pieces = [torch.from_numpy(a[:3]), torch.from_numpy(a[3:12_000]),
              torch.from_numpy(a[12_000:])]
    ranks = [0, 1, 2, 3, 17, 2_857, 10_005, 20_009, 20_010]
    assert health.order_statistics(pieces, ranks, health.bounds(pieces)) == \
        [float(v) for v in np.sort(a)[ranks]]


def test_quantiles_nan_propagates(jnp_quantile):
    a = np.arange(10, dtype=np.float32)
    a[3] = np.nan
    got = health.quantiles([torch.from_numpy(a)], health.B2_QS)
    assert all(math.isnan(v) for v in got + jnp_quantile(a))


# --------------------------------------------------------------------------- #
# the health stream against the reference's
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_x")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                    json.dumps(RUNS), str(SEQ), str(BATCH), str(STEPS)],
                   check=True, env=env, timeout=900)
    ref = json.loads((out / "ref.json").read_text())
    with np.load(out / "params0.npz") as z:
        flat = dict(z)
    as_bf16 = lambda k: flat[k].view(ml_dtypes.bfloat16)
    cfg = reduced(get_arch("biglstm"))
    params0 = convert.to_torch({
        "embed": as_bf16("['embed']"), "head_w": as_bf16("['head_w']"),
        "head_b": as_bf16("['head_b']"),
        "cells": [{n: as_bf16(f"['cells'][{i}]['{n}']")
                   for n in ("b", "wh", "wp", "wx")}
                  for i in range(cfg.n_layers)]})
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    got = {}
    for name, (opt, flat_, sync_kw, workers) in RUNS.items():
        oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), name=opt,
                                       lr=0.5, H=4, warmup_steps=0,
                                       flat=flat_)
        res = train_loop(cfg, shape, oc, steps=STEPS, seed=0,
                         n_workers=workers, verbose=False, device="cpu",
                         init_params=params0,
                         metrics_out=str(out / f"port_{name}.jsonl"),
                         trace_out=str(out / f"port_{name}.trace.json"))
        got[name] = dict(
            res=res, rows=_rows(out / f"port_{name}.jsonl"),
            ref_rows=_rows(out / f"ref_{name}.jsonl"),
            trace=Trace.load(str(out / f"port_{name}.trace.json")),
            prom=out / f"port_{name}.prom", ref=ref[name])
    return got


@pytest.mark.parametrize("name", list(RUNS))
def test_one_row_a_step_with_the_reference_keys(streams, name):
    s = streams[name]
    rows, ref_rows = s["rows"], s["ref_rows"]
    assert rows[0] == {"stream": "repro.obs.metrics",
                       "labels": ref_rows[0]["labels"]}
    assert [r["step"] for r in rows[1:]] == list(range(STEPS))
    assert s["res"].sync_steps == s["ref"]["sync_steps"]
    for got, want in zip(rows[1:], ref_rows[1:]):
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        assert sorted(got["hists"]) == sorted(want["hists"])
        assert got["metrics"]["steps_total"] == got["step"] + 1


@pytest.mark.parametrize("name", ["leaf", "flat"])
def test_sync_round_probes_only_on_sync_steps(streams, name):
    s = streams[name]
    assert s["res"].sync_steps == [2, 5, 8]
    for r in s["rows"][1:]:
        m = r["metrics"]
        # residual gauges keep their last value: absent before the first
        # round, then rewritten on each sync step only
        has = any(k.startswith("ef_residual_norm") for k in m)
        assert has == (r["step"] >= 2)
        assert ("quant_mse" in m) == (r["step"] >= 2)
        assert m.get("sync_rounds_total", 0) == sum(
            1 for t in s["res"].sync_steps if t <= r["step"])
    by = {r["step"]: r["metrics"] for r in s["rows"][1:]}
    assert by[2]["quant_mse"] > 0
    assert by[3]["quant_mse"] == by[2]["quant_mse"]
    assert by[5]["quant_mse"] != by[2]["quant_mse"]
    assert by[2]["wire_bytes_total"] == pytest.approx(
        by[2]["round_wire_bytes"])
    assert by[2]["wire_compression_ratio"] == pytest.approx(3.938, abs=0.01)


def _field(key):
    for f in RTOL:
        if key == f or key.startswith(f + "{"):
            return f
    return None


@pytest.mark.parametrize("name", list(RUNS))
def test_values_match_the_reference(streams, name):
    s = streams[name]
    checked = set()
    for got, want in zip(s["rows"][1:], s["ref_rows"][1:]):
        for key, v in want["metrics"].items():
            f = _field(key)
            if f is None:       # counters and the static wire bytes
                if key in ("steps_total", "sync_rounds_total",
                           "round_wire_bytes", "wire_bytes_total",
                           "wire_compression_ratio"):
                    assert got["metrics"][key] == v, key
                continue
            np.testing.assert_allclose(got["metrics"][key], v,
                                       rtol=RTOL[f], err_msg=key)
            checked.add(f)
    want_fields = {"loss", "grad_norm"} | (
        {"b2", "drift", "ef_residual_norm", "quant_mse"}
        if name != "adaalter" else set())
    assert checked == want_fields


@pytest.mark.parametrize("name", list(RUNS))
def test_prom_file_written_next_to_jsonl(streams, name):
    txt = streams[name]["prom"].read_text()
    assert "# TYPE repro_loss gauge" in txt
    assert "repro_final_loss" in txt
    assert "# TYPE repro_step_time_s summary" in txt


@pytest.mark.parametrize("name", list(RUNS))
def test_trace_and_metrics_report_same_numbers(streams, name):
    s = streams[name]
    by_step = {r["step"]: r["metrics"] for r in s["rows"][1:]}
    spans = s["trace"].by_name("local_step")
    assert len(spans) == RUNS[name][3] * STEPS
    for sp in spans:
        m = by_step[sp.step]
        assert sp.args["grad_norm"] == m["grad_norm"]
        assert sp.args["loss"] == m["loss"]
        for bucket, qs in sp.args.get("b2", {}).items():
            for q, v in qs.items():
                assert m[f"b2{{bucket={bucket},q={q}}}"] == v
    assert ("b2" in spans[0].args) == (name != "adaalter")

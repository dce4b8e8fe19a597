"""The port's training slice against the JAX package's ``train_loop``.

One subprocess drives the reference (``repro.launch.train.train_loop``)
for reduced Big LSTM on a 2-worker Auto-axis CPU mesh, in five
configurations (per-leaf and flat plane, one-pass and three-pass int8
encode), and dumps its results and initial weights. The port starts
from the same weights (``repro_torch.convert``) and trains on the CPU.

What must match:
  * the sync schedule (``sync_steps``, ``sync_count``) and the comm bytes
    (``comm_bytes_total``, ``comm_bytes_modeled``): exactly;
  * the loss curve: to LOSS_RTOL. The parameters are bfloat16, and the two
    frameworks round the bf16 matrix products, the LSTM state and the
    embedding gradient's scatter-add at different places; over 8 steps the
    per-token loss of ~6.23 nats differs by up to ~2e-5 relative;
  * the adaptive schedule: the port's policy, fed the reference's drift
    stream, takes the reference's decisions exactly; the port's own drift
    stream agrees to DRIFT_RTOL (measured ~0.3%: the bf16 parameter deltas
    it is made of differ in last bits) and, with the threshold placed >20%
    away from every accumulated value the run decides on, yields the same
    schedule.
"""
import json
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
from repro_torch.core.sync_policy import AdaptiveSyncPolicy
from repro_torch.launch.train import train_loop

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
DRIFT_RTOL = 0.01
THRESHOLD = 0.0025
SEQ, BATCH, STEPS = 16, 8, 8

STALENESS_THRESHOLD = 2.5

RUNS = {
    # name: (SyncConfig kwargs, use_kernels, flat[, extras]); extras may set
    # OptimizerConfig fields ("opt"), the worker count ("workers", default
    # 2; the global batch grows to 4 sequences a worker), "non_iid"
    "int8_kernels": (dict(compression="int8"), True, False),
    "fp32_plain": (dict(), False, False),
    "adaptive_bf16": (dict(policy="adaptive", threshold=THRESHOLD,
                           compression="bf16"), True, False),
    "flat_int8_kernels": (dict(compression="int8"), True, True),
    "flat_int8_unfused": (dict(compression="int8", fused=False), True, True),
    "local_sgd": (dict(), False, False, dict(opt=dict(name="local_sgd"))),
    "warmup3_int8_kernels": (dict(compression="int8"), True, False,
                             dict(opt=dict(warmup_steps=3))),
    # the per-worker raw gradient norm is ~0.28 here: a 0.2 clip fires
    "clip_int8_kernels": (dict(compression="int8"), True, False,
                          dict(opt=dict(grad_clip=0.2))),
    "clip_int8_plain": (dict(compression="int8"), False, False,
                        dict(opt=dict(grad_clip=0.2))),
    # the first window reads exactly 1 a step (zero anchor); every
    # accumulated value the schedule decides on sits >= 20% from 2.5
    "adaptive_staleness_bf16": (dict(policy="adaptive",
                                     threshold=STALENESS_THRESHOLD,
                                     drift_metric="grad_staleness",
                                     compression="bf16"), True, False),
    "iid_int8_kernels": (dict(compression="int8"), True, False,
                         dict(non_iid=False)),
    "r3_int8_kernels": (dict(compression="int8"), True, False,
                        dict(workers=3)),
    "r3_flat_int8_kernels": (dict(compression="int8"), True, True,
                             dict(workers=3)),
}


def _run(name):
    """(sync kwargs, use_kernels, flat, opt extras, workers, batch,
    non_iid) of one RUNS entry."""
    sync_kw, use_kernels, flat, *rest = RUNS[name]
    extra = rest[0] if rest else {}
    workers = extra.get("workers", 2)
    batch = BATCH if workers == 2 else 4 * workers
    return (sync_kw, use_kernels, flat, extra.get("opt", {}), workers,
            batch, extra.get("non_iid", True))


REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.core import sync_engine
from repro.launch.train import train_loop
from repro.models import build_model

out, runs, seq, steps = sys.argv[1], json.loads(sys.argv[2]), *map(int, sys.argv[3:5])
cfg = reduced(get_arch("biglstm"))
params0 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
leaves, _ = jax.tree_util.tree_flatten_with_path(params0)
np.savez(out + ".npz", **{jax.tree_util.keystr(k): np.asarray(v).view(np.uint16)
                          for k, v in leaves})
drifts = []
observe = sync_engine.SyncEngine.observe
def recording_observe(self, step, synced, metrics=None):
    drifts.append(float((metrics or {}).get("drift", 0.0)))
    return observe(self, step, synced, metrics)
sync_engine.SyncEngine.observe = recording_observe
res = {}
for name, (sync_kw, use_pallas, flat, opt_kw, workers, batch, non_iid) in runs.items():
    drifts.clear()
    mesh = jax.make_mesh((workers, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:workers])
    shape = ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), **{
        "lr": 0.5, "H": 4, "warmup_steps": 0, "use_pallas": use_pallas,
        "flat": flat, **opt_kw})
    r = train_loop(cfg, shape, oc, steps=steps, seed=0, mesh=mesh,
                   non_iid=non_iid, verbose=False)
    res[name] = dict(losses=r.losses, sync_steps=r.sync_steps,
                     sync_count=r.sync_count, n_workers=r.n_workers,
                     comm_bytes_total=r.comm_bytes_total,
                     comm_bytes_modeled=r.comm_bytes_modeled,
                     drift=list(drifts))
json.dump(res, open(out + ".json", "w"))
"""


def _cfg():
    return reduced(get_arch("biglstm"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_ref") / "ref")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    runs = {name: _run(name) for name in RUNS}
    subprocess.run([sys.executable, "-c", REF_SCRIPT, out, json.dumps(runs),
                    str(SEQ), str(STEPS)],
                   check=True, env=env, timeout=900)
    with np.load(out + ".npz") as z:
        flat = dict(z)
    cfg = _cfg()
    as_bf16 = lambda k: flat[k].view(ml_dtypes.bfloat16)
    params0 = convert.to_torch({
        "embed": as_bf16("['embed']"), "head_w": as_bf16("['head_w']"),
        "head_b": as_bf16("['head_b']"),
        "cells": [{n: as_bf16(f"['cells'][{i}]['{n}']")
                   for n in ("b", "wh", "wp", "wx")}
                  for i in range(cfg.n_layers)]})
    with open(out + ".json") as f:
        return params0, json.load(f)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_runs(reference):
    """The port's run of each configuration, with the drift stream its
    sync engine was fed."""
    from repro_torch.core import sync_engine
    params0, _ = reference
    drifts = []
    observe = sync_engine.SyncEngine.observe

    def recording_observe(self, step, synced, metrics=None):
        drifts.append((metrics or {}).get("drift", 0.0))
        return observe(self, step, synced, metrics)

    out = {}
    sync_engine.SyncEngine.observe = recording_observe
    try:
        for name in RUNS:
            (sync_kw, use_kernels, flat, opt_kw, workers, batch,
             non_iid) = _run(name)
            drifts.clear()
            shape = ShapeConfig("t", seq_len=SEQ, global_batch=batch,
                                kind="train")
            oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), **{
                "lr": 0.5, "H": 4, "warmup_steps": 0,
                "use_kernels": use_kernels, "flat": flat, **opt_kw})
            res = train_loop(_cfg(), shape, oc, steps=STEPS, seed=0,
                             n_workers=workers, non_iid=non_iid,
                             verbose=False, device="cpu",
                             init_params=params0)
            out[name] = (res, list(drifts))
    finally:
        sync_engine.SyncEngine.observe = observe
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_schedule_and_comm_bytes_match_exactly(reference, port_runs, name):
    ref, got = reference[1][name], port_runs[name][0]
    assert got.sync_steps == ref["sync_steps"]
    assert got.sync_count == ref["sync_count"]
    assert got.comm_bytes_total == ref["comm_bytes_total"]
    assert got.comm_bytes_modeled == ref["comm_bytes_modeled"]
    assert got.n_workers == ref["n_workers"] == _run(name)[4]
    if RUNS[name][0].get("policy") != "adaptive":
        assert got.sync_steps == [3, 7]


@pytest.mark.parametrize("name", list(RUNS))
def test_loss_curve_matches(reference, port_runs, name):
    ref, got = reference[1][name], port_runs[name][0]
    assert len(got.losses) == STEPS
    np.testing.assert_allclose(got.losses, ref["losses"], rtol=LOSS_RTOL)


def test_adaptive_policy_takes_reference_decisions(reference):
    ref = reference[1]["adaptive_bf16"]
    policy = AdaptiveSyncPolicy(THRESHOLD, h_min=1, h_max=16)
    for step, drift in enumerate(ref["drift"]):
        policy.observe(step, policy.want_sync(step), {"drift": drift})
    assert policy.sync_steps == ref["sync_steps"]
    assert policy.sync_steps, "threshold never crossed: the test pins nothing"


def test_adaptive_drift_stream_matches(reference, port_runs):
    ref = reference[1]["adaptive_bf16"]
    got, drift = port_runs["adaptive_bf16"]
    np.testing.assert_allclose(drift, ref["drift"], rtol=DRIFT_RTOL)
    assert got.sync_steps == ref["sync_steps"]


def test_staleness_schedule_has_margin(reference, port_runs):
    """The grad-staleness run: the port's policy fed the reference's drift
    stream takes its decisions, the port's stream agrees to DRIFT_RTOL, and
    both schedules sync at least once."""
    ref = reference[1]["adaptive_staleness_bf16"]
    got, drift = port_runs["adaptive_staleness_bf16"]
    policy = AdaptiveSyncPolicy(STALENESS_THRESHOLD, h_min=1, h_max=16)
    for step, d in enumerate(ref["drift"]):
        policy.observe(step, policy.want_sync(step), {"drift": d})
    assert policy.sync_steps == ref["sync_steps"] == got.sync_steps
    assert got.sync_steps
    np.testing.assert_allclose(drift, ref["drift"], rtol=DRIFT_RTOL)


def _cli_run(tmp_path, *flags, sync_steps=(3, 7)):
    out = tmp_path / "r.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "biglstm", "--reduced", "--use-kernels", "--compress",
         "int8", "--steps", "8", "--batch", "8", "--seq", "16",
         "--workers", "2", "--out", str(out), *flags],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(out.read_text())
    assert res["sync_steps"] == list(sync_steps)
    assert all(np.isfinite(res["losses"]))
    return res


def test_cli_smoke(tmp_path):
    _cli_run(tmp_path)


@pytest.mark.parametrize("flags", [["--flat"], ["--flat", "--unfused-sync"]])
def test_cli_smoke_flat(tmp_path, flags):
    """The slice-2 flags run (they raised before the flat plane and the
    quantize pair were ported), with the per-leaf run's losses."""
    flat = _cli_run(tmp_path, *flags)
    leaf = _cli_run(tmp_path)
    np.testing.assert_allclose(flat["losses"], leaf["losses"], rtol=1e-6)


def test_cli_trace(tmp_path):
    """--trace writes a span timeline that the Chrome export and the
    replay gate read (``--trace`` raised before slice 4)."""
    trace = tmp_path / "t.json"
    _cli_run(tmp_path, f"--trace={trace}")
    from repro_torch.trace import Trace
    t = Trace.load(str(trace))
    steps = t.by_name("local_step")
    assert len(steps) == 2 * 8
    assert sorted({s.step for s in t.by_name("collective")}) == [3, 7]
    assert all("grad_norm" in s.args and "b2" in s.args for s in steps)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    for mod, args in (("chrome", ["-o", str(tmp_path / "c.json")]),
                      ("replay", ["--check"])):
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.trace.{mod}", str(trace),
             *args], capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr
    assert json.loads((tmp_path / "c.json").read_text())["traceEvents"]


def test_cli_metrics(tmp_path):
    """--metrics streams one JSONL row a step after a header, with the
    Prometheus textfile beside it (``--metrics`` raised before slice 4)."""
    _cli_run(tmp_path, f"--metrics={tmp_path / 'm.jsonl'}")
    rows = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert rows[0]["stream"] == "repro.obs.metrics"
    assert [r["step"] for r in rows[1:]] == list(range(8))
    assert all("grad_norm" in r["metrics"] for r in rows[1:])
    assert "# TYPE repro_loss gauge" in (tmp_path / "m.prom").read_text()


def test_cli_checkpoint(tmp_path):
    """--checkpoint-dir with --checkpoint-every saves, and a second run
    resumes from the latest checkpoint with the straight run's losses
    (``--checkpoint-dir`` raised before slice 4)."""
    straight = _cli_run(tmp_path)
    ck = tmp_path / "ck"
    first = _cli_run(tmp_path, "--steps=4", f"--checkpoint-dir={ck}",
                     "--checkpoint-every=4", sync_steps=[3])
    assert sorted(os.listdir(ck)) == ["step_4"]
    resumed = _cli_run(tmp_path, f"--checkpoint-dir={ck}", sync_steps=[7])
    assert resumed["start_step"] == 4 and resumed["steps"] == 4
    assert first["losses"] + resumed["losses"] == straight["losses"]


def test_default_device_is_cuda_or_raises(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.resolve_device(None)
    assert train.resolve_device("cpu").type == "cpu"


IMPORT_PATTERN = r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)"


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Nor ``ml_dtypes``: the port reads and writes bfloat16 checkpoints
    through 16-bit integer views. Every module is imported, the
    checkpoint, obs and trace subpackages included."""
    import re
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f}:{i}: {line}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if re.match(IMPORT_PATTERN, line)]
    assert not bad, bad
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "need = {'repro_torch.checkpoint.store', 'repro_torch.obs.health', 'repro_torch.obs.metrics', 'repro_torch.trace.events', 'repro_torch.trace.chrome', 'repro_torch.trace.replay', 'repro_torch.hardware'}\n"
            "assert need <= set(names), need - set(names)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro', 'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.'))]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)

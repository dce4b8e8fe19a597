"""The port's synchronous baselines against the JAX package's ``train_loop``.

``sgd``, ``adagrad`` (Algorithm 1) and ``adaalter`` (Algorithm 3): one
model over the global batch, the gradient applied every step. A subprocess
drives the reference (``repro.launch.train.train_loop``) for reduced Big
LSTM on a 2-device Auto-axis CPU mesh, where GSPMD splits the global batch
over the data axis and all-reduces the gradient; the port starts from the
same weights (``repro_torch.convert``) and trains one model on the CPU.

What must match:
  * the schedule (a round every step) and the comm bytes (a P-value fp32
    gradient all-reduce a step: 1,452,032 bytes at this size): exactly;
  * the loss curve: to LOSS_RTOL, as the local runs of
    ``tests/test_torch_train.py`` (bf16 parameters rounded at different
    places by the two frameworks, and the reference's batch split over two
    devices sums the gradient in another order).
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
from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                 reduced)
from repro_torch.launch.train import train_loop

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
SEQ, BATCH, STEPS = 16, 8, 8
BYTES_PER_STEP = 1_452_032          # 363,008 parameters x 4 bytes

RUNS = {
    # name: OptimizerConfig kwargs
    "sgd": dict(name="sgd"),
    "adagrad": dict(name="adagrad"),
    "adaalter": dict(name="adaalter"),
    "sgd_clip": dict(name="sgd", grad_clip=0.5),
    "adagrad_clip": dict(name="adagrad", grad_clip=0.5),
    "adaalter_clip": dict(name="adaalter", grad_clip=0.5),
    "adaalter_warmup3": dict(name="adaalter", warmup_steps=3),
    # the raw gradient's norm here is ~0.28: a 0.5 clip never fires, 0.1
    # scales every step
    "adagrad_clip_fires": dict(name="adagrad", grad_clip=0.1),
    "adaalter_clip_fires": dict(name="adaalter", grad_clip=0.1),
}

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.launch.train import train_loop
from repro.models import build_model

out, runs, seq, batch, steps = sys.argv[1], json.loads(sys.argv[2]), *map(int, sys.argv[3:6])
cfg = reduced(get_arch("biglstm"))
shape = ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
params0 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
leaves, _ = jax.tree_util.tree_flatten_with_path(params0)
np.savez(out + ".npz", **{jax.tree_util.keystr(k): np.asarray(v).view(np.uint16)
                          for k, v in leaves})
res = {}
for name, kw in runs.items():
    oc = OptimizerConfig(**{"lr": 0.5, "warmup_steps": 0, **kw})
    r = train_loop(cfg, shape, oc, steps=steps, seed=0, mesh=mesh,
                   verbose=False)
    res[name] = dict(losses=r.losses, sync_steps=r.sync_steps,
                     sync_count=r.sync_count, n_workers=r.n_workers,
                     comm_bytes_total=r.comm_bytes_total,
                     comm_bytes_modeled=r.comm_bytes_modeled)
json.dump(res, open(out + ".json", "w"))
"""


def _cfg():
    return reduced(get_arch("biglstm"))


def load_jax_params(npz_path, cfg):
    """The reference's initial weights (saved as uint16 views) as tensors."""
    with np.load(npz_path) as z:
        flat = dict(z)
    as_bf16 = lambda k: flat[k].view(ml_dtypes.bfloat16)
    return convert.to_torch({
        "embed": as_bf16("['embed']"), "head_w": as_bf16("['head_w']"),
        "head_b": as_bf16("['head_b']"),
        "cells": [{n: as_bf16(f"['cells'][{i}]['{n}']")
                   for n in ("b", "wh", "wp", "wx")}
                  for i in range(cfg.n_layers)]})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_sync_ref") / "ref")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", REF_SCRIPT, out, json.dumps(RUNS),
                    str(SEQ), str(BATCH), str(STEPS)],
                   check=True, env=env, timeout=600)
    with open(out + ".json") as f:
        return load_jax_params(out + ".npz", _cfg()), json.load(f)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_runs(reference):
    params0, _ = reference
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    return {name: train_loop(
        _cfg(), shape, OptimizerConfig(**{"lr": 0.5, "warmup_steps": 0,
                                          **kw}),
        steps=STEPS, seed=0, verbose=False, device="cpu",
        init_params=params0) for name, kw in RUNS.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_schedule_and_comm_bytes_match_exactly(reference, port_runs, name):
    ref, got = reference[1][name], port_runs[name]
    assert got.n_workers == ref["n_workers"] == 1
    assert got.sync_steps == ref["sync_steps"] == list(range(STEPS))
    assert got.sync_count == ref["sync_count"] == STEPS
    assert got.comm_bytes_total == ref["comm_bytes_total"] \
        == STEPS * BYTES_PER_STEP
    assert got.comm_bytes_modeled == ref["comm_bytes_modeled"] \
        == BYTES_PER_STEP


@pytest.mark.parametrize("name", list(RUNS))
def test_loss_curve_matches(reference, port_runs, name):
    ref, got = reference[1][name], port_runs[name]
    assert len(got.losses) == STEPS
    np.testing.assert_allclose(got.losses, ref["losses"], rtol=LOSS_RTOL)


def test_clip_and_warmup_change_the_run(port_runs):
    """The variants are not the plain runs under another name: a clip that
    fires and a 3-step warm-up each move the loss curve."""
    base = port_runs["adaalter"].losses
    for name in ("adaalter_clip_fires", "adaalter_warmup3"):
        assert max(abs(a - b) for a, b in
                   zip(port_runs[name].losses[1:], base[1:])) > 1e-4, name


def test_synchronous_step_calls_no_kernel_wrapper(monkeypatch):
    """The baselines run plain tensor ops, as the reference's synchronous
    branch runs ``opt.update`` in jnp: even with ``use_kernels`` no kernel
    wrapper is called (``chip_smoke.py`` checks zero launches on the
    card)."""
    from repro_torch.kernels import adaalter_update, ops, quantize, sync_fused

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    for mod, name in ((adaalter_update, "fused_update"),
                      (adaalter_update, "flat_fused_update"),
                      (ops, "fused_update"),
                      (sync_fused, "fused_ef_blocks"),
                      (sync_fused, "flat_ef_blocks"),
                      (quantize, "quantize_blocks"),
                      (quantize, "dequantize_blocks")):
        monkeypatch.setattr(mod, name, refuse)
    shape = ShapeConfig("t", seq_len=8, global_batch=4, kind="train")
    for opt in ("sgd", "adagrad", "adaalter"):
        res = train_loop(_cfg(), shape,
                         OptimizerConfig(name=opt, use_kernels=True,
                                         warmup_steps=0),
                         steps=2, verbose=False, device="cpu")
        assert all(np.isfinite(res.losses))


def test_synchronous_optimizer_refuses_workers():
    from repro_torch.launch.steps import build_train_programs
    with pytest.raises(ValueError, match="synchronous optimizer"):
        build_train_programs(_cfg(), OptimizerConfig(name="sgd"),
                             n_workers=2, device="cpu")


def _cli(tmp_path, *flags):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "biglstm", "--reduced", "--steps", "4", "--batch", "8",
         "--seq", "16", *flags],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)


def test_cli_runs_adaalter(tmp_path):
    proc = _cli(tmp_path, "--optimizer", "adaalter", "--out", "r.json")
    assert proc.returncode == 0, proc.stderr
    res = json.loads((tmp_path / "r.json").read_text())
    assert res["n_workers"] == 1 and res["sync_steps"] == [0, 1, 2, 3]
    assert res["comm_bytes_total"] == 4 * BYTES_PER_STEP
    assert all(np.isfinite(res["losses"]))


def test_cli_refuses_workers_with_a_synchronous_optimizer(tmp_path):
    proc = _cli(tmp_path, "--optimizer", "sgd", "--workers", "2")
    assert proc.returncode == 2
    assert "synchronous optimizer" in proc.stderr

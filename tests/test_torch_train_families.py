"""Every transformer family through the port's ``train_loop`` against the
JAX package's.

Reduced float32 hymba-1.5b, qwen2-7b, phi3.5-moe, mamba2-370m,
llama-3.2-vision-11b and seamless-m4t-large-v2 (2 layers, d_model 256,
vocab 512): Local AdaAlter, 2 workers, H = 4, int8 wire with error
feedback, ``use_kernels`` (``use_pallas`` on the reference side; the
port's kernels take their plain versions on CPU tensors), 4 steps; and on
hymba one run over the flat plane and one synchronous ``adaalter`` run.
Three subprocesses drive the reference side by side on 2-device Auto-axis
CPU meshes and dump its results, its initial weights and, of the hymba
run, its checkpoint at step 4; the port starts from the same weights and
trains on the CPU. lr 2 moves the losses enough that a wrong step size
shows.

What must match:
  * the sync schedule and the comm bytes (measured and modeled): exactly;
  * the loss curves: to LOSS_RTOL. Measured: 1.6e-7 relative or less, and
    6.3e-7 for the MoE, whose losses climb from 6.3 to 7.5 nats at lr 2.
    A run with η 2% larger must leave the tolerance (measured: 2.9e-4 on
    hymba to 4.6e-2 on phi3.5-moe). The synchronous run's three updates
    move the loss less (η 2% off: 6.8e-5), so its fault is η 5% off;
  * hymba's checkpoint (21 stacked leaves, their B², residuals and the
    SyncState): the reference's manifest is the port's, the port restores
    it bitwise, and resumed to step 8 it trains as the port's straight run
    does (LOSS_RTOL).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCHS, OptimizerConfig, ShapeConfig,
                                 SyncConfig, get_arch, reduced)
from repro_torch.launch.steps import build_train_programs
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.tree import leaves, unflatten_like

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
LR = 2.0
SEQ, BATCH, STEPS = 16, 8, 4
INT8 = {"compression": "int8"}

RUNS = {
    # name: (arch, SyncConfig kwargs, OptimizerConfig kwargs, η fault)
    "hymba": ("hymba-1.5b", INT8, {"use_kernels": True}, 1.02),
    "qwen2": ("qwen2-7b", INT8, {"use_kernels": True}, 1.02),
    "phi3.5_moe": ("phi3.5-moe-42b-a6.6b", INT8, {"use_kernels": True},
                   1.02),
    "mamba2": ("mamba2-370m", INT8, {"use_kernels": True}, 1.02),
    "llama3.2_vision": ("llama-3.2-vision-11b", INT8, {"use_kernels": True},
                        1.02),
    "seamless_m4t": ("seamless-m4t-large-v2", INT8, {"use_kernels": True},
                     1.02),
    "hymba_flat": ("hymba-1.5b", INT8, {"use_kernels": True, "flat": True},
                   1.02),
    "hymba_adaalter": ("hymba-1.5b", {}, {"name": "adaalter"}, 1.05),
}
# the reference's runs, one subprocess a group (each ~45-75 s, most of it
# compiling the local and the sync step)
GROUPS = [["hymba", "hymba_flat"], ["phi3.5_moe", "mamba2", "hymba_adaalter"],
          ["qwen2", "llama3.2_vision", "seamless_m4t"]]
CKPT_RUN = "hymba"               # the reference saves its state at STEPS

REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.launch.train import train_loop
from repro.models import build_model

out, runs = sys.argv[1], json.loads(sys.argv[2])
lr, seq, batch, steps = float(sys.argv[3]), *map(int, sys.argv[4:7])
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
shape = ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")
res, arrays = {}, {}
for name, (arch, sync_kw, opt_kw, ckpt) in runs.items():
    cfg = dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32")
    if arch not in arrays:
        p0 = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
        arrays[arch] = [np.asarray(x) for x in jax.tree_util.tree_leaves(p0)]
    opt_kw = {("use_pallas" if k == "use_kernels" else k): v
              for k, v in opt_kw.items()}
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), **{
        "lr": lr, "H": 4, "warmup_steps": 0, **opt_kw})
    ck = dict(checkpoint_dir=f"{out}_ck_{name}", checkpoint_every=steps)
    r = train_loop(cfg, shape, oc, steps=steps, seed=0, mesh=mesh,
                   verbose=False, **(ck if ckpt else {}))
    res[name] = dict(losses=r.losses, sync_steps=r.sync_steps,
                     sync_count=r.sync_count, n_workers=r.n_workers,
                     comm_bytes_total=r.comm_bytes_total,
                     comm_bytes_modeled=r.comm_bytes_modeled)
np.savez(out + ".npz", **{f"{a}/{i}": x for a, xs in arrays.items()
                          for i, x in enumerate(xs)})
json.dump(res, open(out + ".json", "w"))
"""


def _cfg(arch):
    return dataclasses.replace(reduced(get_arch(arch)), param_dtype="float32")


def _params0(z, arch):
    """The reference's initial weights, poured into the port's tree (both
    walk their leaves in sorted-key order)."""
    abstract = build_model(_cfg(arch)).init(None, "meta")
    return unflatten_like(abstract, [
        torch.from_numpy(z[f"{arch}/{i}"])
        for i in range(len(leaves(abstract)))])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{name: the reference's result}, {arch: initial weights}."""
    tmp = tmp_path_factory.mktemp("jax_families")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = []
    for i, group in enumerate(GROUPS):
        runs = {n: (*RUNS[n][:3], n == CKPT_RUN) for n in group}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(tmp / f"ref{i}"),
             json.dumps(runs), str(LR), str(SEQ), str(BATCH), str(STEPS)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    try:
        errors = [p.communicate(timeout=900)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errors):
        assert p.returncode == 0, err[-4000:]
    results, params0 = {}, {}
    for i in range(len(GROUPS)):
        with open(tmp / f"ref{i}.json") as f:
            results.update(json.load(f))
        with np.load(tmp / f"ref{i}.npz") as z:
            for arch in {RUNS[n][0] for n in GROUPS[i]}:
                params0[arch] = _params0(z, arch)
    return results, params0, tmp / f"ref0_ck_{CKPT_RUN}"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_run(name, params0, lr, steps=STEPS, **kw):
    arch, sync_kw, opt_kw, _ = RUNS[name]
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), **{
        "lr": lr, "H": 4, "warmup_steps": 0, **opt_kw})
    workers = 1 if opt_kw.get("name") == "adaalter" else 2
    return train_loop(_cfg(arch), shape, oc, steps=steps, seed=0,
                      n_workers=workers, verbose=False, device="cpu",
                      init_params=params0[arch], **kw)


@pytest.fixture(scope="module")
def port_runs(reference):
    return {name: _port_run(name, reference[1], LR) for name in RUNS}


def _max_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", list(RUNS))
def test_schedule_and_comm_bytes_match_exactly(reference, port_runs, name):
    ref, got = reference[0][name], port_runs[name]
    assert got.sync_steps == ref["sync_steps"]
    assert got.sync_count == ref["sync_count"]
    assert got.n_workers == ref["n_workers"]
    assert got.comm_bytes_total == ref["comm_bytes_total"]
    assert got.comm_bytes_modeled == ref["comm_bytes_modeled"]
    if RUNS[name][2].get("name") == "adaalter":
        assert got.sync_steps == list(range(STEPS)) and got.n_workers == 1
    else:
        assert got.sync_steps == [3] and got.n_workers == 2


@pytest.mark.parametrize("name", list(RUNS))
def test_loss_curve_matches(reference, port_runs, name):
    ref, got = reference[0][name], port_runs[name]
    assert len(got.losses) == STEPS and all(np.isfinite(got.losses))
    np.testing.assert_allclose(got.losses, ref["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_a_wrong_step_size_leaves_the_tolerance(reference, name):
    """The loss comparison can see the update: the same run with η off by
    the run's fault factor misses the reference by more than LOSS_RTOL."""
    bad = _port_run(name, reference[1], LR * RUNS[name][3])
    assert _max_rel(bad.losses, reference[0][name]["losses"]) > LOSS_RTOL


def test_port_restores_the_reference_checkpoint_of_hymba(reference,
                                                        tmp_path):
    ref_dir = reference[2]
    straight = _port_run(CKPT_RUN, reference[1], LR, steps=2 * STEPS,
                         checkpoint_dir=str(tmp_path / "own"),
                         checkpoint_every=STEPS)
    want = json.loads((ref_dir / f"step_{STEPS}" / "manifest.json")
                      .read_text())
    got = json.loads((tmp_path / "own" / f"step_{STEPS}" / "manifest.json")
                     .read_text())
    assert {k: got[k] for k in ("keys", "dtypes", "shapes")} == {
        k: want[k] for k in ("keys", "dtypes", "shapes")}
    assert sum(k.startswith("#0/blocks/") for k in want["keys"]) == 18
    # the port's restore of the reference's arrays, bitwise
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.core.sync_engine import make_sync_engine
    arch, sync_kw, opt_kw, _ = RUNS[CKPT_RUN]
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), lr=LR, H=4,
                                   **opt_kw)
    programs = build_train_programs(_cfg(arch), oc, n_workers=2,
                                    device="cpu")
    like = (*programs.init_fn(0), make_sync_engine(oc, H=4).export_state())
    state, step = restore_checkpoint(str(ref_dir), like)
    assert step == STEPS
    with np.load(ref_dir / f"step_{STEPS}" / "arrays.npz") as z:
        for k, v in _flatten(state).items():
            v = v.numpy() if isinstance(v, torch.Tensor) else v
            assert v.tobytes() == z[k].tobytes(), k
    # resumed to 2 x STEPS from the reference's state
    d = tmp_path / "ref"
    shutil.copytree(ref_dir, d)
    resumed = _port_run(CKPT_RUN, reference[1], LR, steps=2 * STEPS,
                        checkpoint_dir=str(d))
    assert resumed.start_step == STEPS and resumed.sync_steps == [7]
    np.testing.assert_allclose(resumed.losses, straight.losses[STEPS:],
                               rtol=LOSS_RTOL)


def test_flat_plane_equals_per_leaf_on_hymba(port_runs):
    """hymba's 21 stacked leaves packed into one plane train as per leaf."""
    assert port_runs["hymba_flat"].losses == port_runs["hymba"].losses


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("optimizer", ["local_adaalter", "adaalter"])
def test_train_programs_build_for_every_family(arch, optimizer):
    """build_train_programs builds every ported architecture (reduced) and
    a sync round touches every leaf of its tree."""
    cfg = reduced(get_arch(arch))
    local = optimizer == "local_adaalter"
    oc = OptimizerConfig(name=optimizer, use_kernels=local,
                         compression="int8" if local else "")
    programs = build_train_programs(cfg, oc, n_workers=2 if local else 1,
                                    device="cpu")
    n = len(leaves(build_model(cfg).init(None, "meta")))
    assert programs.n_payload_leaves == n
    if arch == "hymba-1.5b":
        assert n == 21

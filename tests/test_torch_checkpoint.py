"""The port's checkpoint store, and checkpoints across the two packages.

* The store alone (``repro_torch.checkpoint``), as ``tests/test_checkpoint.py``
  holds the reference's: exact round trip (bfloat16 included), the latest
  step, the manifest's keys, mismatches that raise, an overwrite, no
  ``.tmp`` left behind.
* The same on-disk format as the reference: for the same training state
  the manifest's keys, dtypes and shapes are the reference's, per leaf and
  flat, with the ``SyncState``, the int8 residuals and the ``g_anchor``,
  and for the synchronous AdaAlter.
* Across frameworks, both directions: reduced Big LSTM, Local AdaAlter
  with the adaptive policy and the int8 wire, 2 workers, per leaf and flat.
  A run of 5 steps saves at step 5 (sync at [2]), mid-window; a run
  resumed from it trains to step 9 (sync at [5, 8]). Each package restores
  the other's checkpoint bitwise and continues with the other's schedule,
  its losses within LOSS_RTOL of the other's own resumed run (the bound of
  ``tests/test_torch_train.py``). The reference runs in subprocesses on a
  2-device Auto-axis CPU mesh.
* In the port: a resumed run is bitwise the straight run (losses and final
  state), per leaf and flat; per-leaf -> flat and flat -> per-leaf restores
  continue with the straight run's state; a flat plane restores across
  worker counts that divide each other (2 -> 4, 2 -> 1) and is refused
  across others (2 -> 3), as the reference's ``adapt_flat_state`` is.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import (checkpoint_keys, checkpoint_layout,
                                    disk_like, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import (OptimizerConfig, ShapeConfig, SyncConfig,
                                 get_arch, reduced)
from repro_torch.core.sync_engine import SyncState, make_sync_engine
from repro_torch.launch.steps import build_train_programs
from repro_torch.launch.train import train_loop
from repro_torch.tree import leaves, tree_map

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
SEQ, BATCH = 16, 8
SAVE_AT, RESUME_TO = 5, 9
# adaptive int8: every accumulated drift value the schedule decides on sits
# >= 20% from this threshold (sync at [2], then [5, 8])
THRESHOLD = 0.002

# name: (optimizer, flat, SyncConfig kwargs, steps saved)
CKPTS = {
    "leaf": ("local_adaalter", False,
             dict(policy="adaptive", threshold=THRESHOLD,
                  compression="int8"), SAVE_AT),
    "flat": ("local_adaalter", True,
             dict(policy="adaptive", threshold=THRESHOLD,
                  compression="int8"), SAVE_AT),
    "staleness_leaf": ("local_adaalter", False,
                       dict(policy="adaptive", threshold=2.5,
                            drift_metric="grad_staleness",
                            compression="int8"), 2),
    "staleness_flat": ("local_adaalter", True,
                       dict(policy="adaptive", threshold=2.5,
                            drift_metric="grad_staleness",
                            compression="int8"), 2),
    "adaalter": ("adaalter", False, dict(), 2),
}
RESUMED = ("leaf", "flat")

REF_WRITE = r"""
import json, os, shutil, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.launch.train import train_loop
from repro.models import build_model

out, ckpts, resumed = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
seq, batch, resume_to = map(int, sys.argv[4:7])
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
for name, (opt, flat, sync_kw, steps) in ckpts.items():
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), name=opt, lr=0.5,
                                   H=4, warmup_steps=0, flat=flat)
    d = os.path.join(out, "ref_" + name)
    r = train_loop(cfg, shape, oc, steps=steps, seed=0, mesh=mesh,
                   checkpoint_dir=d, checkpoint_every=steps, verbose=False)
    res[name] = dict(losses=r.losses, sync_steps=r.sync_steps)
    if name in resumed:
        shutil.copytree(d, d + "_resumed")
        r = train_loop(cfg, shape, oc, steps=resume_to, seed=0, mesh=mesh,
                       checkpoint_dir=d + "_resumed", verbose=False)
        res[name].update(resumed_losses=r.losses,
                         resumed_sync_steps=r.sync_steps,
                         start_step=r.start_step)
json.dump(res, open(os.path.join(out, "ref.json"), "w"))
"""

REF_RESUME = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, ml_dtypes, numpy as np
from jax.sharding import AxisType
import repro.checkpoint
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.launch.train import train_loop

out, ckpts, resumed = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
seq, batch, resume_to = map(int, sys.argv[4:7])
cfg = reduced(get_arch("biglstm"))
shape = ShapeConfig("t", seq_len=seq, global_batch=batch, kind="train")
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
restored = []
restore = repro.checkpoint.restore_checkpoint
def recording_restore(directory, like, **kw):
    state, step = restore(directory, like, **kw)
    restored.append((directory, state))
    return state, step
repro.checkpoint.restore_checkpoint = recording_restore

def bitwise(directory, state):
    # the restored leaves against the arrays on disk, by their bit patterns
    step = repro.checkpoint.latest_step(directory)
    man = json.load(open(os.path.join(directory, f"step_{step}", "manifest.json")))
    with np.load(os.path.join(directory, f"step_{step}", "arrays.npz")) as z:
        disk = {k: z[k] for k in z.files}
    from repro.checkpoint.store import _flatten
    flat, _ = _flatten(state)
    ok = set(flat) == set(disk)
    for k, v in flat.items():
        a = np.asarray(v)
        want = disk[k]
        if man["dtypes"][k] == "bfloat16":
            ok &= a.dtype == ml_dtypes.bfloat16
            a = a.view(np.uint16)
        ok &= a.dtype == want.dtype and a.shape == want.shape
        ok &= a.tobytes() == want.tobytes()
    return bool(ok)

res = {}
for name in resumed:
    opt, flat, sync_kw, _ = ckpts[name]
    oc = OptimizerConfig.from_sync(SyncConfig(**sync_kw), name=opt, lr=0.5,
                                   H=4, warmup_steps=0, flat=flat)
    restored.clear()
    d = os.path.join(out, "port_" + name + "_for_ref")
    r = train_loop(cfg, shape, oc, steps=resume_to, seed=0, mesh=mesh,
                   checkpoint_dir=d, verbose=False)
    (directory, state), = restored
    res[name] = dict(losses=r.losses, sync_steps=r.sync_steps,
                     start_step=r.start_step,
                     restored_bitwise=bitwise(directory, state))
json.dump(res, open(os.path.join(out, "ref_resume.json"), "w"))
"""


def _cfg():
    return reduced(get_arch("biglstm"))


def _shape(batch=BATCH):
    return ShapeConfig("t", seq_len=SEQ, global_batch=batch, kind="train")


def _opt(name, **sync_over):
    opt, flat, sync_kw, _ = CKPTS[name]
    return OptimizerConfig.from_sync(SyncConfig(**{**sync_kw, **sync_over}),
                                     name=opt, lr=0.5, H=4, warmup_steps=0,
                                     flat=flat)


def _workers(name):
    return 1 if CKPTS[name][0] == "adaalter" else 2


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO / "src"),
            "JAX_PLATFORMS": "cpu"}


def _ref_args(out):
    return [str(out), json.dumps(CKPTS), json.dumps(list(RESUMED)),
            str(SEQ), str(BATCH), str(RESUME_TO)]


def _disk(directory):
    """{key: array as stored} and the manifest of the latest checkpoint."""
    step = latest_step(str(directory))
    path = Path(directory) / f"step_{step}"
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads((path / "manifest.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The reference's checkpoints and runs, then the port's from the same
    weights, then the reference resuming the port's checkpoints."""
    out = tmp_path_factory.mktemp("ckpt_x")
    subprocess.run([sys.executable, "-c", REF_WRITE, *_ref_args(out)],
                   check=True, env=_env(), timeout=900)
    ref = json.loads((out / "ref.json").read_text())
    with np.load(out / "params0.npz") as z:
        flat = dict(z)
    as_bf16 = lambda k: flat[k].view(ml_dtypes.bfloat16)
    cfg = _cfg()
    params0 = convert.to_torch({
        "embed": as_bf16("['embed']"), "head_w": as_bf16("['head_w']"),
        "head_b": as_bf16("['head_b']"),
        "cells": [{n: as_bf16(f"['cells'][{i}]['{n}']")
                   for n in ("b", "wh", "wp", "wx")}
                  for i in range(cfg.n_layers)]})
    port = {}
    for name, (_, _, _, steps) in CKPTS.items():
        d = out / ("port_" + name)
        r = train_loop(cfg, _shape(), _opt(name), steps=steps, seed=0,
                       n_workers=_workers(name), checkpoint_dir=str(d),
                       checkpoint_every=steps, verbose=False, device="cpu",
                       init_params=params0)
        port[name] = {"first": r}
        if name in RESUMED:
            shutil.copytree(d, str(d) + "_for_ref")
            shutil.copytree(d, str(d) + "_resumed")
            port[name]["resumed"] = train_loop(
                cfg, _shape(), _opt(name), steps=RESUME_TO, seed=0,
                n_workers=2, checkpoint_dir=str(d) + "_resumed",
                verbose=False, device="cpu", init_params=params0)
    subprocess.run([sys.executable, "-c", REF_RESUME, *_ref_args(out)],
                   check=True, env=_env(), timeout=900)
    ref_resume = json.loads((out / "ref_resume.json").read_text())
    return dict(out=out, ref=ref, port=port, ref_resume=ref_resume,
                params0=params0)


# --------------------------------------------------------------------------- #
# the store alone
# --------------------------------------------------------------------------- #
@pytest.fixture
def state():
    gen = torch.Generator().manual_seed(0)
    return {
        "params": {
            "w": torch.randn((8, 4), generator=gen).to(torch.bfloat16),
            "blocks": [{"a": torch.arange(5.0)}, {"a": torch.ones(5)}],
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "b2": {"w": torch.full((8, 4), 2.0)},
                "tprime": torch.tensor(3, dtype=torch.int32)},
    }


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes(), t.dtype, tuple(t.shape)
    a = np.asarray(t)
    return a.tobytes(), a.dtype, a.shape


def _same(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(_bits(x) == _bits(y)
                                      for x, y in zip(la, lb))


def test_roundtrip_exact(tmp_path, state):
    save_checkpoint(str(tmp_path), 7, state)
    restored, step = restore_checkpoint(str(tmp_path), state)
    assert step == 7
    assert _same(state, restored)
    assert restored["params"]["w"].dtype == torch.bfloat16


def test_latest_step_picks_max(tmp_path, state):
    d = str(tmp_path)
    assert latest_step(d) is None
    for s in (5, 20, 10):
        save_checkpoint(d, s, state)
    assert latest_step(d) == 20
    _, step = restore_checkpoint(d, state)
    assert step == 20


def test_checkpoint_keys_reads_manifest(tmp_path, state):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        checkpoint_keys(d)
    save_checkpoint(d, 4, (state, {"extra": torch.zeros(2)},
                           SyncState.make(3, 0.25)))
    keys = checkpoint_keys(d)
    assert "#0/opt/step" in keys and "#1/extra" in keys
    assert "#0/params/blocks/#1/a" in keys
    assert "#2/since" in keys and "#2/drift" in keys
    assert checkpoint_layout(d) == "per_leaf"


def test_structure_mismatch_raises(tmp_path, state):
    save_checkpoint(str(tmp_path), 1, state)
    bad = dict(state)
    bad["extra"] = torch.zeros(3)
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(str(tmp_path), bad)


def test_shape_mismatch_raises(tmp_path, state):
    save_checkpoint(str(tmp_path), 1, state)
    bad = {**state, "params": {**state["params"],
                               "w": torch.zeros((9, 4), dtype=torch.bfloat16)}}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), bad)


def test_overwrite_same_step(tmp_path, state):
    d = str(tmp_path)
    save_checkpoint(d, 3, state)
    state2 = {**state, "opt": {**state["opt"],
                               "step": state["opt"]["step"] + 1}}
    save_checkpoint(d, 3, state2)
    restored, _ = restore_checkpoint(d, state)
    assert int(restored["opt"]["step"]) == 8
    assert sorted(os.listdir(d)) == ["step_3"]


def test_no_tmp_left_behind(tmp_path, state):
    d = str(tmp_path)
    save_checkpoint(d, 2, state)
    save_checkpoint(d, 2, state)
    assert sorted(os.listdir(d)) == ["step_2"]
    assert sorted(os.listdir(tmp_path / "step_2")) == ["arrays.npz",
                                                       "manifest.json"]


def test_bfloat16_stored_as_uint16_view(tmp_path, state):
    """The reference's convention: the npz holds the bit patterns, the
    manifest the true dtype."""
    save_checkpoint(str(tmp_path), 1, state)
    arrays, man = _disk(tmp_path)
    assert arrays["params/w"].dtype == np.uint16
    assert man["dtypes"]["params/w"] == "bfloat16"
    assert man["dtypes"]["opt/step"] == "int32"
    assert arrays["params/w"].tobytes() == \
        state["params"]["w"].view(torch.int16).numpy().tobytes()


def test_syncstate_and_meta_templates(tmp_path, state):
    """NumPy leaves (the SyncState) restore as NumPy; a meta template
    restores on the CPU; disk_like takes the manifest's shapes."""
    d = str(tmp_path)
    ss = SyncState.make(2, 0.125)
    save_checkpoint(d, 1, (state, ss))
    meta = tree_map(lambda t: t.to("meta"), state)
    (got, got_ss), _ = restore_checkpoint(d, (meta, SyncState.make()))
    assert _same(state, got)
    assert got["params"]["w"].device.type == "cpu"
    assert isinstance(got_ss, SyncState)
    assert got_ss.since.dtype == np.int64 and int(got_ss.since) == 2
    assert got_ss.drift.dtype == np.float64 and float(got_ss.drift) == 0.125
    small = {**meta, "params": {
        **meta["params"], "w": torch.empty((2, 2), dtype=torch.bfloat16,
                                           device="meta")}}
    like = disk_like(d, (small, SyncState.make()))
    assert tuple(like[0]["params"]["w"].shape) == (8, 4)


# --------------------------------------------------------------------------- #
# the reference's format
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(CKPTS))
def test_manifest_matches_reference(work, name):
    _, ref = _disk(work["out"] / ("ref_" + name))
    _, got = _disk(work["out"] / ("port_" + name))
    assert got["keys"] == ref["keys"]
    assert got["dtypes"] == ref["dtypes"]
    assert got["shapes"] == ref["shapes"]
    assert got["step"] == ref["step"] == CKPTS[name][3]
    keys = set(got["keys"])
    assert {"#2/since", "#2/drift"} <= keys
    if name != "adaalter":
        assert any(k.startswith("#1/res_params") for k in keys)
    if name.startswith("staleness"):
        assert any(k.startswith("#1/g_anchor") for k in keys)
    assert ("#0" in keys) == name.endswith("flat")


@pytest.mark.parametrize("name", RESUMED)
def test_reference_checkpoint_restores_bitwise(work, name):
    d = str(work["out"] / ("ref_" + name))
    programs = build_train_programs(_cfg(), _opt(name), n_workers=2,
                                    device="cpu")
    params, opt_state = programs.init_fn(0)
    engine = make_sync_engine(_opt(name), H=programs.H)
    state, step = restore_checkpoint(d, (params, opt_state,
                                         engine.export_state()))
    assert step == SAVE_AT
    from repro_torch.checkpoint.store import _flatten
    arrays, man = _disk(d)
    flat = _flatten(state)
    assert set(flat) == set(arrays)
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            assert str(v.dtype).replace("torch.", "") == man["dtypes"][k]
            v = v.view(torch.int16).numpy().view(np.uint16) \
                if v.dtype == torch.bfloat16 else v.numpy()
        assert v.shape == arrays[k].shape, k
        assert v.tobytes() == arrays[k].tobytes(), k


@pytest.mark.parametrize("name", RESUMED)
def test_port_resumes_reference_checkpoint(work, tmp_path, name):
    ref = work["ref"][name]
    assert ref["sync_steps"] == [2] and ref["resumed_sync_steps"] == [5, 8]
    d = tmp_path / "ck"
    shutil.copytree(work["out"] / ("ref_" + name), d)
    got = train_loop(_cfg(), _shape(), _opt(name), steps=RESUME_TO, seed=0,
                     n_workers=2, checkpoint_dir=str(d), verbose=False,
                     device="cpu", init_params=work["params0"])
    assert got.start_step == ref["start_step"] == SAVE_AT
    assert got.sync_steps == ref["resumed_sync_steps"]
    np.testing.assert_allclose(got.losses, ref["resumed_losses"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", RESUMED)
def test_reference_resumes_port_checkpoint(work, name):
    back, own = work["ref_resume"][name], work["port"][name]
    assert own["first"].sync_steps == [2]
    assert back["restored_bitwise"]
    assert back["start_step"] == own["resumed"].start_step == SAVE_AT
    assert back["sync_steps"] == own["resumed"].sync_steps == [5, 8]
    np.testing.assert_allclose(back["losses"], own["resumed"].losses,
                               rtol=LOSS_RTOL)


# --------------------------------------------------------------------------- #
# resumes within the port
# --------------------------------------------------------------------------- #
def _final_state(tmp_path, tag, opt_cfg, workers=2, batch=BATCH, **kw):
    """Train to RESUME_TO saving only there; the losses and the saved
    arrays."""
    d = tmp_path / tag
    res = train_loop(_cfg(), _shape(batch), opt_cfg, steps=RESUME_TO,
                     seed=0, n_workers=workers, checkpoint_dir=str(d),
                     checkpoint_every=RESUME_TO, verbose=False, device="cpu",
                     **kw)
    return res, _disk(d)[0]


@pytest.mark.parametrize("name", RESUMED)
def test_resume_is_bitwise_the_straight_run(work, tmp_path, name):
    """Losses and final state of 5 + 4 steps equal those of 9 straight."""
    straight, s_arrays = _final_state(tmp_path, "straight", _opt(name),
                                      init_params=work["params0"])
    d = tmp_path / "resumed"
    shutil.copytree(work["out"] / ("port_" + name), d)
    resumed = train_loop(_cfg(), _shape(), _opt(name), steps=RESUME_TO,
                         seed=0, n_workers=2, checkpoint_dir=str(d),
                         checkpoint_every=RESUME_TO, verbose=False,
                         device="cpu", init_params=work["params0"])
    r_arrays, _ = _disk(d)
    first = work["port"][name]["first"]
    assert first.losses + resumed.losses == straight.losses
    assert first.sync_steps + resumed.sync_steps == straight.sync_steps
    assert set(r_arrays) == set(s_arrays)
    for k in s_arrays:
        assert r_arrays[k].tobytes() == s_arrays[k].tobytes(), k


@pytest.mark.parametrize("src,dst", [("leaf", "flat"), ("flat", "leaf")])
def test_resume_across_layouts(work, tmp_path, src, dst):
    """A checkpoint of one layout restores into the other (fixed H = 4,
    so the schedule is layout-free) and continues with the state the
    straight run of the other layout reaches: bitwise, as flat = per-leaf
    is bitwise."""
    fixed = dict(policy="fixed_h")
    ck = tmp_path / "ck"
    train_loop(_cfg(), _shape(), _opt(src, **fixed), steps=SAVE_AT, seed=0,
               n_workers=2, checkpoint_dir=str(ck), checkpoint_every=SAVE_AT,
               verbose=False, device="cpu", init_params=work["params0"])
    assert checkpoint_layout(str(ck)) == ("flat" if src == "flat"
                                          else "per_leaf")
    resumed = train_loop(_cfg(), _shape(), _opt(dst, **fixed),
                         steps=RESUME_TO, seed=0, n_workers=2,
                         checkpoint_dir=str(ck), checkpoint_every=RESUME_TO,
                         verbose=False, device="cpu",
                         init_params=work["params0"])
    straight, s_arrays = _final_state(tmp_path, "straight",
                                      _opt(dst, **fixed),
                                      init_params=work["params0"])
    assert resumed.start_step == SAVE_AT and resumed.sync_steps == [7]
    np.testing.assert_allclose(resumed.losses, straight.losses[SAVE_AT:],
                               rtol=1e-6)
    r_arrays, man = _disk(ck)
    assert checkpoint_layout(str(ck)) == ("flat" if dst == "flat"
                                          else "per_leaf")
    for k in s_arrays:
        assert r_arrays[k].tobytes() == s_arrays[k].tobytes(), k


@pytest.mark.parametrize("workers", [4, 1])
def test_flat_plane_across_worker_counts(work, tmp_path, workers):
    """A 2-worker flat plane restores under 4 workers (rows replicated) and
    under 1 (the two rows' fp32 mean; identical rows pass through), and
    trains on; the global batch keeps 4 sequences a worker."""
    ck = tmp_path / "ck"
    shutil.copytree(work["out"] / "port_flat", ck)
    res = train_loop(_cfg(), _shape(4 * workers), _opt("flat"),
                     steps=RESUME_TO, seed=0, n_workers=workers,
                     checkpoint_dir=str(ck), checkpoint_every=RESUME_TO,
                     verbose=False, device="cpu")
    assert res.start_step == SAVE_AT and res.n_workers == workers
    assert all(np.isfinite(res.losses)) and len(res.losses) == 4
    arrays, man = _disk(ck)
    assert man["shapes"]["#0"][0] == workers
    # the restored window goes on: an adaptive sync in steps 5-8
    assert res.sync_steps and res.sync_steps[0] >= SAVE_AT


def test_flat_plane_refuses_worker_counts_that_do_not_divide(work, tmp_path):
    ck = tmp_path / "ck"
    shutil.copytree(work["out"] / "port_flat", ck)
    with pytest.raises(ValueError, match="one count must divide the other"):
        train_loop(_cfg(), _shape(12), _opt("flat"), steps=RESUME_TO,
                   seed=0, n_workers=3, checkpoint_dir=str(ck),
                   verbose=False, device="cpu")


def test_checkpoint_without_syncstate_restores(tmp_path):
    """A checkpoint written before the SyncState existed holds the
    (params, opt_state) pair: it restores, and the adaptive window starts
    afresh at the restored step."""
    opt = _opt("leaf")
    programs = build_train_programs(_cfg(), opt, n_workers=2, device="cpu")
    params, opt_state = programs.init_fn(0)
    save_checkpoint(str(tmp_path), 3, (params, opt_state))
    assert not any(k.startswith("#2/") for k in checkpoint_keys(str(tmp_path)))
    res = train_loop(_cfg(), _shape(), opt, steps=6, seed=0, n_workers=2,
                     checkpoint_dir=str(tmp_path), verbose=False,
                     device="cpu")
    assert res.start_step == 3 and len(res.losses) == 3
    assert all(np.isfinite(res.losses))

"""The cost table in ``train --trace``: ``launch/train.py::step_cost_tables``.

The reference attaches each compiled step's region table to a training
trace as ``meta["hlo_cost"]`` and its replay prices a sync round from the
tables' sync / local ratio. The port walks the local and the sync step
once on the ``meta`` device (``roofline/cost.py::step_cost``) and prices
them on the H100 (``hardware.py``); ``train_loop`` attaches the table
where the trace runs on the card. What must hold, on the CPU:

  * ``step_cost_tables``, called directly with CPU tensors, gives the
    reference's schema (``local_step``, ``sync_step``, ``hw``; each table
    the keys of the reference's ``region_table``), the sync step's optimal
    wall at least the local step's;
  * a trace carrying the table is priced alike by the port's replay and
    the reference's (``priced_from == "hlo_regions"``, the same
    prediction);
  * a CPU ``--trace`` run carries no ``hlo_cost`` and its replay prices
    from the warm means, its gate passing.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import (OptimizerConfig, ShapeConfig, SyncConfig,
                                 get_arch, reduced)
from repro_torch.data import SyntheticLM, make_train_batch
from repro_torch.hardware import H100
from repro_torch.launch.steps import build_train_programs
from repro_torch.launch.train import step_cost_tables, train_loop
from repro_torch.trace import Trace

SHAPE = ShapeConfig("trace", seq_len=16, global_batch=8, kind="train")


def _cfg():
    return reduced(get_arch("biglstm"), vocab=128)


def _opt(**kw):
    return OptimizerConfig.from_sync(
        SyncConfig(compression="int8"), name="local_adaalter", lr=0.5, H=3,
        warmup_steps=5, use_kernels=True, obs_metrics=True, **kw)


def _tables(flat=False):
    cfg, oc = _cfg(), _opt(flat=flat)
    progs = build_train_programs(cfg, oc, n_workers=2, device="cpu")
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SHAPE.seq_len,
                     n_workers=2, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(
        cfg, SHAPE, ds, 0, n_workers=2).items()}
    return step_cost_tables(cfg, oc, progs, batch)


def _reference_table_keys():
    """The keys of the reference's ``region_table`` and of its regions,
    from a small compiled program."""
    import jax
    import jax.numpy as jnp
    from repro.roofline import region_table
    x = jnp.ones((64, 64), jnp.float32)
    txt = jax.jit(lambda a: jnp.tanh(a @ a)).lower(x).compile().as_text()
    tab = region_table(txt, peak_flops=H100.peak_flops, hbm_bw=H100.hbm_bw)
    return set(tab), set(tab["regions"][0])


@pytest.mark.parametrize("flat", [False, True])
def test_table_has_the_reference_schema(flat):
    tabs = _tables(flat)
    assert set(tabs) == {"local_step", "sync_step", "hw"}
    assert tabs["hw"] == {"peak_flops": H100.peak_flops,
                          "hbm_bw": H100.hbm_bw}
    keys, region_keys = _reference_table_keys()
    for name in ("local_step", "sync_step"):
        tab = tabs[name]
        assert set(tab) == keys, name
        assert tab["regions"] and all(set(r) == region_keys
                                      for r in tab["regions"])
        assert tab["optimal_s"] == max(tab["flops"] / H100.peak_flops,
                                       tab["bytes"] / H100.hbm_bw) > 0
    # the round's encode and mean come on top of the local step's work
    assert tabs["sync_step"]["optimal_s"] >= tabs["local_step"]["optimal_s"]
    assert tabs["sync_step"]["bytes"] > tabs["local_step"]["bytes"]


def test_table_walk_leaves_the_counters():
    """The walk runs on ``meta``: no kernel launch and no collective is
    counted."""
    from repro_torch.core import comm
    from repro_torch.kernels import adaalter_update, sync_fused
    before = (adaalter_update.launches.n, sync_fused.launches.n,
              comm.wire.n, comm.side.n)
    _tables()
    assert (adaalter_update.launches.n, sync_fused.launches.n,
            comm.wire.n, comm.side.n) == before


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace_cost") / "run.trace.json"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_loop(_cfg(), SHAPE, _opt(), steps=12, n_workers=2,
                   verbose=False, device="cpu", trace_out=str(path))
    finally:
        torch.set_num_threads(n)
    return path


def test_cpu_trace_carries_no_cost_table(cpu_trace):
    from repro_torch.trace.replay import replay, validate
    trace = Trace.load(str(cpu_trace))
    assert "hlo_cost" not in trace.meta
    assert not any("hlo_optimal_s" in s.args
                   for s in trace.by_name("local_step"))
    assert not any("hlo_extra_optimal_s" in s.args
                   for s in trace.by_name("ef_encode"))
    assert replay(trace).priced_from == "warm_means"
    gate = validate(trace)
    assert gate["ok"] and gate["priced_from"] == "warm_means", gate


def test_table_prices_alike_in_both_replays(cpu_trace, tmp_path):
    """The CPU trace with ``step_cost_tables``' tables attached (as a card
    run attaches them): both packages' replays price its rounds from the
    tables, to the same prediction."""
    from repro.trace import Trace as RefTrace
    from repro.trace.replay import replay as ref_replay
    from repro.trace.replay import validate as ref_validate
    from repro_torch.trace.replay import replay, validate
    trace = Trace.load(str(cpu_trace))
    tabs = _tables()
    trace.meta["hlo_cost"] = tabs
    path = tmp_path / "with_cost.trace.json"
    trace.save(str(path))
    mine = replay(Trace.load(str(path)))
    theirs = ref_replay(RefTrace.load(str(path)))
    assert mine.priced_from == theirs.priced_from == "hlo_regions"
    rel = tabs["sync_step"]["optimal_s"] / tabs["local_step"][
        "optimal_s"] - 1.0
    assert rel > 0 and mine.sync_overhead_s == pytest.approx(
        rel * mine.compute_s / mine.steps * mine.sync_count)
    for key in ("wall_s", "compute_s", "comm_s", "sync_overhead_s",
                "sync_count"):
        assert getattr(mine, key) == getattr(theirs, key), key
    a, b = validate(Trace.load(str(path))), ref_validate(
        RefTrace.load(str(path)))
    assert a["priced_from"] == b["priced_from"] == "hlo_regions"
    assert a["predicted_wall_s"] == b["predicted_wall_s"]
    assert np.isfinite(a["ratio"])

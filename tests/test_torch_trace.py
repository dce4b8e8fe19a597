"""The port's trace subsystem (``repro_torch.trace``), and traces across
the two packages.

* As ``tests/test_trace.py`` holds the reference's: JSON and Chrome round
  trips lossless, unknown span kinds and schema versions rejected, the span
  stream's shape (one ``local_step`` per worker per step, ``ef_encode`` and
  ``collective`` on sync rounds), replay deterministic, the replayed
  schedule equal to the measured one, the ``validate`` gate passing, the
  H, threshold, bandwidth, flat, worker and codec what-ifs ordered as the
  reference's are, and the replay arithmetic on hand-built traces (warm
  means, and the HLO-priced overhead of reference traces).
* A port trace carries the H100's constants, no HLO costs, and modeled
  spans that equal the formulas under those constants.
* Across packages: the reference's ``Trace.load``, ``validate`` and
  ``replay`` accept a port trace and give the port's results, and the
  port's ``replay``, ``validate`` and sweeps of a reference trace give the
  reference's results exactly. The reference runs in a subprocess on a
  2-device Auto-axis CPU mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import (OptimizerConfig, ShapeConfig, SyncConfig,
                                 get_arch, reduced)
from repro_torch.core import comm
from repro_torch.hardware import H100
from repro_torch.trace import SPAN_KINDS, Trace, TraceRecorder
from repro_torch.trace.chrome import from_chrome, to_chrome
from repro_torch.trace.replay import (ReplayKnobs, replay, sweep_H,
                                      sweep_codecs, sweep_workers, validate)

REPO = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig(name="trace", seq_len=32, global_batch=8, kind="train")
STEPS = 16
WORKERS = 2

# what-if knob sets replayed by both packages; "fabric": "meta" stands for
# the FabricModel the trace records (each package builds it from the meta)
KNOB_SETS = [
    {},
    {"H": 1, "sync_policy": "fixed_h"},
    {"H": 6},
    {"fabric": "meta", "n_workers": 16, "codec": "int8"},
    {"bw_scale": 0.1, "n_workers": 8},
    {"fabric": "meta", "n_workers": 8, "flat": True},
    {"fabric": "meta", "n_workers": 8, "flat": False},
    {"sync_threshold": 0.0},
    {"sync_threshold": float("inf")},
    {"fabric": "meta", "n_workers": 4, "n_shards": 2},
    {"fabric": "meta", "n_workers": 8, "cross_pod": True},
]

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
from jax.sharding import AxisType
from repro.configs import OptimizerConfig, ShapeConfig, get_arch, reduced
from repro.configs.base import SyncConfig
from repro.core import comm
from repro.launch.train import train_loop
from repro.trace import Trace
from repro.trace.chrome import from_chrome, to_chrome
from repro.trace.replay import (ReplayKnobs, replay, sweep_H, sweep_codecs,
                                sweep_workers, validate)

out, knob_sets, port_traces = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
cfg = reduced(get_arch("biglstm"), vocab=128)
shape = ShapeConfig("trace", seq_len=32, global_batch=8, kind="train")
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ref_traces = {}
for policy, kw in (("fixed_h", {}),
                   ("adaptive", dict(threshold=0.002, h_min=2, h_max=6))):
    oc = OptimizerConfig.from_sync(SyncConfig(policy=policy, **kw),
                                   name="local_adaalter", lr=0.5, H=3,
                                   warmup_steps=5)
    path = os.path.join(out, f"ref_{policy}.trace.json")
    train_loop(cfg, shape, oc, steps=16, seed=0, mesh=mesh, verbose=False,
               trace_out=path)
    ref_traces[policy] = path

def knobs(trace, spec):
    spec = dict(spec)
    if spec.get("fabric") == "meta":
        spec["fabric"] = comm.FabricModel(**trace.meta["fabric"])
    return ReplayKnobs(**spec)

def results(path):
    t = Trace.load(path)
    return {"replays": [replay(t, knobs(t, s)).to_dict() for s in knob_sets],
            "validate": validate(t),
            "sweep_workers": sweep_workers(t), "sweep_H": sweep_H(t),
            "sweep_codecs": sweep_codecs(t),
            "chrome_lossless": from_chrome(json.loads(json.dumps(
                to_chrome(t)))).to_dict() == t.to_dict()}

res = {"ref": {p: results(path) for p, path in ref_traces.items()},
       "port": {p: results(path) for p, path in port_traces.items()},
       "ref_paths": ref_traces}
with open(os.path.join(out, "ref.json"), "w") as f:
    f.write(json.dumps(res, allow_nan=True))
"""


def _traced_run(policy, tmpdir, **sync_kw):
    from repro_torch.launch.train import train_loop
    cfg = reduced(get_arch("biglstm"), vocab=128)
    opt = OptimizerConfig.from_sync(SyncConfig(policy=policy, **sync_kw),
                                    name="local_adaalter", lr=0.5, H=3,
                                    warmup_steps=5)
    path = str(tmpdir / f"trace_{policy}.json")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = train_loop(cfg, SHAPE, opt, steps=STEPS, n_workers=WORKERS,
                         verbose=False, device="cpu", trace_out=path)
    finally:
        torch.set_num_threads(n)
    return res, Trace.load(path), path


@pytest.fixture(scope="module")
def fixed_h_run(tmp_path_factory):
    return _traced_run("fixed_h", tmp_path_factory.mktemp("fixed"))


@pytest.fixture(scope="module")
def adaptive_run(tmp_path_factory):
    return _traced_run("adaptive", tmp_path_factory.mktemp("adaptive"),
                       threshold=0.002, h_min=2, h_max=6)


def _knobs(trace, spec):
    spec = dict(spec)
    if spec.get("fabric") == "meta":
        spec["fabric"] = comm.FabricModel(**trace.meta["fabric"])
    return ReplayKnobs(**spec)


def _results(trace):
    return {"replays": [replay(trace, _knobs(trace, s)).to_dict()
                        for s in KNOB_SETS],
            "validate": validate(trace),
            "sweep_workers": sweep_workers(trace), "sweep_H": sweep_H(trace),
            "sweep_codecs": sweep_codecs(trace)}


def _jsonish(x):
    """What a value becomes through the reference's JSON dump."""
    return json.loads(json.dumps(x, allow_nan=True))


@pytest.fixture(scope="module")
def cross(tmp_path_factory, fixed_h_run, adaptive_run):
    out = tmp_path_factory.mktemp("trace_x")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    ports = {"fixed_h": fixed_h_run[2], "adaptive": adaptive_run[2]}
    subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                    json.dumps(KNOB_SETS), json.dumps(ports)],
                   check=True, env=env, timeout=900)
    return json.loads((out / "ref.json").read_text())


# --------------------------------------------------------------------------- #
# schema
# --------------------------------------------------------------------------- #
def test_recorder_rejects_unknown_span_kind():
    rec = TraceRecorder()
    with pytest.raises(ValueError, match="unknown span kind"):
        rec.add("not_a_kind", t0=0.0, dur=1.0)


def test_trace_json_roundtrip_lossless(fixed_h_run):
    _, trace, _ = fixed_h_run
    d = trace.to_dict()
    assert Trace.from_dict(json.loads(json.dumps(d))).to_dict() == d


def test_trace_version_gate():
    with pytest.raises(ValueError, match="schema version"):
        Trace.from_dict({"version": 999, "meta": {}, "spans": []})


def test_span_stream_shape(fixed_h_run):
    res, trace, _ = fixed_h_run
    assert all(s.name in SPAN_KINDS for s in trace.spans)
    steps = trace.by_name("local_step")
    assert len(steps) == res.n_workers * STEPS == WORKERS * STEPS
    assert sorted({s.step for s in steps if s.args["synced"]}) == \
        res.sync_steps == [2, 5, 8, 11, 14]
    for kind in ("ef_encode", "collective"):
        spans = trace.by_name(kind)
        assert len(spans) == WORKERS * res.sync_count
        assert sorted({s.step for s in spans}) == res.sync_steps
        assert all(s.modeled for s in spans)
    assert all(s.args["wire_bytes"] > 0 for s in trace.by_name("collective"))
    assert min(s.t0 for s in trace.spans) >= 0.0
    assert trace.meta["clock"] == "perf_counter"


def test_port_trace_carries_the_cards_constants(fixed_h_run):
    """H100 constants, no HLO costs, and modeled spans equal to the
    formulas under them (fp32 wire: the encode moves nothing)."""
    _, trace, _ = fixed_h_run
    meta = trace.meta
    assert "hlo_cost" not in meta
    assert meta["hbm_bw"] == H100.hbm_bw == 3.35e12
    assert meta["fabric"] == {"ici_bw": 450e9, "dcn_bw": 50e9,
                              "latency": 10e-6}
    assert meta["n_workers"] == WORKERS and meta["n_shards"] == 1
    n_params = meta["n_params"]
    round_b = comm.sync_payload_bytes("local_adaalter", n_params)
    n_coll = comm.round_collectives("local_adaalter",
                                    meta["n_payload_leaves"])
    want = comm.FabricModel().collective_time(round_b, n_coll, WORKERS)
    for s in trace.by_name("collective"):
        assert s.dur == want and s.args["wire_bytes"] == round_b
        assert s.args["n_collectives"] == n_coll == 22
    assert all(s.dur == 0.0 for s in trace.by_name("ef_encode"))
    assert all("hlo_optimal_s" not in s.args
               for s in trace.by_name("local_step"))


def test_int8_encode_span_is_priced_at_the_hbm_rate(tmp_path):
    from repro_torch.core.sync_engine import make_sync_engine
    res, trace, _ = _traced_run("fixed_h", tmp_path, compression="int8")
    eng = make_sync_engine(OptimizerConfig(compression="int8"))
    n = trace.meta["n_params"]
    assert eng.modeled_encode_hbm_bytes(n) == comm.ef_sync_hbm_bytes(
        2 * n, fused=True) == 16.0 * 2 * n
    for s in trace.by_name("ef_encode"):
        assert s.args["hbm_bytes"] == 32.0 * n
        assert s.dur == 32.0 * n / 3.35e12
        assert s.args["codec"] == "int8"


@pytest.mark.parametrize("algorithm,codec", [
    ("local_adaalter", ""), ("local_adaalter", "bf16"),
    ("local_adaalter", "int8"), ("local_sgd", "int8"), ("adaalter", "")])
def test_engine_accounting_matches_reference(algorithm, codec):
    """The sync engine's byte models that the trace meta and the spans
    carry equal the reference's for the same configuration."""
    from repro.configs import OptimizerConfig as JaxOptimizerConfig
    from repro.core.sync_engine import make_sync_engine as jax_engine
    from repro_torch.core.sync_engine import make_sync_engine
    n = 832_198_527
    is_local = algorithm.startswith("local")
    kw = dict(name=algorithm, compression=codec)
    mine = make_sync_engine(OptimizerConfig(**kw), is_local=is_local)
    ref = jax_engine(JaxOptimizerConfig(**kw), is_local=is_local)
    for shards in (1, 2, 8):
        assert mine.round_bytes_per_shard(n, shards) == \
            ref.round_bytes_per_shard(n, shards)
    assert mine.grad_allreduce_bytes(n) == ref.grad_allreduce_bytes(n)
    assert mine.modeled_encode_hbm_bytes(n) == ref.modeled_encode_hbm_bytes(n)
    if codec == "int8":
        for fused in (True, False, None):
            assert mine.encode_hbm_bytes(n, fused=fused) == \
                ref.encode_hbm_bytes(n, fused=fused)
    else:
        with pytest.raises(ValueError, match="int8"):
            mine.encode_hbm_bytes(n)
    for leaves, flat in ((11, False), (11, True)):
        assert mine.round_collectives(leaves, flat=flat) == \
            ref.round_collectives(leaves, flat=flat)


def test_adaptive_trace_records_drift_stream(adaptive_run):
    _, trace, _ = adaptive_run
    assert any(s.args["drift"] > 0 for s in trace.by_name("local_step"))


# --------------------------------------------------------------------------- #
# Chrome export
# --------------------------------------------------------------------------- #
def test_chrome_roundtrip_lossless(adaptive_run):
    _, trace, _ = adaptive_run
    doc = to_chrome(trace)
    assert from_chrome(json.loads(json.dumps(doc))).to_dict() == \
        trace.to_dict()


def test_chrome_has_rows_and_flow_arrows(fixed_h_run):
    res, trace, _ = fixed_h_run
    evs = to_chrome(trace)["traceEvents"]
    names = {e["args"]["name"] for e in evs if e.get("ph") == "M"
             and e["name"] == "process_name"}
    assert names == {f"worker {w}" for w in range(WORKERS)}
    flows = [e for e in evs if e.get("ph") in ("s", "f")]
    assert len(flows) == 2 * res.n_workers * res.sync_count


def test_chrome_cli_writes_the_export(fixed_h_run, tmp_path):
    _, trace, path = fixed_h_run
    out = tmp_path / "c.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.trace.chrome",
                           path, "-o", str(out)], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert from_chrome(json.loads(out.read_text())).to_dict() == \
        trace.to_dict()


def test_health_span_args_roundtrip_chrome(fixed_h_run):
    _, trace, _ = fixed_h_run
    a = from_chrome(to_chrome(trace)).by_name("local_step")[0]
    b = trace.by_name("local_step")[0]
    assert a.args["grad_norm"] == b.args["grad_norm"]
    assert a.args["b2"] == b.args["b2"]
    assert set(b.args["b2"]) == {"bfloat16"}


# --------------------------------------------------------------------------- #
# replay
# --------------------------------------------------------------------------- #
def test_replay_deterministic_bit_identical(adaptive_run):
    _, trace, _ = adaptive_run
    knobs = ReplayKnobs(fabric=comm.FabricModel(), n_workers=16,
                        codec="int8")
    assert replay(trace, knobs).to_dict() == replay(trace, knobs).to_dict()
    assert replay(trace).to_dict() == replay(trace).to_dict()


@pytest.mark.parametrize("which", ["fixed_h", "adaptive"])
def test_replayed_schedule_equals_measured(which, fixed_h_run, adaptive_run):
    res, trace, _ = fixed_h_run if which == "fixed_h" else adaptive_run
    r = replay(trace)
    assert r.sync_count == res.sync_count
    assert r.sync_steps == res.sync_steps
    assert r.priced_from == "warm_means"


@pytest.mark.parametrize("which", ["fixed_h", "adaptive"])
def test_validate_gate_passes(which, fixed_h_run, adaptive_run):
    _, trace, path = fixed_h_run if which == "fixed_h" else adaptive_run
    v = validate(trace)
    assert v["ok"], v
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.trace.replay",
                           path, "--check"], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_replay_h_knob_changes_schedule(fixed_h_run):
    _, trace, _ = fixed_h_run
    assert replay(trace, ReplayKnobs(H=1, sync_policy="fixed_h")
                  ).sync_count == STEPS
    assert replay(trace, ReplayKnobs(H=STEPS + 1, sync_policy="fixed_h")
                  ).sync_count == 0


def test_replay_h_knob_on_adaptive_trace_switches_to_fixed_h(adaptive_run):
    _, trace, _ = adaptive_run
    every = replay(trace, ReplayKnobs(H=1))
    assert every.policy == "fixed_h" and every.sync_count == STEPS


def test_knobs_report_flat_false(fixed_h_run):
    _, trace, _ = fixed_h_run
    assert replay(trace, ReplayKnobs(flat=False)).knobs == {"flat": False}


def test_replay_threshold_knob_uses_drift_stream(adaptive_run):
    res, trace, _ = adaptive_run
    lo = replay(trace, ReplayKnobs(sync_threshold=0.0))
    hi = replay(trace, ReplayKnobs(sync_threshold=float("inf")))
    assert lo.sync_count >= res.sync_count >= hi.sync_count
    assert lo.sync_count > hi.sync_count


def test_replay_baseline_has_no_wire_time(fixed_h_run):
    _, trace, _ = fixed_h_run
    base = replay(trace)
    assert base.comm_s == 0.0 and base.comm_fraction == 0.0
    with_fabric = replay(trace, ReplayKnobs(fabric=comm.FabricModel(),
                                            n_workers=8))
    assert with_fabric.comm_s > 0.0 and with_fabric.wall_s > base.wall_s


def test_bw_scale_knob_slows_the_wire(fixed_h_run):
    _, trace, _ = fixed_h_run
    fast = replay(trace, ReplayKnobs(bw_scale=1.0, n_workers=8))
    slow = replay(trace, ReplayKnobs(bw_scale=0.1, n_workers=8))
    assert slow.comm_s > fast.comm_s
    fab = comm.FabricModel()
    both = replay(trace, ReplayKnobs(fabric=fab, bw_scale=0.1, n_workers=8))
    only = replay(trace, ReplayKnobs(fabric=fab, n_workers=8))
    assert both.comm_s > only.comm_s


def test_flat_knob_reduces_collective_count(fixed_h_run):
    _, trace, _ = fixed_h_run
    fab = comm.FabricModel()
    per_leaf = replay(trace, ReplayKnobs(fabric=fab, n_workers=8, flat=False))
    flat = replay(trace, ReplayKnobs(fabric=fab, n_workers=8, flat=True))
    assert flat.n_collectives_per_round == 1
    assert per_leaf.n_collectives_per_round > 1
    assert flat.comm_s < per_leaf.comm_s


def test_comm_fraction_monotone_in_workers(adaptive_run):
    _, trace, _ = adaptive_run
    fracs = [r["comm_fraction"] for r in
             sweep_workers(trace, (1, 2, 4, 8, 16, 32))]
    assert all(b >= a for a, b in zip(fracs, fracs[1:]))
    assert fracs[0] == 0.0 and fracs[-1] > 0.0


def test_wall_monotone_in_H(fixed_h_run):
    _, trace, _ = fixed_h_run
    rows = sweep_H(trace, (1, 2, 4, 8, 16))
    walls = [r["wall_s"] for r in rows]
    assert all(b <= a for a, b in zip(walls, walls[1:]))
    assert rows[-1]["speedup_vs_first"] >= 1.0


def test_codec_sweep_orders_wire_volume(fixed_h_run):
    _, trace, _ = fixed_h_run
    rows = {r["codec"]: r for r in sweep_codecs(trace)}
    assert rows["fp32"]["round_wire_bytes"] > rows["bf16"]["round_wire_bytes"]
    assert rows["bf16"]["round_wire_bytes"] > rows["int8"]["round_wire_bytes"]
    assert rows["fp32"]["comm_s"] >= rows["bf16"]["comm_s"] >= \
        rows["int8"]["comm_s"]


# --------------------------------------------------------------------------- #
# replay arithmetic on hand-built traces
# --------------------------------------------------------------------------- #
def _hand_trace():
    rec = TraceRecorder(meta={
        "kind": "train", "algorithm": "local_adaalter", "n_params": 1000,
        "n_workers": 2, "steps": 6, "start_step": 0, "H": 3,
        "is_local": True, "flat": False,
        "sync": {"policy": "fixed_h", "threshold": 0.0, "h_min": 1,
                 "h_max": 12, "compression": "", "block": 256},
        "n_payload_leaves": 4,
        "fabric": dataclasses.asdict(comm.FabricModel()),
        "clock": "perf_counter",
        "sync_state0": {"since": 0, "drift": 0.0},
    })
    t = 0.0
    for step in range(6):
        synced = (step + 1) % 3 == 0
        dur = 3.0 if synced else 1.0          # sync overhead = 2.0
        for w in range(2):
            rec.add("local_step", worker=w, step=step, t0=t, dur=dur,
                    synced=synced, loss=1.0, drift=0.5)
        t += dur
    trace = rec.freeze()
    trace.meta["measured"] = {"wall_s": t, "sync_count": 2,
                              "sync_steps": [2, 5]}
    return trace


def test_nonfinite_meta_survives_strict_json(tmp_path):
    trace = _hand_trace()
    trace.meta["sync"]["threshold"] = float("inf")
    p = tmp_path / "inf.trace.json"
    trace.save(str(p))
    json.loads(p.read_text(), parse_constant=lambda s: pytest.fail(
        f"non-RFC JSON literal {s} in saved trace"))
    assert Trace.load(str(p)).meta["sync"]["threshold"] == float("inf")
    doc = json.loads(json.dumps(to_chrome(trace)), parse_constant=lambda s:
                     pytest.fail(f"non-RFC JSON literal {s} in export"))
    assert from_chrome(doc).meta["sync"]["threshold"] == float("inf")


def test_span_context_manager_records_on_exception():
    rec = TraceRecorder()
    with pytest.raises(RuntimeError):
        with rec.span("eval", step=3, tag="x"):
            raise RuntimeError("boom")
    (s,) = rec.spans
    assert s.name == "eval" and s.step == 3 and s.args["tag"] == "x"
    assert s.dur >= 0.0


def test_replay_rejects_dryrun_traces():
    trace = _hand_trace()
    trace.meta["kind"] = "dryrun"
    with pytest.raises(ValueError, match="train trace"):
        replay(trace)
    with pytest.raises(ValueError, match="train trace"):
        validate(trace)


def test_hand_trace_baseline_is_exact():
    trace = _hand_trace()
    r = replay(trace)
    assert r.wall_s == pytest.approx(10.0)
    assert r.compute_s == pytest.approx(6.0)
    assert r.sync_overhead_s == pytest.approx(4.0)
    assert r.sync_steps == [2, 5]
    assert validate(trace)["ok"]


def test_hand_trace_h_knob_arithmetic():
    r = replay(_hand_trace(), ReplayKnobs(H=6))
    assert r.sync_steps == [5] and r.wall_s == pytest.approx(8.0)


def test_warm_estimates_exclude_first_walls():
    rec = TraceRecorder(meta=_hand_trace().meta)
    durs = [(0, False, 5.0), (1, False, 1.0), (2, True, 7.0),
            (3, False, 1.0), (4, False, 1.0), (5, True, 3.0)]
    t = 0.0
    for step, synced, dur in durs:
        for w in range(2):
            rec.add("local_step", worker=w, step=step, t0=t, dur=dur,
                    synced=synced, loss=1.0, drift=0.5)
        t += dur
    trace = rec.freeze()
    trace.meta["measured"] = {"wall_s": t, "sync_count": 2,
                              "sync_steps": [2, 5]}
    assert replay(trace, ReplayKnobs(H=6)).wall_s == pytest.approx(8.0)
    v = validate(trace)
    assert v["ok"] and v["ratio"] == pytest.approx(1.0)
    assert v["measured_warm_wall_s"] == pytest.approx(10.0)
    assert v["measured_span_wall_s"] == pytest.approx(18.0)


def test_all_sync_trace_gate_excludes_first_wall():
    rec = TraceRecorder(meta={**_hand_trace().meta, "H": 1})
    t = 0.0
    for step in range(12):
        dur = 2.0 if step == 0 else 0.05
        for w in range(2):
            rec.add("local_step", worker=w, step=step, t0=t, dur=dur,
                    synced=True, loss=1.0, drift=0.0)
        t += dur
    trace = rec.freeze()
    trace.meta["measured"] = {"wall_s": t, "sync_count": 12,
                              "sync_steps": list(range(12))}
    v = validate(trace)
    assert v["ok"], v
    assert v["measured_warm_wall_s"] == pytest.approx(12 * 0.05)


def test_hand_trace_wire_term_matches_alpha_beta():
    fabric = comm.FabricModel()
    r = replay(_hand_trace(), ReplayKnobs(fabric=fabric, n_workers=8))
    per_round = comm.sync_payload_bytes("local_adaalter", 1000)
    expect = fabric.collective_time(per_round, 8, 8)    # 4 leaves x 2
    assert expect == 8 * 10e-6 + 2 * 7 / 8 * per_round / 450e9
    assert r.comm_s == pytest.approx(2 * expect)


def _with_hlo(trace, local_s, sync_s):
    trace.meta["hlo_cost"] = {
        "local_step": {"optimal_s": local_s, "flops": 1.0, "bytes": 1.0,
                       "regions": []},
        "sync_step": {"optimal_s": sync_s, "flops": 1.0, "bytes": 1.0,
                      "regions": []},
        "hw": {"peak_flops": 1.0, "hbm_bw": 1.0}}
    return trace


def test_hlo_priced_overhead_exact_arithmetic():
    """Reference traces carry HLO region costs; the port prices them as
    the reference does."""
    trace = _with_hlo(_hand_trace(), local_s=2e-3, sync_s=3e-3)
    r = replay(trace)
    assert r.priced_from == "hlo_regions"
    assert r.sync_overhead_s == pytest.approx(2 * 0.5 * 1.0)
    assert r.wall_s == pytest.approx(7.0)
    v = validate(trace)
    assert v["priced_from"] == "hlo_regions"
    assert v["ratio"] == pytest.approx(7.0 / 10.0)


def test_hlo_ratio_below_one_clamps_to_zero_overhead():
    r = replay(_with_hlo(_hand_trace(), local_s=3e-3, sync_s=2e-3))
    assert r.priced_from == "hlo_regions" and r.sync_overhead_s == 0.0


def test_hlo_meta_malformed_falls_back_to_warm_means():
    for bad in ({}, {"local_step": {}},
                {"local_step": {"optimal_s": 0.0},
                 "sync_step": {"optimal_s": 1.0}},
                {"local_step": {"optimal_s": "x"},
                 "sync_step": {"optimal_s": 1.0}}):
        trace = _hand_trace()
        trace.meta["hlo_cost"] = bad
        r = replay(trace)
        assert r.priced_from == "warm_means"
        assert r.sync_overhead_s == pytest.approx(4.0)


# --------------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["fixed_h", "adaptive"])
def test_reference_reads_and_validates_port_trace(cross, which, fixed_h_run,
                                                   adaptive_run):
    """The reference's Trace.load, validate, replay, sweeps and Chrome
    round trip take a port trace, and give the port's own results."""
    _, trace, _ = fixed_h_run if which == "fixed_h" else adaptive_run
    theirs = cross["port"][which]
    assert theirs["validate"]["ok"], theirs["validate"]
    assert theirs["chrome_lossless"]
    mine = _jsonish(_results(trace))
    for key in ("replays", "validate", "sweep_workers", "sweep_H",
                "sweep_codecs"):
        assert theirs[key] == mine[key], key


@pytest.mark.parametrize("which", ["fixed_h", "adaptive"])
def test_port_replays_reference_trace_exactly(cross, which):
    """The port's replay, validate and sweeps of a reference trace (HLO
    costs included) give exactly the reference's results."""
    trace = Trace.load(cross["ref_paths"][which])
    assert "hlo_cost" in trace.meta
    theirs = cross["ref"][which]
    mine = _jsonish(_results(trace))
    for key in ("replays", "validate", "sweep_workers", "sweep_H",
                "sweep_codecs"):
        assert theirs[key] == mine[key], key
    assert mine["replays"][0]["priced_from"] == "hlo_regions"
    assert from_chrome(json.loads(json.dumps(to_chrome(trace)))).to_dict() \
        == trace.to_dict()

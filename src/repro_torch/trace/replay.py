"""Trace-driven what-if replay: re-simulate a recorded run under new knobs.

The port's copy of the JAX package's ``trace/replay.py``: the same cost
model, knobs, sweeps and gate, so it replays a trace of either package and
gives the reference replay's results on a reference trace. A recorded
trace pins down the measured per-step compute, the measured extra of a
sync round, the drift stream the adaptive policy consumed, and the run's
configuration; replay re-prices that evidence under substituted knobs
(fabric, workers, H, threshold, codec, flat vs per-leaf collectives)
without re-running the model. Per replayed step::

    step_cost = compute + [sync round] (sync_overhead + wire_time)

  compute        the step's measured duration when it was a local step (the
                 first one, whose wall holds warm-up, replaced by the warm
                 mean of the rest); the warm mean local step when it was a
                 sync step;
  sync_overhead  the warm extra of a sync round: from the trace's
                 ``meta['hlo_cost']`` (sync/local roofline ratio anchored to
                 the warm local mean) when a reference trace carries one,
                 else warm mean(sync) − warm mean(local), clamped at >= 0.
                 Port traces carry no HLO costs (no HLO on the card), so
                 they take the second;
  wire_time      the alpha-beta ``core.comm.FabricModel.collective_time``
                 of the round under the replay's codec, workers and
                 collective count; 0 in the baseline replay (the recorded
                 workers share one device), the trace's fabric under
                 what-if knobs.

With no knob substituted the replayed wall equals the warm-corrected
measured wall and the replayed schedule the measured one: ``validate``
and ``--check`` gate both. Replay is host arithmetic: bit-identical when
repeated. Replayed times are modeled, not measured.

CLI::

  python -m repro_torch.trace.replay run.trace.json --check --tol 0.1
  python -m repro_torch.trace.replay run.trace.json --workers 32 --H 8 \
      --codec int8 --fabric-defaults
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import comm
from repro_torch.core.sync_policy import (AdaptiveSyncPolicy, FixedHPolicy,
                                    SyncPolicy)
from repro_torch.trace.events import Trace

#: codec names the replay accepts for the ``codec`` knob.
REPLAY_CODECS = ("fp32", "bf16", "int8")


# --------------------------------------------------------------------------- #
# knobs
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ReplayKnobs:
    """What-if substitutions; ``None`` keeps the recorded value.

    ``fabric`` attaches an alpha-beta fabric to the wire term (the recorded
    in-process run has none, so the baseline wire time is zero);
    ``bw_scale`` instead scales the trace's recorded fabric constants
    (ici/dcn bandwidth) — a one-knob "slower interconnect" sweep.
    """

    fabric: Optional[comm.FabricModel] = None
    bw_scale: Optional[float] = None
    n_workers: Optional[int] = None
    H: Optional[int] = None
    sync_policy: Optional[str] = None       # 'fixed_h' | 'adaptive'
    sync_threshold: Optional[float] = None
    h_min: Optional[int] = None
    h_max: Optional[int] = None
    codec: Optional[str] = None
    flat: Optional[bool] = None             # one collective vs per-leaf
    n_shards: Optional[int] = None          # FSDP/TP sub-planes per worker:
                                            # each device's collective moves
                                            # payload/n_shards (sharded flat)
    cross_pod: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)      # recurses into the FabricModel
        # report every SET knob — flat=False (--per-leaf) is a real
        # substitution; only unset (None) and the cross_pod default drop out
        out = {k: v for k, v in d.items() if v is not None}
        if not self.cross_pod:
            out.pop("cross_pod", None)
        return out


@dataclasses.dataclass
class ReplayResult:
    """One replayed timeline, summarized."""

    wall_s: float
    compute_s: float
    sync_overhead_s: float
    comm_s: float                 # modeled wire time (0 without a fabric)
    comm_fraction: float          # comm_s / wall_s
    sync_count: int
    sync_steps: List[int]
    steps: int
    n_workers: int
    codec: str
    policy: str
    n_collectives_per_round: int
    round_wire_bytes: float       # full logical payload of one round
    n_shards: int = 1
    round_wire_bytes_per_shard: float = 0.0   # what ONE device's collective
                                              # moves (= payload / n_shards;
                                              # the priced quantity)
    priced_from: str = "warm_means"   # "hlo_regions" when sync_overhead came
                                      # from the recorded per-region HLO costs
    knobs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------- #
# trace -> per-step records
# --------------------------------------------------------------------------- #
def _step_records(trace: Trace) -> List[Dict[str, Any]]:
    """One record per global step: measured dur (max across workers — the
    rendezvous worker), the recorded sync decision, and the drift statistic
    the policy consumed."""
    kind = trace.meta.get("kind", "train")
    if kind != "train":
        # a dryrun trace is a compile/model timeline whose per-pair step
        # indices restart at 0 — replaying it would silently merge
        # unrelated (arch, shape, mesh) pairs into one bogus run
        raise ValueError(f"replay needs a train trace (train --trace); "
                         f"this trace records kind={kind!r}")
    by_step: Dict[int, Dict[str, Any]] = {}
    for s in trace.spans:
        if s.name != "local_step":
            continue
        rec = by_step.setdefault(
            s.step, {"step": s.step, "dur": 0.0,
                     "synced": bool(s.args.get("synced", False)),
                     "drift": float(s.args.get("drift", 0.0))})
        rec["dur"] = max(rec["dur"], s.dur)
    if not by_step:
        raise ValueError("trace contains no local_step spans — was it "
                         "recorded with train --trace?")
    return [by_step[k] for k in sorted(by_step)]


def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def _warm_anatomy(records: List[Dict[str, Any]]):
    """(local durs, sync durs, warm local, warm sync) — the warm lists drop
    each step kind's first occurrence (its wall holds the warm-up: JIT
    compilation in the reference, CUDA and cuBLAS set-up on the card) when
    a second sample exists."""
    local = [r["dur"] for r in records if not r["synced"]]
    syncd = [r["dur"] for r in records if r["synced"]]
    warm_local = local[1:] if len(local) > 1 else local
    warm_sync = syncd[1:] if len(syncd) > 1 else syncd
    return local, syncd, warm_local, warm_sync


def _warm_compute_est(local, syncd, warm_local, warm_sync) -> float:
    """Steady-state per-step compute estimate. An all-sync recording
    (H=1) has no local samples at all — there the sync step IS the step,
    so its warm wall is the estimate (falling back to the raw all-records
    mean would fold the warm-up wall of step 0 into every replayed
    step and falsely fail the validate gate)."""
    if warm_local:
        return _mean(warm_local)
    if warm_sync:
        return _mean(warm_sync)
    return _mean(local + syncd)


def _hlo_rel_overhead(meta: Dict[str, Any]) -> Optional[float]:
    """Relative sync-step overhead from the recorded HLO per-region costs:
    ``sync_optimal_s / local_optimal_s − 1`` (clamped >= 0), or None when
    the trace carries no usable ``hlo_cost`` meta. Both optimal walls come
    from the same roofline (``roofline.region_table``), so the hardware
    scale cancels — the ratio anchors to the measured warm local mean."""
    hc = meta.get("hlo_cost")
    if not isinstance(hc, dict):
        return None
    try:
        local_s = float(hc["local_step"]["optimal_s"])
        sync_s = float(hc["sync_step"]["optimal_s"])
    except (KeyError, TypeError, ValueError):
        return None
    if not (local_s > 0.0 and sync_s > 0.0):
        return None
    return max(0.0, sync_s / local_s - 1.0)


def _make_policy(meta: Dict[str, Any], knobs: ReplayKnobs) -> SyncPolicy:
    sync = dict(meta.get("sync", {}))
    # a bare H knob means "replay the paper's fixed schedule at that
    # period", even over an adaptive-recorded trace (where H would
    # otherwise only seed the h_max default and silently change nothing)
    name = knobs.sync_policy or (
        "fixed_h" if knobs.H is not None
        else sync.get("policy", "fixed_h") or "fixed_h")
    H = int(knobs.H if knobs.H is not None else meta.get("H", 1))
    if name == "fixed_h":
        return FixedHPolicy(max(1, H))
    if name == "adaptive":
        thr = (knobs.sync_threshold if knobs.sync_threshold is not None
               else float(sync.get("threshold", 0.0)))
        h_min = int(knobs.h_min if knobs.h_min is not None
                    else sync.get("h_min", 1) or 1)
        h_max = int(knobs.h_max if knobs.h_max is not None
                    else sync.get("h_max", 0) or 4 * max(1, H))
        return AdaptiveSyncPolicy(threshold=thr, h_min=max(1, h_min),
                                  h_max=max(h_max, h_min, 1))
    raise ValueError(f"unknown sync_policy {name!r}")


def _schedule(trace: Trace, knobs: ReplayKnobs,
              records: List[Dict[str, Any]]) -> Tuple[List[int], str]:
    """Re-derive the sync schedule host-side from the recorded drift stream
    (no model run). With recorded knobs this reproduces the measured
    schedule exactly — the policy sees the identical inputs."""
    meta = trace.meta
    policy = _make_policy(meta, knobs)
    start = int(meta.get("start_step", 0))
    policy.reset(start)
    schedule_knobs = (knobs.H, knobs.sync_policy, knobs.sync_threshold,
                      knobs.h_min, knobs.h_max)
    if all(k is None for k in schedule_knobs):
        ss = meta.get("sync_state0")
        if ss:           # resume the mid-window state the run restored into
            policy.load_host_state(int(ss["since"]), float(ss["drift"]))
    for rec in records:
        want = policy.want_sync(rec["step"])
        policy.observe(rec["step"], want, {"drift": rec["drift"]})
    return list(policy.sync_steps), policy.name


# --------------------------------------------------------------------------- #
# the replay
# --------------------------------------------------------------------------- #
def _resolve_fabric(meta: Dict[str, Any],
                    knobs: ReplayKnobs) -> Optional[comm.FabricModel]:
    base = knobs.fabric
    if base is None and knobs.bw_scale is not None:
        base = comm.FabricModel(**meta.get("fabric", {}))
    if base is not None and knobs.bw_scale is not None:
        base = base.scaled(knobs.bw_scale)    # scales an explicit fabric too
    return base


def replay(trace: Trace, knobs: ReplayKnobs = ReplayKnobs()) -> ReplayResult:
    """Re-simulate the recorded timeline's critical path under ``knobs``."""
    meta = trace.meta
    records = _step_records(trace)
    algorithm = meta.get("algorithm", "local_adaalter")
    n_params = int(meta.get("n_params", 0))
    sync = dict(meta.get("sync", {}))
    block = int(sync.get("block", 256))
    codec = knobs.codec if knobs.codec is not None \
        else (sync.get("compression", "") or "fp32")
    if codec not in REPLAY_CODECS:
        raise ValueError(f"unknown replay codec {codec!r} "
                         f"(expected one of {REPLAY_CODECS})")
    n_workers = int(knobs.n_workers if knobs.n_workers is not None
                    else meta.get("n_workers", 1))
    flat = bool(knobs.flat if knobs.flat is not None
                else meta.get("flat", False))
    n_leaves = int(meta.get("n_payload_leaves", 1))
    n_coll = comm.round_collectives(algorithm, n_leaves, flat=flat)

    # measured anatomy of the recorded run — STEADY-STATE (warm): each
    # step kind's first occurrence is excluded from the estimates (its wall
    # holds the warm-up, and a what-if schedule must charge new sync rounds
    # the steady-state cost). The same warm model prices EVERY replay, so sweep
    # points stay comparable; ``validate`` holds the baseline against the
    # equally warm-corrected measured wall, where the means cancel and
    # the prediction is exact by construction.
    local_durs, sync_durs, warm_local, warm_sync = _warm_anatomy(records)
    compute_est = _warm_compute_est(local_durs, sync_durs, warm_local,
                                    warm_sync)
    # sync overhead: prefer the recorded HLO per-region cost model — the
    # roofline-optimal sync/local ratio anchored to the warm local mean.
    # This is program-structure-derived (deterministic), not a noisy
    # difference of two measured means, which is what lets the validate
    # gate run at a tighter tolerance. Requires a local anchor: on an
    # all-sync (H=1) recording compute_est already IS the warm sync mean,
    # and adding a ratio-priced extra on top would double-charge the round.
    rel = _hlo_rel_overhead(meta)
    if rel is not None and warm_local:
        sync_overhead = rel * compute_est
        priced_from = "hlo_regions"
    else:
        sync_overhead = max(0.0, _mean(warm_sync) - compute_est) \
            if warm_sync else 0.0
        priced_from = "warm_means"

    # the what-if schedule, from the recorded drift stream
    sync_steps, policy_name = _schedule(trace, knobs, records)

    # modeled wire time of one round under the knob fabric. With a sharded
    # flat plane (n_shards > 1) each device's worker-axis collective moves
    # only its sub-plane, so the alpha-beta model is charged the per-shard
    # payload, not the full plane (recorded in meta by train --trace; the
    # --shards knob sweeps it).
    fabric = _resolve_fabric(meta, knobs)
    n_shards = max(1, int(knobs.n_shards if knobs.n_shards is not None
                          else meta.get("n_shards", 1)))
    round_bytes = comm.sync_payload_bytes(algorithm, n_params,
                                          compression=codec, block=block)
    shard_bytes = round_bytes / n_shards
    wire_time = (fabric.collective_time(shard_bytes, n_coll, n_workers,
                                        cross_pod=knobs.cross_pod)
                 if fabric is not None else 0.0)

    n_sync = len(sync_steps)
    # recorded local steps keep their own measured walls (the first one
    # warm-substituted); recorded sync steps contribute the warm compute
    # estimate (their pure-compute part is not separately observable);
    # every replayed round pays the warm measured sync overhead + the
    # modeled wire transfer
    compute_s = (sum(warm_local) + (len(local_durs) - len(warm_local) +
                                    len(sync_durs)) * compute_est)
    overhead_s = n_sync * sync_overhead
    comm_s = n_sync * wire_time
    wall = compute_s + overhead_s + comm_s
    return ReplayResult(
        wall_s=wall, compute_s=compute_s, sync_overhead_s=overhead_s,
        comm_s=comm_s, comm_fraction=(comm_s / wall if wall else 0.0),
        sync_count=n_sync, sync_steps=sync_steps, steps=len(records),
        n_workers=n_workers, codec=codec, policy=policy_name,
        n_collectives_per_round=n_coll, round_wire_bytes=round_bytes,
        n_shards=n_shards, round_wire_bytes_per_shard=shard_bytes,
        priced_from=priced_from, knobs=knobs.to_dict())


# --------------------------------------------------------------------------- #
# validation (the CI perf gate)
# --------------------------------------------------------------------------- #
#: default predicted/measured wall tolerance — generous vs the exact-by-
#: construction baseline, so the gate only trips on real model drift.
DEFAULT_TOL = 0.1


def validate(trace: Trace, tol: float = DEFAULT_TOL) -> Dict[str, Any]:
    """Baseline replay vs the measurement it was derived from.

    Gates (``ok``): the replayed wall of the *recorded* configuration is
    within ``tol`` of the *warm-corrected* measured wall (the summed step
    spans with each step kind's first, warm-up-dominated occurrence
    replaced by its steady-state mean — the replay models
    steady-state cost, so both sides of the comparison must), and the
    replayed sync schedule equals the measured one exactly. The raw summed
    spans and the loop's own wall are reported alongside.

    On a trace without HLO costs the prediction is exact by construction
    (warm means cancel) and the gate only trips on model drift. On a trace
    WITH ``hlo_cost`` meta the sync overhead is priced from the compiled
    programs' roofline ratio instead of the measured mean, so the gate
    genuinely tests the cost model against measurement — which is what
    licenses running it at a tighter tolerance (``priced_from`` in the
    returned dict says which mode applied).
    """
    records = _step_records(trace)
    local, syncd, warm_local, warm_sync = _warm_anatomy(records)
    measured_span_wall = sum(local) + sum(syncd)
    est_l = _warm_compute_est(local, syncd, warm_local, warm_sync)
    est_s = _mean(warm_sync)
    measured_warm_wall = (
        sum(warm_local) + (len(local) - len(warm_local)) * est_l
        + sum(warm_sync) + (len(syncd) - len(warm_sync)) * est_s)
    res = replay(trace, ReplayKnobs())
    measured = trace.meta.get("measured", {})
    m_count = measured.get("sync_count")
    m_steps = measured.get("sync_steps")
    if m_count is None:       # fall back to the per-span decisions
        m_steps = [r["step"] for r in records if r["synced"]]
        m_count = len(m_steps)
    ratio = (res.wall_s / measured_warm_wall if measured_warm_wall
             else float("nan"))
    sync_ok = (res.sync_count == int(m_count)
               and (m_steps is None or res.sync_steps == list(m_steps)))
    return {
        "predicted_wall_s": res.wall_s,
        "measured_warm_wall_s": measured_warm_wall,
        "measured_span_wall_s": measured_span_wall,
        "measured_loop_wall_s": measured.get("wall_s"),
        "ratio": ratio,
        "tol": tol,
        "wall_ok": bool(abs(ratio - 1.0) <= tol),
        "measured_sync_count": int(m_count),
        "replayed_sync_count": res.sync_count,
        "sync_count_ok": bool(sync_ok),
        "priced_from": res.priced_from,
        "ok": bool(abs(ratio - 1.0) <= tol and sync_ok),
    }


# --------------------------------------------------------------------------- #
# sweeps — the paper's Figure-1/2-style curves from ONE recorded run
# --------------------------------------------------------------------------- #
def sweep_workers(trace: Trace, workers: Sequence[int] = (1, 2, 4, 8, 16, 32),
                  fabric: Optional[comm.FabricModel] = None,
                  base: ReplayKnobs = ReplayKnobs()) -> List[Dict[str, Any]]:
    """Comm fraction vs worker count (Fig. 1's shape) under one fabric."""
    fabric = fabric or comm.FabricModel(**trace.meta.get("fabric", {}))
    rows = []
    for n in workers:
        r = replay(trace, dataclasses.replace(base, fabric=fabric,
                                              n_workers=int(n)))
        rows.append({"workers": int(n), "wall_s": r.wall_s,
                     "comm_s": r.comm_s, "comm_fraction": r.comm_fraction,
                     "sync_count": r.sync_count})
    return rows


def sweep_H(trace: Trace, Hs: Sequence[int] = (1, 2, 4, 8, 16),
            fabric: Optional[comm.FabricModel] = None,
            base: ReplayKnobs = ReplayKnobs()) -> List[Dict[str, Any]]:
    """Wall/speedup vs sync period H (Fig. 2's shape): fixed_h replay of
    the same recorded compute under each period."""
    fabric = fabric or comm.FabricModel(**trace.meta.get("fabric", {}))
    rows = []
    base_wall = None
    for H in Hs:
        r = replay(trace, dataclasses.replace(
            base, fabric=fabric, H=int(H), sync_policy="fixed_h"))
        if base_wall is None:
            base_wall = r.wall_s
        rows.append({"H": int(H), "wall_s": r.wall_s, "comm_s": r.comm_s,
                     "comm_fraction": r.comm_fraction,
                     "sync_count": r.sync_count,
                     "speedup_vs_first": (base_wall / r.wall_s
                                          if r.wall_s else float("nan"))})
    return rows


def sweep_codecs(trace: Trace, codecs: Sequence[str] = REPLAY_CODECS,
                 fabric: Optional[comm.FabricModel] = None,
                 base: ReplayKnobs = ReplayKnobs()) -> List[Dict[str, Any]]:
    """Wire-volume/wall vs sync codec under one fabric."""
    fabric = fabric or comm.FabricModel(**trace.meta.get("fabric", {}))
    rows = []
    for c in codecs:
        r = replay(trace, dataclasses.replace(base, fabric=fabric, codec=c))
        rows.append({"codec": c, "wall_s": r.wall_s, "comm_s": r.comm_s,
                     "comm_fraction": r.comm_fraction,
                     "round_wire_bytes": r.round_wire_bytes,
                     "sync_count": r.sync_count})
    return rows


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="recorded trace JSON (train --trace)")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: baseline replay must match the "
                         "measurement (wall within --tol, sync schedule "
                         "exactly); exit 1 otherwise")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--H", type=int, default=None)
    ap.add_argument("--policy", default=None, choices=["fixed_h", "adaptive"])
    ap.add_argument("--threshold", type=float, default=None)
    ap.add_argument("--codec", default=None, choices=list(REPLAY_CODECS))
    ap.add_argument("--flat", dest="flat", action="store_true", default=None,
                    help="replay the sync round as ONE collective")
    ap.add_argument("--per-leaf", dest="flat", action="store_false",
                    help="replay the sync round as per-leaf collectives")
    ap.add_argument("--shards", type=int, default=None,
                    help="FSDP/TP sub-planes per worker: price each "
                         "device's collective at payload/shards (defaults "
                         "to the trace's recorded n_shards)")
    ap.add_argument("--bw-scale", type=float, default=None,
                    help="scale the recorded fabric bandwidths (implies a "
                         "modeled fabric)")
    ap.add_argument("--fabric-defaults", action="store_true",
                    help="attach the trace's recorded FabricModel to the "
                         "wire term (the baseline replay models none)")
    ap.add_argument("--cross-pod", action="store_true")
    args = ap.parse_args()

    trace = Trace.load(args.trace)
    if args.check:
        v = validate(trace, tol=args.tol)
        print(json.dumps(v, indent=1))
        if not v["ok"]:
            raise SystemExit(1)
        return
    fabric = (comm.FabricModel(**trace.meta.get("fabric", {}))
              if args.fabric_defaults else None)
    knobs = ReplayKnobs(fabric=fabric, bw_scale=args.bw_scale,
                        n_workers=args.workers, H=args.H,
                        sync_policy=args.policy,
                        sync_threshold=args.threshold, codec=args.codec,
                        flat=args.flat, n_shards=args.shards,
                        cross_pod=args.cross_pod)
    print(json.dumps(replay(trace, knobs).to_dict(), indent=1))


if __name__ == "__main__":
    main()

"""Dry-run: one rank of the production grids, for every (arch x shape).

The JAX package's ``launch/dryrun.py`` lowers and compiles each pair for
256 or 512 placeholder devices and reads the compiled program's cost and
memory. The port has no compiler: it runs one rank's real program on the
``meta`` device (nothing computed, nothing allocated) under a
``core.comm.DryGroup`` that plays rank 0 of the grid and records what each
collective would move, and walks its aten ops (``roofline/cost.py``):
FLOPs, bytes, collectives and the peak of live bytes, priced on the H100
(``roofline/analysis.py``).

  train_4k    the run's ``local_step`` and, for a local optimizer with
              workers, its ``sync_step`` (``build_train_programs``, each
              walked once with ``do_sync`` set: the ``SyncEngine``'s
              decision reads tensors on the host);
  prefill_32k the serving prefill;
  decode_32k / long_500k one ``decode_step``: ONE token against the cache.

Grids: ``{"data": 16, "model": 16}`` (single) and ``{"pod": 2, "data": 16,
"model": 16}`` (multi), the reference's ``make_production_mesh``; the
multi-pod grid folds ``pod`` x ``data`` into one ``data`` axis of 32
ranks, pod-major (``DryGroup``). One plan is not run as a program there:
phi3.5-moe's Local AdaAlter plan makes each pod a worker
(``local_axes=("pod",)``, ROADMAP 9b-2); its ``local_step`` is one pod's
one-model FSDP + TP program on the (16, 16) grid, and its ``sync_step``
is modeled (the accounting's bytes of the rank's tiles over the pod pair,
priced on the inter-node link), and the record says so.

In place of ``memory_analysis()`` each record carries ``memory``: the
rank's resident bytes by kind (params, optimizer state, EF residuals,
caches), the walk's peak of live bytes, the largest resident bytes of any
rank (from the specs) and whether that rank's peak fits the card's HBM.
The numbers are modeled: an NVIDIA H100 80GB's data sheet, not a
measurement.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --out experiments_torch/dryrun
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import (ARCHS, SHAPES, OptimizerConfig, get_arch,
                                 get_shape)
from repro_torch.core import comm
from repro_torch.core.comm import DryGroup
from repro_torch.hardware import H100
from repro_torch.launch.mesh import resolve_plan
from repro_torch.launch.serving import (build_serve_programs,
                                        decode_cache_specs,
                                        serve_batch_specs, serve_plan)
from repro_torch.launch.steps import build_train_programs, train_batch_specs
from repro_torch.models import build_model
from repro_torch.roofline import analyze, model_flops, region_table
from repro_torch.roofline.cost import step_cost
from repro_torch.sharding import (GridLayout, ShardingRules, leaf_split,
                                  param_shardings)
from repro_torch.sharding.partition import rule_overrides
from repro_torch.tree import leaves, tree_map

#: the reference's production meshes (``make_production_mesh``)
SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}

#: the reference's ``--optimized`` flags
OPT_FLAGS = dict(attn_tp_pad=True, attn_remat=True, fused_xent=True,
                 moe_group_tokens=True, seq_parallel=True)

#: the counters a record reports (``core.comm``)
COUNTERS = ("wire", "tp", "side", "shard_gather")

#: what a modeled record says of itself
POD_ROUND_NOTE = (
    "modeled, not run: the workers are the two pods (local_axes=('pod',), "
    "ROADMAP 9b-2); a round moves this rank's tiles' accounting bytes to "
    "its peer rank in the other pod over the inter-node link (dcn_bw)")


def mesh_name(grid: Dict[str, int]) -> str:
    return "x".join(str(n) for n in grid.values())


def fold(grid: Dict[str, int]) -> Dict[str, int]:
    """The two-axis grid a ``DryGroup`` lays out: ``pod`` x ``data``
    folded into ``data``."""
    return {"data": grid.get("pod", 1) * grid["data"], "model": grid["model"]}


def fold_plan(plan):
    """``plan`` on the folded grid: ``("pod", "data")`` becomes ``data``."""
    def f(axes):
        axes = tuple(axes)
        return ("data",) if "pod" in axes and "data" in axes else axes
    return dataclasses.replace(plan, local_axes=f(plan.local_axes),
                               grad_axes=f(plan.grad_axes),
                               fsdp_axes=f(plan.fsdp_axes))


def dry_group(grid: Dict[str, int], plan, rank: int = 0) -> DryGroup:
    """Rank ``rank`` of ``grid`` (``pod`` folded), split as ``init_ranks``
    splits a real launch: the grid's sub-groups and the FSDP ones."""
    group = DryGroup(grid, rank)
    f = fold(grid)
    group.split(GridLayout(f["data"], f["model"]), plan.fsdp_axes)
    return group


def _empty(spec, lead=None):
    shape = tuple(spec.shape) if lead is None else tuple(lead) + tuple(
        spec.shape[len(lead):])
    return torch.empty(shape, dtype=spec.dtype, device="meta")


def _bytes(tree) -> int:
    seen, n = set(), 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                n += st.nbytes()
    return n


def _reset_counters() -> None:
    for name in COUNTERS:
        getattr(comm, name).reset()


def _counters() -> Dict[str, Dict[str, int]]:
    return {name: {"n": getattr(comm, name).n,
                   "bytes": getattr(comm, name).bytes} for name in COUNTERS}


def rank_param_bytes(cfg, plan, grid: Dict[str, int], *, workers: bool,
                     extra_per_value: int = 0) -> List[int]:
    """Every rank's bytes of its parameter parts under ``plan`` on
    ``grid`` (folded), in rank order, each value also charged
    ``extra_per_value`` bytes (its optimizer state), from the specs:
    ``sharding.specs.param_shardings`` and ``leaf_split``. ``workers``:
    the paper-style plan, whose ``data`` ranks each hold a worker's
    parts over ``model``."""
    f = fold(grid)
    tree = build_model(cfg).init(None, "meta")
    specs = param_shardings(ShardingRules(f, plan, rule_overrides(cfg)),
                            tree)
    sizes = [(t.shape, t.element_size() + extra_per_value)
             for t in leaves(tree)]
    per_rank = []
    for r in range(f["data"] * f["model"]):
        coords = {"data": 0 if workers else r // f["model"],
                  "model": r % f["model"]}
        per_rank.append(sum(leaf_split(s, sp, f, coords).part_numel * b
                            for (s, b), sp in zip(sizes, specs)))
    return per_rank


def _state_per_value(opt_state, params) -> int:
    """Bytes of optimizer state a parameter value carries (the state's
    params-shaped entries)."""
    n = sum(t.numel() for t in leaves(params))
    return round(_bytes({k: v for k, v in opt_state.items()
                         if isinstance(v, dict)}) / max(n, 1))


def _memory(resident: Dict[str, int], cost, largest: int) -> Dict[str, Any]:
    mine = sum(resident.values())
    peak_any = cost.peak_bytes + max(0, largest - mine)
    return {"resident_bytes": resident, "resident_total": mine,
            "walk_peak_bytes": cost.peak_bytes,
            "largest_rank_resident_bytes": largest,
            "largest_rank_peak_bytes": peak_any,
            "hbm_bytes": H100.hbm_bytes,
            "fits": peak_any <= H100.hbm_bytes}


def train_walks(cfg, shape, opt_cfg, grid: Dict[str, int], plan, *,
                variants=("local_step", "sync_step")):
    """Rank 0's train programs on ``grid`` (``plan``: its folded plan)
    walked on ``meta``: ``{variant: (StepCost, counters, dry log)}``, the
    programs, the rank's resident bytes by kind and its parameter and
    state bytes from the specs (rank 0's, the largest rank's)."""
    group = dry_group(grid, plan)
    f = fold(grid)
    local = bool(plan.local_axes)
    n_workers = f["data"] if local else 1
    programs = build_train_programs(cfg, opt_cfg, n_workers=n_workers,
                                    device="meta", group=group, plan=plan)
    params, state = programs.init_fn(0, base=build_model(cfg).init(
        None, "meta"))
    specs = train_batch_specs(cfg, shape, n_workers if programs.is_local
                              else 0)
    if programs.is_local:              # this rank's worker's rows
        batch = {k: _empty(v, (1, v.shape[1])) for k, v in specs.items()}
    else:                              # this rank's rows of the batch
        rows = shape.global_batch // (
            group.along(plan.grad_axes).world
            if group.along(plan.grad_axes) is not None else 1)
        batch = {k: _empty(v, (rows,)) for k, v in specs.items()}
    res = {k: v for k, v in state.items() if k.startswith("res_")}
    resident = {"params": _bytes(params),
                "optimizer_state": _bytes({k: v for k, v in state.items()
                                           if not k.startswith("res_")}),
                "ef_residuals": _bytes(res)}
    per_value = _state_per_value(state, params)
    spec_bytes = rank_param_bytes(
        cfg, plan, grid, workers=local, extra_per_value=per_value)
    spec_bytes = spec_bytes[0], max(spec_bytes)
    walks = {}
    for name in variants:
        if name == "sync_step" and not programs.is_local:
            continue
        _reset_counters()
        group.log.clear()
        fn = programs.sync_step if name == "sync_step" else programs.local_step
        cost = step_cost(fn, params, state, batch)
        cost.result = None
        walks[name] = (cost, _counters(), list(group.log))
    return walks, programs, resident, spec_bytes


def serve_setup(cfg, shape, grid: Dict[str, int], plan):
    """Rank 0's serving programs for ``shape`` on ``grid`` (``plan``:
    its folded plan) and its weights on ``meta``: (group, programs,
    params, resident bytes by kind)."""
    group = dry_group(grid, plan)
    programs = build_serve_programs(cfg, shape, group=group, plan=plan)
    params = programs.param_parts(build_model(cfg).init(None, "meta"))
    return group, programs, params, {"params": _bytes(params)}


def serve_walk(cfg, shape, grid: Dict[str, int], plan):
    """Rank 0's serving program for ``shape`` (prefill, or one decode
    step) on ``grid`` walked on ``meta``: (variant, StepCost, counters,
    dry log, programs, resident bytes by kind, (rank 0's, the largest
    rank's) weight bytes)."""
    group, programs, params, resident = serve_setup(cfg, shape, grid, plan)
    specs = serve_batch_specs(cfg, shape)
    rows = programs.rows.stop - programs.rows.start
    _reset_counters()
    group.log.clear()
    if shape.kind == "prefill":
        batch = {k: _empty(v, (rows,)) for k, v in specs["prefill"].items()}
        cost = step_cost(programs.prefill, params, batch)
        vname = "prefill"
    else:
        whole = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                               device="meta"),
                         decode_cache_specs(cfg, shape))
        caches = tree_map(lambda t: t.clone(), programs.cache_parts(whole))
        resident["caches"] = _bytes(caches)
        token = _empty(specs["token"], (rows,))
        pos = _empty(specs["pos"], (rows,))
        cost = step_cost(programs.decode_step, params, caches, token, pos)
        vname = "decode_step"
    cost.result = None
    spec_bytes = rank_param_bytes(cfg, plan, grid, workers=False)
    spec_bytes = spec_bytes[0], max(spec_bytes)
    return (vname, cost, _counters(), list(group.log), programs, resident,
            spec_bytes)


def _modeled_pod_round(opt_cfg, n_values: int) -> Dict[str, Any]:
    """phi3.5-moe's pod round on (2, 16, 16): what a rank sends its peer
    in the other pod, by the accounting (``SyncEngine.round_bytes`` of the
    ``n_values`` parameter values of its tiles), over ``dcn_bw``."""
    from repro_torch.core.sync_engine import make_sync_engine
    engine = make_sync_engine(opt_cfg, is_local=True, H=opt_cfg.H)
    wire = engine.round_bytes(n_values)
    return {"variant": "sync_step", "modeled": True, "note": POD_ROUND_NOTE,
            "n_values": n_values, "collective_bytes_per_chip": 0.0,
            "cross_pod_bytes": wire,
            "t_collective_s": comm.FabricModel().allreduce_time(
                wire, 2, cross_pod=True)}


def dryrun_pair(arch: str, shape_name: str, *, multi_pod: bool,
                opt_name: str = "local_adaalter", H: int = 4,
                compression: str = "", verbose: bool = True,
                optimized: bool = False, flat: bool = False,
                recorder=None, registry=None) -> Dict[str, Any]:
    """Walk one (arch, shape, grid) on the ``meta`` device; return the
    roofline record(s), with the reference's keys (``compile_s`` is the
    walk's seconds) and ``memory`` in place of ``memory_analysis``."""
    cfg = get_arch(arch)
    if optimized:
        cfg = dataclasses.replace(cfg, **OPT_FLAGS)
    shape = get_shape(shape_name)
    grid = MULTI if multi_pod else SINGLE
    name = mesh_name(grid)
    n_chips = math.prod(grid.values())
    t0 = time.time()
    records = []

    def emit(rec, vname, cost, tag_extra=None):
        records.append(rec)
        table = (region_table(cost, peak_flops=H100.peak_flops,
                              hbm_bw=H100.hbm_bw)
                 if (recorder is not None or registry) and cost is not None
                 else None)
        if registry:
            registry.set_many(
                {"compile_s": rec["compile_s"],
                 "t_compute_s": rec["t_compute_s"],
                 "t_memory_s": rec["t_memory_s"],
                 "t_collective_s": rec["t_collective_s"]},
                arch=arch, shape=shape_name, mesh=name, variant=vname)
        if recorder is not None:
            t_now = recorder.now()
            tag = f"{arch}/{shape_name}/{name}"
            walk_s = cost.seconds if cost is not None else 0.0
            recorder.add("eval", step=len(records) - 1, t0=t_now - walk_s,
                         dur=walk_s, pair=tag, variant=vname, phase="compile")
            modeled = (max(rec["t_compute_s"], rec["t_memory_s"])
                       + rec["t_collective_s"])
            args = ({"hlo_optimal_s": table["optimal_s"],
                     "hlo_regions": table["regions"]} if table else {})
            recorder.add("local_step", step=len(records) - 1, t0=t_now,
                         dur=modeled, modeled=True, pair=tag, variant=vname,
                         t_compute_s=rec["t_compute_s"],
                         t_memory_s=rec["t_memory_s"],
                         t_collective_s=rec["t_collective_s"],
                         dominant=rec["dominant"], **args)
            if tag_extra is not None:
                layout = "flat" if flat else "per_leaf"
                m = tag_extra[layout]
                recorder.add("collective", step=len(records) - 1,
                             t0=t_now + modeled, dur=m["time_s"],
                             modeled=True, pair=tag, variant=vname,
                             layout=layout,
                             wire_bytes=rec["modeled_sync_payload_bytes"],
                             n_collectives=m["n_collectives"])

    if shape.kind == "train":
        from repro_torch.core.sync_engine import make_sync_engine
        opt_cfg = OptimizerConfig(name=opt_name, H=H, compression=compression,
                                  flat=flat)
        plan = resolve_plan(cfg, grid, optimizer=opt_name)
        if optimized and plan.remat == "none":
            plan = dataclasses.replace(plan, remat="full")
        pod_workers = plan.local_axes == ("pod",)
        if pod_workers:               # one pod's program; the round modeled
            run_grid, run_plan = SINGLE, dataclasses.replace(
                plan, local_axes=())
        else:
            run_grid, run_plan = grid, fold_plan(plan)
        walks, programs, resident, (_, largest) = train_walks(
            cfg, shape, opt_cfg, run_grid, run_plan)
        is_local = programs.is_local or pod_workers
        n_workers = 2 if pod_workers else programs.n_workers
        H_ = opt_cfg.H if is_local else 1
        n_params = cfg.param_count()
        engine = make_sync_engine(opt_cfg, is_local=is_local,
                                  H=H_ if is_local else 1)
        n_leaves = programs.n_payload_leaves
        per_leaf_colls = comm.round_collectives(opt_name, n_leaves)
        variants = list(walks)
        if pod_workers:
            variants.append("sync_step")
        for vname in variants:
            modeled = engine.round_bytes(n_params) if vname == "sync_step" \
                else 0.0
            coll_model = None
            if vname == "sync_step":
                coll_model = {
                    "n_payload_leaves": n_leaves,
                    "per_leaf": {"n_collectives": per_leaf_colls,
                                 "time_s": comm.collective_time(
                                     modeled, per_leaf_colls, n_workers,
                                     cross_pod=multi_pod)},
                    "flat": {"n_collectives": 1,
                             "time_s": comm.collective_time(
                                 modeled, 1, n_workers,
                                 cross_pod=multi_pod)}}
            cost = None
            if vname in walks:
                cost, counters, log = walks[vname]
                rep = analyze(cost, arch=arch, shape_name=shape_name,
                              mesh_name=name, n_chips=n_chips,
                              model_flops_total=model_flops(cfg, shape))
                rec = rep.to_dict()
                rec.update(counters=counters,
                           memory=_memory(resident, cost, largest),
                           kernels=dict(cost.kernels),
                           walk_s=cost.seconds)
            else:                     # phi3.5-moe's pod round, modeled
                pod = _modeled_pod_round(opt_cfg, sum(
                    t.part_numel for t in programs.leaf_layout.tiles))
                local = records[0]
                rec = {k: local[k] for k in ("arch", "shape", "mesh",
                                             "n_chips", "model_flops_total")}
                rec.update({
                    "hlo_flops_per_chip": 0.0, "hlo_bytes_per_chip": 0.0,
                    "collective_bytes_per_chip": 0.0,
                    "cross_pod_bytes": pod["cross_pod_bytes"],
                    "collectives": {}, "collective_counts": {},
                    "bytes_per_device": local["bytes_per_device"],
                    "xla_flops": None, "xla_bytes": None,
                    "t_compute_s": 0.0, "t_memory_s": 0.0,
                    "t_collective_s": pod["t_collective_s"],
                    "dominant": "collective", "useful_flop_ratio": 0.0,
                    "mfu_at_roofline": 0.0, "memory": local["memory"],
                    "modeled": True, "note": POD_ROUND_NOTE,
                    "modeled_round": pod})
            rec.update(variant=vname, plan=dataclasses.asdict(plan),
                       n_workers=n_workers, H=H_, optimizer=opt_name,
                       compression=opt_cfg.compression, flat=flat,
                       modeled_sync_payload_bytes=modeled,
                       sync_collective_model=coll_model,
                       compile_s=round(time.time() - t0, 1))
            emit(rec, vname, cost, coll_model)
            if verbose:
                print(f"  [{vname}] " + _summary(rec))
    else:
        plan = serve_plan(cfg, grid)
        (vname, cost, counters, log, programs, resident,
         (_, largest)) = serve_walk(cfg, shape, grid, fold_plan(plan))
        largest += resident.get("caches", 0)
        rep = analyze(cost, arch=arch, shape_name=shape_name, mesh_name=name,
                      n_chips=n_chips,
                      model_flops_total=model_flops(cfg, shape))
        rec = rep.to_dict()
        rec.update(variant=vname, plan=dataclasses.asdict(plan),
                   cache_len=programs.cache_len, window=programs.window,
                   counters=counters, memory=_memory(resident, cost, largest),
                   kernels=dict(cost.kernels), walk_s=cost.seconds,
                   compile_s=round(time.time() - t0, 1))
        emit(rec, vname, cost)
        if verbose:
            print(f"  [{vname}] " + _summary(rec))
    return {"arch": arch, "shape": shape_name, "mesh": name,
            "records": records, "elapsed_s": round(time.time() - t0, 1)}


def _summary(rec) -> str:
    mem = rec["memory"]
    return (f"flops={rec['hlo_flops_per_chip']:.4g} "
            f"bytes={rec['hlo_bytes_per_chip']:.4g} "
            f"comp={rec['t_compute_s'] * 1e3:.3f}ms "
            f"mem={rec['t_memory_s'] * 1e3:.3f}ms "
            f"coll={rec['t_collective_s'] * 1e3:.3f}ms "
            f"dom={rec['dominant']} peak={mem['walk_peak_bytes'] / 1e9:.2f}GB "
            f"fits={mem['fits']}" + (" (modeled round)"
                                     if rec.get("modeled") else ""))


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="all",
                    help=f"architecture id, 'all', or 'assigned' "
                         f"({sorted(ARCHS)})")
    ap.add_argument("--shape", default="all",
                    help=f"one of {sorted(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--optimizer", default="local_adaalter")
    ap.add_argument("--H", type=int, default=4)
    from repro_torch.core.codecs import CODEC_NAMES
    ap.add_argument("--compress", nargs="?", const="int8", default="",
                    choices=["", *CODEC_NAMES], metavar="SCHEME",
                    help="sync wire codec: its encode is walked in the "
                         "sync_step, and the record carries its modeled "
                         "payload beside the walk's collective bytes")
    ap.add_argument("--out", default="",
                    help="directory for per-pair JSON records")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="record the walks' walls and the roofline-modeled "
                         "step and wire spans as a repro_torch.trace "
                         "timeline")
    ap.add_argument("--metrics", default="", metavar="OUT.jsonl",
                    help="per-pair metrics (walk wall, roofline terms) as "
                         "JSONL rows + a Prometheus textfile (OUT.prom)")
    ap.add_argument("--optimized", action="store_true",
                    help="the beyond-paper flags (OPT_FLAGS)")
    ap.add_argument("--flat", action="store_true",
                    help="the flat-parameter-plane steps")
    args = ap.parse_args(argv)

    archs = ([n for n in ARCHS if n != "biglstm"] if args.arch == "assigned"
             else sorted(ARCHS) if args.arch == "all" else [args.arch])
    shapes = sorted(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    recorder = None
    if args.trace:
        from repro_torch.trace import TraceRecorder
        recorder = TraceRecorder(meta={
            "kind": "dryrun", "optimizer": args.optimizer, "H": args.H,
            "compression": args.compress, "flat": args.flat,
            "clock": "perf_counter", "hardware": H100.name})
    from repro_torch.obs import NULL_REGISTRY
    registry = NULL_REGISTRY
    if args.metrics:
        from repro_torch.obs import MetricsRegistry
        registry = MetricsRegistry(labels={
            "kind": "dryrun", "optimizer": args.optimizer,
            "codec": args.compress or "fp32"})
        registry.open_jsonl(args.metrics)

    n_ok = n_fail = n_pair = 0
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                tag = (f"{arch} x {shape_name} x "
                       f"{'2x16x16' if multi_pod else '16x16'}")
                print(f"== {tag}", flush=True)
                try:
                    result = dryrun_pair(
                        arch, shape_name, multi_pod=multi_pod,
                        opt_name=args.optimizer, H=args.H,
                        compression=args.compress, optimized=args.optimized,
                        flat=args.flat, recorder=recorder, registry=registry)
                    n_ok += 1
                    if registry:
                        registry.counter("pairs_ok_total").inc()
                    if args.out:
                        os.makedirs(args.out, exist_ok=True)
                        fn = (f"{arch}_{shape_name}_"
                              f"{'multi' if multi_pod else 'single'}"
                              f"{'_opt' if args.optimized else ''}.json")
                        with open(os.path.join(args.out, fn), "w") as f:
                            json.dump(result, f, indent=1)
                    print(f"   OK in {result['elapsed_s']}s", flush=True)
                except Exception:
                    n_fail += 1
                    if registry:
                        registry.counter("pairs_failed_total").inc()
                    print(f"   FAIL: {tag}\n{traceback.format_exc()}",
                          flush=True)
                if registry:
                    registry.collect(n_pair)
                n_pair += 1
    if recorder is not None:
        recorder.save(args.trace)
        print(f"wrote trace {args.trace} ({len(recorder.spans)} spans)")
    if registry:
        base = (args.metrics[:-len(".jsonl")]
                if args.metrics.endswith(".jsonl") else args.metrics)
        registry.write_prom(base + ".prom")
        registry.close()
        print(f"wrote metrics {args.metrics} "
              f"(+ Prometheus textfile {base + '.prom'})")
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

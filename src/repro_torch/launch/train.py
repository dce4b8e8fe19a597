"""Training driver of the port: the paper's optimizers on the synthetic
non-IID stream.

The counterpart of the JAX package's ``launch/train.py`` for every
architecture the port builds (``--arch``; the Big LSTM by default, the
transformer families through their ``loss_fn``, full width or
``--reduced``):

* the local optimizers (``local_sgd``, ``local_adaalter``) with R workers
  stacked on one device, per-leaf or over the flat parameter plane
  (``--flat``), the sync round owned by a ``SyncEngine`` (fixed-H or
  adaptive schedule, fp32/bf16/int8 wire, one-pass or three-pass encode);
* the synchronous baselines (``sgd``, ``adagrad``, ``adaalter``), and a
  local optimizer under a plan without worker axes (``plan=``; the plans
  above 20 B parameters): one model over the global batch, R = 1, the
  bytes of a gradient all-reduce charged every step;
* checkpoints (``--checkpoint-dir``, ``--checkpoint-every``) in the JAX
  package's format, restored across layouts and, for flat planes, across
  worker counts, with the sync engine's ``SyncState``;
* ``--trace`` (a span timeline, ``repro_torch.trace``) and ``--metrics``
  (a JSONL health stream and a Prometheus textfile, ``repro_torch.obs``).

Under ``torchrun`` (``WORLD_SIZE`` > 1) the ranks form a grid of
``--workers`` R × S = world / R (``launch/mesh.py``): rank r is worker
r // S; with S > 1 (``--flat`` only) it holds shard r % S of its worker's
flat planes, gathers the params over its worker's ranks before each
forward, and syncs its sub-planes with the ranks of its shard index; per
leaf (tensor parallelism) it holds its parts of its worker's leaves, as
their specs split them over the worker's ranks, and computes with them
(``loss_fn(..., tp=)``). The sync round is a collective
(``core/comm.py``). A one-model run spreads
its batch over the ranks and, under the synchronous plan
(``fsdp_axes=("data",)``), splits each leaf and its state over them
(FSDP, ``launch/steps.py::_leaf_programs``). Rank 0 alone writes
``--out``, ``--trace``, ``--metrics`` and checkpoints (an FSDP run's from
the gathered parts: the replicated run's files), and every rank returns
the same ``TrainResult``, equal to the stacked (or replicated) run's.

``TrainResult`` carries the measured sync schedule and the bytes it moved.
Runs on the CUDA device unless ``device='cpu'`` / ``--device cpu``.

  python -m repro_torch.launch.train --arch biglstm --optimizer \\
      local_adaalter --flat --compress int8 --use-kernels --workers 2 \\
      --batch 64 --seq 20 --steps 8
  python -m repro_torch.launch.train --device cpu --arch biglstm --reduced \\
      --optimizer adaalter --steps 8 --checkpoint-dir ck --checkpoint-every 4 \\
      --trace t.json --metrics m.jsonl
  python -m repro_torch.launch.train --device cpu --arch hymba-1.5b \\
      --reduced --use-kernels --compress int8 --workers 2 --batch 8 \\
      --seq 16 --steps 8
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --device cpu --dist-backend gloo --workers 2 --arch biglstm \\
      --reduced --use-kernels --compress int8 --batch 8 --seq 16 --steps 8
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --dist-backend gloo --workers 2 --flat --arch biglstm \\
      --reduced --use-kernels --compress int8 --batch 8 --seq 16 --steps 8
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --dist-backend gloo --workers 2 --arch qwen2-7b \\
      --reduced --use-kernels --compress int8 --batch 8 --seq 16 --steps 4
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import (ARCHS, OptimizerConfig, ShapeConfig,
                                 SyncConfig, get_arch, reduced)
from repro_torch.core.codecs import CODEC_NAMES
from repro_torch.core.optimizers import SYNC_OPTIMIZERS
from repro_torch.core.sync_engine import DRIFT_METRICS, make_sync_engine
from repro_torch.core.sync_policy import POLICY_NAMES
from repro_torch.data import SyntheticLM, make_train_batch
from repro_torch.launch.steps import build_train_programs, shard_state
from repro_torch.models.counting import count_params
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TrainResult:
    losses: List[float]                    # this run only (after a restore)
    ppl: List[float]
    steps: int                             # steps executed by this run
    n_workers: int
    comm_bytes_per_step: float             # MEASURED: moved bytes / steps run
    wall_s: float
    final_loss: float
    start_step: int = 0                    # the restored step (0: fresh)
    sync_count: int = 0                    # sync rounds the policy triggered
    sync_steps: List[int] = dataclasses.field(default_factory=list)
    comm_bytes_total: float = 0.0          # measured wire bytes, whole run
    comm_bytes_modeled: float = 0.0        # static fixed-H formula, per step
    sync_policy: str = "fixed_h"
    step_s: List[float] = dataclasses.field(default_factory=list)
                                           # host seconds of each step, the
                                           # device's work included
    probe_s: List[float] = dataclasses.field(default_factory=list)
                                           # host seconds of each step's
                                           # health probe (instrumented runs)
    state_digest: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)              # digest=True: state_digest()
    ranks: List[dict] = dataclasses.field(default_factory=list)
                                           # a run with ranks: each rank's
                                           # device, step walls, collectives,
                                           # wire bytes, round parts' seconds,
                                           # kernel launches and peak memory;
                                           # the walls above are rank 0's


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The CUDA device unless the caller names another; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port trains on the card; pass "
                "device='cpu' (--device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _place(tree, dev):
    """Float tensors on ``dev``, contiguous; the integer step counters on
    the host, where the steps keep them."""
    return tree_map(lambda t: t.to(dev).contiguous() if t.is_floating_point()
                    else t.cpu(), tree)


def _stacked_like(tree, workers: int):
    """``tree``'s tensors, one worker a rank, as ``meta`` templates of the
    stacked state of ``workers`` workers."""
    return tree_map(lambda t: torch.empty(
        (workers,) + tuple(t.shape[1:]), dtype=t.dtype, device="meta"), tree)


def gather_workers(programs, tree, *, to_device: bool):
    """Every worker's rows of ``tree`` (this rank's rows of the train state:
    planes, sub-planes, per-leaf tensors and counters) stacked in worker
    order, as the stacked run holds them: one gather over all ranks, in
    rank order, i.e. workers then shards, the sub-planes of a worker laid
    end to end."""
    got = programs.group.gather_stacked(tree, to_device=to_device)
    S, R = programs.n_shards, programs.n_workers
    if S == 1:
        return got
    return tree_map(lambda t: t[::S] if t.ndim == 1 else t.reshape(R, -1),
                    got)


def _restore(checkpoint_dir, programs, engine, params, opt_state, dev,
             verbose):
    """(params, opt_state, SyncState or None, step) from the latest
    checkpoint, written in either layout (per-leaf or flat plane), a flat
    plane under any worker count, with or without the SyncState. A rank of
    a run with one worker a rank restores the stacked state of all the
    run's workers and keeps its own row."""
    from repro_torch.checkpoint import (checkpoint_keys, disk_like,
                                        restore_checkpoint)
    from repro_torch.core.flatspace import (adapt_flat_state,
                                            is_flat_checkpoint)
    keys = checkpoint_keys(checkpoint_dir)
    # states written before the SyncState are (params, opt_state) pairs
    no_ss = not any(k.startswith("#2/") for k in keys)
    disk_flat = is_flat_checkpoint(keys)
    layout = programs.leaf_layout
    sharded = layout is not None and layout.sharded
    if disk_flat == programs.is_flat:
        like = (params, opt_state)
        if sharded:                  # the whole leaves, on the host
            like = (layout.whole_like(params),
                    layout.state(layout.whole_like, opt_state))
    elif disk_flat:
        if programs.flat_abstract is None:
            raise ValueError(
                "checkpoint holds a flat parameter plane but this run has "
                "no FlatSpace (flat layout is local Local AdaAlter only)")
        like = programs.flat_abstract
    else:
        like = programs.legacy_abstract
    ranked = programs.group is not None and programs.is_local
    if ranked:
        like = _stacked_like(like, programs.n_workers)
    if not no_ss:
        like = (*like, engine.export_state())
    if disk_flat:       # the plane may come from another worker count
        like = disk_like(checkpoint_dir, like)
    state, step = restore_checkpoint(checkpoint_dir, like)
    del like, params, opt_state
    params, opt_state = state[:2]
    sync_state = None if no_ss else state[2]
    notes = ""
    if disk_flat:
        want = (programs.n_workers, programs.flatspace.plane_size)
        if tuple(params.shape) != want:
            notes = f" (plane {tuple(params.shape)} -> {want})"
            plane, fstate = adapt_flat_state(
                params.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in opt_state.items()},
                workers=want[0], plane_size=want[1])
            params = torch.from_numpy(plane)
            opt_state = {k: torch.from_numpy(v) for k, v in fstate.items()}
    if ranked:                       # this rank's worker
        w = programs.group.worker
        params, opt_state = tree_map(lambda t: t[w:w + 1],
                                     (params, opt_state))
    if disk_flat and not programs.is_flat:      # whole leaves, on the host
        params, opt_state = programs.to_legacy(params, opt_state)
        notes += " (flat -> per-leaf)"
    if sharded:                      # this rank's parts of the leaves
        params = layout.take(params)
        opt_state = layout.state(layout.take, opt_state)
    shard = partial(shard_state, programs.flatspace, programs.shard)
    if disk_flat and programs.is_flat and programs.n_shards > 1:
        params, opt_state = shard(params, opt_state)   # its sub-planes
    params, opt_state = _place((params, opt_state), dev)
    if programs.is_flat and not disk_flat:
        params, opt_state = programs.to_flat(params, opt_state)
        if programs.n_shards > 1:
            params, opt_state = shard(params, opt_state)
        notes += " (per-leaf -> flat)"
    if verbose:
        print(f"restored checkpoint at step {step}"
              f"{' (no SyncState)' if no_ss else ''}{notes}")
    return params, opt_state, sync_state, step


def state_digest(params, opt_state, *, worker_axis: bool,
                 layout=None) -> Dict[str, List[int]]:
    """A digest of a train state: for the params and each float entry of
    the optimizer state, one integer per worker (with ``worker_axis``; else
    one), the sum of its elements' bit patterns read as integers. Equal
    states give equal digests; any one changed element changes it. The
    sums add over the parts of a leaf, so the digests of a one-model run's
    ranks, each over the leaves it owns (``layout``, a
    ``steps.LeafLayout``: ``owned_leaves``), add up to the whole
    state's."""
    from repro_torch.core.flatspace import SCALAR_STATE_KEYS
    out = {}
    entries = [("params", params)] + sorted(
        (k, v) for k, v in opt_state.items() if k not in SCALAR_STATE_KEYS)
    for key, tree in entries:
        total = None
        picked = (tree_leaves(tree) if layout is None
                  else [x for _, x in layout.owned_leaves(tree)])
        for t in picked:
            if not t.is_floating_point():
                continue
            bits = t.view(torch.int16 if t.element_size() == 2
                          else torch.int32)
            rows = bits if worker_axis else bits[None]
            s = torch.stack([torch.sum(r, dtype=torch.int64) for r in rows])
            total = s if total is None else total + s
        if total is not None:
            out[key] = [int(v) for v in total.tolist()]
        elif layout is not None:          # a rank that owns none of them
            out[key] = [0]
    return out


def step_cost_tables(cfg, opt_cfg, programs, batch, *, seed: int = 0,
                     group=None) -> dict:
    """The reference's ``meta["hlo_cost"]``: the region table
    (``roofline.region_table``, priced on ``hardware.H100``) of the run's
    local step and of its sync step, each walked once by
    ``roofline/cost.py::step_cost`` on the ``meta`` device (nothing
    computed or allocated), rebuilt there from ``programs``' plan, with
    ``batch`` (its shapes and dtypes; any device) and, for a run with
    ranks, a ``core.comm.DryGroup`` playing this rank of ``group``'s grid.
    ``{"local_step": table, "sync_step": table, "hw": {"peak_flops",
    "hbm_bw"}}``; a synchronous run's sync step is its local step."""
    from repro_torch.core import comm
    from repro_torch.core.comm import DryGroup
    from repro_torch.hardware import H100
    from repro_torch.models import build_model
    from repro_torch.roofline import region_table
    from repro_torch.roofline.cost import step_cost
    from repro_torch.sharding.specs import GridLayout
    dry = None
    if group is not None:
        dry = DryGroup(group.grid, group.rank)
        dry.split(GridLayout.of(group.grid), programs.plan.fsdp_axes)
    meta = build_train_programs(cfg, opt_cfg, n_workers=programs.n_workers,
                                device="meta", group=dry, plan=programs.plan)
    params, state = meta.init_fn(seed, build_model(cfg).init(None, "meta"))
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in batch.items()}
    # the dry group's collectives count as a real rank's: the run's
    # counters are put back after the walks
    counters = [getattr(comm, k) for k in ("wire", "side", "tp",
                                           "shard_gather")]
    kept = [copy.deepcopy(vars(c)) for c in counters]
    out = {}
    try:
        for key, fn in (("local_step", meta.local_step),
                        ("sync_step", meta.sync_step)):
            out[key] = region_table(step_cost(fn, params, state, batch),
                                    peak_flops=H100.peak_flops,
                                    hbm_bw=H100.hbm_bw)
    finally:
        for c, v in zip(counters, kept):
            vars(c).update(v)
    out["hw"] = {"peak_flops": H100.peak_flops, "hbm_bw": H100.hbm_bw}
    return out


def _launch_counts() -> dict:
    """Each kernel wrapper's launch count so far, by kernel."""
    from repro_torch.kernels import adaalter_update, quantize, ssd_scan
    from repro_torch.kernels import sync_fused
    return {"adaalter_update": adaalter_update.launches.n,
            "flat_fused_update": adaalter_update.flat_launches.n,
            "fused_ef": sync_fused.launches.n,
            "flat_ef": sync_fused.flat_launches.n,
            "quantize_blocks": quantize.quantize_launches.n,
            "dequantize_blocks": quantize.dequantize_launches.n,
            "ssd_scan": ssd_scan.launches.n}


def _rank_report(group, dev, since: dict, step_s, probe_s, wall: float,
                 digest: dict, state_bytes: int) -> dict:
    """This rank's share of a run with ranks: its device and place in the
    grid, walls, the collectives it issued and the bytes it contributed
    (the sync rounds' or an FSDP step's, the params gathers of a sharded
    flat run, and the rest), the round parts' and the gathers' seconds,
    its kernel launches, peak device memory and the bytes of the train
    state it holds, all counted from ``since``."""
    from repro_torch.core import comm
    wire, side = comm.wire.snapshot(), comm.side.snapshot()
    gather, tp = comm.shard_gather.snapshot(), comm.tp.snapshot()
    launches = _launch_counts()
    return {
        "rank": group.rank, "device": str(dev), "route": group.route,
        "step_s": list(step_s), "probe_s": list(probe_s), "wall_s": wall,
        "collectives": wire["n"] - since["wire"]["n"],
        "wire_bytes": wire["bytes"] - since["wire"]["bytes"],
        "round_s": {k: v - since["wire"]["seconds"][k]
                    for k, v in wire["seconds"].items()},
        "side_collectives": side["n"] - since["side"]["n"],
        "side_bytes": side["bytes"] - since["side"]["bytes"],
        "worker": group.worker, "shard": group.shard,
        "shard_gathers": gather["n"] - since["shard_gather"]["n"],
        "shard_gather_bytes": gather["bytes"] - since["shard_gather"]["bytes"],
        "shard_gather_s": {k: v - since["shard_gather"]["seconds"][k]
                           for k, v in gather["seconds"].items()},
        "tp_collectives": tp["n"] - since["tp"]["n"],
        "tp_bytes": tp["bytes"] - since["tp"]["bytes"],
        "tp_s": {k: v - since["tp"]["seconds"][k]
                 for k, v in tp["seconds"].items()},
        "launches": {k: v - since["launches"][k]
                     for k, v in launches.items()},
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "max_memory_reserved": (torch.cuda.max_memory_reserved(dev)
                                if dev.type == "cuda" else None),
        "state_bytes": state_bytes, "state_digest": digest}


def train_loop(cfg, shape: ShapeConfig, opt_cfg: OptimizerConfig, *,
               steps: int = 100, seed: int = 0, log_every: int = 10,
               n_workers: int = 1, non_iid: bool = True,
               checkpoint_dir: str = "", checkpoint_every: int = 0,
               verbose: bool = True, device: Optional[str] = None,
               init_params=None, trace_out: str = "",
               metrics_out: str = "", group=None,
               digest: bool = False, plan=None) -> TrainResult:
    """Train up to step ``steps`` with ``n_workers`` workers stacked on
    ``device`` (a synchronous optimizer takes one). ``init_params`` (one
    worker's parameter dict) replaces the seeded initialisation, e.g. with
    weights carried across from the JAX package by ``repro_torch.convert``.

    ``plan`` (a ``configs.ParallelismPlan``) overrides the plan
    ``launch.mesh.resolve_plan`` gives the run's grid, as the reference's
    ``plan=`` does: e.g. its ``remat``.

    With a ``group`` (``core.comm.RankGroup``, from
    ``launch.mesh.init_ranks``) this process is one rank of a grid of
    ``n_workers`` workers × S shards: one worker a rank (S = 1), or shard
    ``r % S`` of worker ``r // S``'s flat planes (a sharded ``flat`` run).
    A one-model run spreads the global batch over the ranks and holds each
    leaf as its plan's spec says (FSDP parts or whole); a restore takes
    this rank's parts. ``device`` is this rank's. Every rank initialises from
    the same seed or ``init_params``, draws its worker's batches, and
    returns the same ``TrainResult``: the stacked run's, bit for bit.
    Rank 0 alone writes the checkpoints, the trace and the metrics, from
    the ranks' values gathered to it.

    ``checkpoint_dir`` resumes from its latest checkpoint (``start_step``)
    and, with ``checkpoint_every``, saves ``(params, opt_state,
    SyncState)`` after every ``checkpoint_every``-th step.

    ``trace_out`` records the run as a span stream (``repro_torch.trace``):
    one ``local_step`` span per worker per step with the sync decision the
    engine took, and modeled ``ef_encode`` and ``collective`` spans on sync
    rounds. ``metrics_out`` streams one JSONL row a step of health metrics
    (``repro_torch.obs``) and writes a Prometheus textfile beside it
    (``<base>.prom``). Both share one ``SyncHealthProbe``, so the spans and
    the rows report the same numbers; the probe runs after the step's span.
    All host times share ``time.perf_counter``. ``digest`` puts
    :func:`state_digest` of the final state into the result (every
    worker's, in a run with ranks)."""
    from repro_torch.core import comm
    if trace_out or metrics_out:
        opt_cfg = dataclasses.replace(opt_cfg, obs_metrics=True)
    dev = resolve_device(device)
    since = {"wire": comm.wire.snapshot(), "side": comm.side.snapshot(),
             "shard_gather": comm.shard_gather.snapshot(),
             "tp": comm.tp.snapshot(),
             "launches": _launch_counts()}
    programs = build_train_programs(cfg, opt_cfg, n_workers=n_workers,
                                    device=dev, group=group, plan=plan)
    # a rank draws its worker's batches (every shard of a worker the same),
    # or its share of a one-model run's global batch, split over grad_axes
    # a worker of several data ranks (the pods): rank (i, n) of its rows
    rank = rows = None
    if group is not None:
        along = group.layout.index_along(group.rank, programs.plan.grad_axes)
        rank = (group.worker, programs.n_workers) if programs.is_local \
            else along
        per = shape.global_batch // (programs.n_workers if programs.is_local
                                     else 1)
        if programs.is_local and along[1] > 1:
            rows = along
        if per % along[1]:
            raise ValueError(f"a batch of {per} rows does not split over "
                             f"{along[1]} ranks")
    layout = programs.leaf_layout
    # a worker axis spread over ranks: the state is gathered to rank 0
    ranked = group is not None and programs.is_local
    # leaves in parts: each rank holds its own (a worker's, where ranked)
    sharded = layout is not None and (layout.sharded or ranked)
    lead = group is None or group.rank == 0   # writes the run's files
    verbose = verbose and lead
    R = programs.n_workers
    batch_workers = R if programs.is_local else 0
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                     n_workers=R, seed=seed, non_iid=non_iid)

    def batch_at(step: int) -> dict:
        """This rank's batch of ``step``, on its device."""
        batch = make_train_batch(cfg, shape, ds, step,
                                 n_workers=batch_workers, rank=rank)
        if rows is not None:       # this rank's rows of its worker's
            i, n = rows
            batch = {k: v[:, i * (v.shape[1] // n):(i + 1) * (
                v.shape[1] // n)] for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()}

    params, opt_state = programs.init_fn(seed, init_params)
    # a one-model run syncs every step (the reference's H = 1 engine)
    engine = make_sync_engine(opt_cfg, is_local=programs.is_local,
                              H=programs.H if programs.is_local else 1)
    start_step, sync_state = 0, None
    if checkpoint_dir:
        from repro_torch.checkpoint import latest_step
        if latest_step(checkpoint_dir) is not None:
            params, opt_state, sync_state, start_step = _restore(
                checkpoint_dir, programs, engine, params, opt_state, dev,
                verbose)
    engine.reset(start_step)
    if sync_state is not None:
        engine.import_state(sync_state)
    n_params = count_params(cfg)

    # ---- obs: metrics registry + the shared sync-health probe ---------- #
    from repro_torch.obs import NULL_REGISTRY, SyncHealthProbe
    registry = NULL_REGISTRY
    if metrics_out and lead:
        from repro_torch.obs import MetricsRegistry
        registry = MetricsRegistry(labels={
            "arch": cfg.name, "algorithm": opt_cfg.name,
            "policy": opt_cfg.sync.policy,
            "codec": opt_cfg.sync.compression or "fp32", "workers": R})
        registry.open_jsonl(metrics_out)
    probe = None
    if metrics_out or trace_out:      # on every rank: each joins the gathers
        probe = SyncHealthProbe.build(engine, programs, n_params)
        if registry:
            registry.set_many(probe.static_summary())

    # ---- trace recorder: spans + modeled round costs ------------------- #
    recorder = None
    if trace_out and lead:
        from repro_torch.hardware import H100
        from repro_torch.trace import TraceRecorder
        n_coll = engine.round_collectives(programs.n_payload_leaves,
                                          flat=programs.is_flat)
        round_b = engine.round_bytes(n_params)
        # modeled device-side encode and wire time of ONE sync round, as
        # the replay prices it (FabricModel: the link, not this host)
        enc_bytes = engine.modeled_encode_hbm_bytes(n_params)
        enc_t = enc_bytes / H100.hbm_bw
        # a sharded plane's worker-sub-group collective moves a sub-plane
        n_shards = programs.n_shards
        shard_b = engine.round_bytes_per_shard(n_params, n_shards)
        wire_t = comm.collective_time(shard_b, n_coll, R)
        st0 = engine.export_state()
        recorder = TraceRecorder(meta={
            "kind": "train", "framework": "torch", "arch": cfg.name,
            "algorithm": opt_cfg.name, "n_params": int(n_params),
            "n_workers": R, "steps": steps, "start_step": start_step,
            "H": programs.H, "is_local": programs.is_local,
            "flat": programs.is_flat,
            "sync": dataclasses.asdict(opt_cfg.sync),
            "use_kernels": opt_cfg.use_kernels,
            "n_payload_leaves": programs.n_payload_leaves,
            "n_collectives_per_round": n_coll,
            "n_shards": n_shards,
            "round_wire_bytes_per_shard": shard_b,
            "fabric": dataclasses.asdict(comm.FabricModel()),
            "hbm_bw": H100.hbm_bw, "hardware": H100.name,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "clock": "perf_counter",
            "sync_state0": {"since": int(st0.since),
                            "drift": float(st0.drift)},
        })

    # ---- the steps' cost tables (roofline.region_table), on the card -- #
    # Each step walked once on the meta device and priced on the H100's
    # roofline: the replay prices a sync round from the tables'
    # sync / local ratio, and every local_step span carries its step's
    # optimal wall. A run off the card has no table (the reference's own
    # fallback where it cannot lower one): its replay prices from the warm
    # means, since an H100 roofline would be held to another device's walls
    hlo_local_s = hlo_extra_s = None
    if recorder is not None and dev.type == "cuda":
        tabs = step_cost_tables(cfg, opt_cfg, programs, batch_at(start_step),
                                seed=seed, group=group)
        recorder.meta["hlo_cost"] = tabs
        hlo_local_s = float(tabs["local_step"]["optimal_s"])
        hlo_extra_s = max(0.0, float(tabs["sync_step"]["optimal_s"])
                          - hlo_local_s)

    def now() -> float:
        return recorder.now() if recorder is not None else time.perf_counter()

    def probe_state(synced: bool):
        """The opt-state entries the probe reads, all workers stacked:
        gathered to rank 0 in a run with ranks (None on the others); a run
        whose leaves are in parts probes each rank's own."""
        if not ranked or sharded:
            return opt_state
        keys = ["b2_local"] + (["res_params", "res_b2"] if synced else [])
        got = gather_workers(
            programs, {k: opt_state[k] for k in keys if k in opt_state},
            to_device=lead)
        return got if lead else None

    losses, ppls, step_s, probe_s = [], [], [], []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        batch = batch_at(step)
        do_sync = engine.want_sync(step)
        t_step = now()
        fn = programs.sync_step if do_sync else programs.local_step
        # a span per step for torch.profiler (a no-op when none is active)
        with torch.profiler.record_function(
                f"train_step {step} {'sync' if do_sync else 'local'}"):
            params, opt_state, metrics = fn(params, opt_state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the step's time includes its kernels
        loss = float(metrics["loss"])
        dur = now() - t_step
        step_s.append(dur)
        drift_val = (float(metrics.get("drift", 0.0))
                     if engine.wants_drift else 0.0)
        # decision-time window state (before observe folds this step in)
        st = engine.export_state() if recorder is not None else None
        engine.observe(step, do_sync,
                       {"drift": drift_val} if engine.wants_drift else None)
        summary = {}
        if probe is not None:   # one summary feeds both exports
            t_probe = time.perf_counter()
            state_view = probe_state(do_sync)
            if lead or sharded:     # the parts' sums need every rank
                summary = probe.step_summary(state_view, metrics,
                                             synced=do_sync)
            del state_view
            probe_s.append(time.perf_counter() - t_probe)
        if recorder is not None:
            from repro_torch.trace.events import health_span_args
            t_end = t_step + dur
            health = health_span_args(summary)
            if hlo_local_s is not None:
                health["hlo_optimal_s"] = hlo_local_s
            enc_args = ({} if hlo_extra_s is None
                        else {"hlo_extra_optimal_s": hlo_extra_s})
            for w in range(R):
                recorder.add("local_step", worker=w, step=step, t0=t_step,
                             dur=dur, synced=do_sync, loss=loss,
                             drift=drift_val, sync_since=int(st.since),
                             sync_drift=float(st.drift), **health)
                if do_sync:
                    recorder.add("ef_encode", worker=w, step=step, t0=t_end,
                                 dur=enc_t, modeled=True,
                                 hbm_bytes=enc_bytes, codec=engine.codec.name,
                                 **enc_args)
                    recorder.add("collective", worker=w, step=step,
                                 t0=t_end + enc_t, dur=wire_t, modeled=True,
                                 wire_bytes=round_b,
                                 wire_bytes_per_shard=shard_b,
                                 n_shards=n_shards,
                                 n_collectives=n_coll,
                                 codec=engine.codec.name, workers=R)
        if registry:
            registry.counter("steps_total").inc()
            registry.gauge("loss", help="train loss (mean over workers)"
                           ).set(loss)
            registry.histogram("step_time_s",
                               help="host wall of one train step"
                               ).observe(dur)
            probe.record(registry, summary, step=step, synced=do_sync)
            registry.collect(step)
        losses.append(loss)
        ppls.append(math.exp(min(loss, 30.0)))
        if verbose and (step % log_every == 0 or step == steps - 1):
            t_ev = now()
            print(f"step {step:5d} loss {loss:8.4f} ppl {ppls[-1]:10.2f} "
                  f"{'sync' if do_sync else 'local'}")
            if recorder is not None:
                recorder.add("eval", step=step, t0=t_ev, dur=now() - t_ev,
                             loss=loss)
        if checkpoint_dir and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            from repro_torch.checkpoint import save_checkpoint
            t_ck = now()
            state = (params, opt_state)
            if ranked and sharded:    # whole leaves, every worker's rows
                state = group.workers.gather_stacked(
                    (layout.gather_whole(params),
                     layout.state(layout.gather_whole, opt_state)),
                    to_device=False)
            elif ranked:              # every worker's rows, stacked
                state = gather_workers(programs, state, to_device=False)
            elif sharded:             # every leaf whole
                state = (layout.whole(params),
                         layout.state(layout.whole, opt_state))
            if lead:
                save_checkpoint(checkpoint_dir, step + 1,
                                (*state, engine.export_state()))
            del state
            if recorder is not None:
                recorder.add("ckpt", step=step, t0=t_ck, dur=now() - t_ck,
                             dir=checkpoint_dir)

    wall = time.perf_counter() - t0
    executed = max(steps - start_step, 0)
    # Measured comm: the schedule that ran times the codec's round payload
    # (local optimizers); a synchronous optimizer all-reduces its gradient
    # every step (P fp32 values), untouched by H or the codec.
    if programs.is_local:
        total = engine.sync_count * engine.round_bytes(n_params)
        modeled = engine.modeled_bytes_per_step(n_params)
    else:
        total = executed * engine.grad_allreduce_bytes(n_params)
        modeled = engine.grad_allreduce_bytes(n_params)
    final = float(np.mean(losses[-10:])) if losses else float("nan")
    if registry:
        registry.gauge("final_loss",
                       help="mean loss over the last 10 steps").set(final)
        base = (metrics_out[:-len(".jsonl")]
                if metrics_out.endswith(".jsonl") else metrics_out)
        registry.write_prom(base + ".prom")
        registry.close()
        if verbose:
            print(f"wrote metrics {metrics_out} "
                  f"(+ Prometheus textfile {base + '.prom'})")
    if recorder is not None:
        recorder.meta["measured"] = {
            "wall_s": wall, "sync_count": engine.sync_count,
            "sync_steps": list(engine.sync_steps), "final_loss": final}
        recorder.save(trace_out)
        if verbose:
            print(f"wrote trace {trace_out} ({len(recorder.spans)} spans; "
                  f"python -m repro_torch.trace.chrome {trace_out} to view, "
                  "python -m repro_torch.trace.replay for what-ifs)")
    digests = (state_digest(params, opt_state, worker_axis=programs.is_local,
                            layout=layout if sharded else None)
               if digest else {})
    ranks = []
    if group is not None:     # every rank's report; rank 0's walls for all
        import torch.distributed as dist
        ranks = [None] * group.world
        state_bytes = sum(t.numel() * t.element_size() for t in
                          tree_leaves((params, opt_state))
                          if t.is_floating_point())
        dist.all_gather_object(ranks, _rank_report(
            group, dev, since, step_s, probe_s, wall, digests, state_bytes),
            group=group.group)
        wall, step_s, probe_s = (ranks[0][k]
                                 for k in ("wall_s", "step_s", "probe_s"))
        if ranked:            # a rank holds (a shard of) one worker: the
            S = programs.n_shards     # digest sums add over the shards
            digests = {k: [sum(rep["state_digest"][k][0]
                               for rep in ranks[w * S:(w + 1) * S])
                           for w in range(R)] for k in digests}
        elif sharded:         # every rank holds parts of the one model
            digests = {k: [sum(rep["state_digest"][k][0] for rep in ranks)]
                       for k in digests}
    return TrainResult(losses=losses, ppl=ppls, steps=executed, n_workers=R,
                       comm_bytes_per_step=total / executed if executed
                       else 0.0,
                       wall_s=wall, final_loss=final, start_step=start_step,
                       sync_count=engine.sync_count,
                       sync_steps=list(engine.sync_steps),
                       comm_bytes_total=total, comm_bytes_modeled=modeled,
                       sync_policy=engine.name, step_s=step_s,
                       probe_s=probe_s, state_digest=digests, ranks=ranks)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="biglstm", help=f"one of {sorted(ARCHS)}")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-sized family member (2 layers, "
                         "d_model 256, --vocab tokens)")
    ap.add_argument("--optimizer", default="local_adaalter",
                    choices=["sgd", "adagrad", "adaalter", "local_sgd",
                             "local_adaalter"])
    ap.add_argument("--H", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--param-dtype", default="",
                    choices=["", "bfloat16", "float32"],
                    help="the parameters' dtype (default: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", nargs="?", const="int8", default="",
                    choices=["", *CODEC_NAMES], metavar="SCHEME",
                    help="sync wire codec: 'bf16' or 'int8' (per-block int8 "
                         "+ fp32 scales), both with error feedback. Bare "
                         "--compress means int8")
    ap.add_argument("--sync-policy", default="fixed_h", choices=POLICY_NAMES)
    ap.add_argument("--sync-threshold", type=float, default=0.05)
    ap.add_argument("--drift-metric", default="update_norm",
                    choices=DRIFT_METRICS)
    ap.add_argument("--h-min", type=int, default=1)
    ap.add_argument("--h-max", type=int, default=0)
    ap.add_argument("--use-kernels", action="store_true",
                    help="run the fused AdaAlter update and the int8 sync "
                         "encode through the hand-written CUDA kernels (their "
                         "plain versions on CPU tensors)")
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="workers stacked on the one device (0 -> 1); under "
                         "torchrun the ranks form an N x (world / N) grid: "
                         "rank r is worker r // S and holds shard r %% S of "
                         "its flat plane (--flat) or, per leaf, its parts "
                         "of the worker's weights (tensor parallelism over "
                         "model), so N must divide the world size. A "
                         "one-model plan (a synchronous optimizer, or the "
                         "plans above 20 B parameters) keeps one model: its "
                         "N rows of ranks spread --batch, each leaf split "
                         "over data (FSDP) and model (default: N = world)")
    ap.add_argument("--full-plan", action="store_true",
                    help="with --reduced: train under the plan of the "
                         "full-size architecture (launch.mesh.resolve_plan "
                         "on its parameter count), e.g. llama3-405b's one "
                         "model with FSDP over data")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="under torchrun: nccl (the default on the cards, "
                         "one card a rank) or gloo (the default with --device "
                         "cpu; on the cards it stages the wire through host "
                         "memory, and ranks may share a card)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--iid", action="store_true", help="disable non-IID workers")
    ap.add_argument("--out", default="",
                    help="write the TrainResult JSON here, with a digest of "
                         "the final state (each worker's params, B² and EF "
                         "residuals: train_loop's state_digest)")
    ap.add_argument("--unfused-sync", action="store_true",
                    help="compose the sync encode from three passes (EF add "
                         "/ quantize / dequantize + residual) instead of the "
                         "one-pass kernel; bitwise identical")
    ap.add_argument("--flat", action="store_true",
                    help="flat parameter plane (core/flatspace.py): params "
                         "and optimizer state packed into fp32 planes at "
                         "init; a step is one update launch and a sync round "
                         "one EF encode per payload half. Train state bitwise "
                         "equal to the per-leaf layout's. local_adaalter only")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="record the run as a span timeline "
                         "(repro_torch.trace): per-worker per-step spans "
                         "with the engine's sync decisions and modeled "
                         "encode/wire costs. Export with `python -m "
                         "repro_torch.trace.chrome`, what-ifs with `python "
                         "-m repro_torch.trace.replay`")
    ap.add_argument("--metrics", default="", metavar="OUT.jsonl",
                    help="stream per-step health metrics (repro_torch.obs): "
                         "one JSONL row a step (loss, raw-grad norm, drift, "
                         "B² quantiles per dtype bucket, EF residual norms "
                         "and quantization MSE on sync rounds, wire "
                         "compression ratio) and a Prometheus textfile "
                         "beside it (OUT.prom)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="resume from the latest checkpoint here (either "
                         "package's, either layout) and save into it")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="save after every N-th step (0: never)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg, vocab=args.vocab)
    if args.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.param_dtype)
    shape = ShapeConfig(name="cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    opt_cfg = OptimizerConfig.from_sync(
        SyncConfig(policy=args.sync_policy, threshold=args.sync_threshold,
                   h_min=args.h_min, h_max=args.h_max,
                   drift_metric=args.drift_metric,
                   compression=args.compress, fused=not args.unfused_sync),
        name=args.optimizer, lr=args.lr, H=args.H,
        warmup_steps=args.warmup, use_kernels=args.use_kernels,
        flat=args.flat)
    R = max(1, args.workers)
    from repro_torch.launch import mesh
    world = mesh.world_size()
    planned = get_arch(args.arch) if args.full_plan else cfg
    grid = {"data": world, "model": 1}
    plan = mesh.resolve_plan(planned, grid, optimizer=args.optimizer)
    one_model = args.optimizer in SYNC_OPTIMIZERS or not plan.local_axes
    if R > 1 and one_model and world == 1:
        why = ("is a synchronous optimizer" if args.optimizer in
               SYNC_OPTIMIZERS else "has no worker axes above 20 B "
               "parameters")
        ap.error(f"--workers {R}: {args.optimizer} {why}, trained as one "
                 "model over the global batch (R = 1)")
    if world > 1:
        try:                     # workers (one model: rows) x shards
            grid = mesh.grid_of(world, (args.workers or world) if one_model
                                else R)
        except ValueError as e:
            ap.error(str(e))
        plan = mesh.resolve_plan(planned, grid, optimizer=args.optimizer)
        if one_model:
            R = 1
    elif args.dist_backend:
        ap.error("--dist-backend needs a launch with ranks (torchrun)")
    group, device = None, args.device
    if world > 1:
        group, dev = mesh.init_ranks(args.dist_backend, args.device,
                                     grid=grid, fsdp_axes=plan.fsdp_axes)
        device = str(dev)
    lead = group is None or group.rank == 0
    try:
        where = (f"{R} stacked worker(s) on {resolve_device(device)}"
                 if group is None else
                 f"{world} ranks, " + (
                     ("one model, FSDP over data" if plan.fsdp_axes
                      else "data-parallel")
                     + (f" x {grid['model']} TP shards"
                        if grid["model"] > 1 else "") if one_model
                     else "one worker each" if grid["model"] == 1 else
                     f"{R} workers x {grid['model']} shards")
                 + f"; rank 0: {group.route}")
        if lead:
            print(f"training {cfg.name} ({count_params(cfg):,} params) with "
                  f"{args.optimizer} H={args.H}"
                  f"{' +' + args.compress + ' sync' if args.compress else ''}"
                  f"{' (flat plane)' if args.flat else ''}, {where}",
                  flush=True)
        res = train_loop(cfg, shape, opt_cfg, steps=args.steps,
                         seed=args.seed, n_workers=R, non_iid=not args.iid,
                         device=device, checkpoint_dir=args.checkpoint_dir,
                         checkpoint_every=args.checkpoint_every,
                         trace_out=args.trace, metrics_out=args.metrics,
                         group=group, digest=bool(args.out), plan=plan)
    finally:
        mesh.close_ranks()
    if not lead:
        return
    print(f"done in {res.wall_s:.1f}s; final loss {res.final_loss:.4f}; "
          f"{res.sync_count} syncs in {res.steps} steps; measured comm/step "
          f"{res.comm_bytes_per_step / 1e6:.1f} MB (modeled "
          f"{res.comm_bytes_modeled / 1e6:.1f} MB; {res.n_workers} workers)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dataclasses.asdict(res), f, indent=1)


if __name__ == "__main__":
    main()

"""Training driver of the port: Local AdaAlter on the synthetic non-IID stream.

The counterpart of the JAX package's ``launch/train.py`` for the local
paths: R workers stacked on one device, per-leaf or over the flat parameter
plane (``--flat``), the sync round owned by a ``SyncEngine`` (fixed-H or
adaptive schedule, fp32/bf16/int8 wire, one-pass or three-pass encode),
and a ``TrainResult`` with the measured sync schedule and the bytes it
moved. Runs on the CUDA device unless ``device='cpu'`` / ``--device cpu``.

  python -m repro_torch.launch.train --arch biglstm --optimizer \\
      local_adaalter --flat --compress int8 --use-kernels --workers 2 \\
      --batch 64 --seq 20 --steps 8
  python -m repro_torch.launch.train --device cpu --arch biglstm --reduced \\
      --use-kernels --compress int8 --steps 8 [--flat] [--unfused-sync]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import (ARCHS, OptimizerConfig, ShapeConfig,
                                 SyncConfig, get_arch, reduced)
from repro_torch.core.codecs import CODEC_NAMES
from repro_torch.core.sync_engine import DRIFT_METRICS, make_sync_engine
from repro_torch.core.sync_policy import POLICY_NAMES
from repro_torch.data import SyntheticLM, make_train_batch
from repro_torch.launch.steps import build_train_programs
from repro_torch.models.counting import count_params


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    ppl: List[float]
    steps: int                             # steps executed
    n_workers: int
    comm_bytes_per_step: float             # MEASURED: moved bytes / steps run
    wall_s: float
    final_loss: float
    start_step: int = 0
    sync_count: int = 0                    # sync rounds the policy triggered
    sync_steps: List[int] = dataclasses.field(default_factory=list)
    comm_bytes_total: float = 0.0          # measured wire bytes, whole run
    comm_bytes_modeled: float = 0.0        # static fixed-H formula, per step
    sync_policy: str = "fixed_h"
    step_s: List[float] = dataclasses.field(default_factory=list)
                                           # host seconds of each step, the
                                           # device's work included


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The CUDA device unless the caller names another; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port trains on the card; pass "
                "device='cpu' (--device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def train_loop(cfg, shape: ShapeConfig, opt_cfg: OptimizerConfig, *,
               steps: int = 100, seed: int = 0, log_every: int = 10,
               n_workers: int = 1, non_iid: bool = True,
               verbose: bool = True, device: Optional[str] = None,
               init_params=None) -> TrainResult:
    """Train ``steps`` steps with ``n_workers`` workers stacked on
    ``device``. ``init_params`` (one worker's parameter dict) replaces the
    seeded initialisation, e.g. with weights carried across from the JAX
    package by ``repro_torch.convert``."""
    dev = resolve_device(device)
    programs = build_train_programs(cfg, opt_cfg, n_workers=n_workers,
                                    device=dev)
    R = programs.n_workers
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                     n_workers=R, seed=seed, non_iid=non_iid)
    params, opt_state = programs.init_fn(seed, init_params)
    engine = make_sync_engine(opt_cfg, is_local=True, H=programs.H)
    engine.reset(0)
    n_params = count_params(cfg)

    losses, ppls, step_s = [], [], []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 make_train_batch(cfg, shape, ds, step, n_workers=R).items()}
        do_sync = engine.want_sync(step)
        t_step = time.perf_counter()
        fn = programs.sync_step if do_sync else programs.local_step
        # a span per step for torch.profiler (a no-op when none is active)
        with torch.profiler.record_function(
                f"train_step {step} {'sync' if do_sync else 'local'}"):
            params, opt_state, metrics = fn(params, opt_state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the step's time includes its kernels
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t_step)
        drift_val = (float(metrics.get("drift", 0.0))
                     if engine.wants_drift else 0.0)
        engine.observe(step, do_sync,
                       {"drift": drift_val} if engine.wants_drift else None)
        losses.append(loss)
        ppls.append(math.exp(min(loss, 30.0)))
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d} loss {loss:8.4f} ppl {ppls[-1]:10.2f} "
                  f"{'sync' if do_sync else 'local'}")
    wall = time.perf_counter() - t0
    total = engine.sync_count * engine.round_bytes(n_params)
    final = float(np.mean(losses[-10:])) if losses else float("nan")
    return TrainResult(losses=losses, ppl=ppls, steps=steps, n_workers=R,
                       comm_bytes_per_step=total / steps if steps else 0.0,
                       wall_s=wall, final_loss=final,
                       sync_count=engine.sync_count,
                       sync_steps=list(engine.sync_steps),
                       comm_bytes_total=total,
                       comm_bytes_modeled=engine.modeled_bytes_per_step(
                           n_params),
                       sync_policy=engine.name, step_s=step_s)


#: flags of the JAX training CLI whose paths are later slices of the port
_NOT_PORTED = {
    "trace": "span tracing (ROADMAP Queue 1: trace/obs)",
    "metrics": "the health-metrics stream (ROADMAP Queue 1: trace/obs)",
    "checkpoint_dir": "checkpoints (ROADMAP Queue 1: checkpoints)",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="biglstm", help=f"one of {sorted(ARCHS)}")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-sized family member")
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
                    help="workers stacked on the one device (0 -> 1)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--iid", action="store_true", help="disable non-IID workers")
    ap.add_argument("--out", default="", help="write the TrainResult JSON here")
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
    for flag in ("trace", "metrics", "checkpoint_dir"):
        ap.add_argument("--" + flag.replace("_", "-"), default="",
                        help="not ported yet: raises")
    args = ap.parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {what} is not "
                             "ported to PyTorch yet")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg, vocab=args.vocab)
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
    print(f"training {cfg.name} ({count_params(cfg):,} params) with "
          f"{args.optimizer} H={args.H}"
          f"{' +' + args.compress + ' sync' if args.compress else ''}"
          f"{' (flat plane)' if args.flat else ''}, "
          f"{R} stacked worker(s) on {resolve_device(args.device)}")
    res = train_loop(cfg, shape, opt_cfg, steps=args.steps, seed=args.seed,
                     n_workers=R, non_iid=not args.iid, device=args.device)
    print(f"done in {res.wall_s:.1f}s; final loss {res.final_loss:.4f}; "
          f"{res.sync_count} syncs in {res.steps} steps; measured comm/step "
          f"{res.comm_bytes_per_step / 1e6:.1f} MB (modeled "
          f"{res.comm_bytes_modeled / 1e6:.1f} MB; {res.n_workers} workers)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dataclasses.asdict(res), f, indent=1)


if __name__ == "__main__":
    main()

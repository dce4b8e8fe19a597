#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Local AdaAlter on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each; any failure
raises and exits non-zero:

  device    the card's name and power limit (nvidia-smi), torch's view of it
  build     both CUDA kernels compiled from src/repro_torch/kernels/csrc/
  kernels   each kernel against its plain PyTorch version on the card, at
            the full-width Big LSTM shapes of the training path: the fused
            update (y to rtol 8e-3 bf16 / 1e-6 fp32 of the larger of |y|
            and the update, which is a quarter of |x| here; b2_local
            bitwise; the same check must reject an update with η 2% off
            and one that reads b2_local for b2_sync) and the one-pass EF
            int8 encode (wire and residual bitwise); CUDA-event times
            beside the memory-bound least time
  reference reduced Big LSTM in float32, lr 2, 8 steps, 2 workers, int8
            sync: the card with the kernels against the CPU with their
            plain versions, same initial weights (losses to rtol 1e-4,
            which the CPU run with η 2% larger must exceed)
  train     full-width Big LSTM (793,471 vocab, 832,198,527 parameters,
            bf16), 2 workers stacked on the card, 32 sequences of 20 tokens
            per worker, Local AdaAlter H=4, int8 wire with fused error
            feedback, kernels on, 8 steps, through train_loop — with the
            kernels' launch counts read around exactly this run
  profile   the same run for 4 steps under torch.profiler: per step the
            device's busy time and idle share and its time by kernel

then the kernels summary line, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
TRAIN_STEPS = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of one call, by CUDA events, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bitwise_equal(a, b) -> bool:
    import torch
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def update_agrees(y, y_ref, x, rtol) -> bool:
    """y within ``rtol`` of ``y_ref``, measured against the larger of
    |y_ref| and the update |x − y_ref|: where the update nearly cancels x,
    the error is held at the update's own scale. No absolute floor."""
    import torch
    yf, rf = y.float(), y_ref.float()
    scale = torch.maximum(rf.abs(), (x.float() - rf).abs())
    return bool(((yf - rf).abs() <= rtol * scale).all())


def check_update(gen, shape, dtype):
    """Fused update kernel vs its plain version on one stacked leaf.

    The inputs make the update a quarter of |x| (η = 0.5, g ~ N(0, 1),
    rsqrt(b2_sync + 3) ≈ 0.47), so y's tolerance sees it; the check must
    also reject two wrong updates: η 2% too large, and b2_local read in
    place of b2_sync."""
    import torch
    from repro_torch.kernels import adaalter_update as au
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    bs = 1.0 + torch.rand(shape, generator=gen, device="cuda")
    bl = bs + torch.rand(shape, generator=gen, device="cuda")
    scalars = au.update_scalars(0.5, 3.0, "cuda")
    y, b2 = au.fused_update(x, g, bs, bl, scalars)
    y_ref, b2_ref = au.fused_update_plain(x, g, bs, bl, scalars)
    torch.cuda.synchronize()
    rtol = 8e-3 if dtype == torch.bfloat16 else 1e-6
    max_err = float((y.float() - y_ref.float()).abs().max())
    require(update_agrees(y, y_ref, x, rtol),
            f"update y off its plain version ({dtype}, max {max_err})")
    require(bitwise_equal(b2, b2_ref), f"update b2_local not bitwise ({dtype})")
    del y, b2, b2_ref
    wrong = {
        "eta_2pct_high": au.fused_update_plain(
            x, g, bs, bl, au.update_scalars(0.5 * 1.02, 3.0, "cuda"))[0],
        "b2_local_for_b2_sync": au.fused_update_plain(x, g, bl, bl,
                                                      scalars)[0]}
    for what, y_bad in wrong.items():
        require(not update_agrees(y_bad, y_ref, x, rtol),
                f"the update check accepts a wrong update ({what}, {dtype})")
    del wrong, y_bad
    n = x.numel()
    nbytes = n * (3 * x.element_size() + 3 * 4)
    return dict(
        dtype=str(dtype).replace("torch.", ""), shape=list(shape),
        max_abs_err=max_err, rejects_wrong_updates=True,
        ms=cuda_ms(lambda: au.fused_update(x, g, bs, bl, scalars)),
        plain_ms=cuda_ms(lambda: au.fused_update_plain(x, g, bs, bl, scalars)),
        bytes=nbytes, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)


def check_ef(gen, shape, dtype, clamp, timed=True):
    """One-pass EF encode kernel vs its plain version on one stacked leaf."""
    import torch
    from repro_torch.kernels import sync_fused as sf
    if clamp:      # accumulator payload: B² around 1, a residual that
        # drives a stripe of it negative so the clamp fires
        x = (1.0 + torch.rand(shape, generator=gen, device="cuda")).to(dtype)
        e = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        e.view(-1)[:4096] = -4.0
    else:
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.05).to(dtype)
        e = torch.randn(shape, generator=gen, device="cuda") * 1e-4
    x.view(-1)[4096:4096 + 512] = 0          # two all-zero blocks
    e.view(-1)[4096:4096 + 512] = 0
    w_ref, r_ref = sf.fused_ef_leaf_plain(x, e, batch_ndim=1,
                                          clamp_nonneg=clamp)
    e_k = e.clone()
    w, r = sf.fused_ef_leaf(x, e_k, batch_ndim=1, clamp_nonneg=clamp)
    torch.cuda.synchronize()
    require(r.data_ptr() == e_k.data_ptr(), "EF residual not written in place")
    require(bitwise_equal(w, w_ref), f"EF wire not bitwise ({dtype}, {clamp})")
    require(bitwise_equal(r, r_ref), f"EF residual not bitwise ({dtype}, {clamp})")
    out = dict(dtype=str(dtype).replace("torch.", ""), shape=list(shape),
               clamp_nonneg=clamp,
               max_abs_err=max(float((w.float() - w_ref.float()).abs().max()),
                               float((r - r_ref).abs().max())))
    if timed:
        del w_ref, r_ref
        nbytes = x.numel() * (2 * x.element_size() + 2 * 4)
        out.update(
            ms=cuda_ms(lambda: sf.fused_ef_leaf(x, e_k, batch_ndim=1,
                                                clamp_nonneg=clamp)),
            plain_ms=cuda_ms(lambda: sf.fused_ef_leaf_plain(
                x, e, batch_ndim=1, clamp_nonneg=clamp)),
            bytes=nbytes, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
    return out


def _busy_us(spans) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_steps(run, top: int = 12):
    """``run()`` (a train_loop call) under ``torch.profiler``. For each
    ``train_step`` span that train_loop records: its host wall, the device's
    busy time (the union of the kernels launched in it — train_loop
    synchronises at the end of each step) and idle share, the launches,
    and the device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.events()
    steps = sorted((e for e in events if e.name.startswith("train_step ")
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: e.time_range.start)
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("train_step ")]
    out = []
    for s in steps:
        a, b = s.time_range.start, s.time_range.end
        mine = [k for k in kernels if a <= k[0] < b]
        by_name = {}
        for k0, k1, name in mine:
            by_name[name] = by_name.get(name, 0.0) + (k1 - k0) / 1e3
        busy = _busy_us((k0, k1) for k0, k1, _ in mine)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
        out.append({"step": s.name, "wall_ms": (b - a) / 1e3,
                    "device_busy_ms": busy / 1e3,
                    "device_idle_share": 1.0 - busy / (b - a),
                    "launches": len(mine),
                    "device_ms_by_kernel": {k[:100]: v for k, v in ranked[:top]},
                    "device_ms_other_kernels": sum(v for _, v in ranked[top:])})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import (OptimizerConfig, ShapeConfig, get_arch,
                                     reduced)
    from repro_torch.kernels import _build
    from repro_torch.kernels import adaalter_update as au
    from repro_torch.kernels import sync_fused as sf
    from repro_torch.launch.train import train_loop
    from repro_torch.models.counting import count_params
    from repro_torch.models.lstm import init_lstm

    # float32 products in full float32 everywhere (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- device --------------------------------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- build ---------------------------------------------------------- #
    t0 = time.perf_counter()
    log = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.library_path().relative_to(root)),
          "sources": [p.name for p in _build.sources()], "ptxas": ptxas})

    # ---- kernels vs plain, at the full-width shapes of the path --------- #
    cfg = get_arch("biglstm")
    V, P = cfg.vocab_size, cfg.lstm_proj
    gen = torch.Generator("cuda").manual_seed(0)
    upd = [check_update(gen, (2, V, P), torch.bfloat16),
           check_update(gen, (2, P, 4 * cfg.d_model), torch.float32)]
    torch.cuda.empty_cache()
    ef = [check_ef(gen, (2, V, P), torch.bfloat16, False),
          check_ef(gen, (2, V, P), torch.float32, True),
          check_ef(gen, (2, V), torch.bfloat16, False, timed=False),
          check_ef(gen, (2, V), torch.float32, True, timed=False)]
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "nvidia_smi": smi, "update": upd, "ef": ef})

    # ---- reduced reference: card + kernels vs CPU + plain versions ------ #
    # lr 2 makes the losses move enough that a wrong update shows: the same
    # run on the CPU with η 2% larger must fall outside the tolerance
    small = dataclasses.replace(reduced(cfg), param_dtype="float32")
    base = init_lstm(torch.Generator().manual_seed(1), small)
    shape = ShapeConfig("smoke", seq_len=16, global_batch=8, kind="train")

    def reduced_losses(dev, lr):
        oc = OptimizerConfig(compression="int8", use_kernels=True, H=4,
                             lr=lr, warmup_steps=0)
        res = train_loop(small, shape, oc, steps=TRAIN_STEPS, n_workers=2,
                         verbose=False, device=dev, init_params=base)
        require(res.sync_steps == [3, 7],
                f"reduced run on {dev}: sync steps {res.sync_steps}")
        return res.losses

    def max_rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    cuda, cpu = reduced_losses("cuda", 2.0), reduced_losses("cpu", 2.0)
    rel, rtol = max_rel(cuda, cpu), 1e-4
    rel_wrong = max_rel(reduced_losses("cpu", 2.0 * 1.02), cpu)
    require(rel <= rtol, f"reduced run: losses differ by {rel} relative")
    require(rel_wrong > rtol, f"reduced run: an η 2% off moves the losses "
            f"by only {rel_wrong}, within the tolerance")
    emit({"phase": "reference", "losses_cuda": cuda, "losses_cpu": cpu,
          "max_rel_diff": rel, "rtol": rtol,
          "max_rel_diff_eta_2pct_high": rel_wrong})

    # ---- full-width training through train_loop ------------------------- #
    R, batch, seq = 2, 64, 20
    oc = OptimizerConfig(name="local_adaalter", lr=0.5, H=4,
                         warmup_steps=100, compression="int8",
                         use_kernels=True)
    shape = ShapeConfig("full", seq_len=seq, global_batch=batch, kind="train")
    torch.cuda.reset_peak_memory_stats()
    au.launches.reset()
    sf.launches.reset()
    res = train_loop(cfg, shape, oc, steps=TRAIN_STEPS, n_workers=R,
                     log_every=1, device="cuda")
    launches = {"adaalter_update": au.launches.n, "fused_ef": sf.launches.n}
    n_leaves = 3 + 4 * cfg.n_layers
    require(res.sync_steps == [3, 7], f"sync steps {res.sync_steps}")
    require(launches["adaalter_update"] == n_leaves * TRAIN_STEPS,
            f"update launches {launches}")
    require(launches["fused_ef"] == 2 * n_leaves * len(res.sync_steps),
            f"EF launches {launches}")
    require(all(math.isfinite(v) for v in res.losses), "non-finite loss")
    require(abs(res.losses[0] - math.log(V)) <= 1.5,
            f"step-0 loss {res.losses[0]} vs ln V {math.log(V)}")
    warm = list(range(1, TRAIN_STEPS))
    local_ms = [1e3 * res.step_s[i] for i in warm if i not in res.sync_steps]
    sync_ms = [1e3 * res.step_s[i] for i in warm if i in res.sync_steps]
    emit({"phase": "train", "nvidia_smi": smi, "arch": cfg.name,
          "params": count_params(cfg), "workers": R, "global_batch": batch,
          "seq": seq, "steps": TRAIN_STEPS, "losses": res.losses,
          "sync_steps": res.sync_steps, "launches": launches,
          "step_ms": [1e3 * s for s in res.step_s],
          "local_step_ms_median": statistics.median(local_ms),
          "sync_step_ms_median": statistics.median(sync_ms),
          "tokens_per_s_warm": batch * seq * len(warm)
          / sum(res.step_s[i] for i in warm),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "comm_bytes_total": res.comm_bytes_total})

    # ---- where a full-width step's time goes ---------------------------- #
    # the same run, 4 steps (3 local, then a sync), under torch.profiler;
    # step 0 is left out as the warm-up. The profiler slows the host, so
    # the idle share is also given against the unprofiled walls above.
    prof = profile_steps(lambda: train_loop(
        cfg, shape, oc, steps=4, n_workers=R, verbose=False, device="cuda"))
    require([p["step"] for p in prof] == ["train_step 0 local",
                                          "train_step 1 local",
                                          "train_step 2 local",
                                          "train_step 3 sync"]
            and all(p["launches"] for p in prof),
            f"the profiler saw steps {[p['step'] for p in prof]} and "
            f"launches {[p['launches'] for p in prof]}")
    for p in prof:
        p["device_idle_share_vs_unprofiled_wall"] = 1.0 - p[
            "device_busy_ms"] / statistics.median(
            sync_ms if p["step"].endswith("sync") else local_ms)
    emit({"phase": "profile", "nvidia_smi": smi, "steps": prof[1:]})

    u, e = upd[0], ef[0]
    emit({"kernels": [
        {"name": "adaalter_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/adaalter_update.cu",
         "replaces": "src/repro/kernels/adaalter_update.py:55",
         "launches": launches["adaalter_update"],
         "max_abs_err": max(x["max_abs_err"] for x in upd),
         "ms": u["ms"], "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "fused_ef", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sync_fused.cu",
         "replaces": "src/repro/kernels/sync_fused.py:81",
         "launches": launches["fused_ef"],
         "max_abs_err": max(x["max_abs_err"] for x in ef),
         "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

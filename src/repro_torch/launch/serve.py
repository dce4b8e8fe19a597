"""Batched serving driver: prefill a prompt batch, then greedy-decode tokens.

The JAX package's ``launch/serve.py`` on one device: the same prompts from
the synthetic stream, the same teacher-forced replay of the prompt through
``decode_step``, the same greedy decode, for every family the port builds
(dense and MoE attention with a KV cache, cross-attention to image
embeddings or an encoder's output, the SSM recurrence, the Big LSTM's
state). As in the reference, the prefill is given zero image embeddings /
audio frames, and decode starts from a zero cache, its cross-attention
(k, v) included. Runs on the CUDA device unless ``device='cpu'`` /
``--device cpu``.

Under ``torchrun`` (``WORLD_SIZE`` N > 1) the ranks form a ``{"data": D,
"model": N // D}`` grid (``--data``, default N: the reference's
``(device_count, 1)`` mesh, the batch split alone): each rank serves its
rows of the batch with its parts of the weights and of the cache
(``launch/serving.py``: tensor parallelism over ``model``, the cache's
sequence split over it), the generated tokens are gathered and rank 0
prints them. Sharded serving covers every family up to 20 B parameters
(the SSM state split by heads, the conv tail by channels, the MoE's
experts over ``model``).

  python -m repro_torch.launch.serve --arch qwen2-7b --batch 8 \\
      --prompt-len 512 --new-tokens 32
  python -m repro_torch.launch.serve --arch biglstm --batch 8 \\
      --prompt-len 512 --new-tokens 32
  python -m repro_torch.launch.serve --arch llama-3.2-vision-11b \\
      --batch 8 --prompt-len 512 --new-tokens 32
  python -m repro_torch.launch.serve --device cpu --arch qwen2-7b \\
      --reduced --batch 4 --prompt-len 32 --new-tokens 16
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \\
      --device cpu --dist-backend gloo --data 1 --arch qwen2-7b \\
      --reduced --batch 4 --prompt-len 32 --new-tokens 16
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \\
      --device cpu --dist-backend gloo --data 1 --arch mamba2-370m \\
      --reduced --batch 4 --prompt-len 32 --new-tokens 16
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, ShapeConfig, get_arch, reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch.serving import (build_serve_programs,
                                        decode_cache_specs, serve_batch_specs)
from repro_torch.launch.train import resolve_device
from repro_torch.tree import tree_map


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_session(cfg, *, batch: int = 4, prompt_len: int = 32,
                  new_tokens: int = 16, seed: int = 0,
                  device: Optional[str] = None, params=None,
                  verbose: bool = True, stats: Optional[dict] = None,
                  group=None, plan=None):
    """Returns (generated tokens (B, new_tokens), tokens/s), the rate over
    the decode loop (prompt replay included), by a host clock around work
    that ends in a device synchronisation.

    ``params`` replaces the seeded initialisation, e.g. with weights carried
    across from the JAX package by ``repro_torch.convert``. A ``stats`` dict
    is filled with ``prefill_s``, ``decode_s``, ``decode_steps``,
    ``logits_finite`` (every prefill and decode logit finite), and the
    logits of the prompt's last position from the prefill
    (``prefill_logits``) and from its replay through ``decode_step``
    (``replay_logits``), which should agree.

    With a ``group`` (a ``core.comm.RankGroup`` laid out as ``{"data":
    D, "model": M}``; ``device`` is this rank's) the rank serves its rows
    of the batch with its parts of the weights (``params``: its parts, as
    ``programs.param_parts`` cuts them) and of the cache; the logits in
    ``stats`` are its rows', ``stats["programs"]`` the programs, and the
    returned tokens every row's, gathered over the ranks. ``plan``: the
    serving plan (default ``launch.serving.serve_plan`` on the group's
    grid; above 20 B parameters each rank holds its tiles and gathers the
    weights as they run)."""
    dev = resolve_device(device)
    cache_len = prompt_len + new_tokens
    shape = ShapeConfig(name="decode_32k", seq_len=cache_len,
                        global_batch=batch, kind="decode")
    programs = build_serve_programs(cfg, shape, group=group, plan=plan)
    if params is None:
        params = programs.init_fn(torch.Generator(dev).manual_seed(seed))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                     n_workers=1, seed=seed)
    prompts = torch.from_numpy(ds.worker_batch(0, 0, batch)["tokens"]).to(dev)
    rows = programs.rows or slice(0, batch)
    prompts = prompts[rows]
    n_rows = prompts.shape[0]

    # ---- prefill: run the prompt (its caches are not used: see below)
    pre_shape = ShapeConfig(name="prefill", seq_len=prompt_len,
                            global_batch=batch, kind="prefill")
    pre_batch = {"tokens": prompts}
    for k, v in serve_batch_specs(cfg, pre_shape)["prefill"].items():
        if k != "tokens":
            pre_batch[k] = torch.zeros((n_rows,) + v.shape[1:],
                                       dtype=v.dtype, device=dev)
    _sync(dev)
    t_pre = time.perf_counter()
    prefill_logits, _ = programs.prefill(params, pre_batch)
    finite = (torch.isfinite(prefill_logits).all() if stats is not None
              else None)
    _sync(dev)
    prefill_s = time.perf_counter() - t_pre

    # decode continues from a zero cache replayed over the prompt — simple
    # and correct for every family (the SSM recurrence updates through
    # decode_step).
    # this rank's part of every leaf (the whole cache on one device)
    cache = programs.cache_parts(tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        decode_cache_specs(cfg, shape)))
    cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                           device=dev), cache)
    tok = prompts[:, :1]
    out = []
    steps = 0
    replay_logits = None
    t0 = time.perf_counter()
    for pos in range(cache_len - 1):
        nxt = prompts[:, pos + 1:pos + 2] if pos + 1 < prompt_len else None
        logits, cache = programs.decode_step(
            params, cache, tok,
            torch.full((n_rows,), pos, dtype=torch.int32, device=dev))
        steps += 1
        if finite is not None:
            finite = finite & torch.isfinite(logits).all()
            if pos == prompt_len - 1:
                replay_logits = logits
        if nxt is None:
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            out.append(nxt)
        tok = nxt
        if len(out) >= new_tokens:
            break
    gen = (torch.cat(out, dim=1) if out
           else torch.zeros((n_rows, 0), dtype=torch.int32, device=dev))
    _sync(dev)
    dt = time.perf_counter() - t0
    if group is not None:            # every rank's rows, in batch order
        gen = gather_rows(gen, group)
    gen = gen.cpu().numpy()
    tps = batch * gen.shape[1] / max(dt, 1e-9)
    if stats is not None:
        stats.update(prefill_s=prefill_s, decode_s=dt, decode_steps=steps,
                     logits_finite=bool(finite), prefill_logits=prefill_logits,
                     replay_logits=replay_logits, programs=programs)
    if verbose:
        print(f"generated {gen.shape} tokens in {dt:.2f}s "
              f"({tps:.1f} tok/s incl. prompt replay) on {dev}")
    return gen, tps


def gather_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of a batch split over ``data``, in batch order
    (one collective; the ``model`` ranks of a row hold the same)."""
    from repro_torch.core import comm
    (got,) = group.all_gather([rows], count=comm.side)
    firsts = [r for r in range(group.world)
              if group.layout.coords(r)[1] == 0]
    return torch.cat([got[r] for r in firsts], 0)


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        epilog="phi3.5-moe-42b-a6.6b holds 83.75 GB of bf16 weights, "
               "llama4-maverick-400b-a17b 807 GB and llama3-405b 812 GB: "
               "more than one 80 GB card. Above 20 B parameters serving "
               "takes the plan with gathered weights (each rank's tiles at "
               "rest, a layer group's parts gathered over data as it runs); "
               "on one card they run --reduced, under torchrun with "
               "--data D the ranks hold their tiles.")
    ap.add_argument("--arch", default="qwen2-7b",
                    help=f"one of {sorted(ARCHS)}")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; never a "
                         "silent CPU)")
    ap.add_argument("--data", type=int, default=0, metavar="D",
                    help="under torchrun: the ranks form a D x (world / D) "
                         "grid, the batch split over D and the weights over "
                         "world / D (default: D = world)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="under torchrun (default: nccl on cards, gloo on "
                         "the CPU)")
    ap.add_argument("--full-plan", action="store_true",
                    help="under torchrun with --reduced: serve under the "
                         "full-size architecture's plan (above 20 B "
                         "parameters: each rank's tiles, the weights "
                         "gathered over data as they run)")
    args = ap.parse_args()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    from repro_torch.launch import mesh
    group, device, plan = None, args.device, None
    world = mesh.world_size()
    if world > 1:
        from repro_torch.launch.serving import serve_plan
        data = args.data or world
        if world % data:
            ap.error(f"--data {data} does not divide {world} ranks")
        grid = {"data": data, "model": world // data}
        plan = serve_plan(get_arch(args.arch) if args.full_plan else cfg,
                          grid)
        group, dev = mesh.init_ranks(args.dist_backend, args.device,
                                     grid=grid, fsdp_axes=plan.fsdp_axes)
        device = str(dev)
    try:
        gen, tps = serve_session(cfg, batch=args.batch,
                                 prompt_len=args.prompt_len,
                                 new_tokens=args.new_tokens, seed=args.seed,
                                 device=device, group=group, plan=plan,
                                 verbose=group is None or group.rank == 0)
    finally:
        if group is not None:
            mesh.close_ranks()
    if group is None or group.rank == 0:
        print("sample generations (token ids):")
        for row in gen[:4]:
            print("  ", row.tolist())


if __name__ == "__main__":
    main()

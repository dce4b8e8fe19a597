"""Serving programs: batched prefill + single-token decode with a cache.

The JAX package's ``launch/serving.py`` on one device. Shape semantics:

  * ``prefill_32k``  runs ``prefill`` — full forward over S tokens,
    returning last-position logits + primed caches.
  * ``decode_32k`` / ``long_500k`` run ``decode_step`` — ONE new token
    against a pre-allocated cache of ``cache_len`` entries.

The cache is what the model's ``init_cache`` lays out: stacked ``"kv"``
ring buffers (g, B, cache_len, KV, hd) for attention layers, the SSM state
for mamba2, and the Big LSTM's list of (h_proj, c) pairs.

The JAX package's meshes, shardings and ``serve_plan`` /
``cache_shardings`` wait for more than one device (ROADMAP Queue 1 item 9c);
the programs here run eagerly under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.tree import tree_map

DEFAULT_LONG_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated (the counterpart of
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def cache_geometry(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[int, int, int]:
    """-> (cache_len, window, cross_len) for a decode shape."""
    window = 0
    cache_len = shape.seq_len
    if shape.seq_len > 65536:
        # long-context decode: bounded state required. SSM archs are O(1)
        # natively; others fall back to their sliding-window variant.
        if cfg.family not in ("ssm",):
            window = cfg.sliding_window or DEFAULT_LONG_WINDOW
            cache_len = window
    elif cfg.sliding_window and cfg.long_context_mode != "sliding_window":
        # architectural SWA (e.g. hymba): windowed at every context length
        window = cfg.sliding_window
        cache_len = min(cache_len, window)
    if cfg.family == "ssm":
        cache_len = 0                     # no attention cache at all
    cross_len = 0
    if cfg.cross_attn_every:
        cross_len = cfg.n_image_tokens
    if cfg.is_encdec:
        cross_len = min(shape.seq_len, 32768)   # encoder output length
    return cache_len, window, cross_len


@dataclasses.dataclass
class ServePrograms:
    init_fn: Any                  # (gen: torch.Generator) -> params
    prefill: Any                  # (params, batch) -> (logits, caches)
    decode_step: Any              # (params, caches, token, pos) -> (logits, caches)
    cache_len: int
    window: int
    cross_len: int


def build_serve_programs(cfg: ModelConfig, shape: ShapeConfig) -> ServePrograms:
    """The model's programs for ``shape``; they run on the device of the
    tensors they are given (``init_fn`` on its generator's)."""
    model = build_model(cfg)
    cache_len, window, cross_len = cache_geometry(cfg, shape)

    @torch.inference_mode()
    def init_fn(gen):
        return model.init(gen)

    @torch.inference_mode()
    def prefill_fn(params, batch):
        return model.prefill(params, batch, window=window)

    @torch.inference_mode()
    def decode_fn(params, caches, token, pos):
        return model.decode_step(params, caches, token, pos, window=window)

    return ServePrograms(init_fn=init_fn, prefill=prefill_fn,
                         decode_step=decode_fn,
                         cache_len=cache_len, window=window,
                         cross_len=cross_len)


def serve_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """TensorSpecs of the prefill batch and the decode-step inputs."""
    B, S = shape.global_batch, shape.seq_len
    dtype = getattr(torch, cfg.param_dtype)
    prefill_batch = {"tokens": TensorSpec((B, S), torch.int32)}
    if cfg.cross_attn_every:
        prefill_batch["image_embeds"] = TensorSpec(
            (B, cfg.n_image_tokens, cfg.d_model), dtype)
    if cfg.is_encdec:
        prefill_batch["audio_frames"] = TensorSpec(
            (B, min(S, 32768), cfg.d_model), dtype)
    return {
        "prefill": prefill_batch,
        "token": TensorSpec((B, 1), torch.int32),
        "pos": TensorSpec((B,), torch.int32),
    }


def decode_cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """TensorSpecs of the decode cache (nothing allocated)."""
    model = build_model(cfg)
    cache_len, window, cross_len = cache_geometry(cfg, shape)
    meta = model.init_cache(shape.global_batch, max(cache_len, 1),
                            windowed=bool(window), cross_len=cross_len,
                            device="meta")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), meta)

"""Decoder stack: homogeneous groups of sub-layers over a stacked group axis.

The JAX package's ``models/transformer.py``: a repeating *group* of
``period`` sub-layers whose parameters are stacked over ``n_groups`` (a
leading axis on every leaf, so weights cross between the packages 1:1).
Where the JAX package scans the groups with ``lax.scan``, the port loops
over them in Python. The port builds the ``"ssm"`` sub-layer (mamba2) and
the ``"self_dense"`` one (GQA self-attention and an MLP: the dense family);
the MoE, cross-attention and hybrid kinds come with the rest of the
transformer families (ROADMAP Queue 1 item 10) and raise until then.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.counting import layer_kinds
from repro_torch.models.layers import init_mlp, mlp_apply, rms_norm
from repro_torch.tree import tree_map


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"layer kind {kind!r} is not ported to PyTorch yet (ROADMAP Queue 1 "
        "item 10: MoE, cross-attention, hybrid)")


def group_period(cfg) -> int:
    if cfg.family == "ssm" or cfg.hybrid:
        return 1
    if cfg.cross_attn_every:
        return cfg.cross_attn_every
    if cfg.is_moe and cfg.moe_every > 1:
        return cfg.moe_every
    return 1


def group_kinds(cfg) -> List[str]:
    kinds = layer_kinds(cfg)
    p = group_period(cfg)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into groups of {p}")
    group = kinds[:p]
    for g in range(cfg.n_layers // p):
        if kinds[g * p:(g + 1) * p] != group:
            raise ValueError(f"{cfg.name}: the layer pattern must repeat")
    return group


def stack_trees(trees):
    """Trees of one structure -> one tree whose leaves are stacked on a new
    leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _init_block(gen, cfg, kind: str, dtype, device):
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, device)
        return p
    if kind != "self_dense":
        raise _not_ported(kind)
    p["ln2"] = torch.ones((d,), dtype=dtype, device=device)
    p["attn"] = attn.init_attention(gen, cfg, dtype, device)
    d_ff = cfg.dense_d_ff if (cfg.is_moe and cfg.moe_every > 1) else cfg.d_ff
    p["mlp"] = init_mlp(gen, d, d_ff, cfg.act, dtype, device)
    return p


def init_stack(gen, cfg, dtype, device="cpu") -> List[Dict[str, Any]]:
    """Stacked params: one subtree per position-in-group, leading axis
    n_groups."""
    kinds = group_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    groups = [[_init_block(gen, cfg, kind, dtype, device) for kind in kinds]
              for _ in range(n_groups)]
    return stack_trees(groups)


def _apply_block(bp, cfg, kind, x, positions, ctx, *, window: int,
                 collect_cache: bool):
    """Returns (x, cache_entry)."""
    cache: Dict[str, Any] = {}
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        if collect_cache:
            out, cache["ssm"] = ssm_mod.ssm_forward(bp["ssm"], h, cfg,
                                                    return_state=True)
        else:
            out = ssm_mod.ssm_forward(bp["ssm"], h, cfg)
        return x + out, cache
    if kind != "self_dense":
        raise _not_ported(kind)
    out, kv = attn.self_attention(bp["attn"], h, positions, cfg,
                                  window=window,
                                  causal=ctx.get("causal", True))
    if collect_cache:
        cache["kv"] = kv
    x = x + out
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + mlp_apply(bp["mlp"], h, cfg.act), cache


def apply_stack(params, cfg, x, positions, ctx=None, *, window: int = 0,
                collect_cache: bool = False):
    """Run the stacked groups in order (inference: no rematerialisation).
    Returns (x, aux_loss, caches|None); the caches are stacked like the
    parameters."""
    kinds = group_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    ctx = ctx or {}
    caches = []
    for g in range(n_groups):
        gp = tree_map(lambda t: t[g], params)
        group_caches = []
        for i, kind in enumerate(kinds):
            x, cache = _apply_block(gp[i], cfg, kind, x, positions, ctx,
                                    window=window,
                                    collect_cache=collect_cache)
            group_caches.append(cache)
        caches.append(group_caches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, (stack_trees(caches) if collect_cache else None)


def _decode_block(bp, cfg, kind, x, pos, cache, spec):
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        out, st = ssm_mod.ssm_decode_step(bp["ssm"], h, cache["ssm"], cfg)
        return x + out, {"ssm": st}
    if kind != "self_dense":
        raise _not_ported(kind)
    ck, cv = cache["kv"]
    out, nk, nv = attn.decode_self_attention(bp["attn"], h, ck, cv, pos, cfg,
                                             spec)
    x = x + out
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + mlp_apply(bp["mlp"], h, cfg.act), {"kv": (nk, nv)}


def decode_stack(params, cfg, x, pos, caches, *, spec: attn.KVCacheSpec):
    """x: (B,1,D); pos: (B,); caches: stacked (n_groups leading). Returns
    (x, caches)."""
    kinds = group_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    new_caches = []
    for g in range(n_groups):
        gp = tree_map(lambda t: t[g], params)
        gc = tree_map(lambda t: t[g], caches)
        group_caches = []
        for i, kind in enumerate(kinds):
            x, nc = _decode_block(gp[i], cfg, kind, x, pos, gc[i], spec)
            group_caches.append(nc)
        new_caches.append(group_caches)
    return x, stack_trees(new_caches)

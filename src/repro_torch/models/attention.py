"""Grouped-query attention: RoPE, QKV bias, sliding window, KV cache.

The JAX package's ``models/attention.py`` for self-attention. Full-sequence
attention is computed blockwise (an online softmax over KV blocks, in
order) once the keys outnumber two blocks, so that long prefill never holds
the (S, S) scores; shorter sequences and decode (Sq == 1) take the direct
path. The numerics follow the reference: an additive float32 mask of
-1e30, float32 scores of q and k cast to float32, the direct path scaling
the scores after the product and the blockwise path scaling q before it,
by the scale rounded to q's dtype. With ``cfg.attn_remat`` a training
forward keeps no attention intermediate: the backward recomputes it. No
library attention: it would differ
at the masked edges and in precision. Cross-attention (the VLM's image
layers, the audio decoder's attention to the encoder) is non-causal, at
position 0 on both sides, without RoPE. The tensor-parallel head padding
waits for tensor parallelism (ROADMAP Queue 1 item 9c).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
import torch.utils.checkpoint

from repro_torch.models.layers import apply_rope, init_dense

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype=torch.float32,
                   device="cpu"):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": init_dense(gen, d, h * hd, dtype=dtype, device=device),
         "wk": init_dense(gen, d, kv * hd, dtype=dtype, device=device),
         "wv": init_dense(gen, d, kv * hd, dtype=dtype, device=device),
         "wo": init_dense(gen, h * hd, d, dtype=dtype, device=device)}
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _project_qkv(params, xq, xkv, cfg):
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    q = xq @ params["wq"]
    k = xkv @ params["wk"]
    v = xkv @ params["wv"]
    if cfg.qkv_bias:                     # the bias in the product's dtype
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return (q.reshape(b, sq, cfg.n_heads, cfg.head_dim),
            k.reshape(b, skv, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, skv, cfg.n_kv_heads, cfg.head_dim))


def _mask(pos_q, pos_kv, causal: bool, window: int, valid_kv=None):
    """(B, Sq, Skv) additive mask in float32: 0 where attended, -1e30
    elsewhere."""
    pq = pos_q[..., :, None]
    pk = pos_kv[..., None, :]
    m = torch.zeros(torch.broadcast_shapes(pq.shape, pk.shape),
                    dtype=torch.float32, device=pos_q.device)
    if causal:
        m = torch.where(pk > pq, NEG_INF, m)
    if window:
        m = torch.where(pq - pk >= window, NEG_INF, m)
    if valid_kv is not None:
        m = torch.where(valid_kv[..., None, :], m, NEG_INF)
    return m


def direct_attention(q, k, v, pos_q, pos_kv, *, causal: bool, window: int = 0,
                     valid_kv=None):
    """Unblocked attention. q: (B,Sq,H,hd); k, v: (B,Skv,KV,hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd).float()
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k.float()) * hd ** -0.5
    scores = scores + _mask(pos_q, pos_kv, causal, window,
                            valid_kv)[:, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskh->bqkrh", w, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def blockwise_attention(q, k, v, pos_q, pos_kv, *, causal: bool,
                        window: int = 0, kv_block: int = 1024,
                        bf16_probs: bool = False):
    """Online-softmax attention over KV blocks of ``kv_block``, first to
    last; the direct path when the keys fit in two blocks. The last block
    is padded with zero keys at position 2³⁰, which causality masks; as in
    the reference, non-causal attention does not mask them, so they enter
    its softmax."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if skv <= 2 * kv_block:
        return direct_attention(q, k, v, pos_q, pos_kv, causal=causal,
                                window=window)
    rep = h // kvh
    pad = (-skv) % kv_block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos_kv = torch.nn.functional.pad(pos_kv, (0, pad), value=2 ** 30)
    n_blocks = k.shape[1] // kv_block

    # q scaled before the cast, by the scale rounded to q's dtype (JAX's
    # weak-typed scalar); the compiled reference keeps that product in
    # float32 (XLA's excess precision), so it is not rounded to q's dtype
    scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))
    qg = q.reshape(b, sq, kvh, rep, hd).float() * scale
    m = torch.full((b, kvh, rep, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, rep, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, rep, sq, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(n_blocks):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        k_c, v_c = k[:, blk], v[:, blk]
        s = torch.einsum("bqkrh,bskh->bkrqs", qg, k_c.float())
        s = s + _mask(pos_q, pos_kv[:, blk], causal, window)[:, None, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        if bf16_probs:
            # the probabilities rounded to the value dtype, their product
            # with v accumulated in float32
            p = p.to(v_c.dtype).float()
        pv = torch.einsum("bkrqs,bskh->bkrqh", p, v_c.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # (b,kv,rep,sq,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def self_attention(params, x, positions, cfg, *, window: int = 0,
                   causal: bool = True, kv_block: int = 1024):
    """Full-sequence self-attention; returns (out, (k, v)) for the cache."""
    q, k, v = _project_qkv(params, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attend = partial(blockwise_attention, causal=causal, window=window,
                     kv_block=kv_block, bf16_probs=cfg.attn_bf16_probs)
    if cfg.attn_remat and torch.is_grad_enabled():
        # the backward recomputes the per-block scores instead of keeping
        # every block's probabilities, as the reference's jax.checkpoint
        out = torch.utils.checkpoint.checkpoint(
            attend, q, k, v, positions, positions, use_reentrant=False)
    else:
        out = attend(q, k, v, positions, positions)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ params["wo"]
    return out, (k, v)


def cross_attention_cached(params, x, k, v, cfg):
    """Cross-attention to cached (k, v) (B, Skv, KV, hd). x: (B, Sq, D)."""
    b, sq, _ = x.shape
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
    q = q.reshape(b, sq, cfg.n_heads, cfg.head_dim)
    zeros = torch.zeros((b, 1), dtype=torch.int32, device=x.device)
    out = direct_attention(q, k, v, zeros.expand(b, sq),
                           zeros.expand(b, k.shape[1]), causal=False)
    return out.reshape(b, sq, -1) @ params["wo"]


def cross_attention_full(params, x, kv_src, cfg):
    """Cross-attention of x (B, Sq, D) to kv_src (B, Skv, D); returns (out,
    (k, v)) for the cache."""
    b, sq, _ = x.shape
    q, k, v = _project_qkv(params, x, kv_src, cfg)
    zeros = torch.zeros((b, 1), dtype=torch.int32, device=x.device)
    out = blockwise_attention(q, k, v, zeros.expand(b, sq),
                              zeros.expand(b, k.shape[1]), causal=False)
    return out.reshape(b, sq, -1) @ params["wo"], (k, v)


@dataclasses.dataclass
class KVCacheSpec:
    """Self-attention cache layout: a ring buffer of ``cache_len`` slots.

    For full attention cache_len is the longest sequence; for a sliding
    window it is the window, and the slots are reused in turn."""
    cache_len: int
    windowed: bool


def decode_self_attention(params, x, cache_k, cache_v, pos, cfg,
                          spec: KVCacheSpec):
    """One-token decode. x: (B,1,D); cache_k, cache_v: (B,cache_len,KV,hd);
    pos: (B,). Returns (out, new_k, new_v); the caches passed in are not
    written."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, x, x, cfg)
    positions = pos[:, None]                                    # (B,1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    # the reference blends a one-hot row in; for finite values that is
    # this write of the slot
    slot = (pos % spec.cache_len) if spec.windowed else pos
    rows = torch.arange(b, device=x.device)
    cache_k = cache_k.index_put((rows, slot.long()), k[:, 0])
    cache_v = cache_v.index_put((rows, slot.long()), v[:, 0])

    idx = torch.arange(spec.cache_len, device=x.device)[None, :]
    if spec.windowed:
        # the absolute position each slot holds, from the ring layout
        base = (positions // spec.cache_len) * spec.cache_len
        pos_kv = torch.where(idx <= positions % spec.cache_len, base + idx,
                             base - spec.cache_len + idx)
        valid = pos_kv >= 0
    else:
        pos_kv = idx.expand(b, -1)
        valid = idx <= positions
    out = direct_attention(q, cache_k, cache_v, positions, pos_kv,
                           causal=True, window=0, valid_kv=valid)
    out = out.reshape(b, 1, -1) @ params["wo"]
    return out, cache_k, cache_v

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
position 0 on both sides, without RoPE.

Under tensor parallelism (``tp``, a ``sharding.partition.TensorParallel``)
the projections take the parts their specs give a rank: ``wq``/``wk``/
``wv`` and their biases column-split (by heads where the split falls on
head boundaries), ``wo`` row-split and its partial products summed over
``model``. A rank attends with its own heads; where the parts do not hold
whole heads the projections are gathered and every rank attends with all,
or, under ``cfg.attn_tp_pad`` (the reference's ``_tp_pad_heads``), q is
padded to a multiple of the TP size and k/v repeated to that MHA layout,
each rank attending with its share of the padded heads. Decode reads a
KV cache split along its sequence over ``model`` (the reference's
``cache_shardings``): each rank holds ``cache_len / M`` slots of every kv
head, the owner of the new token's slot writes it, each rank scores its
own slots, and the online-softmax partials are combined over ``model`` in
rank order.
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


def _tp_project_qkv(params, x, cfg, tp, src=None):
    """q, k, v (B, S, heads, hd) under tensor parallelism: each
    projection as its spec splits it (``models.layers.tp_linear``, one
    ``tp_copy`` of each input for all its products); q from ``x``, k and
    v from ``src`` (cross-attention's source; default ``x``). Returns
    ``(q, k, v, by_heads)``: with ``by_heads`` this rank's heads, a
    contiguous share of the q and kv heads (the three split and the head
    counts divisible by the TP size); else every head, the parts
    gathered."""
    from repro_torch.core.comm import tp_copy, tp_gather
    from repro_torch.models.layers import tp_linear
    d, hd = x.shape[-1], cfg.head_dim
    widths = {"q": cfg.n_heads * hd, "k": cfg.n_kv_heads * hd,
              "v": cfg.n_kv_heads * hd}
    splits = {n: tp.split("w" + n, (d, w)) for n, w in widths.items()}
    inputs = {"q": x, "k": x if src is None else src}
    inputs["v"] = inputs["k"]
    copies = {}
    for n, sp in splits.items():
        if sp.split and id(inputs[n]) not in copies:
            copies[id(inputs[n])] = tp_copy(inputs[n], tp.group)
    out = {}
    for n, sp in splits.items():
        y, part = tp_linear(inputs[n], params["w" + n], sp, tp,
                            xc=copies.get(id(inputs[n])))
        if cfg.qkv_bias:             # split with its weight's columns
            y = y + params["b" + n].to(y.dtype)
        out[n] = (y, part)
    by_heads = (all(part for _, part in out.values())
                and cfg.n_heads % tp.size == 0
                and cfg.n_kv_heads % tp.size == 0)
    b = x.shape[0]
    q, k, v = ((y if by_heads or not part else tp_gather(y, tp.group))
               .reshape(b, y.shape[1], -1, hd) for y, part in out.values())
    return q, k, v, by_heads


def _tp_pad_heads(q, k, v, cfg, tp):
    """The reference's ``_tp_pad_heads`` (``cfg.attn_tp_pad``, heads that
    do not divide the TP size): q padded with zero heads to the next
    multiple of the TP size, k/v repeated to that MHA layout; returns this
    rank's contiguous share of the padded heads (``tp_copy``'d: they enter
    rank-specific work) and the padded count."""
    from repro_torch.core.comm import tp_copy
    h, kvh, m = cfg.n_heads, cfg.n_kv_heads, tp.size
    h_pad = -(-h // m) * m
    k = torch.repeat_interleave(k, h // kvh, dim=2)
    v = torch.repeat_interleave(v, h // kvh, dim=2)
    pad = (0, 0, 0, h_pad - h)
    q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    n = h_pad // m
    return tuple(tp_copy(t, tp.group).narrow(2, tp.rank * n, n)
                 for t in (q, k, v)), h_pad


def self_attention(params, x, positions, cfg, *, window: int = 0,
                   causal: bool = True, kv_block: int = 1024, tp=None,
                   cache: bool = False, cache_len: int = 0):
    """Full-sequence self-attention; returns (out, (k, v)) for the cache.
    Under ``tp`` the output is the same on every rank (this rank's slice
    of its sequence under ``tp.seq``), and with ``cache`` (k, v) are this
    rank's part of the sequence-split cache
    (:func:`tp_cache_part`; ``cache_len``: the decode cache's length,
    whose split the part follows)."""
    by_heads = False
    if tp is None:
        q, k, v = _project_qkv(params, x, x, cfg)
    else:
        q, k, v, by_heads = _tp_project_qkv(params, x, cfg, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attend = partial(blockwise_attention, causal=causal, window=window,
                     kv_block=kv_block, bf16_probs=cfg.attn_bf16_probs)
    qa, ka, va = q, k, v
    padded = (tp is not None and not by_heads and cfg.attn_tp_pad
              and tp.size > 1)
    if padded:
        (qa, ka, va), h_pad = _tp_pad_heads(q, k, v, cfg, tp)
    if cfg.attn_remat and torch.is_grad_enabled():
        # the backward recomputes the per-block scores instead of keeping
        # every block's probabilities, as the reference's jax.checkpoint
        out = torch.utils.checkpoint.checkpoint(
            attend, qa, ka, va, positions, positions, use_reentrant=False)
    else:
        out = attend(qa, ka, va, positions, positions)
    if padded:                        # every rank's heads, then the real h
        from repro_torch.core.comm import tp_gather
        out = tp_gather(out, tp.group, 2)[:, :, :cfg.n_heads]
    out = out.reshape(x.shape[0], x.shape[1], -1)
    if tp is None:
        return out @ params["wo"], (k, v)
    from repro_torch.models.layers import tp_linear
    out, _ = tp_linear(out, params["wo"], tp.split(
        "wo", (cfg.n_heads * cfg.head_dim, x.shape[-1])), tp,
        x_part=by_heads, final=True)
    return out, (tp_cache_part((k, v), tp, by_heads, cache_len) if cache
                 else (k, v))


def tp_cache_part(kv, tp, by_heads: bool, cache_len: int = 0):
    """A prefill's (k, v) (B, S, heads, hd) as the cache's split gives a
    rank its part: every kv head (this rank's heads gathered over
    ``model``, where it attended by heads), and its contiguous share of
    the sequence where the TP size divides the decode cache's length
    ``cache_len`` (default S), as the reference's ``cache_shardings`` of
    the decode cache lay out its prefill's output, and S; else the whole
    sequence."""
    from repro_torch.core.comm import tp_gather
    out = []
    for t in kv:
        if by_heads:
            t = tp_gather(t, tp.group, 2)
        whole = tuple(t.shape[:1]) + (cache_len or t.shape[1],) + tuple(
            t.shape[2:])
        out.append(tp.cache_split(t.shape, 1).take(t)
                   if tp.cache_split(whole, 1).split else t)
    return tuple(out)


def tp_cross_attention_cached(params, x, k, v, cfg, spec, tp):
    """:func:`cross_attention_cached` under tensor parallelism: ``k``,
    ``v`` are this rank's part of the cross cache, split along its
    sequence over ``model`` where ``spec.cross_len`` (the whole length)
    divides by the TP size, else whole. q takes every head (its columns
    gathered where ``wq`` splits); over a split cache each rank scores its
    keys and the softmax partials combine in rank order
    (:func:`_combined_attention`); ``wo`` as its spec splits it."""
    from repro_torch.core.comm import tp_gather
    from repro_torch.models.layers import tp_linear
    b, sq, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, part = tp_linear(x, params["wq"], tp.split("wq", (d, h * hd)), tp)
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
    if part:
        q = tp_gather(q, tp.group)
    q = q.reshape(b, sq, h, hd)
    zq = torch.zeros((b, sq), dtype=torch.int32, device=x.device)
    zk = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    if tp.cache_split((b, spec.cross_len, k.shape[2], hd), 1).split:
        out = _combined_attention(q, k, v, zq, zk, None, tp, causal=False)
    else:
        out = direct_attention(q, k, v, zq, zk, causal=False)
    out, _ = tp_linear(out.reshape(b, sq, -1), params["wo"],
                       tp.split("wo", (h * hd, d)), tp)
    return out


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


def cross_attention_full(params, x, kv_src, cfg, *, tp=None,
                         cache: bool = False, cache_len: int = 0):
    """Cross-attention of x (B, Sq, D) to kv_src (B, Skv, D); returns (out,
    (k, v)) for the cache. Under ``tp`` the projections split as their
    specs say (by heads, or gathered), the output is the same on every
    rank (its slice under ``tp.seq``), and with ``cache`` (k, v) are this
    rank's part of the cross
    cache (:func:`tp_cache_part`; ``cache_len``: the decode's cross
    length)."""
    b, sq, _ = x.shape
    by_heads = False
    if tp is None:
        q, k, v = _project_qkv(params, x, kv_src, cfg)
    else:
        q, k, v, by_heads = _tp_project_qkv(params, x, cfg, tp, src=kv_src)
    zeros = torch.zeros((b, 1), dtype=torch.int32, device=x.device)
    out = blockwise_attention(q, k, v, zeros.expand(b, sq),
                              zeros.expand(b, k.shape[1]), causal=False)
    out = out.reshape(b, sq, -1)
    if tp is None:
        return out @ params["wo"], (k, v)
    from repro_torch.models.layers import tp_linear
    out, _ = tp_linear(out, params["wo"], tp.split(
        "wo", (cfg.n_heads * cfg.head_dim, x.shape[-1])), tp,
        x_part=by_heads, final=True)
    return out, (tp_cache_part((k, v), tp, by_heads, cache_len) if cache
                 else (k, v))


@dataclasses.dataclass
class KVCacheSpec:
    """Self-attention cache layout: a ring buffer of ``cache_len`` slots.

    For full attention cache_len is the longest sequence; for a sliding
    window it is the window, and the slots are reused in turn."""
    cache_len: int
    windowed: bool
    #: the cross-attention cache's whole length (tensor parallelism: a
    #: rank holds its part)
    cross_len: int = 0


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


def _slot_positions(idx, positions, spec: KVCacheSpec):
    """The absolute position each slot ``idx`` (1, n) holds at query
    position ``positions`` (B, 1), and which hold one (the ring layout
    when windowed)."""
    if spec.windowed:
        base = (positions // spec.cache_len) * spec.cache_len
        pos_kv = torch.where(idx <= positions % spec.cache_len, base + idx,
                             base - spec.cache_len + idx)
        return pos_kv, pos_kv >= 0
    return idx.expand(positions.shape[0], -1), idx <= positions


def tp_decode_self_attention(params, x, cache_k, cache_v, pos, cfg,
                             spec: KVCacheSpec, tp):
    """:func:`decode_self_attention` under tensor parallelism. ``spec``
    holds the whole cache length; ``cache_k``/``cache_v`` are this rank's
    part (``tp.cache_split``): ``cache_len / M`` slots of every kv head, or
    the whole cache where M does not divide it. The new token's q, k, v
    are whole on every rank (the parts gathered over ``model``, one
    collective); the rank owning the token's slot writes it; each rank
    scores its own slots, and the partial softmax statistics (max, sum of
    exponentials, weighted values; float32) are combined over ``model``
    in rank order, one collective. ``wo`` as its spec splits it."""
    from repro_torch.core import comm
    from repro_torch.models.layers import tp_linear
    b, d = x.shape[0], x.shape[-1]
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    split = tp.cache_split((b, spec.cache_len, kvh, hd), 1)
    q, k, v, by_heads = _tp_project_qkv(params, x, cfg, tp)
    if by_heads:                     # every head, one collective
        (got,) = tp.group.all_gather([torch.cat(
            [t.reshape(b, 1, -1) for t in (q, k, v)], -1)], count=comm.tp)
        nq, nk = q.shape[2] * hd, k.shape[2] * hd
        parts = [torch.split(r, (nq, nk, nk), -1) for r in got.unbind(0)]
        q, k, v = (torch.cat([p[i] for p in parts], -1).reshape(b, 1, -1, hd)
                   for i in range(3))
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if not split.split:              # the whole cache on every rank
        slot = (pos % spec.cache_len) if spec.windowed else pos
        rows = torch.arange(b, device=x.device)
        cache_k = cache_k.index_put((rows, slot.long()), k[:, 0])
        cache_v = cache_v.index_put((rows, slot.long()), v[:, 0])
        idx = torch.arange(spec.cache_len, device=x.device)[None, :]
        pos_kv, valid = _slot_positions(idx, positions, spec)
        out = direct_attention(q, cache_k, cache_v, positions, pos_kv,
                               causal=True, window=0, valid_kv=valid)
    else:
        n = cache_k.shape[1]
        lo = split.index * n
        slot = ((pos % spec.cache_len) if spec.windowed else pos).long()
        mine = (slot >= lo) & (slot < lo + n)
        rows = torch.arange(b, device=x.device)
        local = torch.clamp(slot - lo, 0, n - 1)
        keep = mine[:, None, None]
        cache_k = cache_k.index_put((rows, local), torch.where(
            keep, k[:, 0], cache_k[rows, local]))
        cache_v = cache_v.index_put((rows, local), torch.where(
            keep, v[:, 0], cache_v[rows, local]))
        idx = torch.arange(lo, lo + n, device=x.device)[None, :]
        pos_kv, valid = _slot_positions(idx, positions, spec)
        out = _combined_attention(q, cache_k, cache_v, positions, pos_kv,
                                  valid, tp)
    out, _ = tp_linear(out.reshape(b, 1, -1), params["wo"],
                       tp.split("wo", (h * hd, d)), tp)
    return out, cache_k, cache_v


def _combined_attention(q, k, v, pos_q, pos_kv, valid, tp, *,
                        causal: bool = True):
    """Attention of q (B, Sq, H, hd) over every rank's slots, from this
    rank's k, v (B, n, KV, hd): the scores as :func:`direct_attention`
    takes them (float32, scaled after the product, the additive mask), the
    rank's max m, sum of exponentials l and weighted values acc, combined
    over ``tp``'s ranks in rank order: M = max m_r, l = Σ l_r e^(m_r − M),
    out = Σ acc_r e^(m_r − M) / l."""
    from repro_torch.core import comm
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd).float()
    s = torch.einsum("bqkrh,bskh->bkrqs", qg, k.float()) * hd ** -0.5
    s = s + _mask(pos_q, pos_kv, causal, 0, valid)[:, None, None]
    m = torch.amax(s, dim=-1)                             # (b,kv,rep,q)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bkrqs,bskh->bkrqh", p, v.float())
    ms, ls, accs = tp.group.all_gather([m, l, acc], count=comm.tp)
    top = torch.amax(ms, dim=0)
    tot_l = tot_acc = None
    for r in range(tp.size):                              # rank order
        c = torch.exp(ms[r] - top)
        lr, ar = ls[r] * c, accs[r] * c[..., None]
        tot_l = lr if tot_l is None else tot_l + lr
        tot_acc = ar if tot_acc is None else tot_acc + ar
    out = tot_acc / tot_l[..., None]                      # (b,kv,rep,q,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)

"""Decoder stack: homogeneous groups of sub-layers over a stacked group axis.

The JAX package's ``models/transformer.py``: a repeating *group* of
``period`` sub-layers whose parameters are stacked over ``n_groups`` (a
leading axis on every leaf, so weights cross between the packages 1:1).
Where the JAX package scans the groups with ``lax.scan``, the port loops
over them in Python. Sub-layer kinds: ``"ssm"`` (mamba2), ``"self_dense"``
(GQA self-attention and an MLP), ``"self_moe"`` (self-attention and an MoE
FFN), ``"cross"`` (tanh-gated cross-attention to image embeddings, then
an MLP) and ``"hybrid"`` (hymba: windowed self-attention and the SSM mixer
on the same input, each RMS-normed and mean-fused, then an MLP); an
encoder-decoder's decoder blocks also attend to the encoder's output
(``xattn``, ``ln3``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.counting import layer_kinds
from repro_torch.models.layers import init_mlp, mlp_apply, rms_norm
from repro_torch.tree import tree_map


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


def _init_block(gen, cfg, kind: str, dtype, device, *,
                encdec_dec: bool = False):
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, device)
        return p
    if kind not in ("self_dense", "self_moe", "cross", "hybrid"):
        raise ValueError(f"unknown layer kind {kind!r}")
    p["ln2"] = torch.ones((d,), dtype=dtype, device=device)
    p["attn"] = attn.init_attention(gen, cfg, dtype, device)
    if kind == "hybrid":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, device)
        p["norm_attn"] = torch.ones((d,), dtype=dtype, device=device)
        p["norm_ssm"] = torch.ones((d,), dtype=dtype, device=device)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device)
    elif kind == "self_moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
    else:
        if kind == "cross":
            # tanh(0) = 0: at init the image layers add nothing
            p["gate"] = torch.zeros((1,), dtype=dtype, device=device)
        p["mlp"] = init_mlp(gen, d, _mlp_width(cfg, kind), cfg.act, dtype,
                            device)
    if encdec_dec:
        p["xattn"] = attn.init_attention(gen, cfg, dtype, device)
        p["ln3"] = torch.ones((d,), dtype=dtype, device=device)
    return p


def init_stack(gen, cfg, dtype, device="cpu", *,
               encdec_dec: bool = False) -> List[Dict[str, Any]]:
    """Stacked params: one subtree per position-in-group, leading axis
    n_groups. Each group is drawn and copied into its slot before the next
    is drawn, so the device holds one group beside the stack, not two
    copies of the weights."""
    kinds = group_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    stacked = None
    for g in range(n_groups):
        group = [_init_block(gen, cfg, kind, dtype, device,
                             encdec_dec=encdec_dec) for kind in kinds]
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n_groups,) + t.shape),
                               group)
        tree_map(lambda dst, src: dst[g].copy_(src), stacked, group)
    return stacked


class _Stream:
    """A block's residual stream ``x`` as one sub-layer reads it. Under
    sequence parallelism (``gather``: the ``model`` ranks' slices of the
    sequence put together) :attr:`whole` is the gathered stream, which the
    norm reads, and :meth:`add` adds the sub-layer's output (this rank's
    slice) to this rank's slice of it, cut only then: the stream's
    gradient then takes the residual's term before the norm's two, as the
    unsplit stream's does, and the two runs give the same bits."""

    def __init__(self, x, gather=None, rank: int = 0) -> None:
        self.x, self.rank = x, rank
        self.whole = x if gather is None else gather(x)

    def add(self, out):
        if self.whole is self.x:
            return self.x + out
        n = self.x.shape[1]
        return self.whole.narrow(1, self.rank * n, n) + out


def _ffn(bp, cfg, kind, x, batch_group=None, tp=None, gather=None):
    """The block's second half: x + FFN(ln2(x)). Returns (x, aux_loss).
    ``batch_group``: the ranks whose rows make one batch with ``x``'s (the
    MoE routes them as one, ``moe.moe_apply``); ``tp``: tensor
    parallelism (the MoE's experts over ``model``, the dense MLP's
    ``layers.mlp_apply``); ``gather``: sequence parallelism's
    (:class:`_Stream`)."""
    st = _Stream(x, gather, tp.rank if gather is not None else 0)
    h = rms_norm(st.whole, bp["ln2"], cfg.norm_eps)
    if kind == "self_moe":
        out, aux = moe_mod.moe_apply(bp["moe"], h, cfg, batch_group, tp)
        return st.add(out), aux
    out = mlp_apply(bp["mlp"], h, cfg.act, tp, _mlp_width(cfg, kind))
    return st.add(out), None


def _mlp_width(cfg, kind: str) -> int:
    """The dense MLP's hidden width in a block of ``kind`` (as
    :func:`_init_block` draws it)."""
    if kind == "cross":
        return cfg.dense_d_ff or cfg.d_ff
    if cfg.is_moe and cfg.moe_every > 1:
        return cfg.dense_d_ff
    return cfg.d_ff


def _mean_fusion(bp, cfg, a_out, s_out):
    """The hybrid layer's update: the mean of its RMS-normed attention and
    SSM outputs."""
    return 0.5 * (rms_norm(a_out, bp["norm_attn"], cfg.norm_eps)
                  + rms_norm(s_out, bp["norm_ssm"], cfg.norm_eps))


def _apply_block(bp, cfg, kind, x, positions, ctx, *, window: int,
                 collect_cache: bool, encdec_dec: bool = False):
    """Returns (x, aux_loss or None, cache_entry). Under sequence
    parallelism (ctx ``"seq_parallel"``) ``x`` and the result are this
    rank's slices of the residual stream's sequence: the stream is
    gathered whole for each norm (:class:`_Stream`), the sub-layers see
    the whole sequence, and their outputs come back as slices
    (``TensorParallel.seq``)."""
    cache: Dict[str, Any] = {}
    tp = ctx.get("tp")
    gather, tp_out, rank = None, tp, 0
    if ctx.get("seq_parallel"):
        from repro_torch.core.comm import tp_gather
        gather = partial(tp_gather, group=tp.group, dim=1)
        tp_out, rank = dataclasses.replace(tp, seq=True), tp.rank
    # under tensor parallelism the attention returns this rank's part of
    # the cache, split as the decode cache splits (and the SSM its parts
    # of the state)
    kw = xkw = {}
    if tp is not None:
        kw = {"tp": tp_out, "cache": collect_cache,
              "cache_len": ctx.get("cache_len", 0)}
        xkw = {**kw, "cache_len": ctx.get("cross_len", 0)}
    st = _Stream(x, gather, rank)
    h = rms_norm(st.whole, bp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        if collect_cache:
            out, cache["ssm"] = ssm_mod.ssm_forward(bp["ssm"], h, cfg,
                                                    return_state=True,
                                                    tp=tp_out)
        else:
            out = ssm_mod.ssm_forward(bp["ssm"], h, cfg, tp=tp_out)
        return st.add(out), None, cache
    if kind == "cross":
        out, kv = attn.cross_attention_full(bp["attn"], h, ctx["cross_src"],
                                            cfg, **xkw)
        if collect_cache:
            cache["xkv"] = kv
        x = st.add(torch.tanh(bp["gate"].to(out.dtype)) * out)
    elif kind == "hybrid":
        # windowed even when scoring and training, as the reference is;
        # both outputs whole (their norms and fusion), then this rank's
        # slice under sequence parallelism
        whole_kw = {**kw, "tp": tp} if tp is not None else {}
        a_out, kv = attn.self_attention(bp["attn"], h, positions, cfg,
                                        window=window or cfg.sliding_window,
                                        **whole_kw)
        # the SSD kernel (ssm_pallas) runs where no state is collected
        s_out = ssm_mod.ssm_forward(bp["ssm"], h, cfg,
                                    return_state=collect_cache, tp=tp)
        if collect_cache:
            s_out, cache["ssm"] = s_out
            cache["kv"] = kv
        fused = _mean_fusion(bp, cfg, a_out, s_out)
        x = st.add(fused if gather is None else tp_out.out_whole(fused))
    else:                                       # self_dense / self_moe
        out, kv = attn.self_attention(bp["attn"], h, positions, cfg,
                                      window=window,
                                      causal=ctx.get("causal", True), **kw)
        if collect_cache:
            cache["kv"] = kv
        x = st.add(out)
    if encdec_dec:
        st = _Stream(x, gather, rank)
        h = rms_norm(st.whole, bp["ln3"], cfg.norm_eps)
        out, xkv = attn.cross_attention_full(bp["xattn"], h,
                                             ctx["cross_src"], cfg, **xkw)
        if collect_cache:
            cache["xkv"] = xkv
        x = st.add(out)
    x, aux = _ffn(bp, cfg, kind, x, ctx.get("batch_group"), tp_out, gather)
    return x, aux, cache


#: the reference's ``remat`` policies
REMAT_POLICIES = ("none", "full", "dots", "save_tp")


def _saves_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy, ``checkpoint_dots_with_no_batch_dims``: keep
    the outputs of 2-D matrix products (an activation times a weight),
    recompute the rest (the batched products of attention and the SSD
    included)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _rematerialised(fn, remat: str):
    """``fn(x, gp, log)`` under the reference's ``jax.checkpoint`` of a
    group: non-reentrant ``torch.utils.checkpoint`` (``"full"``: the
    group's input alone is kept for the backward), with a selective policy
    for ``"dots"``; ``fn`` itself for ``"none"``. ``"save_tp"`` (the
    reference's ``save_only_these_names("attn_out", "mlp_out")``) keeps
    the sub-layer outputs that tensor parallelism sums over ``model``: the
    group's forward records each ``tp_sum``'s output
    (``core.comm.TPSumLog``) and its recomputation takes them back instead
    of issuing the collectives again; everything else is recomputed. On
    one rank no sum runs, and it is ``"full"``. The returned function
    takes ``(x, gp)``."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r}: one of {REMAT_POLICIES}")
    if remat == "none":
        return lambda x, gp: fn(x, gp, None)
    import torch.utils.checkpoint as ckpt
    if remat == "save_tp":
        from repro_torch.core.comm import TPSumLog

        def run(x, gp):
            log = TPSumLog()
            out = ckpt.checkpoint(fn, x, gp, log, use_reentrant=False)
            log.replay()              # the recomputation reads it back
            return out
        return run
    kw = {}
    if remat == "dots":
        kw["context_fn"] = partial(ckpt.create_selective_checkpoint_contexts,
                                   _saves_matmuls)
    return lambda x, gp: ckpt.checkpoint(fn, x, gp, None,
                                         use_reentrant=False, **kw)


def apply_stack(params, cfg, x, positions, ctx=None, *, window: int = 0,
                collect_cache: bool = False, encdec_dec: bool = False,
                remat: str = "none"):
    """Run the stacked groups in order. Returns (x, aux_loss, caches|None);
    the caches are stacked like the parameters. The MoE aux losses are
    summed as the reference sums them: within each group in order, then
    over the groups. ``remat`` (``"none"``, ``"full"``, ``"dots"``)
    rematerialises each group in the backward, as the reference's
    ``jax.checkpoint`` of its scanned group does (``"save_tp"`` too:
    :func:`_rematerialised`); it applies where autograd records the
    forward and no cache is collected; under tensor parallelism a
    recomputation issues its TP collectives again (``"full"``,
    ``"dots"``) or takes their recorded outputs (``"save_tp"``). ``ctx``
    holds the cross-attention source (``"cross_src"``), ``"causal"``, the
    ranks whose rows make one batch with ``x``'s (``"batch_group"``),
    tensor parallelism (``"tp"``, a ``sharding.partition.TensorParallel``),
    sequence parallelism (``"seq_parallel"``: ``x`` and the result are
    this rank's slices of the sequence, :func:`_apply_block`), the
    decode caches' lengths whose splits a collected cache follows under it
    (``"cache_len"``, ``"cross_len"``) and, serving with gathered weights,
    ``"fetch"`` (a group's weights as held, stored parts, to the weights
    the layers take, gathered for the group alone and freed after it);
    the groups' functions capture it, so a recomputation sees what the
    forward saw."""
    kinds = group_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    ctx = ctx or {}
    if collect_cache or not torch.is_grad_enabled():
        remat = "none"

    def group_fn(x, gp, log=None):
        group_caches = []
        aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
        gctx = ctx
        if log is not None and ctx.get("tp") is not None:
            gctx = {**ctx, "tp": ctx["tp"].with_log(log)}
        for i, kind in enumerate(kinds):
            x, aux, cache = _apply_block(gp[i], cfg, kind, x, positions,
                                         gctx, window=window,
                                         collect_cache=collect_cache,
                                         encdec_dec=encdec_dec)
            if aux is not None:
                aux_tot = aux_tot + aux
            group_caches.append(cache)
        return x, aux_tot, group_caches

    run = _rematerialised(lambda x, gp, log: group_fn(x, gp, log)[:2], remat)
    caches, group_aux = [], []
    fetch = ctx.get("fetch")
    for g in range(n_groups):
        gp = tree_map(lambda t: t[g], params)
        if fetch is not None:
            gp = fetch(gp)
        if remat == "none":
            x, aux_tot, group_caches = group_fn(x, gp)
            caches.append(group_caches)
        else:
            x, aux_tot = run(x, gp)
        del gp                    # a gathered group's weights, freed
        group_aux.append(aux_tot)
    aux = torch.sum(torch.stack(group_aux))
    return x, aux, (stack_trees(caches) if collect_cache else None)


def _decode_block(bp, cfg, kind, x, pos, cache, spec, tp=None,
                  batch_group=None):
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == "ssm":
        out, st = ssm_mod.ssm_decode_step(bp["ssm"], h, cache["ssm"], cfg, tp)
        return x + out, {"ssm": st}
    new_cache: Dict[str, Any] = {}
    if kind == "cross":
        k, v = cache["xkv"]
        out = _cross_decode(bp["attn"], h, k, v, cfg, spec, tp)
        new_cache["xkv"] = (k, v)
        x = x + torch.tanh(bp["gate"].to(out.dtype)) * out
    else:                     # self_dense / self_moe / hybrid
        ck, cv = cache["kv"]
        if tp is None:
            a_out, nk, nv = attn.decode_self_attention(bp["attn"], h, ck, cv,
                                                       pos, cfg, spec)
        else:
            a_out, nk, nv = attn.tp_decode_self_attention(
                bp["attn"], h, ck, cv, pos, cfg, spec, tp)
        new_cache["kv"] = (nk, nv)
        if kind == "hybrid":
            s_out, new_cache["ssm"] = ssm_mod.ssm_decode_step(
                bp["ssm"], h, cache["ssm"], cfg, tp)
            x = x + _mean_fusion(bp, cfg, a_out, s_out)
        else:
            x = x + a_out
    if "xkv" in cache and kind != "cross":          # enc-dec decoder
        k, v = cache["xkv"]
        h = rms_norm(x, bp["ln3"], cfg.norm_eps)
        x = x + _cross_decode(bp["xattn"], h, k, v, cfg, spec, tp)
        new_cache["xkv"] = (k, v)
    # decode drops the MoE aux loss
    x, _ = _ffn(bp, cfg, kind, x, batch_group, tp)
    return x, new_cache


def _cross_decode(p, h, k, v, cfg, spec, tp):
    if tp is None:
        return attn.cross_attention_cached(p, h, k, v, cfg)
    return attn.tp_cross_attention_cached(p, h, k, v, cfg, spec, tp)


def decode_stack(params, cfg, x, pos, caches, *, spec: attn.KVCacheSpec,
                 tp=None, batch_group=None, fetch=None):
    """x: (B,1,D); pos: (B,); caches: stacked (n_groups leading). Returns
    (x, caches). Under ``tp`` the caches are this rank's parts and
    ``spec`` holds the whole caches' lengths; ``batch_group``: the ranks
    whose rows make one batch with ``x``'s (the MoE routes them as
    one); ``fetch``: as ``apply_stack``'s ctx ``"fetch"``."""
    kinds = group_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    new_caches = []
    for g in range(n_groups):
        gp = tree_map(lambda t: t[g], params)
        if fetch is not None:
            gp = fetch(gp)
        gc = tree_map(lambda t: t[g], caches)
        group_caches = []
        for i, kind in enumerate(kinds):
            x, nc = _decode_block(gp[i], cfg, kind, x, pos, gc[i], spec,
                                  tp, batch_group)
            group_caches.append(nc)
        del gp                    # a gathered group's weights, freed
        new_caches.append(group_caches)
    return x, stack_trees(new_caches)

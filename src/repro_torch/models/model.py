"""Unified model API: ``build_model(cfg)`` -> init / loss_fn / prefill / decode.

The JAX package's ``models/model.py``. Families:

  dense / moe / ssm : decoder-only LM over tokens
  hybrid            : decoder-only LM, attention and SSM heads in parallel
  vlm               : decoder LM + cross-attention to (stubbed) image embeds
  audio             : encoder-decoder over (stubbed) audio frame embeds
  lstm              : the paper's Big LSTM

Parameters, batches and caches are nested dicts, lists and tuples of
tensors laid out like the JAX pytrees; every function runs on the device
its inputs lie on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import lstm as lstm_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (init_dense, rms_norm, tp_embed,
                                       tp_linear)


def softmax_xent(logits, labels, mask=None):
    """Mean token cross-entropy in fp32. logits: (B,S,V), labels: (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


class FusedSoftmaxXent(torch.autograd.Function):
    """The reference's ``fused_softmax_xent``: the mean token cross-entropy
    with the gold logit picked by comparing against an iota, and a backward
    that returns (g / n)·(softmax − onehot) in the logits' dtype."""

    @staticmethod
    def _onehot(x, labels):
        iota = torch.arange(x.shape[-1], device=x.device)
        return iota == labels.long()[..., None]

    @staticmethod
    def forward(ctx, logits, labels):
        x = logits.float()
        m = torch.amax(x, dim=-1, keepdim=True)
        z = torch.sum(torch.exp(x - m), dim=-1)
        logz = torch.log(z) + m[..., 0]
        gold = torch.sum(torch.where(FusedSoftmaxXent._onehot(x, labels), x,
                                     0.0), dim=-1)
        ctx.save_for_backward(logits, labels, m[..., 0], z)
        return torch.mean(logz - gold)

    @staticmethod
    def backward(ctx, g):
        logits, labels, m, z = ctx.saved_tensors
        x = logits.float()
        p = torch.exp(x - m[..., None]) / z[..., None]
        onehot = FusedSoftmaxXent._onehot(x, labels).float()
        dlogits = (g / labels.numel()) * (p - onehot)
        return dlogits.to(logits.dtype), None


def fused_softmax_xent(logits, labels):
    """Mean token cross-entropy; logits: (B,S,V), labels: (B,S)."""
    return FusedSoftmaxXent.apply(logits, labels)


class VocabParallelXent(torch.autograd.Function):
    """The mean token cross-entropy of logits split along the vocabulary
    over ``model`` (this rank's columns ``lo:lo + V/M``), in float32: the
    max, the sum of exponentials and the gold logit each combined over the
    ranks (the max exactly; the sums in rank order), two collectives. The
    backward is local: (g / n)·(softmax − onehot) on this rank's columns
    in the logits' dtype (masked rows weighted as ``softmax_xent``
    weights them). ``softmax_xent`` and ``fused_softmax_xent`` both take
    this form under tensor parallelism."""

    @staticmethod
    def forward(ctx, logits, labels, mask, group, lo):
        from repro_torch.core import comm
        x = logits.float()
        (ms,) = group.all_gather([torch.amax(x, dim=-1)], count=comm.tp)
        m = torch.amax(ms, dim=0)
        z_part = torch.sum(torch.exp(x - m[..., None]), dim=-1)
        local = labels.long() - lo
        mine = (local >= 0) & (local < x.shape[-1])
        gold_part = torch.where(mine, torch.gather(
            x, -1, torch.clamp(local, 0, x.shape[-1] - 1)[..., None])[..., 0],
            torch.zeros_like(m))
        zs, golds = group.all_gather([z_part, gold_part], count=comm.tp)
        z, gold = zs[0].clone(), golds[0].clone()
        for r in range(1, group.world):                  # rank order
            z.add_(zs[r])
            gold.add_(golds[r])
        nll = torch.log(z) + m - gold
        if mask is None:
            weight = None
            loss = torch.mean(nll)
        else:
            mask = mask.float()
            weight = mask / torch.clamp(torch.sum(mask), min=1.0)
            loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)
        ctx.save_for_backward(logits, local, mine, m, z)
        ctx.weight = weight
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, local, mine, m, z = ctx.saved_tensors
        x = logits.float()
        p = torch.exp(x - m[..., None]) / z[..., None]
        iota = torch.arange(x.shape[-1], device=x.device)
        onehot = ((iota == local[..., None]) & mine[..., None]).float()
        w = (g / local.numel() if ctx.weight is None
             else (g * ctx.weight)[..., None])
        return (w * (p - onehot)).to(logits.dtype), None, None, None, None


def vocab_parallel_xent(logits, labels, tp, split, mask=None):
    """Mean token cross-entropy of this rank's vocabulary part of the
    logits (``split``: the head weight's ``LeafSplit`` along the
    vocabulary) under ``tp`` (:class:`VocabParallelXent`)."""
    return VocabParallelXent.apply(logits, labels, mask, tp.group,
                                   split.index * logits.shape[-1])


def tp_logits(logits, part: bool, tp):
    """Logits whole on every rank: a vocabulary part gathered over
    ``model``, as the reference returns serving's logits unsharded."""
    if not part:
        return logits
    from repro_torch.core.comm import tp_gather
    return tp_gather(logits, tp.group)


@dataclasses.dataclass
class Model:
    cfg: Any
    init: Callable[..., Dict]            # (gen, device=None) -> params
    loss_fn: Callable[..., Any]          # (params, batch, rng=None) -> (loss, metrics)
    logits_fn: Callable[..., Any]        # (params, batch) -> logits
    prefill: Callable[..., Any]          # (params, batch) -> (logits, cache)
    decode_step: Callable[..., Any]      # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable[..., Any]       # (batch_size, cache_len, ...) -> cache


def _encoder_cfg(cfg):
    """The encoder's stack: self_dense blocks, as many as n_encoder_layers."""
    return dataclasses.replace(cfg, n_layers=cfg.n_encoder_layers,
                               cross_attn_every=0, n_experts=0, hybrid=False)


def _build_transformer(cfg) -> Model:
    dtype = getattr(torch, cfg.param_dtype)

    def init(gen, device=None):
        """Fresh parameters on ``gen``'s device, the JAX package's
        initialisation distribution drawn from ``gen`` (the two frameworks'
        generators give other numbers; tests carry weights across with
        ``repro_torch.convert``). ``init(None, "meta")``: the shapes and
        dtypes alone."""
        dev = gen.device if device is None else torch.device(device)
        embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                            dtype=torch.float32, device=dev)
        params = {
            "embed": (embed * 0.02).to(dtype),
            "blocks": tfm.init_stack(gen, cfg, dtype, dev,
                                     encdec_dec=cfg.is_encdec),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        }
        del embed
        if cfg.is_encdec:
            params["encoder"] = tfm.init_stack(gen, _encoder_cfg(cfg), dtype,
                                               dev)
            params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                            device=dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab_size,
                                           scale=0.02, dtype=dtype, device=dev)
        return params

    def _top(params, key, gather):
        """A top-level weight as the layers take it: ``params[key]``, or
        gathered by ``gather`` (serving with gathered weights:
        ``launch/serving.py::WeightGather``)."""
        return params[key] if gather is None else gather.leaf(params, key)

    def _encode(params, batch, tp=None, gather=None):
        """The encoder over the (stubbed) audio frames, non-causal; under
        ``tp`` its layers split as the decoder's, the output the same on
        every rank."""
        frames = batch["audio_frames"].to(dtype)            # (B,F,D)
        pos = torch.arange(frames.shape[1],
                           device=frames.device).expand(frames.shape[:2])
        ctx = {"causal": False}
        if tp is not None:
            ctx["tp"] = tp
        if gather is not None:
            ctx["fetch"] = gather.stack("encoder")
        h, _, _ = tfm.apply_stack(params["encoder"], _encoder_cfg(cfg),
                                  frames, pos, ctx=ctx)
        return rms_norm(h, _top(params, "enc_norm", gather), cfg.norm_eps)

    def _ctx(params, batch, tp=None, gather=None):
        """The cross-attention source: the encoder's output, or the image
        embeddings (a replicated input under ``tp``)."""
        if cfg.is_encdec:
            return {"cross_src": _encode(params, batch, tp, gather)}
        if cfg.cross_attn_every:
            return {"cross_src": batch["image_embeds"].to(dtype)}
        return {}

    def _vocab_split(tp):
        """The head weight's split along the vocabulary (the tied
        ``embed``'s rows, or ``lm_head``'s columns)."""
        if cfg.tie_embeddings:
            return tp.split("embed", (cfg.vocab_size, cfg.d_model))
        return tp.split("lm_head", (cfg.d_model, cfg.vocab_size))

    def _trunk(params, batch, *, window=0, collect_cache=False,
               remat="none", batch_group=None, tp=None, cache_lens=None,
               seq_parallel=False, gather=None):
        """The decoder stack over the embedded tokens, final-normed.
        ``seq_parallel`` (training under ``tp``): the residual stream
        between the blocks is this rank's slice of the sequence (the
        reference's ``seq_sp`` constraints), where the TP size divides
        it; the embedding reduce-scattered, the stream gathered whole
        again before the final norm. ``gather``: the weights gathered as
        each runs (serving, ``_top``)."""
        tokens = batch["tokens"]
        sp = (seq_parallel and tp is not None and tp.size > 1
              and tokens.shape[1] % tp.size == 0)
        embed = _top(params, "embed", gather)
        if tp is None:
            x = embed[tokens.long()].to(dtype)
        else:
            x = tp_embed(embed, tokens, tp.split(
                "embed", (cfg.vocab_size, cfg.d_model)),
                dataclasses.replace(tp, seq=sp)).to(dtype)
        del embed
        pos = torch.arange(tokens.shape[1],
                           device=tokens.device).expand(tokens.shape)
        ctx = _ctx(params, batch, tp, gather)
        if batch_group is not None:
            ctx["batch_group"] = batch_group
        if tp is not None:
            ctx["tp"] = tp
            ctx["seq_parallel"] = sp
            ctx.update(cache_lens or {})
        if gather is not None:
            ctx["fetch"] = gather.stack("blocks")
        x, aux, caches = tfm.apply_stack(
            params["blocks"], cfg, x, pos, ctx, window=window,
            collect_cache=collect_cache, encdec_dec=cfg.is_encdec,
            remat=remat)
        if sp:
            from repro_torch.core.comm import tp_gather
            x = tp_gather(x, tp.group, 1)
        x = rms_norm(x, _top(params, "final_norm", gather), cfg.norm_eps)
        return x, aux, caches

    def _head(params, x, tp=None, gather=None):
        """Logits, and whether they are this rank's vocabulary part."""
        w = _top(params, "embed" if cfg.tie_embeddings else "lm_head",
                 gather)
        if tp is None:
            return x @ (w.T if cfg.tie_embeddings else w), False
        split = _vocab_split(tp)
        if cfg.tie_embeddings:       # embed's rows are the head's columns
            if not split.split:
                return x @ w.T, False
            from repro_torch.core.comm import tp_copy
            return tp_copy(x, tp.group) @ w.T, True
        return tp_linear(x, w, split, tp)

    def logits_fn(params, batch, tp=None):
        x, _, _ = _trunk(params, batch, tp=tp)
        return tp_logits(*_head(params, x, tp), tp)

    def loss_fn(params, batch, rng=None, remat: str = "none",
                batch_group=None, tp=None):
        """The training loss; ``remat`` rematerialises the decoder's groups
        in the backward (``transformer.apply_stack``), not the encoder's,
        as in the reference. ``batch_group``: the ranks (a
        ``core.comm.RankGroup``) whose rows make one batch with
        ``batch``'s, in rank order, each as many; the MoE layers route
        them as one (``moe.moe_apply``). ``tp``: tensor parallelism (a
        ``sharding.partition.TensorParallel``; ``params`` this rank's
        parts): the same loss on every rank, vocabulary-parallel where the
        head splits, the decoder's residual stream split along the
        sequence under ``cfg.seq_parallel`` (``_trunk``)."""
        x, aux, _ = _trunk(params, batch, remat=remat,
                           batch_group=batch_group, tp=tp,
                           seq_parallel=cfg.seq_parallel)
        logits, part = _head(params, x, tp)
        if part:
            loss = vocab_parallel_xent(logits, batch["labels"], tp,
                                       _vocab_split(tp), batch.get("mask"))
        elif cfg.fused_xent and "mask" not in batch:
            loss = fused_softmax_xent(logits, batch["labels"])
        else:
            loss = softmax_xent(logits, batch["labels"], batch.get("mask"))
        return loss + aux, {"xent": loss, "aux": aux}

    def prefill(params, batch, *, window: int = 0, tp=None,
                batch_group=None, cache_len: int = 0, cross_len: int = 0,
                gather=None):
        """Last-position logits and the stacked caches: the attention
        layers' post-RoPE (k, v), the cross-attention layers' (k, v) of the
        image embeddings or the encoder's output (``xkv``), the SSM layers'
        last state. Under ``tp`` the logits are whole on every rank and the
        caches this rank's parts: (k, v) and ``xkv`` of the sequence-split
        cache (split where the decode caches of ``cache_len`` and
        ``cross_len`` split, or, 0, the prefill's own), the SSM state's
        heads and the conv tail's channels. ``batch_group``: the ranks
        whose rows make one batch with ``batch``'s (the MoE routes them
        as one, as ``loss_fn``). ``gather``: ``params`` are this rank's
        stored parts, each weight gathered as it runs and freed after it
        (serving with gathered weights, ``launch/serving.py``)."""
        x, _, caches = _trunk(params, batch, window=window,
                              collect_cache=True, tp=tp,
                              batch_group=batch_group, cache_lens={
                                  "cache_len": cache_len,
                                  "cross_len": cross_len}, gather=gather)
        logits = tp_logits(*_head(params, x[:, -1:], tp, gather), tp)
        return logits, caches

    def init_cache(batch_size: int, cache_len: int, *, windowed: bool = False,
                   cross_len: int = 0, device="cpu"):
        """Zero-initialized stacked decode cache: for each kind of the group,
        ``"kv"``: (k, v) (g,B,cache_len,KV,hd) for self-attention (the
        hybrid kind too), ``"xkv"``:
        (k, v) (g,B,cross_len,KV,hd) for cross-attention (the ``cross``
        kind, every decoder block of an encoder-decoder) and ``"ssm"``: (S
        (g,B,nh,N,hd) fp32, conv_tail (g,B,W-1,C)) for the ssm and hybrid
        kinds."""
        kinds = tfm.group_kinds(cfg)
        g = cfg.n_layers // len(kinds)
        kv, hd = cfg.n_kv_heads, cfg.head_dim

        def pair(length):
            return tuple(torch.zeros((g, batch_size, length, kv, hd),
                                     dtype=dtype, device=device)
                         for _ in range(2))

        entries = []
        for kind in kinds:
            c: Dict[str, Any] = {}
            if kind in ("self_dense", "self_moe", "hybrid"):
                c["kv"] = pair(cache_len)
            if kind in ("ssm", "hybrid"):
                s, ct = ssm_mod.init_ssm_state(cfg, batch_size, dtype, device)
                c["ssm"] = (s.new_zeros((g,) + s.shape),
                            ct.new_zeros((g,) + ct.shape))
            if kind == "cross" or cfg.is_encdec:
                c["xkv"] = pair(cross_len)
            entries.append(c)
        return entries

    def decode_step(params, caches, token, pos, *, window: int = 0,
                    tp=None, cache_len: int = 0, cross_len: int = 0,
                    batch_group=None, gather=None):
        """token: (B,1); pos: (B,). Returns (logits (B,1,V), caches). Under
        ``tp`` the caches are this rank's parts, and ``cache_len`` and
        ``cross_len`` the whole self- and cross-attention caches'
        lengths. ``batch_group`` and ``gather`` as in ``prefill``."""
        embed = _top(params, "embed", gather)
        if tp is None:
            x = embed[token.long()].to(dtype)
        else:
            x = tp_embed(embed, token, tp.split(
                "embed", (cfg.vocab_size, cfg.d_model)), tp).to(dtype)
        del embed
        kv_leaves = [v for e in caches for k, v in e.items() if k == "kv"]
        spec = attn_mod.KVCacheSpec(
            cache_len=cache_len or (kv_leaves[0][0].shape[2] if kv_leaves
                                    else 0),
            windowed=bool(window), cross_len=cross_len)
        x, caches = tfm.decode_stack(
            params["blocks"], cfg, x, pos, caches, spec=spec, tp=tp,
            batch_group=batch_group,
            fetch=None if gather is None else gather.stack("blocks"))
        x = rms_norm(x, _top(params, "final_norm", gather), cfg.norm_eps)
        return tp_logits(*_head(params, x, tp, gather), tp), caches

    return Model(cfg=cfg, init=init, loss_fn=loss_fn, logits_fn=logits_fn,
                 prefill=prefill, decode_step=decode_step, init_cache=init_cache)


def _build_lstm(cfg) -> Model:
    dtype = getattr(torch, cfg.param_dtype)

    def init(gen, device=None):
        """Fresh parameters on ``gen``'s device (``lstm.init_lstm``);
        ``init(None, "meta")``: the shapes and dtypes alone."""
        return lstm_mod.init_lstm(gen, cfg, dtype,
                                  gen.device if device is None else device)

    def logits_fn(params, batch, tp=None):
        out = lstm_mod.lstm_logits(params, batch["tokens"], cfg, tp=tp)
        return out if tp is None else tp_logits(*out, tp)

    def loss_fn(params, batch, rng=None, remat: str = "none",
                batch_group=None, tp=None):
        """Dropout 0.1 when ``rng`` (a ``torch.Generator``) is given; the
        training path passes none, as the reference's does. ``remat`` is
        accepted and ignored, as the reference's LSTM ignores it;
        ``batch_group`` too (no layer of the LSTM couples a batch's
        rows). ``tp``: tensor parallelism (``lstm.lstm_logits``), the
        cross-entropy vocabulary-parallel where the head splits."""
        logits = lstm_mod.lstm_logits(
            params, batch["tokens"], cfg, rng=rng,
            dropout_rate=0.1 if rng is not None else 0.0, tp=tp)
        if tp is not None:
            logits, part = logits
            if part:
                loss = vocab_parallel_xent(
                    logits, batch["labels"], tp, lstm_mod.head_split(cfg, tp),
                    batch.get("mask"))
        if tp is None or not part:
            loss = softmax_xent(logits, batch["labels"], batch.get("mask"))
        return loss, {"xent": loss,
                      "aux": torch.zeros((), dtype=torch.float32,
                                         device=loss.device)}

    def prefill(params, batch, *, window: int = 0, tp=None,
                batch_group=None, cache_len: int = 0, cross_len: int = 0,
                gather=None):
        """The state after the prompt, and the logits of its last position:
        the 793k-vocab head runs once, on the last hidden state, not at
        every position. Under ``tp`` the logits are whole on every rank.
        ``gather``: the weights gathered whole for the call."""
        if gather is not None:
            params = gather.tree(params)
        tokens = batch["tokens"]
        state = lstm_mod.init_lstm_state(cfg, tokens.shape[0], dtype,
                                         tokens.device)
        h = torch.zeros((tokens.shape[0], cfg.lstm_proj), dtype=dtype,
                        device=tokens.device)
        for t in range(tokens.shape[1]):
            h, state = lstm_mod.lstm_hidden_step(params, tokens[:, t:t + 1],
                                                 state, cfg, tp=tp)
        logits = lstm_mod.lstm_head(params, h, cfg, tp)
        return logits[:, None], state

    def init_cache(batch_size: int, cache_len: int, *, windowed: bool = False,
                   cross_len: int = 0, device="cpu"):
        """The zero recurrent state; its size does not depend on
        ``cache_len``."""
        return lstm_mod.init_lstm_state(cfg, batch_size, dtype, device)

    def decode_step(params, caches, token, pos, *, window: int = 0,
                    tp=None, cache_len: int = 0, cross_len: int = 0,
                    batch_group=None, gather=None):
        if gather is not None:
            params = gather.tree(params)
        return lstm_mod.lstm_decode_step(params, token, caches, cfg, tp=tp)

    return Model(cfg=cfg, init=init, loss_fn=loss_fn, logits_fn=logits_fn,
                 prefill=prefill, decode_step=decode_step, init_cache=init_cache)


def build_model(cfg) -> Model:
    if cfg.family == "lstm":
        return _build_lstm(cfg)
    return _build_transformer(cfg)

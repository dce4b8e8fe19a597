"""Analytic parameter counts; they match the port's parameter dicts exactly
but for the hybrid layer.

The JAX package's ``models/counting.py``: the same terms for every family,
so each count equals the reference's. The hybrid term is counted as the
reference counts it, with 3 norms of d_model, though the layer holds four
(ln1, ln2, norm_attn, norm_ssm): hymba's tree has n_layers * d_model
parameters more than its count.
"""
from __future__ import annotations


def _attn_params(cfg) -> int:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = d * h * hd + 2 * d * kv * hd + h * hd * d          # wq, wk, wv, wo
    if cfg.qkv_bias:
        n += h * hd + 2 * kv * hd
    return n


def _mlp_params(cfg, d_ff: int) -> int:
    return (3 if cfg.act == "swiglu" else 2) * cfg.d_model * d_ff


def _ssm_params(cfg) -> int:
    d, di, n, hd = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    nh = di // hd
    in_proj = d * (2 * di + 2 * n + nh)                     # z, x, B, C, dt
    conv = cfg.ssm_conv * (di + 2 * n)                      # depthwise conv over x,B,C
    other = nh + nh + nh                                    # A_log, D, dt_bias
    norm = di
    out = di * d
    return in_proj + conv + other + norm + out


def _moe_params(cfg) -> int:
    n = cfg.d_model * cfg.n_experts                         # router
    n += cfg.n_experts * _mlp_params(cfg, cfg.d_ff)         # w1, (w3), w2
    if cfg.shared_expert:
        n += _mlp_params(cfg, cfg.dense_d_ff)
    return n


def _block_params(cfg, kind: str) -> int:
    d = cfg.d_model
    if kind == "ssm":
        return _ssm_params(cfg) + d                          # + pre-norm
    if kind == "hybrid":              # the reference's count: 3 norms
        return (_attn_params(cfg) + _ssm_params(cfg) + 3 * d
                + _mlp_params(cfg, cfg.d_ff))
    n = _attn_params(cfg) + 2 * d                            # + ln1, ln2
    if kind == "self_moe":
        return n + _moe_params(cfg)
    if kind == "cross":                                      # + tanh gate
        return n + _mlp_params(cfg, cfg.dense_d_ff or cfg.d_ff) + 1
    if kind == "self_dense":
        d_ff = cfg.dense_d_ff if (cfg.is_moe and cfg.moe_every > 1) else cfg.d_ff
        return n + _mlp_params(cfg, d_ff)
    raise ValueError(f"unknown layer kind {kind!r}")


def layer_kinds(cfg) -> list:
    """The per-layer kind sequence for the decoder stack."""
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            kinds.append("ssm")
        elif cfg.hybrid:
            kinds.append("hybrid")
        elif cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
            kinds.append("cross")
        elif cfg.is_moe and (i + 1) % cfg.moe_every == 0:
            kinds.append("self_moe")
        else:
            kinds.append("self_dense")
    return kinds


def count_params(cfg) -> int:
    if cfg.family == "lstm":
        e, h, p, v = cfg.lstm_proj, cfg.d_model, cfg.lstm_proj, cfg.vocab_size
        n = v * e                                            # embedding
        per = 4 * h * (e + p) + 4 * h + h * p                # LSTMP cell (in=proj size)
        n += cfg.n_layers * per
        n += p * v + v                                       # softmax
        return n
    d = cfg.d_model
    n = cfg.vocab_size * d                                   # embedding
    for kind in layer_kinds(cfg):
        n += _block_params(cfg, kind)
    if cfg.is_encdec:
        # the encoder's self_dense blocks and final norm; the decoder
        # blocks' cross-attention (xattn) and its norm (ln3)
        n += cfg.n_encoder_layers * (_attn_params(cfg)
                                     + _mlp_params(cfg, cfg.d_ff) + 2 * d)
        n += d
        n += cfg.n_layers * (_attn_params(cfg) + d)
    n += d                                                   # final norm
    if not cfg.tie_embeddings:
        n += d * cfg.vocab_size                              # lm head
    return n


def count_active_params(cfg) -> int:
    """Parameters a token passes through: an MoE layer counts its top_k
    experts (and the shared one), not all of them."""
    n = count_params(cfg)
    if not cfg.is_moe:
        return n
    n_moe = sum(1 for k in layer_kinds(cfg) if k == "self_moe")
    return n - n_moe * (cfg.n_experts - cfg.top_k) * _mlp_params(cfg, cfg.d_ff)

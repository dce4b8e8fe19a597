"""Analytic parameter counts; they match the port's parameter dicts exactly.

The JAX package's ``models/counting.py`` for the families the port builds:
the Big LSTM, the SSM stack and the dense decoder. Other families raise.
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


def _block_params(cfg, kind: str) -> int:
    if kind == "ssm":
        return _ssm_params(cfg) + cfg.d_model                # + pre-norm
    if kind == "self_dense":                                 # + ln1, ln2
        d_ff = cfg.dense_d_ff if (cfg.is_moe and cfg.moe_every > 1) else cfg.d_ff
        return _attn_params(cfg) + 2 * cfg.d_model + _mlp_params(cfg, d_ff)
    raise NotImplementedError(
        f"layer kind {kind!r} is not ported to PyTorch yet (ROADMAP Queue 1 "
        "item 10)")


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
    if cfg.family not in ("ssm", "dense"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet "
            "(ROADMAP Queue 1 item 10)")
    n = cfg.vocab_size * cfg.d_model                         # embedding
    for kind in layer_kinds(cfg):
        n += _block_params(cfg, kind)
    n += cfg.d_model                                         # final norm
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab_size                    # lm head
    return n

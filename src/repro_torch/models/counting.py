"""Analytic parameter counts; they match the port's parameter dicts exactly."""
from __future__ import annotations


def count_params(cfg) -> int:
    if cfg.family != "lstm":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet "
            "(ROADMAP Queue 1)")
    e, h, p, v = cfg.lstm_proj, cfg.d_model, cfg.lstm_proj, cfg.vocab_size
    n = v * e                                            # embedding
    per = 4 * h * (e + p) + 4 * h + h * p                # LSTMP cell (in=proj size)
    n += cfg.n_layers * per
    n += p * v + v                                       # softmax
    return n

"""Big LSTM (LSTM-2048-512) — the paper's own evaluation architecture.

2 projected-LSTM layers (Sak et al. LSTMP cell) over word embeddings of the
projection size, full-softmax head; a residual connection after the first
layer. Parameters are a dict laid out like the JAX package's pytree:
``embed``, ``head_w``, ``head_b``, ``cells[i].{wx, wh, b, wp}``. The time
loop is a Python loop; its backward is ``torch.autograd``'s. Decode is the
single recurrent step over a state of (h_proj, c) pairs, one per layer.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dropout, init_dense


def init_lstm(gen: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    """Fresh parameters, the JAX package's initialisation distribution drawn
    from a ``torch.Generator`` (the two frameworks' generators give other
    numbers; tests carry weights across with ``repro_torch.convert``)."""
    h, p, v = cfg.d_model, cfg.lstm_proj, cfg.vocab_size
    embed = torch.randn((v, p), generator=gen, dtype=torch.float32,
                        device=device)
    params = {
        "embed": (embed * 0.05).to(dtype),
        "head_w": init_dense(gen, p, v, dtype=dtype, device=device),
        "head_b": torch.zeros((v,), dtype=dtype, device=device),
    }
    del embed
    params["cells"] = [{
        "wx": init_dense(gen, p, 4 * h, dtype=dtype, device=device),
        "wh": init_dense(gen, p, 4 * h, dtype=dtype, device=device),
        "b": torch.zeros((4 * h,), dtype=dtype, device=device),
        "wp": init_dense(gen, h, p, dtype=dtype, device=device),
    } for _ in range(cfg.n_layers)]
    return params


def _cell(cell, x, h_proj, c):
    gates = x @ cell["wx"] + h_proj @ cell["wh"] + cell["b"]
    i, f, g, o = torch.split(gates, gates.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h @ cell["wp"], c


def init_lstm_state(cfg, batch, dtype=torch.float32, device="cpu"):
    """Zero state: one (h_proj (B, P), c (B, H)) pair per layer."""
    return [(torch.zeros((batch, cfg.lstm_proj), dtype=dtype, device=device),
             torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def lstm_logits(params, tokens: torch.Tensor, cfg, *, rng=None,
                dropout_rate: float = 0.0) -> torch.Tensor:
    """tokens: (B, S) integer -> logits (B, S, V) in the parameter dtype.

    With a ``torch.Generator`` ``rng`` and a positive ``dropout_rate``, one
    dropout mask falls on the embeddings and one on each layer's outputs
    before the residual, drawn in that order."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()]                     # (B, S, P)
    deterministic = rng is None or dropout_rate == 0.0
    x = dropout(rng, x, dropout_rate, deterministic)
    xs = x.transpose(0, 1)                                 # (S, B, P)
    for li, cell in enumerate(params["cells"]):
        hp = x.new_zeros((b, cfg.lstm_proj))
        c = x.new_zeros((b, cfg.d_model))
        ys = []
        for t in range(s):
            hp, c = _cell(cell, xs[t], hp, c)
            ys.append(hp)
        ys = dropout(rng, torch.stack(ys), dropout_rate, deterministic)
        xs = ys + xs if li > 0 else ys                     # residual after first layer
    out = xs.transpose(0, 1)                               # (B, S, P)
    return out @ params["head_w"] + params["head_b"]


def lstm_hidden_step(params, token: torch.Tensor, state, cfg):
    """One recurrent step WITHOUT the softmax head.
    token: (B, 1) integer; state: [(h_proj, c)] -> (h (B, P), state)."""
    h = params["embed"][token[:, 0].long()]
    new_state = []
    for li, cell in enumerate(params["cells"]):
        hp, c = _cell(cell, h, state[li][0], state[li][1])
        new_state.append((hp, c))
        h = hp + h if li > 0 else hp
    return h, new_state


def lstm_decode_step(params, token: torch.Tensor, state, cfg):
    """token: (B, 1) integer; state: [(h_proj, c)] -> (logits (B, 1, V),
    state)."""
    h, new_state = lstm_hidden_step(params, token, state, cfg)
    logits = h @ params["head_w"] + params["head_b"]
    return logits[:, None], new_state

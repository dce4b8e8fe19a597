"""Big LSTM (LSTM-2048-512) — the paper's own evaluation architecture.

2 projected-LSTM layers (Sak et al. LSTMP cell) over word embeddings of the
projection size, full-softmax head; a residual connection after the first
layer. Parameters are a dict laid out like the JAX package's pytree:
``embed``, ``head_w``, ``head_b``, ``cells[i].{wx, wh, b, wp}``. The time
loop is a Python loop; its backward is ``torch.autograd``'s. Decode is the
single recurrent step over a state of (h_proj, c) pairs, one per layer.

Under tensor parallelism (``tp``, a ``sharding.partition.TensorParallel``)
the cells' ``wx``/``wh``/``b`` are split along the 4H gate dimension
(contiguously: at M = 2 one rank holds the whole i and f gates, the other
g and o), their gate parts gathered over ``model`` every time step, so
``c`` and ``h`` are the same on every rank; ``wp`` is row-split and its
partial products summed. The vocabulary leaves (``embed``, ``head_w``,
``head_b``) split where the vocabulary divides the TP size and stay whole
where it does not (793,471 is odd).
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


def _cell(cell, x, h_proj, c, tp=None, cfg=None):
    if tp is None:
        gates = x @ cell["wx"] + h_proj @ cell["wh"] + cell["b"]
    else:
        gates = _tp_gates(cell, x, h_proj, tp, cfg)
    i, f, g, o = torch.split(gates, gates.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    if tp is None:
        return h @ cell["wp"], c
    from repro_torch.models.layers import tp_linear
    out, _ = tp_linear(h, cell["wp"], tp.split(
        "wp", (cfg.d_model, cfg.lstm_proj)), tp)
    return out, c


def _tp_gates(cell, x, h_proj, tp, cfg):
    """The whole gates from this rank's parts of ``wx``/``wh``/``b`` (one
    gather over ``model`` where they split)."""
    from repro_torch.core.comm import tp_gather
    from repro_torch.models.layers import tp_linear
    shape = (cfg.lstm_proj, 4 * cfg.d_model)
    gx, part = tp_linear(x, cell["wx"], tp.split("wx", shape), tp)
    gh, _ = tp_linear(h_proj, cell["wh"], tp.split("wh", shape), tp)
    gates = gx + gh + cell["b"]
    return tp_gather(gates, tp.group) if part else gates


def head_split(cfg, tp):
    """``head_w``'s split along the vocabulary (``head_b`` splits with
    it)."""
    return tp.split("head_w", (cfg.lstm_proj, cfg.vocab_size))


def _head(params, h, cfg, tp):
    """h @ head_w + head_b and whether it is this rank's vocabulary
    part."""
    if tp is None:
        return h @ params["head_w"] + params["head_b"], False
    from repro_torch.models.layers import tp_linear
    y, part = tp_linear(h, params["head_w"], head_split(cfg, tp), tp)
    return y + params["head_b"], part


def lstm_head(params, h, cfg, tp=None):
    """The whole logits of hidden states ``h`` (a vocabulary part gathered
    over ``model``)."""
    y, part = _head(params, h, cfg, tp)
    if not part:
        return y
    from repro_torch.core.comm import tp_gather
    return tp_gather(y, tp.group)


def _embed(params, tokens, cfg, tp):
    if tp is None:
        return params["embed"][tokens.long()]
    from repro_torch.models.layers import tp_embed
    return tp_embed(params["embed"], tokens, tp.split(
        "embed", (cfg.vocab_size, cfg.lstm_proj)), tp)


def init_lstm_state(cfg, batch, dtype=torch.float32, device="cpu"):
    """Zero state: one (h_proj (B, P), c (B, H)) pair per layer."""
    return [(torch.zeros((batch, cfg.lstm_proj), dtype=dtype, device=device),
             torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


def lstm_logits(params, tokens: torch.Tensor, cfg, *, rng=None,
                dropout_rate: float = 0.0, tp=None):
    """tokens: (B, S) integer -> logits (B, S, V) in the parameter dtype;
    under ``tp`` (logits, part): this rank's vocabulary part where the
    head splits (``part``), else the whole logits.

    With a ``torch.Generator`` ``rng`` and a positive ``dropout_rate``, one
    dropout mask falls on the embeddings and one on each layer's outputs
    before the residual, drawn in that order."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, tp)                    # (B, S, P)
    deterministic = rng is None or dropout_rate == 0.0
    x = dropout(rng, x, dropout_rate, deterministic)
    xs = x.transpose(0, 1)                                 # (S, B, P)
    for li, cell in enumerate(params["cells"]):
        hp = x.new_zeros((b, cfg.lstm_proj))
        c = x.new_zeros((b, cfg.d_model))
        ys = []
        for t in range(s):
            hp, c = _cell(cell, xs[t], hp, c, tp, cfg)
            ys.append(hp)
        ys = dropout(rng, torch.stack(ys), dropout_rate, deterministic)
        xs = ys + xs if li > 0 else ys                     # residual after first layer
    out = xs.transpose(0, 1)                               # (B, S, P)
    logits = _head(params, out, cfg, tp)
    return logits if tp is not None else logits[0]


def lstm_hidden_step(params, token: torch.Tensor, state, cfg, tp=None):
    """One recurrent step WITHOUT the softmax head.
    token: (B, 1) integer; state: [(h_proj, c)] -> (h (B, P), state)."""
    h = _embed(params, token[:, 0], cfg, tp)
    new_state = []
    for li, cell in enumerate(params["cells"]):
        hp, c = _cell(cell, h, state[li][0], state[li][1], tp, cfg)
        new_state.append((hp, c))
        h = hp + h if li > 0 else hp
    return h, new_state


def lstm_decode_step(params, token: torch.Tensor, state, cfg, tp=None):
    """token: (B, 1) integer; state: [(h_proj, c)] -> (logits (B, 1, V),
    state); under ``tp`` the logits whole on every rank."""
    h, new_state = lstm_hidden_step(params, token, state, cfg, tp)
    return lstm_head(params, h, cfg, tp)[:, None], new_state

"""Big LSTM (LSTM-2048-512) — the paper's own evaluation architecture.

2 projected-LSTM layers (Sak et al. LSTMP cell) over word embeddings of the
projection size, full-softmax head; a residual connection after the first
layer. Parameters are a dict laid out like the JAX package's pytree:
``embed``, ``head_w``, ``head_b``, ``cells[i].{wx, wh, b, wp}``. The time
loop is a Python loop; its backward is ``torch.autograd``'s.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import init_dense


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


def lstm_logits(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens: (B, S) integer -> logits (B, S, V) in the parameter dtype."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()]                     # (B, S, P)
    xs = x.transpose(0, 1)                                 # (S, B, P)
    for li, cell in enumerate(params["cells"]):
        hp = x.new_zeros((b, cfg.lstm_proj))
        c = x.new_zeros((b, cfg.d_model))
        ys = []
        for t in range(s):
            hp, c = _cell(cell, xs[t], hp, c)
            ys.append(hp)
        ys = torch.stack(ys)
        xs = ys + xs if li > 0 else ys                     # residual after first layer
    out = xs.transpose(0, 1)                               # (B, S, P)
    return out @ params["head_w"] + params["head_b"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in fp32. logits: (B, S, V), labels: (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss_fn(params, batch, cfg):
    """(loss, metrics) of one worker's batch; dropout is off, as on the
    reference's training path."""
    loss = softmax_xent(lstm_logits(params, batch["tokens"], cfg),
                        batch["labels"])
    return loss, {"xent": loss, "aux": torch.zeros((), device=loss.device)}

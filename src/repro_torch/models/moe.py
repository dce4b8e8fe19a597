"""Mixture-of-Experts FFN: top-k router, expert capacity, dispatch by index.

The JAX package's ``models/moe.py``. Expert weights sit on a leading
expert axis (``w1``, ``w3``: (E, D, F); ``w2``: (E, F, D)) and the router
is float32 in a model of any dtype. A layer routes each token to its top_k
experts; each expert takes at most ``capacity`` (token, choice) pairs, in
token-major order with choice 0 before choice 1, and drops the rest.

The reference has two forms of the layer, picked by ``cfg.moe_group_tokens``:
a GShard one-hot einsum dispatch and a gather/scatter one. They compute the
same function, and the port computes both by index (the one-hot form's
(T, E, C) float32 einsums would cost 2·T²·k·cf·D operations each).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense, init_mlp, mlp_apply


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / fan_in) ** 0.5).to(dtype)

    p = {"router": init_dense(gen, d, e, scale=0.02, dtype=torch.float32,
                              device=device),
         "w1": experts((e, d, f), d),
         "w3": experts((e, d, f), d),
         "w2": experts((e, f, d), f)}
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, d, cfg.dense_d_ff, cfg.act, dtype, device)
    return p


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    return max(int(n_tokens * top_k * factor / n_experts), 4)


def _router(params, xt, cfg):
    """xt: (T, D). Returns (gate_vals, gate_idx, probs, pos, keep, cap):
    the (T, k) gates (renormalised over the k choices when k > 1, zero where
    dropped), expert ids and buffer positions, the (T, E) float32 router
    probabilities, the (T, k) kept mask and the capacity."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, e, k, cfg.capacity_factor)
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)   # (T,E)
    # lax.top_k: the larger first, the lower index first among ties
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    if k > 1:
        gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    flat = F.one_hot(gate_idx, e).reshape(t * k, e)                # (T*k,E)
    pos = torch.sum((torch.cumsum(flat, dim=0) - 1) * flat,
                    dim=-1).reshape(t, k)
    keep = pos < cap
    return gate_vals * keep, gate_idx, probs, pos, keep, cap


def _expert_ffn(params, xin, cfg):
    """xin: (E, C, D) -> (E, C, D), one product per expert."""
    h = torch.bmm(xin, params["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.bmm(xin, params["w3"])
    else:
        h = F.gelu(h, approximate="tanh")          # jax.nn.gelu's default
    return torch.bmm(h, params["w2"])


def _aux_loss(probs, gate_idx, cfg):
    """The load-balance loss: router_aux_loss · E · Σ_e frac_e · prob_e,
    frac counting every choice, dropped ones too."""
    e = cfg.n_experts
    frac = torch.mean(F.one_hot(gate_idx, e).float().sum(dim=1), dim=0)
    prob = torch.mean(probs, dim=0)
    return cfg.router_aux_loss * e * torch.sum(frac * prob)


def moe_apply(params, x, cfg):
    """x: (B, S, D) -> (out, aux_loss)."""
    if cfg.moe_group_tokens:
        return moe_apply_grouped(params, x, cfg)
    return moe_apply_einsum(params, x, cfg)


def moe_apply_grouped(params, x, cfg):
    """Gather each expert's tokens into an (E, C, D) buffer, run the experts,
    gather each kept (token, choice) output back and sum them, gate-weighted
    in float32."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    gate_vals, gate_idx, probs, pos, keep, cap = _router(params, xt, cfg)

    # the buffer slot of each (token, choice); dropped ones go to a sentinel
    # slot E·C that is sliced away, empty slots read token T: a zero row
    flat_slot = torch.where(keep, gate_idx * cap + pos, e * cap)   # (T,k)
    token_ids = torch.arange(t, device=x.device)[:, None].expand(t, k)
    buf_token = torch.full((e * cap + 1,), t, dtype=torch.long,
                           device=x.device)
    buf_token[flat_slot.reshape(-1)] = token_ids.reshape(-1)
    xt_fill = torch.cat([xt, xt.new_zeros((1, d))])
    xin = xt_fill[buf_token[:e * cap]].reshape(e, cap, d)
    eout = _expert_ffn(params, xin, cfg).reshape(e * cap, d)

    out_tk = eout[torch.where(keep, flat_slot, 0)]                 # (T,k,D)
    out = torch.sum(out_tk.float() * gate_vals[..., None], dim=1)
    out = out.to(x.dtype).reshape(b, s, d)
    if cfg.shared_expert:
        out = out + mlp_apply(params["shared"], x, cfg.act)
    return out, _aux_loss(probs, gate_idx, cfg)


def moe_apply_einsum(params, x, cfg):
    """The reference's GShard form, computed by index. Its dispatch tensor
    has at most one 1 in each (expert, slot), so its dispatch einsum is a
    gather; its combine sums at most top_k gate-weighted rows per token in
    float32. Both are what :func:`moe_apply_grouped` computes."""
    return moe_apply_grouped(params, x, cfg)

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

Capacity, queue positions and the load-balance fractions depend on the
whole batch. Where ranks split one model's batch (a synchronous or FSDP
run, ``launch/steps.py``), the caller passes the ranks' ``group`` and each
rank routes its rows as part of the whole batch, rank after rank, as the
reference's one program over the global batch does: the capacity counts
every rank's tokens, a rank's queue positions start after the lower ranks'
pairs, and the fractions count every rank's choices (one gather of the
per-expert counts a layer). A rank's expert buffers hold only its own
kept pairs. The group is an argument, not ambient state, so a
rematerialised layer recomputes the same routing wherever autograd runs
its backward (on CUDA, a thread of its own).

Under tensor parallelism (``tp``, a ``sharding.partition.TensorParallel``)
the experts split over ``model`` as their specs say (E / M a rank; the
router stays whole, so every rank routes the same tokens the same way):
a rank fills and runs only its experts' buffers, its combine is the
partial over its own experts' choices, and the partials are summed in
float32 in rank order and rounded once (at top_k ≤ 2 the terms that meet
are one or two, so the sum is the one-rank combine's bit for bit). The
load-balance loss comes from the replicated router, the same on every
rank. llama4's shared expert follows its specs, row-parallel in all
three of its matrices (its path holds ``moe``).
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


def _router(params, xt, cfg, group=None):
    """xt: (T, D). Returns (gate_vals, gate_idx, probs, slot, keep, size):
    the (T, k) gates (renormalised over the k choices when k > 1, zero where
    dropped), expert ids and positions in this rank's expert buffers, the
    (T, E) float32 router probabilities, the (T, k) kept mask and the
    buffers' length. Without ``group`` the buffers are the capacity long.
    With ``group`` (a ``core.comm.RankGroup`` whose ranks hold the batch's
    rows in rank order, each as many) a pair is kept where its position in
    the whole batch's queue is under the whole batch's capacity, and the
    buffers are as long as this rank's most kept pairs of one expert."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)   # (T,E)
    gate_vals, gate_idx = _top_k(probs, k)
    if k > 1:
        gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    flat = F.one_hot(gate_idx, e).reshape(t * k, e)                # (T*k,E)
    pos = torch.sum((torch.cumsum(flat, dim=0) - 1) * flat,
                    dim=-1).reshape(t, k)
    if group is None:
        size = _capacity(t, e, k, cfg.capacity_factor)
        keep = pos < size
    else:                         # after the lower ranks' pairs
        counts = _rank_counts(group, flat)                         # (R,E)
        offset = torch.sum(counts[:group.rank], dim=0)
        cap = _capacity(t * group.world, e, k, cfg.capacity_factor)
        keep = pos + offset[gate_idx] < cap
        kept = torch.clamp(torch.minimum(counts[group.rank], cap - offset),
                           min=0)
        size = max(int(torch.max(kept)), 1)
    return gate_vals * keep, gate_idx, probs, pos, keep, size


def _top_k(probs, k):
    """The k largest router probabilities of each token and their experts,
    as lax.top_k orders them: the larger first, the lower index first
    among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _rank_counts(group, onehot):
    """Every rank's count of (token, choice) pairs per expert, (R, E):
    one gather over ``group`` (counted in ``comm.side``)."""
    from repro_torch.core import comm
    (counts,) = group.all_gather([torch.sum(onehot, dim=0)],
                                 count=comm.side)
    return counts


def _expert_ffn(params, xin, cfg):
    """xin: (E, C, D) -> (E, C, D), one product per expert."""
    h = torch.bmm(xin, params["w1"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.bmm(xin, params["w3"])
    else:
        h = F.gelu(h, approximate="tanh")          # jax.nn.gelu's default
    return torch.bmm(h, params["w2"])


def _aux_loss(probs, gate_idx, cfg, group=None):
    """The load-balance loss: router_aux_loss · E · Σ_e frac_e · prob_e,
    frac counting every choice, dropped ones too. With ``group`` frac
    counts every rank's choices and prob is this rank's mean, so the
    ranks' mean loss is the whole batch's."""
    e = cfg.n_experts
    onehot = F.one_hot(gate_idx, e)
    if group is None:
        frac = torch.mean(onehot.float().sum(dim=1), dim=0)
    else:
        t = gate_idx.shape[0] * group.world
        frac = torch.sum(_rank_counts(group, onehot.sum(dim=1)),
                         dim=0).float() / t
    prob = torch.mean(probs, dim=0)
    return cfg.router_aux_loss * e * torch.sum(frac * prob)


def moe_apply(params, x, cfg, group=None, tp=None):
    """x: (B, S, D) -> (out, aux_loss). ``group``: the ranks whose rows
    make one batch with ``x``'s (module docstring); None: ``x`` is the
    batch. ``tp``: tensor parallelism, the experts over ``model``."""
    if cfg.moe_group_tokens:
        return moe_apply_grouped(params, x, cfg, group, tp)
    return moe_apply_einsum(params, x, cfg, group, tp)


def moe_apply_grouped(params, x, cfg, group=None, tp=None):
    """Gather each expert's tokens into an (E, C, D) buffer, run the experts,
    gather each kept (token, choice) output back and sum them, gate-weighted
    in float32. Under ``tp`` a rank's buffers are its experts' (module
    docstring)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    gate_vals, gate_idx, probs, slot, keep, size = _router(params, xt, cfg,
                                                           group)
    split = None
    if tp is not None:
        split = tp.split("w1", (e, d, cfg.d_ff), ("moe",))
        split = split if split.split else None
    lo, e_r, mine, w = 0, e, keep, gate_vals
    if split is not None:             # this rank's experts lo : lo + e_r
        from repro_torch.core.comm import tp_copy
        e_r = e // split.parts
        lo = split.index * e_r
        mine = keep & (gate_idx >= lo) & (gate_idx < lo + e_r)
        xt = tp_copy(xt, tp.group)
        w = tp_copy(gate_vals, tp.group) * mine

    # the buffer slot of each (token, choice); dropped ones (and under tp
    # the other ranks' choices) go to a sentinel slot E·C that is sliced
    # away, empty slots read token T: a zero row
    flat_slot = torch.where(mine, (gate_idx - lo) * size + slot,
                            e_r * size)                            # (T,k)
    token_ids = torch.arange(t, device=x.device)[:, None].expand(t, k)
    buf_token = torch.full((e_r * size + 1,), t, dtype=torch.long,
                           device=x.device)
    buf_token[flat_slot.reshape(-1)] = token_ids.reshape(-1)
    xt_fill = torch.cat([xt, xt.new_zeros((1, d))])
    xin = xt_fill[buf_token[:e_r * size]].reshape(e_r, size, d)
    eout = _expert_ffn(params, xin, cfg).reshape(e_r * size, d)

    out_tk = eout[torch.where(mine, flat_slot, 0)]                 # (T,k,D)
    out = torch.sum(out_tk.float() * w[..., None], dim=1).reshape(b, s, d)
    if split is not None:             # the ranks' partial combines
        out = tp.out_sum(out)
    elif tp is not None:
        out = tp.out_whole(out)
    out = out.to(x.dtype)
    if cfg.shared_expert:
        out = out + mlp_apply(params["shared"], x, cfg.act, tp,
                              cfg.dense_d_ff, ("moe", "shared"))
    return out, _aux_loss(probs, gate_idx, cfg, group)


def moe_apply_einsum(params, x, cfg, group=None, tp=None):
    """The reference's GShard form, computed by index. Its dispatch tensor
    has at most one 1 in each (expert, slot), so its dispatch einsum is a
    gather; its combine sums at most top_k gate-weighted rows per token in
    float32. Both are what :func:`moe_apply_grouped` computes."""
    return moe_apply_grouped(params, x, cfg, group, tp)

"""Mamba-2 (SSD, state-space duality) mixer — chunked scan + O(1) decode.

The JAX package's ``models/ssm.py``: within a chunk the recurrence is
evaluated in its dual "attention-like" quadratic form; across chunks the
(heads, state, head_dim) recurrent state is carried by a loop. With
``cfg.ssm_pallas`` the full-sequence forward without state goes through
the SSD chunk-scan kernel (``kernels/ssd_scan.py``); prefill, which needs
the last state, takes the chunked path, as in the JAX package. Decode is
the plain recurrence.

Under tensor parallelism (``tp``, a ``sharding.partition.TensorParallel``)
each rank holds its parts of the weights as their specs split them over
``model``: ``in_proj`` and ``conv_w`` by columns where shape-safety cuts
them (not at the z / x / B / C / dt boundaries), ``norm`` and ``out_proj``
by rows of ``d_inner``. Where those rows hold whole heads (the head count
divides by the TP size) a rank runs the SSM on its own heads: the
``in_proj`` product is gathered over ``model`` whole (its gradient summed
back over the ranks: ``tp_copy`` after ``tp_gather``), the conv runs on
the rank's x channels and the shared B and C, the SSD (the kernel under
``ssm_pallas``) on its heads, the gated RMSNorm's mean square is the sum
of the ranks' float32 partial sums, and ``out_proj`` is row-parallel. A
split inside a head runs the SSM whole on every rank from the gathered
parts. The decode state splits as the reference's ``cache_shardings``
says: the SSD state by heads, the conv tail by channels (gathered for the
step, each rank keeping its channels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.comm import tp_copy
from repro_torch.kernels.ref import ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import init_dense, rms_norm


def init_ssm(gen: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.n_ssm_heads
    proj_out = 2 * di + 2 * n + nh
    conv_w = torch.randn((cfg.ssm_conv, di + 2 * n), generator=gen,
                         dtype=torch.float32, device=device) * 0.1
    return {
        "in_proj": init_dense(gen, d, proj_out, dtype=dtype, device=device),
        "conv_w": conv_w.to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)).to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": init_dense(gen, di, d, dtype=dtype, device=device),
    }


def _split_proj(cfg, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv. xbc: (B,L,C); conv_w: (W,C). A sum of W shifted
    products in the parameter dtype, as the JAX package writes it (a
    ``conv1d`` would round otherwise in bf16, and run TF32 through cuDNN in
    fp32)."""
    w = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * conv_w[i] for i in range(w))
    return F.silu(out)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_forward(params, x, cfg, *, return_state: bool = False, tp=None):
    """Full-sequence SSD. x: (B,L,D); L is padded to a multiple of the chunk.
    Returns out (B,L,D), and with ``return_state`` also (S_last, conv_tail)
    (under ``tp`` this rank's parts of them, as the cache splits them)."""
    b, L, _ = x.shape
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    c = cfg.ssm_chunk
    pad = (-L) % c
    split_in, _, conv_w, by_heads, h0, nh_r = _tp_weights(params, cfg, tp)
    zxbcdt = _tp_project(params, x, split_in, tp, grad_sum=by_heads)
    if by_heads:
        conv_w = tp_copy(conv_w, tp.group)
    z, xbc_all, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(_rank_channels(xbc_all, cfg, h0, nh_r),
                       _rank_channels(conv_w, cfg, h0, nh_r))
    z = z[..., h0 * hd:(h0 + nh_r) * hd]
    dt = dt[..., h0:h0 + nh_r]
    if pad:
        z, xbc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (z, xbc, dt))
    Lp = L + pad
    nz = Lp // c
    dr = nh_r * hd

    A_log, D, dt_bias = _head_vectors(params, tp, by_heads, h0, nh_r)
    xs = xbc[..., :dr].reshape(b, nz, c, nh_r, hd).float()
    Bm = xbc[..., dr:dr + n].reshape(b, nz, c, n).float()
    Cm = xbc[..., dr + n:].reshape(b, nz, c, n).float()
    dt = _softplus(dt.float() + dt_bias.float())                  # (B,Lp,nh)
    dt = dt.reshape(b, nz, c, nh_r)
    dA = dt * -torch.exp(A_log.float())                            # (B,nz,c,nh)

    xbar = xs * dt[..., None]                                      # (B,nz,c,nh,hd)
    if cfg.ssm_pallas and not return_state:
        # the kernel, on this rank's heads under tp
        y, S_last = ssd_scan(xbar, Bm, Cm, dA), None
    else:
        y, S_last = ssd_chunked(xbar, Bm, Cm, dA)
    y = y + D.float()[None, None, None, :, None] * xs
    y = y.reshape(b, Lp, dr)[:, :L]
    y = _tp_gated_norm(y, z[:, :L].to(x.dtype), _tp_norm_weight(
        params, cfg, tp, by_heads), cfg, tp, by_heads)
    out = _tp_out(y, params, cfg, tp, by_heads)
    if not return_state:
        return out
    if tp is None:
        return out, (S_last, _conv_tail(x, params, cfg))
    w = cfg.ssm_conv
    tail = xbc_all[:, -(w - 1):]
    if tail.shape[1] < w - 1:
        tail = F.pad(tail, (0, 0, w - 1 - tail.shape[1], 0))
    return out, (S_last, tp.cache_split(tail.shape, 2).take(tail))


def _conv_tail(x, params, cfg):
    """Last (W-1) pre-conv channel rows, for decode continuation."""
    w = params["conv_w"].shape[0]
    zxbcdt = x[:, -(w - 1):] @ params["in_proj"]
    _, xbc, _ = _split_proj(cfg, zxbcdt)
    pad = (w - 1) - xbc.shape[1]
    if pad > 0:
        xbc = F.pad(xbc, (0, 0, pad, 0))
    return xbc


def init_ssm_state(cfg, batch, dtype=torch.float32, device="cpu"):
    nh, n, hd = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    return (
        torch.zeros((batch, nh, n, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                    dtype=dtype, device=device),
    )


def ssm_decode_step(params, x, state, cfg, tp=None):
    """One-token recurrence. x: (B,1,D); state: (S, conv_tail), under ``tp``
    this rank's part of them as the cache splits them (S by heads, the
    tail by channels). The split ones of the ``in_proj`` columns, the
    tail's channels and the conv weight's are gathered over ``model`` in
    one collective; the rank keeps its part of the new tail."""
    from repro_torch.core import comm
    S, tail = state
    b = x.shape[0]
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    w = cfg.ssm_conv
    split_in, split_conv, conv_w, by_heads, h0, nh_r = _tp_weights(
        params, cfg, tp, gather_conv=False)
    split_tail = (None if tp is None
                  else tp.cache_split((b, w - 1, di + 2 * n), 2))
    zxbcdt = x[:, 0] @ params["in_proj"]                           # (B, P)
    parts = {k: t for k, t, sp in (("zx", zxbcdt, split_in),
                                   ("tail", tail, split_tail),
                                   ("conv", conv_w, split_conv))
             if sp is not None and sp.split}
    if parts:
        got = tp.group.all_gather(list(parts.values()), count=comm.tp)
        whole = {k: torch.cat(rows.unbind(0), dim=-1)
                 for k, rows in zip(parts, got)}
        zxbcdt = whole.get("zx", zxbcdt)
        tail = whole.get("tail", tail)
        conv_w = whole.get("conv", conv_w)
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)
    window = torch.cat([tail, xbc_new[:, None]], dim=1)           # (B,W,C)
    xbc = F.silu(torch.einsum(
        "bwc,wc->bc", _rank_channels(window, cfg, h0, nh_r),
        _rank_channels(conv_w, cfg, h0, nh_r)))
    new_tail = window[:, 1:]
    if split_tail is not None:
        new_tail = split_tail.take(new_tail)

    dr = nh_r * hd
    A_log, D, dt_bias = _head_vectors(params, tp, by_heads, h0, nh_r)
    xs = xbc[:, :dr].reshape(b, nh_r, hd).float()
    Bm = xbc[:, dr:dr + n].float()
    Cm = xbc[:, dr + n:].float()
    dt = _softplus(dt[:, h0:h0 + nh_r].float() + dt_bias.float())
    dA = torch.exp(dt * -torch.exp(A_log.float()))                 # (B,nh)
    # the outer product Bm ⊗ (dt·xs), the JAX package's 3-operand einsum
    # "bn,bh,bhp->bhnp" without one: torch.einsum would ask opt_einsum for a
    # contraction path on every call, a host cost of each layer's step
    S = S * dA[..., None, None] + Bm[:, None, :, None] * (
        dt[..., None] * xs)[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", Cm, S)
    y = y + D.float()[None, :, None] * xs
    y = _tp_gated_norm(y.reshape(b, dr), z[:, h0 * hd:(h0 + nh_r) * hd],
                       _tp_norm_weight(params, cfg, tp, by_heads), cfg, tp,
                       by_heads)
    out = _tp_out(y, params, cfg, tp, by_heads)[:, None]
    return out, (S, new_tail)


# --------------------------------------------------------------------------- #
# tensor parallelism over model (each helper is the one-rank operation
# under tp=None)
# --------------------------------------------------------------------------- #
def _tp_weights(params, cfg, tp, gather_conv: bool = True):
    """The ``in_proj`` split, the conv weight's split and the weight
    (gathered whole with ``gather_conv``), and the rank's share of the
    heads: ``(split_in, split_conv, conv_w, by_heads, h0, nh_r)``. With
    ``by_heads`` the rank runs heads ``h0 : h0 + nh_r`` (its rows of
    ``norm`` and ``out_proj``); else every head, on the weights
    gathered. Under ``tp=None`` no split, every head."""
    from repro_torch.core.comm import tp_gather
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    if tp is None:
        return None, None, params["conv_w"], False, 0, nh
    proj = 2 * di + 2 * n + nh
    split_in = tp.split("in_proj", (d, proj))
    split_conv = tp.split("conv_w", (cfg.ssm_conv, di + 2 * n))
    conv_w = params["conv_w"]
    if split_conv.split and gather_conv:
        conv_w = tp_gather(conv_w, tp.group)
    by_heads = tp.split("out_proj", (di, d)).split and nh % tp.size == 0
    if by_heads:
        return (split_in, split_conv, conv_w, True,
                tp.rank * (nh // tp.size), nh // tp.size)
    return split_in, split_conv, conv_w, False, 0, nh


def _tp_project(params, x, split_in, tp, grad_sum: bool):
    """``x @ in_proj`` whole on every rank: the rank's columns gathered
    over ``model`` where the weight splits. ``grad_sum``: the product
    enters rank-specific work, so its gradient is summed over the ranks
    before each takes its columns' (``tp_copy`` after ``tp_gather``)."""
    from repro_torch.core.comm import tp_gather
    if split_in is not None and split_in.split:
        out = tp_gather(tp_copy(x, tp.group) @ params["in_proj"], tp.group)
    else:
        out = x @ params["in_proj"]
    return tp_copy(out, tp.group) if grad_sum else out


def _tp_gated_norm(y, z, w, cfg, tp, by_heads: bool):
    """The gated RMSNorm of y (this rank's channels) by silu(z): the mean
    square over the whole ``d_inner`` the sum of the ranks' float32 sums
    of squares (rank order) where the channels split, its gradient summed
    back over the ranks."""
    from repro_torch.core.comm import tp_sum
    y = (y * F.silu(z.float())).to(z.dtype)
    if not by_heads:
        return rms_norm(y, w, cfg.norm_eps)
    y32 = y.float()
    ss = torch.sum(torch.square(y32), dim=-1, keepdim=True)
    var = tp_copy(tp_sum(ss, tp.group, tp.sum_log), tp.group) / cfg.d_inner
    return (y32 * torch.rsqrt(var + cfg.norm_eps) * w.float()).to(y.dtype)


def _tp_out(y, params, cfg, tp, by_heads: bool):
    """``out_proj``: row-parallel over the rank's heads, or the whole
    weight (gathered where split) on every rank's whole y. The partial
    products are taken in float32 and summed in rank order, so the output
    is rounded once to y's dtype, as one rank's product is (a bf16 GEMM
    would round each partial first). Under ``tp.seq`` the output is this
    rank's slice of the sequence."""
    from repro_torch.core.comm import tp_gather
    if by_heads:
        part = y.float() @ params["out_proj"].float()
        return tp.out_sum(part).to(y.dtype)
    w = params["out_proj"]
    if tp is None:
        return y @ w
    if tp.split("out_proj", (cfg.d_inner, cfg.d_model)).split:
        w = tp_gather(w, tp.group, 0)
    return tp.out_whole(y @ w)


def _tp_norm_weight(params, cfg, tp, by_heads: bool):
    from repro_torch.core.comm import tp_gather
    w = params["norm"]
    if tp is not None and not by_heads and tp.split("norm", (cfg.d_inner,)).split:
        w = tp_gather(w, tp.group)
    return w


def _head_vectors(params, tp, by_heads: bool, h0: int, nh_r: int):
    """A_log, D and dt_bias (whole leaves) at the rank's heads; their
    gradient summed over ``model`` where the rank takes a share."""
    if not by_heads:
        return params["A_log"], params["D"], params["dt_bias"]
    vec = torch.stack([params["A_log"], params["D"], params["dt_bias"]])
    return tp_copy(vec, tp.group)[:, h0:h0 + nh_r].unbind(0)


def _rank_channels(t, cfg, h0: int, nh_r: int):
    """The rank's x channels and the shared B, C channels of a tensor over
    the conv's ``d_inner + 2N`` channels (its last dimension)."""
    hd, di = cfg.ssm_head_dim, cfg.d_inner
    if nh_r == cfg.n_ssm_heads:
        return t
    return torch.cat([t[..., h0 * hd:(h0 + nh_r) * hd], t[..., di:]], -1)

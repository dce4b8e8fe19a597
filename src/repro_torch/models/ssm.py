"""Mamba-2 (SSD, state-space duality) mixer — chunked scan + O(1) decode.

The JAX package's ``models/ssm.py``: within a chunk the recurrence is
evaluated in its dual "attention-like" quadratic form; across chunks the
(heads, state, head_dim) recurrent state is carried by a loop. With
``cfg.ssm_pallas`` the full-sequence forward without state goes through
the SSD chunk-scan kernel (``kernels/ssd_scan.py``); prefill, which needs
the last state, takes the chunked path, as in the JAX package. Decode is
the plain recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def ssm_forward(params, x, cfg, *, return_state: bool = False):
    """Full-sequence SSD. x: (B,L,D); L is padded to a multiple of the chunk.
    Returns out (B,L,D), and with ``return_state`` also (S_last, conv_tail)."""
    b, L, _ = x.shape
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    c = cfg.ssm_chunk
    pad = (-L) % c
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, params["conv_w"])
    if pad:
        z, xbc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (z, xbc, dt))
    Lp = L + pad
    nz = Lp // c

    xs = xbc[..., :di].reshape(b, nz, c, nh, hd).float()
    Bm = xbc[..., di:di + n].reshape(b, nz, c, n).float()
    Cm = xbc[..., di + n:].reshape(b, nz, c, n).float()
    dt = _softplus(dt.float() + params["dt_bias"].float())         # (B,Lp,nh)
    dt = dt.reshape(b, nz, c, nh)
    A = -torch.exp(params["A_log"].float())                        # (nh,)
    dA = dt * A                                                    # (B,nz,c,nh)

    xbar = xs * dt[..., None]                                      # (B,nz,c,nh,hd)
    if cfg.ssm_pallas and not return_state:
        y = ssd_scan(xbar, Bm, Cm, dA)
        S_last = None
    else:
        y, S_last = ssd_chunked(xbar, Bm, Cm, dA)
    y = y + params["D"].float()[None, None, None, :, None] * xs
    y = y.reshape(b, Lp, di)[:, :L]
    z = z[:, :L]
    y = y * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, (S_last, _conv_tail(x, params, cfg))
    return out


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


def ssm_decode_step(params, x, state, cfg):
    """One-token recurrence. x: (B,1,D); state: (S, conv_tail)."""
    S, conv_tail = state
    b = x.shape[0]
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    zxbcdt = x[:, 0] @ params["in_proj"]                           # (B, P)
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)
    window = torch.cat([conv_tail, xbc_new[:, None]], dim=1)       # (B,W,C)
    xbc = F.silu(torch.einsum("bwc,wc->bc", window, params["conv_w"]))
    new_tail = window[:, 1:]

    xs = xbc[:, :di].reshape(b, nh, hd).float()
    Bm = xbc[:, di:di + n].float()
    Cm = xbc[:, di + n:].float()
    dt = _softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt * A)                                         # (B,nh)
    # the outer product Bm ⊗ (dt·xs), the JAX package's 3-operand einsum
    # "bn,bh,bhp->bhnp" without one: torch.einsum would ask opt_einsum for a
    # contraction path on every call, a host cost of each layer's step
    S = S * dA[..., None, None] + Bm[:, None, :, None] * (
        dt[..., None] * xs)[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", Cm, S)
    y = y + params["D"].float()[None, :, None] * xs
    y = y.reshape(b, di)
    y = y * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), params["norm"], cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None]
    return out, (S, new_tail)

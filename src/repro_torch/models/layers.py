"""Shared building blocks (the JAX package's ``models/layers.py``): the
dense initialiser, RMSNorm, the MLPs, RoPE and dropout."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_dense(gen: torch.Generator, d_in: int, d_out: int, scale=None,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """N(0, scale²) weights of shape (d_in, d_out), scale 1/sqrt(d_in) by
    default, drawn in float32 and cast."""
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """x·rsqrt(mean(x²) + eps)·w in float32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def swiglu(x, w1, w3, w2):
    """SwiGLU MLP: (silu(x@w1) * (x@w3)) @ w2. w1, w3: (D,F); w2: (F,D)."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def gelu_mlp(x, w1, w2):
    """``jax.nn.gelu`` defaults to the tanh approximation; so does this."""
    return F.gelu(x @ w1, approximate="tanh") @ w2


def mlp_apply(params, x, act: str):
    if act == "swiglu":
        return swiglu(x, params["w1"], params["w3"], params["w2"])
    if act == "gelu":
        return gelu_mlp(x, params["w1"], params["w2"])
    return F.relu(x @ params["w1"]) @ params["w2"]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.float32, device="cpu"):
    if act == "swiglu":
        return {"w1": init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
                "w3": init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
                "w2": init_dense(gen, d_ff, d_model, dtype=dtype, device=device)}
    return {"w1": init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
            "w2": init_dense(gen, d_ff, d_model, dtype=dtype, device=device)}


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """1 / theta^(2i / head_dim) for i < head_dim / 2, rounded to float32.

    Taken in float64: XLA's float32 power rounds these correctly and
    PyTorch's does not (an ulp off on a third of them), and an ulp of a
    frequency is ~1e-4 of an angle at position 3000."""
    ex = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return (1.0 / theta ** (ex / head_dim)).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The head is
    split in halves (not interleaved pairs) and rotated in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dropout(gen, x: torch.Tensor, rate: float, deterministic: bool):
    """Keep each element with probability 1 - rate, drawn from the
    ``torch.Generator`` ``gen``, as x / (1 - rate); zero elsewhere. 1 - rate
    is rounded to x's dtype first, as JAX's weak-typed scalar is."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    kept = x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, kept, torch.zeros_like(x))

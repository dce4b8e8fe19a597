"""Shared building blocks (the JAX package's ``models/layers.py``): the
dense initialiser and RMSNorm. The MLPs and RoPE come with the transformer
families (ROADMAP Queue 1 item 10)."""
from __future__ import annotations

import torch


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

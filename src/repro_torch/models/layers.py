"""Shared building blocks (the JAX package's ``models/layers.py``): the
dense initialiser, RMSNorm, the MLPs, RoPE and dropout; and the
tensor-parallel product :func:`tp_linear` and lookup :func:`tp_embed`,
which the layers take under a ``sharding.partition.TensorParallel``."""
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


def _act(h1, h3, act: str):
    if act == "swiglu":
        return F.silu(h1) * h3
    if act == "gelu":
        return F.gelu(h1, approximate="tanh")
    return F.relu(h1)


def mlp_apply(params, x, act: str, tp=None, d_ff: int = 0, path=()):
    """The block's MLP; under ``tp`` (a ``TensorParallel``; ``d_ff`` the
    whole width) each weight split as its spec says (``path``: the keys
    above the MLP its specs read, ``("moe", "shared")`` for llama4's
    shared expert, whose three matrices split along their first
    dimension): ``w1``/``w3`` column-split (or row-split, their partials
    summed) and ``w2`` row-split, each whole where shape-safety leaves it
    so: the output is the same on every rank."""
    if tp is None:
        if act == "swiglu":
            return swiglu(x, params["w1"], params["w3"], params["w2"])
        if act == "gelu":
            return gelu_mlp(x, params["w1"], params["w2"])
        return F.relu(x @ params["w1"]) @ params["w2"]
    from repro_torch.core.comm import tp_copy, tp_gather
    d = x.shape[-1]
    names = ("w1", "w3") if act == "swiglu" else ("w1",)
    splits = [tp.split(n, (d, d_ff), path) for n in names]
    xc = tp_copy(x, tp.group) if any(sp.split for sp in splits) else None
    hs = [tp_linear(x, params[n], sp, tp, xc=xc)
          for n, sp in zip(names, splits)]
    if len({part for _, part in hs}) > 1:      # one whole, one split
        hs = [(tp_gather(h, tp.group) if part else h, False)
              for h, part in hs]
    a = _act(hs[0][0], hs[-1][0], act)
    out, _ = tp_linear(a, params["w2"], tp.split("w2", (d_ff, d), path), tp,
                       x_part=hs[0][1], final=True)
    return out


def tp_linear(x, w, split, tp, *, x_part: bool = False, xc=None,
              final: bool = False):
    """``x @ w`` where ``w`` is this rank's part of a weight split as
    ``split`` (a ``sharding.specs.LeafSplit`` of the whole (d_in, d_out)
    weight) over ``tp``'s ranks, and ``x`` is the same on every rank, or
    with ``x_part`` split along its last dimension as a column-split
    product leaves it. ``xc``: ``core.comm.tp_copy(x)``, where the caller
    made one for several products. Returns ``(y, y_part)``:

    * ``w`` whole: ``x`` gathered first if split; ``y`` whole;
    * column-split: ``x`` gathered first if split; ``y`` split;
    * row-split: ``x`` split the same way (this rank's slice of a whole
      ``x``), and ``y`` the partial products summed over the ranks
      (``core.comm.tp_sum``: float32, rank order, rounded once).

    A whole ``x`` enters rank-specific work through ``tp_copy``, which
    sums its gradient over the ranks, so every rank's gradient of it is
    the whole one (and the same bits). ``final``: the product is a
    sub-layer's output, whole (a split ``y`` gathered), and under
    sequence parallelism (``tp.seq``) this rank's slice of its sequence:
    the row-parallel sum reduce-scattered (``TensorParallel.out_sum``),
    a whole product cut (``TensorParallel.out_whole``)."""
    from repro_torch.core.comm import tp_copy, tp_gather, tp_sum
    row = split.split and split.dim == 0
    if x_part and not row:
        x, xc = tp_gather(x, tp.group), None
    if not split.split:
        return (tp.out_whole(x @ w) if final else x @ w), False
    xc = xc if xc is not None else tp_copy(x, tp.group)
    if not row:
        if final:
            return tp.out_whole(tp_gather(xc @ w, tp.group)), False
        return xc @ w, True
    if not x_part:
        x = xc.narrow(-1, split.index * w.shape[0], w.shape[0])
    elif x.shape[-1] != w.shape[0]:
        raise ValueError(f"a part of {x.shape[-1]} against rows "
                         f"{w.shape[0]} of a row-split weight")
    if final:
        return tp.out_sum(x @ w), False
    return tp_sum(x @ w, tp.group, tp.sum_log), False


def tp_embed(embed, tokens, split, tp):
    """``embed[tokens]`` from this rank's rows of a vocab-split table: the
    rank looks up the tokens it holds, the others as zeros, and the
    lookups are summed over the ranks (one nonzero term an element: the
    whole table's rows, bit for bit). ``embed`` whole: the plain lookup.
    Under sequence parallelism (``tp.seq``) this rank's slice of the
    sequence (dimension 1) of the lookups."""
    if tp is None:
        return embed[tokens.long()]
    if not split.split:
        return tp.out_whole(embed[tokens.long()])
    n = embed.shape[0]
    local = tokens.long() - split.index * n
    mine = (local >= 0) & (local < n)
    rows = embed[torch.clamp(local, 0, n - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return tp.out_sum(rows)


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

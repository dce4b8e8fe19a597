"""Weights, optimizer state and decode caches carried between the JAX
package and the port.

The JAX side is given as nested dicts/lists/tuples of NumPy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, (params, opt_state))``). bfloat16
arrays cross as 16-bit integer views, as the JAX package's checkpoints
store them, so the port needs neither JAX nor ``ml_dtypes``. Integer
leaves are the optimizer's step counters, which the port keeps on the host.
A flat train state (``--flat``: fp32 planes and integer counters, laid out
by ``core/flatspace.py`` as the JAX package lays them out) crosses as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if not t.is_floating_point():
        return t
    return t.to(device)


def to_torch(tree, device="cpu"):
    """NumPy leaves (bf16 included) -> tensors on ``device``; integer
    leaves (step counters) stay on the CPU."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def _leaf_to_numpy(t: torch.Tensor, bf16):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(bf16)
    return t.numpy()


def to_numpy(tree, bf16=np.uint16):
    """Tensors -> NumPy arrays. bfloat16 leaves come back as a 16-bit view
    of dtype ``bf16``: pass ``ml_dtypes.bfloat16`` (JAX's bfloat16) to get
    the JAX package's own arrays back."""
    return tree_map(lambda t: _leaf_to_numpy(t, bf16), tree)

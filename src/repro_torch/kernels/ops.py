"""The fused AdaAlter update applied across a whole parameter tree.

One launch per stacked leaf, covering all R workers at once, as the JAX
package's ``kernels/ops.py::tree_fused_update`` does.
"""
from __future__ import annotations

from repro_torch import tree
from repro_torch.kernels.adaalter_update import fused_update


def tree_fused_update(params, grads, b2_sync, b2_local, scalars):
    """Apply the fused update leafwise. Returns (new_params, new_b2_local)."""
    pairs = tree.tree_map(
        lambda p, g, bs, bl: fused_update(p, g, bs, bl, scalars),
        params, grads, b2_sync, b2_local)
    return (tree.tree_map(lambda _, pr: pr[0], params, pairs),
            tree.tree_map(lambda _, pr: pr[1], params, pairs))

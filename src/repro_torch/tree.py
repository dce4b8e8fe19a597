"""Nested dicts and lists of tensors, walked in the JAX package's leaf order.

Parameters and optimizer state are plain nested dicts/lists of tensors laid
out like the JAX pytrees. Dict keys are visited in sorted order and lists
in index order, as ``jax.tree_util`` does, so the port's per-leaf loops
(and the fp32 sums over leaves) run in the same order as the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree``, in sorted-key / index order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise to ``tree`` and the same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, flat: List[Any]):
    """Inverse of :func:`leaves`: ``flat`` poured into ``tree``'s structure."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def paths(tree, prefix=()) -> List[tuple]:
    """The path of every leaf of ``tree``, in :func:`leaves` order: dict
    keys as themselves, list indices as ``"[i]"`` (the JAX package's
    ``sharding/specs.py`` names)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k],
                                                       prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in paths(t, prefix + (f"[{i}]",))]
    return [prefix]

"""Checkpoint store: flat-key npz payload + JSON manifest.

The on-disk format of the JAX package's ``checkpoint/store.py``, so a
checkpoint written by either package restores in the other:

* ``step_<n>/arrays.npz`` holds one array per leaf, keyed by its path in
  the state tree: dict keys by name (in sorted order), sequence indices as
  ``#i``, dataclass fields (``SyncState``) by name, joined by ``/``. The
  train state ``(params, opt_state, SyncState)`` gives ``#0/...``,
  ``#1/...`` and ``#2/since``, ``#2/drift``;
* bfloat16 arrays are stored as their uint16 bit patterns and
  ``manifest.json`` names the true dtype (``"bfloat16"``), since NumPy has
  no bfloat16; the port reads them back through 16-bit integer views, with
  neither JAX nor ``ml_dtypes``;
* ``manifest.json`` also lists the sorted keys and each shape.
  ``"treedef"`` is informational: nothing reads it, and the port writes its
  own description of the tree there;
* a checkpoint is written to ``step_<n>.tmp`` and renamed, so a crash
  mid-write never leaves a partial ``step_<n>``;
* the npz is written with fixed zip timestamps, so the same state gives
  the same bytes: a run with one worker a rank writes the files of the
  stacked run of as many workers.

Leaves are tensors (restored with the template's dtype, on its device, or
on the CPU for a ``meta`` template) or NumPy arrays (the ``SyncState``
scalars, restored as NumPy).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "/"
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP = ".tmp"


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple)) or (
        dataclasses.is_dataclass(tree) and not isinstance(tree, type))


def _children(tree) -> Iterator[Tuple[str, Any]]:
    """(key part, child) in the JAX package's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield str(k), tree[k]
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield f"#{i}", t
    else:
        for f in dataclasses.fields(tree):
            yield f.name, getattr(tree, f.name)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path key: leaf}, in leaf order."""
    if not _is_node(tree):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for part, child in _children(tree):
        out.update(_flatten(child, prefix + _SEP + part if prefix else part))
    return out


def _rebuild(tree, values: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with every leaf replaced by ``values[key]``."""
    if not _is_node(tree):
        return values[prefix]

    def sub(part, child):
        return _rebuild(child, values, prefix + _SEP + part if prefix
                        else part)

    if isinstance(tree, dict):
        return {k: sub(str(k), v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(f"#{i}", t) for i, t in enumerate(tree))
    return dataclasses.replace(tree, **{
        f.name: sub(f.name, getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


def _describe(tree) -> str:
    """A short description of the tree's structure (leaves as ``*``)."""
    if not _is_node(tree):
        return "*"
    inner = ", ".join(f"{k}: {_describe(c)}" for k, c in _children(tree))
    if isinstance(tree, dict):
        return "{" + inner + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + inner + "]"
    return f"{type(tree).__name__}({inner})"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, true dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(leaf)
    return a, a.dtype.name


def _step_dir(directory: str, step: Optional[int]) -> Tuple[str, int]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory!r}")
    return os.path.join(directory, f"step_{step}"), step


def _manifest(directory: str, step: Optional[int]) -> Dict[str, Any]:
    path, _ = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` with a fixed timestamp on every member (np.load and
    the JAX package read it as any npz)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            info = zipfile.ZipInfo(key + ".npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write ``state`` (a tree of tensors and NumPy arrays) as checkpoint
    ``step``, replacing one of the same step. Returns its path."""
    os.makedirs(directory, exist_ok=True)
    arrays, true_dtypes = {}, {}
    for k, leaf in _flatten(state).items():
        arrays[k], true_dtypes[k] = _to_numpy(leaf)
    path = os.path.join(directory, f"step_{step}")
    tmp = path + _TMP
    os.makedirs(tmp, exist_ok=True)
    _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
    manifest = {
        "step": step,
        "treedef": "repro_torch " + _describe(state),
        "keys": sorted(arrays),
        "dtypes": true_dtypes,
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def checkpoint_keys(directory: str, *, step: Optional[int] = None
                    ) -> Tuple[str, ...]:
    """The leaf keys of a saved checkpoint, from its manifest (the arrays
    are not read): lets a caller pick the restore template that matches
    what is on disk."""
    return tuple(_manifest(directory, step)["keys"])


def checkpoint_layout(directory: str, *, step: Optional[int] = None) -> str:
    """``'flat'`` (the params are one packed plane, a bare ``#0`` key) or
    ``'per_leaf'`` (``#0/...`` subtree keys)."""
    from repro_torch.core.flatspace import is_flat_checkpoint
    return ("flat" if is_flat_checkpoint(checkpoint_keys(directory,
                                                         step=step))
            else "per_leaf")


def disk_like(directory: str, like: Any, *, step: Optional[int] = None) -> Any:
    """``like`` with every leaf's shape replaced by the manifest's (dtype
    kept; tensors on the ``meta`` device): the restore template of a flat
    plane written under another worker or shard count, which
    ``core.flatspace.adapt_flat_state`` then reshapes. Keys must match."""
    shapes = _manifest(directory, step)["shapes"]
    flat_like = _flatten(like)
    missing = set(flat_like) - set(shapes)
    if missing:
        raise ValueError(f"checkpoint/state mismatch: missing="
                         f"{sorted(missing)[:5]}")

    def one(key, leaf):
        shape = tuple(shapes[key])
        if isinstance(leaf, torch.Tensor):
            return torch.empty(shape, dtype=leaf.dtype, device="meta")
        return np.zeros(shape, np.asarray(leaf).dtype)

    return _rebuild(like, {k: one(k, v) for k, v in flat_like.items()})


def _from_stored(arr: np.ndarray, name: str, want) -> Any:
    """A stored array as a leaf like ``want``."""
    if isinstance(want, torch.Tensor):      # ``arr`` is a fresh array
        if name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.view(np.dtype(name)))
        device = torch.device("cpu") if want.device.type == "meta" \
            else want.device
        return t.to(device=device, dtype=want.dtype)
    want = np.asarray(want)
    if name == "bfloat16":
        raise TypeError("a bfloat16 array restores into a tensor template")
    return arr.view(np.dtype(name)).astype(want.dtype)


def restore_checkpoint(directory: str, like: Any, *,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a live state or a ``meta``
    template). Returns (state, step). Raises FileNotFoundError if no
    checkpoint exists, ValueError if keys or shapes differ."""
    path, step = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(like)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        stored = set(z.files)
        missing = set(flat_like) - stored
        extra = stored - set(flat_like)
        if missing or extra:
            raise ValueError(
                f"checkpoint/state mismatch: missing={sorted(missing)[:5]} "
                f"extra={sorted(extra)[:5]}")
        values = {}
        for key, want in flat_like.items():
            arr = z[key]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"{key}: shape {arr.shape} != expected "
                                 f"{tuple(want.shape)}")
            values[key] = _from_stored(arr, manifest["dtypes"][key], want)
            del arr
    return _rebuild(like, values), step

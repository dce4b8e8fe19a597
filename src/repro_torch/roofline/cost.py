"""The cost of one call, from a walk of the aten ops it dispatches.

The counterpart of the JAX package's ``roofline/hlo_cost.py``, which walks
a compiled program's HLO text. The port has no compiler and no HLO: it runs
the program itself, on ``meta`` tensors (nothing is computed or
allocated) or on the card, under a ``TorchDispatchMode`` that sees every
aten op below autograd, the backward's included. :func:`step_cost`
returns a :class:`StepCost`:

  * **FLOPs**, by ``hlo_cost.py``'s rules: a matrix product is 2 · output
    elements · contracted size (``torch.utils.flop_counter``'s formulas);
    an elementwise op one an output element, a reduction one an input
    element; copies, casts, gathers, comparisons and selects none;
  * **bytes**: each op's inputs read and outputs written (a broadcast
    input no more than its storage; a gather its rows, not its table).
    Views, reshapes and aliases, and empty allocations, are charged
    nothing;
  * **collectives** by kind, count and output bytes, and the bytes of
    those that cross pods, charged by ``core/comm.py::RankGroup`` at its
    two calls that move data (``charges.charge_collective``), on a real
    group and on a ``DryGroup`` alike;
  * **kernels**: a hand-written kernel's launch is a ctypes call, not an
    aten op, so each wrapper charges its kernel's cost function
    (``charges.kernel_call``), where it launches on the card and on its
    ``meta`` route, which launches nothing;
  * **the peak of live bytes**: the storages alive at each op, those of
    the arguments included (a view adds nothing; a storage leaves when its
    last tensor, a saved one included, is freed).

:func:`region_table` gives the reference's JSON table of a call: one
region per kernel, one per collective kind and one per aten op over the
rest (``trip``: its count); the regions sum to the totals.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import charges

#: the reference's collective kinds (``hlo_cost.COLLECTIVES``); the port
#: issues all-gathers and all-to-alls
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

# ops that compute nothing (hlo_cost.py's _ZERO_FLOP_OPS, in aten's names)
_ZERO_FLOPS = frozenset({
    "copy_", "_to_copy", "clone", "contiguous", "cat", "stack", "_copy_from",
    "index_select", "gather", "scatter", "scatter_", "index", "index_put",
    "index_put_", "embedding", "embedding_dense_backward", "constant_pad_nd",
    "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_not", "logical_and",
    "logical_or", "clamp", "clamp_min", "clamp_max", "masked_fill",
    "masked_fill_", "fill_", "zero_", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "fill", "arange", "tril", "triu",
    "roll", "flip", "repeat", "expand_copy", "slice_scatter",
    "select_scatter", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "lift_fresh_copy", "_local_scalar_dense", "sort", "argsort", "topk",
    "bitwise_and", "bitwise_or", "bitwise_not", "isnan", "isinf", "sign",
    "nonzero", "unique", "rand", "randn", "uniform_", "normal_", "bernoulli_",
    "split_with_sizes_copy", "unbind_copy", "_index_put_impl_", "one_hot",
})
# ops whose first argument is written, never read
_WRITE_ONLY_FIRST = frozenset({"copy_", "fill_", "zero_", "uniform_",
                               "normal_", "bernoulli_", "_copy_from"})
# ops that only allocate
_ALLOC_ONLY = frozenset({"empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided", "resize_",
                         "set_", "_pin_memory", "record_stream"})
# ops that read a table's rows: output bytes read, output bytes written,
# and the index
_GATHERS = frozenset({"embedding", "index_select", "gather", "index"})
# reductions: one operation an input element
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "argmax", "argmin", "all", "any", "count_nonzero", "aminmax",
})
# namespaces whose ops a walk does not see (collectives are charged at
# the group's calls; the profiler's marks move nothing)
_SKIP_NS = ("c10d", "_c10d_functional", "profiler", "_c10d")


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    and outputs, a call's arguments), in order."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its elements, or its storage where
    broadcasting repeats them."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _shape_dims(t) -> List[int]:
    return list(t.shape) if isinstance(t, torch.Tensor) else []


def _extra_flops(name: str, args, out) -> Optional[float]:
    """Matrix products ``torch.utils.flop_counter`` does not list."""
    if name in ("mv", "addmv"):
        m = args[1] if name == "addmv" else args[0]
        return 2.0 * math.prod(_shape_dims(m))
    if name == "dot" or name == "vdot":
        return 2.0 * args[0].numel()
    if name == "addbmm":
        b1 = _shape_dims(args[1])
        return 2.0 * out.numel() * b1[0] * b1[2]
    return None


@dataclasses.dataclass
class Region:
    """One row of a call's cost: a kernel, a collective kind or an aten op
    (``opcode``), run ``trip`` times."""
    name: str
    opcode: str
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    trip: int = 0

    def optimal_s(self, peak_flops: float, hbm_bw: float) -> float:
        """The larger of the compute and the memory time (collective bytes
        are priced by the fabric, not here)."""
        return max(self.flops / peak_flops if peak_flops else 0.0,
                   self.bytes / hbm_bw if hbm_bw else 0.0)


@dataclasses.dataclass
class StepCost:
    """The totals of one call (:func:`step_cost`)."""
    flops: float = 0.0
    bytes: float = 0.0
    #: output bytes of each collective kind, and their counts
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    coll_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    cross_pod_bytes: float = 0.0
    #: bytes of the storages the arguments held when the call began
    resident_bytes: int = 0
    #: the largest bytes alive at once during the call (arguments included)
    peak_bytes: int = 0
    #: kernel launches (or meta-route calls) by kernel name
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: aten ops by name (views included), with their counts
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    regions: Dict[str, Region] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    result: Any = dataclasses.field(default=None, repr=False)

    @property
    def matmul_flops(self) -> float:
        """FLOPs of the matrix products alone (the dot FLOPs of an HLO)."""
        return sum(r.flops for r in self.regions.values()
                   if r.opcode == "aten" and r.name.split("::")[-1] in
                   _MATMULS)


_MATMULS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot",
                      "vdot", "addbmm", "convolution", "_convolution",
                      "convolution_backward"})


class _Walk(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.cost = StepCost()
        self._live = 0
        self._known: Dict[int, int] = {}

    # ---- live bytes ---------------------------------------------------- #
    def _freed(self, key: int) -> None:
        self._live -= self._known.pop(key, 0)

    def _track(self, t: torch.Tensor) -> int:
        """Note ``t``'s storage as alive (once); returns its new bytes."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return 0
        key = st._cdata
        if key in self._known:
            return 0
        n = st.nbytes()
        self._known[key] = n
        self._live += n
        weakref.finalize(st, self._freed, key)
        if self._live > self.cost.peak_bytes:
            self.cost.peak_bytes = self._live
        return n

    # ---- charges ------------------------------------------------------- #
    def _region(self, name: str, opcode: str) -> Region:
        r = self.cost.regions.get(name)
        if r is None:
            r = self.cost.regions[name] = Region(name, opcode)
        return r

    def add(self, name: str, opcode: str, flops: float, nbytes: float,
            coll_bytes: float = 0.0) -> None:
        r = self._region(name, opcode)
        r.flops += flops
        r.bytes += nbytes
        r.coll_bytes += coll_bytes
        r.trip += 1
        self.cost.flops += flops
        self.cost.bytes += nbytes

    def kernel(self, name: str, nbytes: float, flops: float) -> None:
        """One launch of the hand-written kernel ``name`` (its cost
        function's bytes and operations; ``charges.kernel_call``)."""
        self.cost.kernels[name] = self.cost.kernels.get(name, 0) + 1
        self.add(name, "kernel", flops, nbytes)

    def collective(self, kind: str, nbytes: float, cross_pod: bool) -> None:
        """One collective of ``kind`` whose output holds ``nbytes``
        (``charges.charge_collective``)."""
        self.cost.coll[kind] = self.cost.coll.get(kind, 0.0) + nbytes
        self.cost.coll_counts[kind] = self.cost.coll_counts.get(kind, 0) + 1
        if cross_pod:
            self.cost.cross_pod_bytes += nbytes
        self.add(kind, "collective", 0.0, 0.0, coll_bytes=nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in _FLOP_FORMULAS:
            # a composite op (reached whole under inference mode, where
            # autograd does not decompose it: einsum, matmul, linear) is
            # walked as the ops it is made of, as in a training step
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = _run_meta(func, args, kwargs)
        ns = func.namespace
        if ns in _SKIP_NS:
            return out
        name = func.overloadpacket.__name__
        if name == "lift_fresh":        # a constant's wrapper (CPU only)
            return out
        full = f"{ns}::{name}"
        self.cost.ops[full] = self.cost.ops.get(full, 0) + 1
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if func.is_view or name in ("detach", "alias", "_unsafe_view", "view_as_real",
                                    "view_as_complex"):
            return out
        if name in _ALLOC_ONLY:
            return out
        ins = _tensors((args, kwargs))
        if name in _GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:])
            nbytes = 2.0 * sum(t.numel() * t.element_size() for t in outs) + idx
        else:
            read = ins[1:] if name in _WRITE_ONLY_FIRST else ins
            nbytes = float(sum(_nbytes(t) for t in read)
                           + sum(t.numel() * t.element_size() for t in outs))
        flops = 0.0
        if func.overloadpacket in _FLOP_FORMULAS:
            flops = float(_FLOP_FORMULAS[func.overloadpacket](
                *args, **kwargs, out_val=out))
        elif (extra := _extra_flops(name, args, outs[0] if outs else None)
              ) is not None:
            flops = extra
        elif name in _ZERO_FLOPS or name.rstrip("_") in _ZERO_FLOPS:
            flops = 0.0
        elif name.rstrip("_") in _REDUCTIONS:
            flops = float(ins[0].numel()) if ins else 0.0
        else:
            flops = float(sum(t.numel() for t in outs))
        self.add(full, "aten", flops, nbytes)
        return out


# --------------------------------------------------------------------------- #
# meta ops by shape: an op on meta tensors whose outputs are new tensors is
# run once per signature; later calls get empty tensors of the shapes it
# gave (PyTorch's meta kernels are Python, and a recurrent model calls the
# same few ops at the same shapes per token)
# --------------------------------------------------------------------------- #
_META_OUT: Dict[Any, Any] = {}
_NOT_CACHED = object()


def _key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple((k, _key(v)) for k, v in sorted(x.items()))
    if x is None or isinstance(x, (int, float, bool, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return (type(x).__name__, x)
    raise TypeError


def _fresh(t: torch.Tensor) -> bool:
    """Whether ``t`` owns a storage of exactly its strided extent."""
    if t.storage_offset() or t.numel() == 0:
        return False
    extent = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return t.untyped_storage().nbytes() == extent * t.element_size()


def _run_meta(func, args, kwargs):
    if func.is_view or not args or not isinstance(args[0], torch.Tensor):
        return func(*args, **kwargs)   # a factory, or a list's op
    try:
        key = (func, _key(args), _key(kwargs))
    except TypeError:              # a tensor off meta, or an odd argument
        return func(*args, **kwargs)
    got = _META_OUT.get(key)
    if got is _NOT_CACHED:
        return func(*args, **kwargs)
    if got == "in place":
        return args[0]
    if func._schema.is_mutable:
        # an in-place op that returns its first argument unchanged in
        # shape is cached as such; any other mutation runs every time
        a = args[0]
        before = (tuple(a.shape), a.stride(), a.storage_offset())
        out = func(*args, **kwargs)
        _META_OUT[key] = ("in place" if out is a and before == (
            tuple(a.shape), a.stride(), a.storage_offset())
            else _NOT_CACHED)
        return out
    if got is not None:
        kind, metas = got
        outs = [torch.empty_strided(size, stride, dtype=dtype, device="meta")
                for size, stride, dtype in metas]
        return outs[0] if kind == "one" else _SEQ[kind](outs)
    out = func(*args, **kwargs)
    ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
    if isinstance(out, torch.Tensor):
        kind, outs = "one", [out]
    elif isinstance(out, (tuple, list)) and out and all(
            isinstance(t, torch.Tensor) for t in out):
        kind, outs = type(out).__name__, list(out)
    else:
        _META_OUT[key] = _NOT_CACHED
        return out
    if (any(t.untyped_storage()._cdata in ins or not _fresh(t)
            for t in outs)
            or len({t.untyped_storage()._cdata for t in outs}) < len(outs)):
        _META_OUT[key] = _NOT_CACHED
        return out
    _META_OUT[key] = (kind, [(tuple(t.shape), t.stride(), t.dtype)
                             for t in outs])
    return out


_SEQ = {"tuple": tuple, "list": list}


def _flop_formulas():
    from torch.utils.flop_counter import flop_registry
    return dict(flop_registry)


_FLOP_FORMULAS = _flop_formulas()


def step_cost(fn: Callable[..., Any], *args, **kw) -> StepCost:
    """Run ``fn(*args, **kw)`` once under the walk and return its
    :class:`StepCost` (``result``: what ``fn`` returned). The arguments'
    storages count as alive from the start."""
    walk = _Walk()
    for t in _tensors((args, kw)):
        walk.cost.resident_bytes += walk._track(t)
    charges.ACTIVE.append(walk)
    t0 = time.perf_counter()
    try:
        with walk:
            walk.cost.result = fn(*args, **kw)
    finally:
        charges.ACTIVE.remove(walk)
    walk.cost.seconds = time.perf_counter() - t0
    return walk.cost


def region_table(cost: StepCost, *, peak_flops: float, hbm_bw: float,
                 top: int = 12) -> Dict[str, Any]:
    """The reference's JSON table of one call (``hlo_cost.region_table``):
    the totals, and the ``top`` regions by roofline-optimal seconds (the
    rest summed in ``dropped_optimal_s``, so a cut is visible)."""
    rows = [{"region": r.name, "opcode": r.opcode, "trip": r.trip,
             "flops": r.flops, "bytes": r.bytes, "coll_bytes": r.coll_bytes,
             "optimal_s": r.optimal_s(peak_flops, hbm_bw)}
            for r in cost.regions.values()]
    rows.sort(key=lambda r: r["optimal_s"], reverse=True)
    total_opt = max(cost.flops / peak_flops if peak_flops else 0.0,
                    cost.bytes / hbm_bw if hbm_bw else 0.0)
    kept = rows[:top] if top else rows
    dropped = sum(r["optimal_s"] for r in rows[len(kept):])
    return {"flops": cost.flops, "bytes": cost.bytes,
            "coll_bytes": sum(cost.coll.values()), "optimal_s": total_opt,
            "n_regions": len(rows), "dropped_optimal_s": dropped,
            "regions": kept}

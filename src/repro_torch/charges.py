"""Where a walk of aten ops (``roofline/cost.py``) hears of the work it
cannot see: a hand-written kernel's launch, which is a ctypes call and
not an aten op, and a collective. The kernel wrappers (``kernels/``) and
``core/comm.py::RankGroup`` report here; a walk in progress listens.

It imports nothing, so that the layers below the roofline report to it
without loading the roofline.
"""
from __future__ import annotations

from typing import Any, Dict, List

#: the walks in progress: each has ``kernel(name, nbytes, flops)`` and
#: ``collective(kind, nbytes, cross_pod)``
ACTIVE: List[Any] = []

#: the devices a kernel wrapper takes: the plain version on ``cpu``, the
#: kernel on ``cuda``, the kernel's cost alone on ``meta`` (the dry-run)
DEVICES = ("cpu", "cuda", "meta")


def route(t, fn: str) -> str:
    """The route of kernel wrapper ``fn`` for a tensor ``t``: its device
    type, one of :data:`DEVICES`; any other device raises."""
    kind = t.device.type
    if kind not in DEVICES:
        raise ValueError(f"{fn} runs on cuda or cpu, not {t.device}")
    return kind


def kernel_call(name: str, cost: Dict[str, float], kind: str) -> bool:
    """Charge one call of kernel ``name`` (its cost function's ``bytes``
    and ``operations``) to every walk in progress. True where ``kind`` is
    ``meta``: the wrapper then returns its empty outputs, launching
    nothing and counting no launch; on ``cuda`` it launches."""
    for w in ACTIVE:
        w.kernel(name, cost["bytes"], cost["operations"])
    return kind == "meta"


def charge_collective(kind: str, nbytes: float,
                      cross_pod: bool = False) -> None:
    """Charge one collective of ``kind`` whose output holds ``nbytes`` to
    every walk in progress."""
    for w in ACTIVE:
        w.collective(kind, nbytes, cross_pod)

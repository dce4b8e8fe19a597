"""The card's own time of each kernel a call launches (``torch.profiler``):
the measured counterpart of a walk's regions (``roofline/cost.py``)."""
from __future__ import annotations

from typing import Callable, Dict


def device_ms_by_kernel(fn: Callable[[], object], reps: int = 5,
                        tries: int = 3) -> Dict[str, float]:
    """Device milliseconds of each kernel that one ``fn()`` launches, by
    kernel name: ``reps`` warm calls under torch.profiler, the sum over
    them divided by ``reps``. A profiled window can come back without a
    device event (the tracer starting), so a window that saw none is
    profiled again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.name] = out.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / reps
        if out:
            break
    return out

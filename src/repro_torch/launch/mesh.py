"""Ranks and parallelism plans: the port's counterpart of the JAX package's
``launch/mesh.py``.

In the JAX package the local-SGD workers are the ``data`` axis of a device
mesh, and GSPMD turns the worker-axis mean into an all-reduce. In the port
they are the ranks of a ``torch.distributed`` process group, one worker a
rank, started by ``torchrun`` (``python -m torch.distributed.run``):

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --workers 2 --dist-backend gloo ...

:func:`init_ranks` reads the launcher's environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``), gives rank r the card ``LOCAL_RANK % device_count`` (or
the CPU), refuses NCCL where two ranks would share a card, and opens the
group with a bounded timeout, so a rank that dies fails its peers instead
of hanging them. :func:`resolve_plan` chooses the plan with the
reference's thresholds; ``launch/steps.py::build_train_programs`` builds
the run's steps from it.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelismPlan
from repro_torch.core.comm import RankGroup, nccl_shares_a_card

# Parameter-count thresholds steering worker granularity (the reference's)
_POD_WORKER_THRESHOLD = 20e9       # > 20B params: one local-SGD worker per pod
_SYNC_ONLY_THRESHOLD = 100e9       # > 100B: no local workers (AdaAlter, global FSDP)

#: seconds a collective may wait for a peer before the group fails
DEFAULT_TIMEOUT_S = 60.0

_SHARD_AXIS = ("the shard axis (per-rank sub-planes, FSDP over fsdp_axes) "
               "is not ported yet: ROADMAP Queue 1 item 9, shard axis")


def world_size() -> int:
    """The launcher's world size (1 outside ``torchrun``)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def resolve_plan(cfg: ModelConfig, world: int, *,
                 optimizer: str = "local_adaalter") -> ParallelismPlan:
    """The reference's plan for ``cfg`` on ``world`` ranks along ``data``
    (the port's only axis): the paper-style plan (every rank a worker,
    ``local_axes=("data",)``) for a local optimizer, and the fully
    synchronous plan (``grad_axes=("data",)``, one model whose gradient is
    averaged every step) for the baselines. ``launch/steps.py`` builds a
    run with ranks from it. The reference also shards the synchronous
    plan's state over ``data`` (FSDP); the port keeps it replicated. The
    >20 B "workers = pods" plan raises NotImplementedError."""
    n_params = cfg.param_count()
    local = optimizer in ("local_adaalter", "local_sgd")
    if n_params > _SYNC_ONLY_THRESHOLD or not local:
        if n_params > _POD_WORKER_THRESHOLD:
            raise NotImplementedError(
                f"{cfg.name} ({n_params:,} parameters): the reference "
                "shards its synchronous state over data (FSDP); "
                + _SHARD_AXIS)
        return ParallelismPlan(local_axes=(), grad_axes=("data",),
                               fsdp_axes=(),
                               remat="full" if n_params > 1e9 else "none")
    if n_params > _POD_WORKER_THRESHOLD:
        raise NotImplementedError(
            f"{cfg.name} ({n_params:,} parameters): the reference makes "
            "each pod a worker with ZeRO over data inside it; " + _SHARD_AXIS)
    return ParallelismPlan(local_axes=("data",), grad_axes=(), fsdp_axes=(),
                           remat="full" if n_params > 1e9 else "none")


def rank_device(device: Optional[str], local_rank: int) -> torch.device:
    """Rank ``local_rank``'s device: ``cpu`` when asked, else the card
    ``local_rank % device_count`` (never a silent CPU)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port trains on the card; "
                           "pass --device cpu (with --dist-backend gloo) to "
                           "run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def default_backend(device: Optional[str]) -> str:
    """``gloo`` for a CPU run, ``nccl`` on the cards."""
    cpu = device is not None and torch.device(device).type == "cpu"
    return "gloo" if cpu else "nccl"


def check_backend(backend: str, local_world: int, device_count: int) -> None:
    """Refuse NCCL where ``local_world`` ranks on a host would share a
    card (NCCL rejects two ranks on one device); never switch backend."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if nccl_shares_a_card(backend, local_world, device_count):
        raise ValueError(
            f"{local_world} ranks on this host but {device_count} card(s): "
            "NCCL cannot put two ranks on one card. Run one rank a card, or "
            "pass --dist-backend gloo, which stages the wire through host "
            "memory")


def init_ranks(backend: Optional[str] = None, device: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S
               ) -> Tuple[RankGroup, torch.device]:
    """Open the process group of this ``torchrun`` launch. Returns the
    :class:`~repro_torch.core.comm.RankGroup` and this rank's device."""
    import torch.distributed as dist
    backend = backend or default_backend(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = rank_device(device, local_rank)
    if dev.type == "cpu" and backend == "nccl":
        raise ValueError("NCCL moves CUDA tensors: a CPU run takes "
                         "--dist-backend gloo")
    if dev.type == "cuda":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", "1")))
        check_backend(backend, local_world, torch.cuda.device_count())
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=timeout_s), **kw)
    return RankGroup(dev), dev


def close_ranks() -> None:
    """Tear the process group down (a no-op outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()

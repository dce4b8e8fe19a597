"""Ranks and parallelism plans: the port's counterpart of the JAX package's
``launch/mesh.py``.

In the JAX package the local-SGD workers are the ``data`` axis of a device
mesh, and GSPMD turns the worker-axis mean into an all-reduce. In the port
they are the ranks of a ``torch.distributed`` process group, started by
``torchrun`` (``python -m torch.distributed.run``):

  torchrun --standalone --nproc-per-node R·S -m repro_torch.launch.train \\
      --workers R --flat --dist-backend gloo ...

The ranks form an (R, S) grid, the reference's ``("data", "model")`` mesh:
rank r is worker ``r // S`` and shard ``r % S``. With S = 1 every rank is
one worker; with S > 1 each worker's flat plane is split into S
sub-planes, one a rank (the paper-style plan shards it down ``tp_axis``),
or, per leaf, each worker's weights are split over its S ranks as their
specs say (tensor parallelism, ``sharding.partition.TensorParallel``).
Under a one-model plan (the synchronous one, and those above 20 B
parameters) the R rows of ranks share one model: each leaf split over
``model`` and over the FSDP axes beside it, a tile a rank. A grid with
``pod`` (``init_ranks(grid={"pod": P, "data": D, "model": M})``, the
reference's ``(pod, data, model)`` mesh, pod-major) trains under the
20-100 B plan, whose workers are the pods: each pod one Local AdaAlter
worker of D × M ranks, its leaves split over ``data`` (FSDP) and
``model`` (tiles), its gradient averaged over ``data`` every step and
its state over the pods on the sync steps.
Serving lays its ranks out as ``{"data": D, "model": N // D}``
(``launch/serve.py``).

:func:`init_ranks` reads the launcher's environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``), gives rank r the card ``LOCAL_RANK % device_count`` (or
the CPU), refuses NCCL where two ranks would share a card, opens the group
with a bounded timeout, so a rank that dies fails its peers instead of
hanging them, and lays the ranks out as the grid. :func:`resolve_plan`
chooses the plan with the reference's thresholds;
``launch/steps.py::build_train_programs`` builds the run's steps from it.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ParallelismPlan
from repro_torch.core.comm import RankGroup, nccl_shares_a_card
from repro_torch.sharding.specs import GridLayout

# Parameter-count thresholds steering worker granularity (the reference's)
_POD_WORKER_THRESHOLD = 20e9       # > 20B params: one local-SGD worker per pod
_SYNC_ONLY_THRESHOLD = 100e9       # > 100B: no local workers (AdaAlter, global FSDP)

#: seconds a collective may wait for a peer before the group fails
DEFAULT_TIMEOUT_S = 60.0

#: the families whose layers run under tensor parallelism (every one)
TP_FAMILIES = ("lstm", "dense", "moe", "ssm", "hybrid", "vlm", "audio")


def world_size() -> int:
    """The launcher's world size (1 outside ``torchrun``)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def grid_of(world: int, workers: int) -> Dict[str, int]:
    """The (workers × shards) grid of ``world`` ranks: ``{"data": workers,
    "model": world // workers}``. Raises ValueError, naming the worker
    counts that fit, where ``workers`` does not divide ``world``."""
    if workers < 1 or world % workers:
        fit = [n for n in range(1, world + 1) if world % n == 0]
        raise ValueError(
            f"--workers {workers} on {world} ranks: the ranks form a grid "
            f"of workers x shards, so the workers must divide {world}; "
            "valid: " + ", ".join(f"--workers {n}" for n in fit))
    return {"data": workers, "model": world // workers}


def resolve_plan(cfg: ModelConfig, grid: Union[Dict[str, int], int], *,
                 optimizer: str = "local_adaalter") -> ParallelismPlan:
    """The reference's plan for ``cfg`` on ``grid`` (the reference's mesh
    shape, ``{"data": R, "model": S}``; an int n is ``{"data": n, "model":
    1}``), with its thresholds: the paper-style plan (workers along
    ``local_axes=("data",)``, the flat plane split down
    ``tp_axis="model"``) for a local optimizer up to 20 B parameters; the
    fully synchronous plan (``grad_axes=fsdp_axes=("data",)``: one model
    whose gradient is averaged every step, its state FSDP-sharded over
    ``data``) for the baselines and above 100 B; between them, workers as
    pods with ZeRO over ``data`` (without a pod axis no worker axis: one
    model). Every plan takes ``remat="full"`` above 1e9 parameters. A
    grid with ``"pod"`` (the reference's ``(pod, data, model)`` mesh: the
    dry-run's production grid, or ``init_ranks(grid=)`` with pods) gives
    the reference's plans on it: ``pod`` beside ``data`` in each, and for
    the 20-100 B plan each pod a worker (``local_axes=("pod",)``)."""
    if isinstance(grid, int):
        grid = {"data": grid, "model": 1}
    pod = ("pod",) if "pod" in grid else ()
    n_params = cfg.param_count()
    local = optimizer in ("local_adaalter", "local_sgd")
    remat = "full" if n_params > 1e9 else "none"
    big = n_params > _POD_WORKER_THRESHOLD
    if n_params > _SYNC_ONLY_THRESHOLD or not local:
        dp = pod + ("data",)
        return ParallelismPlan(local_axes=(), grad_axes=dp, fsdp_axes=dp,
                               remat=remat, weight_gather_serving=big)
    if big:        # workers = pods (none without a pod axis); ZeRO over data
        return ParallelismPlan(local_axes=pod, grad_axes=("data",),
                               fsdp_axes=("data",), remat="full",
                               weight_gather_serving=True)
    return ParallelismPlan(local_axes=pod + ("data",), grad_axes=(),
                           fsdp_axes=(), remat=remat)


def check_tp(cfg: ModelConfig, what: str) -> None:
    """Refuse tensor parallelism over ``model`` for a family outside
    :data:`TP_FAMILIES` (none: every family splits its layers)."""
    if cfg.family not in TP_FAMILIES:
        raise ValueError(
            f"{what} of {cfg.name} ({cfg.family}) over model ranks: tensor "
            f"parallelism covers the {'/'.join(TP_FAMILIES)} families")


def check_plan(plan: ParallelismPlan, grid: Dict[str, int], *,
               flat: bool, cfg: Optional[ModelConfig] = None) -> None:
    """Refuse, for a run with ranks, what the port cannot build. Shards of
    a worker (``model`` > 1) are a sharded flat plane (``flat``) or, per
    leaf, tensor parallelism (:func:`check_tp`) under any plan: the
    paper-style plan's workers, or one model whose gradient is averaged
    over ``grad_axes``, its leaves split over ``fsdp_axes`` beside
    ``model`` (tiles). A grid with pods trains under the plan whose
    workers are the pods (``local_axes=("pod",)``), a worker's leaves
    split over ``fsdp_axes=("data",)`` and ``model`` (tiles), its gradient
    averaged over ``data``; per leaf, or its flat plane split over the
    pod's ``data`` × ``model`` ranks. Refused: a pod grid under another
    plan (fold the pods into ``data``), workers along any axis but the
    grid's first, a worker's gradient or FSDP split over axes other than
    ``data``, and a flat plane on a grid whose shard axes the plan leaves
    unused (ranks that would hold the same sub-plane)."""
    from repro_torch.sharding.specs import plane_shard_count
    if grid.get("model", 1) > 1 and not flat and cfg is not None:
        check_tp(cfg, "training")
    if "pod" in grid and tuple(plan.local_axes) != ("pod",):
        raise ValueError(
            f"the plan {plan} on a grid with pods {grid}: the port trains a "
            "pod grid under the plan whose workers are the pods "
            "(local_axes=('pod',), the reference's 20-100 B plan); for this "
            f"plan fold the pods into data ({grid['pod'] * grid['data']} "
            "data ranks)")
    if not plan.local_axes:
        return
    lead = GridLayout.of(grid).axes[0]
    if tuple(plan.local_axes) != (lead,):
        raise ValueError(f"the plan {plan} makes workers of "
                         f"{plan.local_axes}: on the grid {grid} the workers "
                         f"run along its first axis, {lead!r}")
    if not (set(plan.fsdp_axes) <= set(plan.grad_axes) <= {"data"}) or (
            plan.grad_axes and lead == "data"):
        raise ValueError(f"the plan {plan}: a worker's gradient mean and "
                         "FSDP split run over the data ranks inside a pod, "
                         "and nowhere else")
    inner = 1
    for a, n in grid.items():
        inner *= 1 if a == lead else n
    shards = plane_shard_count(grid, plan)
    if flat and shards != inner:
        raise ValueError(f"the plan {plan} splits a worker's plane into "
                         f"{shards} shards on a grid of {inner} ranks a "
                         "worker")


def check_serve_plan(cfg: ModelConfig, plan: ParallelismPlan,
                     grid: Dict[str, int]) -> None:
    """Refuse sharded serving the port cannot build: on ``model`` > 1,
    what :func:`check_tp` refuses. ``weight_gather_serving`` (the plan
    above 20 B parameters) holds each rank's tiles at rest and gathers a
    layer group's parts over ``data`` as it runs (``launch/serving.py``)."""
    if grid.get("model", 1) > 1:
        check_tp(cfg, "serving")


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
               timeout_s: float = DEFAULT_TIMEOUT_S,
               grid: Optional[Dict[str, int]] = None,
               fsdp_axes: Tuple[str, ...] = ()
               ) -> Tuple[RankGroup, torch.device]:
    """Open the process group of this ``torchrun`` launch, laid out as
    ``grid`` (``{"data": R, "model": S}`` or ``{"pod": P, "data": D,
    "model": M}``, pod-major; default: one worker a rank), with the FSDP
    sub-groups along ``fsdp_axes`` (the plan's; ``RankGroup.split``).
    Returns the
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
    group = RankGroup(dev)
    if grid is not None:
        group.split(GridLayout.of(grid), fsdp_axes)
    return group, dev


def close_ranks() -> None:
    """Tear the process group down (a no-op outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()

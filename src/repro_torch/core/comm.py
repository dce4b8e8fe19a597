"""Communication: the sync mean's arithmetic, the collectives of a run with
one worker a rank, the bytes each round moves, and the alpha-beta time
model of a round.

The byte accounting and the alpha-beta model of the JAX package's
``core/comm.py``. :class:`FabricModel` keeps the reference's field names
(traces of either package carry ``dataclasses.asdict(FabricModel())`` and
each package reads the other's), with the H100 SXM's links as defaults.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.hardware import H100
from repro_torch.charges import charge_collective
from repro_torch.sharding.specs import GridLayout


@dataclasses.dataclass(frozen=True)
class FabricModel:
    """Bandwidths in bytes/s; latency in s per collective.

    ``ici_bw``   the intra-node link: NVLink 4, 450 GB/s a direction per
                 H100 SXM (NVIDIA data sheet);
    ``dcn_bw``   the inter-node link: one NDR InfiniBand port, 400 Gb/s =
                 50 GB/s per GPU (NVIDIA data sheet);
    ``latency``  launch and rendezvous of one collective: an assumption
                 (10 µs), not a measurement. Measuring it needs ranks on
                 several cards over NCCL.
    """
    ici_bw: float = H100.ici_bw
    dcn_bw: float = H100.dcn_bw
    latency: float = 10e-6

    def scaled(self, bw_scale: float = 1.0,
               latency_scale: float = 1.0) -> "FabricModel":
        """The bandwidths (and optionally the latency) scaled: the replay's
        one-knob "slower interconnect" what-if."""
        return dataclasses.replace(self, ici_bw=self.ici_bw * bw_scale,
                                   dcn_bw=self.dcn_bw * bw_scale,
                                   latency=self.latency * latency_scale)

    def collective_time(self, n_bytes: float, n_collectives: int, n: int,
                        cross_pod: bool = False) -> float:
        """One sync round issued as ``n_collectives`` all-reduces totalling
        ``n_bytes`` per replica: every collective pays the latency, the
        ring transfer depends on the total payload,
        ``t = n_collectives·α + 2(n−1)/n · n_bytes / bw``."""
        if n <= 1 or n_collectives <= 0:
            return 0.0
        bw = self.dcn_bw if cross_pod else self.ici_bw
        return (n_collectives * self.latency
                + 2.0 * (n - 1) / n * n_bytes / bw)

    def allreduce_time(self, bytes_per_replica: float, n: int,
                       cross_pod: bool = False) -> float:
        """Ring all-reduce of ``bytes_per_replica`` over ``n`` replicas:
        :meth:`collective_time` with a single collective."""
        return self.collective_time(bytes_per_replica, 1, n, cross_pod)


def bytes_per_param(dtype_bytes: int = 4) -> int:
    return dtype_bytes


def collective_time(n_bytes: float, n_collectives: int, n_workers: int,
                    fabric: FabricModel = FabricModel(),
                    cross_pod: bool = False) -> float:
    """:meth:`FabricModel.collective_time` of the default fabric."""
    return fabric.collective_time(n_bytes, n_collectives, n_workers,
                                  cross_pod)


def ordered_mean(n: int, row: Callable[[int], torch.Tensor],
                 round16=()) -> torch.Tensor:
    """The mean of ``n`` rows as the reference's jitted ``jnp.mean``
    computes it, in float32: ``row(0) + row(1)``, then ``+ row(2)``, ...,
    times ``f32(1/n)``. ``row(r)`` gives row r (any float dtype, all of one
    shape); it is called once a row, in order, so a caller may decode rows
    one at a time. ``round16`` lists ``(start, stop)`` ranges of the last
    axis whose mean is rounded through bfloat16 (a flat plane's 16-bit
    slots). Returns a float32 tensor: a new one for ``n`` >= 2; for ``n``
    == 1 (a worker sub-group of one rank) ``row(0)`` in float32, whose sum
    of one row times ``f32(1)`` is itself."""
    acc = row(0).float()
    if n > 1:
        acc = acc + row(1)
        for r in range(2, n):
            acc.add_(row(r))
        acc.mul_(torch.as_tensor(np.float32(1.0) / np.float32(n),
                                 device=acc.device))
    for start, stop in round16:
        seg = acc[..., start:stop]
        seg.copy_(seg.to(torch.bfloat16))
    return acc


def worker_mean_(x: torch.Tensor, round16=()) -> torch.Tensor:
    """Replace every row of ``x``'s leading (worker) axis by the mean over
    that axis, in place: :func:`ordered_mean` of the rows, cast back to
    ``x``'s dtype. The sum is spelled out as a loop because a reduction
    kernel may add a short axis in another order. Returns ``x``."""
    workers = x.shape[0]
    if workers == 1:              # the sum of one row, times f32(1): x
        return x
    acc = ordered_mean(workers, x.__getitem__, round16)
    return x.copy_(acc.expand_as(x))      # the copy rounds to x's dtype


# --------------------------------------------------------------------------- #
# one worker a rank: the sync round's collectives over torch.distributed
# --------------------------------------------------------------------------- #
#: the parts of a sync round a staged (gloo, CUDA tensors) rank times; an
#: FSDP step's params gather is timed whole, as ``gather``
ROUND_PARTS = ("encode", "d2h", "wire", "h2d", "decode_sum", "gather")
#: elements of a row a rank's mean decodes and sums at a time (a multiple
#: of every quantization block): 256 MB of each fp32 temporary
MEAN_CHUNK = 1 << 26


class CollectiveCount:
    """Collectives one rank issued, the bytes it contributed to them, and
    the host seconds of the round's parts (:data:`ROUND_PARTS`) where the
    rank times them."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.bytes = 0
        self.seconds = dict.fromkeys(ROUND_PARTS, 0.0)

    def snapshot(self) -> Dict[str, Any]:
        return {"n": self.n, "bytes": self.bytes,
                "seconds": dict(self.seconds)}


#: the sync rounds' collectives, and the synchronous path's gradient mean
#: and FSDP params gather: what ``TrainResult.comm_bytes_total`` accounts
#: for
wire = CollectiveCount()
#: every other gather (the per-step statistics, checkpoints, health probes)
side = CollectiveCount()
#: a sharded flat run's params gather before each forward (its parts d2h,
#: wire, h2d, as a round's)
shard_gather = CollectiveCount()
#: tensor parallelism's collectives over the ``model`` sub-group (the
#: layers' sums and gathers, forward and backward, and the decode's
#: softmax combine): :func:`tp_copy`, :func:`tp_sum`, :func:`tp_gather`
tp = CollectiveCount()


def nccl_shares_a_card(backend: str, local_world: int,
                       device_count: int) -> bool:
    """Whether ``local_world`` ranks on one host would put two NCCL ranks on
    one card (NCCL refuses them: "Duplicate GPU detected")."""
    return backend == "nccl" and local_world > device_count


#: by kind, the least bytes of a collective (its output on every rank; an
#: all-to-all's send over every rank) that gloo ranks on one host move
#: through their shared region; smaller ones go through gloo. On the host
#: of an H100 (8 cores; tools/collective_walls.py, 2 and 4 ranks) the
#: region's two barriers cost more than gloo's one exchange below these:
#: an all-gather of 1 KiB took 0.91 ms against gloo's 0.69 ms on 2 ranks,
#: 1 MiB 1.64 against 1.81 ms, 64 MiB 22.5 against 60.6 ms; an all-to-all
#: of 4 MiB 2.00 against 1.46 ms on 2 ranks and 16 MiB 4.04 against 3.21
#: ms on 4, 64 MiB 15.4 against 18.0 ms on 2 and 11.2 against 12.2 on 4
SHARED_MIN_BYTES = {"all_gather": 1 << 20, "all_to_all": 1 << 26}


class SharedRegion:
    """Host memory that every rank of a gloo group on one host maps: an
    anonymous file (``os.memfd_create``) that the group's rank 0 makes and
    the others open through ``/proc/<pid>/fd``, remade larger (a power of
    two) when a collective needs more. A collective's ranks each write
    their own bytes into it and read the others' between two barriers of
    the group: the bytes gloo would move, copied twice in host memory
    instead of through the loopback network."""

    def __init__(self, group, fd: int, size: int) -> None:
        import mmap
        self.group, self.size = group, size
        # a normal tensor even where a serving forward under inference mode
        # opens it: later collectives write into it outside that mode
        with torch.inference_mode(False):
            self.bytes = torch.frombuffer(mmap.mmap(fd, size),
                                          dtype=torch.uint8)
        _REGIONS.add(self)

    @classmethod
    def open(cls, group, size: int = 1 << 20) -> Optional["SharedRegion"]:
        """The region of ``group`` (a ``torch.distributed`` group), made by
        its rank 0 and opened by every rank; None where a rank cannot open
        it or finds other bytes in it than rank 0 wrote (a rank on another
        host). Every rank of the group calls it together."""
        import os
        import secrets
        import torch.distributed as dist
        rank = dist.get_rank(group)
        src = 0 if group is None else dist.get_global_rank(group, 0)
        fd, region, path = -1, None, [None, None]
        if rank == 0:
            fd = os.memfd_create("repro_torch_rank_group")
            os.ftruncate(fd, size)
            region = cls(group, fd, size)
            token = secrets.token_bytes(16)
            region.bytes[:16].copy_(torch.frombuffer(bytearray(token),
                                                     dtype=torch.uint8))
            path = [f"/proc/{os.getpid()}/fd/{fd}", token]
        dist.broadcast_object_list(path, src=src, group=group)
        if rank != 0:
            try:
                fd = os.open(path[0], os.O_RDWR)
                region = cls(group, fd, size)
                if bytes(region.bytes[:16].tolist()) != path[1]:
                    region = None
            except OSError:
                region = None
        ok = [None] * dist.get_world_size(group)
        dist.all_gather_object(ok, region is not None, group=group)
        if fd >= 0:               # the mappings outlive the descriptors
            os.close(fd)
        return region if all(ok) else None

    def close(self) -> None:
        """Unmap the region on this rank (the host frees it once every
        rank has); a later :meth:`take` reopens it."""
        self.bytes, self.size = None, 0

    def take(self, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of the region, remade larger first where
        it is smaller or closed (every rank asks for the same
        ``nbytes``)."""
        if nbytes > self.size:
            grown = SharedRegion.open(self.group,
                                      1 << (nbytes - 1).bit_length())
            if grown is None:
                raise RuntimeError("the ranks could not open a larger "
                                   "shared region")
            self.bytes, self.size = grown.bytes, grown.size
        return self.bytes[:nbytes]


_REGIONS: "weakref.WeakSet[SharedRegion]" = weakref.WeakSet()


def close_regions() -> None:
    """Unmap every shared region this rank holds (``mesh.close_ranks``
    does so before it tears the process group down)."""
    for region in list(_REGIONS):
        region.close()


class RankGroup:
    """The ranks of a run, one worker each, over a ``torch.distributed``
    process group.

    Every collective is an all-gather of one contiguous byte buffer, into
    which the caller's parts (tensors of any dtype) are packed: a sync
    round's wire is one collective per payload leaf, or one for a whole
    flat plane; but an FSDP gradient mean's, an all-to-all of a leaf's
    float32 slices (:meth:`mean_slices`). Under gloo with CUDA tensors the
    buffers are staged through host memory explicitly, here and nowhere
    else: copied to the host, exchanged there, copied back to the card;
    ranks on one host exchange the larger ones through a
    :class:`SharedRegion`. Under NCCL they stay on the card. ``timed``
    (gloo, or a CPU run) times the round's parts, with the device
    synchronised around each."""

    def __init__(self, device, group=None) -> None:
        import torch.distributed as dist
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        # one worker a rank until split() lays the ranks out as a grid
        self.layout = GridLayout(self.world, 1)
        self.workers: "RankGroup" = self
        self.shards: Optional["RankGroup"] = None
        # sub-groups by the grid axes their ranks differ along
        self._along: Dict[Tuple[str, ...], "RankGroup"] = {}
        self.device = torch.device(device)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        if self.backend == "gloo" and self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"gloo ranks run on cpu or cuda, not {device}")
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("NCCL moves CUDA tensors: a CPU run takes "
                             "--dist-backend gloo")
        self.timed = self.backend == "gloo"
        self._round_t0: Optional[float] = None
        self._cross_pod = False
        # the SharedRegion of ranks on one host (None: not opened yet;
        # False: they share none)
        self._shared: Any = None

    @property
    def cross_pod(self) -> bool:
        """Whether this group's ranks lie in more than one pod of the grid
        :meth:`split` laid out (its collectives would cross the inter-node
        link)."""
        return self._cross_pod

    @property
    def grid(self) -> Dict[str, int]:
        """The grid's shape as the reference's mesh shape: ``{"data":
        workers, "model": shards}``, or with ``"pod"`` in front."""
        return self.layout.shape

    @property
    def worker(self) -> int:
        return self.layout.coords(self.rank)[0]

    @property
    def shard(self) -> int:
        return self.layout.coords(self.rank)[1]

    def split(self, layout, fsdp_axes: Sequence[str] = ()) -> "RankGroup":
        """Lay the ranks out as ``layout`` (a
        ``sharding.specs.GridLayout``: rank r is worker r // S, shard r % S;
        on ``(pod, data, model)`` the workers are the pods) and open its
        sub-groups: :attr:`workers`, the ranks of this rank's shard index
        (the sync mean's: along ``pod`` where the pods are the workers),
        :attr:`shards`, the ranks of this rank's worker (the params
        gather's), on three axes each of a worker's axes alone (``data``,
        the FSDP and gradient mean's inside a pod, and ``model``, tensor
        parallelism's), and the FSDP sub-group, the ranks that differ only
        along ``fsdp_axes`` (:meth:`along`). Every rank creates every
        sub-group, in one order (the shard sub-groups by worker, the worker
        sub-groups by shard index, a worker's axes in grid order, then the
        FSDP sub-groups), as ``dist.new_group`` requires of all ranks; a
        rank that did otherwise would hang its peers. A sub-group of every
        rank is this group, one of this rank alone none. Returns
        ``self``."""
        if layout.world != self.world:
            raise ValueError(f"a {'x'.join(map(str, layout.sizes))} grid "
                             f"on {self.world} ranks")
        for g in (self.workers, self.shards, *self._along.values()):
            if g is not self and isinstance(g, RankGroup) and isinstance(
                    g._shared, SharedRegion):
                g._shared.close()       # the sub-groups it replaces
        self.layout = layout
        self._along = {}
        self._cross_pod = self._spans_pods(range(self.world))
        sub = self._new_group
        if layout.shards > 1:
            by_worker = [sub(r) for r in layout.shard_groups()]
            by_shard = [sub(r) for r in layout.worker_groups()]
            self.shards = by_worker[self.worker]
            self.workers = by_shard[self.shard]
            self._along = {layout.axes[1:]: self.shards,
                           layout.axes[:1]: self.workers}
        else:
            self.workers, self.shards = self, None
        inner = layout.axes[1:]
        wanted = [(a,) for a in inner] if len(inner) > 1 else []
        wanted.append(tuple(sorted(a for a in fsdp_axes
                                   if a in layout.axes)))
        for axes in wanted:
            groups = layout.groups_along(axes)
            if (axes and axes not in self._along and len(groups) > 1
                    and len(groups[0]) > 1):
                mine = [sub(r) for r in groups]
                self._along[axes] = next(g for g in mine if g is not None)
        return self

    def _spans_pods(self, ranks) -> bool:
        """Whether ``ranks`` (of this group's layout) lie in several
        pods."""
        if "pod" not in self.layout.axes:
            return False
        return len({self.layout.coords_of(r)["pod"] for r in ranks}) > 1

    def _new_group(self, ranks: List[int]) -> Optional["RankGroup"]:
        """The sub-group of ``ranks`` (every rank creates every one), or
        None where this rank is not among them."""
        import torch.distributed as dist
        pg = dist.new_group(ranks, backend=self.backend)
        if self.rank not in ranks:
            return None
        out = RankGroup(self.device, pg)
        out._cross_pod = self._spans_pods(ranks)
        return out

    def along(self, axes: Sequence[str]) -> Optional["RankGroup"]:
        """The sub-group of the ranks that differ from this one only along
        the grid ``axes``: this group where that is every rank, None where
        it is this rank alone, else the sub-group :meth:`split` opened."""
        axes = tuple(sorted(a for a in axes if a in self.layout.axes))
        group = next(g for g in self.layout.groups_along(axes)
                     if self.rank in g)
        if len(group) == 1:
            return None
        if len(group) == self.world:
            return self
        if axes not in self._along:
            raise ValueError(f"no sub-group along {axes}: open it with "
                             f"split(layout, fsdp_axes={axes})")
        return self._along[axes]

    @property
    def route(self) -> str:
        if self.backend == "nccl":
            return f"nccl on {self.device}"
        if self.staged:
            return (f"gloo from {self.device}: the wire is staged through "
                    "host memory")
        return f"gloo on {self.device}"

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @contextlib.contextmanager
    def part(self, name: str, count: Optional["CollectiveCount"] = wire):
        """Time the block as part ``name`` of a round (where ``timed``),
        into ``count`` (None: not timed)."""
        if not self.timed or count is None:
            yield
            return
        t0 = self._now()
        yield
        count.seconds[name] += self._now() - t0

    @contextlib.contextmanager
    def round_(self):
        """A sync round: where ``timed``, the seconds from its start to its
        first collective (the wire's encode) go to part ``encode``."""
        self._round_t0 = self._now() if self.timed else None
        try:
            yield
        finally:
            self._round_t0 = None

    @staticmethod
    def _packing(parts: Sequence[torch.Tensor]):
        """Byte offsets of ``parts`` packed into one buffer (larger
        elements first, so each offset is aligned to its element size), the
        packed size, and the largest element size."""
        order = sorted(range(len(parts)),
                       key=lambda i: -parts[i].element_size())
        offsets, total = {}, 0
        for i in order:
            offsets[i] = total
            total += parts[i].numel() * parts[i].element_size()
        return offsets, total, max(p.element_size() for p in parts)

    def _gather_packed(self, sent: Sequence[torch.Tensor], packings,
                       count: Optional[CollectiveCount],
                       timed: bool = True) -> torch.Tensor:
        """One all-gather of every rank's parts, rank r's packed as
        ``packings[r]`` (:meth:`_packing`; ``sent`` is this rank's) into a
        buffer padded to the largest rank's and aligned to the largest
        element. Returns the (world, bytes) uint8 rows: on the host where
        the wire is staged (pinned), else on the device. ``count`` (None:
        not counted) gets one collective and the buffer's bytes, and the
        seconds of its parts unless not ``timed``."""
        if self._round_t0 is not None and count is wire:
            wire.seconds["encode"] += self._now() - self._round_t0
            self._round_t0 = None
        total = max(t for _, t, _ in packings)
        total += (-total) % max(a for _, _, a in packings)
        host = self.staged or (self.device.type == "cpu")
        offsets = packings[self.rank][0]
        timing = count if timed else None
        with self.part("d2h", timing if self.staged else None):
            buf = torch.empty(total, dtype=torch.uint8,
                              device="cpu" if host else self.device,
                              pin_memory=self.staged)
            for i, p in enumerate(sent):
                n = p.numel() * p.element_size()
                buf[offsets[i]:offsets[i] + n].copy_(
                    p.detach().contiguous().reshape(-1).view(torch.uint8))
        out = torch.empty((self.world, total), dtype=torch.uint8,
                          device=buf.device, pin_memory=self.staged)
        with self.part("wire", timing):
            self._all_gather(out, buf)
        if count is not None:
            count.n += 1
            count.bytes += total
        charge_collective("all-gather", out.numel(), self.cross_pod)
        return out

    def _all_gather(self, out: torch.Tensor, buf: torch.Tensor) -> None:
        """Row r of ``out`` = rank r's ``buf`` (the one call that moves an
        all-gather's bytes): through the group's shared region where it
        has one (:meth:`_region`), else through the process group."""
        import torch.distributed as dist
        region = self._region(out.numel(), "all_gather")
        if region is None:
            dist.all_gather(list(out.unbind(0)), buf, group=self.group)
            return
        rows = region.view(self.world, -1)
        rows[self.rank].copy_(buf)
        dist.barrier(group=self.group)
        out.copy_(rows)
        dist.barrier(group=self.group)    # the region may then be reused

    def _all_to_all(self, recv: torch.Tensor, send: torch.Tensor) -> None:
        """Row r of ``recv`` = rank r's row ``self.rank`` of ``send`` (the
        one call that moves an all-to-all's bytes), through the shared
        region as :meth:`_all_gather`."""
        import torch.distributed as dist
        nbytes = send.numel() * send.element_size()
        region = self._region(self.world * nbytes, "all_to_all")
        if region is None:
            dist.all_to_all_single(recv, send, group=self.group)
            return
        blocks = region.view(self.world, self.world, -1)
        blocks[self.rank].copy_(send.view(self.world, -1).view(torch.uint8))
        dist.barrier(group=self.group)
        recv.view(self.world, -1).view(torch.uint8).copy_(
            blocks[:, self.rank])
        dist.barrier(group=self.group)

    def _region(self, nbytes: int, kind: str) -> Optional[torch.Tensor]:
        """The first ``nbytes`` of the host memory every rank of this group
        maps (:class:`SharedRegion`), for a collective of ``kind`` that
        takes ``nbytes`` of it; None (the process group moves it) under
        NCCL, below the kind's :data:`SHARED_MIN_BYTES`, or where the ranks
        share no host. Every rank calls it at the same collective."""
        if (self.backend != "gloo" or nbytes < SHARED_MIN_BYTES[kind]
                or self._shared is False):
            return None
        if self._shared is None:
            self._shared = SharedRegion.open(self.group) or False
            if self._shared is False:
                return None
        return self._shared.take(nbytes)

    def all_gather(self, parts: Sequence[torch.Tensor],
                   count: Optional[CollectiveCount] = wire,
                   to_device: bool = True) -> List[torch.Tensor]:
        """One all-gather of every rank's ``parts``, packed into one byte
        buffer. Returns, per part, a tensor of shape (world, *part.shape)
        whose row r is rank r's part, contiguous, on this rank's device
        (on the host with ``to_device=False``). ``count`` (None: not
        counted) gets one collective and the buffer's bytes."""
        packing = self._packing(parts)
        out = self._gather_packed(parts, [packing] * self.world, count)
        if self.staged and to_device:
            with self.part("h2d", count):
                out = out.to(self.device)
        offsets = packing[0]
        got = []
        for i, p in enumerate(parts):
            n = p.numel() * p.element_size()
            got.append(out[:, offsets[i]:offsets[i] + n].view(p.dtype)
                       .reshape((self.world,) + tuple(p.shape)))
        return got

    def mean_(self, x: torch.Tensor,
              row: Callable[[int, int, int], torch.Tensor], round16=(),
              chunk: Optional[int] = None) -> torch.Tensor:
        """Write the :func:`ordered_mean` of the world's rows over ``x``
        (contiguous), cast to its dtype, ``chunk`` (default
        :data:`MEAN_CHUNK`) elements at a time:
        ``row(r, start, stop)`` gives elements start:stop of rank r's row,
        ``x`` flattened (any float dtype), so decoding a row holds one
        chunk of each temporary, not a whole plane. ``round16``: ranges of
        ``x``'s last axis, as :func:`ordered_mean` takes them (``x`` is
        then taken whole unless it is one row). Returns ``x``."""
        flat = x.view(-1)
        n = flat.numel()
        chunk = chunk or MEAN_CHUNK
        if round16 and math.prod(x.shape[:-1]) > 1:   # not one plane row
            chunk = max(n, 1)
        with self.part("decode_sum"):
            if chunk >= n and round16:
                return x.copy_(ordered_mean(
                    self.world, lambda r: row(r, 0, n).view(x.shape),
                    round16))
            for a in range(0, n, chunk):
                b = min(n, a + chunk)
                r16 = [(max(lo, a) - a, min(hi, b) - a)
                       for lo, hi in round16 if lo < b and hi > a]
                flat[a:b].copy_(ordered_mean(
                    self.world, lambda r: row(r, a, b), r16))
        return x

    def gather_into(self, sent: Sequence[torch.Tensor],
                    dests: Sequence[Sequence[torch.Tensor]],
                    count: Optional[CollectiveCount] = shard_gather) -> None:
        """:meth:`all_gather` with parts that differ from rank to rank:
        rank r sends parts shaped and typed as ``dests[r]`` (``sent`` is
        this rank's, like ``dests[self.rank]``), and each rank's parts land
        in ``dests[r]`` (contiguous tensors, e.g. views of the leaves a
        forward reads): every rank's bytes cross the wire once and are
        copied once, into their destinations (from host memory straight to
        the card where the wire is staged)."""
        packings = [self._packing(d) for d in dests]
        out = self._gather_packed(sent, packings, count)
        with self.part("h2d", count if self.staged else None):
            for r, (offsets, _, _) in enumerate(packings):
                for i, d in enumerate(dests[r]):
                    n = d.numel() * d.element_size()
                    d.view(-1).copy_(out[r, offsets[i]:offsets[i] + n]
                                     .view(d.dtype), non_blocking=self.staged)

    def gather_leaves(self, parts: Sequence[torch.Tensor], splits,
                      count: Optional[CollectiveCount] = wire
                      ) -> List[torch.Tensor]:
        """The whole leaves of an FSDP-sharded tree, one all-gather: rank
        r's ``parts`` (its parts of the leaves, ``splits[i]`` a
        ``sharding.specs.LeafSplit`` over this group's ranks) land in part
        r of each whole leaf, along its split dimension; an unsplit leaf is
        its part itself. Returns new whole leaves (the unsplit ones as
        given). ``count`` gets one collective and the bytes this rank sent,
        the seconds as part ``gather``."""
        idx = [i for i, s in enumerate(splits) if s.split]
        out = list(parts)
        if not idx:
            return out
        with self.part("gather", count):
            for i in idx:
                out[i] = torch.empty(splits[i].shape, dtype=parts[i].dtype,
                                     device=parts[i].device)
            dests = [[splits[i].part(out[i], r) for i in idx]
                     for r in range(self.world)]
            packings = [self._packing([parts[i] for i in idx])] * self.world
            got = self._gather_packed([parts[i] for i in idx], packings,
                                      count, timed=False)
            offsets = packings[0][0]
            for r in range(self.world):
                for j, (i, d) in enumerate(zip(idx, dests[r])):
                    if r == self.rank:
                        d.copy_(parts[i])
                        continue
                    n = d.numel() * d.element_size()
                    d.copy_(got[r, offsets[j]:offsets[j] + n].view(d.dtype)
                            .view(d.shape), non_blocking=self.staged)
        return out

    def _exchange_parts(self, x: torch.Tensor, split,
                        count: Optional[CollectiveCount]) -> dict:
        """Part r of ``x`` (``split``, a ``sharding.specs.LeafSplit`` over
        this group's ranks) sent to rank r in float32, one all-to-all:
        returns every rank's part of its own ``x`` that this rank
        received, flat, on its device, by rank (this rank's own part
        stays put). ``count`` gets one collective and the bytes this rank
        sent to the others."""
        R, me, n = self.world, self.rank, split.part_numel
        host = self.staged or self.device.type == "cpu"
        with self.part("d2h", count if self.staged else None):
            send = torch.empty((R, n), dtype=torch.float32,
                               device="cpu" if host else self.device,
                               pin_memory=self.staged)
            for r in range(R):        # this rank's own part stays put
                if r != me:           # widened on the device, then copied
                    send[r].view(split.part_shape).copy_(
                        split.part(x, r).float())
        recv = torch.empty((R, n), dtype=torch.float32, device=send.device,
                           pin_memory=self.staged)
        with self.part("wire", count):
            self._all_to_all(recv, send)
        if count is not None:
            count.n += 1
            count.bytes += 4 * n * (R - 1)
        charge_collective("all-to-all", 4 * recv.numel(), self.cross_pod)
        del send
        with self.part("h2d", count if self.staged else None):
            rows = {r: (recv[r].to(self.device) if self.staged else recv[r])
                    for r in range(R) if r != me}
        del recv
        rows[me] = split.part(x).contiguous().view(-1)
        return rows

    def mean_slices(self, x: torch.Tensor, split,
                    count: Optional[CollectiveCount] = wire) -> torch.Tensor:
        """This rank's part (``split``, a ``sharding.specs.LeafSplit``
        over this group's ranks) of the mean over the ranks of ``x``, each
        rank's own whole leaf, one all-to-all: part r of every rank's ``x``
        goes to rank r in float32 (:func:`gather_mean_`'s wire), and each
        rank takes the :func:`ordered_mean` of the parts it holds, in rank
        order, cast to ``x``'s dtype: bit for bit its part of
        ``gather_mean_(x)``. ``all_to_all`` rather than
        ``reduce_scatter``, which adds in its own order. Returns a new
        contiguous tensor. ``count`` gets one collective and the bytes
        this rank sent to the others."""
        rows = self._exchange_parts(x, split, count)
        out = torch.empty(split.part_shape, dtype=x.dtype, device=x.device)
        return self.mean_(out, lambda r, a, b: rows[r][a:b])

    def sum_slices(self, x: torch.Tensor, dim: int,
                   count: Optional[CollectiveCount] = None) -> torch.Tensor:
        """This rank's slice along ``dim`` (the world's equal parts, in
        rank order) of the sum over the ranks of ``x``, one all-to-all:
        the float32 sum in rank order, rounded once to ``x``'s dtype, bit
        for bit this rank's slice of :func:`ordered_sum` (a
        reduce-scatter). ``count`` defaults to :data:`tp`."""
        from repro_torch.sharding.specs import LeafSplit
        split = LeafSplit(tuple(x.shape), dim, self.world, self.rank)
        rows = self._exchange_parts(x.detach(), split,
                                    tp if count is None else count)
        acc = rows[0].clone()
        for r in range(1, self.world):
            acc.add_(rows[r])
        return acc.view(split.part_shape).to(x.dtype)

    def gather_stacked(self, tree, *, to_device: bool,
                       count: Optional[CollectiveCount] = side):
        """Every rank's rows of ``tree`` (tensors whose leading axis is
        this rank's one worker) stacked on that axis in rank order, one
        collective a leaf: the stacked run's tensors (on this rank's device
        with ``to_device``; else, staged, left on the host)."""
        from repro_torch.tree import tree_map
        return tree_map(lambda t: self.all_gather(
            [t], count, to_device=to_device)[0].reshape(
                (self.world * t.shape[0],) + tuple(t.shape[1:])), tree)


class DryGroup(RankGroup):
    """Rank ``rank`` of a grid of any size, played without a process group:
    the dry-run's group (``launch/dryrun.py``). The program runs as on a
    real rank, on ``meta`` tensors; the two calls that move data
    (:meth:`_all_gather`, :meth:`_all_to_all`) move nothing and leave
    their outputs as the real collective shapes them, and each collective
    is recorded in :attr:`log` (shared with the sub-groups
    :meth:`RankGroup.split` opens, without ``dist.new_group``): its kind,
    output bytes, the ranks and grid axes it spans, and whether it crosses
    pods. The counters (:data:`wire`, :data:`tp`, :data:`side`,
    :data:`shard_gather`) count as in a real run.

    ``grid``: ``{"data": D, "model": M}``, or with ``"pod": P`` in front
    (the reference's ``(pod, data, model)`` mesh), laid out as
    ``GridLayout.of(grid)`` until :meth:`RankGroup.split` lays it out
    again (``launch/dryrun.py`` folds the pods into ``data`` where they
    are not the workers). Ranks r and s share a pod where
    ``r // (D·M) == s // (D·M)``."""

    def __init__(self, grid: Dict[str, int], rank: int = 0,
                 device="meta") -> None:
        self.pod_ranks = int(grid.get("data", 1)) * int(grid.get("model", 1))
        self.log: List[Dict[str, Any]] = []
        self._setup(list(range(int(grid.get("pod", 1)) * self.pod_ranks)),
                    rank, device)
        self.layout = GridLayout.of(grid)
        self.root = self

    def _setup(self, members: List[int], rank: int, device) -> None:
        self.group, self.backend = None, "dry"
        self.members, self.world = members, len(members)
        self.rank = members.index(rank)
        self.layout = GridLayout(self.world, 1)
        self.workers, self.shards, self._along = self, None, {}
        self.device = torch.device(device)
        self.staged = self.timed = False
        self._round_t0 = None
        self._shared = False

    @property
    def global_rank(self) -> int:
        return self.members[self.rank]

    @property
    def cross_pod(self) -> bool:
        return len({m // self.root.pod_ranks for m in self.members}) > 1

    @property
    def axes(self) -> Tuple[str, ...]:
        """The grid axes along which this group's ranks differ (``pod``
        where they lie in several pods)."""
        lay = self.root.layout
        coords = [lay.coords_of(m) for m in self.members]
        out = tuple(a for a in lay.axes if len({c[a] for c in coords}) > 1)
        if self.cross_pod and "pod" not in out:
            out = ("pod",) + out
        return out

    def _new_group(self, ranks: List[int]) -> Optional["DryGroup"]:
        if self.rank not in ranks:
            return None
        sub = DryGroup.__new__(DryGroup)
        sub.root, sub.log = self.root, self.log
        sub._setup([self.members[r] for r in ranks], self.global_rank,
                   self.device)
        return sub

    def _record(self, kind: str, out: torch.Tensor) -> None:
        self.log.append({"kind": kind,
                         "bytes": out.numel() * out.element_size(),
                         "world": self.world, "axes": self.axes,
                         "cross_pod": self.cross_pod})

    def _all_gather(self, out: torch.Tensor, buf: torch.Tensor) -> None:
        self._record("all-gather", out)

    def _all_to_all(self, recv: torch.Tensor, send: torch.Tensor) -> None:
        self._record("all-to-all", recv)


def gather_mean_(x: torch.Tensor, group: RankGroup, round16=(),
                 wire_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sync mean over ranks, one collective: every rank's ``x`` (this
    rank's row of a worker-stacked tensor, or any tensor of one shape on
    every rank) all-gathered, summed in float32 in rank order, times
    ``f32(1/R)``, cast back to ``x``'s dtype and written over ``x``:
    :func:`worker_mean_`'s arithmetic, so R ranks give the stacked mean of
    R workers bit for bit. The wire carries ``x`` in ``wire_dtype`` (its
    own by default; values must be exact in it). ``all_reduce(SUM)`` is not
    used: NCCL and gloo add in their own order. Returns ``x``."""
    sent = x if wire_dtype in (None, x.dtype) else x.to(wire_dtype)
    (rows,) = group.all_gather([sent])
    return group.mean_(x, lambda r, a, b: rows[r].view(-1)[a:b], round16)


# --------------------------------------------------------------------------- #
# tensor parallelism: Megatron's f and g over the model sub-group
# --------------------------------------------------------------------------- #
def ordered_sum(group: RankGroup, x: torch.Tensor,
                count: Optional[CollectiveCount] = None) -> torch.Tensor:
    """Every rank's ``x`` summed in float32 in rank order (one all-gather
    of the float32 values), rounded once to ``x``'s dtype: the same bits
    on every rank of ``group``. ``all_reduce(SUM)`` is not used: NCCL and
    gloo add in their own order, and a bf16 all-reduce would round each
    partial. ``count`` defaults to :data:`tp`."""
    (rows,) = group.all_gather([x.detach().float()],
                               count=tp if count is None else count)
    acc = rows[0].clone()
    for r in range(1, group.world):
        acc.add_(rows[r])
    return acc.to(x.dtype)


class _Copy(torch.autograd.Function):
    """Identity forward, :func:`ordered_sum` of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(ctx.group, g), None


class _Sum(torch.autograd.Function):
    """:func:`ordered_sum` forward, identity backward. With a ``log``
    (:class:`TPSumLog`) replaying, the sum recorded by the first forward is
    returned instead: a recomputation issues no collective."""

    @staticmethod
    def forward(ctx, x, group, log):
        if log is not None and log.replaying:
            return log.pop().clone()
        y = ordered_sum(group, x)
        if log is not None:
            log.push(y.detach())
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """Every rank's part concatenated along ``dim`` in rank order forward;
    this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        (rows,) = group.all_gather([x.detach().contiguous()], count=tp)
        return torch.cat(rows.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n)
                .contiguous(), None, None)


class _SeqSplit(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor whole on every rank
    forward; the ranks' slices of the gradient gathered backward (each
    rank's whole gradient, the same bits on every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group.world
        return x.narrow(dim, group.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.group.all_gather([g.contiguous()], count=tp)
        return torch.cat(rows.unbind(0), dim=ctx.dim), None, None


class _SumScatter(torch.autograd.Function):
    """:meth:`RankGroup.sum_slices` forward (a reduce-scatter in rank
    order); the ranks' slices of the gradient gathered backward, each
    partial's gradient the whole one. With a ``log`` replaying, as
    :class:`_Sum`."""

    @staticmethod
    def forward(ctx, x, group, dim, log):
        ctx.group, ctx.dim = group, dim
        if log is not None and log.replaying:
            return log.pop().clone()
        y = group.sum_slices(x, dim)
        if log is not None:
            log.push(y.detach())
        return y

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.group.all_gather([g.contiguous()], count=tp)
        return torch.cat(rows.unbind(0), dim=ctx.dim), None, None, None


class TPSumLog:
    """The outputs of one rematerialised group's :func:`tp_sum` calls, in
    call order: recorded by its forward, handed back to its recomputation
    (remat ``"save_tp"``, ``models/transformer.py``)."""

    def __init__(self) -> None:
        self.saved: List[torch.Tensor] = []
        self.replaying = False
        self._next = 0

    def push(self, y: torch.Tensor) -> None:
        self.saved.append(y)

    def replay(self) -> None:
        self.replaying, self._next = True, 0

    def pop(self) -> torch.Tensor:
        y = self.saved[self._next]
        self._next += 1
        return y


def tp_copy(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Megatron's f: ``x`` (the same on every rank of ``group``) entering
    rank-specific work; its gradient is summed over the ranks."""
    return _Copy.apply(x, group)


def tp_sum(x: torch.Tensor, group: RankGroup,
           log: Optional[TPSumLog] = None) -> torch.Tensor:
    """Megatron's g: the ranks' partial results summed (float32, rank
    order, rounded once); the gradient passes unchanged to each partial."""
    return _Sum.apply(x, group, log)


def tp_gather(x: torch.Tensor, group: RankGroup, dim: int = -1
              ) -> torch.Tensor:
    """The ranks' parts of a tensor split along ``dim`` put together; the
    gradient's slice goes back to each part."""
    return _Gather.apply(x, group, dim % x.ndim)


def sp_split(x: torch.Tensor, group: RankGroup, dim: int = 1
             ) -> torch.Tensor:
    """Sequence parallelism: this rank's slice along ``dim`` of ``x``,
    whole and the same on every rank; the gradient's slices gathered."""
    return _SeqSplit.apply(x, group, dim % x.ndim)


def sp_sum_scatter(x: torch.Tensor, group: RankGroup, dim: int = 1,
                   log: Optional[TPSumLog] = None) -> torch.Tensor:
    """Sequence parallelism's reduce-scatter: the ranks' partial results
    summed (float32, rank order, rounded once: :func:`tp_sum`'s bits) and
    this rank's slice along ``dim`` kept; the gradient's slices
    gathered."""
    return _SumScatter.apply(x, group, dim % x.ndim, log)


def payload_bytes(n_values: int, dtype_bytes: int = 4, compression="",
                  block: int = 256) -> float:
    """Wire bytes for one synced tensor of ``n_values`` elements.

    Dispatches through :func:`repro_torch.core.codecs.get_codec`, so the
    accounting is the wire format ``compressed_sync`` simulates:

    ''/'fp32' -> n · dtype_bytes
    'bf16'    -> n · 2
    'int8'    -> n · 1 byte + one fp32 scale per ``block`` values
    """
    from repro_torch.core.codecs import get_codec
    return get_codec(compression, block=block).wire_bytes(
        n_values, dtype_bytes)


def ef_sync_hbm_bytes(n_values: int, *, fused: bool, dtype_bytes: int = 4,
                      block: int = 256) -> float:
    """Modeled device-memory traffic of ONE worker's error-feedback encode
    of an ``n_values``-element sync payload (int8 codec).

    fused (one pass): read x + residual, write wire + residual'.
    unfused (three passes): EF add, quantize, dequantize, residual update,
    with the int8/scales and v/v̂ intermediates round-tripping memory.
    """
    n = float(n_values)
    d = float(dtype_bytes)
    scales = 4.0 * n / block
    one_pass = (d * n + 4.0 * n) + (d * n + 4.0 * n)
    if fused:
        return one_pass
    q = 1.0 * n + scales
    return (
        (d * n + 4.0 * n) + 4.0 * n          # pass 1: read x,e  write v
        + (4.0 * n + q)                      # pass 2: read v    write q,s
        + (q + 4.0 * n)                      # pass 3: read q,s  write v̂
        + (4.0 * n + 4.0 * n)                # residual: read v, v̂
        + (d * n + 4.0 * n))                 #           write wire, e'


def round_collectives(algorithm: str, n_payload_leaves: int,
                      flat: bool = False) -> int:
    """Collectives ONE sync round issues: the flat plane all-reduces a
    single packed wire array; the per-leaf path pays one all-reduce per
    payload leaf times the algorithm's round multiplier."""
    if flat:
        return 1
    return max(1, int(n_payload_leaves * sync_round_multiplier(algorithm)))


def sync_round_multiplier(algorithm: str) -> float:
    """How many param-sized tensors one communication round moves.

    AdaGrad/AdaAlter  : the gradient all-reduce               -> 1
    Local SGD         : params                                -> 1
    Local AdaAlter    : params + accumulators                 -> 2
    """
    if algorithm in ("sgd", "adagrad", "adaalter", "local_sgd"):
        return 1.0
    if algorithm == "local_adaalter":
        return 2.0
    raise ValueError(algorithm)


def sync_payload_bytes(algorithm: str, n_params: int, dtype_bytes: int = 4,
                       compression="", block: int = 256) -> float:
    """Per-worker wire bytes of ONE communication round; ``train_loop``
    multiplies it by the policy's measured sync count."""
    return sync_round_multiplier(algorithm) * payload_bytes(
        n_params, dtype_bytes, compression, block)


def fsdp_step_bytes(n_params: int, n_split: int, world: int,
                    param_bytes: int = 4,
                    split_bytes: Optional[int] = None) -> float:
    """Wire bytes ONE rank of an FSDP group of ``world`` ranks contributes
    to a step of a run whose split leaves hold ``n_split`` of its
    ``n_params`` values: its part of the split params (``split_bytes /
    world``; ``split_bytes``, the split leaves' bytes, defaults to
    ``n_split`` values of ``param_bytes``, and differs where a leaf keeps
    another dtype, as the MoE's float32 router in a bf16 model), the parts
    of its float32 gradient it sends the others (``n_split · (world − 1) /
    world``), and the unsplit leaves' float32 gradients (``n_params −
    n_split``). At float32 params: 4·n_params for every ``world``, the
    replicated run's gradient mean; FSDP saves memory, not wire."""
    if split_bytes is None:
        split_bytes = param_bytes * n_split
    return (split_bytes / world
            + 4.0 * n_split * (world - 1) / world
            + 4.0 * (n_params - n_split))


def sync_bytes_per_step(algorithm: str, n_params: int, H: int = 1,
                        dtype_bytes: int = 4, compression="",
                        block: int = 256) -> float:
    """MODELED average per-step communication volume per worker (bytes),
    assuming the fixed every-H-steps schedule.

    AdaGrad/AdaAlter  : gradient all-reduce every step        -> P
    Local SGD         : params every H steps                  -> P/H
    Local AdaAlter    : params + accumulators every H steps   -> 2P/H
    """
    per_round = sync_payload_bytes(algorithm, n_params, dtype_bytes,
                                   compression, block)
    if algorithm in ("sgd", "adagrad", "adaalter"):
        return per_round
    return per_round / H


def step_time(algorithm: str, n_params: int, compute_time: float,
              n_workers: int, H: int = 1,
              fabric: FabricModel = FabricModel(), cross_pod: bool = False,
              dtype_bytes: int = 4, compression: str = "",
              block: int = 256) -> float:
    """The paper's Figure-1 model: a step's wall time = compute + the
    round's all-reduce time (``sync_round_multiplier`` param-sized tensors
    over ``fabric``), amortized over H steps for the local optimizers."""
    if algorithm == "none":
        return compute_time
    p = payload_bytes(n_params, dtype_bytes, compression, block)
    mult = sync_round_multiplier(algorithm)
    comm = mult * fabric.allreduce_time(p, n_workers, cross_pod)
    if algorithm in ("local_sgd", "local_adaalter"):
        comm /= H
    return compute_time + comm

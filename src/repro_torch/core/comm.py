"""Communication: the sync mean's arithmetic, the bytes each round moves,
and the alpha-beta time model of a round.

The byte accounting and the alpha-beta model of the JAX package's
``core/comm.py``. :class:`FabricModel` keeps the reference's field names
(traces of either package carry ``dataclasses.asdict(FabricModel())`` and
each package reads the other's), with the H100 SXM's links as defaults.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FabricModel:
    """Bandwidths in bytes/s; latency in s per collective.

    ``ici_bw``   the intra-node link: NVLink 4, 450 GB/s a direction per
                 H100 SXM (NVIDIA data sheet);
    ``dcn_bw``   the inter-node link: one NDR InfiniBand port, 400 Gb/s =
                 50 GB/s per GPU (NVIDIA data sheet);
    ``latency``  launch and rendezvous of one collective: an assumption
                 (10 µs), not a measurement. It waits for the port's
                 multi-card workers (ROADMAP Queue 1 item 9) to be measured.
    """
    ici_bw: float = 450e9
    dcn_bw: float = 50e9
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


def collective_time(n_bytes: float, n_collectives: int, n_workers: int,
                    fabric: FabricModel = FabricModel(),
                    cross_pod: bool = False) -> float:
    """:meth:`FabricModel.collective_time` of the default fabric."""
    return fabric.collective_time(n_bytes, n_collectives, n_workers,
                                  cross_pod)


def worker_mean_(x: torch.Tensor, round16=()) -> torch.Tensor:
    """Replace every row of ``x``'s leading (worker) axis by the mean over
    that axis, in place, as the reference's jitted ``jnp.mean`` computes it:
    the R rows summed in float32 one after another (row 0 + row 1, then
    + row 2, ...), times ``f32(1/R)``, cast back to ``x``'s dtype. The sum
    is spelled out as a loop because a reduction kernel may add a short
    axis in another order. ``round16`` lists ``(start, stop)`` ranges of the
    last axis whose mean is rounded through bfloat16 (a flat plane's 16-bit
    slots). Returns ``x``."""
    workers = x.shape[0]
    if workers == 1:              # the sum of one row, times f32(1): x
        return x
    acc = x[0].float() + x[1]
    for r in range(2, workers):
        acc.add_(x[r])
    acc.mul_(torch.as_tensor(np.float32(1.0) / np.float32(workers),
                             device=x.device))
    for start, stop in round16:
        seg = acc[..., start:stop]
        seg.copy_(seg.to(torch.bfloat16))
    return x.copy_(acc.expand_as(x))      # the copy rounds to x's dtype


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

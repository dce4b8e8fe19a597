"""Communication: the sync mean's arithmetic and the bytes each round moves.

The byte accounting of the JAX package's ``core/comm.py``, copied. Its
fabric time model is not carried over: its constants describe another
machine's interconnect.
"""
from __future__ import annotations

import numpy as np
import torch


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

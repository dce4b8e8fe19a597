"""Wire formats for the sync payload: numerics and byte accounting.

  fp32   the paper's payload — 4 bytes/value, lossless;
  bf16   round to bfloat16 — 2 bytes/value, with error feedback;
  int8   per-block int8 + one fp32 scale per ``block`` values — ~3.94x
         less at block=256, with error feedback through the one-pass
         encode kernel (``kernels/sync_fused.py``), or through the
         quantize/dequantize pair (``kernels/quantize.py``) unfused.

A :class:`WireCodec` is the single source of both the numerics
(``encode``/``decode``, or the fused ``ef_roundtrip``) and the accounting
(``wire_bytes``) that ``core.comm`` charges.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

#: codec names accepted by OptimizerConfig.compression / --compress.
CODEC_NAMES = ("fp32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One sync wire format: encode/decode numerics + byte accounting.

    encode(x, batch_ndim)        fp32 tensor -> wire payload
    decode(payload, shape, batch_ndim)
                                 wire payload -> fp32 tensor of ``shape``
    wire_bytes(n_values, dtype_bytes)
                                 bytes on the wire for ``n_values`` values
    lossless                     decode(encode(x)) == x bitwise, so error
                                 feedback is a no-op
    decode_range                 optional ``(payload, start, stop)`` ->
                                 elements start:stop of one worker row's
                                 decoded fp32 values, from that row's
                                 payload (int8: its codes and scales, as
                                 they travel between ranks)
    ef_roundtrip                 optional one-pass error-feedback encode
                                 ``(x, residual, batch_ndim, clamp_nonneg,
                                 codes=False) -> (wire, new_residual)``,
                                 with ``codes`` also the wire's encoded
                                 payload (what ``decode`` takes)
    """

    name: str
    lossless: bool
    encode: Callable[[Any, int], Any]
    decode: Callable[[Any, Tuple[int, ...], int], Any]
    wire_bytes: Callable[[int, int], float]
    ef_roundtrip: Optional[Callable[[Any, Any, int, bool],
                                    Tuple[Any, Any]]] = None
    decode_range: Optional[Callable[[Any, int, int], Any]] = None

    def roundtrip(self, x, batch_ndim: int = 0):
        """decode(encode(x)) — the value the sync mean actually averages."""
        return self.decode(self.encode(x, batch_ndim), x.shape, batch_ndim)


def _fp32_codec() -> WireCodec:
    return WireCodec(
        name="fp32", lossless=True,
        encode=lambda x, bnd: x,
        decode=lambda p, shape, bnd: p,
        wire_bytes=lambda n, dtype_bytes=4: float(n * dtype_bytes))


def _bf16_codec() -> WireCodec:
    return WireCodec(
        name="bf16", lossless=False,
        encode=lambda x, bnd: x.to(torch.bfloat16),
        decode=lambda p, shape, bnd: p.float(),
        wire_bytes=lambda n, dtype_bytes=4: float(n * 2))


def _int8_codec(block: int, use_kernels: bool, fused: bool) -> WireCodec:
    # kernel modules are imported inside the closures: accounting callers
    # (comm.payload_bytes) resolve the codec without touching them

    def encode(x, bnd):
        from repro_torch.kernels.quantize import quantize
        return quantize(x, block=block, batch_ndim=min(bnd, x.ndim),
                        use_kernels=use_kernels)

    def decode(payload, shape, bnd):
        from repro_torch.kernels.quantize import dequantize
        q, scales = payload
        return dequantize(q, scales, shape, block=block,
                          batch_ndim=min(bnd, len(shape)),
                          use_kernels=use_kernels)

    def decode_range(payload, start, stop):
        from repro_torch.kernels.quantize import dequantize_range
        return dequantize_range(*payload, start, stop, block=block,
                                use_kernels=use_kernels)

    def ef_roundtrip(x, e, bnd, clamp_nonneg, codes=False):
        from repro_torch.kernels.sync_fused import (fused_ef_leaf,
                                                    fused_ef_leaf_plain)
        if use_kernels:
            return fused_ef_leaf(x, e, block=block, batch_ndim=bnd,
                                 clamp_nonneg=clamp_nonneg, codes=codes)
        return fused_ef_leaf_plain(x, e, block=block, batch_ndim=bnd,
                                   clamp_nonneg=clamp_nonneg, codes=codes)

    return WireCodec(
        name="int8", lossless=False, encode=encode, decode=decode,
        wire_bytes=lambda n, dtype_bytes=4: n * (1.0 + 4.0 / block),
        ef_roundtrip=ef_roundtrip if fused else None,
        decode_range=decode_range)


def get_codec(name, *, block: int = 256, use_kernels: bool = False,
              fused: bool = True) -> WireCodec:
    """Resolve a codec name ('', 'fp32', 'bf16', 'int8') -> WireCodec.
    ``use_kernels`` routes the int8 numerics through the CUDA kernels'
    wrappers, else through their plain versions on any device.
    ``fused=False`` strips the one-pass ``ef_roundtrip``, so the engine
    composes the encode from three passes (quantize, dequantize, residual);
    the two are bitwise identical."""
    if isinstance(name, WireCodec):
        return name
    if name in ("", "fp32"):
        return _fp32_codec()
    if name == "bf16":
        return _bf16_codec()
    if name == "int8":
        return _int8_codec(block, use_kernels, fused)
    raise ValueError(f"unknown compression {name!r} "
                     f"(expected one of {CODEC_NAMES})")

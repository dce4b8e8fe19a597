"""The card the port runs on, as the numbers its models need.

NVIDIA H100 SXM5 80 GB, from NVIDIA's data sheet: the dense tensor-core
peaks (bf16 989 TFLOP/s, TF32 495), the fp32 peak outside the tensor
cores (67 TFLOP/s), HBM3 at 3.35 TB/s and 80 GB, and the links:
NVLink 4 at 450 GB/s a direction and one NDR InfiniBand port (400 Gb/s)
a GPU. ``hbm_bw`` prices the trace's modeled ``ef_encode`` spans; the
links are ``core.comm.FabricModel``'s defaults; ``roofline.analysis``
prices a dry-run with all of them. The field names are the JAX package's
``roofline.analysis.Hardware``'s (``ici_bw``: the link inside a node,
``dcn_bw``: the one between nodes).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12        # bf16 dense, FLOP/s
    hbm_bw: float = 3.35e12           # HBM3, bytes/s
    ici_bw: float = 450e9             # NVLink 4, bytes/s a direction
    dcn_bw: float = 50e9              # NDR InfiniBand, bytes/s a GPU
    hbm_bytes: float = 80e9           # HBM capacity
    tf32_flops: float = 495e12        # TF32 dense, FLOP/s
    fp32_flops: float = 67e12         # fp32 outside the tensor cores


H100 = Hardware()

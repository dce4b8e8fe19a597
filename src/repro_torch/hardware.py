"""The card the port runs on, as the numbers its models need.

NVIDIA H100 SXM5 80 GB, from NVIDIA's data sheet. ``hbm_bw`` prices the
trace's modeled ``ef_encode`` spans; the card's links are
``core.comm.FabricModel``'s defaults.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    hbm_bw: float = 3.35e12           # HBM3, bytes/s


H100 = Hardware()

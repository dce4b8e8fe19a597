"""Three-term roofline of one rank's step, priced on the H100.

The JAX package's ``roofline/analysis.py`` prices a compiled executable;
the port prices the walk of one rank's program (``roofline/cost.py``, on
the ``meta`` device or on the card):

  compute    = FLOPs            / peak_FLOPs_per_chip
  memory     = bytes            / HBM_bandwidth_per_chip
  collective = collective_bytes / link bandwidth (+ cross-pod bytes over
               the inter-node link)

Every count is a rank's own, so no term is divided by the chip count.
:class:`RooflineReport` keeps the reference's fields, properties and
``to_dict`` keys, so the records of either package read alike; in the
port ``hlo_flops`` / ``hlo_bytes`` (``hlo_*_per_chip``) hold the walk's
per-rank counts, the collectives its output bytes by kind (an all-reduce
charged twice, as the reference's ring rule; the port issues all-gathers
and all-to-alls), ``bytes_per_device`` the walk's peak of live bytes, and
``xla_flops`` / ``xla_bytes`` (the reference's ``cost_analysis()``
cross-check) are None: there is no compiler.

``model_flops`` is the standard 6·N·D (2·N·D to serve), N the active
parameters; the ratio to the walk's FLOPs shows remat's recomputation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.hardware import H100, Hardware
from repro_torch.roofline.cost import COLLECTIVES


def collective_wire_bytes(col: Dict[str, float]) -> float:
    """Ring-model wire traffic: all-reduce charged 2x, others 1x."""
    total = 0
    for kind in COLLECTIVES:
        mult = 2 if kind == "all-reduce" else 1
        total += mult * col.get(kind, 0)
    return total


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float                  # per rank: the walk's FLOPs
    hlo_bytes: float                  # per rank: the walk's bytes
    collective_bytes: float           # per rank (wire)
    collectives: Dict[str, float]
    collective_counts: Dict[str, int]
    model_flops_total: float          # 6·N·D, whole job
    bytes_per_device: Optional[float] = None   # the walk's peak live bytes
    hw: Hardware = H100
    cross_pod_bytes: float = 0.0      # collective bytes crossing the pod axis
    xla_flops: Optional[float] = None     # no compiler: None
    xla_bytes: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        t = self.collective_bytes / self.hw.ici_bw
        if self.cross_pod_bytes:
            t += self.cross_pod_bytes / self.hw.dcn_bw
        return t

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def model_flops_per_chip(self) -> float:
        return self.model_flops_total / max(self.n_chips, 1)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / walk FLOPs (per rank): < 1 is recomputation or
        padding."""
        if self.hlo_flops == 0:
            return 0.0
        return self.model_flops_per_chip / self.hlo_flops

    @property
    def step_time(self) -> float:
        """Roofline step time (max of the three overlapping terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        if self.step_time == 0:
            return 0.0
        return self.model_flops_per_chip / self.hw.peak_flops / self.step_time

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "cross_pod_bytes": self.cross_pod_bytes,
            "collectives": dict(self.collectives),
            "collective_counts": self.collective_counts,
            "model_flops_total": self.model_flops_total,
            "bytes_per_device": self.bytes_per_device,
            "xla_flops": self.xla_flops,
            "xla_bytes": self.xla_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu_at_roofline": self.mfu,
        }

    def summary(self) -> str:
        return (f"{self.arch:28s} {self.shape:12s} {self.mesh:10s} "
                f"comp={self.t_compute * 1e3:9.3f}ms "
                f"mem={self.t_memory * 1e3:9.3f}ms "
                f"coll={self.t_collective * 1e3:9.3f}ms "
                f"dom={self.dominant:10s} "
                f"useful={self.useful_flop_ratio:6.3f} "
                f"mfu={self.mfu * 100:5.1f}%")


def model_flops(cfg, shape_cfg) -> float:
    """6·N_active·D total FLOPs for the step the shape lowers (2·N·D to
    serve; a decode step is one token a sequence)."""
    n = cfg.active_param_count()
    if shape_cfg.kind == "decode":
        tokens = shape_cfg.global_batch
    else:
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
    mult = 6.0 if shape_cfg.kind == "train" else 2.0
    return mult * n * tokens


def analyze(cost, *, arch: str, shape_name: str, mesh_name: str,
            n_chips: int, model_flops_total: float,
            hw: Hardware = H100) -> RooflineReport:
    """A :class:`RooflineReport` from a ``roofline.cost.StepCost``."""
    col = {k: float(v) for k, v in cost.coll.items()}
    # a collective that crosses pods goes over the inter-node link alone
    wire = collective_wire_bytes(col) - cost.cross_pod_bytes
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        collective_bytes=float(wire), collectives=col,
        collective_counts=dict(cost.coll_counts),
        model_flops_total=model_flops_total,
        bytes_per_device=float(cost.peak_bytes), hw=hw,
        cross_pod_bytes=float(cost.cross_pod_bytes))

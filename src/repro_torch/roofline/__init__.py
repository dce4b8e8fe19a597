"""Roofline of one rank's step: the walk of its aten ops (``cost``), its
three terms on the H100 (``analysis``) and the card's own kernel times
(``profile``)."""
from repro_torch.hardware import H100, Hardware
from repro_torch.roofline.analysis import (RooflineReport, analyze,
                                           collective_wire_bytes,
                                           model_flops)
from repro_torch.roofline.cost import (Region, StepCost, region_table,
                                       step_cost)

__all__ = ["H100", "Hardware", "Region", "RooflineReport", "StepCost",
           "analyze", "collective_wire_bytes", "model_flops", "region_table",
           "step_cost"]

"""Sharding over a (workers × shards) grid of ranks: the port's
counterparts of the JAX package's ``sharding/partition.py`` (logical-axis
rules) and ``sharding/specs.py`` (per-leaf specs, the flat plane's
layout), with the part of a leaf each rank holds (``LeafSplit``,
``TileSplit``)."""
from repro_torch.sharding.partition import ShardingRules, plane_shard_axes
from repro_torch.sharding.specs import (GridLayout, LeafSplit, TileSplit,
                                        leaf_split, logical_for_leaf,
                                        param_shardings, plane_shard_count,
                                        plane_shardings, shape_safe_spec,
                                        tile_parts)

__all__ = ["GridLayout", "LeafSplit", "ShardingRules", "TileSplit",
           "leaf_split", "logical_for_leaf", "param_shardings",
           "plane_shard_axes", "plane_shard_count", "plane_shardings",
           "shape_safe_spec", "tile_parts"]

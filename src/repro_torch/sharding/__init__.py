"""Sharding plans over a (workers × shards) grid of ranks: the port's
counterparts of the JAX package's ``sharding/partition.py`` and
``sharding/specs.py`` for the sharded flat plane."""
from repro_torch.sharding.partition import plane_shard_axes
from repro_torch.sharding.specs import (GridLayout, plane_shard_count,
                                        plane_shardings)

__all__ = ["GridLayout", "plane_shard_axes", "plane_shard_count",
           "plane_shardings"]

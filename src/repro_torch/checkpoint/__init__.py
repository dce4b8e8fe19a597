"""Checkpoints in the JAX package's on-disk format (npz payload + JSON
manifest): either package restores the other's."""
from repro_torch.checkpoint.store import (checkpoint_keys, checkpoint_layout,
                                          disk_like, latest_step,
                                          restore_checkpoint, save_checkpoint)

__all__ = ["checkpoint_keys", "checkpoint_layout", "disk_like",
           "latest_step", "restore_checkpoint", "save_checkpoint"]

"""Deterministic synthetic LM data."""
from repro_torch.data.synthetic import SyntheticLM, make_train_batch

__all__ = ["SyntheticLM", "make_train_batch"]

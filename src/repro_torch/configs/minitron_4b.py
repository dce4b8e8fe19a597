"""Minitron-4B — pruned Nemotron dense decoder.

[arXiv:2407.14679; 32 layers, d_model=3072, 24 heads / 8 kv heads,
 d_ff=9216, vocab=256000]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="arXiv:2407.14679",
)

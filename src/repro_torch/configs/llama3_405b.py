"""Llama-3 405B — dense decoder, GQA, 128k vocab.

[arXiv:2407.21783; 126 layers, d_model=16384, 128 heads / 8 kv heads,
 d_ff=53248, vocab=128256]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="arXiv:2407.21783",
)

"""Phi-4-mini 3.8B — dense decoder, RoPE + SwiGLU + GQA.

[arXiv:2412.08905; 32 layers, d_model=3072, 24 heads / 8 kv heads,
 d_ff=8192, vocab=200064]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="arXiv:2412.08905",
)

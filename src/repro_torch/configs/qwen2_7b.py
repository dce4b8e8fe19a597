"""Qwen2-7B — dense decoder, GQA with QKV bias.

[arXiv:2407.10671; 28 layers, d_model=3584, 28 heads / 4 kv heads,
 d_ff=18944, vocab=152064, qkv bias]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="arXiv:2407.10671",
)

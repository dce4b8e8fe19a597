"""Phi-3.5-MoE 42B-A6.6B — 16 experts, top-2 routing.

[hf:microsoft/Phi-3.5-MoE-instruct; 32 layers, d_model=4096,
 32 heads / 8 kv heads, d_ff(expert)=6400, vocab=32064, 16e top-2]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    moe_every=1,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

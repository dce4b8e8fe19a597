"""Hymba-1.5B — hybrid-head: parallel attention + mamba heads per layer.

[arXiv:2411.13676; 32 layers, d_model=1600, 25 heads / 5 kv heads
 (head_dim=64), d_ff=5504, vocab=32001, ssm_state=16; attention and SSM
 heads run in PARALLEL on the same input and are mean-fused.]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hybrid=True,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=64,
    sliding_window=1024,       # Hymba uses SWA on most layers
    long_context_mode="ssm",   # SSM path carries long context natively
    source="arXiv:2411.13676",
)

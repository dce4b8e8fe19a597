"""Mamba2-370m — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060, Dao & Gu 2024; mamba2-370m: 48 layers, d_model=1024,
 d_state=128, expand=2, headdim=64, vocab=50280]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,                    # no separate FFN; the mamba block is the mixer
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=64,
    long_context_mode="ssm",   # O(1) decode state -> long_500k native
    source="arXiv:2405.21060",
)

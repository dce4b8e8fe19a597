"""Llama-4 Maverick 400B-A17B — MoE, 128 experts top-1, interleaved dense.

[hf:meta-llama/Llama-4-Scout-17B-16E family card; Maverick variant:
 128 routed experts, top-1 routing, shared expert, MoE every other layer,
 intermediate_size(expert)=8192, intermediate_size_mlp(dense/shared)=16384]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                 # per-expert FFN width
    dense_d_ff=16384,          # dense-layer / shared-expert FFN width
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    moe_every=2,               # MoE on every other layer (Maverick)
    shared_expert=True,
    rope_theta=500000.0,
    sliding_window=8192,       # used only in long_context_mode
    long_context_mode="sliding_window",
    source="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick 400B-A17B variant)",
)

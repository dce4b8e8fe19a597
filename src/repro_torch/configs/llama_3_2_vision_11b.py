"""Llama-3.2-Vision 11B — decoder with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; 40 layers, d_model=4096,
 32 heads / 8 kv heads, d_ff=14336, vocab=128256; cross-attn every 5th
 layer over vision tokens. The ViT/SigLIP frontend is STUBBED:
 input_specs() provides projected patch embeddings (batch, n_img, d_model).]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    n_image_tokens=1601,       # 1 tile x (40x40 patches + cls) as in the card
    rope_theta=500000.0,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

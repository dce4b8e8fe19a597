"""SeamlessM4T-large-v2 — encoder-decoder multimodal (audio) backbone.

[arXiv:2308.11596; transformer backbone only: 24 encoder + 24 decoder
 layers, d_model=1024, 16 heads (MHA: kv=16), d_ff=8192, vocab=256206.
 The speech frontend (mel + conformer conv) is STUBBED: input_specs()
 provides precomputed frame embeddings of shape (batch, frames, d_model).]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,               # decoder layers
    n_encoder_layers=24,       # encoder layers over stubbed frame embeddings
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    act="gelu",
    vocab_size=256206,
    sliding_window=8192,
    long_context_mode="sliding_window",
    source="arXiv:2308.11596",
)

"""Big LSTM (LSTM-2048-512) — the paper's own evaluation model.

[Jozefowicz et al., arXiv:1602.02410, "LSTM-2048-512": 2-layer LSTM with
 2048 units projected to 512, word embeddings 512, vocab 793471 (1B-Word).
 Used by Local AdaAlter (arXiv:1911.09030) with 10% dropout.]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="biglstm",
    family="lstm",
    n_layers=2,
    d_model=2048,              # LSTM hidden units
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=793471,
    lstm_proj=512,             # recurrent projection + embedding size
    long_context_mode="ssm",   # O(1) recurrent decode state
    source="arXiv:1602.02410 via arXiv:1911.09030",
)

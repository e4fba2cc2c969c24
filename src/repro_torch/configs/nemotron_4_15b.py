"""nemotron-4-15b — GQA + squared-ReLU FFN [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    act="squared_relu",    # Nemotron uses squared ReLU, non-gated
    norm="layernorm",
    rope="rope",
    rope_frac=0.5,         # Nemotron-4 rotary on 50% of head dim
)

"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (MHA) d_ff=5632 vocab=100352, partial rotary (25%),
LayerNorm.  The port's non-VLM dense config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    act="swiglu",
    norm="layernorm",
    rope="partial",
    rope_frac=0.25,
)

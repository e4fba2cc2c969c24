"""deepseek-67b — dense llama-arch [arXiv:2401.02954].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400, SwiGLU, RMSNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    rope="rope",
    rope_theta=10000.0,
)

"""deepseek-moe-16b — fine-grained + shared experts [arXiv:2401.06066].

28L d_model=2048 16H (kv=16 -> MHA) d_ff=1408/expert, 2 shared + 64 routed
top-6, vocab 102400.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    rope="rope",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  d_ff_shared=2816),
)

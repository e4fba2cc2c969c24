"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576, MoE 16e top-2 every other layer,
vocab 65536.  Layout: 9 groups of 8 sublayers; attention at in-group index 4,
Mamba elsewhere; MoE FFN on odd in-group indices.  Sub-quadratic (runs
long_500k: only the 9 attention layers hold a 500k KV cache).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    rope="none",           # Jamba uses no positional embedding
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128, n_groups=1,
                  chunk_size=256),
    hybrid_group=8,
    attn_every=4,
    subquadratic=True,
)

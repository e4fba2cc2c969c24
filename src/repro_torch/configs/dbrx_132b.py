"""dbrx-132b — fine-grained MoE [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert, 16 experts top-4,
vocab 100352.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    act="swiglu",
    norm="layernorm",
    rope="rope",
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)

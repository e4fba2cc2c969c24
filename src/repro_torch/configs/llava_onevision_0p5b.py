"""llava-onevision-0.5b — the paper's own demonstration model.

SigLip vision encoder (stubbed frontend -> patch features of width 1152) +
projector + Qwen2-0.5B decoder: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, tied embeddings, qkv biases.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-onevision-0.5b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    act="swiglu",
    norm="rmsnorm",
    rope="rope",
    rope_theta=1000000.0,
    tie_embeddings=True,
    vlm=True,
    vision_feat_dim=1152,
    vision_tokens=729,     # 27x27 patches (SigLip-384)
    vision_token_buckets=(196, 729),
    vision_max_images=4,
    max_stage_batch=4,
    attn_sharding="context",
)

"""qwen2-vl-7b — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, untied
``lm_head``, qkv biases.  The vision frontend (ViT) is a stub: requests
carry precomputed patch features (width 1280, the Qwen2-ViT hidden
size); the projector, the multimodal merge and the decoder are real
bricks.  ``attn_sharding="context"`` (28 heads do not divide a 16-way
model axis) has no effect on one card and is kept as data.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    rope="mrope",
    rope_theta=1000000.0,
    vlm=True,
    vision_feat_dim=1280,
    vision_tokens=1024,    # the full-resolution patch grid
    # dynamic resolution quantized to two static slab shapes: low-res
    # (256 merged patches) and the full 1024-patch grid, up to 4 images
    # per request (video frames bucket the same way)
    vision_token_buckets=(256, 1024),
    vision_max_images=4,
    # 1024-patch slabs at d_model 3584 are memory-heavy: at most two
    # requests per staging commit
    max_stage_batch=2,
    attn_sharding="context",
)

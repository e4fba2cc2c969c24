"""seamless-m4t-large-v2 — encoder-decoder multimodal [arXiv:2308.11596].

24L (enc) + 24L (dec), d_model=1024 16H (kv=16) d_ff=8192 (GELU, not
gated) vocab=256206, LayerNorm, RoPE, tied embeddings.  The audio
frontend is a stub: a request carries precomputed frame embeddings (B,
T, d_model).  Decode uses a fixed 8192-frame encoder memory
(``enc_seq_len``) beside the decoder's self-cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,           # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    act="gelu",
    norm="layernorm",
    rope="rope",
    tie_embeddings=True,
    encdec=True,
    n_enc_layers=24,
    enc_seq_len=8192,
)

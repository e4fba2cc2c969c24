"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attention-free (d_ff=0: pure Mamba-2 blocks), vocab
50280, tied embeddings; 64 SSD heads of 64 (expand 2), one B/C group,
state 128, conv 4, chunk 256.  The port's ``ssm`` config: prefill runs
the SSD chunked scan (``kernels/ssd``) in every layer, decode carries a
fixed-size per-request state (conv tail + SSD state) in the slot pool.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,            # SSD heads = expand*d_model/head_dim = 4096/64
    n_kv_heads=64,
    d_ff=0,                # attn-free, no MLP (Mamba-2 block only)
    vocab_size=50280,
    head_dim=64,
    rope="none",
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    subquadratic=True,
)

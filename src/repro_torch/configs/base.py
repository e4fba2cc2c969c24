"""Model configuration: the port's own copy of the reference's
``ModelConfig`` (frozen dataclass, same fields, same ``reduced()``).

The one change is the dtype mapping: :attr:`ModelConfig.torch_dtype`
maps ``cfg.dtype`` to a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (raises on unknown names)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}") from None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (routed + shared experts)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    every: int = 1
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) mixer configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture (the reference's field set, unchanged)."""

    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    act: str = "swiglu"           # swiglu | squared_relu | gelu | geglu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    rope: str = "rope"            # rope | mrope | partial | none
    rope_frac: float = 1.0
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_group: int = 0
    attn_every: int = 0
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 8192
    vlm: bool = False
    vision_feat_dim: int = 0
    vision_tokens: int = 0
    vision_token_buckets: Tuple[int, ...] = ()
    vision_max_images: int = 1
    max_stage_batch: int = 4
    dtype: str = "bfloat16"
    attn_impl: str = "softmax"
    attn_sharding: str = "head"
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    vocab_pad_to: int = 512
    remat: bool = True
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (same cuts as the
        reference's ``reduced()``)."""
        small = dict(
            n_layers=min(self.n_layers, 2 * max(1, self.hybrid_group)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            vocab_pad_to=64,
            remat=False,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64, d_ff_shared=64 if self.moe.n_shared else 0)
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=32)
        if self.encdec:
            small["n_enc_layers"] = 2
            small["enc_seq_len"] = 64
        if self.vlm:
            small["vision_feat_dim"] = 48
            small["vision_tokens"] = 8
            small["vision_token_buckets"] = (2, 8)
        small.update(overrides)
        return dataclasses.replace(self, **small)

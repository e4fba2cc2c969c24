"""Shared model building blocks: init, norms, activations, rotary
embeddings.  Parameters are plain dict trees of tensors in the reference's
layouts; norm statistics run in fp32."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers (the reference's shapes and scales, torch's own numbers)
# ---------------------------------------------------------------------------


def _trunc_normal(shape, generator, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], by inverse CDF."""
    lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(3.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = lo + (hi - lo) * u
    return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


def dense_init(generator, shape, dtype, device, fan_in: Optional[int] = None):
    """Truncated-normal init scaled by 1/sqrt(fan_in) (LLaMA-style)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    return (_trunc_normal(shape, generator, device) * std).to(dtype)


def embed_init(generator, shape, dtype, device):
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

def init_norm(cfg, d: int, device, lead=()):
    dt = cfg.torch_dtype
    p = {"scale": torch.ones(tuple(lead) + (d,), dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(tuple(lead) + (d,), dtype=dt, device=device)
    return p


def apply_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, or LayerNorm when ``p`` has a bias; statistics in fp32."""
    xf = x.to(torch.float32)
    if "bias" in p:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].to(torch.float32)
                + p["bias"].to(torch.float32)).to(x.dtype)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# activations (the reference's gelu is the tanh form)
# ---------------------------------------------------------------------------

def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _squared_relu(x):
    return torch.relu(x).square()


_ACTS = {"gelu": _gelu, "silu": F.silu, "relu": torch.relu,
         "squared_relu": _squared_relu}


def activation(name: str):
    return _ACTS[name]


# ---------------------------------------------------------------------------
# rotary position embeddings (RoPE / partial RoPE / M-RoPE)
# ---------------------------------------------------------------------------

def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    ex = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    # theta filled on the device (no host copy: a CUDA graph captures it)
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), ex)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_frac: float = 1.0) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) int.  Partial RoPE rotates only
    the first ``rope_frac`` of head_dim."""
    hd = x.shape[-1]
    rot = int(hd * rope_frac)
    rot -= rot % 2
    if rot == 0:
        return x
    freqs = _rope_freqs(rot, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x_rot = _rotate(x[..., :rot], cos, sin)
    if rot == hd:
        return x_rot
    return torch.cat([x_rot, x[..., rot:]], dim=-1)


# M-RoPE (Qwen2-VL): the rotated half of head_dim is split into
# (temporal, height, width) frequency sections, each rotated with its own
# position stream.
MROPE_SECTIONS = (0.25, 0.375, 0.375)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """x (B, S, H, hd); positions3 (3, B, S) int (t, h, w streams).
    Angles in fp32; cos/sin cast to ``x.dtype`` before the rotation."""
    hd = x.shape[-1]
    half = hd // 2
    sec = [int(half * f) for f in MROPE_SECTIONS]
    sec[-1] = half - sec[0] - sec[1]
    freqs = _rope_freqs(hd, theta, x.device)              # (half,)
    parts = []
    off = 0
    for i, s in enumerate(sec):
        pos = positions3[i].to(torch.float32)             # (B, S)
        parts.append(pos[..., None] * freqs[off:off + s])
        off += s
    ang = torch.cat(parts, dim=-1)                        # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin)


def default_positions(batch: int, seq: int, device):
    return torch.arange(seq, dtype=torch.int32,
                        device=device)[None, :].expand(batch, seq)


def default_mrope_positions(batch: int, seq: int, device):
    """Text-only M-RoPE positions: three equal streams, (3, B, S)."""
    p = default_positions(batch, seq, device)
    return torch.stack([p, p, p], dim=0)

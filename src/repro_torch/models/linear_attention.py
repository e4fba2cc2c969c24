"""Streaming linear attention: the paper's sub-quadratic attention (§3.2
GPU), the reference's ``models/linear_attention.py`` in PyTorch.

Causal linear attention with the feature map phi(x) = elu(x) + 1:

    S_t = S_{t-1} + phi(k_t) v_t^T          (hd x hd running summary)
    z_t = z_{t-1} + phi(k_t)                (hd running normalizer)
    o_t = (phi(q_t)^T S_t) / max(phi(q_t)^T z_t, 1e-6)

Prefill is the chunked form (intra-chunk causal products, inter-chunk
state passing), all arithmetic in fp32; decode is one mat-vec against the
running state.  ``linear_attn_prefill`` runs through
``kernels/linear_attention/ops.linear_attention``: the Hopper kernel for
CUDA tensors, the plain chunked form (``linear_attention_chunked``) for
CPU tensors.

Two additions to the reference:

- GQA by kv-head indexing: q (B,S,H,hd) against k/v (B,S,KV,hd), head h
  reading kv head h // (H / KV), never materialising the repeat.  The
  returned state and normalizer stay per query head, (B,H,hd,hd) and
  (B,H,hd), laid out as the reference's state over repeated k/v.
- ``valid_len`` (B,) for right-padded prompts: positions at or past a
  row's ``valid_len`` add nothing to the state and normalizer, and their
  output rows are zero.  The reference engine pads prompts without it,
  so every term phi(k_pad) v_pad^T lands in the slot's state (phi > 0
  everywhere) and every decode step after the first reads it (ROADMAP
  §3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6
# the prefill's chunk (rows per chunk of the chunked form)
PREFILL_CHUNK = 256


def feature_map(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = elu(x) + 1 in fp32."""
    return F.elu(x.to(torch.float32)) + 1.0


def _keep(valid_len: Optional[torch.Tensor], B: int, S: int, device):
    """(B, S) bool: position < the row's valid_len (None: every one)."""
    if valid_len is None:
        return None
    return (torch.arange(S, device=device)[None, :]
            < valid_len.to(device=device, dtype=torch.long)[:, None])


def linear_attention_chunked(q, k, v, *, chunk: int = 256,
                             valid_len: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Causal linear attention over a full sequence, chunked, from a zero
    state: the function the Hopper kernel computes, all arithmetic in
    fp32.  q (B,S,H,hd), k/v (B,S,KV,hd) with H % KV == 0.  Returns (out
    (B,S,H,hd) in q's dtype, state (B,H,hd,hd) fp32, z (B,H,hd) fp32).

    Heads are batched as (B, KV, G, ...) against k/v's (B, KV, 1, ...):
    every matrix product is one (rows x hd) product per head, the same
    shapes as over repeated k/v, so G = 1 on repeated k/v gives the same
    bits."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"linear attention: {H} query heads over {KV} "
                         f"kv heads")
    G = H // KV
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"linear attention: sequence {S} is not a "
                         f"multiple of the chunk {L}")
    nc = S // L
    keep = _keep(valid_len, B, S, q.device)
    kf, vf = feature_map(k), v.to(torch.float32)
    if keep is not None:
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        kf = torch.where(keep[..., None, None], kf, zero)
        vf = torch.where(keep[..., None, None], vf, zero)
    # (B, KV, G, nc, L, hd) and (B, KV, 1, nc, L, hd)
    qc = feature_map(q).reshape(B, nc, L, KV, G, hd).permute(0, 3, 4, 1, 2, 5)
    kc = kf.reshape(B, nc, L, KV, hd).permute(0, 3, 1, 2, 4)[:, :, None]
    vc = vf.reshape(B, nc, L, KV, hd).permute(0, 3, 1, 2, 4)[:, :, None]
    mask = torch.tril(torch.ones((L, L), dtype=torch.float32,
                                 device=q.device))
    state = torch.zeros((B, KV, 1, hd, hd), dtype=torch.float32,
                        device=q.device)
    z = torch.zeros((B, KV, 1, hd, 1), dtype=torch.float32, device=q.device)
    outs = []
    for c in range(nc):
        qi, ki, vi = qc[:, :, :, c], kc[:, :, :, c], vc[:, :, :, c]
        o_inter = torch.matmul(qi, state)                  # (B,KV,G,L,hd)
        z_inter = torch.matmul(qi, z)                      # (B,KV,G,L,1)
        s = torch.matmul(qi, ki.transpose(-1, -2)) * mask  # (B,KV,G,L,L)
        o_intra = torch.matmul(s, vi)
        z_intra = s.sum(dim=-1, keepdim=True)
        # every term of the denominator is positive (phi > 0): it grows
        # with the prompt and nothing cancels
        den = torch.clamp_min(z_inter + z_intra, EPS)
        outs.append((o_inter + o_intra) / den)
        state = state + torch.matmul(ki.transpose(-1, -2), vi)
        z = z + ki.sum(dim=-2)[..., None]
    out = torch.stack(outs, dim=3)                         # (B,KV,G,nc,L,hd)
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(B, S, H, hd)
    if keep is not None:
        out = torch.where(keep[..., None, None], out,
                          torch.zeros((), dtype=out.dtype, device=q.device))
    state = state.expand(B, KV, G, hd, hd).reshape(B, H, hd, hd)
    z = z[..., 0].expand(B, KV, G, hd).reshape(B, H, hd)
    return out.to(q.dtype), state, z


def linear_attention_sequential(q, k, v):
    """The per-token recurrence (the reference's ``ref_linear_attention``,
    the tests' oracle) over k/v already expanded to q's heads: q, k, v
    (B,S,H,hd) -> (out, state (B,H,hd,hd), z (B,H,hd))."""
    B, S, H, hd = q.shape
    qf, kf, vf = feature_map(q), feature_map(k), v.to(torch.float32)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                        device=q.device)
    z = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    outs = []
    for t in range(S):
        state = state + torch.einsum("bhk,bhd->bhkd", kf[:, t], vf[:, t])
        z = z + kf[:, t]
        o = torch.einsum("bhk,bhkd->bhd", qf[:, t], state)
        den = torch.clamp_min(torch.einsum("bhk,bhk->bh", qf[:, t], z), EPS)
        outs.append(o / den[..., None])
    return torch.stack(outs, dim=1).to(q.dtype), state, z


def linear_attn_prefill(q, k, v, *, chunk: int = PREFILL_CHUNK,
                        valid_len: Optional[torch.Tensor] = None):
    """Causal linear attention over a prompt through the kernel wrapper.
    q (B,S,H,hd), k/v (B,S,KV,hd) (not expanded).  Returns (out, state
    (B,H,hd,hd), z (B,H,hd))."""
    # imported here: kernels/linear_attention/ref.py imports this module
    from repro_torch.kernels.linear_attention.ops import linear_attention
    return linear_attention(q, k, v, chunk=chunk, valid_len=valid_len)


def linear_attn_decode(q, k_new, v_new, state, z):
    """One-token decode: a single mat-vec against the running summary.
    q, k_new, v_new (B,1,H,hd) (k/v expanded to q's heads); state
    (B,H,hd,hd), z (B,H,hd) fp32."""
    qf = feature_map(q[:, 0])                              # (B,H,hd)
    kf = feature_map(k_new[:, 0])
    vf = v_new[:, 0].to(torch.float32)
    state = state + torch.einsum("bhk,bhd->bhkd", kf, vf)
    z = z + kf
    o = torch.einsum("bhk,bhkd->bhd", qf, state)
    den = torch.clamp_min(torch.einsum("bhk,bhk->bh", qf, z), EPS)
    out = (o / den[..., None]).to(q.dtype)[:, None]
    return out, state, z

"""Plain PyTorch versions of the linear-attention kernel: the port's
chunked form with GQA by kv-head indexing and ``valid_len`` (the function
the kernel computes, all arithmetic in fp32) and the sequential
recurrence over expanded k/v as its oracle.

The wrapper in ``ops.py`` runs ``ref_linear_attention_chunked`` for CPU
tensors; the tests hold both against the reference package, and the
card's checks hold the kernel against ``ref_linear_attention_chunked``.
``emulate_linear_attention_tf32x3`` repeats the kernel's own arithmetic
(64-row tiles, split TF32 products of two or three terms), for the tests
to hold it against the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.linear_attention import (EPS, _keep, feature_map)
from repro_torch.models.linear_attention import (
    linear_attention_chunked as ref_linear_attention_chunked)
from repro_torch.models.linear_attention import (
    linear_attention_sequential as ref_linear_attention)

__all__ = ["ref_linear_attention", "ref_linear_attention_chunked",
           "emulate_linear_attention_tf32x3"]

TILE = 64             # rows of the kernel's row tiles (kTile)


def _split_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                   terms: int = 3) -> torch.Tensor:
    """einsum(eq, a, b) as the kernel's split TF32 products: lo.hi + hi.lo +
    hi.hi (``terms`` 3), or lo.b + hi.b where b is exact in tf32 (``terms``
    2: a bf16 v), each summed in fp32, added in that order."""
    from repro_torch.kernels.flash_attention.ref import split_tf32
    ah, al = split_tf32(a)
    if terms == 2:
        b = b.float()
        return torch.einsum(eq, al, b) + torch.einsum(eq, ah, b)
    bh, bl = split_tf32(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def emulate_linear_attention_tf32x3(q, k, v, *, chunk: int = 256,
                                    valid_len: Optional[torch.Tensor] = None):
    """The kernel's arithmetic in plain PyTorch, model layout as
    ``ref_linear_attention_chunked`` (q (B,S,H,hd), k/v (B,S,KV,hd)):
    rows at or past ``valid_len`` zeroed; each chunk cut into row tiles of
    TILE rows; per (b, kv head) and tile its state phi(k)^T v (two terms
    when v is bf16, three in fp32) and normalizer sum phi(k), the sums
    before each tile added in tile order in fp32; per tile and query head
    phi(q) S_before and phi(q) phi(k)^T (three terms), the latter masked
    to j <= i, its row sums and phi(q).z_before (fp32) the denominator,
    and s v (two or three terms) added to phi(q) S_before.  Returns (out
    in q's dtype, state (B,H,hd,hd), z (B,H,hd))."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    L = min(chunk, S)
    keep = _keep(valid_len, B, S, q.device)
    qf, kf, vf = feature_map(q), feature_map(k), v.to(torch.float32)
    if keep is not None:
        m = keep[..., None, None]
        qf, kf, vf = qf * m, kf * m, vf * m
    v_terms = 2 if v.dtype == torch.bfloat16 else 3
    qg = qf.reshape(B, S, KV, G, hd)
    st = torch.zeros((B, KV, hd, hd), dtype=torch.float32, device=q.device)
    zt = torch.zeros((B, KV, hd), dtype=torch.float32, device=q.device)
    out = torch.zeros((B, S, KV, G, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, S, L):
        for i0 in range(c0, c0 + L, TILE):
            rows = slice(i0, min(i0 + TILE, c0 + L))
            qt, kt, vt = qg[:, rows], kf[:, rows], vf[:, rows]
            n = kt.shape[1]
            o = _split_product("bikgh,bkhd->bikgd", qt, st)
            den = torch.einsum("bikgh,bkh->bikg", qt, zt)
            s = _split_product("bikgh,bjkh->bkgij", qt, kt)
            s = s * torch.tril(torch.ones((n, n), device=q.device))
            den = den + s.sum(-1).permute(0, 3, 1, 2)
            o = o + _split_product("bkgij,bjkd->bikgd", s, vt, v_terms)
            out[:, rows] = o / torch.clamp_min(den, EPS)[..., None]
            st = st + _split_product("bjkh,bjkd->bkhd", kt, vt, v_terms)
            zt = zt + kt.sum(1)
    out = out.reshape(B, S, H, hd)
    if keep is not None:
        out = out * keep[..., None, None]
    return (out.to(q.dtype),
            st[:, :, None].expand(B, KV, G, hd, hd).reshape(B, H, hd, hd),
            zt[:, :, None].expand(B, KV, G, hd).reshape(B, H, hd))

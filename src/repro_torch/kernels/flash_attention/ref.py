"""Plain PyTorch version of the flash-attention kernel: dense GQA
attention with an fp32 softmax, the reference's ``ref_attention`` (the
same function as its off-TPU ``dense_attention``).

The wrapper in ``ops.py`` runs it for CPU tensors; the tests hold it
against the reference package, and the card's checks hold the kernel
against it.  ``split_tf32`` and ``emulate_flash_f32`` repeat the
arithmetic of the kernel's fp32 route (split TF32 products, tiles of 64
keys, an online softmax), for the tests to hold it against the
reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,hd); k, v (B,Sk,KV,hd), H = KV*G -> (B,Sq,H,hd).

    Scores q.k * hd^-1/2 in fp32 (products of the inputs, accumulated in
    fp32); causal keeps key j <= query i, both counted from 0; the
    softmax in fp32; probabilities rounded to v's dtype before P.V, which
    accumulates in fp32; the output rounds to q's dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).to(torch.float32)
    s = torch.einsum("bikgh,bjkh->bkgij", qg,
                     k.to(torch.float32)) * (hd ** -0.5)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, None, None], s,
                        torch.full((), NEG_INF, dtype=s.dtype,
                                   device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bjkh->bikgh", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


KEYS_A_TILE = 64      # the fp32 route's K/V tile (kKeysF)


def split_tf32(x: torch.Tensor):
    """(hi, lo) tf32 terms of fp32 ``x``: hi is x rounded to nearest, ties
    away from zero, at its 13 low bits (``cvt.rna.tf32.f32``, done on the
    int32 view), lo the same of x - hi; hi + lo is x within 2^-22 |x|."""
    def rna(t):
        b = t.contiguous().view(torch.int32)
        return ((b + 0x1000) & -0x2000).view(torch.float32)
    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _split_product(eq: str, a: torch.Tensor, b: torch.Tensor):
    """einsum(eq, a, b) as the kernel's three tf32 products, lo.hi, hi.lo
    and hi.hi, each summed in fp32, added in that order."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def key_groups(hd: int) -> int:
    """The fp32 route's key groups a block (``FlashF::kGroups``): two at
    hd <= 64, each taking alternate tiles, else one."""
    return 2 if hd <= 64 else 1


def emulate_flash_f32(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """The kernel's fp32 route in plain PyTorch, model layout as
    ``ref_attention``: each key group (``key_groups``) runs over its tiles
    of KEYS_A_TILE keys (tile j to group j mod groups), S = Q Kᵀ and the
    tile's P V as split TF32 products (``_split_product``), scores scaled
    by hd^-1/2 and masked to NEG_INF, its running max, sum and output
    rescaled by exp(m - m_new) in fp32, P unrounded; the groups' partial
    softmaxes are merged, and the output is acc / max(l, 1e-30).  Returns
    fp32 (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    kf, vf = k.float(), v.float()
    rows = torch.arange(Sq, device=q.device)[:, None]
    G = key_groups(hd)
    parts = []
    for grp in range(G):
        m = torch.full((B, KV, H // KV, Sq), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, H // KV, Sq, hd), device=q.device)
        for k0 in range(grp * KEYS_A_TILE, Sk, G * KEYS_A_TILE):
            kt, vt = kf[:, k0:k0 + KEYS_A_TILE], vf[:, k0:k0 + KEYS_A_TILE]
            s = _split_product("bikgh,bjkh->bkgij", qg, kt) * (hd ** -0.5)
            if causal:
                keys = torch.arange(k0, k0 + kt.shape[1], device=q.device)
                s = torch.where(rows >= keys[None], s,
                                torch.full((), NEG_INF, device=q.device))
            mn = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _split_product("bkgij,bjkh->bkgih",
                                                         p, vt)
            m = mn
        parts.append((m, l, acc))
    m, l, acc = parts[0]
    for mb, lb, accb in parts[1:]:
        mn = torch.maximum(m, mb)
        ca, cb = torch.exp(m - mn), torch.exp(mb - mn)
        l = l * ca + lb * cb
        acc = acc * ca[..., None] + accb * cb[..., None]
        m = mn
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)

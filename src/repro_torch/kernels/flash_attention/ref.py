"""Plain PyTorch version of the flash-attention kernel: dense GQA
attention with an fp32 softmax, the reference's ``ref_attention`` (the
same function as its off-TPU ``dense_attention``).

The wrapper in ``ops.py`` runs it for CPU tensors; the tests hold it
against the reference package, and the card's checks hold the kernel
against it.  ``ref_attention_lse`` adds the rows' log-sum-exp the
kernel's forward saves, and ``ref_attention_backward`` is the plain
version of the backward kernel: the gradient as its explicit formula,
from those saved rows.  ``split_tf32`` and ``emulate_flash_f32`` repeat the
arithmetic of the kernel's fp32 route (split TF32 products, tiles of 64
keys, an online softmax), for the tests to hold it against the
reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _keep(Sq: int, Sk: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: causal keeps key j <= query i, both from 0."""
    return (torch.arange(Sq, device=device)[:, None]
            >= torch.arange(Sk, device=device)[None, :])


def _acc(t: torch.Tensor) -> torch.dtype:
    """The arithmetic's dtype: fp32, or float64 for float64 inputs (the
    yardstick the card's checks hold both versions against)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q, k, causal: bool) -> torch.Tensor:
    """(B,KV,G,Sq,Sk) fp32 scores q.k * hd^-1/2, masked to NEG_INF."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qg = q.reshape(B, Sq, KV, H // KV, hd).to(_acc(q))
    s = torch.einsum("bikgh,bjkh->bkgij", qg,
                     k.to(_acc(q))) * (hd ** -0.5)
    if causal:
        s = torch.where(_keep(Sq, Sk, q.device)[None, None, None], s,
                        torch.full((), NEG_INF, dtype=s.dtype,
                                   device=s.device))
    return s


def ref_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,hd); k, v (B,Sk,KV,hd), H = KV*G -> (B,Sq,H,hd).

    Scores q.k * hd^-1/2 in fp32 (products of the inputs, accumulated in
    fp32); causal keeps key j <= query i, both counted from 0; the
    softmax in fp32; probabilities rounded to v's dtype before P.V, which
    accumulates in fp32; the output rounds to q's dtype."""
    B, Sq, H, hd = q.shape
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bjkh->bikgh", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def ref_attention_lse(q, k, v, *, causal: bool = True):
    """(``ref_attention``, lse (B,H,Sq) fp32): each row's log-sum-exp of
    its scaled, masked scores, as the kernel's forward saves it."""
    B, Sq, H, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal), dim=-1)
    return ref_attention(q, k, v, causal=causal), lse.reshape(B, H, Sq)


def ref_attention_backward(q, k, v, o, lse, do, *, causal: bool = True):
    """The plain backward kernel: (dq, dk, dv) in the inputs' dtypes from
    q (B,Sq,H,hd), k, v (B,Sk,KV,hd), the forward's o and lse (B,H,Sq),
    and do (B,Sq,H,hd), all in fp32 arithmetic.  P = exp(s - lse) from
    ``ref_attention``'s scores (masked entries -1e30, so P is 0 there);
    dV = Pᵀ dO with P rounded to v's dtype (the forward's rounding before
    P.V); dP = dO Vᵀ; D = rowsum(dO * O); dS = P (dP - D); dQ = dS K
    hd^-1/2 and dK = dSᵀ Q hd^-1/2; dK and dV summed over each kv head's
    G query heads.  float64 inputs run in float64 throughout."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    f32 = _acc(q)
    s = _scores(q, k, causal)                                # (B,KV,G,i,j)
    p = torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None])
    dog = do.reshape(B, Sq, KV, G, hd).to(f32)
    og = o.reshape(B, Sq, KV, G, hd).to(f32)
    dv = torch.einsum("bkgij,bikgh->bjkh", p.to(v.dtype).to(f32), dog)
    dp = torch.einsum("bikgh,bjkh->bkgij", dog, v.to(f32))
    dsum = (dog * og).sum(-1).permute(0, 2, 3, 1)            # (B,KV,G,i)
    ds = p * (dp - dsum[..., None])
    scale = hd ** -0.5
    dq = torch.einsum("bkgij,bjkh->bikgh", ds, k.to(f32)) * scale
    dk = torch.einsum("bkgij,bikgh->bjkh", ds,
                      q.reshape(B, Sq, KV, G, hd).to(f32)) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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

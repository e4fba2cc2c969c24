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
keys, an online softmax), and ``emulate_flash_bwd`` that of the backward
kernel (bf16 products with dS in two bf16 terms, or split TF32), for the
tests to hold them against the reference.
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


def split3_tf32(x: torch.Tensor):
    """(x1, x2, x3) tf32 terms of fp32 ``x``, each rounded to nearest,
    ties away, from what the earlier ones leave: x1 + x2 + x3 is x
    exactly (``split3_tf32`` in the kernel)."""
    def rna(t):
        b = t.contiguous().view(torch.int32)
        return ((b + 0x1000) & -0x2000).view(torch.float32)
    x = x.float()
    x1 = rna(x)
    r = x - x1
    x2 = rna(r)
    return x1, x2, rna(r - x2)


def _split3_product(eq: str, a: torch.Tensor, b: torch.Tensor):
    """einsum(eq, a, b) as the kernel's six tf32 products of three-term
    splits, x3.y1 + x2.y2 + x1.y3 + x2.y1 + x1.y2 + x1.y1, each summed in
    fp32, added in that order."""
    (a1, a2, a3), (b1, b2, b3) = split3_tf32(a), split3_tf32(b)
    out = torch.einsum(eq, a3, b1)
    for x, y in ((a2, b2), (a1, b3), (a2, b1), (a1, b2), (a1, b1)):
        out = out + torch.einsum(eq, x, y)
    return out


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


ROWS_A_TILE = 64      # the backward's query tiles (kBT)
LOG2E = 1.4426950408889634


def emulate_flash_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """The backward kernel's arithmetic in plain PyTorch, with the
    arguments and results of ``ref_attention_backward``.  Per query head,
    query tiles of ROWS_A_TILE rows in order: S and dP as products of the
    inputs (bf16: exact products summed in fp32; fp32: six tf32 products
    of three-term splits, ``_split3_product``); P, 0 where masked, is
    exp2(S hd^-1/2 log2(e) - lse log2(e)) in bf16 and exp(S hd^-1/2 -
    lse) with the exponent rounded once (an fma) in fp32; dS = P (dP - D), D =
    rowsum(dO * O) of the output as stored, summed in float64 and rounded
    once.  bf16: dV += bf16(P)ᵀ dO, and dS in two terms, hi = bf16(dS)
    and lo = bf16(dS - hi), a product each for dK and dQ; fp32: P and dS
    unrounded, three split-TF32 products (``_split_product``).  dK and dV
    accumulate over the tiles per query head (dK times hd^-1/2 at the
    end), then each kv head's G partials are added in order g = 0, 1,
    ...; dQ = dS K hd^-1/2."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    bf = q.dtype == torch.bfloat16

    def sdp(eq, a, b):                  # S and dP
        return torch.einsum(eq, a, b) if bf else _split3_product(eq, a, b)

    def prod(eq, a, b):                 # dV, dK, dQ
        return torch.einsum(eq, a, b) if bf else _split_product(eq, a, b)
    qf, dof = q.float(), do.float()
    kh = k.float().repeat_interleave(G, dim=2)               # (B,Sk,H,hd)
    vh = v.float().repeat_interleave(G, dim=2)
    dsum = (dof.double() * o.double()).sum(-1).float().transpose(1, 2)
    lse2 = lse.float() * LOG2E
    scale = hd ** -0.5
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    scale32 = float(torch.tensor(scale, dtype=torch.float32))
    keys = torch.arange(Sk, device=q.device)
    dq = torch.zeros((B, Sq, H, hd), device=q.device)
    dk = torch.zeros((B, Sk, H, hd), device=q.device)
    dv = torch.zeros((B, Sk, H, hd), device=q.device)
    for r0 in range(0, Sq, ROWS_A_TILE):
        r1 = min(r0 + ROWS_A_TILE, Sq)
        qt, ot = qf[:, r0:r1], dof[:, r0:r1]
        s = sdp("bihd,bjhd->bhij", qt, kh)
        if bf:
            p = torch.exp2(s * scale_log2 - lse2[:, :, r0:r1, None])
        else:
            p = torch.exp((s.double() * scale32 - lse.double()[:, :, r0:r1,
                                                              None]).float())
        if causal:
            rows = torch.arange(r0, r1, device=q.device)
            p = torch.where(rows[:, None] >= keys[None], p,
                            torch.zeros((), device=q.device))
        dp = sdp("bihd,bjhd->bhij", ot, vh)
        ds = p * (dp - dsum[:, :, r0:r1, None])
        if bf:
            hi = ds.to(torch.bfloat16).float()
            terms = (hi, (ds - hi).to(torch.bfloat16).float())
            p = p.to(torch.bfloat16).float()
        else:
            terms = (ds,)
        dv += prod("bhij,bihd->bjhd", p, ot)
        for t in terms:
            dk += prod("bhij,bihd->bjhd", t, qt)
            dq[:, r0:r1] += prod("bhij,bjhd->bihd", t, kh)
    dk = (dk * scale).reshape(B, Sk, KV, G, hd)
    dv = dv.reshape(B, Sk, KV, G, hd)
    dk_sum, dv_sum = dk[:, :, :, 0], dv[:, :, :, 0]
    for g in range(1, G):
        dk_sum = dk_sum + dk[:, :, :, g]
        dv_sum = dv_sum + dv[:, :, :, g]
    return ((dq * scale).to(q.dtype), dk_sum.to(k.dtype),
            dv_sum.to(v.dtype))

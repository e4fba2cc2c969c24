"""Plain PyTorch version of the flash-attention kernel: dense GQA
attention with an fp32 softmax, the reference's ``ref_attention`` (the
same function as its off-TPU ``dense_attention``).

The wrapper in ``ops.py`` runs it for CPU tensors; the tests hold it
against the reference package, and the card's checks hold the kernel
against it.
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

"""GQA attention: prefill through the flash kernel (``attn_q_chunk ==
0``) or chunked online softmax, and cached decode.

GQA layout: q (B,S,H,hd), k/v (B,S,KV,hd) with H = KV*G.  Scores,
softmax statistics and the context accumulate in fp32; masked scores are
-1e30 (not -inf), so a length-0 row stays finite.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.cache_update import ops as cu
from repro_torch.kernels.cache_update.ref import index_vector
from repro_torch.kernels.dequant_gemm import ops as dg
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import dense_init

NEG_INF = -1e30


def init_attn(generator, cfg, d_model: int, device, qkv_bias: bool = False,
              lead=()):
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    lead = tuple(lead)
    p = {
        "wq": dense_init(generator, lead + (d_model, H, hd), dt, device,
                         fan_in=d_model),
        "wk": dense_init(generator, lead + (d_model, KV, hd), dt, device,
                         fan_in=d_model),
        "wv": dense_init(generator, lead + (d_model, KV, hd), dt, device,
                         fan_in=d_model),
        "wo": dense_init(generator, lead + (H, hd, d_model), dt, device,
                         fan_in=H * hd),
    }
    if qkv_bias:
        p["bq"] = torch.zeros(lead + (H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros(lead + (KV, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros(lead + (KV, hd), dtype=dt, device=device)
    return p


def qkv_proj(p, x):
    """Packed weights go through the packed-weight GEMM (prefill); the
    bias adds after its rounding, as on dense weights."""
    q = dg.quant_einsum("bsd,dhk->bshk", x, p["wq"])
    k = dg.quant_einsum("bsd,dhk->bshk", x, p["wk"])
    v = dg.quant_einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def out_proj(p, o):
    return dg.quant_einsum("bshk,hkd->bsd", o, p["wo"])


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-efficient attention.  q (B,Sq,H,hd), k/v (B,Sk,KV,hd)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not divide "
                         f"({Sq}, {Sk})")
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    dev = q.device
    qc = q.reshape(B, nq, q_chunk, KV, G, hd)
    kc = k.reshape(B, nk, kv_chunk, KV, hd)
    vc = v.reshape(B, nk, kv_chunk, KV, hd)
    outs = []
    for qi in range(nq):
        q_i = qc[:, qi].to(torch.float32)
        q_pos = torch.arange(qi * q_chunk, (qi + 1) * q_chunk, device=dev)
        m = torch.full((B, q_chunk, KV, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, q_chunk, KV, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, q_chunk, KV, G, hd), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            k_j = kc[:, j].to(torch.float32)
            v_j = vc[:, j]
            s = torch.einsum("bqkgh,bckh->bqkgc", q_i, k_j) * scale
            if causal:
                k_pos = torch.arange(j * kv_chunk, (j + 1) * kv_chunk,
                                     device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask[None, :, None, None, :], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckh->bqkgh", p.to(v_j.dtype).to(torch.float32),
                v_j.to(torch.float32))
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=1).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def attn_train(p, cfg, x, rope_fn, *, causal=True, kv_override=None):
    """Full-sequence attention; returns (out, (k, v)) for the cache.
    ``kv_override`` (k, v): cross-attention (the encoder-decoder) takes
    them as given, and only q is projected from x and roped."""
    if kv_override is not None:
        q = dg.quant_einsum("bsd,dhk->bshk", x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        k, v = kv_override
        q = rope_fn(q)
    else:
        q, k, v = qkv_proj(p, x)
        q, k = rope_fn(q), rope_fn(k)
    if cfg.attn_q_chunk == 0:
        # one attention region: the flash kernel on the card, its plain
        # (dense) version on the CPU
        o = flash_attention(q, k, v, causal=causal)
    else:
        o = chunked_attention(q, k, v, causal=causal,
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)
    return out_proj(p, o), (k, v)


def attn_context(q, k_new, v_new, cache_k, cache_v, index, cfg
                 ) -> torch.Tensor:
    """Decode attention core: online softmax over the cache (positions <
    ``index`` of each row) plus the not-yet-written new token.  Shared by
    :func:`attn_decode` and the fused decode step."""
    B, S, KV, hd = cache_k.shape
    H = cfg.n_heads
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, 1, KV, G, hd)[:, 0].to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg,
                     cache_k.to(torch.float32)) * scale
    idx = index_vector(index, B, q.device)
    valid = (torch.arange(S, device=q.device)[None, :]
             < idx[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    s_new = torch.einsum("bkgh,bkh->bkg", qg,
                         k_new[:, 0].to(torch.float32)) * scale
    m = torch.maximum(s.amax(dim=-1), s_new)
    p_cache = torch.exp(s - m[..., None])
    p_new = torch.exp(s_new - m)
    denom = p_cache.sum(dim=-1) + p_new
    o = torch.einsum("bkgs,bskh->bkgh",
                     p_cache.to(cache_v.dtype).to(torch.float32),
                     cache_v.to(torch.float32))
    o = o + p_new[..., None] * v_new[:, 0, :, None, :].to(torch.float32)
    return (o / denom[..., None]).to(q.dtype).reshape(B, 1, H, hd)


def attn_decode(p, cfg, x, cache_k, cache_v, index, rope_fn
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: x (B,1,D); cache_k/v (B,S,KV,hd).  Returns (out,
    k_new, v_new) with k/v_new the (B,1,KV,hd) rows for the cache."""
    q, k_new, v_new = qkv_proj(p, x)
    q, k_new = rope_fn(q), rope_fn(k_new)
    o = attn_context(q, k_new, v_new, cache_k, cache_v, index, cfg)
    return out_proj(p, o), k_new, v_new


def update_cache(cache_k, cache_v, k_new, v_new, index, *,
                 donate: bool = False):
    """Each row's K/V written at ``index`` (out-of-range positions are
    dropped).  With ``donate`` the caller hands both caches over: each is
    written in place by the cache-row-update kernel (one launch per cache,
    the reference's donation discipline) and returned.  Without it, new
    caches are returned and the inputs are not modified."""
    if donate:
        return (cu.cache_row_update(cache_k, k_new[:, 0], index),
                cu.cache_row_update(cache_v, v_new[:, 0], index))
    B, S = cache_k.shape[:2]
    idx = index_vector(index, B, cache_k.device).to(torch.long)
    ok = idx < S
    b = torch.arange(B, device=cache_k.device)[ok]
    cache_k, cache_v = cache_k.clone(), cache_v.clone()
    cache_k[b, idx[ok]] = k_new[ok, 0].to(cache_k.dtype)
    cache_v[b, idx[ok]] = v_new[ok, 0].to(cache_v.dtype)
    return cache_k, cache_v

"""Encoder-decoder model (the seamless-m4t family).

The audio frontend is a stub: a request carries precomputed frame
embeddings (B, T, d_model).  The encoder is a bidirectional attention
stack with RoPE over the frames; the decoder runs causal self-attention,
cross-attention on the encoder's output (its K/V projected once a layer,
in prefill) and an ungated FFN; the head is the tied embedding, its
product in the compute dtype and then widened to fp32.

Every layer leaf is stacked over the layers (``enc_layers``,
``dec_layers``), as in the reference.  Prefill (:func:`encode`,
:func:`decode_stack`) dequantizes each layer's small packed leaves at use
and hands the projections packed to the packed-weight GEMM
(``models/decoder.py::stack_forward``'s discipline).  The decode step
(:func:`encdec_decode_step`) runs the self q/k/v and the FFN through the
split-K GEMVs on the packed weights (``kernels/fused_decode``) and writes
each layer's new K/V row into the donated self-cache in place (the
cache-row-update kernel); the cross q and both output projections are
dequantized at use.  Every row of a call shares one frame count T and
one scalar ``index``: there is no frame or length mask, as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import QTensor, dequantize, quantize_tree
from repro_torch.kernels.dequant_gemm import ops as dg
from repro_torch.kernels.fused_decode import ops as fd
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (apply_norm, apply_rope,
                                       default_positions, embed_init,
                                       init_norm)
from repro_torch.models.decoder import dequantize_small, layer_slice
from repro_torch.models.model import _vocab_bias, decode_positions


def _dq(w):
    return dequantize(w) if isinstance(w, QTensor) else w


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_enc_layers(generator, cfg, device):
    lead, D = (cfg.n_enc_layers,), cfg.d_model
    return {"norm1": init_norm(cfg, D, device, lead=lead),
            "attn": attn.init_attn(generator, cfg, D, device, lead=lead),
            "norm2": init_norm(cfg, D, device, lead=lead),
            "ffn": mlp_mod.init_mlp(generator, cfg, D, cfg.d_ff, device,
                                    lead=lead)}


def _init_dec_layers(generator, cfg, device):
    lead, D = (cfg.n_layers,), cfg.d_model
    return {"norm1": init_norm(cfg, D, device, lead=lead),
            "self_attn": attn.init_attn(generator, cfg, D, device,
                                        lead=lead),
            "norm_x": init_norm(cfg, D, device, lead=lead),
            "cross_attn": attn.init_attn(generator, cfg, D, device,
                                         lead=lead),
            "norm2": init_norm(cfg, D, device, lead=lead),
            "ffn": mlp_mod.init_mlp(generator, cfg, D, cfg.d_ff, device,
                                    lead=lead)}


def init_encdec(cfg, generator: torch.Generator, device, policy=None):
    """The reference's tree (``enc_layers``, ``enc_final_norm``,
    ``embed``, ``dec_layers``, ``final_norm``), shapes and scales, with
    torch's own random numbers.  With a ``policy`` each layer stack is
    packed as soon as it is made, bit-equal to ``quantize_tree(
    init_encdec(...), policy)``."""
    def made(tree, path):
        return tree if policy is None else quantize_tree(tree, policy,
                                                         path=path)
    params = {"enc_layers": made(_init_enc_layers(generator, cfg, device),
                                 "enc_layers"),
              "enc_final_norm": init_norm(cfg, cfg.d_model, device)}
    params["embed"] = embed_init(generator, (cfg.padded_vocab, cfg.d_model),
                                 cfg.torch_dtype, device)
    params["dec_layers"] = made(_init_dec_layers(generator, cfg, device),
                                "dec_layers")
    params["final_norm"] = init_norm(cfg, cfg.d_model, device)
    return params


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _rope(cfg, positions):
    return lambda t: apply_rope(t, positions, cfg.rope_theta)


def encode(params, cfg, src_embeds):
    """src_embeds (B, T, D) from the audio-frontend stub -> (B, T, D):
    bidirectional layers (flash non-causal when ``attn_q_chunk == 0``),
    then the final norm."""
    B, T, _ = src_embeds.shape
    rope_fn = _rope(cfg, default_positions(B, T, src_embeds.device))
    x = src_embeds.to(cfg.torch_dtype)
    for i in range(cfg.n_enc_layers):
        lp = dequantize_small(layer_slice(params["enc_layers"], i))
        h = apply_norm(lp["norm1"], x)
        y, _ = attn.attn_train(lp["attn"], cfg, h, rope_fn, causal=False)
        x = x + y
        h = apply_norm(lp["norm2"], x)
        x = x + mlp_mod.apply_mlp(lp["ffn"], cfg.act, h)
        del lp
    return apply_norm(dequantize_small(params["enc_final_norm"]), x)


# ---------------------------------------------------------------------------
# decoder (teacher-forced / prefill)
# ---------------------------------------------------------------------------

def cross_kv(lp, enc_out):
    """One layer's cross-attention K and V (B, T, KV, hd), projected from
    the encoder's output (the packed-weight GEMM on packed weights)."""
    ca = lp["cross_attn"]
    return (dg.quant_einsum("bsd,dhk->bshk", enc_out, ca["wk"]),
            dg.quant_einsum("bsd,dhk->bshk", enc_out, ca["wv"]))


def _dec_layer_full(cfg, lp, x, enc_out, rope_fn, want_cache, decode_len):
    """One decoder layer over the whole target; ``lp`` has its small
    leaves dequantized.  Returns (x, (k, v, ck, cv) or None), k and v
    padded to ``decode_len`` positions."""
    h = apply_norm(lp["norm1"], x)
    y, (k, v) = attn.attn_train(lp["self_attn"], cfg, h, rope_fn,
                                causal=True)
    x = x + y
    h = apply_norm(lp["norm_x"], x)
    ck, cv = cross_kv(lp, enc_out)
    y, _ = attn.attn_train(lp["cross_attn"], cfg, h, lambda t: t,
                           causal=False, kv_override=(ck, cv))
    x = x + y
    h = apply_norm(lp["norm2"], x)
    x = x + mlp_mod.apply_mlp(lp["ffn"], cfg.act, h)
    if not want_cache:
        return x, None
    pad = decode_len - k.shape[1]
    return x, (F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad)),
               ck, cv)


def decode_layers(dec_layers, cfg, x, enc_out, *, want_cache=False,
                  decode_len=0):
    """The decoder's layers over hidden states x (B, S, D) at positions
    0..S-1 against ``enc_out`` (B, T, D).  Returns (x, caches): with
    ``want_cache`` the stacked (k, v, ck, cv), k/v (L, B, decode_len, KV,
    hd), ck/cv (L, B, T, KV, hd); else None."""
    B, S, _ = x.shape
    rope_fn = _rope(cfg, default_positions(B, S, x.device))
    caches = []
    for i in range(cfg.n_layers):
        lp = dequantize_small(layer_slice(dec_layers, i))
        x, c = _dec_layer_full(cfg, lp, x, enc_out, rope_fn, want_cache,
                               decode_len)
        caches.append(c)
        del lp
    if not want_cache:
        return x, None
    return x, tuple(torch.stack(t) for t in zip(*caches))


def decode_stack(params, cfg, tgt_tokens, enc_out, *, want_cache=False,
                 decode_len=0):
    """Teacher-forced decoder: tgt_tokens (B, S) -> (hidden (B, S, D),
    caches as :func:`decode_layers` gives them)."""
    x = params["embed"][tgt_tokens]
    return decode_layers(params["dec_layers"], cfg, x, enc_out,
                         want_cache=want_cache, decode_len=decode_len)


def _logits(params, cfg, x):
    """Final norm, then the tied embedding as the head: the product in
    the compute dtype, widened to fp32, plus the padded rows' -1e30."""
    x = apply_norm(dequantize_small(params["final_norm"]), x)
    logits = torch.einsum("bsd,vd->bsv", x, _dq(params["embed"]))
    return (logits.to(torch.float32)
            + _vocab_bias(cfg, x.device)[None, None, :])


def encdec_prefill(params, cfg, src_embeds, tgt_tokens, max_len: int):
    """Encode the frames, run the target prefix; self-caches padded to
    ``max_len``.  Returns (last-token logits (B, V), cache {"layers": (k,
    v, ck, cv), "index": S})."""
    enc_out = encode(params, cfg, src_embeds)
    x, caches = decode_stack(params, cfg, tgt_tokens, enc_out,
                             want_cache=True, decode_len=max_len)
    logits = _logits(params, cfg, x[:, -1:])
    return logits[:, 0], {"layers": caches,
                          "index": torch.tensor(tgt_tokens.shape[1],
                                                dtype=torch.int32,
                                                device=tgt_tokens.device)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _cross_decode(p, cfg, x, ck, cv):
    """Dense cross-attention for one query token: x (B, 1, D) against
    ck/cv (B, T, KV, hd); ``p`` has dense ``wq`` and ``wo``.  Scores and
    the softmax in fp32, the probabilities rounded to cv's dtype before
    P.V."""
    B, T, KV, hd = ck.shape
    H = cfg.n_heads
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg,
                     ck.to(torch.float32)) * (hd ** -0.5)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", prob.to(cv.dtype), cv)
    return attn.out_proj(p, o.reshape(B, 1, H, hd))


def encdec_decode_step(params, cfg, tokens, cache):
    """tokens (B, 1) -> (logits (B, V), cache), every row at the cache's
    one scalar ``index``.  The self-caches are donated: each layer's new
    K/V row is written into its slice in place (the cache-row-update
    kernel) and the same tensors come back with ``index + 1``.  Fixed
    shape, no host sync."""
    B = tokens.shape[0]
    index = torch.as_tensor(cache["index"], device=tokens.device)
    rope_fn = _rope(cfg, decode_positions(index, B, tokens.device))
    k_cache, v_cache, ck, cv = cache["layers"]
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        lp = dequantize_small(layer_slice(params["dec_layers"], i))
        sa, ca, ffn = lp["self_attn"], lp["cross_attn"], lp["ffn"]
        h = apply_norm(lp["norm1"], x)
        q, k_new, v_new = fd.fused_qkv(h, sa["wq"], sa["wk"], sa["wv"])
        q, k_new = rope_fn(q), rope_fn(k_new)
        o = attn.attn_context(q, k_new, v_new, k_cache[i], v_cache[i],
                              index, cfg)
        attn.update_cache(k_cache[i], v_cache[i], k_new, v_new, index,
                          donate=True)
        x = x + attn.out_proj({"wo": _dq(sa["wo"])}, o)
        h = apply_norm(lp["norm_x"], x)
        x = x + _cross_decode({"wq": _dq(ca["wq"]), "wo": _dq(ca["wo"])},
                              cfg, h, ck[i], cv[i])
        h = apply_norm(lp["norm2"], x)
        x = x + fd.fused_mlp(h, ffn["w_up"], ffn["w_down"], ffn.get("w_gate"),
                             act=cfg.act)
        del lp
    logits = _logits(params, cfg, x)
    return logits[:, 0], {"layers": (k_cache, v_cache, ck, cv),
                          "index": index + 1}


def init_encdec_decode_state(cfg, batch: int, max_len: int, device="cuda"):
    """Zero caches: self k/v (L, batch, max_len, KV, hd), cross k/v (L,
    batch, enc_seq_len, KV, hd); index ``max_len - 1``."""
    KV, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    dt, device = cfg.torch_dtype, torch.device(device)
    self_shape = (L, batch, max_len, KV, hd)
    cross_shape = (L, batch, cfg.enc_seq_len, KV, hd)
    caches = tuple(torch.zeros(s, dtype=dt, device=device)
                   for s in (self_shape, self_shape, cross_shape,
                             cross_shape))
    return {"layers": caches,
            "index": torch.tensor(max_len - 1, dtype=torch.int32,
                                  device=device)}

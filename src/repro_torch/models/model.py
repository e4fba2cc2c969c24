"""Top-level language-model API: init / prefill / decode (decoder-only
dense, VLM and SSM families; softmax or linear attention).  The cache's
``layers`` are the decoder's: ``((k, v),)`` for softmax attention,
``((state, z),)`` for linear attention, ``((conv_tail, ssd_state),)``
for Mamba-2."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.models import decoder as dec
from repro_torch.models.common import (apply_mrope, apply_norm,
                                       apply_rope, default_mrope_positions,
                                       default_positions, dense_init,
                                       embed_init, init_norm)


def init_lm(cfg: ModelConfig, generator: torch.Generator, device):
    """Parameters with the reference's tree, shapes and scales (torch's
    own random numbers)."""
    dt = cfg.torch_dtype
    qkv_bias = cfg.family == "vlm"          # Qwen2 uses qkv biases
    params: Dict[str, Any] = {
        "embed": embed_init(generator, (cfg.padded_vocab, cfg.d_model), dt,
                            device),
        "layers": dec.init_stack(generator, cfg, device, qkv_bias),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), dt, device,
            fan_in=cfg.d_model)
    if cfg.vlm:
        params["vis_proj"] = {
            "w1": dense_init(generator, (cfg.vision_feat_dim, cfg.d_model),
                             dt, device),
            "w2": dense_init(generator, (cfg.d_model, cfg.d_model), dt,
                             device),
        }
    return params


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0):
    """The port's counterpart of the reference's ``init_params``: random
    weights made on ``device`` (the card by default) from ``generator``
    (or a fresh one seeded with ``seed``)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    with torch.no_grad():
        return init_lm(cfg, generator, device)


def make_rope_fn(cfg, positions, mrope_positions=None):
    """The rotary map of q/k: ``positions`` (B, S) for RoPE,
    ``mrope_positions`` (3, B, S) for M-RoPE."""
    if cfg.rope == "none":
        return lambda t: t
    if cfg.rope == "mrope":
        return lambda t: apply_mrope(t, mrope_positions, cfg.rope_theta)
    return lambda t: apply_rope(t, positions, cfg.rope_theta, cfg.rope_frac)


def prompt_rope_fn(cfg, batch: int, seq: int, device):
    """The rotary map of a prompt at positions 0..seq-1 (M-RoPE: three
    equal text streams)."""
    mrope = (default_mrope_positions(batch, seq, device)
             if cfg.rope == "mrope" else None)
    return make_rope_fn(cfg, default_positions(batch, seq, device), mrope)


def _vocab_bias(cfg, device) -> torch.Tensor:
    """-1e30 on padded vocab rows so they never receive probability."""
    v = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(v < cfg.vocab_size, 0.0, -1e30).to(torch.float32)


def project_vision(vis_proj, cfg, feats):
    """The projector: tanh-GELU(feats @ w1) @ w2."""
    v = F.gelu(torch.einsum("bnf,fd->bnd", feats.to(cfg.torch_dtype),
                            vis_proj["w1"]), approximate="tanh")
    return torch.einsum("bnd,de->bne", v, vis_proj["w2"])


def _embed(params, cfg, tokens, vision_feats=None):
    x = params["embed"][tokens]
    if cfg.vlm and vision_feats is not None:
        v = project_vision(params["vis_proj"], cfg, vision_feats)
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    return x


def _head(params, cfg, x):
    """Final norm + LM head, accumulated AND returned in fp32 (bf16 logits
    would make exact top-1 ties)."""
    x = apply_norm(params["final_norm"], x)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if isinstance(w, QTensor):
        w = dequantize(w)
    w = w.to(torch.float32)
    w = w.t() if cfg.tie_embeddings else w
    logits = torch.matmul(x.to(torch.float32), w)
    return logits + _vocab_bias(cfg, x.device)[None, None, :]


def lm_prefill(params, cfg: ModelConfig, tokens, max_len: int, *,
               vision_feats=None, mrope_positions=None):
    """Run the prompt; caches padded to ``max_len``.  Returns
    (last-token logits (B, V), cache).  M-RoPE configs default to three
    equal text position streams."""
    B, S = tokens.shape
    rope_fn = (prompt_rope_fn(cfg, B, S, tokens.device)
               if mrope_positions is None else
               make_rope_fn(cfg, default_positions(B, S, tokens.device),
                            mrope_positions))
    x = _embed(params, cfg, tokens, vision_feats)
    x, caches, _ = dec.stack_forward(params["layers"], cfg, x, rope_fn,
                                     causal=True, want_cache=True,
                                     decode_len=max_len)
    logits = _head(params, cfg, x[:, -1:])
    return logits[:, 0], {"layers": caches,
                          "index": torch.tensor(S, dtype=torch.int32,
                                                device=tokens.device)}


def decode_positions(index, batch: int, device) -> torch.Tensor:
    index = torch.as_tensor(index, device=device)
    if index.dim() == 0:
        return index.reshape(1, 1).expand(batch, 1).to(torch.int32)
    return index[:, None].to(torch.int32)


def decode_rope_fn(cfg, positions):
    """The rotary map of one decode step: M-RoPE repeats the (B, 1)
    positions on all three streams."""
    mrope = (torch.stack([positions] * 3) if cfg.rope == "mrope" else None)
    return make_rope_fn(cfg, positions, mrope)


def lm_decode_step(params, cfg: ModelConfig, tokens, cache, *,
                   donate: bool = False):
    """One decode step: tokens (B,1) -> (logits (B,V), new cache).
    ``cache["index"]`` is a scalar or a (B,) vector of per-row lengths.
    ``donate`` hands the softmax caches over to be written in place
    (``decoder.stack_decode``); the default leaves them unmodified."""
    B = tokens.shape[0]
    index = torch.as_tensor(cache["index"], device=tokens.device)
    rope_fn = decode_rope_fn(cfg, decode_positions(index, B, tokens.device))
    x = _embed(params, cfg, tokens)
    x, new_caches = dec.stack_decode(params["layers"], cfg, x,
                                     cache["layers"], index, rope_fn,
                                     donate=donate)
    logits = _head(params, cfg, x)
    return logits[:, 0], {"layers": new_caches, "index": index + 1}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      start_index: Optional[int] = None, device="cuda"):
    """Cache for a decode-only entry: zero caches of ``max_len`` positions
    (softmax attention) or zero state (linear attention, Mamba-2), index
    ``max_len - 1`` unless ``start_index`` is given."""
    idx = max_len - 1 if start_index is None else start_index
    return {"layers": dec.init_cache(cfg, batch, max_len, device),
            "index": torch.tensor(idx, dtype=torch.int32,
                                  device=torch.device(device))}


def count_params_analytic(cfg: ModelConfig) -> int:
    """Analytic parameter count of the stacks the port covers (softmax or
    linear attention, which share their weights, or Mamba-2 mixers; dense
    FFN or none), the reference's formula."""
    dec.check_supported(cfg)
    D, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    mixer, ffn = dec.sublayer_spec(cfg, 0)
    if mixer == "attn":
        per_layer = D * hd * (H + 2 * KV) + H * hd * D
    else:
        s = cfg.ssm
        d_inner = s.expand * D
        ch = d_inner + 2 * s.n_groups * s.d_state
        Hm = d_inner // s.head_dim
        per_layer = (D * (2 * d_inner + 2 * s.n_groups * s.d_state + Hm)
                     + s.d_conv * ch + ch + 3 * Hm + d_inner + d_inner * D)
    if ffn == "mlp":
        n_mats = 3 if cfg.act in ("swiglu", "geglu") else 2
        per_layer += n_mats * D * cfg.d_ff
    per_layer += 2 * D                      # norms
    total = per_layer * cfg.n_layers
    total += cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
    if cfg.vlm:
        total += cfg.vision_feat_dim * D + D * D
    return int(total)

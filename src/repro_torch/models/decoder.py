"""Decoder stack, dense path with group size 1.

Layer params are stacked on a leading ``L`` axis, as in the reference:
``params["layers"]`` is a 1-tuple (one sublayer per group) holding
``{"norm1", "mixer", "norm2", "ffn"}``, every leaf ``(L, ...)``.  The
reference's ``lax.scan`` over layers is a Python loop here; each layer
dequantizes its packed weights at use (``dequantize_tree`` of the slice).
MoE, Mamba-2, linear attention and hybrid groups are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import QTensor, dequantize_tree
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.tree import tree_map


def group_size(cfg) -> int:
    return cfg.hybrid_group or 1


def check_supported(cfg):
    """The port's decoder covers dense softmax-attention stacks only."""
    if (group_size(cfg) != 1 or cfg.family == "ssm" or cfg.moe is not None
            or cfg.attn_impl != "softmax" or cfg.encdec):
        raise NotImplementedError(
            f"{cfg.name}: only dense softmax-attention decoders with group "
            f"size 1 are ported")


def init_stack(generator, cfg, device, qkv_bias: bool = False):
    """Stacked layer params, leading dim ``n_layers``."""
    check_supported(cfg)
    L, D = cfg.n_layers, cfg.d_model
    sub = {"norm1": init_norm(cfg, D, device, lead=(L,)),
           "mixer": attn.init_attn(generator, cfg, D, device, qkv_bias,
                                   lead=(L,)),
           "norm2": init_norm(cfg, D, device, lead=(L,)),
           "ffn": mlp_mod.init_mlp(generator, cfg, D, cfg.d_ff, device,
                                   lead=(L,))}
    return (sub,)


def layer_slice(params_layers, i: int):
    """Layer ``i`` of the stacked params (QTensors sliced too)."""
    return tree_map(lambda l: l.layer(i) if isinstance(l, QTensor) else l[i],
                    params_layers)


def stack_forward(params_layers, cfg, x, rope_fn, *, causal=True,
                  want_cache=False, decode_len=0):
    """Run the whole stack.  Returns (x, caches, aux) with caches
    ``((k, v),)`` stacked ``(L, B, decode_len, KV, hd)`` when
    ``want_cache``."""
    check_supported(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        sub = dequantize_tree(layer_slice(params_layers, i))[0]
        h = apply_norm(sub["norm1"], x)
        y, (k, v) = attn.attn_train(sub["mixer"], cfg, h, rope_fn,
                                    causal=causal)
        x = x + y
        if want_cache:
            pad = decode_len - k.shape[1]
            ks.append(F.pad(k, (0, 0, 0, 0, 0, pad)))
            vs.append(F.pad(v, (0, 0, 0, 0, 0, pad)))
        h2 = apply_norm(sub["norm2"], x)
        x = x + mlp_mod.apply_mlp(sub["ffn"], cfg.act, h2)
    caches = ((torch.stack(ks), torch.stack(vs)),) if want_cache else None
    return x, caches, 0.0


def stack_decode(params_layers, cfg, x, caches, index, rope_fn
                 ) -> Tuple[torch.Tensor, tuple]:
    """One decode step through every layer; returns (x, new caches)."""
    check_supported(cfg)
    cache_k, cache_v = caches[0]
    new_k, new_v = [], []
    for i in range(cfg.n_layers):
        sub = dequantize_tree(layer_slice(params_layers, i))[0]
        h = apply_norm(sub["norm1"], x)
        y, k_new, v_new = attn.attn_decode(sub["mixer"], cfg, h, cache_k[i],
                                           cache_v[i], index, rope_fn)
        ck, cv = attn.update_cache(cache_k[i], cache_v[i], k_new, v_new,
                                   index)
        new_k.append(ck)
        new_v.append(cv)
        x = x + y
        h2 = apply_norm(sub["norm2"], x)
        x = x + mlp_mod.apply_mlp(sub["ffn"], cfg.act, h2)
    return x, ((torch.stack(new_k), torch.stack(new_v)),)


def init_cache(cfg, batch: int, max_len: int, device):
    """Zero caches ``((k, v),)``, each ``(L, batch, max_len, KV, hd)``."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return ((torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             torch.zeros(shape, dtype=cfg.torch_dtype, device=device)),)

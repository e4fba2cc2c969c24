"""Decoder stack with group size 1: dense softmax attention, the paper's
streaming linear attention (``attn_impl="linear"``) or Mamba-2.

Layer params are stacked on a leading ``L`` axis, as in the reference:
``params["layers"]`` is a 1-tuple (one sublayer per group) holding
``{"norm1", "mixer"}`` plus ``{"norm2", "ffn"}`` when the sublayer has
an FFN, every leaf ``(L, ...)``.  The reference's ``lax.scan`` over
layers is a Python loop here.  Prefill (``stack_forward``) hands each
layer's packed projection weights (``GEMM_LEAVES``) to the packed-weight
GEMM (``kernels/dequant_gemm``) as they are and dequantizes only the
small packed leaves (norm scales, q/k/v biases, Mamba-2's conv and norm);
decode (``stack_decode``) dequantizes every packed leaf of the layer at
use.  Caches are one tuple per group position: ``(k, v)`` for softmax
attention, ``(state, z)`` for linear attention (per query head, as the
reference lays out its state over repeated k/v), ``(conv_tail,
ssd_state)`` for Mamba-2.  The FFN is a dense MLP or the
mixture of experts (``models/moe.py``), whose stacked expert weights
``w_up`` / ``w_gate`` / ``w_down`` (L, E, ...) prefill passes packed to
the packed-weight GEMM's expert contractions; prefill masks right pads
out of the routing (``valid_len``), decode masks the rows the caller
marks invalid.  Hybrid groups and the encoder-decoder are not ported
yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import QTensor, dequantize, dequantize_tree
from repro_torch.models import attention as attn
from repro_torch.models import linear_attention as lin
from repro_torch.models import mamba2
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.tree import tree_map, tree_map_with_path

# the projection weights prefill passes packed to ``quant_einsum``
GEMM_LEAVES = frozenset(("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
                         "in_proj", "out_proj"))


def group_size(cfg) -> int:
    return cfg.hybrid_group or 1


def sublayer_spec(cfg, pos: int) -> Tuple[str, str]:
    """(mixer_kind, ffn_kind) for position ``pos`` within a group."""
    if cfg.family == "ssm":
        return "mamba", ("none" if cfg.d_ff == 0 else "mlp")
    if cfg.hybrid_group:
        mixer = "attn" if pos == cfg.attn_every else "mamba"
        ffn = "moe" if (cfg.moe and pos % cfg.moe.every == cfg.moe.every - 1) \
            else "mlp"
        return mixer, ffn
    ffn = "moe" if cfg.moe is not None else "mlp"
    return "attn", ffn


def check_supported(cfg):
    """The port's decoder covers uniform stacks (group size 1) of softmax
    attention, linear attention or Mamba-2 mixers with a dense FFN, a
    mixture of experts or none."""
    if (group_size(cfg) != 1 or cfg.attn_impl not in ("softmax", "linear")
            or cfg.encdec):
        raise NotImplementedError(
            f"{cfg.name}: only uniform softmax- or linear-attention or "
            f"Mamba-2 decoders with group size 1 are ported")


def mixer_of(cfg, pos: int = 0) -> str:
    """The mixer at group position ``pos``: "attn", "linear" or
    "mamba"."""
    kind = sublayer_spec(cfg, pos)[0]
    return "linear" if kind == "attn" and cfg.attn_impl == "linear" else kind


def _expand_kv(cfg, t):
    """k/v (B,S,KV,hd) -> (B,S,H,hd): kv head g serves query heads
    g*G .. g*G + G - 1, as the reference's ``jnp.repeat``."""
    return torch.repeat_interleave(t, cfg.n_heads // cfg.n_kv_heads, dim=2)


def init_stack(generator, cfg, device, qkv_bias: bool = False,
               pack=None):
    """Stacked layer params, leading dim ``n_layers``.  ``pack(name,
    leaf)``, when given, packs each stacked expert leaf as it is made
    (``moe.init_moe``)."""
    check_supported(cfg)
    L, D = cfg.n_layers, cfg.d_model
    mixer_kind, ffn_kind = sublayer_spec(cfg, 0)
    sub = {"norm1": init_norm(cfg, D, device, lead=(L,))}
    if mixer_kind == "attn":
        sub["mixer"] = attn.init_attn(generator, cfg, D, device, qkv_bias,
                                      lead=(L,))
    else:
        sub["mixer"] = mamba2.init_mamba(generator, cfg, device, lead=(L,))
    if ffn_kind != "none":
        sub["norm2"] = init_norm(cfg, D, device, lead=(L,))
        sub["ffn"] = (moe_mod.init_moe(generator, cfg, D, device,
                                       lead=(L,), pack=pack)
                      if ffn_kind == "moe" else
                      mlp_mod.init_mlp(generator, cfg, D, cfg.d_ff, device,
                                       lead=(L,)))
    return (sub,)


def layer_slice(params_layers, i: int):
    """Layer ``i`` of the stacked params (QTensors sliced too)."""
    return tree_map(lambda l: l.layer(i) if isinstance(l, QTensor) else l[i],
                    params_layers)


def dequantize_small(sub):
    """Every packed leaf of a layer dequantized except ``GEMM_LEAVES``."""
    def visit(path, leaf):
        if (isinstance(leaf, QTensor)
                and path.rsplit("/", 1)[-1] not in GEMM_LEAVES):
            return dequantize(leaf)
        return leaf
    return tree_map_with_path(visit, sub)


def _ffn(sub, cfg, x, valid=None):
    """x + the FFN of norm2(x); ``valid`` (B, S) bool masks tokens out of
    the MoE's routing."""
    if "ffn" not in sub:
        return x
    h2 = apply_norm(sub["norm2"], x)
    if cfg.moe is not None:
        return x + moe_mod.apply_moe(sub["ffn"], cfg, h2, valid)[0]
    return x + mlp_mod.apply_mlp(sub["ffn"], cfg.act, h2)


def stack_forward(params_layers, cfg, x, rope_fn, *, causal=True,
                  want_cache=False, decode_len=0,
                  valid_len: Optional[torch.Tensor] = None):
    """Run the whole stack.  Returns (x, caches, aux).  With
    ``want_cache``, caches are ``((k, v),)`` stacked ``(L, B, decode_len,
    KV, hd)`` for softmax attention, ``((state, z),)`` stacked ``(L, B,
    H, hd, hd)`` and ``(L, B, H, hd)`` for linear attention,
    ``((conv_tail, ssd_state),)`` stacked ``(L, B, ...)`` for Mamba-2.
    ``valid_len`` (B,) marks right-padded rows: Mamba-2 and
    linear-attention state is taken at each row's true end (softmax
    caches keep the pad positions, which decode's length mask never
    reads), and the pads take no part in the MoE's routing.  ``aux`` is
    0.0: the MoE's load-balance loss is a training term, and training is
    not ported."""
    check_supported(cfg)
    mixer = mixer_of(cfg)
    valid = None
    if valid_len is not None and cfg.moe is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < valid_len.to(x.device)[:, None])
    c0, c1 = [], []
    for i in range(cfg.n_layers):
        sub = dequantize_small(layer_slice(params_layers, i))[0]
        h = apply_norm(sub["norm1"], x)
        if mixer == "mamba":
            y, (a, b) = mamba2.mamba_forward(sub["mixer"], cfg, h,
                                             valid_len=valid_len)
        elif mixer == "linear":
            q, k, v = attn.qkv_proj(sub["mixer"], h)
            q, k = rope_fn(q), rope_fn(k)
            o, a, b = lin.linear_attn_prefill(q, k, v, valid_len=valid_len)
            y = attn.out_proj(sub["mixer"], o)
        else:
            y, (a, b) = attn.attn_train(sub["mixer"], cfg, h, rope_fn,
                                        causal=causal)
            if want_cache:
                pad = decode_len - a.shape[1]
                a = F.pad(a, (0, 0, 0, 0, 0, pad))
                b = F.pad(b, (0, 0, 0, 0, 0, pad))
        x = _ffn(sub, cfg, x + y, valid)
        if want_cache:
            c0.append(a)
            c1.append(b)
    caches = ((torch.stack(c0), torch.stack(c1)),) if want_cache else None
    return x, caches, 0.0


def stack_decode(params_layers, cfg, x, caches, index, rope_fn, *,
                 donate: bool = False,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, tuple]:
    """One decode step through every layer; returns (x, new caches).
    Linear attention takes the plain one-token step (the reference has
    no decode kernel for it).  With ``donate`` the caller hands over the
    stacked softmax caches: each layer's row is written into them in place
    (``attention.update_cache(donate=True)``) and they come back as they
    are, with no copy; other mixers' state is new either way.  ``valid``
    (B,) bool marks the rows that take part in the MoE's routing (a
    cohort's sentinel rows do not); None: every row."""
    check_supported(cfg)
    mixer = mixer_of(cfg)
    if valid is not None:
        valid = valid[:, None]
    c0, c1 = caches[0]
    new0, new1 = [], []
    for i in range(cfg.n_layers):
        sub = dequantize_tree(layer_slice(params_layers, i))[0]
        h = apply_norm(sub["norm1"], x)
        if mixer == "mamba":
            y, (a, b) = mamba2.mamba_decode(sub["mixer"], cfg, h, c0[i],
                                            c1[i])
        elif mixer == "linear":
            q, k, v = attn.qkv_proj(sub["mixer"], h)
            q, k = rope_fn(q), rope_fn(k)
            o, a, b = lin.linear_attn_decode(q, _expand_kv(cfg, k),
                                             _expand_kv(cfg, v), c0[i],
                                             c1[i])
            y = attn.out_proj(sub["mixer"], o)
        else:
            y, k_new, v_new = attn.attn_decode(sub["mixer"], cfg, h, c0[i],
                                               c1[i], index, rope_fn)
            a, b = attn.update_cache(c0[i], c1[i], k_new, v_new, index,
                                     donate=donate)
        new0.append(a)
        new1.append(b)
        x = _ffn(sub, cfg, x + y, valid)
    if donate and mixer == "attn":
        return x, ((c0, c1),)
    return x, ((torch.stack(new0), torch.stack(new1)),)


def init_cache(cfg, batch: int, max_len: int, device):
    """Zero caches stacked ``(L, ...)``: ``((k, v),)`` each ``(L, batch,
    max_len, KV, hd)`` for softmax attention; ``((state, z),)`` fp32
    ``(L, batch, H, hd, hd)`` and ``(L, batch, H, hd)`` for linear
    attention and ``((conv_tail, ssd_state),)`` for Mamba-2, neither of
    which has a length axis."""
    check_supported(cfg)
    mixer = mixer_of(cfg)
    if mixer == "mamba":
        return (mamba2.init_mamba_cache(cfg, batch, device,
                                        lead=(cfg.n_layers,)),)
    if mixer == "linear":
        lead = (cfg.n_layers, batch, cfg.n_heads)
        return ((torch.zeros(lead + (cfg.hd, cfg.hd), dtype=torch.float32,
                             device=device),
                 torch.zeros(lead + (cfg.hd,), dtype=torch.float32,
                             device=device)),)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return ((torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             torch.zeros(shape, dtype=cfg.torch_dtype, device=device)),)

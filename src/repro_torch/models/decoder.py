"""Decoder stack over groups of sublayers: dense softmax attention, the
paper's streaming linear attention (``attn_impl="linear"``), Mamba-2,
and Jamba's hybrid groups (``cfg.hybrid_group`` sublayers a group:
attention at ``cfg.attn_every``, Mamba-2 elsewhere, the mixture of
experts on odd positions, ``sublayer_spec``).

Layer params are stacked on a leading ``n_groups`` axis, as in the
reference: ``params["layers"]`` is a tuple of one sub a group position
(a 1-tuple for a uniform stack) holding ``{"norm1", "mixer"}`` plus
``{"norm2", "ffn"}`` when the sublayer has an FFN, every leaf
``(n_groups, ...)``.  The reference's ``lax.scan`` over groups is a
Python loop here, and each group runs its positions in order.  Prefill
(``stack_forward``) hands each sublayer's packed projection weights
(``GEMM_LEAVES``) to the packed-weight GEMM (``kernels/dequant_gemm``)
as they are and dequantizes only the small packed leaves (norm scales,
q/k/v biases, Mamba-2's conv and norm); decode (``stack_decode``)
dequantizes one sublayer's packed leaves at a time, at use, except the
stacked experts (``EXPERT_LEAVES``).  Caches are one pair a group
position: ``(k, v)`` for softmax attention, ``(state, z)`` for linear
attention (per query head, as the reference lays out its state over
repeated k/v), ``(conv_tail, ssd_state)`` for Mamba-2.  The FFN is a
dense MLP or the mixture of experts (``models/moe.py``), whose stacked
expert weights ``w_up`` / ``w_gate`` / ``w_down`` (n_groups, E, ...)
prefill passes packed to the packed-weight GEMM's expert contractions
and decode to the routed experts' GEMV; prefill masks right pads out of
the routing and out of every Mamba-2 state (``valid_len``), decode
masks the rows the caller marks invalid.  The encoder-decoder has its
own module (``models/encdec.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quantize import QTensor, dequantize, quantize_tree
from repro_torch.models import attention as attn
from repro_torch.models import linear_attention as lin
from repro_torch.models import mamba2
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.tree import key_path, tree_map, tree_map_with_path

# the projection weights prefill passes packed to ``quant_einsum``
GEMM_LEAVES = frozenset(("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
                         "in_proj", "out_proj"))
# a mixture of experts' stacked expert leaves (E, ...), by their path in a
# sublayer: decode reads them packed
EXPERT_LEAVES = frozenset(("ffn/w_up", "ffn/w_gate", "ffn/w_down"))


def group_size(cfg) -> int:
    return cfg.hybrid_group or 1


def n_groups(cfg) -> int:
    """Groups of ``group_size(cfg)`` sublayers in the stack: the stacked
    leading axis of every layer leaf and cache."""
    g = group_size(cfg)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of {g}")
    return cfg.n_layers // g


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
    """The port's decoder covers stacks of groups of softmax- or
    linear-attention and Mamba-2 sublayers (a uniform stack is groups of
    one; Jamba's hybrid groups of 8) with a dense FFN, a mixture of
    experts or none; not the encoder-decoder (``models/encdec.py``)."""
    if cfg.attn_impl not in ("softmax", "linear") or cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: only softmax- or linear-attention, Mamba-2 and "
            f"hybrid decoders are ported")
    n_groups(cfg)


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
               policy=None, path: str = "layers"):
    """Stacked group params: a tuple of one sub a group position, each
    leaf with the leading dim ``n_groups(cfg)`` (the reference's ``vmap``
    over ``init_group``).  With a ``policy`` each position's leaves are
    packed as soon as the position is made, at their key paths under
    ``path`` (``path/pos/...``), the stacked expert leaves one expert at
    a time (``moe.init_moe``): the init never holds more than one group
    position's other leaves dense."""
    check_supported(cfg)
    lead, D = (n_groups(cfg),), cfg.d_model
    subs = []
    for pos in range(group_size(cfg)):
        at = key_path(path, pos)
        mixer_kind, ffn_kind = sublayer_spec(cfg, pos)
        sub = {"norm1": init_norm(cfg, D, device, lead=lead)}
        if mixer_kind == "attn":
            sub["mixer"] = attn.init_attn(generator, cfg, D, device,
                                          qkv_bias, lead=lead)
        else:
            sub["mixer"] = mamba2.init_mamba(generator, cfg, device,
                                             lead=lead)
        if ffn_kind != "none":
            sub["norm2"] = init_norm(cfg, D, device, lead=lead)
            sub["ffn"] = (moe_mod.init_moe(generator, cfg, D, device,
                                           lead=lead, policy=policy,
                                           path=key_path(at, "ffn"))
                          if ffn_kind == "moe" else
                          mlp_mod.init_mlp(generator, cfg, D, cfg.d_ff,
                                           device, lead=lead))
        if policy is not None:
            sub = quantize_tree(sub, policy, path=at)
        subs.append(sub)
    return tuple(subs)


def layer_slice(params_layers, i: int):
    """Group ``i`` of the stacked params (QTensors sliced too)."""
    return tree_map(lambda l: l.layer(i) if isinstance(l, QTensor) else l[i],
                    params_layers)


def dequantize_small(sub):
    """Every packed leaf of a sublayer dequantized except ``GEMM_LEAVES``."""
    def visit(path, leaf):
        if (isinstance(leaf, QTensor)
                and path.rsplit("/", 1)[-1] not in GEMM_LEAVES):
            return dequantize(leaf)
        return leaf
    return tree_map_with_path(visit, sub)


def dequantize_decode(sub):
    """Every packed leaf of a sublayer dequantized at use, except a mixture
    of experts' stacked expert leaves (``EXPERT_LEAVES``), which decode
    reads packed, routed expert by routed expert
    (``moe.apply_moe`` -> ``fused_decode.ops.fused_mlp_experts``)."""
    moe = "router" in sub.get("ffn", {})

    def visit(path, leaf):
        if isinstance(leaf, QTensor) and not (moe and path in EXPERT_LEAVES):
            return dequantize(leaf)
        return leaf
    return tree_map_with_path(visit, sub)


def _ffn(sub, cfg, x, valid=None):
    """(x + the FFN of norm2(x), the sublayer's aux loss: the MoE's
    load-balance term, 0.0 for a dense FFN or none); ``valid`` (B, S)
    bool masks tokens out of the MoE's routing."""
    if "ffn" not in sub:
        return x, 0.0
    h2 = apply_norm(sub["norm2"], x)
    if "router" in sub["ffn"]:
        y, aux = moe_mod.apply_moe(sub["ffn"], cfg, h2, valid)
        return x + y, aux
    return x + mlp_mod.apply_mlp(sub["ffn"], cfg.act, h2), 0.0


def _mixer_forward(sub, cfg, mixer, x, rope_fn, causal, want_cache,
                   decode_len, valid_len):
    """(x + the mixer of norm1(x), its cache pair) of one sublayer."""
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
    return x + y, (a, b)


def stack_forward(params_layers, cfg, x, rope_fn, *, causal=True,
                  want_cache=False, decode_len=0,
                  valid_len: Optional[torch.Tensor] = None):
    """Run the whole stack: the groups in turn, each group's sublayers in
    position order (the reference's scan of ``group_forward``).  Returns
    (x, caches, aux).  With ``want_cache``, caches are one pair a group
    position, stacked over the groups: ``(k, v)`` ``(n_groups, B,
    decode_len, KV, hd)`` for softmax attention, ``(state, z)`` ``(n_groups,
    B, H, hd, hd)`` and ``(n_groups, B, H, hd)`` for linear attention,
    ``(conv_tail, ssd_state)`` ``(n_groups, B, ...)`` for Mamba-2.
    ``valid_len`` (B,) marks right-padded rows: Mamba-2 and
    linear-attention state is taken at each row's true end, in every such
    sublayer of every group (softmax caches keep the pad positions, which
    decode's length mask never reads), and the pads take no part in any
    MoE sublayer's routing.  ``aux`` is the MoE's load-balance loss as
    the reference sums it: each group's MoE sublayers added in position
    order (from 0.0), then the groups' sums summed; 0.0 without an MoE.
    It carries grad through the router's probabilities (``moe.route``),
    and ``model.lm_loss`` adds it to the loss; prefill and decode ignore
    it.  With ``cfg.remat`` and grad enabled, and no caches asked for,
    each group runs under ``torch.utils.checkpoint`` (non-reentrant): its
    activations, its aux included, are recomputed in the backward, the
    reference's ``jax.checkpoint`` of the scan body."""
    check_supported(cfg)
    remat = cfg.remat and torch.is_grad_enabled() and not want_cache
    mixers = [mixer_of(cfg, pos) for pos in range(group_size(cfg))]
    valid = None
    if valid_len is not None and cfg.moe is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < valid_len.to(x.device)[:, None])
    c0 = [[] for _ in mixers]
    c1 = [[] for _ in mixers]

    def run_group(x, g):
        group = layer_slice(params_layers, g)
        aux = 0.0
        for pos, mixer in enumerate(mixers):
            sub = dequantize_small(group[pos])
            x, (a, b) = _mixer_forward(sub, cfg, mixer, x, rope_fn, causal,
                                       want_cache, decode_len, valid_len)
            x, sub_aux = _ffn(sub, cfg, x, valid)
            aux = aux + sub_aux
            if want_cache:
                c0[pos].append(a)
                c1[pos].append(b)
            del sub, a, b
        return x, aux

    auxes = []
    for g in range(n_groups(cfg)):
        if remat:
            x, aux = checkpoint(run_group, x, g, use_reentrant=False)
        else:
            x, aux = run_group(x, g)
        auxes.append(aux)
    caches = (tuple((torch.stack(a), torch.stack(b)) for a, b in zip(c0, c1))
              if want_cache else None)
    if any(isinstance(a, torch.Tensor) for a in auxes):
        aux = torch.sum(torch.stack([torch.as_tensor(
            a, dtype=torch.float32, device=x.device) for a in auxes]))
    else:
        aux = 0.0
    return x, caches, aux


def stack_decode(params_layers, cfg, x, caches, index, rope_fn, *,
                 donate: bool = False,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, tuple]:
    """One decode step through every group, each group's sublayers in
    position order; returns (x, new caches), one pair a group position.
    Each sublayer's packed leaves are dequantized as it runs
    (``dequantize_decode``), never an MoE's stacked experts.  Linear
    attention takes the plain one-token step (the reference has no decode
    kernel for it).  With ``donate`` the caller hands over the stacked
    softmax caches: each sublayer's row is written into them in place
    (``attention.update_cache(donate=True)``) and they come back as they
    are, with no copy; other mixers' state is new either way.  ``valid``
    (B,) bool marks the rows that take part in the MoE's routing (a
    cohort's sentinel rows do not); None: every row."""
    check_supported(cfg)
    mixers = [mixer_of(cfg, pos) for pos in range(group_size(cfg))]
    if valid is not None:
        valid = valid[:, None]
    new0 = [[] for _ in mixers]
    new1 = [[] for _ in mixers]
    for g in range(n_groups(cfg)):
        group = layer_slice(params_layers, g)
        for pos, mixer in enumerate(mixers):
            sub = dequantize_decode(group[pos])
            c0, c1 = caches[pos][0][g], caches[pos][1][g]
            h = apply_norm(sub["norm1"], x)
            if mixer == "mamba":
                y, (a, b) = mamba2.mamba_decode(sub["mixer"], cfg, h, c0, c1)
            elif mixer == "linear":
                q, k, v = attn.qkv_proj(sub["mixer"], h)
                q, k = rope_fn(q), rope_fn(k)
                o, a, b = lin.linear_attn_decode(q, _expand_kv(cfg, k),
                                                 _expand_kv(cfg, v), c0, c1)
                y = attn.out_proj(sub["mixer"], o)
            else:
                y, k_new, v_new = attn.attn_decode(sub["mixer"], cfg, h, c0,
                                                   c1, index, rope_fn)
                a, b = attn.update_cache(c0, c1, k_new, v_new, index,
                                         donate=donate)
            new0[pos].append(a)
            new1[pos].append(b)
            x, _ = _ffn(sub, cfg, x + y, valid)
            del sub
    out = tuple(caches[pos] if donate and mixer == "attn"
                else (torch.stack(new0[pos]), torch.stack(new1[pos]))
                for pos, mixer in enumerate(mixers))
    return x, out


def init_cache(cfg, batch: int, max_len: int, device):
    """Zero caches, one pair a group position, stacked ``(n_groups, ...)``:
    ``(k, v)`` each ``(n_groups, batch, max_len, KV, hd)`` for softmax
    attention; ``(state, z)`` fp32 ``(n_groups, batch, H, hd, hd)`` and
    ``(n_groups, batch, H, hd)`` for linear attention and ``(conv_tail,
    ssd_state)`` for Mamba-2, neither of which has a length axis."""
    check_supported(cfg)
    G = n_groups(cfg)
    out = []
    for pos in range(group_size(cfg)):
        mixer = mixer_of(cfg, pos)
        if mixer == "mamba":
            out.append(mamba2.init_mamba_cache(cfg, batch, device,
                                               lead=(G,)))
        elif mixer == "linear":
            lead = (G, batch, cfg.n_heads)
            out.append((torch.zeros(lead + (cfg.hd, cfg.hd),
                                    dtype=torch.float32, device=device),
                        torch.zeros(lead + (cfg.hd,), dtype=torch.float32,
                                    device=device)))
        else:
            shape = (G, batch, max_len, cfg.n_kv_heads, cfg.hd)
            out.append((torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=device),
                        torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=device)))
    return tuple(out)

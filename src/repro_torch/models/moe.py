"""Mixture-of-Experts FFN: top-k routed experts plus optional shared
experts, the reference's GShard capacity routing in PyTorch.

The tokens are split into groups of ``gs`` tokens; each group gives
every expert a capacity C = max(4, ceil(gs * top_k * capacity_factor /
E)) (:func:`capacity`).  The router's logits are fp32
(:func:`router_logits`: the fp32 rounding of a float64 product, so that
a token's logits, and with them its routing, do not depend on how many
rows the call has; an fp32 GEMM's summation order follows the shape it
is given, and on an H100 a 2-group call's logits differ from the same
groups' in a 4-group call, ``scripts/moe_routing_determinism.py``);
:func:`top_choices` takes the softmax and the top k renormalised, and
:func:`choices` each choice's position in its expert by a cumsum over
the group, one choice rank at a time (every token's first choice before
any second), dropping choices past the capacity.  A bf16 one-hot
dispatch gathers each expert's rows (G, E, C, D); the expert
contractions ``gecd,edf->gecf`` and ``gecf,efd->gecd`` go to
``quant_einsum`` (on the card, one launch of the packed-weight GEMM over
all E experts); the combine casts the gates to the activations' dtype
before the sum; the shared experts' MLP is added on ``x``.

With ``valid=None`` the groups are the reference's: ``min(GROUP_SIZE,
N)`` tokens of the batch flattened row-major, and where N is not a
multiple of that the tokens are padded up to whole groups with masked
rows (the reference raises there); with N a multiple of it the function
is the reference's step for step.  ``valid`` (B, S) bool is the port's
repair of the reference's right padding: an invalid token's one-hots
are zero, so it takes no capacity and gets the shared experts' output
alone, and each row is padded on its own to whole groups of
``GROUP_SIZE`` masked tokens, so that no group holds two rows: a row's
routing depends neither on how far it was padded nor on the rows that
share the call.  A prompt routes the same in every prefill bucket and
batch, and a decode cohort's rows route as each does alone, with room
for every choice (the reference's cohort of 8 has C = 4 and drops).
Every one-hot is a comparison against an ``arange``, with no call that
reads a value back to the host, so the decode step that runs it can be
captured as a CUDA graph.

Training differentiates it as the reference's ``jax.grad`` does: the
gradients flow through the combine weights (the gates, ``top_choices``'
renormalisation, the softmax, the router's logits and, through the
float64 product rounded once, the fp32 router) and the dispatch
product's x, not through ``dispatch = (combine > 0)``, the counts or the
capacity positions (integer and boolean tensors); the aux loss takes its
gradient through the mean probabilities and not through the routed
shares.  The expert products go to ``quant_einsum``, which is
``torch.einsum`` on the dense weights a train step holds.

A decode step (S = 1 with ``valid``) keeps every choice of a valid row
(each row alone in its group), so the dispatch and combine reduce to
each row's gated sum over its top-k experts: :func:`_decode_moe` hands
the router's choices to ``fused_decode.ops.fused_mlp_experts``, which
reads only the routed experts' packed codes (on the card, one
hand-written kernel call); the stacked expert leaves are never
dequantized in decode.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import quantize_stacked
from repro_torch.kernels.dequant_gemm import ops as dg
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import apply_mlp, init_mlp
from repro_torch.tree import key_path

GROUP_SIZE = 256


def capacity(cfg_moe, group_size: int = GROUP_SIZE) -> int:
    c = math.ceil(group_size * cfg_moe.top_k * cfg_moe.capacity_factor
                  / cfg_moe.n_experts)
    return max(4, c)


def _expert_slices(generator, shape, dtype, device, fan_in: int):
    """``dense_init`` draws of a stacked expert leaf ``shape`` (lead...,
    E, a, b), one expert's (a, b) at a time, in row-major order of the
    leading axes: the fp32 temporaries stay one expert's (a full-width
    Jamba expert is 201 M elements a matrix)."""
    for _ in range(int(math.prod(shape[:-2]))):
        yield dense_init(generator, shape[-2:], dtype, device, fan_in=fan_in)


def init_moe(generator, cfg, d_model: int, device, lead=(), policy=None,
             path: str = ""):
    """The reference's tree, shapes and scales: ``router`` fp32 (D, E),
    ``w_up`` / ``w_gate`` (E, D, F), ``w_down`` (E, F, D), ``shared`` an
    MLP of width ``d_ff_shared`` (or ``d_ff_expert * n_shared``), each
    with the stacked ``lead`` axes first.  With a ``policy`` each expert
    leaf is packed as it is drawn, one expert at a time, as
    ``quantize_tree`` packs it at its key path under ``path``
    (``core.quantize.quantize_stacked``): no dense expert leaf exists
    whole."""
    m = cfg.moe
    dt = cfg.torch_dtype
    lead = tuple(lead)
    E, Fe = m.n_experts, m.d_ff_expert
    p = {"router": dense_init(generator, lead + (d_model, E), torch.float32,
                              device, fan_in=d_model)}
    for name, shape, fan_in in (("w_up", (E, d_model, Fe), d_model),
                                ("w_gate", (E, d_model, Fe), d_model),
                                ("w_down", (E, Fe, d_model), Fe)):
        p[name] = quantize_stacked(
            key_path(path, name), lead + shape, dt,
            _expert_slices(generator, lead + shape, dt, device, fan_in),
            policy)
    if m.n_shared:
        # all assigned MoE archs use gated (SwiGLU) FFNs
        p["shared"] = init_mlp(generator, cfg, d_model,
                               m.d_ff_shared or m.d_ff_expert * m.n_shared,
                               device, lead=lead)
    return p


def router_logits(xg: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """xg (G, S, D) against the router (D, E) -> fp32 logits (G, S, E):
    the product in float64, rounded once to fp32."""
    return torch.einsum("gsd,de->gse", xg.to(torch.float64),
                        router.to(torch.float64)).to(torch.float32)


def top_choices(logits: torch.Tensor, top_k: int):
    """logits (G, S, E) fp32 -> (probs, gates (G, S, k) renormalised, idx
    (G, S, k)): each token's top k experts."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def choices(logits: torch.Tensor, top_k: int, cap: int,
            mask: Optional[torch.Tensor] = None):
    """The routing decisions of logits (G, S, E) fp32: (probs, gates (G,
    S, k) renormalised, idx (G, S, k), keep (G, S, k) bool: the choice
    took a position under ``cap``, pos (G, S, k) its position, counts (G,
    E) int32: the choices each expert received, kept or not).  ``mask``
    (G, S) bool: tokens outside it choose nothing (their one-hots are
    zero)."""
    G, S, E = logits.shape
    probs, gates, idx = top_choices(logits, top_k)
    experts = torch.arange(E, device=logits.device)
    counts = torch.zeros((G, E), dtype=torch.int32, device=logits.device)
    keeps, poss = [], []
    for j in range(top_k):
        oh = idx[..., j, None] == experts                       # (G,S,E)
        if mask is not None:
            oh = oh & mask[..., None]
        oh = oh.to(torch.int32)
        pos = (counts[:, None, :] + torch.cumsum(oh, dim=1, dtype=torch.int32)
               - oh)
        counts = counts + oh.sum(dim=1, dtype=torch.int32)
        keeps.append(((pos < cap) & (oh > 0)).any(-1))
        poss.append((pos * oh).sum(-1))
    return (probs, gates, idx, torch.stack(keeps, -1), torch.stack(poss, -1),
            counts)


def route(logits: torch.Tensor, top_k: int, cap: int,
          mask: Optional[torch.Tensor] = None):
    """logits (G, S, E) fp32 -> combine (G, S, E, C) fp32, dispatch bf16,
    aux (the Switch load-balance loss, E * sum(mean prob * routed
    share)), the reference's ``route``; with ``mask``, the means run over
    the tokens inside it."""
    G, S, E = logits.shape
    probs, gates, idx, keep, pos, counts = choices(logits, top_k, cap, mask)
    experts = torch.arange(E, device=logits.device)
    slots = torch.arange(cap, device=logits.device)
    combine = torch.zeros((G, S, E, cap), dtype=torch.float32,
                          device=logits.device)
    for j in range(top_k):
        oh = idx[..., j, None] == experts                       # (G,S,E)
        kj = keep[..., j, None] & oh
        pos_oh = (torch.where(kj, pos[..., j, None], 0)[..., None]
                  == slots).to(torch.float32)                   # (G,S,E,C)
        combine = combine + (gates[..., j, None, None]
                             * kj[..., None].to(torch.float32) * pos_oh)
    dispatch = (combine > 0).to(torch.bfloat16)
    if mask is None:
        me = probs.mean(dim=(0, 1))
        f = (counts.sum(dim=0) / max(1, G * S * top_k)).to(torch.float32)
    else:
        w = mask.to(torch.float32)
        n = torch.clamp(w.sum(), min=1.0)
        me = (probs * w[..., None]).sum(dim=(0, 1)) / n
        f = counts.sum(dim=0).to(torch.float32) / (n * top_k)
    aux = E * torch.sum(me * f)
    return combine, dispatch, aux


def _decode_moe(p, cfg, x: torch.Tensor, valid: torch.Tensor):
    """A decode step's MoE, x (B, 1, D): each row alone in its group (a
    group of GROUP_SIZE padded tokens, as ``apply_moe(valid=)`` pads it,
    so capacity is at least 4 >= top_k and every choice of a valid row is
    kept), so the one-hot dispatch and combine reduce to each valid row's
    gated sum over its top-k experts, which
    ``fused_decode.ops.fused_mlp_experts`` computes from the packed codes
    of the routed experts alone; an invalid row gets the shared experts'
    output alone.  The routing goes through :func:`choices`, as every
    call's does."""
    from repro_torch.kernels.fused_decode import ops as fd
    m = cfg.moe
    B, _, D = x.shape
    logits = router_logits(x, p["router"])                      # (B,1,E)
    _, gates, idx, _, _, _ = choices(logits, m.top_k, capacity(m), valid)
    y = fd.fused_mlp_experts(x.reshape(B, D), p["w_up"], p["w_down"],
                             p.get("w_gate"), idx[:, 0], gates[:, 0],
                             valid[:, 0], act=cfg.act)
    y = y.reshape(B, 1, D).to(x.dtype)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], cfg.act, x)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_moe(p, cfg, x: torch.Tensor,
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss).  ``valid`` (B, S) bool
    (each row in groups of its own, invalid tokens routed nowhere; a
    decode step, S = 1, through the routed experts' GEMV,
    :func:`_decode_moe`, whose aux loss is 0) or None (every token valid,
    groups of ``min(GROUP_SIZE, B * S)`` over the flattened batch)."""
    m = cfg.moe
    B, S, D = x.shape
    if S == 1 and valid is not None:
        return _decode_moe(p, cfg, x, valid.to(torch.bool).reshape(B, 1))
    if valid is None:
        rows, n, gs = 1, B * S, min(GROUP_SIZE, B * S)
        mask = None
    else:
        rows, n, gs = B, S, GROUP_SIZE
        mask = valid.to(torch.bool)
    width = -(-n // gs) * gs
    xr = x.reshape(rows, n, D)
    if width != n:
        if mask is None:
            mask = torch.ones((rows, n), dtype=torch.bool, device=x.device)
        xr = F.pad(xr, (0, 0, 0, width - n))
        mask = F.pad(mask, (0, width - n))
    G = rows * width // gs
    xg = xr.reshape(G, gs, D)
    if mask is not None:
        mask = mask.reshape(G, gs)
    cap = capacity(m, gs)

    logits = router_logits(xg, p["router"])
    combine, dispatch, aux = route(logits, m.top_k, cap, mask)

    xe = torch.einsum("gsd,gsec->gecd", xg, dispatch.to(xg.dtype))
    up = dg.quant_einsum("gecd,edf->gecf", xe, p["w_up"])
    gate = dg.quant_einsum("gecd,edf->gecf", xe, p["w_gate"])
    h = F.silu(gate) * up
    ye = dg.quant_einsum("gecf,efd->gecd", h, p["w_down"])
    y = torch.einsum("gecd,gsec->gsd", ye, combine.to(ye.dtype))
    y = y.reshape(rows, width, D)[:, :n].reshape(B, S, D).to(x.dtype)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], cfg.act, x)
    return y, aux

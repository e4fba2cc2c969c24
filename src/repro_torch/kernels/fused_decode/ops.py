"""Public wrappers for the fused low-bit cohort-decode step.

Each wrapper dispatches on the device of its tensors alone: CPU tensors
run the plain version (``ref.py``); CUDA tensors launch the Hopper kernel
(``kernel.py``) or raise — there is no fallback.  Each wrapper counts its
calls into the compiled library under its own name in the kernels'
launch-count registry (``repro_torch.kernels``), so a run can show that
it went through the kernels; ``fused_mlp`` also counts each call under
``fused_mlp/gemv`` and ``fused_qkv`` each of its device kernels under
``fused_qkv/gemv``, both the split-K GEMV kernel.
``fused_mlp_experts``, the MoE's decode (``models/moe.py``), counts each
call under ``fused_mlp/experts``: two device kernels a call
(``expert.py``), the routed experts' GEMV of each stage with its
reductions inside.  One such call runs
several device kernels: ``fused_qkv`` one a distinct bit width among its
three weights (one for every served profile), ``fused_mlp`` two (the
GEMV of each stage, its epilogue inside), ``kv_scatter`` one.  The GEMV
kernels take bf16 or fp32 activations.

``cohort_step`` is the engine-facing entry: the batched decode step over
the paged pool.  ``use_fused=False`` runs the composed step
(:func:`_composed_cohort_step`: ``ref_cohort_step``'s structure with the
gathered caches donated to ``lm_decode_step``, so each layer's new row
goes in through the cache-row-update kernel, and the pool written in
place by :func:`kv_scatter` and ``ref.scatter_slots``), the only step for
Mamba-2 and linear attention (slot-state pool, as in the reference).
The fused step runs, per layer, :func:`fused_qkv`, the shared attention
core and output projection, and :func:`fused_mlp`; the new K/V rows of
every layer land in the pool in one :func:`kv_scatter` after the last
layer.  Both steps are fixed-shape with no host sync, so the engine
captures each as a CUDA graph per cohort bucket
(``serving/cohort_graph``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import QTensor, dequantize, dequantize_tree
from repro_torch.kernels import count_launch, refuse_grad, register_kernels
from repro_torch.kernels.fused_decode import expert as EK
from repro_torch.kernels.fused_decode import kernel as K
from repro_torch.kernels.fused_decode.ref import (block_and_offset,
                                                  composed_cohort_step,
                                                  gather_context,
                                                  ref_fused_mlp,
                                                  ref_fused_mlp_experts,
                                                  ref_fused_qkv,
                                                  ref_kv_scatter)
from repro_torch.models import attention as attn
from repro_torch.models import decoder as dec
from repro_torch.models import model as M
from repro_torch.models.common import apply_norm
from repro_torch.models.mlp import GATED


def _on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain path), False for CUDA tensors (kernel);
    raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused decode: unsupported device {t.device}")
    return t.device.type == "cpu"


def fused_qkv(h, wq, wk, wv, bq=None, bk=None, bv=None):
    """h (bc,1,D) -> (q, k, v); weights dense or packed QTensors."""
    if _on_cpu(h):
        return ref_fused_qkv(h, wq, wk, wv, bq, bk, bv)
    refuse_grad("fused_qkv", h, wq, wk, wv, bq, bk, bv)
    outs, calls, kernels = K.launch_fused_qkv(h, wq, wk, wv, bq, bk, bv)
    count_launch("fused_qkv", calls)
    count_launch("fused_qkv/gemv", kernels)
    return outs


def fused_mlp(h, w_up, w_down, w_gate=None, *, act: str):
    """h (bc,1,D) -> (bc,1,D): gate/up GEMMs, activation, down GEMM.
    ``act`` is the config's name (swiglu, geglu, gelu, squared_relu)."""
    if _on_cpu(h):
        return ref_fused_mlp(h, w_up, w_down, w_gate, act=act)
    refuse_grad("fused_mlp", h, w_up, w_down, w_gate)
    gated = w_gate is not None
    out, n = K.launch_fused_mlp(h, w_up, w_down, w_gate,
                                GATED[act] if gated else act, gated)
    count_launch("fused_mlp", n)
    count_launch("fused_mlp/gemv", n)
    return out


def fused_mlp_experts(h, w_up, w_down, w_gate, idx, gates, valid, *,
                      act: str):
    """A decode step's routed experts: h (bc, D), the router's top-k
    ``idx`` (bc, k), renormalised ``gates`` (bc, k), the row mask
    ``valid`` (bc,) -> (bc, D): each valid row's gated sum of its experts'
    MLPs, reading only the routed experts' packed codes; an invalid row
    gets 0.  The stacked expert weights (E, K, N) stay packed."""
    if _on_cpu(h):
        return ref_fused_mlp_experts(h, w_up, w_down, w_gate, idx, gates,
                                     valid, act=act)
    refuse_grad("fused_mlp/experts", h, w_up, w_down, w_gate, gates)
    gated = w_gate is not None
    out, n = EK.launch_fused_mlp_experts(h, w_up, w_down, w_gate, idx,
                                         gates, valid,
                                         GATED[act] if gated else act)
    count_launch("fused_mlp/experts", n)
    return out


def kv_scatter(blk, off, k_rows, v_rows, k_pool, v_pool):
    """Write each cohort row's new K/V position (all layers at once) into
    the paged pools, IN PLACE; sentinel rows write nothing.  Returns the
    pools."""
    if _on_cpu(k_pool):
        return ref_kv_scatter(blk, off, k_rows, v_rows, k_pool, v_pool)
    refuse_grad("kv_scatter", k_rows, v_rows, k_pool, v_pool)
    out = K.launch_kv_row_scatter(blk, off, k_rows, v_rows, k_pool, v_pool)
    count_launch("kv_scatter")
    return out


register_kernels("fused_qkv", "fused_qkv/gemv", "fused_mlp", "fused_mlp/gemv",
                 "fused_mlp/experts", "kv_scatter")


def fused_supported(cfg) -> bool:
    """The fused step covers uniform dense-attention archs (group size 1,
    softmax attention, dense MLP)."""
    if dec.group_size(cfg) != 1 or cfg.family == "ssm":
        return False
    if cfg.attn_impl == "linear" or cfg.moe is not None:
        return False
    return cfg.d_ff > 0


def _dq(w):
    return dequantize(w) if isinstance(w, QTensor) else w


def _composed_cohort_step(params, cfg, tokens, lengths, slot_ids, tables,
                          pool, *, block_size: int, paged):
    """The served composed step, ``ref_cohort_step``'s structure with the
    gathered caches donated (they are this step's temporaries), so each
    layer's new K and V rows go in through ``cache_row_update`` with no
    copy, and each row's new K/V position written into the pool IN PLACE
    by :func:`kv_scatter`, each row's new slot state by ``scatter_slots``.
    Returns (logits, pool), the pool the one given."""
    return composed_cohort_step(params, cfg, tokens, lengths, slot_ids,
                                tables, pool, block_size=block_size,
                                paged=paged, donate=True,
                                kv_write=kv_scatter)


def _fused_cohort_step(params, cfg, tokens, lengths, tables, pool, *,
                       block_size: int):
    """The fused replacement for ref_cohort_step (same structure as the
    reference's ``_fused_cohort_step``: embed, one gather of the cohort
    context, per layer fused QKV -> attention core -> output projection
    -> fused MLP, one scatter of every layer's new row, head)."""
    k_pool, v_pool = pool[0]
    L = k_pool.shape[0]
    rope_fn = M.decode_rope_fn(cfg, M.decode_positions(
        lengths, tokens.shape[0], tokens.device))
    x = M._embed(params, cfg, tokens)
    gk = gather_context(k_pool, tables)
    gv = gather_context(v_pool, tables)
    blk, off = block_and_offset(tables, lengths, block_size)
    k_rows, v_rows = [], []
    for i in range(L):
        sub = dec.layer_slice(params["layers"], i)[0]
        mix, ffn = sub["mixer"], sub["ffn"]
        h = apply_norm(dequantize_tree(sub["norm1"]), x)
        q, k_new, v_new = fused_qkv(
            h, mix["wq"], mix["wk"], mix["wv"],
            *(_dq(mix.get(b)) for b in ("bq", "bk", "bv")))
        q, k_new = rope_fn(q), rope_fn(k_new)
        o = attn.attn_context(q, k_new, v_new, gk[i], gv[i], lengths, cfg)
        x = x + attn.out_proj({"wo": _dq(mix["wo"])}, o)
        h2 = apply_norm(dequantize_tree(sub["norm2"]), x)
        x = x + fused_mlp(h2, ffn["w_up"], ffn["w_down"], ffn.get("w_gate"),
                          act=cfg.act)
        k_rows.append(k_new[:, 0])
        v_rows.append(v_new[:, 0])
    k_pool, v_pool = kv_scatter(blk, off, torch.stack(k_rows),
                                torch.stack(v_rows), k_pool, v_pool)
    logits = M._head(params, cfg, x)
    return logits[:, 0], ((k_pool, v_pool),)


def cohort_step(params, cfg, tokens, lengths, slot_ids, tables, pool, *,
                block_size: int, paged, use_fused: Optional[bool] = None):
    """One batched cohort decode step against the paged pool.

    tokens (bc,1); lengths/slot_ids (bc,); tables (bc, W) with sentinel
    ``n_blocks`` for padded rows; pool ``((k, v),)``.  Returns (logits
    (bc, V), pool).  Both steps write the pool in place and return it.
    ``use_fused=None`` resolves to :func:`fused_supported`."""
    if use_fused is None:
        use_fused = fused_supported(cfg)
    if not use_fused:
        return _composed_cohort_step(params, cfg, tokens, lengths, slot_ids,
                                     tables, pool, block_size=block_size,
                                     paged=paged)
    if not fused_supported(cfg):
        raise ValueError(
            "use_fused=True needs a uniform dense-attention arch "
            f"(family={cfg.family}, attn_impl={cfg.attn_impl})")
    if not all(paged):
        raise ValueError("the fused cohort step expects every position paged")
    return _fused_cohort_step(params, cfg, tokens, lengths, tables, pool,
                              block_size=block_size)

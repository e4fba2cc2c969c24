"""Plain PyTorch versions of the fused cohort-decode kernels.

Each is the composed path its kernel replaces — the dequantize -> einsum
chains of ``models/attention`` and ``models/mlp`` and the paged scatter —
written with torch ops only; ``ref_cohort_step`` is the composed decode
step over the pool (paged attention K/V and slot-indexed state).  The
wrappers in ``ops.py`` run these for CPU tensors; the tests hold them
against the reference package, and the card's checks hold each kernel
against them.  ``emulate_fused_mlp`` and ``emulate_fused_qkv`` repeat
the split-K GEMV's summation order (``kernel.gemv_plan``'s and
``kernel.qkv_plan``'s plans) in plain PyTorch, for the tests to hold that
order against the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import model as M
from repro_torch.models.common import activation


def _dq(w):
    return dequantize(w) if isinstance(w, QTensor) else w


def ref_fused_qkv(h, wq, wk, wv, bq: Optional[torch.Tensor] = None,
                  bk: Optional[torch.Tensor] = None,
                  bv: Optional[torch.Tensor] = None):
    """Dequantize, then ``qkv_proj``."""
    p = {"wq": _dq(wq), "wk": _dq(wk), "wv": _dq(wv)}
    if bq is not None:
        p.update(bq=_dq(bq), bk=_dq(bk), bv=_dq(bv))
    return attn.qkv_proj(p, h)


def ref_fused_mlp(h, w_up, w_down, w_gate=None, *, act: str):
    """Dequantize, then ``apply_mlp`` (``act`` is the config's name)."""
    p = {"w_up": _dq(w_up), "w_down": _dq(w_down)}
    if w_gate is not None:
        p["w_gate"] = _dq(w_gate)
    return mlp_mod.apply_mlp(p, act, h)


def emulate_gemv(x, w, plan):
    """fp32 sums x (bc, K) @ w (K, n) in the order of the MLP kernel's
    split-K plan ``plan`` (``kernel.GemvPlan``): each thread adds its K
    rows k0 + sub + s nsub in turn (a product then an add, where the
    kernel fuses them), a CTA adds its sub-rows in order, a cluster its
    CTAs in rank order, and the clusters' sums are added in cluster
    order."""
    x, w = x.float(), w.float()
    bc, K = x.shape
    nsub = 128 // plan.slots
    steps = -(-plan.k_chunk // nsub)
    clusters = []
    for c in range(plan.clusters):
        total = None
        for r in range(plan.cluster):
            k0 = (c * plan.cluster + r) * plan.k_chunk
            kn = max(0, min(plan.k_chunk, K - k0))
            acc = torch.zeros((bc, nsub, w.shape[1]), device=x.device)
            for s in range(steps):
                kk = torch.arange(nsub, device=x.device) + s * nsub
                ok = kk < kn
                rows = (k0 + kk).clamp(max=K - 1)
                term = x[:, rows, None] * w[rows][None]
                acc = acc + torch.where(ok[None, :, None], term,
                                        torch.zeros((), device=x.device))
            cta = acc[:, 0]
            for q in range(1, nsub):
                cta = cta + acc[:, q]
            total = cta if total is None else total + cta
        clusters.append(total)
    out = clusters[0]
    for t in clusters[1:]:
        out = out + t
    return out


def emulate_fused_qkv(h, wq, wk, wv, bq=None, bk=None, bv=None, plan=None):
    """``ref_fused_qkv`` with the kernel's summation order (``plan``: the
    ``GemvPlan`` of the one launch over the three weights, of one bit
    width, side by side along the outputs) and its roundings to h's dtype
    T: each output rt(rt(sum) + bias), or rt(sum) without biases."""
    dt = h.dtype
    bc, _, D = h.shape
    ws = [_dq(w) for w in (wq, wk, wv)]
    y = emulate_gemv(h.reshape(bc, D), torch.cat(
        [w.reshape(D, -1) for w in ws], 1), plan).to(dt)
    outs, c0 = [], 0
    for w, b in zip(ws, (bq, bk, bv)):
        n = w[0].numel()
        o = y[:, c0:c0 + n]
        if b is not None:
            o = (o.float() + _dq(b).reshape(-1).to(dt).float()).to(dt)
        outs.append(o.reshape((bc, 1) + tuple(w.shape[1:])))
        c0 += n
    return tuple(outs)


def emulate_fused_mlp(h, w_up, w_down, w_gate=None, *, act: str,
                      plans):
    """``ref_fused_mlp`` with the kernel's summation order (``plans``:
    the two stages' ``GemvPlan``) and its roundings to h's dtype T: up
    and gate each to T, mid = rt(rt(act(rt(gate))) * rt(up)) (or
    rt(act(rt(up)))), out to T."""
    dt = h.dtype
    bc, _, D = h.shape
    x = h.reshape(bc, D)

    def rt(t):
        return t.to(dt).float()
    up = rt(emulate_gemv(x, _dq(w_up), plans[0]))
    if w_gate is not None:
        gate = rt(emulate_gemv(x, _dq(w_gate), plans[0]))
        mid = rt(rt(activation(mlp_mod.GATED[act])(gate)) * up)
    else:
        mid = rt(activation(act)(up))
    out = emulate_gemv(mid, _dq(w_down), plans[1])
    return out.to(dt).reshape(bc, 1, D)


def ref_kv_scatter(blk, off, k_rows, v_rows, k_pool, v_pool):
    """In place, like the kernel: row (g, b) lands at pool[g, blk[b],
    off[b]]; rows whose block id is out of range (the sentinel
    ``n_blocks``) write nothing.  Returns the pools."""
    n_blocks, bs = k_pool.shape[1:3]
    blk = blk.to(torch.long)
    off = off.to(torch.long)
    ok = (blk >= 0) & (blk < n_blocks) & (off >= 0) & (off < bs)
    k_pool[:, blk[ok], off[ok]] = k_rows[:, ok].to(k_pool.dtype)
    v_pool[:, blk[ok], off[ok]] = v_rows[:, ok].to(v_pool.dtype)
    return k_pool, v_pool


def gather_context(pool_leaf, tables):
    """(L, n_blocks, bs, ...) pool + (bc, W) block tables -> each row's
    context (L, bc, W*bs, ...); sentinel ids (>= n_blocks) read zeros."""
    n_blocks, bs = pool_leaf.shape[1:3]
    bc, W = tables.shape
    valid = tables < n_blocks
    g = pool_leaf[:, tables.clamp(max=n_blocks - 1).to(torch.long)]
    mask = valid.reshape((1, bc, W) + (1,) * (g.dim() - 3))
    g = torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return g.reshape((g.shape[0], bc, W * bs) + tuple(g.shape[4:]))


def block_and_offset(tables, lengths, block_size: int):
    """The block holding each row's next position, and its offset."""
    blk = torch.gather(tables, 1,
                       (lengths // block_size)[:, None].to(torch.long))[:, 0]
    return blk, lengths % block_size


def gather_slots(pool_leaf, slot_ids):
    """(L, n_slots, ...) slot-state pool + (bc,) slot ids -> each row's
    state (L, bc, ...); the sentinel id (>= n_slots) reads zeros."""
    n_slots = pool_leaf.shape[1]
    valid = slot_ids < n_slots
    g = pool_leaf[:, slot_ids.clamp(max=n_slots - 1).to(torch.long)]
    mask = valid.reshape((1, -1) + (1,) * (g.dim() - 2))
    return torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device))


def scatter_slots(pool_leaf, slot_ids, rows):
    """Each row's new state (L, bc, ...) written IN PLACE at its slot of
    the (L, n_slots, ...) pool by one fixed-shape ``index_copy_``, with no
    host sync and no copy of the pool (a CUDA graph captures it).  A
    sentinel row (slot id >= n_slots) is sent to a slot no real row
    writes and writes that slot's own state back: it changes nothing.
    Such a slot exists whenever a row is a sentinel, given at most n_slots
    rows and real rows on distinct slots (the engine's cohorts).  Returns
    ``pool_leaf``."""
    n_slots = pool_leaf.shape[1]
    ids = slot_ids.to(torch.long)
    ok = ids < n_slots
    hit = torch.zeros(n_slots + 1, dtype=torch.int32, device=ids.device)
    hit.index_fill_(0, ids.clamp(max=n_slots), 1)
    spare = hit[:n_slots].argmin()          # the first slot no row writes
    mask = ok.reshape((1, -1) + (1,) * (rows.dim() - 2))
    vals = torch.where(mask, rows.to(pool_leaf.dtype),
                       pool_leaf[:, spare.reshape(1)])
    return pool_leaf.index_copy_(1, torch.where(ok, ids, spare), vals)


def scatter_slots_copy(pool_leaf, slot_ids, rows):
    """A copy of the (L, n_slots, ...) pool with each row's new state
    (L, bc, ...) written at its slot; sentinel rows write nothing (the
    plain step's form: the input pool is not modified)."""
    ok = slot_ids < pool_leaf.shape[1]
    out = pool_leaf.clone()
    out[:, slot_ids[ok].to(torch.long)] = rows[:, ok].to(out.dtype)
    return out


def composed_cohort_step(params, cfg, tokens, lengths, slot_ids, tables,
                         pool, *, block_size: int, paged, donate: bool,
                         kv_write, slot_write=scatter_slots):
    """The composed cohort step: gather every row's context through its
    block table (attention) or its slot (slot state), one
    ``lm_decode_step`` over the cohort (``donate``: the gathered caches
    are handed to it to be written in place), then write each row's new
    K/V position back through the table with ``kv_write`` (a
    ``kv_scatter``-like function returning the pools) and its new state
    back by slot with ``slot_write`` (``scatter_slots``: in place).  An
    MoE routes only the real rows: sentinel rows (block id ``n_blocks``)
    take no capacity.  Returns (logits, pool)."""
    bc = tokens.shape[0]
    layers = tuple(
        tuple(gather_context(l, tables) if is_paged
              else gather_slots(l, slot_ids) for l in pool[pos])
        for pos, is_paged in enumerate(paged))
    cache = {"layers": layers, "index": lengths}
    valid = None
    if cfg.moe is not None:
        valid = tables[:, 0] < pool[paged.index(True)][0].shape[1]
    logits, new = M.lm_decode_step(params, cfg, tokens, cache, donate=donate,
                                   valid=valid)
    rows = torch.arange(bc, device=tokens.device)
    idx = lengths.to(torch.long)
    out = []
    for pos, is_paged in enumerate(paged):
        if not is_paged:
            out.append(tuple(slot_write(l, slot_ids, nl)
                             for l, nl in zip(pool[pos], new["layers"][pos])))
            continue
        blk, off = block_and_offset(tables, lengths, block_size)
        (k_pool, v_pool), (nk, nv) = pool[pos], new["layers"][pos]
        out.append(kv_write(blk, off, nk[:, rows, idx], nv[:, rows, idx],
                            k_pool, v_pool))
    return logits, tuple(out)


def ref_cohort_step(params, cfg, tokens, lengths, slot_ids, tables, pool, *,
                    block_size: int, paged):
    """The plain composed step (:func:`composed_cohort_step` with nothing
    donated and the plain scatters on copies of the pools).  Returns
    (logits, new pool); the input pool is not modified (and needs no
    spare slot)."""
    def write_copies(blk, off, k_rows, v_rows, k_pool, v_pool):
        return ref_kv_scatter(blk, off, k_rows, v_rows, k_pool.clone(),
                              v_pool.clone())
    return composed_cohort_step(params, cfg, tokens, lengths, slot_ids,
                                tables, pool, block_size=block_size,
                                paged=paged, donate=False,
                                kv_write=write_copies,
                                slot_write=scatter_slots_copy)

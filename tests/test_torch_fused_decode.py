"""The port's fused-decode step against the reference's, on the CPU.

On CPU tensors each wrapper runs its plain version (the kernels run only
on the card; ``test_torch_cuda_kernels.py`` holds them against these
plain versions there).  Here:

* ``fused_qkv`` / ``fused_mlp`` agree with the reference's composed
  oracles (``ref_fused_qkv`` / ``ref_fused_mlp``) and with one
  interpret-mode call of each Pallas kernel — within 1e-5 * (1 + max|ref|)
  in fp32 (summation order only) and 2e-2 * max|ref| in bf16 (one bf16
  rounding step, 2^-8, at different points of the two frameworks);
* the split-K GEMV's launch plans (``kernel.mlp_plans`` for the MLP,
  ``kernel.qkv_plans`` for the fused QKV) cover every output vector and
  K row once at every served width, and its fixed-order split-K
  reduction (``ref.emulate_fused_mlp``, ``ref.emulate_fused_qkv``)
  matches the reference within the same tolerances;
* ``kv_scatter`` is bit-exact and sentinel rows leave the pool's bits
  unchanged;
* the composed and the fused ``cohort_step`` both match the reference's
  ``ref_cohort_step`` on logits and pools, across cohort buckets 1/2/4
  with sentinel rows, on reduced llava and (M-RoPE) reduced qwen2-vl
  (the reference's step under ``jax.jit``, as its engine runs it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bits, f32, from_numpy_to_ref, shared_params
from repro.kernels import fused_decode as RF
from repro_torch import bridge
from repro_torch.core import quantize as TQ
from repro_torch.kernels import fused_decode as TF
from repro_torch.kernels.fused_decode import kernel as FK
from repro_torch.kernels.fused_decode.ref import (emulate_fused_mlp,
                                                  emulate_fused_qkv)

SPEC = {"dense": None, "q4": (4, 32), "q8": (8, 64)}
ref_cohort_step = jax.jit(RF.ref_cohort_step, static_argnums=(1,),
                          static_argnames=("block_size", "paged"))
# the composed oracles, compiled once per shape (tolerance checks only)
ref_fused_qkv = jax.jit(RF.ref_fused_qkv)
ref_fused_mlp = jax.jit(RF.ref_fused_mlp, static_argnames=("act",))


def _tol(dtype, m):
    return 1e-5 * (1.0 + m) if dtype == "float32" else 2e-2 * m


def _weight(rng, shape, label, dtype):
    """(reference weight, port weight): dense, or packed by the port's
    quantize (bit-equal to the reference's, test_torch_quantize_bridge)."""
    w = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                    / np.sqrt(shape[0])).astype(dtype)
    tw = bridge.array_to_tensor(np.asarray(w), device="cpu")
    if SPEC[label] is None:
        return w, tw
    nbits, g = SPEC[label]
    tq = TQ.quantize(tw, TQ.QuantSpec(nbits, group_size=g))
    return from_numpy_to_ref(bridge.to_numpy(tq)), tq


def _check(want, got, dtype):
    want, got = f32(want), f32(got)
    assert want.shape == got.shape
    m = float(np.abs(want).max())
    assert float(np.abs(want - got).max()) <= _tol(dtype, m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label", ["dense", "q4", "q8"])
def test_fused_qkv_plain_matches_reference(dtype, label):
    rng = np.random.default_rng(3)
    D, H, KV, hd, bc = 64, 4, 2, 32, 3
    h = jnp.asarray(rng.standard_normal((bc, 1, D)).astype(np.float32)
                    ).astype(dtype)
    ws = [_weight(rng, (D, n, hd), label, dtype) for n in (H, KV, KV)]
    bs = [jnp.asarray(rng.standard_normal((n, hd)).astype(np.float32)
                      ).astype(dtype) for n in (H, KV, KV)]
    th = bridge.array_to_tensor(np.asarray(h), device="cpu")
    tb = [bridge.array_to_tensor(np.asarray(b), device="cpu") for b in bs]
    for bias in (False, True):
        want = ref_fused_qkv(h, *[w[0] for w in ws],
                                *(bs if bias else (None,) * 3))
        got = TF.fused_qkv(th, *[w[1] for w in ws],
                           *(tb if bias else (None,) * 3))
        for wt, gt in zip(want, got):
            _check(wt, gt, dtype)
    if label == "q4":                 # one interpret-mode Pallas call
        pallas = RF.fused_qkv(h, *[w[0] for w in ws], *bs, interpret=True)
        for wt, gt in zip(pallas, got):
            _check(wt, gt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label", ["dense", "q4", "q8"])
def test_fused_mlp_plain_matches_reference(dtype, label):
    rng = np.random.default_rng(5)
    D, F, bc = 64, 128, 3
    h = jnp.asarray(rng.standard_normal((bc, 1, D)).astype(np.float32)
                    ).astype(dtype)
    th = bridge.array_to_tensor(np.asarray(h), device="cpu")
    up = _weight(rng, (D, F), label, dtype)
    down = _weight(rng, (F, D), label, dtype)
    gate = _weight(rng, (D, F), label, dtype)
    for act in ("swiglu", "geglu", "gelu"):
        g = gate if act != "gelu" else (None, None)
        want = ref_fused_mlp(h, up[0], down[0], g[0], act=act)
        got = TF.fused_mlp(th, up[1], down[1], g[1], act=act)
        _check(want, got, dtype)
    if label == "q4":                 # one interpret-mode Pallas call
        pallas = RF.fused_mlp(h, up[0], down[0], gate[0], act="swiglu",
                              interpret=True)
        got = TF.fused_mlp(th, up[1], down[1], gate[1], act="swiglu")
        _check(pallas, got, dtype)


def test_kv_scatter_bit_exact_and_sentinel_writes_nothing():
    rng = np.random.default_rng(0)
    L, nb, bs, KV, hd, bc = 2, 8, 4, 2, 16, 3
    kp = jnp.asarray(rng.standard_normal((L, nb, bs, KV, hd)).astype(
        np.float32)).astype(jnp.bfloat16)
    vp = kp * 0.5
    kr = jnp.asarray(rng.standard_normal((L, bc, KV, hd)).astype(
        np.float32)).astype(jnp.bfloat16)
    vr = kr * 2.0
    blk = np.array([1, nb, 5], np.int32)          # row 1 is a sentinel
    off = np.array([2, 0, 3], np.int32)
    want = RF.ref_kv_scatter(jnp.asarray(blk), jnp.asarray(off), kr, vr, kp,
                             vp)
    pallas = RF.kv_scatter(jnp.asarray(blk), jnp.asarray(off), kr, vr, kp,
                           vp, interpret=True)
    t = [bridge.array_to_tensor(np.asarray(a), device="cpu")
         for a in (kr, vr, kp, vp)]
    got = TF.kv_scatter(torch.from_numpy(blk), torch.from_numpy(off), *t)
    assert got[0] is t[2] and got[1] is t[3]       # written in place
    for w, p, g in zip(want, pallas, got):
        assert np.array_equal(bits(np.asarray(w)), bridge.tensor_to_array(g))
        assert np.array_equal(bits(np.asarray(p)), bridge.tensor_to_array(g))
    untouched = np.ones((L, nb, bs), bool)
    untouched[:, [1, 5], [2, 3]] = False
    assert np.array_equal(bridge.tensor_to_array(got[0])[untouched],
                          bits(np.asarray(kp))[untouched])


def _cohort_state(cfg, bc, nb=16, bs=4, W=6, seed=7):
    rng = np.random.default_rng(seed)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    kp = jnp.asarray(rng.standard_normal((L, nb, bs, KV, hd)).astype(
        np.float32)).astype(cfg.dtype)
    tokens = (np.arange(bc)[:, None] % 50 + 3).astype(np.int32)
    lengths = np.array([(5 + 7 * i) % (W * bs) for i in range(bc)], np.int32)
    tables = (np.arange(bc * W, dtype=np.int32).reshape(bc, W) * 5) % nb
    if bc >= 2:                                # last row: padded sentinel
        tables[bc - 1] = nb
        lengths[bc - 1] = 0
    return tokens, lengths, np.arange(bc, dtype=np.int32), tables, \
        ((kp, kp * 0.5),), bs


@pytest.mark.parametrize("dtype,bc", [("float32", 1), ("float32", 2),
                                      ("float32", 4), ("bfloat16", 4)])
def test_cohort_step_matches_reference(dtype, bc):
    """Composed and fused ``cohort_step`` vs the reference's composed
    ``ref_cohort_step``: logits within 1e-4 (fp32) / 5e-2 (bf16, the
    model tests' bound) of the largest logit; pools bit-equal outside
    the written cells, written cells within 1e-4 / 2e-2."""
    _check_cohort_step("llava-onevision-0.5b", dtype, bc)


@pytest.mark.parametrize("bc", [1, 2])
def test_qwen2_vl_cohort_step_matches_reference(bc):
    """The same on reduced qwen2-vl: an M-RoPE decode (positions stacked
    on three streams) through the fused and the composed step."""
    _check_cohort_step("qwen2-vl-7b", "float32", bc)


def _check_cohort_step(arch, dtype, bc):
    rcfg, rparams, tcfg, tparams = shared_params(arch, dtype,
                                                 "nanomind-serve")
    tokens, lengths, slot_ids, tables, pool, bs = _cohort_state(rcfg, bc)
    rl, rpool = ref_cohort_step(
        rparams, rcfg, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(slot_ids), jnp.asarray(tables), pool, block_size=bs,
        paged=(True,))
    written = np.zeros(pool[0][0].shape[:3], bool)
    for b in range(bc):
        blk = tables[b, lengths[b] // bs]
        if blk < pool[0][0].shape[1]:
            written[:, blk, lengths[b] % bs] = True
    tol, wtol = (1e-4, 1e-4) if dtype == "float32" else (5e-2, 2e-2)
    for fused in (False, True):
        tpool = tuple(tuple(bridge.array_to_tensor(np.asarray(l), device="cpu")
                            for l in pos) for pos in pool)
        with torch.no_grad():
            tl, tpool2 = TF.cohort_step(
                tparams, tcfg, torch.from_numpy(tokens),
                torch.from_numpy(lengths), torch.from_numpy(slot_ids),
                torch.from_numpy(tables), tpool, block_size=bs,
                paged=(True,), use_fused=fused)
        m = float(np.abs(f32(rl)).max())
        assert float(np.abs(f32(rl) - f32(tl)).max()) <= tol * m
        for r, tt, old in zip(rpool[0], tpool2[0], pool[0]):
            r, old = np.asarray(r), np.asarray(old)
            t = bridge.tensor_to_array(tt)
            assert np.array_equal(bits(t)[~written], bits(old)[~written])
            assert np.array_equal(bits(r)[~written], bits(old)[~written])
            rw = np.asarray(r, np.float32)[written]
            tw = f32(tt)[written]
            if rw.size:
                assert float(np.abs(rw - tw).max()) <= \
                    wtol * float(np.abs(rw).max())


# -- the MLP kernel's split-K plan and its summation order ----------------------

SERVED_MLP = {"llava-onevision-0.5b": (896, 4864), "qwen2-vl-7b": (3584, 18944)}
# the served QKV widths: D, then the outputs of wq, wk, wv (heads x hd)
SERVED_QKV = {"llava-onevision-0.5b": (896, (896, 128, 128)),
              "qwen2-vl-7b": (3584, (3584, 512, 512))}


def _check_plan_rows(p, K):
    """The CTAs' K ranges cover every row exactly once, in whole clusters
    of at most 8 CTAs, each pass at most 4 rows and 128 accumulators a
    thread; the counters one a tile and cluster rank."""
    rows = np.zeros(K, int)
    for kb in range(p.k_split):
        rows[kb * p.k_chunk:min(K, (kb + 1) * p.k_chunk)] += 1
    assert (rows == 1).all() and p.k_chunk <= FK.MAX_K_CHUNK
    assert p.k_split == p.cluster * p.clusters
    assert 1 <= p.cluster <= FK.MAX_CLUSTER
    assert p.rows <= 4 and p.rows * p.vec <= 128
    assert p.counters == p.tiles * p.cluster
    assert p.args() == (p.rows, p.slots, p.k_chunk, p.cluster, p.clusters)


@pytest.mark.parametrize("bc", range(1, 9))
@pytest.mark.parametrize("bits", [0, 2, 4, 8])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("arch", list(SERVED_MLP))
def test_gemv_plan_covers_every_output_and_row_once(arch, elem_bytes, bits,
                                                    bc):
    """Both stages' plans at every served width, dtype, packing and
    cohort: the column tiles cover every 16-byte vector of each segment
    exactly once, the CTAs' K ranges every row exactly once, the K split
    is whole clusters of at most 8 CTAs, each pass at most 4 rows and
    128 accumulators a thread, the scratch sizes match, and at
    Qwen2-VL-7B's widths each stage runs at least 132 CTAs.  The fused
    QKV's one launch at the same width, dtype, packing and cohort: its
    tiles cover every vector of each of q, k and v exactly once, each
    tile in one weight, its K split as above, its scratch and counters
    sized to match."""
    D, F = SERVED_MLP[arch]
    plans = FK.mlp_plans(D, F, True, (bits, bits), elem_bytes, bc)
    for p, (K, n, nseg) in zip(plans, ((D, F, 2), (F, D, 1))):
        assert p.vec == (128 // bits if bits else 16 // elem_bytes)
        nvec = n // p.vec
        sps = p.slots // nseg
        hits = np.zeros((nseg, p.tiles * sps), int)
        for tile in range(p.tiles):
            for slot in range(p.slots):
                hits[slot // sps, tile * sps + slot % sps] += 1
        assert (hits[:, :nvec] == 1).all() and hits.shape[1] - nvec < sps
        _check_plan_rows(p, K)
        assert p.rows * p.passes >= bc
        assert p.partial == (p.clusters * bc * nseg * n if p.clusters > 1
                             else 0)
        if arch == "qwen2-vl-7b":
            assert p.tiles * p.k_split >= FK.SMS

    K, ns = SERVED_QKV[arch]
    (p,) = FK.qkv_plans(K, tuple((n, bits) for n in ns), elem_bytes, bc)
    assert p.vec == (128 // bits if bits else 16 // elem_bytes)
    _check_plan_rows(p, K)
    assert p.rows * p.passes >= bc
    assert all(n % p.vec == 0 for n in ns)
    # each weight in whole column tiles from its first: every vector of
    # q, k and v once, each CTA in one weight
    tile0 = np.cumsum((0,) + tuple(-(-(n // p.vec) // p.slots) for n in ns))
    assert p.tiles == tile0[-1]
    hits = [np.zeros(n // p.vec, int) for n in ns]
    for tile in range(p.tiles):
        seg = int(np.searchsorted(tile0, tile, side="right")) - 1
        for slot in range(p.slots):
            vec = (tile - tile0[seg]) * p.slots + slot
            if vec < len(hits[seg]):
                hits[seg][vec] += 1
    assert all((hit == 1).all() for hit in hits)
    width = FK.qkv_width(ns, p.vec, p.slots)
    assert width == p.tiles * p.slots * p.vec
    assert p.partial == (p.clusters * bc * width if p.clusters > 1 else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", ["plan", "clusters", "ragged"])
def test_mlp_reduction_order_matches_reference(dtype, split):
    """The kernel's fixed-order split-K reduction (``emulate_fused_mlp``:
    thread rows, CTA sub-rows, cluster ranks, clusters, each in order)
    against the reference's ``fused_mlp_pallas`` in interpret mode and its
    ``ref_fused_mlp``: the plan of these widths, a split over two
    clusters of 8 CTAs, and 3 clusters of 5 with empty CTAs past K."""
    rng = np.random.default_rng(11)
    D, F, bc = 64, 128, 3
    h = jnp.asarray(rng.standard_normal((bc, 1, D)).astype(np.float32)
                    ).astype(dtype)
    th = bridge.array_to_tensor(np.asarray(h), device="cpu")
    up, down, gate = (_weight(rng, s, "q4", dtype)
                      for s in ((D, F), (F, D), (D, F)))
    p1, p2 = FK.mlp_plans(D, F, True, (4, 4), th.element_size(), bc)
    if split == "clusters":
        p1 = dataclasses.replace(p1, k_chunk=4, k_split=16, cluster=8,
                                 clusters=2)
        p2 = dataclasses.replace(p2, k_chunk=8, k_split=16, cluster=8,
                                 clusters=2)
    elif split == "ragged":
        p1 = dataclasses.replace(p1, k_chunk=5, k_split=15, cluster=5,
                                 clusters=3)
        p2 = dataclasses.replace(p2, k_chunk=9, k_split=15, cluster=5,
                                 clusters=3)
    got = emulate_fused_mlp(th, up[1], down[1], gate[1], act="swiglu",
                            plans=(p1, p2))
    assert got.dtype == th.dtype and tuple(got.shape) == (bc, 1, D)
    _check(ref_fused_mlp(h, up[0], down[0], gate[0], act="swiglu"), got,
           dtype)
    _check(RF.fused_mlp(h, up[0], down[0], gate[0], act="swiglu",
                        interpret=True), got, dtype)


QKV_SPLITS = {"plan": None, "clusters": dict(k_chunk=4, k_split=16,
                                             cluster=8, clusters=2),
              "ragged": dict(k_chunk=5, k_split=15, cluster=5, clusters=3)}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", list(QKV_SPLITS))
def test_qkv_reduction_order_matches_reference(split, dtype, bias):
    """The fused QKV's one launch over q | k | v side by side, in the
    kernel's fixed-order split-K reduction with its rt(rt(sum) + bias)
    epilogue (``emulate_fused_qkv``), against the reference's
    ``fused_qkv_pallas`` in interpret mode and its ``ref_fused_qkv``: the
    plan of these widths, a split over two clusters of 8 CTAs, and 3
    clusters of 5 with empty CTAs past K."""
    rng = np.random.default_rng(13)
    D, H, KV, hd, bc = 64, 4, 2, 32, 3
    h = jnp.asarray(rng.standard_normal((bc, 1, D)).astype(np.float32)
                    ).astype(dtype)
    th = bridge.array_to_tensor(np.asarray(h), device="cpu")
    ws = [_weight(rng, (D, n, hd), "q4", dtype) for n in (H, KV, KV)]
    bs = [jnp.asarray(rng.standard_normal((n, hd)).astype(np.float32)
                      ).astype(dtype) if bias else None for n in (H, KV, KV)]
    tb = [None if b is None else bridge.array_to_tensor(np.asarray(b),
                                                        device="cpu")
          for b in bs]
    (plan,) = FK.qkv_plans(D, tuple((n * hd, 4) for n in (H, KV, KV)),
                           th.element_size(), bc)
    if QKV_SPLITS[split] is not None:
        plan = dataclasses.replace(plan, **QKV_SPLITS[split])
    got = emulate_fused_qkv(th, *[w[1] for w in ws], *tb, plan=plan)
    refs = ref_fused_qkv(h, *[w[0] for w in ws], *bs)
    pallas = RF.fused_qkv(h, *[w[0] for w in ws], *bs, interpret=True)
    for g, r, pl, n in zip(got, refs, pallas, (H, KV, KV)):
        assert g.dtype == th.dtype and tuple(g.shape) == (bc, 1, n, hd)
        _check(r, g, dtype)
        _check(pl, g, dtype)

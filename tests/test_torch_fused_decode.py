"""The port's fused-decode step against the reference's, on the CPU.

On CPU tensors each wrapper runs its plain version (the kernels run only
on the card; ``test_torch_cuda_kernels.py`` holds them against these
plain versions there).  Here:

* ``fused_qkv`` / ``fused_mlp`` agree with the reference's composed
  oracles (``ref_fused_qkv`` / ``ref_fused_mlp``) and with one
  interpret-mode call of each Pallas kernel — within 1e-5 * (1 + max|ref|)
  in fp32 (summation order only) and 2e-2 * max|ref| in bf16 (one bf16
  rounding step, 2^-8, at different points of the two frameworks);
* ``kv_scatter`` is bit-exact and sentinel rows leave the pool's bits
  unchanged;
* the composed and the fused ``cohort_step`` both match the reference's
  ``ref_cohort_step`` on logits and pools, across cohort buckets 1/2/4
  with sentinel rows, on reduced llava and (M-RoPE) reduced qwen2-vl
  (the reference's step under ``jax.jit``, as its engine runs it).
"""
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

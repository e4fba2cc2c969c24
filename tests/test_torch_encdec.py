"""The port's encoder-decoder (``models/encdec.py``, seamless-m4t-large-v2)
held against the reference's ``models/encdec.py`` on the CPU, at the
reference's ``reduced()`` config (2 encoder + 2 decoder layers, d 128, 4
heads of 32, d_ff 256, vocab 512): 64 audio frames and a 16-token
target made with numpy from a seed, the same weights in both packages
(the port's init, through the bridge), fp32 and bf16, dense and
``nanomind-serve``, ``attn_q_chunk`` 0 (the flash kernel's plain
version against the reference's ``dense_attention``) and 512 (chunked).

Tolerances, each relative to the largest magnitude of the reference's
tensor: fp32 1e-4, bf16 5e-2 (the frameworks round bf16 apart).  Decode
is compared teacher-forced (fixed tokens, not greedy ones): bf16 logits
make exact ties likely.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (bits, f32, flat, from_numpy_to_ref, jax_to_numpy,
                           shared_params)
from repro.configs import get_config as ref_config
from repro.core import quantize as RQ
from repro.launch import steps as RS
from repro.models import attention as RA
from repro.models import encdec as RED
from repro.models.common import apply_rope as r_rope
from repro.models.common import default_positions as r_positions
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.quantize import (PROFILES, QTensor, QuantPolicy,
                                       quantize_tree)
from repro_torch.kernels.dequant_gemm import ops as dg_ops
from repro_torch.kernels.fused_decode import ops as fd_ops
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TED
from repro_torch.models import model as TM
from repro_torch.models.common import apply_rope as t_rope
from repro_torch.models.common import default_positions as t_positions

ARCH = "seamless-m4t-large-v2"
B, T, S, MAX_LEN, STEPS = 2, 64, 16, 24, 4
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
CASES = [(d, p, q) for d in ("float32", "bfloat16")
         for p in (None, "nanomind-serve") for q in (0, 512)]
IDS = [f"{d}-{p or 'dense'}-q{q}" for d, p, q in CASES]


def _close(got, want, dtype, what):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, what
    err = float(np.abs(g - w).max())
    assert err <= TOL[dtype] * float(np.abs(w).max()), (what, err)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((B, T, 128)) * 0.02).astype(np.float32)
    tgt = rng.integers(3, 500, (B, S)).astype(np.int32)
    new = rng.integers(3, 500, (STEPS, B, 1)).astype(np.int32)
    return src, tgt, new


def _cfgs(dtype, policy, q_chunk):
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, dtype, policy)
    return (dataclasses.replace(rcfg, attn_q_chunk=q_chunk), rparams,
            dataclasses.replace(tcfg, attn_q_chunk=q_chunk), tparams)


@functools.lru_cache(maxsize=None)
def _run(dtype, policy, q_chunk):
    """encode, prefill and four teacher-forced decode steps through both
    packages; the port's self-cache rows read after each step (the step
    writes them in place)."""
    rcfg, rparams, tcfg, tparams = _cfgs(dtype, policy, q_chunk)
    src, tgt, new = _inputs()
    out = {"encode": (TED.encode(tparams, tcfg, torch.from_numpy(src)),
                      RED.encode(rparams, rcfg, jnp.asarray(src),
                                 remat=False))}
    tl, tc = TED.encdec_prefill(tparams, tcfg, torch.from_numpy(src),
                                torch.from_numpy(tgt), MAX_LEN)
    rl, rc = RED.encdec_prefill(rparams, rcfg, jnp.asarray(src),
                                jnp.asarray(tgt), MAX_LEN)
    out["prefill"] = (tl, [t.clone() for t in tc["layers"]], int(tc["index"]),
                      rl, rc["layers"], int(rc["index"]))
    step = jax.jit(RED.encdec_decode_step, static_argnums=1)
    out["steps"] = []
    for j in range(STEPS):
        idx = int(tc["index"])
        tl, tc = TED.encdec_decode_step(tparams, tcfg,
                                        torch.from_numpy(new[j]), tc)
        rl, rc = step(rparams, rcfg, jnp.asarray(new[j]), rc)
        out["steps"].append((
            idx, tl, [t[:, :, idx].clone() for t in tc["layers"][:2]],
            int(tc["index"]), rl, [t[:, :, idx] for t in rc["layers"][:2]],
            int(rc["index"])))
    return out


@pytest.mark.parametrize("dtype,policy,q_chunk", CASES, ids=IDS)
def test_encode_matches_reference(dtype, policy, q_chunk):
    got, want = _run(dtype, policy, q_chunk)["encode"]
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, "enc_out")


@pytest.mark.parametrize("dtype,policy,q_chunk", CASES, ids=IDS)
def test_prefill_matches_reference(dtype, policy, q_chunk):
    """Last-token logits (fp32), the four stacked caches (self k/v padded
    to MAX_LEN, cross k/v over the frames) and the index."""
    tl, tcache, tidx, rl, rcache, ridx = _run(dtype, policy,
                                              q_chunk)["prefill"]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == rl.shape
    _close(tl, rl, dtype, "logits")
    assert tidx == ridx == S
    for name, t, r in zip(("k", "v", "ck", "cv"), tcache, rcache):
        _close(t, r, dtype, name)
    # the self caches' pad positions are zero in both
    assert not tcache[0][:, :, S:].any() and not tcache[1][:, :, S:].any()


@pytest.mark.parametrize("dtype,policy,q_chunk", CASES, ids=IDS)
def test_decode_steps_match_reference(dtype, policy, q_chunk):
    """Four steps after the prefill: each step's logits, the self-cache
    rows it wrote at its index, and the index it hands on."""
    for idx, tl, trows, tnext, rl, rrows, rnext in _run(
            dtype, policy, q_chunk)["steps"]:
        _close(tl, rl, dtype, f"logits at {idx}")
        for name, t, r in zip(("k", "v"), trows, rrows):
            _close(t, r, dtype, f"{name} row at {idx}")
        assert tnext == rnext == idx + 1


@pytest.mark.parametrize("dtype,policy,q_chunk", CASES, ids=IDS)
def test_decode_matches_teacher_forced_forward(dtype, policy, q_chunk):
    """The port's prefill + decode steps against its own full forward over
    the extended target (``decode_stack`` then ``_logits``): step j's
    logits are the forward's at position S + j."""
    _, _, tcfg, tparams = _cfgs(dtype, policy, q_chunk)
    src, tgt, new = _inputs()
    full = torch.from_numpy(np.concatenate([tgt] + [n for n in new], 1))
    src_t = torch.from_numpy(src)
    logits, cache = TED.encdec_prefill(tparams, tcfg, src_t,
                                       full[:, :S], MAX_LEN)
    enc_out = TED.encode(tparams, tcfg, src_t)
    x, _ = TED.decode_stack(tparams, tcfg, full, enc_out)
    want = TED._logits(tparams, tcfg, x)
    _close(logits, want[:, S - 1], dtype, "prefill")
    for j in range(STEPS - 1):
        logits, cache = TED.encdec_decode_step(tparams, tcfg,
                                               full[:, S + j:S + j + 1],
                                               cache)
        _close(logits, want[:, S + j], dtype, f"step {j}")


def test_small_leaves_packed_match_reference():
    """Every rank-2 leaf packed (the stacked norm scales too, as
    ``nanomind-serve`` packs them at full width): the port dequantizes the
    small leaves at use and passes the projections packed; fp32 prefill
    and two decode steps against the reference on the same packed tree."""
    rcfg, _, tcfg, tparams = shared_params(ARCH, "float32")
    policy = QuantPolicy("all-rank2", PROFILES["nanomind-serve"].rules,
                         min_size=1)
    tparams = quantize_tree(tparams, policy)
    assert isinstance(tparams["enc_layers"]["norm1"]["scale"], QTensor)
    assert isinstance(tparams["dec_layers"]["norm_x"]["bias"], QTensor)
    rparams = from_numpy_to_ref(bridge.to_numpy(tparams))
    src, tgt, new = _inputs(1)
    tl, tc = TED.encdec_prefill(tparams, tcfg, torch.from_numpy(src),
                                torch.from_numpy(tgt), MAX_LEN)
    rl, rc = RED.encdec_prefill(rparams, rcfg, jnp.asarray(src),
                                jnp.asarray(tgt), MAX_LEN)
    _close(tl, rl, "float32", "prefill")
    for j in range(2):
        tl, tc = TED.encdec_decode_step(tparams, tcfg,
                                        torch.from_numpy(new[j]), tc)
        rl, rc = RED.encdec_decode_step(rparams, rcfg, jnp.asarray(new[j]),
                                        rc)
        _close(tl, rl, "float32", f"step {j}")


@pytest.mark.parametrize("q_chunk", [0, 512])
def test_cross_attention_kv_override_matches_reference(q_chunk):
    """``attn_train(kv_override=(k, v))``: q projected and roped, k and v
    taken as given (Sq 16 against Sk 64), fp32."""
    rcfg, rparams, tcfg, tparams = _cfgs("float32", None, q_chunk)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((B, S, 128)).astype(np.float32)
    k = rng.standard_normal((B, T, 4, 32)).astype(np.float32)
    v = rng.standard_normal((B, T, 4, 32)).astype(np.float32)
    rp = jax.tree_util.tree_map(lambda a: a[0],
                                rparams["dec_layers"]["cross_attn"])
    tp = {n: w[0] for n, w in tparams["dec_layers"]["cross_attn"].items()}
    want, (wk, _) = RA.attn_train(
        rp, rcfg, jnp.asarray(h),
        lambda t: r_rope(t, r_positions(B, S), rcfg.rope_theta),
        causal=False, kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, (gk, _) = TA.attn_train(
        tp, tcfg, torch.from_numpy(h),
        lambda t: t_rope(t, t_positions(B, S, "cpu"), tcfg.rope_theta),
        causal=False, kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    _close(got, want, "float32", "out")
    assert np.array_equal(f32(gk), k) and np.array_equal(f32(wk), k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_packs_as_it_makes_bit_equal(dtype):
    """``init_params(policy=nanomind-serve)`` (each layer stack packed as
    it is made) equals the port's ``quantize_tree`` of the dense init and
    the reference's ``quantize_tree`` of the same dense weights, codes and
    scales bit for bit."""
    cfg = get_config(ARCH).reduced(dtype=dtype)
    policy = PROFILES["nanomind-serve"]
    dense = TM.init_params(cfg, device="cpu", seed=0)
    got = flat(bridge.to_numpy(TM.init_params(cfg, device="cpu", seed=0,
                                              policy=policy)))
    port = flat(bridge.to_numpy(quantize_tree(dense, policy)))
    ref = flat(jax_to_numpy(RQ.quantize_tree(
        from_numpy_to_ref(bridge.to_numpy(dense)),
        RQ.PROFILES["nanomind-serve"])))
    assert got.keys() == port.keys() == ref.keys()
    for path in got:
        for want in (port, ref):
            a, b = got[path], want[path]
            if isinstance(a, np.ndarray):
                assert np.array_equal(bits(a), bits(np.asarray(b))), path
            else:
                assert a == b, path
    assert ("dec_layers", "ffn", "w_up", "codes") in got
    assert ("enc_layers", "attn", "wq", "codes") in got


def test_init_has_reference_tree_and_scales():
    """The port's own init: the reference's tree, shapes and dtypes, and
    init scales within sampling noise (the numbers differ by design)."""
    rcfg = ref_config(ARCH).reduced()
    ref = flat(jax_to_numpy(jax.jit(RED.init_encdec, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)))
    port = flat(TM.init_params(get_config(ARCH).reduced(), device="cpu",
                               seed=3))
    assert sorted(ref) == sorted(port)
    for path, leaf in ref.items():
        t = port[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
        want = float(np.std(np.asarray(leaf, np.float32)))
        got = float(t.float().std()) if t.numel() > 1 else 0.0
        assert abs(got - want) <= 0.1 * want + 1e-6, (path, got, want)


@pytest.mark.parametrize("arch", [ARCH, "stablelm-1.6b"])
def test_init_cache_matches_reference(arch):
    """``launch.steps.init_cache``: the reference's shapes, dtypes and
    start index, zero state."""
    rcfg = ref_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    want = flat(jax_to_numpy(RS.init_cache(rcfg, 3, 16)))
    got = flat(TS.init_cache(tcfg, 3, 16, device="cpu"))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        if path[-1] != "index":
            assert not g.any(), path
    assert int(got[("index",)]) == int(want[("index",)]) == 15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_steps_match_reference(dtype):
    """``build_prefill_step`` / ``build_serve_step`` of both packages on
    the same batch (packed weights): prefill logits and three serve
    steps, teacher-forced."""
    rcfg, rparams, tcfg, tparams = _cfgs(dtype, "nanomind-serve", 512)
    src, tgt, new = _inputs(3)
    tl, tc = TS.build_prefill_step(tcfg, MAX_LEN)(
        tparams, {"src_embeds": torch.from_numpy(src),
                  "tgt_tokens": torch.from_numpy(tgt)})
    rl, rc = RS.build_prefill_step(rcfg, MAX_LEN)(
        rparams, {"src_embeds": jnp.asarray(src),
                  "tgt_tokens": jnp.asarray(tgt)})
    _close(tl, rl, dtype, "prefill")
    tserve, rserve = TS.build_serve_step(tcfg), RS.build_serve_step(rcfg)
    for j in range(3):
        tl, tc = tserve(tparams, torch.from_numpy(new[j]), tc)
        rl, rc = rserve(rparams, jnp.asarray(new[j]), rc)
        _close(tl, rl, dtype, f"step {j}")
    assert int(tc["index"]) == int(rc["index"]) == S + 3


def test_lm_steps_are_the_models_functions():
    """For a decoder-only arch the builders run ``lm_prefill`` and
    ``lm_decode_step``: the same logits bit for bit."""
    tcfg = get_config("stablelm-1.6b").reduced(dtype="float32")
    params = TM.init_params(tcfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.arange(3, 15, dtype=np.int32)[None])
    got, gc = TS.build_prefill_step(tcfg, 32)(params, {"tokens": tokens})
    want, wc = TM.lm_prefill(params, tcfg, tokens, 32)
    assert torch.equal(got, want)
    nxt = torch.tensor([[7]], dtype=torch.int32)
    got, _ = TS.build_serve_step(tcfg)(params, nxt, gc)
    want, _ = TM.lm_decode_step(params, tcfg, nxt, wc)
    assert torch.equal(got, want)


def test_prefill_hands_projections_packed_and_decode_to_the_gemvs(
        monkeypatch):
    """``nanomind-serve``: prefill passes every projection to the
    packed-weight GEMM packed (6 an encoder layer; 10 a decoder layer:
    self q/k/v/o, cross k/v once, cross q/o, up, down); a decode step
    runs each layer's self q/k/v and FFN through the GEMVs on the packed
    weights (ungated GELU) and hands ``quant_einsum`` only the two output
    projections, dequantized."""
    _, _, cfg, params = shared_params(ARCH, "bfloat16", "nanomind-serve")
    calls, gemvs = [], []
    inner = dg_ops.quant_einsum
    qkv, mlp = fd_ops.fused_qkv, fd_ops.fused_mlp

    def recording(spec, x, w):
        if not inside:        # not the GEMVs' plain versions' own calls
            calls.append((spec, isinstance(w, QTensor)))
        return inner(spec, x, w)

    def rec_qkv(h, *ws):
        gemvs.append(("qkv", all(isinstance(w, QTensor) for w in ws)))
        inside.append(1)
        try:
            return qkv(h, *ws)
        finally:
            inside.pop()

    def rec_mlp(h, up, down, gate=None, *, act):
        gemvs.append((f"mlp/{act}/{gate is None}",
                      isinstance(up, QTensor) and isinstance(down, QTensor)))
        inside.append(1)
        try:
            return mlp(h, up, down, gate, act=act)
        finally:
            inside.pop()
    inside = []
    monkeypatch.setattr(dg_ops, "quant_einsum", recording)
    monkeypatch.setattr(fd_ops, "fused_qkv", rec_qkv)
    monkeypatch.setattr(fd_ops, "fused_mlp", rec_mlp)
    src, tgt, new = _inputs()
    with torch.no_grad():
        _, cache = TED.encdec_prefill(params, cfg, torch.from_numpy(src),
                                      torch.from_numpy(tgt), MAX_LEN)
        assert len(calls) == 6 * cfg.n_enc_layers + 10 * cfg.n_layers
        assert all(packed for _, packed in calls)
        assert not gemvs
        calls.clear()
        TED.encdec_decode_step(params, cfg, torch.from_numpy(new[0]), cache)
    assert calls == [("bshk,hkd->bsd", False)] * (2 * cfg.n_layers)
    assert gemvs == [("qkv", True), ("mlp/gelu/True", True)] * cfg.n_layers

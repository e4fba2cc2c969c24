"""Activation-aware pruning of the port (``core/quantize.prune_weights``,
``quantize_tree(act_scales=)`` and the ``nanomind-sparse`` profile) held
against the reference's.

The masks are bit-equal: the same fp32 score ``|W| * |act|``, each
last-axis row's threshold by the reference's own arithmetic (the fp32
linear quantile, ``low * (1 - frac) + high * frac``), so rows full of
exact ties (bf16 and fp16 weights on an integer grid) flip where the
reference's flip.  The pruned and packed trees are bit-equal too, and
the pruned model serves: its free-running decode replays its own prefill
argmax, its logits stay within the reference test's drift bound of the
unpruned model's, and they agree with the reference's on the same packed
weights within ``tests/test_torch_model.py``'s tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bits, f32, flat, jax_to_numpy, shared_params, \
    to_port
from repro.configs import get_config as ref_config
from repro.core import quantize as RQ
from repro.launch.steps import init_params as ref_init
from repro.models import model as RM
from repro_torch import bridge
from repro_torch.core import quantize as TQ
from repro_torch.models import model as TM

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SPARSITY = (0.25, 0.5, 0.75)


def _tied_weights(shape, dtype, seed):
    """Weights on a coarse integer grid (every row full of exact ties in
    |W|), plus a little noise in fp32 so its rows also have distinct
    values."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-6, 7, size=shape).astype(np.float32) * 0.0625
    if dtype == "float32":
        w = w + (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    return jnp.asarray(w).astype(dtype)


def _to_torch(jw):
    return torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        getattr(torch, str(jw.dtype)))


@pytest.mark.parametrize("act", ["none", "last_axis", "full"])
@pytest.mark.parametrize("sparsity", SPARSITY)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_prune_masks_bit_equal_reference(dtype, sparsity, act):
    for seed, shape in enumerate(((2, 64, 96), (96, 96), (5, 7, 33))):
        jw = _tied_weights(shape, dtype, seed)
        rng = np.random.default_rng(100 + seed)
        scale = {"none": None,
                 "last_axis": np.abs(rng.standard_normal(shape[-1])),
                 "full": rng.integers(1, 4, size=shape) * 0.5}[act]
        if scale is not None:
            scale = scale.astype(np.float32)
        want = RQ.prune_weights(jw, sparsity, None if scale is None
                                else jnp.asarray(scale))
        got = TQ.prune_weights(_to_torch(jw), sparsity, scale)
        assert got.dtype == getattr(torch, dtype)
        assert np.array_equal(bits(np.asarray(want.astype(jnp.float32))),
                              bits(f32(got))), (shape, seed)
        # every row keeps at most its (1 - sparsity) share of survivors
        n = shape[-1]
        zeros = (f32(got) == 0).reshape(-1, n).sum(-1)
        assert (zeros >= int(np.floor(sparsity * n))).all()


def test_prune_keeps_the_reference_axis_and_edges():
    w = torch.arange(1, 13, dtype=torch.float32).reshape(3, 4)
    assert TQ.prune_weights(w, 0.0) is w
    with pytest.raises(ValueError):
        TQ.prune_weights(w, 1.0)
    # each last-axis row thresholded alone: the lowest half of every row
    got = TQ.prune_weights(w, 0.5)
    assert torch.equal(got != 0, torch.tensor([[0, 0, 1, 1]] * 3).bool())
    # an act_scale sized to the last axis reorders each row's scores
    act = np.array([8.0, 4.0, 1.0, 1.0], np.float32)
    got = TQ.prune_weights(w, 0.5, act)
    want = RQ.prune_weights(jnp.asarray(w.numpy()), 0.5, jnp.asarray(act))
    assert np.array_equal(f32(got), np.asarray(want))


def test_prune_sorts_rows_in_chunks(monkeypatch):
    """A chunked sort (rows beyond the sort budget) gives the same
    thresholds as one sort of every row."""
    jw = _tied_weights((3, 40, 64), "bfloat16", 7)
    whole = TQ.prune_weights(_to_torch(jw), 0.5)
    monkeypatch.setattr(TQ, "_PRUNE_SORT_CHUNK", 64 * 7)
    chunked = TQ.prune_weights(_to_torch(jw), 0.5)
    assert torch.equal(whole.view(torch.int16), chunked.view(torch.int16))
    want = RQ.prune_weights(jw, 0.5)
    assert np.array_equal(bits(np.asarray(want.astype(jnp.float32))),
                          bits(f32(chunked)))


@functools.lru_cache(maxsize=None)
def _ref_llava():
    cfg = ref_config("llava-onevision-0.5b").reduced()
    return cfg, jax.jit(ref_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                    cfg)


def _act_scales(cfg):
    rng = np.random.default_rng(3)
    mk = lambda n: np.abs(rng.standard_normal(n)).astype(np.float32) + 0.1
    # the first matching substring applies: "ffn/w_up" never does
    return {"ffn/w_down": mk(cfg.d_model), "ffn": mk(cfg.d_ff),
            "ffn/w_up": mk(cfg.d_ff), "mixer/wo": mk(cfg.d_model)}


@pytest.mark.parametrize("with_act", [False, True])
def test_sparse_profile_codes_and_scales_bit_equal_reference(with_act):
    cfg, params = _ref_llava()
    acts = _act_scales(cfg) if with_act else None
    want = jax_to_numpy(RQ.quantize_tree(
        params, RQ.PROFILES["nanomind-sparse"],
        act_scales=None if acts is None else
        {k: jnp.asarray(v) for k, v in acts.items()}))
    got = bridge.to_numpy(TQ.quantize_tree(
        to_port(params), TQ.PROFILES["nanomind-sparse"], act_scales=acts))
    fa, fb = flat(want), flat(got)
    assert sorted(fa) == sorted(fb)
    n_codes = 0
    for path, x in fa.items():
        y = fb[path]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(bits(np.asarray(x)), bits(np.asarray(y))), \
                path
            n_codes += path[-1] == "codes"
        else:
            assert x == y, path
    assert n_codes >= 7          # every decoder projection packed
    assert TQ.PROFILES["nanomind-sparse"].rules == \
        RQ.PROFILES["nanomind-sparse"].rules


def test_sparse_profile_prunes_half_of_every_decoder_row(monkeypatch):
    """Half of every pruned row is zero before quantization; only the
    seven stacked decoder projections are pruned (the vision side and the
    embedding stay whole)."""
    cfg, params = _ref_llava()
    real, seen = TQ.prune_weights, []

    def prune(w, sparsity, act=None):
        out = real(w, sparsity, act)
        seen.append((w.shape, sparsity, out))
        return out
    monkeypatch.setattr(TQ, "prune_weights", prune)
    TQ.quantize_tree(to_port(params), TQ.PROFILES["nanomind-sparse"])
    assert len(seen) == 7 and all(s == 0.5 for _, s, _ in seen)
    for shape, _, out in seen:
        n = shape[-1]
        zeros = (out == 0).reshape(-1, n).sum(-1)
        assert int(zeros.min()) >= n // 2


def _stablelm(dtype):
    return shared_params("stablelm-1.6b", dtype, None), \
        shared_params("stablelm-1.6b", dtype, "nanomind-sparse")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pruned_q4_decode_self_consistent_and_bounded(dtype):
    """The port's counterpart of the reference's test of the same name:
    the pruned model's free-running decode replays its own prefill argmax
    exactly, and its logits stay within the reference's drift bound of
    the unpruned model's (loose: half of a random model is a large
    perturbation)."""
    (_, _, tcfg, dense), (_, _, _, sparse) = _stablelm(dtype)
    tokens = (torch.arange(24)[None] % 60 + 3).to(torch.int32)
    steps = 6
    with torch.no_grad():
        lg, cache = TM.lm_prefill(sparse, tcfg, tokens, 40)
        seq = [int(lg[0].argmax())]
        for _ in range(steps - 1):
            lg, cache = TM.lm_decode_step(
                sparse, tcfg, torch.tensor([[seq[-1]]], dtype=torch.int32),
                cache)
            seq.append(int(lg[0].argmax()))
        assert torch.isfinite(lg).all()
        full = torch.cat([tokens, torch.tensor([seq[:-1]],
                                               dtype=torch.int32)], 1)
        S = tokens.shape[1]
        replay, rel = [], 0.0
        for i in range(steps):
            q, _ = TM.lm_prefill(sparse, tcfg, full[:, :S + i], 40)
            d, _ = TM.lm_prefill(dense, tcfg, full[:, :S + i], 40)
            replay.append(int(q[0].argmax()))
            rel = max(rel, float((q - d).abs().max() / d.abs().max()))
    assert replay == seq
    assert rel < 1.2, rel


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "llava-onevision-0.5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pruned_logits_match_reference(arch, dtype):
    """Teacher-forced prefill logits and one decode step of the port and
    the reference on the same pruned, packed weights."""
    rcfg, rparams, tcfg, tparams = shared_params(arch, dtype,
                                                 "nanomind-sparse")
    rng = np.random.default_rng(2)
    toks = rng.integers(3, rcfg.vocab_size, (2, 16)).astype(np.int32)
    feats = None
    if rcfg.vlm:
        feats = (rng.standard_normal((2, rcfg.vision_tokens,
                                      rcfg.vision_feat_dim)) * 0.02
                 ).astype(np.float32)
    rl, rcache = jax.jit(RM.lm_prefill, static_argnums=(1, 3))(
        rparams, rcfg, jnp.asarray(toks), 32,
        vision_feats=None if feats is None else jnp.asarray(feats))
    with torch.no_grad():
        tl, tcache = TM.lm_prefill(
            tparams, tcfg, torch.from_numpy(toks), 32,
            vision_feats=None if feats is None else torch.from_numpy(feats))
    rel = lambda w, g: float(np.abs(f32(w) - f32(g)).max()
                             / np.abs(f32(w)).max())
    assert rel(rl, tl) <= TOL[dtype]
    nxt = np.array([[5], [7]], np.int32)
    rl2, _ = jax.jit(RM.lm_decode_step, static_argnums=(1,))(
        rparams, rcfg, jnp.asarray(nxt), rcache)
    with torch.no_grad():
        tl2, _ = TM.lm_decode_step(tparams, tcfg, torch.from_numpy(nxt),
                                   tcache)
    assert rel(rl2, tl2) <= TOL[dtype]

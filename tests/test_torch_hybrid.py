"""Jamba's hybrid groups (``jamba-1.5-large-398b``) in the port against
the reference, on the CPU, at the reference's ``reduced()``: 2 groups of 8
sublayers (attention at position 4, Mamba-2 elsewhere, the mixture of
experts on odd positions), d 128, 4 experts top-2, SSM head_dim 16,
state 16, chunk 32.  Both packages get the port's ``init_params`` (seed
0) through the bridge; inputs are numpy draws from seeds.

* The tree: the reference's paths and shapes, 8 subs stacked over the
  2 groups, packed leaves included.
* ``lm_prefill`` and teacher-forced ``lm_decode_step`` logits against
  the reference's at B 1: fp32 within 1e-4 of the largest logit; bf16
  within 0.25 of it (random weights through 14 Mamba-2 and 8 MoE
  sublayers round the two frameworks' bf16 logits 6-17 % of the largest
  apart); decode with ``valid`` (the routed experts' GEMV) and without
  (the one-hot route).
* The engine against the reference's unpadded model: prompts of 20, 32
  and 64 tokens prefilled together in the 128 bucket, the prefill and
  three decode steps' logits teacher-forced within 1e-4 of the largest
  (fp32, capacity factor 8.0 so that the reference's groups of S tokens
  and the port's masked groups of 256 both keep every choice).
* Each Mamba-2 position's (conv tail, SSD state), taken at ``valid_len``
  of a padded prompt, equals the unpadded prompt's, and the reference's.
* The routed experts' plain version (``ref_fused_mlp_experts``) against
  ``apply_moe``'s one-hot route on the same routed rows, fp32 within
  1e-5 and bf16 within 2e-2 of the largest output (``test_torch_moe``'s
  bounds), dense and q4 g32 experts, sentinel rows writing nothing and
  a row that chooses one expert twice summing it twice.
* Decode never dequantizes a stacked expert leaf: every ``dequantize``
  call of an engine decode step is watched.
* ``init_params(policy=nanomind-serve)`` equals ``quantize_tree`` of the
  dense init bit for bit.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32, flat, shared_params
from repro.models import model as RM
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import quantize as TQ
from repro_torch.core.quantize import (PROFILES, QTensor, QuantSpec,
                                       quantize, quantize_tree)
from repro_torch.kernels.fused_decode import ops as fd_ops
from repro_torch.models import decoder as TD
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "jamba-1.5-large-398b"
TOL = {"float32": 1e-4, "bfloat16": 0.25}        # of the largest logit
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}    # of the largest output
ref_prefill = jax.jit(RM.lm_prefill, static_argnums=(1, 3))
ref_decode_step = jax.jit(RM.lm_decode_step, static_argnums=(1,))


def _close(want, got, tol):
    want, got = f32(want), f32(got)
    assert want.shape == got.shape
    err = float(np.abs(want - got).max())
    assert err <= tol * float(np.abs(want).max()), err


def _wide(cfg, factor=8.0):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


def test_tree_matches_the_reference():
    """8 subs, each leaf stacked over the 2 groups, the reference's paths
    and shapes; packed leaves cross the bridge to the reference."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, "float32",
                                                 "nanomind-serve")
    assert TD.n_groups(tcfg) == 2 and len(tparams["layers"]) == 8
    want = jax.eval_shape(lambda k: RM.init_lm(k, rcfg),
                          jax.random.PRNGKey(0))
    wf = {k: tuple(v.shape) for k, v in flat(want).items()}
    tf = {k: tuple(v.shape) for k, v in flat(TM.init_params(
        tcfg, device="cpu", seed=0)).items()}
    assert wf == tf
    for pos in range(8):
        mixer, ffn = TD.sublayer_spec(tcfg, pos)
        assert mixer == ("attn" if pos == 4 else "mamba")
        assert ffn == ("moe" if pos % 2 else "mlp")
        assert "router" in tparams["layers"][pos]["ffn"] or pos % 2 == 0
    up = tparams["layers"][1]["ffn"]["w_up"]
    assert isinstance(up, QTensor) and up.shape[:2] == (2, 4)
    assert rparams["layers"][1]["ffn"]["w_up"].codes.shape == tuple(
        up.codes.shape)


def _model_logits(params, cfg, tokens, S, max_len, ref, valid=None):
    """The prefill logits of ``tokens[:, :S]`` and each teacher-forced
    decode step's after it, through the reference (``ref``) or the port
    (decode with ``valid``, or without: the one-hot route)."""
    if ref:
        logits, cache = ref_prefill(params, cfg, jnp.asarray(tokens[:, :S]),
                                    max_len)
    else:
        logits, cache = TM.lm_prefill(params, cfg, torch.from_numpy(
            tokens[:, :S]), max_len)
    out = [f32(logits)]
    for t in range(S, tokens.shape[1]):
        tok = tokens[:, t:t + 1]
        if ref:
            logits, cache = ref_decode_step(params, cfg, jnp.asarray(tok),
                                            cache)
        else:
            logits, cache = TM.lm_decode_step(params, cfg,
                                              torch.from_numpy(tok), cache,
                                              valid=valid)
        out.append(f32(logits))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """A 64-token prompt (two SSD chunks), then three teacher-forced
    decode steps, through both packages' models at B 1; the port's decode
    with ``valid`` (the routed experts' plain version) and without (the
    one-hot route) both held against the reference's logits in the same
    dtype.  fp32: within 1e-4 of the largest logit.  bf16: within 0.25
    of it: 14 Mamba-2 and 8 MoE sublayers of random weights round the
    two frameworks' bf16 logits 6-17 % of the largest apart (each 30-75 %
    from the fp32 model's), where the Mamba-2 and MoE tests' 5e-2 is
    held over one sublayer kind at a time."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, dtype,
                                                 "nanomind-serve")
    tokens = np.random.default_rng(0).integers(
        3, tcfg.vocab_size, (1, 67)).astype(np.int32)
    S, max_len = 64, 96
    ones = torch.ones(1, dtype=torch.bool)
    want = _model_logits(rparams, rcfg, tokens, S, max_len, ref=True)
    with torch.no_grad():
        routed = _model_logits(tparams, tcfg, tokens, S, max_len, False,
                               valid=ones)
        one_hot = _model_logits(tparams, tcfg, tokens, S, max_len, False)
    for w, g, o in zip(want, routed, one_hot):
        _close(w, g, TOL[dtype])
        _close(w, o, TOL[dtype])


def test_engine_follows_the_unpadded_reference_model():
    """Prompts of 20, 32 and 64 tokens right-padded together into the
    128 bucket: the engine takes every Mamba-2 position's state at each
    row's true end and masks the pads out of every MoE position, so its
    prefill logits and three decode steps follow the reference model on
    the unpadded prompts, teacher-forced with the engine's tokens."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, "float32",
                                                 "nanomind-serve")
    rcfg, tcfg = _wide(rcfg), _wide(tcfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
               for n in (20, 32, 64)]
    pre, steps = {}, []
    with ServingEngine(tcfg, tparams, n_slots=4, max_len=256,
                       block_size=32, device="cpu") as eng:
        assert eng.slots.paged == tuple(p == 4 for p in range(8))
        assert not eng.use_fused
        prefill, decode = eng._prefill, eng._decode

        def recording_prefill(tokens, vision, last_idx):
            assert tuple(tokens.shape) == (3, 128)
            logits, cache = prefill(tokens, vision, last_idx)
            pre.update(logits=logits.clone(), lens=last_idx.tolist())
            return logits, cache

        def recording_decode(tokens, lengths, slot_ids, tables):
            logits, pool = decode(tokens, lengths, slot_ids, tables)
            steps.append((slot_ids.tolist(), logits.clone()))
            return logits, pool
        eng._prefill, eng._decode = recording_prefill, recording_decode
        reqs = [Request(rid=i, tokens=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert all(r.error is None for r in done)
        eng.slots.check_block_invariants()
    assert pre["lens"] == [20, 32, 64] and len(steps) == 3
    for b, req in enumerate(reqs):
        rl, cache = ref_prefill(rparams, rcfg, jnp.asarray(prompts[b][None]),
                                256)
        got, want = [pre["logits"][b]], [rl[0]]
        for t, (slot_ids, logits) in enumerate(steps):
            got.append(logits[slot_ids.index(req.slot)])
            rl, cache = ref_decode_step(rparams, rcfg, jnp.asarray(
                [[req.out_tokens[t]]], jnp.int32), cache)
            want.append(rl[0])
        for w, g in zip(want, got):
            _close(w, g, 1e-4)


def test_mamba_state_is_taken_at_valid_len():
    """A 64-token prompt padded to 96: each of the 14 Mamba-2 sublayers'
    (conv tail, SSD state) equals the unpadded prompt's (fp32, 1e-5 of
    the largest) and the reference's on the unpadded prompt."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, "float32",
                                                 "nanomind-serve")
    rcfg, tcfg = _wide(rcfg), _wide(tcfg)
    rng = np.random.default_rng(2)
    n, width = 64, 96
    tok = rng.integers(3, tcfg.vocab_size, (1, n)).astype(np.int32)
    padded = np.zeros((1, width), np.int32)
    padded[:, :n] = tok
    _, rcache = ref_prefill(rparams, rcfg, jnp.asarray(tok), 128)
    with torch.no_grad():
        _, want = TM.lm_prefill(tparams, tcfg, torch.from_numpy(tok), 128)
        _, got = TM.lm_prefill(tparams, tcfg, torch.from_numpy(padded), 128,
                               valid_len=torch.tensor([n]))
    mamba = [p for p in range(8) if TD.mixer_of(tcfg, p) == "mamba"]
    assert len(mamba) == 7
    for pos in mamba:
        for i in range(2):
            w = want["layers"][pos][i]
            g = got["layers"][pos][i]
            assert tuple(w.shape[:2]) == (2, 1)
            _close(w, g, 1e-5)
            _close(rcache["layers"][pos][i], g, 1e-4)


def _expert_ffn(dtype, packed, seed=0):
    cfg = get_config(ARCH).reduced(dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        p = TMOE.init_moe(gen, cfg, cfg.d_model, "cpu")
    if packed:
        for name in ("w_up", "w_gate", "w_down"):
            p[name] = quantize(p[name], QuantSpec(4, group_size=32))
    return cfg, p


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "q4g32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_plain_version_matches_apply_moe(dtype, packed):
    """Six decode rows, two of them sentinels: the decode route
    (``apply_moe`` on (6, 1, D) with ``valid``: the routed experts' plain
    version) against the one-hot route on the same rows as one masked
    (1, 6, D) call, whose capacity keeps every choice; the sentinel rows
    get 0."""
    cfg, p = _expert_ffn(dtype, packed)
    dt = cfg.torch_dtype
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 1, cfg.d_model)).astype(
        np.float32)).to(dt)
    valid = torch.tensor([True, True, False, True, False, True])
    with torch.no_grad():
        got, _ = TMOE.apply_moe(p, cfg, x, valid[:, None])
        want, _ = TMOE.apply_moe(p, cfg, x.reshape(1, 6, -1), valid[None])
    want = want.reshape(6, 1, -1)
    _close(want[valid], got[valid], MOE_TOL[dtype])
    assert torch.count_nonzero(got[~valid]) == 0
    assert torch.count_nonzero(want[~valid]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_plain_version_sums_each_choice(dtype):
    """A row that chooses one expert twice gets that expert's output at
    both gates; each row's sum is its choices' ``ref_fused_mlp`` in
    order; sentinel rows get 0."""
    cfg, p = _expert_ffn(dtype, True, seed=1)
    dt = cfg.torch_dtype
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.standard_normal((3, cfg.d_model)).astype(
        np.float32)).to(dt)
    idx = torch.tensor([[2, 2], [0, 3], [1, 1]])
    gates = torch.tensor([[0.75, 0.25], [0.5, 0.5], [0.6, 0.4]])
    valid = torch.tensor([True, True, False])
    from repro_torch.kernels.fused_decode.ref import ref_fused_mlp
    with torch.no_grad():
        got = fd_ops.fused_mlp_experts(h, p["w_up"], p["w_down"],
                                       p["w_gate"], idx, gates, valid,
                                       act=cfg.act)
        for r in range(2):
            acc = torch.zeros(cfg.d_model)
            for j in range(2):
                e = int(idx[r, j])
                y = ref_fused_mlp(h[r:r + 1, None], p["w_up"].layer(e),
                                  p["w_down"].layer(e), p["w_gate"].layer(e),
                                  act=cfg.act)
                acc = acc + gates[r, j].to(dt).float() * y[0, 0].float()
            assert torch.equal(got[r], acc.to(dt))
    assert torch.count_nonzero(got[2]) == 0


def test_decode_never_dequantizes_a_stacked_expert_leaf():
    """Every ``dequantize`` call of the engine's decode steps on packed
    reduced Jamba: none receives a stacked expert leaf ((groups, E, ...)
    or one layer's (E, ...)), and the routed experts' plain version
    dequantizes one expert's matrices at a time."""
    _, _, tcfg, tparams = shared_params(ARCH, "float32", "nanomind-serve")
    E = tcfg.moe.n_experts
    seen = []
    orig = TQ.dequantize

    def watching(qt):
        seen.append(tuple(qt.shape))
        return orig(qt)
    mods = [m for m in list(sys.modules.values())
            if getattr(m, "__name__", "").startswith("repro_torch")
            and getattr(m, "dequantize", None) is orig]
    eng = ServingEngine(tcfg, tparams, n_slots=2, max_len=160,
                        block_size=32, device="cpu")
    decode = eng._decode

    def watched_decode(*args):
        for m in mods:
            m.dequantize = watching
        try:
            return decode(*args)
        finally:
            for m in mods:
                m.dequantize = orig
    eng._decode = watched_decode
    rng = np.random.default_rng(6)
    with eng:
        for i in range(2):
            eng.submit(Request(rid=i, tokens=rng.integers(
                3, 500, 10 + 7 * i).astype(np.int32), max_new_tokens=3))
        done = eng.run()
    assert all(r.error is None for r in done)
    assert seen
    D, Fe = tcfg.d_model, tcfg.moe.d_ff_expert
    assert not [s for s in seen if len(s) >= 3 and E in s[:2]
                and s[-2:] in ((D, Fe), (Fe, D))]
    # the routed experts' plain version: (D, F) and (F, D) slices, three
    # a (row, choice), two rows x top-2 x 8 MoE sublayers a step
    expert = [s for s in seen if s in ((D, Fe), (Fe, D))]
    assert expert and len(expert) % (3 * 2 * 8) == 0


def test_init_params_packs_as_it_makes_bit_equal():
    """``init_params(policy=nanomind-serve)`` (each group position packed
    as it is made, each stacked expert leaf one expert at a time) equals
    ``quantize_tree`` of the dense init bit for bit."""
    cfg = get_config(ARCH).reduced()
    policy = PROFILES["nanomind-serve"]
    want = quantize_tree(TM.init_params(cfg, device="cpu", seed=0), policy)
    got = TM.init_params(cfg, device="cpu", seed=0, policy=policy)
    fw, fg = (flat(bridge.to_numpy(t)) for t in (want, got))
    assert fw.keys() == fg.keys()
    for k in fw:
        assert np.array_equal(np.asarray(fw[k]), np.asarray(fg[k])), k
    w = got["layers"][3]["ffn"]["w_down"]
    assert isinstance(w, QTensor)
    assert tuple(w.codes.shape) == (2, 4, 64, 128 // 8)

"""The port's ServingEngine against the reference's, on the CPU.

A README-style mix on fp32 reduced llava under ``nanomind-serve``: mixed
slot classes (thumbnail, full resolution, 4-image), more requests than
KV slots (mid-flight admit and retire), and one request whose vision
bytes repeat another's (shared staging).  A smaller mix on fp32 reduced
qwen2-vl with ``attn_q_chunk=0`` (single-region prefill attention,
M-RoPE).  Both engines get the same weights (through the bridge) and the
same requests.

Greedy tokens are compared step by step until the first step whose
reference top-1 margin is below 1e-4: random-init logits are nearly
uniform, so beyond a near-tie a benign rounding difference may
legitimately pick the other token and fork the rest of the trajectory.
At least 3/4 of all tokens must be compared.

Reduced Mamba-2 (fp32, nanomind-serve) and reduced llava with the
paper's streaming linear attention are held against the reference's
MODEL, not its engine: the reference engine right-pads prompts into SSM
and linear-attention state (ROADMAP §3; a test here shows it for the
linear-attention state).  Each request's prefill logits and its first
three decode steps' logits must match the reference's ``lm_prefill`` on
the unpadded prompt plus teacher-forced ``lm_decode_step`` within 1e-4
of the largest logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import f32, shared_params
from repro.models import model as RM
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine
from repro_torch.core.backends import DeviceBackend
from repro_torch.core.bricks import decompose
from repro_torch.core.plan import compile_plan
from repro_torch.core.tabm import SlotClassPool
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "llava-onevision-0.5b"
MARGIN = 1e-4


# (vision tokens, images, max_new, prompt length) per request
LLAVA_MIX = [(8, 1, 6, 7), (2, 1, 3, 6), (32, 4, 5, 9), (2, 1, 4, 8),
             (8, 1, 3, 6), (8, 1, 4, 7)]
# both resolution buckets (8 and 2 tokens per image) and a 4-image request
QWEN_MIX = [(8, 1, 5, 10), (2, 1, 4, 6), (8, 4, 5, 9)]


def _mix(request_cls, cfg, spec=LLAVA_MIX, share_last=True):
    """Requests of ``spec``; with ``share_last`` the last request repeats
    request 0's vision bytes."""
    rng = np.random.default_rng(0)
    reqs = []
    for rid, (nt, ni, new, plen) in enumerate(spec):
        feats = (rng.standard_normal((1, nt, cfg.vision_feat_dim)) * 0.02
                 ).astype(np.float32)
        if share_last and rid == len(spec) - 1:
            feats = reqs[0].vision_feats.copy()
        reqs.append(request_cls(
            rid=rid, tokens=(np.arange(plen) % 50 + 3).astype(np.int32),
            n_images=ni, max_new_tokens=new, vision_feats=feats))
    return reqs


def _run_reference(cfg, params, reqs):
    """Reference engine run, recording each picked token's top-1 margin."""
    margins = {}
    with RServingEngine(cfg, params, n_slots=2, max_len=128,
                        block_size=32) as eng:
        pick = eng._pick

        def recording_pick(logits, req):
            row = np.sort(np.asarray(logits, np.float32)[0])
            margins.setdefault(req.rid, []).append(float(row[-1] - row[-2]))
            return pick(logits, req)
        eng._pick = recording_pick
        for r in reqs:
            eng.submit(r)
        done = eng.run()
    assert all(r.error is None for r in done)
    return {r.rid: r.out_tokens for r in done}, margins


def test_engine_serves_mix_like_reference():
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, "float32",
                                                 "nanomind-serve")
    want, margins = _run_reference(rcfg, rparams, _mix(RRequest, rcfg))
    with ServingEngine(tcfg, tparams, n_slots=2, max_len=128, block_size=32,
                       device="cpu") as eng:
        assert eng.use_fused            # decodes through the fused step
        reqs = _mix(Request, tcfg)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert len(done) == len(reqs) and all(r.error is None for r in done)
        assert len({r.slot_class for r in reqs}) >= 2
        stats = eng.tabm.stats
        assert stats["writes"] == stats["reads"] and stats["shares"] == 1
        eng.slots.check_block_invariants()
        events = [(e, k) for e, k, _ in eng.trace]
        first_finish = events.index(("finish", done[0].rid))
        assert any(e == "prefill" for e, _ in events[first_finish:])
        assert max(k for e, k in events if e == "decode_cohort") > 1
        got = {r.rid: r.out_tokens for r in done}
    _check_tokens(want, margins, got)


def _check_tokens(want, margins, got):
    """Greedy tokens equal up to each request's first near-tie; at least
    3/4 of all tokens compared."""
    compared = total = 0
    for rid, toks in want.items():
        total += len(toks)
        for i, tok in enumerate(toks):
            if margins[rid][i] < MARGIN:
                break
            assert got[rid][i] == tok, (rid, i, got[rid], toks)
            compared += 1
    assert compared >= 0.75 * total, (compared, total)


def test_qwen2_vl_engine_serves_mix_like_reference():
    """Reduced qwen2-vl (fp32, nanomind-serve) with ``attn_q_chunk=0``:
    prefill through the single-region attention (the reference's
    ``dense_attention``; the port's flash wrapper, its plain version on
    the CPU), M-RoPE decode through the fused step; both resolution
    buckets and a 4-image request."""
    rcfg, rparams, tcfg, tparams = shared_params("qwen2-vl-7b", "float32",
                                                 "nanomind-serve")
    rcfg = dataclasses.replace(rcfg, attn_q_chunk=0)
    tcfg = dataclasses.replace(tcfg, attn_q_chunk=0)
    want, margins = _run_reference(
        rcfg, rparams, _mix(RRequest, rcfg, QWEN_MIX, share_last=False))
    with ServingEngine(tcfg, tparams, n_slots=2, max_len=128, block_size=32,
                       device="cpu") as eng:
        assert eng.use_fused
        reqs = _mix(Request, tcfg, QWEN_MIX, share_last=False)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert len(done) == len(reqs) and all(r.error is None for r in done)
        assert len({r.slot_class for r in reqs}) == 3
        stats = eng.tabm.stats
        assert stats["writes"] == stats["reads"] == len(reqs)
        eng.slots.check_block_invariants()
        got = {r.rid: r.out_tokens for r in done}
    _check_tokens(want, margins, got)


def _serve_text(cfg, params, prompts, new, check_prefill=None,
                max_len=256):
    """Serve text-only ``prompts`` (``new`` tokens each) on the port's
    engine on the CPU; record the prefill logits and every decode step's
    (slot ids, logits).  Returns (requests, prefill record, steps, slot
    of each request id)."""
    pre, steps = {}, []
    with ServingEngine(cfg, params, n_slots=4, max_len=max_len,
                       device="cpu") as eng:
        assert not eng.use_fused and eng.slots.paged == (False,)
        assert eng.slots.n_blocks == eng.slots.blocks_per_slot == 0
        prefill, decode = eng._prefill, eng._decode

        def recording_prefill(tokens, vision, last_idx):
            logits, cache = prefill(tokens, vision, last_idx)
            if check_prefill is not None:
                check_prefill(tokens, cache)
            pre.update(logits=logits.clone(), lens=last_idx.tolist())
            return logits, cache

        def recording_decode(tokens, lengths, slot_ids, tables):
            logits, pool = decode(tokens, lengths, slot_ids, tables)
            steps.append((slot_ids.tolist(), logits.clone()))
            return logits, pool
        eng._prefill, eng._decode = recording_prefill, recording_decode
        reqs = [Request(rid=i, tokens=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert all(r.error is None for r in done)
        eng.slots.check_block_invariants()
        slot_of = {r.rid: r.slot for r in reqs}
    assert pre["lens"] == [len(p) for p in prompts]
    assert len(steps) == new - 1
    return reqs, pre, steps, slot_of


def _hold_against_unpadded_model(rcfg, rparams, prompts, served):
    """Each request's prefill logits and decode steps' logits against the
    reference's ``lm_prefill`` on the unpadded prompt plus teacher-forced
    ``lm_decode_step``, within 1e-4 of the largest logit."""
    reqs, pre, steps, slot_of = served
    prefill_fn = jax.jit(RM.lm_prefill, static_argnums=(1, 3))
    decode_fn = jax.jit(RM.lm_decode_step, static_argnums=(1,))
    for b, req in enumerate(reqs):
        rl, cache = prefill_fn(rparams, rcfg, jnp.asarray(prompts[b][None]),
                               256)
        got = [pre["logits"][b]]
        want = [rl[0]]
        for t, (slot_ids, logits) in enumerate(steps):
            got.append(logits[slot_ids.index(slot_of[req.rid])])
            rl, cache = decode_fn(rparams, rcfg, jnp.asarray(
                [[req.out_tokens[t]]], jnp.int32), cache)
            want.append(rl[0])
        for w, g in zip(want, got):
            w, g = f32(w), f32(g)
            assert float(np.abs(w - g).max()) <= 1e-4 * float(
                np.abs(w).max())


def test_mamba2_engine_matches_the_unpadded_reference_model():
    """Prompts of 20, 32 and 64 tokens share the 128 bucket, so each is
    right-padded by 108, 96 and 64 positions in one batch-3 prefill; the
    engine takes each row's SSM state and conv tail at its true end, and
    its logits then follow the reference model run on the unpadded
    prompt (chunk 32 admits these lengths) through three decode steps,
    teacher-forced with the engine's own tokens."""
    rcfg, rparams, tcfg, tparams = shared_params("mamba2-1.3b", "float32",
                                                 "nanomind-serve")
    rng = np.random.default_rng(5)
    lens, new = (20, 32, 64), 4
    prompts = [rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]

    def check_prefill(tokens, cache):
        assert tuple(tokens.shape) == (len(lens), 128)
    served = _serve_text(tcfg, tparams, prompts, new, check_prefill)
    _hold_against_unpadded_model(rcfg, rparams, prompts, served)


def test_mamba2_engine_short_bucket_is_chunk_aligned():
    """An engine with ``max_len=128`` has one prompt bucket.  At
    ``max_len - 1`` = 127 the reduced config's 32-position SSD chunk would
    not divide it; the bucket is rounded up to 128 (the slot-state pool has
    no length axis), so prompts of 20, 64 and 96 tokens prefill in one
    batch-3 call of width 128 and the logits follow the reference model on
    the unpadded prompts through three decode steps."""
    rcfg, rparams, tcfg, tparams = shared_params("mamba2-1.3b", "float32",
                                                 "nanomind-serve")
    assert tcfg.ssm.chunk_size == 32
    rng = np.random.default_rng(6)
    lens, new = (20, 64, 96), 4
    prompts = [rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]

    def check_prefill(tokens, cache):
        assert tuple(tokens.shape) == (len(lens), 128)
    served = _serve_text(tcfg, tparams, prompts, new, check_prefill,
                         max_len=128)
    _hold_against_unpadded_model(rcfg, rparams, prompts, served)


@pytest.mark.parametrize("max_len,want", [(128, (128,)), (100, (128,)),
                                          (33, (32,)), (20, (19,)),
                                          (256, (128,))])
def test_short_bucket_of_each_mixer(max_len, want):
    """The engine's buckets: a chunked slot-state mixer's one short
    bucket is a whole number of its chunks (or one chunk); softmax
    attention keeps ``max_len - 1``."""
    _, _, tcfg, tparams = shared_params("mamba2-1.3b", "float32",
                                        "nanomind-serve")
    with ServingEngine(tcfg, tparams, n_slots=2, max_len=max_len,
                       device="cpu") as eng:
        assert eng._buckets() == want
    _, _, lcfg, lparams = shared_params(ARCH, "float32", "nanomind-serve")
    for cfg in (lcfg, dataclasses.replace(lcfg, **LINEAR)):
        with ServingEngine(cfg, lparams, n_slots=2, max_len=max_len,
                           block_size=32, device="cpu") as eng:
            assert eng._buckets() == ((128,) if max_len > 128
                                      else (max_len - 1,))


LINEAR = {"attn_impl": "linear", "subquadratic": True}


def _linear_params():
    """Reduced llava (fp32, nanomind-serve) with the paper's streaming
    linear attention, for both packages: llava's own weights."""
    rcfg, rparams, tcfg, tparams = shared_params(ARCH, "float32",
                                                 "nanomind-serve")
    return (dataclasses.replace(rcfg, **LINEAR), rparams,
            dataclasses.replace(tcfg, **LINEAR), tparams)


def test_linear_attention_engine_matches_the_unpadded_reference_model():
    """Reduced llava with ``attn_impl="linear"``: text prompts of 20, 45
    and 100 tokens right-padded into one batch-3 prefill of the 128
    bucket; the engine keeps each row's (state, z) at its true end (the
    kernel wrapper's ``valid_len``) in the slot pool, which holds no KV
    blocks, and its logits follow the reference model run on the
    unpadded prompt through three decode steps (the composed step)."""
    rcfg, rparams, tcfg, tparams = _linear_params()
    rng = np.random.default_rng(8)
    lens, new = (20, 45, 100), 4
    prompts = [rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]

    def check_prefill(tokens, cache):
        assert tuple(tokens.shape) == (len(lens), 128)
        state, z = cache["layers"][0]
        L, H, hd = tcfg.n_layers, tcfg.n_heads, tcfg.hd
        assert tuple(state.shape) == (L, len(lens), H, hd, hd)
        assert tuple(z.shape) == (L, len(lens), H, hd)
    served = _serve_text(tcfg, tparams, prompts, new, check_prefill)
    _hold_against_unpadded_model(rcfg, rparams, prompts, served)


def test_linear_attention_engine_serves_the_vision_mix():
    """The llava mix (three slot classes, mid-flight admit and retire,
    one shared staging) on the linear-attention variant at ``max_len``
    128: one ragged 127-position prefill chunk, vision spliced from the
    TABM ring, every request finishes and releases its slot, and the
    slot pool holds L x n_slots x H (hd^2 + hd) fp32 state whatever the
    length."""
    _, _, tcfg, tparams = _linear_params()
    with ServingEngine(tcfg, tparams, n_slots=2, max_len=128, block_size=32,
                       device="cpu") as eng:
        reqs = _mix(Request, tcfg)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert len(done) == len(reqs) and all(r.error is None for r in done)
        assert all(len(r.out_tokens) == r.max_new_tokens for r in done)
        stats = eng.tabm.stats
        assert stats["writes"] == stats["reads"] and stats["shares"] == 1
        eng.slots.check_block_invariants()
        assert sorted(eng.slots.free) == [0, 1] and not eng.live
        L, H, hd = tcfg.n_layers, tcfg.n_heads, tcfg.hd
        assert eng.slots.nbytes == L * 2 * H * (hd * hd + hd) * 4


def test_reference_engine_pads_into_linear_attention_state():
    """The fault the port repairs (ROADMAP §3): the reference engine
    right-pads a 20-token prompt to the 128 bucket and its prefill sums
    phi(k) v^T and phi(k) over the 108 pads too, so the (state, z) it
    lands in the slot is not the unpadded prompt's (phi > 0: z alone
    grows with the 128 summed positions).  The port's engine lands the
    unpadded prompt's state, within 1e-4."""
    rcfg, rparams, tcfg, tparams = _linear_params()
    prompt = np.random.default_rng(9).integers(
        3, tcfg.vocab_size, 20).astype(np.int32)
    _, want = jax.jit(RM.lm_prefill, static_argnums=(1, 3))(
        rparams, rcfg, jnp.asarray(prompt[None]), 256)
    want = [f32(t[:, 0]) for t in want["layers"][0]]
    landed = {}
    with RServingEngine(rcfg, rparams, n_slots=2, max_len=256) as eng:
        insert = eng.slots.insert_many

        def capture(slots, cache, lens):
            landed["reference"] = [f32(t[:, 0]) for t in cache["layers"][0]]
            return insert(slots, cache, lens)
        eng.slots.insert_many = capture
        eng.submit(RRequest(rid=0, tokens=prompt, max_new_tokens=2))
        assert all(r.error is None for r in eng.run())
    with ServingEngine(tcfg, tparams, n_slots=2, max_len=256,
                       device="cpu") as eng:
        insert = eng.slots.insert_many

        def capture_port(slots, cache, lens):
            landed["port"] = [f32(t[:, 0]) for t in cache["layers"][0]]
            return insert(slots, cache, lens)
        eng.slots.insert_many = capture_port
        eng.submit(Request(rid=0, tokens=prompt, max_new_tokens=2))
        assert all(r.error is None for r in eng.run())

    def rel(w, g):
        return float(np.abs(w - g).max() / np.abs(w).max())
    for w, r, t in zip(want, landed["reference"], landed["port"]):
        assert rel(w, r) > 0.5
        assert rel(w, t) <= 1e-4


def test_plan_run_same_on_device_and_host_backends():
    """One full pass through the brick plan (TABM crossing included) on
    the device backend (here the CPU) and on the pinned-thread host
    backend, against ``lm_prefill`` — the same logits."""
    _, _, cfg, params = shared_params(ARCH, "float32", "nanomind-serve")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(3, 500, (1, 12)).astype(np.int32))
    feats = torch.from_numpy((rng.standard_normal(
        (1, 8, cfg.vision_feat_dim)) * 0.02).astype(np.float32))
    outs = []
    for backend in (DeviceBackend("cpu"), "host"):
        pool = SlotClassPool.from_config(cfg, device="cpu")
        plan = compile_plan(decompose(cfg), params, tabm=pool,
                            backend=backend)
        logits, trace = plan.run({"tokens": toks, "vision_feats": feats})
        assert pool.stats["writes"] == pool.stats["reads"] == 1
        outs.append(logits[:, -1])
    # the ring holds bf16 embeds; feed lm_prefill the same rounding
    with torch.no_grad():
        v = TM.project_vision(params["vis_proj"], cfg, feats)
        x = params["embed"][toks]
        x = torch.cat([v.to(torch.bfloat16).to(x.dtype),
                       x[:, v.shape[1]:]], dim=1)
        from repro_torch.models import decoder as dec
        from repro_torch.models.common import default_positions
        rope = TM.make_rope_fn(cfg, default_positions(1, 12, "cpu"))
        x, _, _ = dec.stack_forward(params["layers"], cfg, x, rope)
        want = TM._head(params, cfg, x)[:, -1]
    for got in outs:
        assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(
            want.abs().max()))
    assert torch.equal(outs[0], outs[1])


def test_serve_launcher_runs_on_cpu(capsys):
    """The port's launcher, asked for the CPU: reduced llava under
    ``nanomind-serve`` (weights kept packed), every request finishes and
    the TABM ring reports its hand-offs."""
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                       "--max-len", "128", "--max-new", "3",
                       "--quantize", "nanomind-serve"]) == 0
    out = capsys.readouterr().out
    assert "finished=3/3" in out and "on cpu" in out
    assert "tabm ring: {'writes': 3, 'reads': 3" in out


def test_serve_launcher_runs_mamba2_on_cpu(capsys):
    """``--arch mamba2-1.3b``: text-only prompts, no TABM ring, every
    request finishes through the slot-state pool.  ``--max-len 256``
    gives the 128 prefill bucket, a multiple of the SSD chunk (at
    ``--max-len`` 128 the engine's one bucket would be 127)."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "mamba2-1.3b", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-len", "256",
                       "--max-new", "3", "--quantize", "nanomind-serve"]) == 0
    out = capsys.readouterr().out
    assert "finished=3/3" in out and "mamba2-1.3b on cpu" in out
    assert "tabm ring" not in out

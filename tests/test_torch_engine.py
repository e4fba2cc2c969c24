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
"""
import dataclasses

import numpy as np
import torch

from _torch_parity import shared_params
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

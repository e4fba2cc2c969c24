"""The port's disaggregation seam on the CPU: paged KV export and import,
remote admission, the prefill and decode fleets over every transport,
and a reference (JAX) prefill fleet feeding the port's decode fleet.

* ``export_blocks`` -> ``encode_frame`` -> ``decode_frame`` ->
  ``import_blocks`` is bit-exact and in place (every pool leaf keeps its
  address) on reduced LLaVA (paged K/V), Mamba-2 and linear attention
  (slot-state rows);
* ``admit_remote`` admits nothing and changes nothing when the pool is
  full, and raises on another paged layout;
* ``serve_disagg_inproc`` gives the port's single engine's tokens, with
  more requests than decode slots and, on LLaVA, >= 2 slot classes and
  fewer paged wire bytes than whole lanes;
* the reference's ``PrefillWorker`` (reduced fp32 LLaVA, softmax) sends
  over an OS pipe to the port's ``DecodeWorker``: the port's pool holds
  exactly the bytes the JAX prefill exported, the first tokens are the
  JAX prefill's, and the tokens follow the reference's single-process
  engine up to each request's first near-tie (ROADMAP §3).  Not on
  Mamba-2 or linear attention: the reference's prefill sums the pads
  into their state (ROADMAP §3);
* the launcher runs as a subprocess over inproc, pipe and socket, and
  its weight digest tells equal weights from different ones."""
import dataclasses
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from _torch_parity import shared_params
from repro.core import transport as R
from repro.serving.disagg import PrefillWorker as RPrefillWorker
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine
from repro_torch.configs import get_config
from repro_torch.core.quantize import PROFILES, quantize_tree
from repro_torch.core.transport import (BytesReader, InProcTransport,
                                        PipeTransport, TransportError,
                                        decode_frame, encode_frame)
from repro_torch.launch.serve_disagg import params_digest
from repro_torch.models.model import init_params
from repro_torch.serving.disagg import (DecodeWorker, PrefillWorker,
                                        serve_disagg_inproc)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_cache import PagedKVCache

ROOT = os.path.join(os.path.dirname(__file__), "..")
LLAVA = "llava-onevision-0.5b"
LINEAR = {"attn_impl": "linear", "subquadratic": True}
KW = dict(n_slots=2, max_len=256, block_size=32, device="cpu")
MARGIN = 1e-4


def _cfg(kind):
    if kind == "mamba":
        return get_config("mamba2-1.3b").reduced()
    cfg = get_config(LLAVA).reduced()
    return dataclasses.replace(cfg, **LINEAR) if kind == "linear" else cfg


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.contiguous().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def _ptrs(cache):
    return [t.data_ptr() for pos in cache.pool for t in pos]


def _fill(cache, seed):
    """Random contents in every pool leaf, written in place."""
    g = torch.Generator().manual_seed(seed)
    for pos in cache.pool:
        for t in pos:
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))


def _wire(payload):
    """A payload through the codec, as a frame crosses the wire."""
    layout = [len(leaves) for leaves in payload]
    flat = [leaf for leaves in payload for leaf in leaves]
    _, meta, back, _ = decode_frame(BytesReader(encode_frame(
        "kv", {"layout": layout}, flat, rid=0)).read)
    it = iter(back)
    return [[next(it) for _ in range(n)] for n in meta["layout"]]


# ---------------------------------------------------------------------------
# export -> wire -> import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["llava", "mamba", "linear"])
def test_export_wire_import_is_bit_exact_and_in_place(kind):
    cfg = _cfg(kind)
    kw = dict(n_slots=3, max_len=256, block_size=32, device="cpu")
    src, dst = PagedKVCache(cfg, **kw), PagedKVCache(cfg, **kw)
    _fill(src, 2)
    _fill(dst, 3)
    paged = any(src.paged)
    assert paged == (kind == "llava")
    src.take_slot()
    s_src = src.take_slot()                   # export from slot 1, not 0
    src.grant_blocks(s_src, 4 if paged else 0)
    nb = 3 if paged else 0                    # written blocks < grant
    payload = src.export_blocks(s_src, nb)
    for pos, leaves in enumerate(payload):
        for leaf, pool_leaf in zip(leaves, src.pool[pos]):
            assert leaf.device.type == "cpu"
            assert leaf.shape[1] == (nb if src.paged[pos] else 1)
            assert leaf.dtype == pool_leaf.dtype
    wired = _wire(payload)

    dst.grant_blocks(dst.take_slot(), 2 if paged else 0)   # shift ids
    s_dst = dst.take_slot()
    dst.grant_blocks(s_dst, 4 if paged else 0)
    before = _ptrs(dst)
    others = [t.clone() for pos in dst.pool for t in pos]
    dst.import_blocks(s_dst, wired)
    assert _ptrs(dst) == before               # written in place
    out = dst.export_blocks(s_dst, nb)
    for p1, p2 in zip(payload, out):
        for l1, l2 in zip(p1, p2):
            assert _bits(l1) == _bits(l2)
    # nothing outside the slot's blocks (or its row) changed
    written = torch.zeros(dst.n_blocks if paged else dst.n_slots,
                          dtype=torch.bool)
    written[dst.block_tables[s_dst][:nb] if paged else [s_dst]] = True
    for old, new in zip(others, [t for pos in dst.pool for t in pos]):
        assert torch.equal(old[:, ~written], new[:, ~written])
    if paged:
        with pytest.raises(RuntimeError):
            src.export_blocks(s_src, 5)       # over the grant
        small = dst.take_slot()
        dst.grant_blocks(small, 2)
        with pytest.raises(RuntimeError):
            dst.import_blocks(small, wired)   # 3 blocks into a grant of 2


def test_slot_lane_bytes_is_one_whole_lane():
    cfg = _cfg("llava")
    c = PagedKVCache(cfg, n_slots=3, max_len=256, block_size=32,
                     device="cpu")
    per_block = 2 * cfg.n_layers * 32 * cfg.n_kv_heads * cfg.hd * 2   # bf16
    assert c.slot_lane_bytes == per_block * c.blocks_per_slot
    assert PagedKVCache(_cfg("mamba"), n_slots=3, max_len=256,
                        device="cpu").slot_lane_bytes == 0


def test_import_rejects_another_block_size():
    cfg = _cfg("llava")
    src = PagedKVCache(cfg, n_slots=1, max_len=128, block_size=32,
                       device="cpu")
    dst = PagedKVCache(cfg, n_slots=1, max_len=128, block_size=16,
                       device="cpu")
    s = src.take_slot()
    src.grant_blocks(s, 2)
    d = dst.take_slot()
    dst.grant_blocks(d, 8)
    with pytest.raises(RuntimeError):
        dst.import_blocks(d, src.export_blocks(s, 2))


# ---------------------------------------------------------------------------
# remote admission
# ---------------------------------------------------------------------------

def _requests(cfg, n, new=4, seed=0):
    """Alternating thumbnail / full-resolution requests (LLaVA), or text
    prompts of 20-60 tokens (Mamba-2)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        text = rng.integers(3, cfg.vocab_size - 1, 6 + i % 3 if cfg.vlm
                            else 20 + 10 * i).astype(np.int32)
        if not cfg.vlm:
            reqs.append(Request(rid=i, tokens=text, max_new_tokens=new))
            continue
        n_vis = cfg.vision_tokens if i % 2 else min(cfg.vision_token_buckets)
        reqs.append(Request(
            rid=i, tokens=np.concatenate([np.zeros(n_vis, np.int32), text]),
            max_new_tokens=new + i % 2, vision_feats=(rng.standard_normal(
                (1, n_vis, cfg.vision_feat_dim)) * 0.02).astype(np.float32)))
    return reqs


@pytest.fixture(scope="module")
def llava_params():
    cfg = _cfg("llava")
    with torch.no_grad():
        return quantize_tree(init_params(cfg, device="cpu", seed=0),
                             PROFILES["nanomind-serve"])


def _exports(cfg, params, reqs):
    """RemotePrefills of ``reqs`` from a port prefill engine."""
    out = []
    with ServingEngine(cfg, params, capture_slab=True, async_staging=False,
                       **KW) as eng:
        for r in reqs:
            eng.submit(r)
        while eng.queue or eng.live:
            out += [eng.export_remote(r) for r in eng.prefill_step()]
        assert not eng.live and sorted(eng.slots.free) == [0, 1]
        eng.slots.check_block_invariants()
    return out


def test_admit_remote_full_pool_changes_nothing(llava_params):
    cfg = _cfg("llava")
    rps = _exports(cfg, llava_params, _requests(cfg, 3))
    assert all(rp.slab is not None and rp.slab.shape[0] ==
               r.tokens.shape[0] - 6 - i % 3 for i, (rp, r) in
               enumerate(zip(rps, _requests(cfg, 3))))
    with ServingEngine(cfg, llava_params, async_staging=False, **KW) as eng:
        assert eng.admit_remote(rps[0]) and eng.admit_remote(rps[1])

        def state():
            return ([t.clone() for pos in eng.slots.pool for t in pos],
                    list(eng.slots.free), list(eng.slots.free_blocks),
                    {k: list(v) for k, v in eng.slots.block_tables.items()},
                    dict(eng.slots.used_blocks), eng.slots.lengths.copy(),
                    dict(eng.live), eng.stats.prefills)
        before = state()
        assert not eng.admit_remote(rps[2])            # no slot
        after = state()
        assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
        assert before[1:5] == after[1:5] and before[6:] == after[6:]
        assert np.array_equal(before[5], after[5])
    # too few free blocks, a slot free
    with ServingEngine(cfg, llava_params, async_staging=False,
                       kv_blocks=rps[0].blocks_granted + 1, **KW) as eng:
        assert eng.admit_remote(rps[0])
        free_blocks = list(eng.slots.free_blocks)
        assert not eng.admit_remote(rps[1])
        assert list(eng.slots.free_blocks) == free_blocks
        assert eng.slots.free and len(eng.live) == 1
        bad = dataclasses.replace(rps[2], paged=(False,))
        with pytest.raises(RuntimeError):
            eng.admit_remote(bad)


# ---------------------------------------------------------------------------
# the fleets
# ---------------------------------------------------------------------------

def _single(cfg, params, reqs):
    with ServingEngine(cfg, params, async_staging=False, **KW) as eng:
        for r in reqs:
            eng.submit(r)
        done = eng.run()
    assert all(r.error is None for r in done) and len(done) == len(reqs)
    return {r.rid: list(r.out_tokens) for r in done}


def _fleet_engines(monkeypatch):
    """{"prefill": engine, "decode": engine} of the next
    ``serve_disagg_inproc``, filled in as the prefill engine exports and
    the decode engine admits."""
    engines = {}
    export, admit = ServingEngine.export_remote, ServingEngine.admit_remote

    def exporting(self, req):
        engines["prefill"] = self
        return export(self, req)

    def admitting(self, msg):
        engines["decode"] = self
        return admit(self, msg)
    monkeypatch.setattr(ServingEngine, "export_remote", exporting)
    monkeypatch.setattr(ServingEngine, "admit_remote", admitting)
    return engines


@pytest.mark.parametrize("kind", ["llava", "mamba", "linear"])
def test_inproc_fleets_match_the_single_engine(kind, llava_params,
                                               monkeypatch):
    cfg = _cfg(kind)
    if kind == "mamba":
        with torch.no_grad():
            params = quantize_tree(init_params(cfg, device="cpu", seed=0),
                                   PROFILES["nanomind-serve"])
    else:
        params = llava_params
    n = 5                                     # more than the 2 decode slots
    want = _single(cfg, params, _requests(cfg, n))
    reqs = _requests(cfg, n)
    engines = _fleet_engines(monkeypatch)
    results, stats = serve_disagg_inproc(
        cfg, params, reqs, prefill_kwargs=KW, decode_kwargs=KW)
    assert {rid: r.tokens for rid, r in results.items()} == want
    assert all(r.error is None for r in results.values())
    pre, dec = engines["prefill"], engines["decode"]
    assert pre.stats.decoded_tokens == 0                  # never decodes
    assert dec.stats.prefills == n                        # admitted remote
    assert max(e.rid for e in dec.trace
               if e.event == "decode_cohort") == 2
    assert stats.sent == n and stats.failed == 0 and stats.transport == \
        "inproc"
    dec.slots.check_block_invariants()
    if kind == "llava":
        assert len({r.slot_class for r in reqs}) >= 2
        assert 0 < stats.kv_wire_bytes < n * stats.lane_bytes_baseline
    else:
        assert stats.kv_wire_bytes == stats.lane_bytes_baseline == 0
    assert stats.wire_bytes > stats.kv_wire_bytes


def test_prefill_fleet_is_greedy_only(llava_params):
    cfg = _cfg("llava")
    a, _ = InProcTransport.pair()
    pre = PrefillWorker(cfg, llava_params, a, **KW)
    try:
        req = _requests(cfg, 1)[0]
        req.temperature = 0.7
        with pytest.raises(ValueError):
            pre.submit(req)
    finally:
        pre.engine.shutdown()


def test_wire_failures_fail_their_requests(llava_params):
    """A ``failed`` frame and a corrupt payload each fail only their rid;
    a truncated stream fails every unresolved request and propagates,
    after the decode fleet has decoded what it admitted and sent every
    result and ``done``, which ``collect`` drains."""
    cfg = _cfg("llava")
    rps = _exports(cfg, llava_params, _requests(cfg, 2))
    a, b = InProcTransport.pair()
    dec = DecodeWorker(cfg, llava_params, b, **KW)
    a.send_prefill(rps[0])
    bad = bytearray(encode_frame(*rps[1].to_wire(), rid=rps[1].rid))
    bad[-5] ^= 0xFF                           # a payload byte
    a._send_bytes(bytes(bad))
    a.send("failed", {"rid": 7, "error": "staging failed"}, rid=7)
    a._send_bytes(bytes(bad)[:40])            # truncated stream
    a.close()
    try:
        with pytest.raises(TransportError) as ei:
            dec.run()
        assert not ei.value.recoverable
    finally:
        dec.engine.shutdown()
    res = dec.results
    assert res[rps[0].rid].error is None
    assert len(res[rps[0].rid].tokens) == rps[0].max_new_tokens
    assert "corrupt frame payload" in res[rps[1].rid].error
    assert res[7].error == "staging failed"
    got = {}
    while True:
        kind, meta, arrays, rid = a.recv()
        if kind == "done":
            break
        got[rid] = meta["error"]
    assert set(got) == {rps[0].rid, rps[1].rid, 7}
    assert got[rps[0].rid] is None


def test_staging_failure_crosses_as_a_failed_frame(llava_params):
    cfg = _cfg("llava")
    reqs = _requests(cfg, 3)
    reqs[1].vision_feats = reqs[1].vision_feats[..., :-1]   # bad width
    results, stats = serve_disagg_inproc(cfg, llava_params, reqs,
                                         prefill_kwargs=KW,
                                         decode_kwargs=KW)
    assert stats.failed == 1 and stats.sent == 2
    assert results[1].error is not None and not results[1].tokens
    assert all(results[i].error is None and results[i].tokens
               for i in (0, 2))


# ---------------------------------------------------------------------------
# a reference (JAX) prefill fleet feeds the port's decode fleet
# ---------------------------------------------------------------------------

# (vision tokens, prompt length, max_new) per request
CROSS_MIX = [(8, 7, 5), (2, 6, 4), (8, 9, 5), (2, 8, 4)]


def _cross_requests(request_cls, cfg):
    rng = np.random.default_rng(4)
    return [request_cls(
        rid=i, tokens=(np.arange(plen) % 50 + 3).astype(np.int32),
        n_images=1, max_new_tokens=new, vision_feats=(rng.standard_normal(
            (1, nv, cfg.vision_feat_dim)) * 0.02).astype(np.float32))
        for i, (nv, plen, new) in enumerate(CROSS_MIX)]


def test_jax_prefill_fleet_feeds_the_port_decode_fleet():
    rcfg, rparams, tcfg, tparams = shared_params(LLAVA, "float32",
                                                 "nanomind-serve")
    geo = dict(n_slots=2, max_len=128, block_size=32)
    # the reference's single-process oracle, recording top-1 margins
    margins = {}
    with RServingEngine(rcfg, rparams, **geo) as eng:
        pick = eng._pick

        def recording_pick(logits, req):
            row = np.sort(np.asarray(logits, np.float32)[0])
            margins.setdefault(req.rid, []).append(float(row[-1] - row[-2]))
            return pick(logits, req)
        eng._pick = recording_pick
        for r in _cross_requests(RRequest, rcfg):
            eng.submit(r)
        want = {r.rid: list(r.out_tokens) for r in eng.run()}

    a2b_r, a2b_w = os.pipe()
    b2a_r, b2a_w = os.pipe()
    ref_tr = R.PipeTransport(b2a_r, a2b_w)
    port_tr = PipeTransport(a2b_r, b2a_w)
    dec = DecodeWorker(tcfg, tparams, port_tr, device="cpu", **geo)
    imported = {}
    admit = dec.engine.admit_remote

    def recording_admit(msg):
        ok = admit(msg)
        if ok:
            slot = dec.engine.live[max(dec.engine.live, key=lambda s:
                                       dec.engine.live[s].rid == msg.rid)]
            assert slot.rid == msg.rid
            nb = msg.kv[0][0].shape[1]
            imported[msg.rid] = dec.engine.slots.export_blocks(slot.slot, nb)
        return ok
    dec.engine.admit_remote = recording_admit
    errs = []

    def run_decode():
        try:
            dec.run()
        except BaseException as e:           # surfaces after join
            errs.append(e)
    t = threading.Thread(target=run_decode, daemon=True)
    t.start()
    pre = RPrefillWorker(rcfg, rparams, ref_tr, **geo)
    exported = {}
    export = pre.engine.export_remote

    def recording_export(req):
        rp = export(req)
        exported[rp.rid] = rp
        return rp
    pre.engine.export_remote = recording_export
    try:
        for r in _cross_requests(RRequest, rcfg):
            pre.submit(r)
        pre.run()
        results = pre.collect(len(CROSS_MIX))
    finally:
        t.join(timeout=300)
        pre.engine.shutdown()
        dec.engine.shutdown()
        ref_tr.close()
        port_tr.close()
    assert not t.is_alive() and not errs, errs
    assert set(imported) == set(exported) == set(want)
    compared = total = 0
    for rid, rp in exported.items():
        # the port's pool holds exactly the bytes the JAX prefill exported
        for p1, p2 in zip(rp.kv, imported[rid]):
            for l1, l2 in zip(p1, p2):
                assert _bits(l1) == _bits(l2)
        got = results[rid]
        assert got.error is None and got.tokens[0] == rp.first_token \
            == want[rid][0]
        total += len(want[rid])
        for i, tok in enumerate(want[rid]):
            if margins[rid][i] < MARGIN:
                break
            assert got.tokens[i] == tok, (rid, i, got.tokens, want[rid])
            compared += 1
    assert compared >= 0.75 * total, (compared, total)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["inproc", "pipe", "socket"])
def test_serve_disagg_launcher(transport):
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_disagg",
         "--device", "cpu", "--transport", transport, "--requests", "5"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert f"OK: disaggregated prefill/decode fleets over {transport}" in out
    digests = re.findall(r"\] weights digest ([0-9a-f]{8})", out)
    # one process holds one copy of the weights; a decode subprocess
    # makes its own and prints its digest beside the prefill fleet's
    n = 1 if transport == "inproc" else 2
    assert len(digests) == n and len(set(digests)) == 1, out


def test_params_digest_tells_weights_apart():
    cfg = _cfg("llava")
    a = params_digest(init_params(cfg, device="cpu", seed=0))
    assert a == params_digest(init_params(cfg, device="cpu", seed=0))
    assert a != params_digest(init_params(cfg, device="cpu", seed=1))
    with torch.no_grad():
        q = quantize_tree(init_params(cfg, device="cpu", seed=0),
                          PROFILES["nanomind-serve"])
        q2 = quantize_tree(init_params(cfg, device="cpu", seed=0),
                           PROFILES["nanomind-serve"])
    assert params_digest(q) == params_digest(q2) != a

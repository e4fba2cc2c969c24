#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build the CUDA kernel libraries of ``src/repro_torch/csrc`` with nvcc,
   one compiler per source, all at once (timed);
2. hold each kernel against its plain PyTorch version at the served
   shapes, on bf16 inputs:
   - the fused-decode kernels at LLaVA-OneVision-0.5B's widths (D=896,
     H=14, KV=2, hd=64, d_ff=4864, L=24; cohort rows 1/2/4/8) and at
     Qwen2-VL-7B's (D=3584, H=28, KV=4, hd=128, d_ff=18944, L=28; rows
     1/2/4), q4 group 32, within 2e-2 of the plain version's largest
     magnitude; the in-kernel unpack bit-equal to ``dequantize``
     (one-hot activations); the KV-row scatter bit-exact, sentinel rows
     writing nothing, on each model's served pool (n_slots x max_len /
     block_size blocks);
   - the flash-attention kernel at LLaVA's prefill shape (B 1, S 1024,
     H 14, KV 2, hd 64), Qwen2-VL's (B 2, S 2048, H 28, KV 4, hd 128), a
     ragged S = 777, and non-causal with Sq != Sk; every output row
     (b, i, h) within 2e-2 of that row's largest plain magnitude (a row
     over n keys is ~n^-1/2 in size, so one tolerance over the whole
     output would be loose for the long rows);
3. serve LLaVA-OneVision-0.5B at full width through ``ServingEngine``:
   random weights from ``init_params`` (seed 0) on the card, packed by
   ``quantize_tree(nanomind-serve)``; four requests (full-resolution and
   thumbnail images, one shared payload, 16-token text, 16 new tokens);
   chunked prefill attention, decode through the fused kernels;
4. serve Qwen2-VL-7B the same way with ``attn_q_chunk=0``: prefill
   through the flash kernel in every layer, M-RoPE decode through the
   fused kernels; four requests (a 1024-token image, a repeat of its
   bytes, a 256-token image, a 4 x 256 request);
   for each served path the launch counts are reset just before and
   read just after the run; one captured cohort state is decoded again
   by the fused and by the composed (plain) step, which must agree
   within bf16 tolerance; for Qwen2-VL one captured prefill group runs
   again with chunked attention, whose logits must agree with the flash
   path's;
5. time each kernel, its plain version and a PyTorch library call: the
   fused-decode kernels at cohort size 4 rotating over the layers'
   weights (so the weights come from device memory, not the 50 MB L2)
   at both models' widths, the flash kernel at Qwen2-VL's prefill shape;
   beside the bound the card's published rates set (3.35 TB/s, 989
   TFLOP/s bf16).

Output: build, check and serve lines, the ``nvidia-smi`` name/power-limit
line, one JSON line ``{"kernels": [...]}``, and as the last line
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16, published
TIME_BC = 4
# kernel vs plain version, bf16 outputs: both accumulate in fp32 in
# different orders, so an output may differ by one bf16 rounding step
KERNEL_TOL = 2e-2
# fused vs composed cohort step, and flash vs chunked prefill (logits):
# per-layer bf16 differences compound over the stack; the port's bf16
# model tests use 5e-2
STEP_TOL = 5e-2
# the served KV pools: n_slots x max_len / block_size blocks; Qwen2-VL at
# max_len 4096, because the engine's prefill buckets stop below max_len
# and a 1040-token prompt needs the 2048 bucket
N_SLOTS, BLOCK_SIZE = 4, 64
MAX_LEN = {"llava-onevision-0.5b": 2048, "qwen2-vl-7b": 4096}
# weights' layers rotated through in the decode-kernel timings: LLaVA's 24
# (the qkv weights of one layer would sit in L2), Qwen2-VL's first 8
# (one layer's q4 MLP weights alone are 127 MB)
TIME_LAYERS = {"llava-onevision-0.5b": 24, "qwen2-vl-7b": 8}
FLASH_SHAPES = (  # (B, Sq, Sk, H, KV, hd, causal)
    (1, 1024, 1024, 14, 2, 64, True),      # LLaVA prefill
    (2, 2048, 2048, 28, 4, 128, True),     # Qwen2-VL prefill
    (1, 777, 777, 28, 4, 128, True),       # ragged tile edges
    (2, 300, 1000, 14, 2, 64, False))      # non-causal, Sq != Sk
FLASH_TIME_SHAPE = FLASH_SHAPES[1]


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def device_time(fn):
    """Run ``fn`` under the profiler; return (total kernel microseconds on
    the card, [(kernel name, microseconds, launches)] largest first,
    number of kernels run).  Summed over the profiler's CUDA-side events
    only, so no kernel counts twice.  The profiler can miss the first
    launches of a burst; a synchronized pause inside the profiled region
    before ``fn`` keeps that to a few, and ``timed`` estimates from
    per-kernel means."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        fn()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in events), key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows, sum(r[2] for r in rows)


def timed(fn, n_rot, iters=96):
    """(device ms, call ms, device kernels) per call of ``fn(i)``, i
    rotating over ``n_rot`` weight sets: the card's kernel time summed
    from the profiler's CUDA events (None if it recorded none), wall time
    per call between CUDA events around the loop — host overhead
    included, which dominates calls of a few microseconds — and the
    kernels one call runs on the card."""
    import torch
    for i in range(n_rot):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_rot)
    stop.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(stop) / iters

    def loop():
        for i in range(iters):
            fn(i % n_rot)
        torch.cuda.synchronize()
    dev_us, rows, n_kernels = device_time(loop)
    # per call: each kernel's mean time times its launches per call
    # (at least one), so a launch the profiler missed does not count as
    # zero time
    per_call_us = sum(us / n * max(1, round(n / iters))
                      for _, us, n in rows if n)
    return ((per_call_us / 1e3 if dev_us > 0 else None), call_ms,
            n_kernels / iters)


def dev_or_call(t):
    return t[0] if t[0] is not None else t[1]


def bound(byt, fl):
    """(least ms on the card, what bounds it)."""
    t_b, t_f = byt / HBM_BYTES_PER_S, fl / BF16_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


class Smoke:
    """The run's shared state: device, random source, helpers."""

    def __init__(self, device="cuda"):
        import torch
        self.torch = torch
        self.dev = torch.device(device)
        self.gen = torch.Generator(device=self.dev).manual_seed(1)
        self.errs = {"fused_qkv": 0.0, "fused_mlp": 0.0,
                     "kv_row_scatter": 0.0, "flash_attention": 0.0}
        self.worst_row_ratio = 0.0       # flash: max over rows err/max

    def randn(self, *shape, scale=1.0):
        torch = self.torch
        return (torch.randn(shape, generator=self.gen, device=self.dev)
                * scale).to(torch.bfloat16)

    @staticmethod
    def max_err(got, want):
        got, want = got.float(), want.float()
        return (got - want).abs().max().item(), want.abs().max().item()

    def check(self, name, got, want, what):
        err, m = self.max_err(got, want)
        if not (got.shape == want.shape and err <= KERNEL_TOL * m):
            fail(f"{name} {what}: max err {err} vs max {m}")
        self.errs[name] = max(self.errs[name], err)

    # -- kernel checks ------------------------------------------------------
    def check_fused(self, cfg, bcs):
        """The fused-decode kernels against their plain versions at the
        widths of ``cfg``."""
        from repro_torch.core.quantize import QuantSpec, dequantize, quantize
        from repro_torch.kernels.fused_decode import ops, ref
        torch = self.torch
        D, H, KV, hd, F, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, cfg.d_ff, cfg.n_layers)
        spec = QuantSpec(4, group_size=32)
        randn = self.randn
        wq, wk, wv = (quantize(randn(D, n, hd, scale=D ** -0.5), spec)
                      for n in (H, KV, KV))
        bq, bk, bv = (randn(n, hd, scale=0.1) for n in (H, KV, KV))
        w_up, w_gate = (quantize(randn(D, F, scale=D ** -0.5), spec)
                        for _ in range(2))
        w_down = quantize(randn(F, D, scale=F ** -0.5), spec)
        for bc in bcs:
            h = randn(bc, 1, D)
            got = ops.fused_qkv(h, wq, wk, wv, bq, bk, bv)
            want = ref.ref_fused_qkv(h, wq, wk, wv, bq, bk, bv)
            for g, w in zip(got, want):
                self.check("fused_qkv", g, w, f"{cfg.name} bc={bc}")
            self.check("fused_mlp",
                       ops.fused_mlp(h, w_up, w_down, w_gate, act="swiglu"),
                       ref.ref_fused_mlp(h, w_up, w_down, w_gate,
                                         act="swiglu"),
                       f"{cfg.name} bc={bc}")
        for k in (0, D // 2 + 3, D - 1):       # the unpack, bit for bit
            h = torch.zeros((1, 1, D), dtype=torch.bfloat16, device=self.dev)
            h[0, 0, k] = 1.0
            for g, w in zip(ops.fused_qkv(h, wq, wk, wv), (wq, wk, wv)):
                if not torch.equal(g[0, 0].view(torch.int16),
                                   dequantize(w)[k].view(torch.int16)):
                    fail(f"fused_qkv {cfg.name}: one-hot row {k} differs "
                         f"from dequantize")
        n_blocks = N_SLOTS * MAX_LEN[cfg.name] // BLOCK_SIZE
        bs = BLOCK_SIZE
        k_pool = randn(L, n_blocks, bs, KV, hd)
        v_pool = randn(L, n_blocks, bs, KV, hd)
        for bc in bcs:
            k_rows, v_rows = randn(L, bc, KV, hd), randn(L, bc, KV, hd)
            blk = torch.randperm(n_blocks, generator=self.gen,
                                 device=self.dev)[:bc].to(torch.int32)
            off = torch.randint(0, bs, (bc,), generator=self.gen,
                                device=self.dev, dtype=torch.int32)
            if bc > 1:
                blk[-1] = n_blocks                  # a padded sentinel row
            want = ref.ref_kv_scatter(blk, off, k_rows, v_rows,
                                      k_pool.clone(), v_pool.clone())
            got = ops.kv_scatter(blk, off, k_rows, v_rows, k_pool, v_pool)
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    fail(f"kv_row_scatter {cfg.name} bc={bc}: pools differ")
        torch.cuda.synchronize()

    def check_flash(self):
        """Per output row (b, i, h): max |kernel - plain| within
        KERNEL_TOL of the row's max |plain|."""
        from repro_torch.kernels.flash_attention import (flash_attention,
                                                         ref_attention)
        for B, Sq, Sk, H, KV, hd, causal in FLASH_SHAPES:
            what = (f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                    f"causal={causal}")
            q = self.randn(B, Sq, H, hd)
            k, v = self.randn(B, Sk, KV, hd), self.randn(B, Sk, KV, hd)
            got = flash_attention(q, k, v, causal=causal).float()
            want = ref_attention(q, k, v, causal=causal).float()
            if got.shape != want.shape or not got.isfinite().all():
                fail(f"flash_attention {what}: shape {tuple(got.shape)} "
                     f"or non-finite output")
            err = (got - want).abs().amax(-1)
            ratio = (err / want.abs().amax(-1)).nan_to_num(nan=0.0,
                                                           posinf=1e9)
            worst = ratio.max().item()
            if worst > KERNEL_TOL:
                i = int(ratio.argmax())
                fail(f"flash_attention {what}: row {i} err/max {worst}")
            self.errs["flash_attention"] = max(self.errs["flash_attention"],
                                               err.max().item())
            self.worst_row_ratio = max(self.worst_row_ratio, worst)
        self.torch.cuda.synchronize()


def serve_path(sm, cfg, reqs):
    """Serve ``reqs`` on ``cfg`` at full width; check what the run must
    show; return (serve record, engine, captured cohort state, captured
    prefill)."""
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_decode import ops, ref
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    torch = sm.torch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        params = quantize_tree(init_params(cfg, device=sm.dev, seed=0),
                               PROFILES["nanomind-serve"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, params, n_slots=N_SLOTS,
                        max_len=MAX_LEN[cfg.name], block_size=BLOCK_SIZE,
                        device=sm.dev)
    del params
    if not eng.use_fused:
        fail(f"{cfg.name}: the engine did not select the fused decode step")
    captured, prefills = {}, []
    decode, prefill = eng._decode, eng._prefill

    def capturing_decode(tokens, lengths, slot_ids, tables):
        # keep one multi-row cohort state (inputs + pool before the step)
        if "args" not in captured and int((tables[:, 0] <
                                           eng.slots.n_blocks).sum()) >= 2:
            captured["args"] = tuple(t.clone() for t in
                                     (tokens, lengths, slot_ids, tables))
            captured["pool"] = tuple(tuple(t.clone() for t in pos)
                                     for pos in eng.slots.pool)
        return decode(tokens, lengths, slot_ids, tables)

    def counting_prefill(tokens, vision_embeds, last_idx):
        logits, cache = prefill(tokens, vision_embeds, last_idx)
        if not prefills or tuple(tokens.shape) > tuple(prefills[0][0].shape):
            # keep the largest group's inputs and logits (batch, width)
            prefills[:] = [(tokens.clone(), None if vision_embeds is None
                            else vision_embeds.clone(), last_idx.clone(),
                            logits.clone())]
        captured["prefill_calls"] = captured.get("prefill_calls", 0) + 1
        captured.setdefault("prefill_batch", []).append(
            int(tokens.shape[0]))
        captured.setdefault("prefill_width", []).append(
            int(tokens.shape[1]))
        return logits, cache
    eng._decode, eng._prefill = capturing_decode, counting_prefill
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    with eng:
        done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    eng._decode, eng._prefill = decode, prefill
    L = cfg.n_layers
    decode_steps = sum(1 for e in eng.trace if e.event == "decode_step")
    n_prefill = captured.get("prefill_calls", 0)
    errors = [r for r in done if r.error is not None]
    if len(done) != len(reqs) or errors:
        fail(f"{cfg.name}: requests failed: "
             f"{[repr(r.error) for r in errors]}")
    eng.slots.check_block_invariants()
    tstats = eng.tabm.stats
    if tstats["writes"] != tstats["reads"] or tstats["shares"] != 1:
        fail(f"{cfg.name}: TABM writes/reads/shares {tstats}")
    for r in done:
        if not (len(r.out_tokens) == r.max_new_tokens and all(
                0 <= t < cfg.vocab_size for t in r.out_tokens)):
            fail(f"{cfg.name}: request {r.rid} tokens {r.out_tokens}")
    want_flash = L * n_prefill if cfg.attn_q_chunk == 0 else 0
    if not (launches["fused_qkv"] == launches["fused_mlp"] == L * decode_steps
            and launches["kv_scatter"] == decode_steps and decode_steps > 0
            and launches["flash_attention"] == want_flash and n_prefill > 0):
        fail(f"{cfg.name}: launch counts {launches} for {decode_steps} "
             f"decode steps and {n_prefill} prefill calls")
    spans = eng.probe.samples()
    pre = [s for s in spans if s.brick == "decoder" and s.phase == "prefill"]
    decs = [s for s in spans if s.brick == "decoder" and s.phase == "decode"]
    serve = {"arch": cfg.name, "attn_q_chunk": cfg.attn_q_chunk,
             "requests": len(done), "decode_steps": decode_steps,
             "decoded_tokens": eng.stats.decoded_tokens,
             "setup_s": round(setup_s, 3), "serve_s": round(serve_s, 3),
             "prefill_calls": n_prefill,
             "prefill_batch": captured["prefill_batch"],
             "prefill_width": captured["prefill_width"],
             "prefill_ms": [round(s.dt * 1e3, 3) for s in pre],
             "prefill_tokens": [s.tokens for s in pre],
             "decode_step_ms_mean": round(1e3 * sum(s.dt for s in decs)
                                          / max(1, len(decs)), 3),
             "decode_tok_s": round(sum(s.tokens for s in decs)
                                   / max(1e-9, sum(s.dt for s in decs)), 3),
             "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                  3),
             "tabm": tstats, "launches": launches}

    # fused vs composed on the captured cohort state
    if "args" not in captured:
        fail(f"{cfg.name}: no multi-row cohort state was captured")
    args = captured["args"]
    pool_f = tuple(tuple(t.clone() for t in pos) for pos in captured["pool"])
    kw = dict(block_size=eng.slots.block_size, paged=eng.slots.paged)
    with torch.no_grad():
        lf, _ = ops.cohort_step(eng.params, cfg, *args, pool_f,
                                use_fused=True, **kw)
        lr, _ = ref.ref_cohort_step(eng.params, cfg, *args,
                                    captured["pool"], **kw)
    rows = int((args[3][:, 0] < eng.slots.n_blocks).sum())
    serve["cohort_check"] = logit_check(cfg, lf[:rows], lr[:rows],
                                        "fused vs composed step")
    serve["cohort_check"]["rows"] = rows

    # where one fused decode step's time goes: wall time (host clock,
    # synchronized, median of 5) against the card's kernel time
    def step():
        with torch.no_grad():
            ops.cohort_step(eng.params, cfg, *args, pool_f, use_fused=True,
                            **kw)
        torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    kernel_us, by_name, _ = device_time(step)
    wall_ms = sorted(walls)[2] * 1e3
    serve["decode_step_breakdown"] = {
        "bc": int(args[0].shape[0]), "wall_ms": wall_ms,
        "device_ms": kernel_us / 1e3,
        "device_busy_share": kernel_us / 1e3 / wall_ms,
        "top_kernels_ms": [[k[:96], v / 1e3] for k, v, _ in by_name[:8]]}
    del captured["pool"], pool_f
    return serve, eng, prefills[0]


def logit_check(cfg, got, want, what):
    """Real rows, real vocabulary (padded vocab rows carry a -1e30 bias):
    max abs error within STEP_TOL of the largest logit."""
    got, want = got[:, :cfg.vocab_size], want[:, :cfg.vocab_size]
    if not (got.isfinite().all() and want.isfinite().all()):
        fail(f"{cfg.name}: non-finite logits in the {what} comparison")
    err = (got - want).abs().max().item()
    m = want.abs().max().item()
    if err > STEP_TOL * m:
        fail(f"{cfg.name} {what}: max err {err} vs max {m}")
    return {"max_abs_err": err, "max_abs_logit": m, "tol_rel": STEP_TOL,
            "same_top1": int((got.argmax(-1) == want.argmax(-1)).sum()),
            "rows_compared": int(got.shape[0])}


def prefill_branch_check(eng, cfg, captured):
    """The captured flash-path prefill group run again with chunked
    attention (``attn_q_chunk=512``): the same logits within bf16
    tolerance."""
    import torch
    tokens, vision, last_idx, flash_logits = captured
    eng.cfg = dataclasses.replace(cfg, attn_q_chunk=512)
    try:
        chunked, _ = eng._prefill(tokens, vision, last_idx)
    finally:
        eng.cfg = cfg
    torch.cuda.synchronize()
    out = logit_check(cfg, flash_logits, chunked, "flash vs chunked prefill")
    out["batch"], out["width"] = int(tokens.shape[0]), int(tokens.shape[1])
    return out


def prefill_breakdown(eng, captured):
    """Where one flash-path prefill call's time goes: wall time (host
    clock, synchronized, median of 3) against the card's kernel time, by
    kernel."""
    import torch
    tokens, vision, last_idx, _ = captured

    def call():
        eng._prefill(tokens, vision, last_idx)
        torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        walls.append(time.perf_counter() - t0)
    kernel_us, by_name, _ = device_time(call)
    wall_ms = sorted(walls)[1] * 1e3
    flash_us = sum(us for k, us, _ in by_name if "flash_attention" in k)
    return {"batch": int(tokens.shape[0]), "width": int(tokens.shape[1]),
            "wall_ms": wall_ms, "device_ms": kernel_us / 1e3,
            "device_busy_share": kernel_us / 1e3 / wall_ms,
            "flash_kernel_ms": flash_us / 1e3,
            "top_kernels_ms": [[k[:96], us / 1e3]
                               for k, us, _ in by_name[:8]]}


def time_fused(sm, cfg, eng):
    """Timings of the three fused-decode kernels at cohort size 4 over the
    served weights (the first TIME_LAYERS[cfg] layers, rotated)."""
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels.fused_decode import ops, ref
    from repro_torch.models import decoder as dec
    torch = sm.torch
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    L = cfg.n_layers
    n_rot = TIME_LAYERS[cfg.name]
    layers = [dec.layer_slice(eng.params["layers"], i)[0]
              for i in range(n_rot)]
    h4 = sm.randn(TIME_BC, 1, D)
    x2 = h4.reshape(TIME_BC, D)

    def _b(t):
        return dequantize(t) if not torch.is_tensor(t) else t
    qkv_in = [(m["wq"], m["wk"], m["wv"], *(_b(m[b]) for b in
                                            ("bq", "bk", "bv")))
              for m in (lay["mixer"] for lay in layers)]
    dense_qkv = [torch.cat([dequantize(w).reshape(D, -1) for w in a[:3]], 1)
                 for a in qkv_in]
    bias_qkv = [torch.cat([b.reshape(-1) for b in a[3:]]) for a in qkv_in]
    rec = {}
    with torch.no_grad():
        t_k = timed(lambda i: ops.fused_qkv(h4, *qkv_in[i]), n_rot)
        t_p = timed(lambda i: ref.ref_fused_qkv(h4, *qkv_in[i]), n_rot)
        t_l = timed(lambda i: torch.addmm(
            bias_qkv[i], x2, torch.cat([dequantize(qkv_in[i][j]).reshape(
                D, -1) for j in range(3)], 1)), n_rot)
        t_d = timed(lambda i: torch.addmm(bias_qkv[i], x2, dense_qkv[i]),
                    n_rot)
        w_bytes = sum(w.codes.numel() * 4 + w.scales.numel() * 4
                      for w in qkv_in[0][:3])
        n_out = (H + 2 * KV) * hd
        byt = w_bytes + 2 * (TIME_BC * D + n_out + TIME_BC * n_out)
        rec["fused_qkv"] = (t_k, t_p, t_l, t_d, byt,
                            2 * TIME_BC * D * n_out)
        del dense_qkv

        ffn = [lay["ffn"] for lay in layers]
        dense_ffn = [tuple(dequantize(f[w]) for w in ("w_up", "w_gate",
                                                      "w_down")) for f in ffn]

        def mlp_lib(i, dense=False):
            up, gate, down = dense_ffn[i] if dense else (
                dequantize(ffn[i]["w_up"]), dequantize(ffn[i]["w_gate"]),
                dequantize(ffn[i]["w_down"]))
            return torch.matmul(torch.nn.functional.silu(x2 @ gate)
                                * (x2 @ up), down)
        t_k = timed(lambda i: ops.fused_mlp(h4, ffn[i]["w_up"],
                                            ffn[i]["w_down"],
                                            ffn[i]["w_gate"], act="swiglu"),
                    n_rot)
        t_p = timed(lambda i: ref.ref_fused_mlp(h4, ffn[i]["w_up"],
                                                ffn[i]["w_down"],
                                                ffn[i]["w_gate"],
                                                act="swiglu"), n_rot)
        t_l = timed(lambda i: mlp_lib(i), n_rot)
        t_d = timed(lambda i: mlp_lib(i, dense=True), n_rot)
        del dense_ffn
        w_bytes = sum(ffn[0][w].codes.numel() * 4 + ffn[0][w].scales.numel()
                      * 4 for w in ("w_up", "w_gate", "w_down"))
        rec["fused_mlp"] = (t_k, t_p, t_l, t_d, w_bytes + 2 * 2 * TIME_BC * D,
                            2 * TIME_BC * 3 * D * F)

        kp, vp = eng.slots.pool[0]
        nb, bs = kp.shape[1], kp.shape[2]
        k_rows, v_rows = sm.randn(L, TIME_BC, KV, hd), sm.randn(L, TIME_BC,
                                                                KV, hd)
        blk = torch.arange(TIME_BC, dtype=torch.int32, device=sm.dev) * 7 % nb
        off = torch.arange(TIME_BC, dtype=torch.int32, device=sm.dev) * 5 % bs
        g_idx = torch.arange(L, device=sm.dev)[:, None].expand(L, TIME_BC)
        b_idx = blk.long()[None].expand(L, TIME_BC)
        o_idx = off.long()[None].expand(L, TIME_BC)
        t_k = timed(lambda i: ops.kv_scatter(blk, off, k_rows, v_rows, kp,
                                             vp), 1)
        t_p = timed(lambda i: ref.ref_kv_scatter(blk, off, k_rows, v_rows,
                                                 kp, vp), 1)
        t_l = timed(lambda i: (kp.index_put_((g_idx, b_idx, o_idx), k_rows),
                               vp.index_put_((g_idx, b_idx, o_idx), v_rows)),
                    1)
        rec["kv_row_scatter"] = (t_k, t_p, t_l, None,
                                 2 * 2 * (2 * L * TIME_BC * KV * hd)
                                 + 2 * 4 * TIME_BC, 0)
    return rec


def time_flash(sm):
    """The flash kernel, its plain version and SDPA (GQA through
    ``enable_gqa``) at Qwen2-VL's prefill shape."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     ref_attention)
    B, Sq, Sk, H, KV, hd, causal = FLASH_TIME_SHAPE
    q = sm.randn(B, Sq, H, hd)
    k, v = sm.randn(B, Sk, KV, hd), sm.randn(B, Sk, KV, hd)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        t_k = timed(lambda i: flash_attention(q, k, v, causal=causal), 1,
                    iters=20)
        t_p = timed(lambda i: ref_attention(q, k, v, causal=causal), 1,
                    iters=5)
        t_l = timed(lambda i: Fn.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 1, iters=20)
    byt = 2 * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    pairs = Sq * (Sq + 1) // 2 if causal and Sq == Sk else Sq * Sk
    fl = 4 * B * H * hd * pairs            # q.k and p.v, keys each row sees
    return t_k, t_p, t_l, None, byt, fl


def requests(cfg, specs, seed):
    """Requests of ``specs`` ((vision tokens, images, repeat-of index or
    None)): one placeholder token per vision token, then 16 text tokens;
    16 new tokens each."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for rid, (n_vis, n_img, repeat) in enumerate(specs):
        feats = (reqs[repeat].vision_feats.copy() if repeat is not None
                 else (rng.standard_normal((1, n_vis, cfg.vision_feat_dim))
                       * 0.02).astype(np.float32))
        text = rng.integers(3, cfg.vocab_size - 1, 16).astype(np.int32)
        reqs.append(Request(rid=rid, tokens=np.concatenate(
            [np.zeros(n_vis, np.int32), text]), vision_feats=feats,
            n_images=n_img, max_new_tokens=16))
    return reqs


def free():
    """Return what the dropped objects held to the card."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_decode import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build: one nvcc per library, all at once ------------------------
    t0 = time.perf_counter()
    build.build_all({m.LIBRARY: m.SOURCES for m in (K, FK)})
    for m in (K, FK):
        m.library()
    build_s = time.perf_counter() - t0
    ptxas = {m.LIBRARY: [ln.strip() for ln in build.build_log(
        m.LIBRARY, m.SOURCES).splitlines() if "Used" in ln or "spill" in ln][
        :40] for m in (K, FK)}
    print(json.dumps({"build": {"seconds": round(build_s, 3),
                                "ptxas": ptxas}}))

    # -- 2. kernel checks at the served shapes ------------------------------
    sm = Smoke()
    llava = get_config("llava-onevision-0.5b")
    qwen = dataclasses.replace(get_config("qwen2-vl-7b"), attn_q_chunk=0)
    sm.check_fused(llava, (1, 2, 4, 8))
    sm.check_fused(qwen, (1, 2, 4))
    sm.check_flash()
    free()
    print(json.dumps({"kernel_checks": {
        "fused_bc": {llava.name: [1, 2, 4, 8], qwen.name: [1, 2, 4]},
        "flash_shapes": [list(s) for s in FLASH_SHAPES],
        "max_abs_err": sm.errs, "tol_rel": KERNEL_TOL,
        "flash_worst_row_err_over_row_max": sm.worst_row_ratio,
        "kv_pool_blocks": {a: N_SLOTS * n // BLOCK_SIZE
                           for a, n in MAX_LEN.items()}}}))

    # -- 3. serve LLaVA-OneVision-0.5B --------------------------------------
    serves, timings = {}, {}
    serve, eng, _ = serve_path(sm, llava, requests(
        llava, [(729, 1, None), (196, 1, None), (729, 1, 0), (196, 1, None)],
        seed=0))
    print(json.dumps({"serve": serve}))
    serves[llava.name] = serve
    timings[llava.name] = time_fused(sm, llava, eng)
    del eng
    free()

    # -- 4. serve Qwen2-VL-7B, prefill through the flash kernel -------------
    serve, eng, captured = serve_path(sm, qwen, requests(
        qwen, [(1024, 1, None), (1024, 1, 0), (256, 1, None),
               (1024, 4, None)], seed=1))
    serve["prefill_branch_check"] = prefill_branch_check(eng, qwen, captured)
    serve["prefill_breakdown"] = prefill_breakdown(eng, captured)
    print(json.dumps({"serve": serve}))
    serves[qwen.name] = serve
    timings[qwen.name] = time_fused(sm, qwen, eng)
    del eng, captured
    free()

    # -- 5. the flash kernel at the Qwen2-VL prefill shape ------------------
    flash_t = time_flash(sm)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    launch_key = {"fused_qkv": "fused_qkv", "fused_mlp": "fused_mlp",
                  "kv_row_scatter": "kv_scatter",
                  "flash_attention": "flash_attention"}
    replaces = {
        "fused_qkv": "src/repro/kernels/fused_decode/kernel.py:92",
        "fused_mlp": "src/repro/kernels/fused_decode/kernel.py:138",
        "kv_row_scatter": "src/repro/kernels/fused_decode/kernel.py:174",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:55"}

    def numbers(t):
        t_k, t_p, t_l, t_d, byt, fl = t
        b_ms, b_by = bound(byt, fl)
        out = {"ms": dev_or_call(t_k), "plain_ms": dev_or_call(t_p),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": dev_or_call(t_l),
               "ms_source": ("profiler device time" if t_k[0] is not None
                             else "CUDA events per call"),
               "device_kernels_per_call": t_k[2], "call_ms": t_k[1],
               "plain_call_ms": t_p[1], "library_call_ms": t_l[1],
               "bytes": byt, "flops": fl}
        if t_d is not None:
            out["dense_bf16_matmul_ms"] = dev_or_call(t_d)
        return out

    kernels = []
    for name in ("fused_qkv", "fused_mlp", "kv_row_scatter",
                 "flash_attention"):
        by_path = {a: s["launches"][launch_key[name]]
                   for a, s in serves.items()}
        entry = {"name": name, "route": "cuda",
                 "source": ("src/repro_torch/csrc/flash_attention.cu"
                            if name == "flash_attention" else
                            "src/repro_torch/csrc/fused_decode.cu"),
                 "replaces": replaces[name],
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": sm.errs[name]}
        if name == "flash_attention":
            entry.update(numbers(flash_t))
            entry["shape"] = dict(zip(("B", "Sq", "Sk", "H", "KV", "hd",
                                       "causal"), FLASH_TIME_SHAPE))
            entry["library"] = "F.scaled_dot_product_attention(enable_gqa)"
        else:
            entry.update(numbers(timings[llava.name][name]))
            entry["bc"] = TIME_BC
            entry["shape_of"] = llava.name
            entry["at_" + qwen.name] = numbers(timings[qwen.name][name])
        kernels.append(entry)
    print(smi.stdout.strip())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

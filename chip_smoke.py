#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build the CUDA kernels of ``src/repro_torch/csrc`` with nvcc (timed);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (LLaVA-OneVision-0.5B: D=896, H=14, KV=2, hd=64, d_ff=4864,
   L=24, block 64; cohort rows 1/2/4/8; q4 group 32, bf16): outputs
   within 2e-2 of the plain version's largest magnitude, the in-kernel
   unpack bit-equal to ``dequantize`` (one-hot activations), the KV-row
   scatter bit-exact with sentinel rows writing nothing;
3. serve LLaVA-OneVision-0.5B at full width through ``ServingEngine``:
   random weights from ``init_params`` (seed 0) on the card, packed by
   ``quantize_tree(nanomind-serve)``; four requests (full-resolution and
   thumbnail images, one shared payload, 16-token text); launch counts
   of every kernel are reset just before and read just after the run;
   one captured cohort state is decoded again by the fused and by the
   composed (plain) step, which must agree within bf16 tolerance;
4. time each kernel, its plain version and a PyTorch library call at
   cohort size 4, rotating over the 24 layers' weights (so the weights
   come from device memory, not the 50 MB L2), beside the bound the
   card's published rates set (3.35 TB/s, 989 TFLOP/s bf16).

Output: build and serve lines, the ``nvidia-smi`` name/power-limit line,
one JSON line ``{"kernels": [...]}``, and as the last line
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16, published
BC = (1, 2, 4, 8)
TIME_BC = 4
# kernel vs plain version, bf16 outputs: both accumulate in fp32 in
# different orders, so an output may differ by one bf16 rounding step
KERNEL_TOL = 2e-2
# fused vs composed cohort step (logits): per-layer bf16 differences
# compound over 24 layers; the port's bf16 model tests use 5e-2
STEP_TOL = 5e-2


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def device_time(fn):
    """Run ``fn`` under the profiler; return (total kernel microseconds on
    the card, [(kernel name, microseconds)] largest first, number of
    kernels run).  Summed over the profiler's CUDA-side events only, so no
    kernel counts twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    rows = sorted(((e.key, e.self_device_time_total) for e in events),
                  key=lambda r: -r[1])
    return sum(us for _, us in rows), rows, sum(e.count for e in events)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import (PROFILES, QuantSpec, dequantize,
                                           quantize, quantize_tree)
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_decode import kernel as K
    from repro_torch.kernels.fused_decode import ops, ref
    from repro_torch.models import decoder as dec
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServingEngine

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    K.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log("fused_decode",
                                                  K.SOURCES).splitlines()
             if "Used" in ln or "spill" in ln]
    print(json.dumps({"build": {"seconds": round(build_s, 3),
                                "ptxas": ptxas[:40]}}))

    cfg = get_config("llava-onevision-0.5b")
    D, H, KV, hd, F, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff, cfg.n_layers)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    spec = QuantSpec(4, group_size=32)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(bf16)

    def max_err(got, want):
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        return err, want.abs().max().item()

    # -- 2. kernel checks at the main path's shapes -------------------------
    errs = {"fused_qkv": 0.0, "fused_mlp": 0.0, "kv_row_scatter": 0.0}
    wq, wk, wv = (quantize(randn(D, n, hd, scale=D ** -0.5), spec)
                  for n in (H, KV, KV))
    bq, bk, bv = randn(H, hd, scale=0.1), randn(KV, hd, scale=0.1), \
        randn(KV, hd, scale=0.1)
    w_up, w_gate = (quantize(randn(D, F, scale=D ** -0.5), spec)
                    for _ in range(2))
    w_down = quantize(randn(F, D, scale=F ** -0.5), spec)
    for bc in BC:
        h = randn(bc, 1, D)
        got = ops.fused_qkv(h, wq, wk, wv, bq, bk, bv)
        want = ref.ref_fused_qkv(h, wq, wk, wv, bq, bk, bv)
        for g, w in zip(got, want):
            err, m = max_err(g, w)
            if not (g.shape == w.shape and err <= KERNEL_TOL * m):
                fail(f"fused_qkv bc={bc}: max err {err} vs max {m}")
            errs["fused_qkv"] = max(errs["fused_qkv"], err)
        got = ops.fused_mlp(h, w_up, w_down, w_gate, act="swiglu")
        want = ref.ref_fused_mlp(h, w_up, w_down, w_gate, act="swiglu")
        err, m = max_err(got, want)
        if not (got.shape == want.shape and err <= KERNEL_TOL * m):
            fail(f"fused_mlp bc={bc}: max err {err} vs max {m}")
        errs["fused_mlp"] = max(errs["fused_mlp"], err)
    for k in (0, 451, D - 1):              # the unpack, bit for bit
        h = torch.zeros((1, 1, D), dtype=bf16, device=dev)
        h[0, 0, k] = 1.0
        for g, w in zip(ops.fused_qkv(h, wq, wk, wv), (wq, wk, wv)):
            if not torch.equal(g[0, 0].view(torch.int16),
                               dequantize(w)[k].view(torch.int16)):
                fail(f"fused_qkv one-hot row {k} differs from dequantize")
    n_blocks, bs = 128, 64
    k_pool = randn(L, n_blocks, bs, KV, hd)
    v_pool = randn(L, n_blocks, bs, KV, hd)
    for bc in BC:
        k_rows, v_rows = randn(L, bc, KV, hd), randn(L, bc, KV, hd)
        blk = torch.randperm(n_blocks, generator=gen, device=dev)[:bc].to(
            torch.int32)
        off = torch.randint(0, bs, (bc,), generator=gen, device=dev,
                            dtype=torch.int32)
        if bc > 1:
            blk[-1] = n_blocks                      # a padded sentinel row
        want = ref.ref_kv_scatter(blk, off, k_rows, v_rows, k_pool.clone(),
                                  v_pool.clone())
        got = ops.kv_scatter(blk, off, k_rows, v_rows, k_pool, v_pool)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                fail(f"kv_row_scatter bc={bc}: pools differ")
    torch.cuda.synchronize()
    print(json.dumps({"kernel_checks": {"bc": list(BC), "max_abs_err": errs,
                                        "tol_rel": KERNEL_TOL}}))

    # -- 3. serve the main path ---------------------------------------------
    t0 = time.perf_counter()
    with torch.no_grad():
        params = quantize_tree(init_params(cfg, device=dev, seed=0),
                               PROFILES["nanomind-serve"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, params, n_slots=4, max_len=2048, block_size=64,
                        device=dev)
    if not eng.use_fused:
        fail("the engine did not select the fused decode step")
    rng = np.random.default_rng(0)

    def request(rid, n_vis, feats=None):
        if feats is None:
            feats = (rng.standard_normal((1, n_vis, cfg.vision_feat_dim))
                     * 0.02).astype(np.float32)
        text = rng.integers(3, cfg.vocab_size - 1, 16).astype(np.int32)
        toks = np.concatenate([np.zeros(n_vis, np.int32), text])
        return Request(rid=rid, tokens=toks, vision_feats=feats,
                       max_new_tokens=16)

    reqs = [request(0, 729), request(1, 196)]
    reqs += [request(2, 729, reqs[0].vision_feats.copy()), request(3, 196)]
    captured = {}
    decode = eng._decode

    def capturing_decode(tokens, lengths, slot_ids, tables):
        # keep one multi-row cohort state (inputs + pool before the step)
        if "args" not in captured and int((tables[:, 0] <
                                           eng.slots.n_blocks).sum()) >= 2:
            captured["args"] = tuple(t.clone() for t in
                                     (tokens, lengths, slot_ids, tables))
            captured["pool"] = tuple(tuple(t.clone() for t in pos)
                                     for pos in eng.slots.pool)
        return decode(tokens, lengths, slot_ids, tables)
    eng._decode = capturing_decode
    for r in reqs:
        eng.submit(r)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with eng:
        done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    decode_steps = sum(1 for e in eng.trace if e.event == "decode_step")
    errors = [r for r in done if r.error is not None]
    if len(done) != len(reqs) or errors:
        fail(f"requests failed: {[repr(r.error) for r in errors]}")
    eng.slots.check_block_invariants()
    tstats = eng.tabm.stats
    if tstats["writes"] != tstats["reads"] or tstats["shares"] != 1:
        fail(f"TABM writes/reads/shares {tstats}")
    for r in done:
        if not (len(r.out_tokens) == r.max_new_tokens and all(
                0 <= t < cfg.vocab_size for t in r.out_tokens)):
            fail(f"request {r.rid} tokens {r.out_tokens}")
    if not (launches["fused_qkv"] == launches["fused_mlp"] == L * decode_steps
            and launches["kv_scatter"] == decode_steps and decode_steps > 0):
        fail(f"launch counts {launches} for {decode_steps} decode steps")
    spans = eng.probe.samples()
    pre = [s for s in spans if s.brick == "decoder" and s.phase == "prefill"]
    decs = [s for s in spans if s.brick == "decoder" and s.phase == "decode"]
    serve = {"requests": len(done), "decode_steps": decode_steps,
             "decoded_tokens": eng.stats.decoded_tokens,
             "setup_s": round(setup_s, 3), "serve_s": round(serve_s, 3),
             "prefill_calls": len(pre),
             "prefill_ms": [round(s.dt * 1e3, 3) for s in pre],
             "prefill_tokens": [s.tokens for s in pre],
             "decode_step_ms_mean": round(1e3 * sum(s.dt for s in decs)
                                          / max(1, len(decs)), 3),
             "decode_tok_s": round(sum(s.tokens for s in decs)
                                   / max(1e-9, sum(s.dt for s in decs)), 3),
             "tabm": tstats, "launches": launches}

    # fused vs composed on the captured cohort state
    if "args" not in captured:
        fail("no multi-row cohort state was captured")
    args = captured["args"]
    pool_f = tuple(tuple(t.clone() for t in pos) for pos in captured["pool"])
    kw = dict(block_size=eng.slots.block_size, paged=eng.slots.paged)
    with torch.no_grad():
        lf, _ = ops.cohort_step(eng.params, cfg, *args, pool_f,
                                use_fused=True, **kw)
        lr, _ = ref.ref_cohort_step(eng.params, cfg, *args,
                                    captured["pool"], **kw)
    rows = int((args[3][:, 0] < eng.slots.n_blocks).sum())
    # real rows, real vocabulary (padded vocab rows carry a -1e30 bias)
    lf, lr = lf[:rows, :cfg.vocab_size], lr[:rows, :cfg.vocab_size]
    if not (torch.isfinite(lf).all() and torch.isfinite(lr).all()):
        fail("non-finite logits in the cohort comparison")
    step_err = (lf - lr).abs().max().item()
    m = lr.abs().max().item()
    if step_err > STEP_TOL * m:
        fail(f"fused vs composed step: max err {step_err} vs max {m}")
    serve["cohort_check"] = {"rows": rows, "max_abs_err": step_err,
                             "max_abs_logit": m, "tol_rel": STEP_TOL,
                             "same_top1": int((lf.argmax(-1) ==
                                               lr.argmax(-1)).sum())}

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
        "top_kernels_ms": [[k[:96], v / 1e3] for k, v in by_name[:8]]}
    print(json.dumps({"serve": serve}))

    # -- 4. timing at cohort size 4, rotating over the 24 layers ------------
    layers = [dec.layer_slice(eng.params["layers"], i)[0] for i in range(L)]
    h4 = randn(TIME_BC, 1, D)

    def timed(fn, iters=96):
        """(device ms, call ms, device kernels) per call: the card's kernel
        time summed from the profiler's CUDA events (None if it recorded
        none), wall time per call between CUDA events around the loop —
        host overhead included, which dominates calls of a few
        microseconds — and the kernels one call runs on the card."""
        for i in range(L):
            fn(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i % L)
        stop.record()
        torch.cuda.synchronize()
        call_ms = start.elapsed_time(stop) / iters

        def loop():
            for i in range(iters):
                fn(i % L)
            torch.cuda.synchronize()
        dev_us, _, n_kernels = device_time(loop)
        return ((dev_us / 1e3 / iters if dev_us > 0 else None), call_ms,
                n_kernels / iters)

    def mix(i):
        return layers[i]["mixer"]

    def dense_cat(i):
        m = mix(i)
        return torch.cat([dequantize(m[w]).reshape(D, -1)
                          for w in ("wq", "wk", "wv")], 1)

    def bias_cat(i):
        m = mix(i)
        return torch.cat([(dequantize(m[b]) if not torch.is_tensor(m[b])
                           else m[b]).reshape(-1) for b in ("bq", "bk", "bv")])

    def qkv_args(i):
        m = mix(i)
        return (m["wq"], m["wk"], m["wv"],
                *(dequantize(m[b]) if not torch.is_tensor(m[b]) else m[b]
                  for b in ("bq", "bk", "bv")))

    qkv_in = [qkv_args(i) for i in range(L)]
    dense_qkv = [dense_cat(i) for i in range(L)]
    bias_qkv = [bias_cat(i) for i in range(L)]
    x2 = h4.reshape(TIME_BC, D)
    rec = []
    with torch.no_grad():
        t_k = timed(lambda i: ops.fused_qkv(h4, *qkv_in[i]))
        t_p = timed(lambda i: ref.ref_fused_qkv(h4, *qkv_in[i]))
        t_l = timed(lambda i: torch.addmm(
            bias_qkv[i], x2, torch.cat([dequantize(qkv_in[i][j]).reshape(
                D, -1) for j in range(3)], 1)))
        t_d = timed(lambda i: torch.addmm(bias_qkv[i], x2, dense_qkv[i]))
        w_bytes = sum(w.codes.numel() * 4 + w.scales.numel() * 4
                      for w in qkv_in[0][:3])
        n_out = (H + 2 * KV) * hd
        byt = w_bytes + 2 * (TIME_BC * D + n_out + TIME_BC * n_out)
        fl = 2 * TIME_BC * D * n_out
        rec.append(("fused_qkv", "src/repro/kernels/fused_decode/kernel.py:92",
                    t_k, t_p, t_l, t_d, byt, fl))

        ffn = [layers[i]["ffn"] for i in range(L)]
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
                                            ffn[i]["w_gate"], act="swiglu"))
        t_p = timed(lambda i: ref.ref_fused_mlp(h4, ffn[i]["w_up"],
                                                ffn[i]["w_down"],
                                                ffn[i]["w_gate"],
                                                act="swiglu"))
        t_l = timed(lambda i: mlp_lib(i))
        t_d = timed(lambda i: mlp_lib(i, dense=True))
        w_bytes = sum(ffn[0][w].codes.numel() * 4 + ffn[0][w].scales.numel()
                      * 4 for w in ("w_up", "w_gate", "w_down"))
        byt = w_bytes + 2 * 2 * TIME_BC * D
        fl = 2 * TIME_BC * 3 * D * F
        rec.append(("fused_mlp", "src/repro/kernels/fused_decode/kernel.py:138",
                    t_k, t_p, t_l, t_d, byt, fl))

        kp, vp = eng.slots.pool[0]
        nb = kp.shape[1]
        k_rows, v_rows = randn(L, TIME_BC, KV, hd), randn(L, TIME_BC, KV, hd)
        blk = torch.arange(TIME_BC, dtype=torch.int32, device=dev) * 7 % nb
        off = torch.arange(TIME_BC, dtype=torch.int32, device=dev) * 5 % bs
        g_idx = torch.arange(L, device=dev)[:, None].expand(L, TIME_BC)
        b_idx = blk.long()[None].expand(L, TIME_BC)
        o_idx = off.long()[None].expand(L, TIME_BC)
        t_k = timed(lambda i: ops.kv_scatter(blk, off, k_rows, v_rows, kp,
                                             vp))
        t_p = timed(lambda i: ref.ref_kv_scatter(blk, off, k_rows, v_rows,
                                                 kp, vp))
        t_l = timed(lambda i: (kp.index_put_((g_idx, b_idx, o_idx), k_rows),
                               vp.index_put_((g_idx, b_idx, o_idx), v_rows)))
        byt = 2 * 2 * (2 * L * TIME_BC * KV * hd) + 2 * 4 * TIME_BC
        rec.append(("kv_row_scatter",
                    "src/repro/kernels/fused_decode/kernel.py:174",
                    t_k, t_p, t_l, None, byt, 0))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    kernels = []
    launch_key = {"fused_qkv": "fused_qkv", "fused_mlp": "fused_mlp",
                  "kv_row_scatter": "kv_scatter"}
    def dev_or_call(t):
        return t[0] if t[0] is not None else t[1]

    for name, replaces, t_k, t_p, t_l, t_d, byt, fl in rec:
        bound = max(byt / HBM_BYTES_PER_S, fl / BF16_FLOPS_PER_S) * 1e3
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/csrc/fused_decode.cu",
                 "replaces": replaces,
                 "launches": launches[launch_key[name]],
                 "max_abs_err": errs[name], "ms": dev_or_call(t_k),
                 "plain_ms": dev_or_call(t_p), "bound_ms": bound,
                 "bound_by": ("bytes" if byt / HBM_BYTES_PER_S
                              >= fl / BF16_FLOPS_PER_S else "operations"),
                 "library_ms": dev_or_call(t_l),
                 "ms_source": ("profiler device time" if t_k[0] is not None
                               else "CUDA events per call"),
                 "device_kernels_per_call": t_k[2],
                 "call_ms": t_k[1], "plain_call_ms": t_p[1],
                 "library_call_ms": t_l[1], "bc": TIME_BC, "bytes": byt,
                 "flops": fl}
        if t_d is not None:
            entry["dense_bf16_matmul_ms"] = dev_or_call(t_d)
        kernels.append(entry)
    print(smi.stdout.strip())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

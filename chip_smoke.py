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
     block_size blocks); their fp32 instances at both widths, cohorts
     1/2/4/8, q4 and dense fp32 weights, within 1e-5 of the largest
     plain magnitude;
   - the flash-attention kernel at LLaVA's prefill shape (B 1, S 1024,
     H 14, KV 2, hd 64), Qwen2-VL's (B 2, S 2048, H 28, KV 4, hd 128), a
     ragged S = 777, and non-causal with Sq != Sk; every output row
     (b, i, h) within 2e-2 of that row's largest plain magnitude (a row
     over n keys is ~n^-1/2 in size, so one tolerance over the whole
     output would be loose for the long rows); then the reference kernel
     tests' grid (B, S, H, KV, hd of (2, 128, 4, 2, 32), (1, 256, 8, 8,
     64), (2, 256, 6, 2, 32), (1, 128, 32, 4, 16)), causal and not, and
     hd 160 at Qwen2-VL's head counts, in bf16 (rows as above) and fp32
     (within the reference's 1e-4 of the largest plain magnitude);
   - the cache-row-update kernel bit for bit against its plain version:
     the reference tests' shapes (4, 64, 2, 16), (2, 128, 8, 32), (1,
     256, 4, 64) with a per-row index, a scalar index and an
     out-of-range row, and layer slices of a stacked cache at LLaVA's
     widths (24 x 4 x 2048 x 2 x 64), bf16 and fp32 caches and rows;
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
   read just after the run, and read around every decode step (every
   bf16 GEMM and flash launch must take the warp-specialised wgmma
   kernel, every fp32 one the GEMM's tile kernel and the split-TF32 flash
   kernel, every fused-MLP launch and every fused-QKV device kernel the
   split-K GEMV, one a QKV call: the counts per route show it); every
   fused-QKV and fused-MLP call of one captured decode step is held
   against ``ref_fused_qkv`` / ``ref_fused_mlp`` on its own inputs, each
   cohort row within 2e-2 (bf16) or 1e-5 (fp32) of its largest plain
   value; one
   captured cohort state is decoded again by the fused and by the plain
   composed step (``ref_cohort_step``), which must agree within bf16
   tolerance; for Qwen2-VL one captured prefill group runs again with
   chunked attention, whose logits must agree with the flash path's;
   3a. serve LLaVA-OneVision-0.5B again with the same weights and
   requests through the composed decode step (``use_fused=False``): every
   layer's new K and V rows written into the donated gathered caches by
   the cache-row-update kernel (48 launches a step) and the pool by one
   KV-row scatter; every row-update call of one step held bit for bit
   against the plain version on its own inputs; that step's logits
   against the fused step's and the plain step's on the same state
   (teacher-forced) within 5e-2, its pool equal to the plain step's;
   3b. serve LLaVA-OneVision-0.5B in fp32 with ``attn_q_chunk=0`` and the
   engine's default ``use_fused``: prefill through the fp32 flash kernel
   in every layer (each call held against the plain version within
   1e-4, kernel and plain each also against a float64 evaluation),
   decode through the fp32 fused kernels; the largest prefill
   group rerun through the plain versions (dense attention, dequantize +
   einsum) and a captured cohort state through ``ref_cohort_step`` give
   logits within 5e-2;
5. serve LLaVA-OneVision-0.5B with the paper's streaming linear
   attention (``attn_impl="linear"``) at full width and depth: the same
   weights, engine settings and four requests as phase 3, prefill
   through the linear-attention kernel in every layer (buckets 1024 and
   256), decode through the composed step over the slot-indexed (state,
   z) pool.  The kernel is first held against its plain version at B 2,
   S 1024, H 14, KV 2, hd 64, chunk 256 and at the ragged S 127, bf16 and
   fp32, without and with ``valid_len`` (one row at 700 or 100): state and
   z within 1e-4 of their largest magnitude, every output row (b, i, h)
   within 2e-2 (bf16) or 1e-4 (fp32) of that row's largest plain
   magnitude, padded rows exactly zero; then every kernel call of the
   serve on its own inputs, with the same gates.  The engine is held
   against the port's own model within 5e-2 of the largest logit, in bf16
   and on an fp32 instance of the full config: each request's first two
   decode steps against its unpadded prompt (the plain chunked form at a
   chunk that divides the prompt) plus ``lm_decode_step``; the 745- and
   212-token prompts padded to two widths give the same next-step
   logits; the largest prefill group rerun through the plain version
   gives the same logits.  The (state, z) pool's bytes stand beside the
   softmax LLaVA's paged pool at the same ``max_len``;
6. serve Mamba-2-1.3B the same way (text only): prefill through the SSD
   kernel in every layer, decode through the composed step over the
   slot-state pool; four requests of 1024, 1000, 300 and 100 tokens
   (four chunks of 256; padding 1000 -> 1024 and 300 -> 512; the
   one-chunk 128 bucket), 16 new tokens each, greedy.  The SSD kernel
   is first held against its plain version at B 2, S 2048, H 64, P 64,
   G 1, N 128, chunk 256 (bf16 x/B/C, fp32 dt: the tensor-core route;
   and the same inputs in fp32: the FFMA route): h_final within 1e-4
   (max abs err over max abs), every (b, h) head's y within 2e-2 of
   that head's largest plain |y|, and with dt = 0 past position 1000
   the state equal to the 1024-position call's; then every kernel call
   of the serve (each on the route of its dtype) (each layer of the 2 x 1024, 1 x 512 and one-chunk
   1 x 128 groups) against the plain version on its own inputs, with
   the same tolerances.  The engine is held against the port's own
   model: the 1024- and 100-token requests' first two decode steps
   against ``lm_prefill`` on the unpadded prompt plus
   ``lm_decode_step``; the 1000- and 300-token prompts prefilled padded
   to the next bucket and the one above give the same next-step logits;
   the largest prefill group rerun through the plain ``ssd_chunked``
   gives the same logits.  A second serve of the full config in fp32
   holds these within 5e-2 of the largest logit, the bf16 serve within
   0.5: in bf16 one rounding step grows through the 48 layers past 5e-2
   (kernel and plain SSD alike), which a rounding witness measures (the
   plain SSD with as many y elements moved by one bf16 step as the
   kernel's differ from it, against the plain SSD).  The fp32 serve's
   SSD calls are also held in the reference's own measure (max |y -
   plain y| over the call's largest plain |y|) within 1e-4, and the
   kernel and the plain version each against a float64 evaluation of
   the same inputs within 1e-4; the bf16 serve's y and h_final are
   reported against a float64 evaluation beside them;
7. time each kernel, its plain version and a PyTorch library call: the
   fused-decode kernels at cohort size 4 rotating over the layers'
   weights (so the weights come from device memory, not the 50 MB L2)
   at both models' widths (and the fp32 instances at LLaVA's over serve
   3b's weights), the flash kernel at Qwen2-VL's prefill shape and head
   counts at hd 64, 128 and 160 beside SDPA (and the fp32 instance at
   LLaVA's, beside SDPA in fp32, with its route's own bound: three TF32
   products at 495 TFLOP/s), the packed-weight GEMM at every distinct
   served projection shape (Qwen2-VL and Mamba-2 at 2048 rows, LLaVA at
   1024) beside dequantize + ``matmul`` and ``matmul`` on a dense weight,
   the flash and GEMM times both from the profiler and from CUDA events
   around the loop, the cache-row-update
   kernel at the composed step's shape (a layer of a cohort-4 gathered
   context, beside ``index_put_``),
   the SSD kernel at its check shape in bf16 and fp32, with the device
   ms of its four phases (no single PyTorch call computes SSD), the
   linear-attention kernel at its check shape (nor that);
   beside the bound the card's published rates set (3.35 TB/s, 989
   TFLOP/s bf16, 67 TFLOP/s fp32 for the SSD's and the linear
   attention's fp32 arithmetic, whose operations ``ssd_work`` and
   ``linear_attention_work`` count; beside it the SSD's bf16 route's
   own count, ``ssd_mma_bound``), the fused-decode kernels' effective
   GB/s.

Output: build, check and serve lines, the ``nvidia-smi`` name/power-limit
line, one JSON line ``{"kernels": [...]}``, and as the last line
``{"ok": true, "device": {...}}``.
"""
import contextlib
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
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 (SIMT FFMA), published
TF32_FLOPS_PER_S = 495e12        # H100 SXM dense TF32, published
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
MAX_LEN = {"llava-onevision-0.5b": 2048, "qwen2-vl-7b": 4096,
           "mamba2-1.3b": 2048}
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
# the fp32 instance's timing shape: serve 3b's prefill (LLaVA, S 1024)
FLASH_FP32_TIME_SHAPE = FLASH_SHAPES[0]
# the reference kernel tests' flash grid (tests/test_kernels.py:163-198):
# (B, S, H, KV, hd), each causal and not, in bf16 and fp32
FLASH_REF_GRID = ((2, 128, 4, 2, 32), (1, 256, 8, 8, 64),
                  (2, 256, 6, 2, 32), (1, 128, 32, 4, 16))
# hd 160 (stablelm-12b) at Qwen2-VL's head counts: (B, Sq, Sk, H, KV, hd,
# causal)
FLASH_HD160 = ((2, 1024, 1024, 28, 4, 160, True),
               (1, 300, 777, 28, 4, 160, False))
# fp32 kernels vs plain, max |err| over the largest plain magnitude: the
# reference's flash bound; the port's fp32 GEMM gate for the GEMVs (both
# keep fp32 throughout, in other summation orders)
FLASH_FP32_TOL = 1e-4
FUSED_FP32_TOL = 1e-5
# the cache-row-update checks: the reference tests' (B, S, KV, hd)
CU_SHAPES = ((4, 64, 2, 16), (2, 128, 8, 32), (1, 256, 4, 64))
# the keys of serves 3a and 3b in the kernels line's launches_by_path
COMPOSED_PATH = "llava-onevision-0.5b/composed"
FP32_PATH = "llava-onevision-0.5b/fp32"
# the SSD kernel's check and timing shape: (B, S, H, P, G, N, chunk),
# Mamba-2-1.3B's widths at a 2 x 2048 prefill
SSD_SHAPE = (2, 2048, 64, 64, 1, 128, 256)
# SSD kernel vs plain: h_final (fp32 in both) within 1e-4 of its
# largest magnitude; y per (b, h) head within KERNEL_TOL of its largest
SSD_H_TOL = 1e-4
# Mamba-2 logit checks of the bf16 serve.  Random-weight Mamba-2 in bf16
# grows a one-step rounding difference through its 48 layers' exp(dt A)
# decay to 6-28 % of the largest logit (a bf16 rounding witness in the
# smoke measures it), so STEP_TOL gates the fp32 serve and this bound,
# under 2x the largest bf16 reading, the bf16 one: logits of unrelated
# states differ by more than the largest logit
BF16_LOGIT_TOL = 0.5
# Mamba-2 requests: prompt lengths, 16 new tokens each
MAMBA_PROMPTS = (1024, 1000, 300, 100)
# the fp32 serve's SSD y in the reference's measure (max abs err over the
# call's largest |y|, tests/test_kernels.py), kernel vs plain and each
# against a float64 evaluation
SSD_Y_FP32_TOL = 1e-4
# the linear-attention kernel's check shapes (B, S, H, KV, hd, chunk,
# valid_len or None): LLaVA-OneVision-0.5B's widths at its 2 x 1024
# prefill, and the ragged one-chunk 127 of a short engine's bucket
LA_SHAPE = (2, 1024, 14, 2, 64, 256)
LA_CHECKS = ((2, 1024, 14, 2, 64, 256, None),
             (2, 1024, 14, 2, 64, 256, (700, 1024)),
             (2, 127, 14, 2, 64, 256, None),
             (2, 127, 14, 2, 64, 256, (127, 100)))
# the key of the linear-attention serve in the kernels line's
# launches_by_path (its config keeps LLaVA's name)
LINEAR_PATH = "llava-onevision-0.5b/linear"
# kernel vs plain: state and z (fp32 in both) within 1e-4 of their
# largest magnitude; each output row within KERNEL_TOL (bf16) or 1e-4
# (fp32) of that row's largest plain magnitude
LA_STATE_TOL = 1e-4
LA_ROW_TOL = {"bfloat16": KERNEL_TOL, "float32": 1e-4}
# the packed-weight GEMM against its plain version, in the reference
# kernel tests' measure (max |err| over max |plain|,
# tests/test_kernels.py:43): a bf16 output may differ by one rounding
# step (both accumulate in fp32, in other orders), fp32 ones by the order
DG_TOL = {"bfloat16": 5e-3, "float32": 1e-5}
# the reference kernel tests' grid (tests/test_kernels.py:29-75): (M, K,
# N) at bits 2/4/8, group 64, bf16 and fp32
DG_NK_GRID = ((64, 512, 128), (8, 1024, 256), (130, 512, 200))
# rows of the "kn" checks at the served projection shapes (ragged)
DG_KN_ROWS = 1000
# the GEMM's timing shape: Qwen2-VL-7B's MLP up projection in a 1 x 2048
# prefill, (M, K, N), q4 g32, bf16
DG_TIME_SHAPE = (2048, 3584, 18944)
# projections a layer runs on packed weights: q, k, v, o, up, gate, down;
# Mamba-2's in_proj and out_proj
GEMMS_PER_LAYER = {"attn": 7, "linear": 7, "mamba": 2}
# the kernel (launch-count route) every served call of a dtype must take:
# bf16 the warp-specialised wgmma kernels, fp32 the GEMM's tile kernel and
# the split-TF32 flash kernel on the tensor cores
GEMM_ROUTE = {"bfloat16": "wgmma", "float32": "tile"}
FLASH_ROUTE = {"bfloat16": "wgmma", "float32": "tf32x3"}
# the SSD kernel's route by dtype: bf16 the tensor-core products (split
# fp32 operands), fp32 FFMA; every fused-MLP call and every fused-QKV
# device kernel takes the split-K GEMV
SSD_ROUTE = {"bfloat16": "mma", "float32": "simt"}
MLP_ROUTE = "gemv"
# the fused-MLP calls of a captured decode step against the plain
# version, each cohort row's max |err| over its largest plain value: one
# bf16 rounding step, or the fp32 GEMVs' gate
MLP_ROW_TOL = {"bfloat16": KERNEL_TOL, "float32": 1e-5}   # and the QKV's
# rows of each served model's largest prefill call: the GEMM's per-shape
# timings run every distinct projection shape at these rows
DG_SERVED_ROWS = {"qwen2-vl-7b": 2048, "llava-onevision-0.5b": 1024,
                  "mamba2-1.3b": 2048}
# the bf16 flash timings beside SDPA, (B, Sq, Sk, H, KV, hd, causal) at
# Qwen2-VL's head counts: hd 64 and 128 at its 2 x 2048 prefill, hd 160 at
# 2 x 1024 (FLASH_HD160's first shape)
FLASH_HD_TIMES = ((2, 2048, 2048, 28, 4, 64, True),
                  (2, 2048, 2048, 28, 4, 128, True),
                  (2, 1024, 1024, 28, 4, 160, True))


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


def bound(byt, fl, flops_per_s=BF16_FLOPS_PER_S):
    """(least ms on the card, what bounds it)."""
    t_b, t_f = byt / HBM_BYTES_PER_S, fl / flops_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def attention_f64(q, k, v, causal):
    """Dense GQA attention evaluated in float64 throughout (the yardstick
    of the fp32 flash route's accuracy)."""
    import torch
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qg = q.double().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bikgh,bjkh->bkgij", qg, k.double()) * hd ** -0.5
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None])
        s = s.masked_fill(~keep, -1e30)
    o = torch.einsum("bkgij,bjkh->bikgh", torch.softmax(s, -1), v.double())
    return o.reshape(B, Sq, H, hd)


class Smoke:
    """The run's shared state: device, random source, helpers."""

    def __init__(self, device="cuda"):
        import torch
        self.torch = torch
        self.dev = torch.device(device)
        self.gen = torch.Generator(device=self.dev).manual_seed(1)
        self.errs = {"fused_qkv": 0.0, "fused_mlp": 0.0,
                     "kv_row_scatter": 0.0, "flash_attention": 0.0,
                     "ssd": 0.0, "linear_attention": 0.0,
                     "dequant_gemm": 0.0, "cache_row_update": 0.0}
        self.worst_row_ratio = 0.0       # flash: max over rows err/max
        self.fp32_check = {}             # fp32 instances: worst err/max
        self.cu_check = {}
        self.ssd_check = {}
        self.la_check = []
        self.dg_check = {}

    def randn(self, *shape, scale=1.0, dtype=None):
        torch = self.torch
        return (torch.randn(shape, generator=self.gen, device=self.dev)
                * scale).to(dtype or torch.bfloat16)

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

    def check_fused_fp32(self, cfg, bcs):
        """The fp32 instances of the two GEMV kernels against their plain
        versions at the widths of ``cfg``: q4 g32 weights packed from fp32
        (dequantized to fp32 with no bf16 rounding) and the dense fp32
        weights themselves, fp32 biases; max |err| within FUSED_FP32_TOL
        of the largest plain magnitude."""
        from repro_torch.core.quantize import QuantSpec, quantize
        from repro_torch.kernels.fused_decode import ops, ref
        torch = self.torch
        f32 = torch.float32
        D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cfg.d_ff)
        spec = QuantSpec(4, group_size=32)

        def rn(*shape, scale=1.0):
            return self.randn(*shape, scale=scale, dtype=f32)
        dense = {"qkv": [rn(D, n, hd, scale=D ** -0.5) for n in (H, KV, KV)],
                 "mlp": [rn(D, F, scale=D ** -0.5), rn(F, D, scale=F ** -0.5),
                         rn(D, F, scale=D ** -0.5)]}
        bias = [rn(n, hd, scale=0.1) for n in (H, KV, KV)]
        worst = {}

        def held(name, what, got, want):
            if not (got.shape == want.shape and got.dtype == want.dtype == f32
                    and got.isfinite().all()):
                fail(f"{name} fp32 {what}: shape, dtype or non-finite output")
            err, m = self.max_err(got, want)
            if err > FUSED_FP32_TOL * m:
                fail(f"{name} fp32 {what}: max err {err} vs max {m}")
            worst[name] = max(worst.get(name, 0.0), err / m)
        for label in ("q4", "dense"):
            ws = {k: [quantize(w, spec) if label == "q4" else w for w in v]
                  for k, v in dense.items()}
            up, down, gate = ws["mlp"]
            for bc in bcs:
                h = rn(bc, 1, D)
                for g, w in zip(ops.fused_qkv(h, *ws["qkv"], *bias),
                                ref.ref_fused_qkv(h, *ws["qkv"], *bias)):
                    held("fused_qkv", f"{cfg.name} {label} bc={bc}", g, w)
                held("fused_mlp", f"{cfg.name} {label} bc={bc}",
                     ops.fused_mlp(h, up, down, gate, act="swiglu"),
                     ref.ref_fused_mlp(h, up, down, gate, act="swiglu"))
            del ws, up, down, gate
        torch.cuda.synchronize()
        self.fp32_check[cfg.name] = {"bc": list(bcs),
                                     "worst_err_over_max": worst,
                                     "tol": FUSED_FP32_TOL}

    def flash_held(self, q, k, v, causal, what, f64=None):
        """The flash kernel against its plain version on q, k, v: bf16
        every output row within KERNEL_TOL of that row's largest plain
        magnitude, fp32 within FLASH_FP32_TOL of the largest (the
        reference's measure); fp32 kernel and plain each also against a
        float64 evaluation in that measure, the worst of each kept in
        ``f64`` where given.  Returns (err/max measure, max abs err)."""
        from repro_torch.kernels.flash_attention import (flash_attention,
                                                         ref_attention)
        got = flash_attention(q, k, v, causal=causal).float()
        want = ref_attention(q, k, v, causal=causal).float()
        if got.shape != want.shape or not got.isfinite().all():
            fail(f"flash_attention {what}: shape {tuple(got.shape)} or "
                 f"non-finite output")
        err = (got - want).abs()
        if q.dtype == self.torch.float32:
            worst = (err.max() / want.abs().max()).item()
            if worst > FLASH_FP32_TOL:
                fail(f"flash_attention {what}: err/max {worst}")
            if f64 is not None:
                exact = attention_f64(q, k, v, causal)
                den = exact.abs().max()
                for key, t in (("kernel", got), ("plain", want)):
                    f64[key] = max(f64.get(key, 0.0), (
                        (t.double() - exact).abs().max() / den).item())
            return worst, err.max().item()
        err = err.amax(-1)
        ratio = (err / want.abs().amax(-1)).nan_to_num(nan=0.0, posinf=1e9)
        worst = ratio.max().item()
        if worst > KERNEL_TOL:
            i = int(ratio.argmax())
            fail(f"flash_attention {what}: row {i} err/max {worst}")
        return worst, err.max().item()

    def check_flash(self):
        """Per output row (b, i, h): max |kernel - plain| within
        KERNEL_TOL of the row's max |plain|."""
        for B, Sq, Sk, H, KV, hd, causal in FLASH_SHAPES:
            q = self.randn(B, Sq, H, hd)
            k, v = self.randn(B, Sk, KV, hd), self.randn(B, Sk, KV, hd)
            worst, err = self.flash_held(
                q, k, v, causal, f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} "
                f"hd={hd} causal={causal}")
            self.errs["flash_attention"] = max(self.errs["flash_attention"],
                                               err)
            self.worst_row_ratio = max(self.worst_row_ratio, worst)
        self.torch.cuda.synchronize()

    def check_flash_grid(self):
        """The reference kernel tests' grid (FLASH_REF_GRID, causal and
        not) and hd 160 (FLASH_HD160), in bf16 and fp32."""
        torch = self.torch
        cases = [(B, S, S, H, KV, hd, c) for B, S, H, KV, hd in FLASH_REF_GRID
                 for c in (True, False)] + list(FLASH_HD160)
        worst, f64 = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            for B, Sq, Sk, H, KV, hd, causal in cases:
                q = self.randn(B, Sq, H, hd, dtype=dtype)
                k = self.randn(B, Sk, KV, hd, dtype=dtype)
                v = self.randn(B, Sk, KV, hd, dtype=dtype)
                w, err = self.flash_held(
                    q, k, v, causal, f"{name} B={B} Sq={Sq} Sk={Sk} H={H} "
                    f"KV={KV} hd={hd} causal={causal}", f64)
                worst[name] = max(worst.get(name, 0.0), w)
                if dtype == torch.bfloat16:
                    self.errs["flash_attention"] = max(
                        self.errs["flash_attention"], err)
        torch.cuda.synchronize()
        self.fp32_check["flash_attention"] = {
            "cases": [list(c) for c in cases], "dtypes": sorted(worst),
            "worst": {"bfloat16_row_err_over_row_max": worst["bfloat16"],
                      "float32_err_over_max": worst["float32"]},
            "float32_vs_float64_err_over_max": f64,
            "tol": {"bfloat16_row": KERNEL_TOL, "float32": FLASH_FP32_TOL}}

    def check_cache_update(self, cfg):
        """The cache-row-update kernel bit for bit against its plain
        version (each on its own copy of the same inputs), in place and
        finite: the reference tests' shapes (CU_SHAPES) with a per-row
        index, a scalar index and an out-of-range row (left as it was),
        and layer slices of a stacked (L, n_slots, max_len, KV, hd) cache
        at ``cfg``'s widths; bf16 and fp32 caches, each with a row of
        either dtype."""
        from repro_torch.kernels.cache_update import (cache_row_update,
                                                      ref_cache_row_update)
        torch = self.torch
        cases = 0

        def held(what, cache, row, index):
            nonlocal cases
            want = ref_cache_row_update(cache.clone(), row, index)
            got = cache_row_update(cache, row, index)
            if not (got is cache and got.isfinite().all()
                    and torch.equal(got, want)):
                fail(f"cache_row_update {what}: differs from the plain "
                     f"version")
            cases += 1
        dtypes = (torch.bfloat16, torch.float32)
        for cdt in dtypes:
            for rdt in dtypes:
                what = f"cache {cdt} row {rdt}"
                for B, S, KV, hd in CU_SHAPES:
                    cache = self.randn(B, S, KV, hd, dtype=cdt)
                    row = self.randn(B, KV, hd, dtype=rdt)
                    idx = torch.tensor([(i * 7 + 3) % S for i in range(B)],
                                       dtype=torch.int32, device=self.dev)
                    held(f"{what} {(B, S, KV, hd)}", cache, row, idx)
                    held(f"{what} {(B, S, KV, hd)} scalar index", cache, row,
                         5)
                    idx[0] = S
                    before = cache[0].clone()
                    held(f"{what} {(B, S, KV, hd)} out of range", cache, row,
                         idx)
                    if not torch.equal(cache[0], before):
                        fail(f"cache_row_update {what}: an out-of-range "
                             f"row was written")
            L, B, S = cfg.n_layers, N_SLOTS, MAX_LEN[cfg.name]
            stack = self.randn(L, B, S, cfg.n_kv_heads, cfg.hd, dtype=cdt)
            row = self.randn(B, cfg.n_kv_heads, cfg.hd, dtype=cdt)
            idx = torch.tensor([0, 700, 1400, S - 1], dtype=torch.int32,
                               device=self.dev)
            want = stack.clone()
            for i in (0, L // 2, L - 1):
                ref_cache_row_update(want[i], row, idx)
                held(f"{cfg.name} layer slice {i} {cdt}", stack[i], row, idx)
            if not torch.equal(stack, want):
                fail("cache_row_update: a layer slice write reached another "
                     "layer")
            del stack, want
        torch.cuda.synchronize()
        self.cu_check = {"cases": cases, "bit_exact": True,
                         "shapes": [list(c) for c in CU_SHAPES],
                         "layer_slices_of": [cfg.n_layers, N_SLOTS,
                                             MAX_LEN[cfg.name],
                                             cfg.n_kv_heads, cfg.hd]}

    def ssd_inputs(self, B, S, H, P, G, N):
        """bf16 x/B/C and fp32 dt, A drawn like the reference kernel
        tests: dt = softplus(normal), A = -exp(0.5 normal), B and C =
        0.3 normal."""
        torch = self.torch

        def rn(*shape):
            return torch.randn(shape, generator=self.gen, device=self.dev)
        x = rn(B, S, H, P).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(rn(B, S, H))
        A = -torch.exp(rn(H) * 0.5)
        return (x, dt, A, (rn(B, S, G, N) * 0.3).to(torch.bfloat16),
                (rn(B, S, G, N) * 0.3).to(torch.bfloat16))

    def check_ssd(self):
        """The SSD kernel against ``ssd_chunked`` at SSD_SHAPE (the bf16
        route, and the fp32 route on the same inputs in fp32), then the
        pad check: dt = 0 past position 1000 of 2048 leaves the state of
        the 1024-position call on the same inputs."""
        from repro_torch.kernels.ssd import ssd
        B, S, H, P, G, N, chunk = SSD_SHAPE
        args = self.ssd_inputs(B, S, H, P, G, N)
        h_rel, head, y_abs, h_abs, _ = ssd_errors(
            args, ssd(*args, chunk=chunk), chunk, "ssd")
        a32 = tuple(t.float() for t in args)
        fp32 = dict(zip(("h_rel_err", "worst_head_y_err_over_max",
                         "y_max_abs_err", "h_max_abs_err"), ssd_errors(
            a32, ssd(*a32, chunk=chunk), chunk, "ssd fp32")[:4]))
        del a32
        x, dt, A, Bm, Cm = args
        dt = dt.clone()
        dt[:, 1000:] = 0.0
        _, h_long = ssd(x, dt, A, Bm, Cm, chunk=chunk)
        _, h_short = ssd(x[:, :1024], dt[:, :1024], A, Bm[:, :1024],
                         Cm[:, :1024], chunk=chunk)
        pad_rel = ((h_long - h_short).abs().max()
                   / h_short.abs().max()).item()
        if pad_rel > SSD_H_TOL:
            fail(f"ssd pad check: h_final rel err {pad_rel}")
        self.errs["ssd"] = y_abs
        self.ssd_check = {"shape": list(SSD_SHAPE), "h_rel_err": h_rel,
                          "worst_head_y_err_over_max": head,
                          "y_max_abs_err": y_abs, "h_max_abs_err": h_abs,
                          "pad_check_h_rel_err": pad_rel, "fp32": fp32,
                          "tol": {"h": SSD_H_TOL, "y_head": KERNEL_TOL}}
        self.torch.cuda.synchronize()

    def la_inputs(self, B, S, H, KV, hd, dtype):
        """q, k = 0.5 normal and v = normal in ``dtype``, like the
        reference kernel tests; k and v at kv-head width."""
        torch = self.torch

        def rn(heads, scale):
            return (torch.randn((B, S, heads, hd), generator=self.gen,
                                device=self.dev) * scale).to(dtype)
        return rn(H, 0.5), rn(KV, 0.5), rn(KV, 1.0)

    def check_linear_attention(self):
        """The linear-attention kernel against its plain version at
        LA_CHECKS, bf16 and fp32 (``linear_errors``' gates)."""
        from repro_torch.kernels.linear_attention import linear_attention
        torch = self.torch
        for B, S, H, KV, hd, chunk, vl in LA_CHECKS:
            for dtype in (torch.bfloat16, torch.float32):
                args = self.la_inputs(B, S, H, KV, hd, dtype)
                valid = (None if vl is None else
                         torch.tensor(vl, dtype=torch.int32, device=self.dev))
                name = str(dtype).replace("torch.", "")
                rec = linear_errors(
                    args, linear_attention(*args, chunk=chunk,
                                           valid_len=valid),
                    chunk, valid, f"linear_attention B={B} S={S} H={H} "
                    f"KV={KV} hd={hd} {name} valid_len={vl}")
                self.la_check.append(dict(
                    shape=[B, S, H, KV, hd, chunk], dtype=name,
                    valid_len=vl, **rec))
                if dtype == torch.bfloat16:
                    self.errs["linear_attention"] = max(
                        self.errs["linear_attention"], rec["out_max_abs_err"])
        torch.cuda.synchronize()

    def check_dequant_gemm(self, cfgs):
        """The packed-weight GEMM against its plain versions
        (``gemm_error``'s gate): the reference kernel's layout ("nk",
        ``dequant_gemm``) on the reference tests' grid, the four
        epilogues with a bias, group sizes 32/64/128 and a 3-D x, in bf16
        and fp32; the model's layout ("kn", ``quant_einsum``) at every
        distinct projection shape of ``cfgs`` ((config, dtypes) pairs),
        q4 g32 as served, DG_KN_ROWS rows."""
        from repro_torch.core.quantize import QuantSpec, quantize
        from repro_torch.kernels.dequant_gemm import (dequant_gemm,
                                                      quant_einsum,
                                                      ref_dequant_gemm,
                                                      ref_quant_einsum)
        torch = self.torch

        def rn(shape, dtype, scale=1.0):
            return (torch.randn(shape, generator=self.gen, device=self.dev)
                    * scale).to(dtype)
        worst, cases = {}, 0

        def held(what, got, want):
            nonlocal cases
            dtype, rel, err = gemm_error(what, got, want)
            worst[dtype] = max(worst.get(dtype, 0.0), rel)
            self.errs["dequant_gemm"] = max(self.errs["dequant_gemm"], err)
            cases += 1
        for dtype in (torch.bfloat16, torch.float32):
            for bits in (2, 4, 8):
                for M, K, N in DG_NK_GRID:
                    x = rn((M, K), dtype)
                    qt = quantize(rn((N, K), dtype, 0.05), QuantSpec(bits))
                    held(f"nk w{bits} M={M} K={K} N={N} {dtype}",
                         dequant_gemm(x, qt), ref_dequant_gemm(x, qt))
            x = rn((32, 512), dtype)
            qt = quantize(rn((128, 512), dtype, 0.1), QuantSpec(4))
            bias = torch.linspace(-0.5, 0.5, 128, device=self.dev)
            for act in ("relu", "silu", "gelu", "squared_relu"):
                held(f"nk epilogue {act} {dtype}",
                     dequant_gemm(x, qt, bias, act),
                     ref_dequant_gemm(x, qt, bias, act))
            x = rn((16, 512), dtype)
            for g in (32, 64, 128):
                qt = quantize(rn((64, 512), dtype, 0.2),
                              QuantSpec(4, group_size=g))
                held(f"nk group {g} {dtype}", dequant_gemm(x, qt),
                     ref_dequant_gemm(x, qt))
            x = rn((2, 16, 512), dtype)
            qt = quantize(rn((64, 512), dtype, 0.1), QuantSpec(4))
            held(f"nk 3-D x {dtype}", dequant_gemm(x, qt),
                 ref_dequant_gemm(x, qt))
        shapes = sorted({(spec, w, x, str(dt)) for cfg, dtypes in cfgs
                         for spec, w, x in gemm_shapes(cfg)
                         for dt in dtypes})
        spec32 = QuantSpec(4, group_size=32)
        for spec, wshape, xshape, dt in shapes:
            dtype = getattr(torch, dt.replace("torch.", ""))
            x = rn((1, DG_KN_ROWS) + xshape, dtype)
            w = quantize(rn(wshape, dtype, wshape[0] ** -0.5), spec32)
            held(f"kn {spec} {wshape} {dtype}", quant_einsum(spec, x, w),
                 ref_quant_einsum(spec, x, w))
            del x, w
        torch.cuda.synchronize()
        self.dg_check = {"cases": cases,
                         "worst_err_over_max": worst, "tol": DG_TOL,
                         "nk_grid_MKN": [list(c) for c in DG_NK_GRID],
                         "kn_shapes": [[sp, list(w), dt.replace("torch.", "")]
                                       for sp, w, _, dt in shapes]}


def gemm_error(what, got, want):
    """A packed-weight GEMM's output against its plain version's: fails
    unless finite, of the plain shape and dtype, and max |err| within
    DG_TOL of max |plain|.  Returns (dtype name, err over max, max abs
    err)."""
    dtype = str(want.dtype).replace("torch.", "")
    if not (got.shape == want.shape and got.dtype == want.dtype
            and got.isfinite().all()):
        fail(f"dequant_gemm {what}: shape, dtype or non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    if rel > DG_TOL[dtype]:
        fail(f"dequant_gemm {what}: max err {err} is {rel} of the largest "
             f"plain magnitude (tol {DG_TOL[dtype]})")
    return dtype, rel, err


def gemm_shapes(cfg):
    """(einsum, weight shape, x's contracted shape) of each projection of
    a layer of ``cfg`` that takes a packed weight (its first axes are
    contracted, as the model stores it)."""
    from repro_torch.models import decoder, mamba2
    D = cfg.d_model
    if decoder.mixer_of(cfg) == "mamba":
        s = cfg.ssm
        d_inner, H, _ = mamba2._dims(cfg)
        n_in = 2 * d_inner + 2 * s.n_groups * s.d_state + H
        return [("bsd,de->bse", (D, n_in), (D,)),
                ("bse,ed->bsd", (d_inner, D), (d_inner,))]
    H, KV, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    return [("bsd,dhk->bshk", (D, H, hd), (D,)),
            ("bsd,dhk->bshk", (D, KV, hd), (D,)),
            ("bshk,hkd->bsd", (H, hd, D), (H, hd)),
            ("bsd,df->bsf", (D, F), (D,)),
            ("bsf,fd->bsd", (F, D), (F,))]


class GemmCalls:
    """Keeps the packed-weight GEMM calls (spec, x, w, out; by reference:
    the model writes none of them after the call) of one prefill call:
    ``dequant_gemm.ops.quant_einsum`` is wrapped inside the ``with``
    block and records while ``armed``."""

    def __init__(self):
        from repro_torch.core.quantize import QTensor
        from repro_torch.kernels.dequant_gemm import ops
        self.ops, self.inner, self.packed = ops, ops.quant_einsum, QTensor
        self.calls, self.armed = [], False

    def __call__(self, spec, x, w):
        out = self.inner(spec, x, w)
        if self.armed and isinstance(w, self.packed):
            self.calls.append((spec, x, w, out))
        return out

    def __enter__(self):
        self.ops.quant_einsum = self
        return self

    def __exit__(self, *exc):
        self.ops.quant_einsum = self.inner


def served_gemm_check(cfg, calls, n_calls):
    """Every recorded packed-weight GEMM call of one served prefill call
    (``n_calls`` of them) against the plain version (``dequantize`` +
    einsum) on its own inputs, with ``gemm_error``'s gate; the worst
    error over the largest plain magnitude and the (einsum, x shape,
    weight shape, dtype) of the calls."""
    import torch
    from repro_torch.kernels.dequant_gemm import ref_quant_einsum
    if len(calls) != n_calls:
        fail(f"{cfg.name}: {len(calls)} packed-weight GEMM calls recorded "
             f"in one prefill call, expected {n_calls}")
    worst, err_max, shapes = 0.0, 0.0, set()
    with torch.no_grad():
        for spec, x, w, out in calls:
            _, rel, err = gemm_error(
                f"{cfg.name}: served {spec} at {tuple(x.shape)}", out,
                ref_quant_einsum(spec, x, w))
            worst, err_max = max(worst, rel), max(err_max, err)
            shapes.add((spec, tuple(x.shape), tuple(w.shape),
                        str(x.dtype).replace("torch.", "")))
    return {"calls": len(calls), "worst_err_over_max": worst,
            "max_abs_err": err_max, "tol": DG_TOL,
            "shapes_spec_x_w_dtype": sorted(shapes)}


def time_dequant_gemm(sm):
    """The packed-weight GEMM at DG_TIME_SHAPE (q4 g32, bf16) through
    ``quant_einsum``, its plain version, the library convention of the
    decode rows (``dequantize`` + ``torch.matmul``) and ``torch.matmul``
    alone on the weight dequantized beforehand; the bytes (codes, scales,
    x, y once each) and operations (2 M N K) that set its bound."""
    import torch
    from repro_torch.core.quantize import QuantSpec, dequantize, quantize
    from repro_torch.kernels.dequant_gemm import (quant_einsum,
                                                  ref_quant_einsum)
    M, K, N = DG_TIME_SHAPE
    x = sm.randn(1, M, K)
    w = quantize(sm.randn(K, N, scale=K ** -0.5),
                 QuantSpec(4, group_size=32))
    dense = dequantize(w)
    x2 = x.reshape(M, K)
    with torch.no_grad():
        t_k = timed(lambda i: quant_einsum("bsd,df->bsf", x, w), 1,
                    iters=20)
        t_p = timed(lambda i: ref_quant_einsum("bsd,df->bsf", x, w), 1,
                    iters=10)
        t_l = timed(lambda i: torch.matmul(x2, dequantize(w)), 1, iters=10)
        t_d = timed(lambda i: torch.matmul(x2, dense), 1, iters=20)
    byt = (w.codes.numel() * 4 + w.scales.numel() * 4
           + 2 * M * K + 2 * M * N)
    return t_k, t_p, t_l, t_d, byt, 2 * M * N * K


def time_gemm_shapes(sm, cfgs):
    """The packed-weight GEMM at every distinct projection shape of
    ``cfgs`` (q, k/v, o, up/gate, down; Mamba-2's in_proj and out_proj),
    q4 g32 bf16 at DG_SERVED_ROWS rows, through ``quant_einsum`` (the
    kernel its route picks), beside ``dequantize`` + ``torch.matmul`` and
    ``torch.matmul`` on the weight dequantized beforehand; each time from
    the profiler (device ms) and from CUDA events around the loop (event
    ms), and the bound from the codes, scales, x and y bytes and 2 M N K
    operations."""
    import torch
    from repro_torch.core.quantize import QuantSpec, dequantize, quantize
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dequant_gemm import quant_einsum
    names = {"bsd,dhk->bshk": "q / k / v", "bshk,hkd->bsd": "o",
             "bsd,df->bsf": "up / gate", "bsf,fd->bsd": "down",
             "bsd,de->bse": "in_proj", "bse,ed->bsd": "out_proj"}
    rows, seen = [], set()
    for cfg in cfgs:
        M = DG_SERVED_ROWS[cfg.name]
        for spec, wshape, xshape in gemm_shapes(cfg):
            if (cfg.name, wshape) in seen:
                continue
            seen.add((cfg.name, wshape))
            x = sm.randn(1, M, *xshape)
            w = quantize(sm.randn(*wshape, scale=wshape[0] ** -0.5),
                         QuantSpec(4, group_size=32))
            dense = dequantize(w)
            K = x.shape[-len(xshape):].numel()
            N = dense.numel() // K
            x2, d2 = x.reshape(M, K), dense.reshape(K, N)
            with torch.no_grad():
                t_k = timed(lambda i: quant_einsum(spec, x, w), 1, iters=10)
                t_l = timed(lambda i: torch.matmul(x2, dequantize(w).reshape(
                    K, N)), 1, iters=5)
                t_d = timed(lambda i: torch.matmul(x2, d2), 1, iters=10)
            byt = (w.codes.numel() * 4 + w.scales.numel() * 4
                   + 2 * M * K + 2 * M * N)
            b_ms, b_by = bound(byt, 2 * M * N * K)
            reset_launch_counts()       # the kernel this shape launches
            with torch.no_grad():
                quant_einsum(spec, x, w)
            route = [r for r in GEMM_ROUTE.values()
                     if launch_counts()[f"dequant_gemm/{r}"]]
            rows.append({
                "model": cfg.name, "proj": names[spec], "M": M, "K": K,
                "N": N, "route": route,
                "ms": dev_or_call(t_k), "event_ms": t_k[1],
                "bound_ms": b_ms, "bound_by": b_by,
                "dequantize_matmul_ms": dev_or_call(t_l),
                "dense_matmul_ms": dev_or_call(t_d),
                "dense_matmul_event_ms": t_d[1]})
            del x, w, dense, x2, d2
    free()
    return rows


def ssd_errors(args, out, chunk, what):
    """The SSD kernel's (y, h_final) ``out`` on ``args`` against the plain
    ``ssd_chunked``: fails unless both are finite, of the plain shapes,
    h_final within SSD_H_TOL of its largest magnitude and every (b, h)
    head's y within KERNEL_TOL of that head's largest plain |y|.
    Returns (h rel err, worst head's y err / max, y max abs err, h max
    abs err, the number of y elements that differ)."""
    import torch
    from repro_torch.kernels.ssd import ref_ssd_chunked
    y, h = out
    ry, rh = ref_ssd_chunked(*args, chunk=chunk)
    if not (y.shape == ry.shape and h.shape == rh.shape
            and y.isfinite().all() and h.isfinite().all()):
        fail(f"{what}: shape or non-finite output")
    h_err = (h - rh).abs().max().item()
    h_rel = h_err / rh.abs().max().item()
    y_err = (y.float() - ry.float()).abs()
    tiny = torch.finfo(torch.float32).tiny
    head = (y_err.amax(dim=(1, 3)) / ry.float().abs().amax(
        dim=(1, 3)).clamp_min(tiny)).max().item()
    if not (h_rel <= SSD_H_TOL and head <= KERNEL_TOL):
        fail(f"{what}: h_final rel err {h_rel}, worst head y err/max "
             f"{head}")
    return (h_rel, head, y_err.max().item(), h_err,
            int((y != ry).sum().item()))


class RowUpdateCalls:
    """Holds every ``cache_update.ops.cache_row_update`` call made while
    ``armed`` (the model looks the wrapper up at each call) against the
    plain version on its own inputs, a copy of the cache taken just before
    the call: bit for bit, in place, finite.  Wrapped inside the ``with``
    block."""

    def __init__(self):
        from repro_torch.kernels.cache_update import ops, ref
        self.ops, self.inner = ops, ops.cache_row_update
        self.ref = ref.ref_cache_row_update
        self.armed, self.calls, self.shapes = False, 0, set()

    def __call__(self, cache, row, index):
        import torch
        if not self.armed:
            return self.inner(cache, row, index)
        before = cache.clone()
        out = self.inner(cache, row, index)
        want = self.ref(before, row, index)
        if not (out is cache and out.isfinite().all()
                and torch.equal(out, want)):
            fail(f"served cache_row_update at {tuple(cache.shape)} differs "
                 f"from the plain version")
        self.calls += 1
        self.shapes.add((tuple(cache.shape), str(cache.dtype), tuple(
            cache.stride())))
        return out

    def __enter__(self):
        self.ops.cache_row_update = self
        return self

    def __exit__(self, *exc):
        self.ops.cache_row_update = self.inner


class MlpCalls:
    """Holds every ``fused_decode.ops.fused_mlp`` call made while
    ``armed`` (the fused step looks the wrapper up at each call) against
    the plain ``ref_fused_mlp`` on its own inputs: finite, of the plain
    shape and dtype, each cohort row's max |err| within MLP_ROW_TOL of its
    largest plain value.  Wrapped inside the ``with`` block."""

    def __init__(self):
        from repro_torch.kernels.fused_decode import ops, ref
        self.ops, self.inner, self.ref = ops, ops.fused_mlp, ref.ref_fused_mlp
        self.armed, self.calls, self.worst, self.bc = False, 0, 0.0, 0

    def __call__(self, h, w_up, w_down, w_gate=None, *, act):
        out = self.inner(h, w_up, w_down, w_gate, act=act)
        if not self.armed:
            return out
        want = self.ref(h, w_up, w_down, w_gate, act=act)
        dtype = str(h.dtype).replace("torch.", "")
        if not (out.shape == want.shape and out.dtype == want.dtype
                and out.isfinite().all()):
            fail(f"served fused_mlp at {tuple(h.shape)}: shape, dtype or "
                 f"non-finite output")
        err = (out.float() - want.float()).abs().amax(-1)
        worst = (err / want.float().abs().amax(-1)).max().item()
        if worst > MLP_ROW_TOL[dtype]:
            fail(f"served fused_mlp at {tuple(h.shape)} {dtype}: row err/max "
                 f"{worst}")
        self.calls += 1
        self.worst, self.bc = max(self.worst, worst), int(h.shape[0])
        return out

    def __enter__(self):
        self.ops.fused_mlp = self
        return self

    def __exit__(self, *exc):
        self.ops.fused_mlp = self.inner


class QkvCalls(MlpCalls):
    """``MlpCalls`` for ``fused_decode.ops.fused_qkv``: each call made
    while ``armed`` against ``ref_fused_qkv`` on its own inputs, each
    cohort row of q, k and v within MLP_ROW_TOL of its largest plain
    value."""

    def __init__(self):
        from repro_torch.kernels.fused_decode import ops, ref
        self.ops, self.inner, self.ref = ops, ops.fused_qkv, ref.ref_fused_qkv
        self.armed, self.calls, self.worst, self.bc = False, 0, 0.0, 0

    def __call__(self, h, *args):
        outs = self.inner(h, *args)
        if not self.armed:
            return outs
        dtype = str(h.dtype).replace("torch.", "")
        for out, want in zip(outs, self.ref(h, *args)):
            if not (out.shape == want.shape and out.dtype == want.dtype
                    and out.isfinite().all()):
                fail(f"served fused_qkv at {tuple(h.shape)}: shape, dtype "
                     f"or non-finite output")
            o, w = out.float().flatten(1), want.float().flatten(1)
            worst = ((o - w).abs().amax(-1) / w.abs().amax(-1)).max().item()
            if worst > MLP_ROW_TOL[dtype]:
                fail(f"served fused_qkv at {tuple(h.shape)} {dtype}: row "
                     f"err/max {worst}")
            self.worst = max(self.worst, worst)
        self.calls += 1
        self.bc = int(h.shape[0])
        return outs

    def __enter__(self):
        self.ops.fused_qkv = self
        return self

    def __exit__(self, *exc):
        self.ops.fused_qkv = self.inner


class FlashCalls:
    """Keeps every flash-attention call of a serve (q, k, v, causal, out;
    by reference: the model writes none of them after the call):
    ``models.attention.flash_attention`` is wrapped inside the ``with``
    block."""

    def __init__(self):
        from repro_torch.models import attention
        self.mod, self.inner = attention, attention.flash_attention
        self.calls = []

    def __call__(self, q, k, v, *, causal=True):
        out = self.inner(q, k, v, causal=causal)
        self.calls.append((q, k, v, causal, out))
        return out

    def __enter__(self):
        self.mod.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.inner


def serve_path(sm, cfg, reqs, use_fused=None):
    """Serve ``reqs`` on ``cfg`` at full width with the engine's decode
    step (``use_fused``: None, the engine's default, which must be the
    fused step; False, the composed step); check what the run must show,
    the launches of every decode step, the packed-weight GEMM calls of the
    first prefill call among it (``GemmCalls``, ``served_gemm_check``),
    every cache-row-update call of the captured step (``RowUpdateCalls``)
    and every flash call (``FlashCalls``, fp32 within FLASH_FP32_TOL,
    bf16 rows within KERNEL_TOL); return (serve record, engine, captured
    prefill: the largest group)."""
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
                        use_fused=use_fused, device=sm.dev)
    del params
    fused = eng.use_fused
    if fused != (use_fused is None):
        fail(f"{cfg.name}: the engine selected use_fused={fused}")
    captured, prefills, step_launches = {}, [], []
    decode, prefill = eng._decode, eng._prefill

    def capturing_decode(tokens, lengths, slot_ids, tables):
        # keep one multi-row cohort state (inputs + pool before the step,
        # the step's logits and pool after it); count every step's launches
        take = ("args" not in captured and int((tables[:, 0] <
                                                eng.slots.n_blocks).sum()) >= 2)
        if take:
            captured["args"] = tuple(t.clone() for t in
                                     (tokens, lengths, slot_ids, tables))
            captured["pool"] = tuple(tuple(t.clone() for t in pos)
                                     for pos in eng.slots.pool)
        before = launch_counts()
        rows.armed = mlps.armed = qkvs.armed = take
        try:
            logits, pool = decode(tokens, lengths, slot_ids, tables)
        finally:
            rows.armed = mlps.armed = qkvs.armed = False
        after = launch_counts()
        step_launches.append({k: after[k] - before[k] for k in after
                              if after[k] != before[k]})
        if take:
            captured["logits"] = logits.clone()
            captured["pool_after"] = tuple(tuple(t.clone() for t in p)
                                           for p in pool)
        return logits, pool

    def counting_prefill_inner(tokens, vision_embeds, last_idx):
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
    def counting_prefill(tokens, vision_embeds, last_idx):
        gemms.armed = "prefill_calls" not in captured   # the first call
        try:
            return counting_prefill_inner(tokens, vision_embeds, last_idx)
        finally:
            gemms.armed = False
    eng._decode, eng._prefill = capturing_decode, counting_prefill
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    with GemmCalls() as gemms, RowUpdateCalls() as rows, \
            FlashCalls() as flashes, MlpCalls() as mlps, \
            QkvCalls() as qkvs, eng:
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
    # each decode step: the fused kernels, or two row updates a layer;
    # one KV-row scatter either way
    per_step = ({"fused_qkv": L, f"fused_qkv/{MLP_ROUTE}": L, "fused_mlp": L,
                 f"fused_mlp/{MLP_ROUTE}": L, "kv_scatter": 1} if fused
                else {"cache_row_update": 2 * L, "kv_scatter": 1})
    per_call = GEMMS_PER_LAYER["attn"] * L
    want = {k: 0 for k in launches}
    want.update({k: n * decode_steps for k, n in per_step.items()})
    n_flash = L * n_prefill if cfg.attn_q_chunk == 0 else 0
    want["flash_attention"] = n_flash
    want[f"flash_attention/{FLASH_ROUTE[cfg.dtype]}"] = n_flash
    want["dequant_gemm"] = per_call * n_prefill
    want[f"dequant_gemm/{GEMM_ROUTE[cfg.dtype]}"] = per_call * n_prefill
    if not (launches == want and decode_steps > 0 and n_prefill > 0
            and len(step_launches) == decode_steps
            and all(d == per_step for d in step_launches)):
        fail(f"{cfg.name}: launch counts {launches} for {decode_steps} "
             f"decode steps and {n_prefill} prefill calls (want {want}; "
             f"per step {per_step}, got {step_launches[:3]})")
    if not fused and rows.calls != 2 * L:
        fail(f"{cfg.name}: {rows.calls} row-update calls held in the "
             f"captured step, expected {2 * L}")
    if fused and qkvs.calls != L:
        fail(f"{cfg.name}: {qkvs.calls} fused-QKV calls held in the "
             f"captured step, expected {L}")
    if fused and mlps.calls != L:
        fail(f"{cfg.name}: {mlps.calls} fused-MLP calls held in the "
             f"captured step, expected {L}")
    spans = eng.probe.samples()
    pre = [s for s in spans if s.brick == "decoder" and s.phase == "prefill"]
    decs = [s for s in spans if s.brick == "decoder" and s.phase == "decode"]
    serve = {"arch": cfg.name, "dtype": cfg.dtype,
             "attn_q_chunk": cfg.attn_q_chunk,
             "decode_step": "fused" if fused else "composed",
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
             "kv_pool_mb": round(eng.slots.nbytes / 1e6, 3),
             "tabm": tstats, "launches": launches,
             "launches_per_decode_step": per_step}
    serve["gemm_served_check"] = dict(served_gemm_check(
        cfg, gemms.calls, per_call), prefill_batch=captured[
        "prefill_batch"][0], prefill_width=captured["prefill_width"][0])
    del gemms
    if fused:
        for key, held in (("qkv_served_check", qkvs),
                          ("mlp_served_check", mlps)):
            serve[key] = {
                "calls": held.calls, "worst_row_err_over_row_max": held.worst,
                "bc": held.bc, "dtype": cfg.dtype,
                "tol": MLP_ROW_TOL[cfg.dtype]}
    if not fused:
        serve["row_update_served_check"] = {
            "calls": rows.calls, "bit_exact": True,
            "cache_shape_dtype_strides": sorted(rows.shapes)}
    if flashes.calls:
        worst, err_max, f64 = 0.0, 0.0, {}
        with torch.no_grad():
            for q, k, v, causal, _ in flashes.calls:
                w, err = sm.flash_held(q, k, v, causal, f"{cfg.name}: served "
                                       f"at {tuple(q.shape)}", f64)
                worst, err_max = max(worst, w), max(err_max, err)
        serve["flash_served_check"] = {
            "calls": len(flashes.calls), "max_abs_err": err_max,
            "worst_err_over_max": worst, "dtype": cfg.dtype,
            "tol": (FLASH_FP32_TOL if cfg.dtype == "float32"
                    else KERNEL_TOL)}
        if f64:
            serve["flash_served_check"]["vs_float64_err_over_max"] = f64
    del flashes

    # the captured cohort state again through the fused and the plain
    # composed step (teacher-forced: the same inputs and pool)
    if "args" not in captured:
        fail(f"{cfg.name}: no multi-row cohort state was captured")
    args = captured["args"]
    pool_f = tuple(tuple(t.clone() for t in pos) for pos in captured["pool"])
    kw = dict(block_size=eng.slots.block_size, paged=eng.slots.paged)
    with torch.no_grad():
        lf, _ = ops.cohort_step(eng.params, cfg, *args, pool_f,
                                use_fused=True, **kw)
        lr, pr = ref.ref_cohort_step(eng.params, cfg, *args,
                                     captured["pool"], **kw)
    nrows = int((args[3][:, 0] < eng.slots.n_blocks).sum())
    if fused:
        serve["cohort_check"] = logit_check(cfg, lf[:nrows], lr[:nrows],
                                            "fused vs composed step")
    else:
        ls = captured["logits"]
        same_pool = all(torch.equal(a, b) for a, b in
                        zip(captured["pool_after"][0], pr[0]))
        if not same_pool:
            fail(f"{cfg.name}: the composed step's pool differs from the "
                 f"plain step's")
        serve["cohort_check"] = {
            "served_vs_fused": logit_check(cfg, ls[:nrows], lf[:nrows],
                                           "composed served vs fused step"),
            "served_vs_plain": logit_check(cfg, ls[:nrows], lr[:nrows],
                                           "composed served vs plain step"),
            "logits_bit_equal_to_plain": bool(torch.equal(ls, lr)),
            "pool_equal_to_plain": same_pool}
    serve["cohort_check"]["rows"] = nrows
    del pr, captured["pool_after"]

    # where one decode step's time goes: wall time (host clock,
    # synchronized, median of 5) against the card's kernel time
    def step():
        with torch.no_grad():
            ops.cohort_step(eng.params, cfg, *args, pool_f, use_fused=fused,
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


def prefill_plain_check(eng, cfg, captured):
    """The captured prefill group again with each prefill kernel swapped
    for its plain version (dense attention for the flash kernel,
    dequantize + einsum for the packed-weight GEMM): the same logits
    within STEP_TOL."""
    import torch
    from repro_torch.kernels.dequant_gemm import ops as dg_ops
    from repro_torch.kernels.flash_attention import ref_attention
    from repro_torch.models import attention
    tokens, vision, last_idx, logits = captured
    with swapped(attention, "flash_attention", ref_attention), \
            swapped(dg_ops, "quant_einsum", dg_ops.ref_quant_einsum), \
            torch.no_grad():
        plain, _ = eng._prefill(tokens, vision, last_idx)
    torch.cuda.synchronize()
    out = logit_check(cfg, logits, plain, "kernel vs plain prefill")
    out["batch"], out["width"] = int(tokens.shape[0]), int(tokens.shape[1])
    return out


def logit_check(cfg, got, want, what, tol=STEP_TOL):
    """Real rows, real vocabulary (padded vocab rows carry a -1e30 bias):
    max abs error within ``tol`` of the largest logit."""
    got, want = got[:, :cfg.vocab_size], want[:, :cfg.vocab_size]
    if not (got.isfinite().all() and want.isfinite().all()):
        fail(f"{cfg.name}: non-finite logits in the {what} comparison")
    err = (got - want).abs().max().item()
    m = want.abs().max().item()
    if err > tol * m:
        fail(f"{cfg.name} {what}: max err {err} vs max {m}")
    return {"max_abs_err": err, "max_abs_logit": m, "tol_rel": tol,
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


def prefill_breakdown(eng, group, names):
    """Where one prefill call's time goes (``group``, a captured prefill
    group): wall time (host clock, synchronized, median of 3) against the
    card's kernel time, the device time of the kernels whose names hold
    each of ``names`` and the largest kernels; and the same for the same
    call through the plain projection route (``dequantize`` + einsum per
    projection, the route before the packed-weight GEMM kernel), run in
    turn with it in this call of the script."""
    import torch
    from repro_torch.kernels.dequant_gemm import ops as dg_ops
    tokens, vision, last_idx = group[:3]

    def call():
        with torch.no_grad():
            eng._prefill(tokens, vision, last_idx)
        torch.cuda.synchronize()

    def measure():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)
        kernel_us, by_name, n = device_time(call)
        wall_ms = sorted(walls)[1] * 1e3
        return {"wall_ms": wall_ms, "device_ms": kernel_us / 1e3,
                "device_busy_share": kernel_us / 1e3 / wall_ms,
                "device_kernels": n,
                "kernels_ms_by_name": {
                    nm: sum(us for k, us, _ in by_name if nm in k) / 1e3
                    for nm in names},
                "top_kernels_ms": [[k[:96], us / 1e3]
                                   for k, us, _ in by_name[:10]]}
    out = {"batch": int(tokens.shape[0]), "width": int(tokens.shape[1])}
    out.update(measure())
    with swapped(dg_ops, "quant_einsum", dg_ops.ref_quant_einsum):
        out["plain_projection_route"] = measure()
    return out


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
    dt = cfg.torch_dtype
    es = torch.finfo(dt).bits // 8
    h4 = sm.randn(TIME_BC, 1, D, dtype=dt)
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
        byt = w_bytes + es * (TIME_BC * D + n_out + TIME_BC * n_out)
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
        rec["fused_mlp"] = (t_k, t_p, t_l, t_d, w_bytes + es * 2 * TIME_BC * D,
                            2 * TIME_BC * 3 * D * F)

        kp, vp = eng.slots.pool[0]
        nb, bs = kp.shape[1], kp.shape[2]
        k_rows = sm.randn(L, TIME_BC, KV, hd, dtype=dt)
        v_rows = sm.randn(L, TIME_BC, KV, hd, dtype=dt)
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
                                 2 * es * (2 * L * TIME_BC * KV * hd)
                                 + 2 * 4 * TIME_BC, 0)
    return rec


def time_cache_update(sm, cfg):
    """The cache-row-update kernel, its plain version and ``index_put_``
    (``cache[b, index] = row``) at the composed step's shape: a layer of a
    cohort-4 gathered context (n_slots x max_len x KV x hd, bf16), rotated
    over the layers of the stack; the bytes are the rows read and written
    once and the index read."""
    import torch
    from repro_torch.kernels.cache_update import (cache_row_update,
                                                  ref_cache_row_update)
    L, B, S = cfg.n_layers, N_SLOTS, MAX_LEN[cfg.name]
    KV, hd = cfg.n_kv_heads, cfg.hd
    stack = sm.randn(L, B, S, KV, hd)
    row = sm.randn(B, KV, hd)
    idx = torch.tensor([5, 700, 1400, S - 1], dtype=torch.int32,
                       device=sm.dev)
    b_idx, s_idx = torch.arange(B, device=sm.dev), idx.long()
    with torch.no_grad():
        t_k = timed(lambda i: cache_row_update(stack[i], row, idx), L)
        t_p = timed(lambda i: ref_cache_row_update(stack[i], row, idx), L)
        t_l = timed(lambda i: stack[i].index_put_((b_idx, s_idx), row), L)
    return t_k, t_p, t_l, None, 2 * 2 * B * KV * hd + 4 * B, 0


def time_flash(sm, shape=None, dtype=None):
    """The flash kernel, its plain version and SDPA (GQA through
    ``enable_gqa``) at ``shape`` (FLASH_TIME_SHAPE by default) in
    ``dtype`` (bf16 by default)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     ref_attention)
    B, Sq, Sk, H, KV, hd, causal = shape or FLASH_TIME_SHAPE
    dtype = dtype or torch.bfloat16
    q = sm.randn(B, Sq, H, hd, dtype=dtype)
    k = sm.randn(B, Sk, KV, hd, dtype=dtype)
    v = sm.randn(B, Sk, KV, hd, dtype=dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        t_k = timed(lambda i: flash_attention(q, k, v, causal=causal), 1,
                    iters=20)
        t_p = timed(lambda i: ref_attention(q, k, v, causal=causal), 1,
                    iters=5)
        t_l = timed(lambda i: Fn.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 1, iters=20)
    byt = q.element_size() * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    pairs = Sq * (Sq + 1) // 2 if causal and Sq == Sk else Sq * Sk
    fl = 4 * B * H * hd * pairs            # q.k and p.v, keys each row sees
    return t_k, t_p, t_l, None, byt, fl


def serve_composed(sm, cfg, reqs, op_module, op_name):
    """Serve ``reqs`` on ``cfg`` at full width with ``cfg``'s dtype
    through the composed decode step over a slot-state pool, recording
    every call of the prefill kernel wrapper ``op_module.<op_name>``
    (arguments kept by reference, not copied: the model writes none of
    them after the call) and the packed-weight GEMM calls of the first
    prefill call (``GemmCalls``, checked by ``served_gemm_check`` into
    the record's ``gemm_served_check``).  Returns (serve record, engine,
    run) with
    ``run`` = (requests, prefill groups [(tokens, vision embeds,
    last_idx, logits)], decode steps [(slot ids, lengths, logits)],
    kernel calls [(args, kwargs, out)])."""
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.decoder import mixer_of
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
    if eng.use_fused or eng.slots.paged != (False,):
        fail(f"{cfg.name}: expected the composed step over a slot pool")
    groups, steps, calls = [], [], []
    decode, prefill = eng._decode, eng._prefill
    kernel = getattr(op_module, op_name)

    def recording_prefill(tokens, vision_embeds, last_idx):
        gemms.armed = not groups                          # the first call
        try:
            logits, cache = prefill(tokens, vision_embeds, last_idx)
        finally:
            gemms.armed = False
        groups.append((tokens.clone(), None if vision_embeds is None
                       else vision_embeds.clone(), last_idx.clone(),
                       logits.clone()))
        return logits, cache

    def recording_decode(tokens, lengths, slot_ids, tables):
        logits, pool = decode(tokens, lengths, slot_ids, tables)
        steps.append((slot_ids.tolist(), lengths.tolist(), logits.clone()))
        return logits, pool

    def recording_kernel(*args, **kwargs):
        out = kernel(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    eng._decode, eng._prefill = recording_decode, recording_prefill
    setattr(op_module, op_name, recording_kernel)
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with GemmCalls() as gemms, eng:
            done = eng.run()
        torch.cuda.synchronize()
    finally:
        setattr(op_module, op_name, kernel)
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    eng._decode, eng._prefill = decode, prefill
    decode_steps = sum(1 for e in eng.trace if e.event == "decode_step")
    errors = [r for r in done if r.error is not None]
    if len(done) != len(reqs) or errors:
        fail(f"{cfg.name}: requests failed: "
             f"{[repr(r.error) for r in errors]}")
    eng.slots.check_block_invariants()
    for r in done:
        if not (len(r.out_tokens) == r.max_new_tokens and all(
                0 <= t < cfg.vocab_size for t in r.out_tokens)):
            fail(f"{cfg.name}: request {r.rid} tokens {r.out_tokens}")
    gemm_route = f"dequant_gemm/{GEMM_ROUTE[cfg.dtype]}"
    # the wrapper's route count, where it has routes (ssd/mma, ssd/simt)
    op_route = (f"{op_name}/{SSD_ROUTE[cfg.dtype]}" if op_name == "ssd"
                else op_name)
    others = sum(v for k, v in launches.items()
                 if k not in (op_name, op_route, "dequant_gemm", gemm_route))
    per_call = GEMMS_PER_LAYER[mixer_of(cfg)] * cfg.n_layers
    if not (launches[op_name] == launches[op_route]
            == cfg.n_layers * len(groups) == len(calls)
            and launches["dequant_gemm"] == launches[gemm_route]
            == per_call * len(groups)
            and groups and decode_steps > 0 and others == 0):
        fail(f"{cfg.name}: launch counts {launches} for {decode_steps} "
             f"decode steps and {len(groups)} prefill calls")
    spans = eng.probe.samples()
    pre = [s for s in spans if s.brick == "decoder" and s.phase == "prefill"]
    decs = [s for s in spans if s.brick == "decoder" and s.phase == "decode"]
    serve = {"arch": cfg.name, "dtype": cfg.dtype, "requests": len(done),
             "prompt_tokens": [len(r.tokens) for r in reqs],
             "decode_steps": decode_steps,
             "decoded_tokens": eng.stats.decoded_tokens,
             "setup_s": round(setup_s, 3), "serve_s": round(serve_s, 3),
             "prefill_calls": len(groups),
             "prefill_batch": [int(g[0].shape[0]) for g in groups],
             "prefill_width": [int(g[0].shape[1]) for g in groups],
             "prefill_ms": [round(s.dt * 1e3, 3) for s in pre],
             "prefill_tokens": [s.tokens for s in pre],
             "decode_step_ms_mean": round(1e3 * sum(s.dt for s in decs)
                                          / max(1, len(decs)), 3),
             "decode_tok_s": round(sum(s.tokens for s in decs)
                                   / max(1e-9, sum(s.dt for s in decs)), 3),
             "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                  3),
             "state_pool_mb": round(eng.slots.nbytes / 1e6, 3),
             "launches": launches,
             "gemm_served_check": dict(served_gemm_check(
                 cfg, gemms.calls, per_call),
                 prefill_batch=int(groups[0][0].shape[0]),
                 prefill_width=int(groups[0][0].shape[1]))}
    del gemms
    if eng.tabm is not None:
        serve["tabm"] = eng.tabm.stats
    return serve, eng, (reqs, groups, steps, calls)


def serve_mamba(sm, cfg):
    """Serve Mamba-2-1.3B's four text requests at full width with ``cfg``'s
    dtype, and hold every SSD kernel call of the serve (each layer of each
    prefill group, at the served shapes and dtype) against the plain
    ``ssd_chunked`` on the same inputs.  Returns ``serve_composed``'s
    (serve record, engine, run)."""
    import numpy as np
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, tokens=rng.integers(
        3, cfg.vocab_size - 1, n).astype(np.int32), max_new_tokens=16)
        for i, n in enumerate(MAMBA_PROMPTS)]
    serve, eng, run = serve_composed(sm, cfg, reqs, ssd_ops, "ssd")
    serve["ssd_served_check"] = served_ssd_check(
        cfg, [(args, out, kw["chunk"]) for args, kw, out in run[3]])
    return serve, eng, run


def served_ssd_check(cfg, calls):
    """Every recorded SSD kernel call of a serve against the plain version
    on its own inputs, with ``ssd_errors``' tolerances; the worst errors,
    the share of y elements where kernel and plain differ, and the (B, S,
    chunk, dtype) of the calls.  Beside the per-head measure, the
    reference's own (max |y - plain y| over the call's largest plain |y|,
    ``tests/test_kernels.py``); for fp32 calls also the kernel and the
    plain version each against a float64 evaluation (``ssd_chunked`` on
    float64 inputs), all three gated at SSD_Y_FP32_TOL."""
    import torch
    from repro_torch.kernels.ssd import ref_ssd_chunked
    keys = ("h_rel_err", "worst_head_y_err_over_max", "y_max_abs_err",
            "h_max_abs_err")
    worst = dict.fromkeys(keys, 0.0)
    ref_measure = {"kernel_vs_plain": 0.0, "kernel_vs_f64": 0.0,
                   "plain_vs_f64": 0.0}
    # bf16 calls: y and h_final of the kernel and of the plain version
    # against a float64 evaluation, in the reference's measure (reported)
    bf16_f64 = {"kernel_y": 0.0, "kernel_h": 0.0, "plain_y": 0.0,
                "plain_h": 0.0}
    shapes, differ, total, fp32 = set(), 0, 0, False
    with torch.no_grad():
        for args, out, chunk in calls:
            x = args[0]
            dtype = str(x.dtype).replace("torch.", "")
            *errs, n = ssd_errors(args, out, chunk, f"{cfg.name}: served "
                                  f"ssd at {tuple(x.shape)} {dtype}")
            for k, v in zip(keys, errs):
                worst[k] = max(worst[k], v)
            differ, total = differ + n, total + out[0].numel()
            shapes.add((int(x.shape[0]), int(x.shape[1]), chunk, dtype))
            if x.dtype != torch.float32:
                py, ph = ref_ssd_chunked(*args, chunk=chunk)
                fy, fh = ref_ssd_chunked(*(t.double() for t in args),
                                         chunk=chunk)
                for key, got, want in (("kernel_y", out[0], fy),
                                       ("kernel_h", out[1], fh),
                                       ("plain_y", py, fy),
                                       ("plain_h", ph, fh)):
                    got, want = got.double(), want.double()
                    bf16_f64[key] = max(bf16_f64[key], (
                        (got - want).abs().max() / want.abs().max()).item())
                del py, ph, fy, fh
                continue
            fp32 = True
            y = out[0].double()
            py = ref_ssd_chunked(*args, chunk=chunk)[0].double()
            fy = ref_ssd_chunked(*(t.double() for t in args),
                                 chunk=chunk)[0]
            for key, got, want in (("kernel_vs_plain", y, py),
                                   ("kernel_vs_f64", y, fy),
                                   ("plain_vs_f64", py, fy)):
                ref_measure[key] = max(ref_measure[key], (
                    (got - want).abs().max() / want.abs().max()).item())
            del py, fy
    torch.cuda.synchronize()
    rec = dict(worst, calls=len(calls), y_differing_share=differ / total,
               shapes_B_S_chunk_dtype=sorted(shapes),
               tol={"h": SSD_H_TOL, "y_head": KERNEL_TOL})
    if len(shapes) > sum(1 for sh in shapes if sh[3] == "float32"):
        rec["bf16_vs_f64_ref_measure"] = bf16_f64
    if fp32:
        rec["y_ref_measure"] = ref_measure
        rec["tol"]["y_ref_measure"] = SSD_Y_FP32_TOL
        if max(ref_measure.values()) > SSD_Y_FP32_TOL:
            fail(f"{cfg.name}: fp32 served ssd y in the reference's "
                 f"measure {ref_measure} (tol {SSD_Y_FP32_TOL})")
    return rec


def request_steps(r, steps, n_steps=2):
    """Request ``r``'s logits rows in its first ``n_steps`` decode steps
    (the steps whose row for its slot is at positions len(prompt),
    len(prompt) + 1, ...)."""
    n, rows = len(r.tokens), []
    for slot_ids, lengths, logits in steps:
        if r.slot in slot_ids:
            b = slot_ids.index(r.slot)
            if lengths[b] == n + len(rows):
                rows.append(logits[b])
        if len(rows) == n_steps:
            return rows
    fail(f"request {r.rid}: {len(rows)} of {n_steps} decode steps found")


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.<name>`` replaced by ``fn`` for the block (the model looks
    its kernel wrappers up at each call)."""
    kernel = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def padded_next_step(eng, cfg, tokens, vision, n, width):
    """The first ``n`` of ``tokens`` (host ints) right-padded to ``width``
    through the engine's prefill (with ``vision`` embeds or None), then
    one ``lm_decode_step`` on its greedy token: the next-step logits."""
    import torch
    from repro_torch.models import model as M
    dev = eng.device
    padded = torch.zeros((1, width), dtype=torch.int32, device=dev)
    padded[0, :n] = torch.as_tensor(tokens[:n], device=dev)
    last = torch.tensor([n], dtype=torch.int32, device=dev)
    logits, cache = eng._prefill(padded, vision, last)
    lw, _ = M.lm_decode_step(
        eng.params, cfg, logits.argmax(-1, keepdim=True).to(torch.int32),
        {"layers": cache["layers"], "index": last})
    return lw


def mamba_checks(sm, cfg, eng, run, tol, witness_share=None):
    """The engine against the port's own model, each within ``tol`` of the
    largest logit: (a) the 1024- and 100-token requests' first two decode
    steps against ``lm_prefill`` on the unpadded prompt plus
    teacher-forced ``lm_decode_step``; (b) the 1000- and 300-token
    prompts prefilled padded to the next bucket and the one above: the
    same next-step logits; (c) the largest prefill group rerun through
    the plain ``ssd_chunked``: the same prefill logits.  With
    ``witness_share`` (bf16) also the rounding witness: that group
    through the plain SSD again with that share of every layer's y
    elements (the share where the served kernel and the plain version
    differ) moved by one bf16 step up or down at random, against (c)'s
    plain logits — how far rounding alone carries through the stack."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import model as M
    torch = sm.torch
    reqs, groups, steps, _ = run
    dev = sm.dev

    def tok(t):
        return torch.tensor([[int(t)]], dtype=torch.int32, device=dev)

    checks = {}
    with torch.no_grad():
        for r in reqs:
            n = len(r.tokens)
            if n % min(cfg.ssm.chunk_size, n):
                continue                  # the chunk does not admit n
            _, cache = M.lm_prefill(eng.params, cfg, torch.from_numpy(
                r.tokens[None]).to(dev), MAX_LEN[cfg.name])
            got, want = request_steps(r, steps), []
            for i in range(len(got)):
                lw, cache = M.lm_decode_step(eng.params, cfg,
                                             tok(r.out_tokens[i]), cache)
                want.append(lw[0])
            checks[f"unpadded_{n}"] = logit_check(
                cfg, torch.stack(got), torch.stack(want),
                f"engine vs unpadded model ({n} tokens)", tol)
        if sorted(int(k.split("_")[1]) for k in checks) != [100, 1024]:
            fail(f"{cfg.name}: unpadded checks ran for {sorted(checks)}")

        for n, widths in ((1000, (1024, 2048)), (300, (512, 1024))):
            r = next(q for q in reqs if len(q.tokens) == n)
            a, b = (padded_next_step(eng, cfg, r.tokens, None, n, w)
                    for w in widths)
            checks[f"pad_{n}_{widths[0]}_vs_{widths[1]}"] = logit_check(
                cfg, a, b, f"pad invariance ({n} tokens)", tol)

        tokens, _, last, logits = max(groups, key=lambda g: g[0].numel())
        shape = {"batch": int(tokens.shape[0]),
                 "width": int(tokens.shape[1])}
        with swapped(ssd_ops, "ssd", ssd_ops.ref_ssd_chunked):
            plain_logits, _ = eng._prefill(tokens, None, last)
        checks["kernel_vs_plain_prefill"] = dict(logit_check(
            cfg, logits, plain_logits, "kernel vs plain SSD prefill", tol),
            **shape)

        if witness_share is not None:
            gen = torch.Generator(device=dev).manual_seed(3)

            def one_step_off(x, dt, A, Bm, Cm, *, chunk):
                y, h = ssd_ops.ref_ssd_chunked(x, dt, A, Bm, Cm,
                                               chunk=chunk)
                u = torch.rand(y.shape, generator=gen, device=dev)
                # +-1 on the bits of a nonzero bf16 is one step of its
                # magnitude (sign-magnitude); zeros stay
                step = ((u < witness_share / 2).to(torch.int16)
                        - (u > 1 - witness_share / 2).to(torch.int16))
                step = torch.where(y != 0, step, torch.zeros_like(step))
                return (y.view(torch.int16) + step).view(torch.bfloat16), h
            with swapped(ssd_ops, "ssd", one_step_off):
                off_logits, _ = eng._prefill(tokens, None, last)
            checks["bf16_rounding_witness"] = dict(logit_check(
                cfg, off_logits, plain_logits,
                "plain SSD one bf16 step off vs plain SSD prefill", tol),
                **shape)
    torch.cuda.synchronize()
    return checks


def composed_decode_breakdown(sm, cfg, eng):
    """Where one composed cohort-4 decode step's time goes, on the served
    slot pool (each slot holds its request's final state): wall time
    (host clock, synchronized, median of 5) against the card's kernel
    time, by kernel."""
    from repro_torch.kernels.fused_decode import cohort_step
    torch = sm.torch
    n = eng.slots.n_slots
    args = (torch.full((n, 1), 5, dtype=torch.int32, device=sm.dev),
            torch.full((n,), 1100, dtype=torch.int32, device=sm.dev),
            torch.arange(n, dtype=torch.int32, device=sm.dev),
            torch.zeros((n, eng.slots.blocks_per_slot), dtype=torch.int32,
                        device=sm.dev))

    def step():
        with torch.no_grad():
            cohort_step(eng.params, cfg, *args, eng.slots.pool,
                        block_size=eng.slots.block_size,
                        paged=eng.slots.paged)
        torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    kernel_us, by_name, _ = device_time(step)
    wall_ms = sorted(walls)[2] * 1e3
    return {"bc": n, "wall_ms": wall_ms, "device_ms": kernel_us / 1e3,
            "device_busy_share": kernel_us / 1e3 / wall_ms,
            "top_kernels_ms": [[k[:96], us / 1e3]
                               for k, us, _ in by_name[:8]]}


def linear_errors(args, out, chunk, valid_len, what):
    """The linear-attention kernel's (out, state, z) ``out`` on ``args``
    (q, k, v) against the plain chunked form: fails unless all are
    finite and of the plain shapes, state and z within LA_STATE_TOL of
    their largest magnitude, every output row (b, i, h) within
    LA_ROW_TOL of that row's largest plain magnitude, and every row at
    or past ``valid_len`` exactly zero.  Returns the errors."""
    import torch
    from repro_torch.kernels.linear_attention import (
        ref_linear_attention_chunked)
    o, st, z = out
    ro, rst, rz = ref_linear_attention_chunked(*args, chunk=chunk,
                                               valid_len=valid_len)
    if not (o.shape == ro.shape and st.shape == rst.shape
            and z.shape == rz.shape and o.isfinite().all()
            and st.isfinite().all() and z.isfinite().all()):
        fail(f"{what}: shape or non-finite output")
    s_rel = ((st - rst).abs().max() / rst.abs().max()).item()
    z_rel = ((z - rz).abs().max() / rz.abs().max()).item()
    err = (o.float() - ro.float()).abs().amax(-1)            # (B, S, H)
    m = ro.float().abs().amax(-1)
    ratio = torch.where(m > 0, err / m.clamp_min(1e-30),
                        torch.where(err > 0, float("inf"), 0.0))
    row = ratio.max().item()
    pad_rows, pad_nonzero = 0, 0
    if valid_len is not None:
        pad = (torch.arange(o.shape[1], device=o.device)[None, :]
               >= valid_len.to(o.device)[:, None])
        pad_rows = int(pad.sum()) * o.shape[2]
        pad_nonzero = int((o[pad] != 0).sum())
    tol = LA_ROW_TOL[str(o.dtype).replace("torch.", "")]
    if not (s_rel <= LA_STATE_TOL and z_rel <= LA_STATE_TOL and row <= tol
            and pad_nonzero == 0):
        fail(f"{what}: state rel err {s_rel}, z rel err {z_rel}, worst "
             f"row err/max {row} (tol {tol}), {pad_nonzero} nonzero "
             f"padded elements")
    return {"state_rel_err": s_rel, "z_rel_err": z_rel,
            "worst_row_err_over_max": row,
            "out_max_abs_err": err.max().item(),
            "padded_rows_exactly_zero": pad_rows}


def serve_linear(sm, cfg, reqs):
    """Serve ``reqs`` on LLaVA-OneVision-0.5B with ``attn_impl="linear"``
    at full width with ``cfg``'s dtype, and hold every linear-attention
    kernel call of the serve (each layer of each prefill group, at the
    served shapes, dtype and ``valid_len``) against the plain chunked
    form on the same inputs.  Returns ``serve_composed``'s (serve record,
    engine, run)."""
    from repro_torch.kernels.linear_attention import ops as la_ops
    serve, eng, run = serve_composed(sm, cfg, reqs, la_ops,
                                     "linear_attention")
    tstats = serve["tabm"]
    if tstats["writes"] != tstats["reads"] or tstats["shares"] != 1:
        fail(f"{cfg.name} (linear): TABM writes/reads/shares {tstats}")
    worst, shapes = {}, set()
    with sm.torch.no_grad():
        for args, kw, out in run[3]:
            q, vl = args[0], kw.get("valid_len")
            dtype = str(q.dtype).replace("torch.", "")
            rec = linear_errors(args, out, kw["chunk"], vl,
                                f"{cfg.name}: served linear attention at "
                                f"{tuple(q.shape)} {dtype}")
            for k, v in rec.items():
                worst[k] = max(worst.get(k, 0), v)
            shapes.add((int(q.shape[0]), int(q.shape[1]), kw["chunk"],
                        dtype))
    sm.torch.cuda.synchronize()
    serve["linear_served_check"] = dict(
        worst, calls=len(run[3]), shapes_B_S_chunk_dtype=sorted(shapes),
        tol={"state_z": LA_STATE_TOL, "row": LA_ROW_TOL})
    return serve, eng, run


def linear_checks(sm, cfg, eng, run, tol):
    """The linear-attention engine against the port's own model, each
    within ``tol`` of the largest logit: (a) every request's prefill
    logits and first two decode steps against its unpadded prompt (its
    tokens and the served vision embeds) prefilled through the plain
    chunked form at the largest chunk up to 256 that divides its length
    (745 = 5 x 149 admits no 256-chunk), plus teacher-forced
    ``lm_decode_step``; (b) the 745- and 212-token prompts padded to their
    bucket and the one above: the same next-step logits; (c) the largest
    prefill group rerun through the plain version: the same logits."""
    from repro_torch.kernels.linear_attention import ops as la_ops
    from repro_torch.models import model as M
    torch = sm.torch
    reqs, groups, steps, _ = run
    dev = sm.dev

    def served_row(r):
        """(tokens (1, n), vision embeds, prefill logits) of ``r``'s row
        in its prefill group."""
        n = len(r.tokens)
        want = torch.from_numpy(r.tokens).to(dev)
        for tokens, vision, last, logits in groups:
            for b in range(tokens.shape[0]):
                if int(last[b]) == n and torch.equal(tokens[b, :n], want):
                    return (tokens[b:b + 1, :n], None if vision is None
                            else vision[b:b + 1], logits[b])
        fail(f"request {r.rid}: no prefill row")

    def divisor_chunk(q, k, v, *, chunk, valid_len=None):
        S = q.shape[1]
        c = max(d for d in range(1, min(chunk, S) + 1) if S % d == 0)
        return la_ops.ref_linear_attention_chunked(q, k, v, chunk=c,
                                                   valid_len=valid_len)

    checks = {}
    with torch.no_grad():
        for r in reqs:
            n = len(r.tokens)
            tokens, vision, first = served_row(r)
            last = torch.tensor([n], dtype=torch.int32, device=dev)
            with swapped(la_ops, "linear_attention", divisor_chunk):
                lw, cache = eng._prefill(tokens, vision, last)
            cache = {"layers": cache["layers"], "index": last}
            got, want = [first] + request_steps(r, steps), [lw[0]]
            for t in r.out_tokens[:len(got) - 1]:
                lw, cache = M.lm_decode_step(eng.params, cfg, torch.tensor(
                    [[int(t)]], dtype=torch.int32, device=dev), cache)
                want.append(lw[0])
            checks[f"unpadded_r{r.rid}_{n}"] = logit_check(
                cfg, torch.stack(got), torch.stack(want),
                f"linear engine vs unpadded model (request {r.rid}, {n} "
                f"tokens)", tol)
        for n, widths in ((745, (1024, 2048)), (212, (256, 512))):
            r = next(q for q in reqs if len(q.tokens) == n)
            _, vision, _ = served_row(r)
            a, b = (padded_next_step(eng, cfg, r.tokens, vision, n, w)
                    for w in widths)
            checks[f"pad_{n}_{widths[0]}_vs_{widths[1]}"] = logit_check(
                cfg, a, b, f"linear pad invariance ({n} tokens)", tol)
        tokens, vision, last, logits = max(groups,
                                           key=lambda g: g[0].numel())
        with swapped(la_ops, "linear_attention",
                     la_ops.ref_linear_attention_chunked):
            plain_logits, _ = eng._prefill(tokens, vision, last)
        checks["kernel_vs_plain_prefill"] = dict(logit_check(
            cfg, logits, plain_logits, "kernel vs plain linear prefill",
            tol), batch=int(tokens.shape[0]), width=int(tokens.shape[1]))
    torch.cuda.synchronize()
    return checks


def linear_attention_work(B, S, H, KV, hd, chunk, esize=2):
    """(bytes, operations) the linear-attention function needs: q, k, v
    (k and v at kv-head width) and out in ``esize``-byte elements, state
    and z in fp32, each read or written once; the operations of its
    recurrent form, the least any form needs (the chunk changes only
    rounding): per kv head and row, S += phi(k) v^T and z += phi(k),
    2 hd^2 + hd; per query head and row, phi(q).S and phi(q).z, 2 hd^2 +
    2 hd; phi of q and k and the division, one per element."""
    byt = (esize * (2 * B * S * H * hd + 2 * B * S * KV * hd)
           + 4 * B * H * (hd * hd + hd))
    fl = (B * KV * S * (2 * hd * hd + hd)
          + B * H * S * (2 * hd * hd + 2 * hd)
          + B * S * (2 * H + KV) * hd)
    return byt, fl


def linear_attention_tile_ops(B, S, H, KV, hd, chunk, tile=64):
    """The operations of the kernel's own form (``csrc/linear_attention.cu``),
    64-row tiles of each chunk: per query head, the diagonal tile's causal
    pairs (4 hd + 1 each) and phi(q).S_before and phi(q).z_before on every
    row after the first tile (2 hd^2 + 2 hd); per kv head the tile states
    (2 hd^2 + hd a row) and the scan over tiles (hd^2 + hd a tile after
    the first); phi and the division as ``linear_attention_work``."""
    L = min(chunk, S)
    rows = [min(tile, L - i) for i in range(0, L, tile)] * (S // L)
    pairs = sum(r * (r + 1) // 2 for r in rows)
    return (B * H * pairs * (4 * hd + 1)
            + B * H * (S - rows[0]) * (2 * hd * hd + 2 * hd)
            + B * KV * S * (2 * hd * hd + hd)
            + B * KV * (len(rows) - 1) * (hd * hd + hd)
            + B * S * (2 * H + KV) * hd)


def time_linear(sm):
    """The linear-attention kernel and its plain version at LA_SHAPE
    (bf16, the served dtype), and the work (``linear_attention_work``)
    that sets its bound."""
    import torch
    from repro_torch.kernels.linear_attention import (
        linear_attention, ref_linear_attention_chunked)
    B, S, H, KV, hd, chunk = LA_SHAPE
    args = sm.la_inputs(B, S, H, KV, hd, torch.bfloat16)
    with torch.no_grad():
        t_k = timed(lambda i: linear_attention(*args, chunk=chunk), 1,
                    iters=50)
        t_p = timed(lambda i: ref_linear_attention_chunked(
            *args, chunk=chunk), 1, iters=10)
    return (t_k, t_p) + linear_attention_work(*LA_SHAPE)


def ssd_terms(B, S, H, P, G, N, chunk):
    """The operations of the chunked form with nothing computed twice, by
    term.  Per chunk of L rows (L(L+1)/2 causal pairs):
    - ``cb``: C.B^T once per (b, group), causal half: 2 N per pair;
    - ``decay``: the weights per head, CB exp(cum_i - cum_j) dt_j: 4 per
      pair;
    - ``wx``: the weights times x: 2 P per pair and head;
    - ``inter``: exp(cum_i) C_i.h_prev, from the second chunk on (h_prev =
      0 before it): 2 N P per row and head (the product) and ``inter_scale``
      2 P;
    - ``state``: the chunk's state, x^T (B exp(cum_last - cum) dt): 2 N P
      per row and head, and ``state_scale`` N; the ``scan`` over chunks, h
      = a h + s: 2 P N per head from the second chunk on; ``cumsum``: dt A
      and the cumsum, 2 per row and head."""
    L = min(chunk, S)
    nc, pairs = S // L, L * (L + 1) // 2
    return {"cb": B * G * nc * 2 * N * pairs,
            "decay": B * H * nc * 4 * pairs,
            "wx": B * H * nc * 2 * P * pairs,
            "inter": B * H * (nc - 1) * L * 2 * N * P,
            "inter_scale": B * H * (nc - 1) * L * 2 * P,
            "state": B * H * nc * L * 2 * N * P,
            "state_scale": B * H * nc * L * N,
            "scan": B * H * (nc - 1) * 2 * P * N,
            "cumsum": B * H * nc * L * 2}


def ssd_work(B, S, H, P, G, N, chunk):
    """(bytes, operations) the SSD function needs: bf16 x, B, C and y,
    fp32 dt, A and h_final, each read or written once; the operations of
    ``ssd_terms`` summed."""
    byt = (2 * B * S * H * P * 2 + B * S * H * 4 + H * 4
           + 2 * B * S * G * N * 2 + B * H * P * N * 4)
    return byt, sum(ssd_terms(B, S, H, P, G, N, chunk).values())


# the products the bf16 route runs on the tensor cores with a split fp32
# operand (three bf16 products each); C.B^T takes one
SSD_SPLIT_PRODUCTS = ("wx", "inter", "state")


def ssd_mma_bound(B, S, H, P, G, N, chunk):
    """The least ms of the bf16 route's own count: C.B^T once and each
    split product three times at 989 TFLOP/s bf16, the elementwise terms
    at the 67 TFLOP/s fp32 rate, against the bytes of ``ssd_work`` at 3.35
    TB/s; (ms, what bounds it, tensor-core flop, fp32 flop)."""
    terms = ssd_terms(B, S, H, P, G, N, chunk)
    tc = terms["cb"] + 3 * sum(terms[k] for k in SSD_SPLIT_PRODUCTS)
    simt = sum(v for k, v in terms.items()
               if k != "cb" and k not in SSD_SPLIT_PRODUCTS)
    t_ops = tc / BF16_FLOPS_PER_S + simt / FP32_FLOPS_PER_S
    t_bytes = ssd_work(B, S, H, P, G, N, chunk)[0] / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", tc, simt)


SSD_PHASES = ("ssd_cb_", "ssd_state_", "ssd_scan_", "ssd_out_")


def time_ssd(sm, dtype=None):
    """The SSD kernel and its plain version at SSD_SHAPE (bf16 inputs,
    the served route, or ``dtype``), the work (``ssd_work``) that sets
    its bound, and the device ms of each of its four phases (profiler
    rows by kernel name, per call)."""
    import torch
    from repro_torch.kernels.ssd import ref_ssd_chunked, ssd
    B, S, H, P, G, N, chunk = SSD_SHAPE
    args = sm.ssd_inputs(B, S, H, P, G, N)
    if dtype is not None:
        args = tuple(t.to(dtype) if t.dtype == torch.bfloat16 else t
                     for t in args)
    iters = 20
    with torch.no_grad():
        t_k = timed(lambda i: ssd(*args, chunk=chunk), 1, iters=iters)
        t_p = timed(lambda i: ref_ssd_chunked(*args, chunk=chunk), 1,
                    iters=3)

        def loop():
            for _ in range(iters):
                ssd(*args, chunk=chunk)
            torch.cuda.synchronize()
        _, rows, _ = device_time(loop)
    phases = {ph.rstrip("_"): sum(us for k, us, _ in rows if ph in k)
              / iters / 1e3 for ph in SSD_PHASES}
    return (t_k, t_p) + ssd_work(*SSD_SHAPE) + (phases,)


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
    from repro_torch.kernels.cache_update import kernel as CK
    from repro_torch.kernels.dequant_gemm import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_decode import kernel as K
    from repro_torch.kernels.linear_attention import kernel as LK
    from repro_torch.kernels.ssd import kernel as SK
    libs = (K, FK, SK, LK, DK, CK)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build: one nvcc per library, all at once ------------------------
    t0 = time.perf_counter()
    build.build_all({m.LIBRARY: m.SOURCES for m in libs})
    for m in libs:
        m.library()
    build_s = time.perf_counter() - t0
    ptxas = {m.LIBRARY: [ln.strip() for ln in build.build_log(
        m.LIBRARY, m.SOURCES).splitlines() if "Used" in ln or "spill" in ln][
        :40] for m in libs}
    print(json.dumps({"build": {"seconds": round(build_s, 3),
                                "ptxas": ptxas}}))

    # -- 2. kernel checks at the served shapes ------------------------------
    sm = Smoke()
    llava = get_config("llava-onevision-0.5b")
    qwen = dataclasses.replace(get_config("qwen2-vl-7b"), attn_q_chunk=0)
    mamba = get_config("mamba2-1.3b")
    sm.check_fused(llava, (1, 2, 4, 8))
    sm.check_fused(qwen, (1, 2, 4))
    sm.check_fused_fp32(llava, (1, 2, 4, 8))
    sm.check_fused_fp32(qwen, (1, 2, 4, 8))
    free()
    sm.check_flash()
    sm.check_flash_grid()
    sm.check_cache_update(llava)
    sm.check_ssd()
    sm.check_linear_attention()
    # LLaVA's projections serve in fp32 too (the fp32 linear-attention
    # instance), Mamba-2's as well
    sm.check_dequant_gemm(((llava, (torch.bfloat16, torch.float32)),
                           (qwen, (torch.bfloat16,)),
                           (mamba, (torch.bfloat16, torch.float32))))
    free()
    print(json.dumps({"kernel_checks": {
        "fused_bc": {llava.name: [1, 2, 4, 8], qwen.name: [1, 2, 4]},
        "fp32": sm.fp32_check,
        "cache_row_update": sm.cu_check,
        "flash_shapes": [list(s) for s in FLASH_SHAPES],
        "ssd": sm.ssd_check,
        "dequant_gemm": sm.dg_check,
        "linear_attention": {"cases": sm.la_check,
                             "tol": {"state_z": LA_STATE_TOL,
                                     "row": LA_ROW_TOL}},
        "max_abs_err": sm.errs, "tol_rel": KERNEL_TOL,
        "flash_worst_row_err_over_row_max": sm.worst_row_ratio,
        "kv_pool_blocks": {a: N_SLOTS * n // BLOCK_SIZE
                           for a, n in MAX_LEN.items()}}}))

    # -- 3. serve LLaVA-OneVision-0.5B --------------------------------------
    serves, timings = {}, {}
    llava_reqs = [(729, 1, None), (196, 1, None), (729, 1, 0),
                  (196, 1, None)]
    serve, eng, captured = serve_path(sm, llava, requests(
        llava, llava_reqs, seed=0))
    serve["prefill_breakdown"] = prefill_breakdown(eng, captured,
                                                   ("dequant_gemm",))
    print(json.dumps({"serve": serve}))
    serves[llava.name] = serve
    timings[llava.name] = time_fused(sm, llava, eng)
    del eng, captured
    free()

    # -- 3a. the same LLaVA serve through the composed decode step: the
    # cache-row-update kernel on the donated gathered caches ---------------
    serve, eng, _ = serve_path(sm, llava, requests(llava, llava_reqs, seed=0),
                               use_fused=False)
    print(json.dumps({"serve": serve}))
    serves[COMPOSED_PATH] = serve
    timings["cache_row_update"] = time_cache_update(sm, llava)
    del eng
    free()

    # -- 3b. LLaVA in fp32 with the engine's default decode step: prefill
    # through the fp32 flash kernel, decode through the fp32 fused kernels -
    llava32 = dataclasses.replace(llava, dtype="float32", attn_q_chunk=0)
    serve, eng, captured = serve_path(sm, llava32, requests(
        llava32, llava_reqs, seed=0))
    serve["prefill_plain_check"] = prefill_plain_check(eng, llava32,
                                                       captured)
    print(json.dumps({"serve": serve}))
    serves[FP32_PATH] = serve
    timings[FP32_PATH] = time_fused(sm, llava32, eng)
    del eng, captured
    free()

    # -- 4. serve Qwen2-VL-7B, prefill through the flash kernel -------------
    serve, eng, captured = serve_path(sm, qwen, requests(
        qwen, [(1024, 1, None), (1024, 1, 0), (256, 1, None),
               (1024, 4, None)], seed=1))
    serve["prefill_branch_check"] = prefill_branch_check(eng, qwen, captured)
    serve["prefill_breakdown"] = prefill_breakdown(
        eng, captured, ("flash_attention", "dequant_gemm"))
    print(json.dumps({"serve": serve}))
    serves[qwen.name] = serve
    timings[qwen.name] = time_fused(sm, qwen, eng)
    del eng, captured
    free()

    # -- 5. serve LLaVA-OneVision-0.5B with streaming linear attention,
    # prefill through the linear-attention kernel --------------------------
    linear = dataclasses.replace(llava, attn_impl="linear",
                                 subquadratic=True)
    serve, eng, run = serve_linear(sm, linear, requests(linear, llava_reqs,
                                                        seed=0))
    serve["checks"] = linear_checks(sm, linear, eng, run, STEP_TOL)
    serve["prefill_breakdown"] = prefill_breakdown(
        eng, max(run[1], key=lambda g: g[0].numel()),
        ("la_", "dequant_gemm"))
    serve["decode_step_breakdown"] = composed_decode_breakdown(sm, linear,
                                                               eng)
    serve["softmax_kv_pool_mb"] = serves[llava.name]["kv_pool_mb"]
    del eng, run
    free()
    linear32 = dataclasses.replace(linear, dtype="float32")
    serve32, eng, run = serve_linear(sm, linear32, requests(
        linear32, llava_reqs, seed=0))
    serve["fp32"] = {k: serve32[k] for k in (
        "prefill_calls", "prefill_ms", "decode_tok_s", "launches",
        "linear_served_check", "gemm_served_check")}
    serve["fp32"]["checks"] = linear_checks(sm, linear32, eng, run, STEP_TOL)
    print(json.dumps({"serve": serve}))
    serves[LINEAR_PATH] = serve
    del eng, run
    free()

    # -- 6. serve Mamba-2-1.3B, prefill through the SSD kernel -------------
    # The logit checks hold at STEP_TOL on an fp32 instance of the same
    # config and at BF16_LOGIT_TOL in bf16, where a one-step rounding
    # difference anywhere (kernel vs plain SSD, cohort 4 vs 1) grows
    # through the 48 layers' dt -> exp(dt A) decay past STEP_TOL
    serve, eng, run = serve_mamba(sm, mamba)
    serve["checks"] = mamba_checks(
        sm, mamba, eng, run, BF16_LOGIT_TOL,
        witness_share=serve["ssd_served_check"]["y_differing_share"])
    serve["prefill_breakdown"] = prefill_breakdown(
        eng, max(run[1], key=lambda g: g[0].numel()),
        ("ssd_", "dequant_gemm"))
    serve["decode_step_breakdown"] = composed_decode_breakdown(sm, mamba,
                                                               eng)
    del eng, run
    free()
    mamba32 = dataclasses.replace(mamba, dtype="float32")
    serve32, eng, run = serve_mamba(sm, mamba32)
    serve["fp32"] = {k: serve32[k] for k in (
        "prefill_calls", "prefill_ms", "decode_tok_s", "launches",
        "ssd_served_check", "gemm_served_check")}
    serve["fp32"]["checks"] = mamba_checks(sm, mamba32, eng, run, STEP_TOL)
    sm.errs["ssd"] = max(sm.errs["ssd"],
                         serve["ssd_served_check"]["y_max_abs_err"])
    print(json.dumps({"serve": serve}))
    serves[mamba.name] = serve
    del eng, run
    free()

    # -- 7. the flash kernel and the packed-weight GEMM at Qwen2-VL's
    # prefill shapes, the SSD and linear-attention kernels at their check
    # shapes ----------------------------------------------------------------
    flash_ts = {shape[5]: time_flash(sm, shape) for shape in FLASH_HD_TIMES}
    flash_t = flash_ts[FLASH_TIME_SHAPE[5]]
    flash32_t = time_flash(sm, FLASH_FP32_TIME_SHAPE, torch.float32)
    ssd_t = time_ssd(sm)
    ssd32_t = time_ssd(sm, torch.float32)
    la_t = time_linear(sm)
    dg_t = time_dequant_gemm(sm)
    gemm_rows = time_gemm_shapes(sm, (qwen, llava, mamba))
    print(json.dumps({"gemm_shapes": gemm_rows}))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    launch_key = {"fused_qkv": "fused_qkv", "fused_mlp": "fused_mlp",
                  "kv_row_scatter": "kv_scatter",
                  "flash_attention": "flash_attention", "ssd": "ssd",
                  "linear_attention": "linear_attention",
                  "dequant_gemm": "dequant_gemm",
                  "cache_row_update": "cache_row_update"}
    replaces = {
        "fused_qkv": "src/repro/kernels/fused_decode/kernel.py:92",
        "fused_mlp": "src/repro/kernels/fused_decode/kernel.py:138",
        "kv_row_scatter": "src/repro/kernels/fused_decode/kernel.py:174",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:55",
        "ssd": "src/repro/kernels/ssd/kernel.py:69",
        "linear_attention": "src/repro/kernels/linear_attention/kernel.py:68",
        "dequant_gemm": "src/repro/kernels/dequant_gemm/kernel.py:84",
        "cache_row_update": "src/repro/kernels/cache_update/kernel.py:31"}
    sources = {"flash_attention": "src/repro_torch/csrc/flash_attention.cu",
               "ssd": "src/repro_torch/csrc/ssd.cu",
               "linear_attention": "src/repro_torch/csrc/linear_attention.cu",
               "dequant_gemm": "src/repro_torch/csrc/dequant_gemm.cu",
               "cache_row_update": "src/repro_torch/csrc/cache_update.cu"}
    # every counted run: the four serves and the two fp32 instances
    records = dict(serves)
    records.update({f"{a}/fp32": s["fp32"] for a, s in serves.items()
                    if "fp32" in s})
    runs = {a: r["launches"] for a, r in records.items()}

    def numbers(t, flops_per_s=BF16_FLOPS_PER_S):
        t_k, t_p, t_l, t_d, byt, fl = t
        b_ms, b_by = bound(byt, fl, flops_per_s)
        out = {"ms": dev_or_call(t_k), "plain_ms": dev_or_call(t_p),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": dev_or_call(t_l),
               "ms_source": ("profiler device time" if t_k[0] is not None
                             else "CUDA events per call"),
               "device_kernels_per_call": t_k[2], "call_ms": t_k[1],
               "plain_call_ms": t_p[1], "library_call_ms": t_l[1],
               "bytes": byt, "flops": fl,
               "event_ms": t_k[1],
               "effective_GB_s": byt / dev_or_call(t_k) / 1e6}
        if t_d is not None:
            out["dense_bf16_matmul_ms"] = dev_or_call(t_d)
        return out

    kernels = []
    def fp32_numbers(name, t, shape_names, shape, path, served_check):
        """The entry of kernel ``name``, whose contract is fp32
        arithmetic: its bound at the 67 TFLOP/s fp32 FFMA peak, and the
        launches per prefill call measured on ``path``."""
        t_k, t_p, byt, fl = t
        b_ms, b_by = bound(byt, fl, FP32_FLOPS_PER_S)
        return {
            "ms": dev_or_call(t_k), "plain_ms": dev_or_call(t_p),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "bound_ms_at_bf16_peak": bound(byt, fl)[0],
            "bound_by_at_bf16_peak": bound(byt, fl)[1],
            "ms_source": ("profiler device time" if t_k[0] is not None
                          else "CUDA events per call"),
            "device_kernels_per_call": t_k[2], "call_ms": t_k[1],
            "plain_call_ms": t_p[1], "bytes": byt, "flops": fl,
            "shape": dict(zip(shape_names, shape)),
            "launches_per_prefill_call": (
                serves[path]["launches"][launch_key[name]]
                / serves[path]["prefill_calls"]),
            "served_check": served_check}

    def by_route(name, routes):
        """Launches of each kernel behind wrapper ``name`` over every
        counted run."""
        return {r: sum(n[f"{name}/{r}"] for n in runs.values())
                for r in sorted(set(routes.values()))}

    for name in ("fused_qkv", "fused_mlp", "kv_row_scatter",
                 "flash_attention", "ssd", "linear_attention",
                 "dequant_gemm", "cache_row_update"):
        by_path = {a: n[launch_key[name]] for a, n in runs.items()}
        entry = {"name": name, "route": "cuda",
                 "source": sources.get(
                     name, "src/repro_torch/csrc/fused_decode.cu"),
                 "replaces": replaces[name],
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": sm.errs[name]}
        if name == "flash_attention":
            entry.update(numbers(flash_t))
            entry["event_ms"] = flash_t[0][1]
            entry["launches_by_route"] = by_route(name, FLASH_ROUTE)
            entry["shape"] = dict(zip(("B", "Sq", "Sk", "H", "KV", "hd",
                                       "causal"), FLASH_TIME_SHAPE))
            entry["hd64"] = dict(
                numbers(flash_ts[64]), event_ms=flash_ts[64][0][1],
                shape=dict(zip(("B", "Sq", "Sk", "H", "KV", "hd", "causal"),
                               FLASH_HD_TIMES[0])))
            entry["library"] = "F.scaled_dot_product_attention(enable_gqa)"
            r_ms, r_by = bound(flash32_t[4], 3 * flash32_t[5],
                               TF32_FLOPS_PER_S)
            entry["fp32"] = dict(
                numbers(flash32_t, FP32_FLOPS_PER_S),
                shape=dict(zip(("B", "Sq", "Sk", "H", "KV", "hd", "causal"),
                               FLASH_FP32_TIME_SHAPE)),
                library="F.scaled_dot_product_attention(enable_gqa), fp32",
                route=FLASH_ROUTE["float32"],
                bound_ms_tf32x3_route=r_ms, bound_by_tf32x3_route=r_by,
                bound_note=("bound_ms at the fp32 FFMA peak (67 TFLOP/s); "
                            "bound_ms_tf32x3_route: the route's own count, "
                            "three TF32 products at 495 TFLOP/s dense"),
                launches_per_prefill_call=(
                    serves[FP32_PATH]["launches"]["flash_attention"]
                    / serves[FP32_PATH]["prefill_calls"]),
                served_check=serves[FP32_PATH]["flash_served_check"],
                checks=sm.fp32_check["flash_attention"])
            entry["hd160"] = dict(
                numbers(flash_ts[160]), event_ms=flash_ts[160][0][1],
                shape=dict(zip(("B", "Sq", "Sk", "H", "KV", "hd", "causal"),
                               FLASH_HD160[0])),
                checked=[list(c) for c in FLASH_HD160])
        elif name == "ssd":
            entry.update(fp32_numbers(
                name, ssd_t[:4], ("B", "S", "H", "P", "G", "N", "chunk"),
                SSD_SHAPE, mamba.name,
                serves[mamba.name]["ssd_served_check"]))
            entry["bound_note"] = (
                "bound_ms at the fp32 FFMA peak (67 TFLOP/s): the kernel's "
                "contract is fp32 arithmetic; operations as ssd_work counts "
                "them (C.B^T once per group, causal halves); "
                "bound_ms_mma_route: the bf16 route's own count, the split "
                "products 3x at 989 TFLOP/s bf16 (ssd_mma_bound)")
            m_ms, m_by, m_tc, m_simt = ssd_mma_bound(*SSD_SHAPE)
            entry.update(route="cuda", event_ms=ssd_t[0][1],
                         phases_ms=ssd_t[4], bound_ms_mma_route=m_ms,
                         bound_by_mma_route=m_by,
                         flops_mma_route={"tensor_core_bf16": m_tc,
                                          "fp32": m_simt},
                         launches_by_route=by_route(name, SSD_ROUTE),
                         served_route=SSD_ROUTE)
            entry["fp32_route"] = dict(
                fp32_numbers(name, ssd32_t[:4], ("B", "S", "H", "P", "G",
                                                 "N", "chunk"), SSD_SHAPE,
                             mamba.name,
                             serves[mamba.name]["fp32"]["ssd_served_check"]),
                event_ms=ssd32_t[0][1], phases_ms=ssd32_t[4],
                inputs="float32 x, B, C")
            entry["fp32_route"].pop("launches_per_prefill_call")
        elif name == "linear_attention":
            entry.update(fp32_numbers(
                name, la_t, ("B", "S", "H", "KV", "hd", "chunk"), LA_SHAPE,
                LINEAR_PATH, serves[LINEAR_PATH]["linear_served_check"]))
            entry["flops_of_kernel_form"] = linear_attention_tile_ops(
                *LA_SHAPE)
            entry["bound_note"] = (
                "bound_ms at the fp32 FFMA peak (67 TFLOP/s): the kernel's "
                "contract is fp32 arithmetic; operations of the recurrent "
                "form, as linear_attention_work counts them; "
                "flops_of_kernel_form counts the kernel's 64-row tiles")
        elif name == "dequant_gemm":
            entry.update(numbers(dg_t))
            entry["event_ms"] = dg_t[0][1]
            entry["launches_by_route"] = by_route(name, GEMM_ROUTE)
            entry["served_shapes"] = gemm_rows
            entry["dense_matmul_ms"] = entry.pop("dense_bf16_matmul_ms")
            entry["shape"] = dict(zip(("M", "K", "N"), DG_TIME_SHAPE),
                                  bits=4, group=32, dtype="bfloat16")
            entry["library"] = "dequantize + torch.matmul"
            entry["launches_per_prefill_call"] = {
                a: r["launches"]["dequant_gemm"] / r["prefill_calls"]
                for a, r in records.items()}
            entry["served_check"] = {a: r["gemm_served_check"]
                                     for a, r in records.items()}
            entry["kernel_checks"] = sm.dg_check
        elif name == "cache_row_update":
            entry.update(numbers(timings[name]))
            entry["shape"] = dict(zip(("B", "S", "KV", "hd"), (
                N_SLOTS, MAX_LEN[llava.name], llava.n_kv_heads, llava.hd)),
                layers_rotated=llava.n_layers, dtype="bfloat16")
            entry["library"] = "cache[b, index] = row (index_put_)"
            entry["bound_note"] = (
                "bytes: the rows read and written once and the index read, "
                "under a nanosecond at 3.35 TB/s; launch latency is the "
                "whole cost (launch-latency territory)")
            entry["launches_per_decode_step"] = {
                a: r["launches"]["cache_row_update"] / r["decode_steps"]
                for a, r in records.items()
                if r["launches"].get("cache_row_update")}
            entry["served_check"] = serves[COMPOSED_PATH][
                "row_update_served_check"]
            entry["kernel_checks"] = sm.cu_check
        else:
            entry.update(numbers(timings[llava.name][name]))
            entry["bc"] = TIME_BC
            if name in ("fused_qkv", "fused_mlp"):
                entry["launches_by_route"] = by_route(name, {0: MLP_ROUTE})
                check = ("qkv" if name == "fused_qkv" else "mlp") + \
                    "_served_check"
                entry["served_check"] = {a: r[check]
                                         for a, r in records.items()
                                         if check in r}
            if name == "fused_mlp":
                entry["decode_step_device_ms"] = {
                    a: serves[a]["decode_step_breakdown"]["device_ms"]
                    for a in (llava.name, FP32_PATH, qwen.name)}
            entry["shape_of"] = llava.name
            entry["at_" + qwen.name] = numbers(timings[qwen.name][name])
            entry["fp32_at_" + llava.name] = numbers(
                timings[FP32_PATH][name], FP32_FLOPS_PER_S)
            if name != "kv_row_scatter":
                entry["fp32_checks"] = {
                    a: c["worst_err_over_max"].get(name)
                    for a, c in sm.fp32_check.items() if "bc" in c}
        kernels.append(entry)
    print(smi.stdout.strip())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   - the packed-weight GEMM's expert axis (the MoE's gecd,edf->gecf and
     gecf,efd->gecd, one launch over every expert, counted under
     ``dequant_gemm/experts``) against dequantize + einsum: DeepSeek-
     MoE-16B's shapes (64 experts, 4 groups of capacity 30, 2048 <->
     1408) and DBRX's (16 experts, 2 x 80 rows, 6144 <-> 10752) on the
     ``wgmma`` route within 5e-3, an F of 96 on the ``tile`` route, and
     DeepSeek's in fp32 on ``tf32x3`` within 1e-5 and against float64 no
     worse than 2x the plain version;
3. serve LLaVA-OneVision-0.5B at full width through ``ServingEngine``:
   random weights from ``init_params`` (seed 0) on the card, packed by
   ``quantize_tree(nanomind-serve)``; four requests (full-resolution and
   thumbnail images, one shared payload, 16-token text, 16 new tokens),
   every one staged before the engine's first step (``stage_all``), so
   all four are admitted together: fails unless it decoded at the one
   cohort bucket ``[N_SLOTS]``; chunked prefill attention, decode
   through the fused kernels;
4. serve Qwen2-VL-7B the same way with ``attn_q_chunk=0``: prefill
   through the flash kernel in every layer, M-RoPE decode through the
   fused kernels; four requests (a 1024-token image, a repeat of its
   bytes, a 256-token image, a 4 x 256 request);
   every decode step of every serve replays the CUDA graph the engine
   captured for its cohort bucket: one capture a bucket the serve
   decoded at, one replay a decode step (``cohort_graph`` on the serve
   line); one captured cohort state runs again through the eager
   ``ops.cohort_step`` the graph captured, whose logits and pool must
   equal the replay's bit for bit, and which carries the held checks
   below (a replay runs no Python); the decode step is timed as a replay
   and eagerly, in turns (``decode_step_breakdown``: wall, device and
   busy share, tokens/s, the row update's and KV scatter's time inside
   the step);
   for each served path the launch counts are reset just before and
   read just after the run, and read around every decode step, replays
   included (every
   bf16 GEMM and flash launch must take the warp-specialised wgmma
   kernel, every fp32 one the split-TF32 GEMM and flash kernels (the
   GEMM's fp32 calls each also against a float64 evaluation, no worse than
   2x the plain fp32 route over the call), every fused-MLP launch and every fused-QKV device kernel the
   split-K GEMV, one a QKV call: the counts per route show it); every
   fused-QKV and fused-MLP call of that eager step is held
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
   KV-row scatter; every row-update call of the eager step held bit for
   bit against the plain version on its own inputs; the served step's
   logits
   against the fused step's and the plain step's on the same state
   (teacher-forced) within 5e-2, its pool equal to the plain step's;
   3b. serve LLaVA-OneVision-0.5B in fp32 with ``attn_q_chunk=0`` and the
   engine's default ``use_fused``: prefill through the fp32 flash kernel
   in every layer (each call held against the plain version within
   1e-4, kernel and plain each also against a float64 evaluation),
   decode through the fp32 fused kernels; the largest prefill
   group rerun through the plain versions (dense attention, dequantize +
   einsum) and a captured cohort state through ``ref_cohort_step`` give
   logits within 5e-2; that prefill call broken down by kernel (as the
   fp32 linear-attention serve's below);
   3c. serve phase 3's requests again through disaggregated fleets
   (``serving.disagg.serve_disagg_inproc``): a prefill engine and a decode
   engine on the one card with phase 3's weights and settings, the decode
   fleet on a thread, each request handed over as a frame of the port's
   wire (its written KV blocks and its slab); every request's hand-off
   clocked (export to the host, encode, send, decode, import to the
   card); every imported block bit for bit the sender's export, every
   token phase 3's, the prefill fleet's launches the packed-weight GEMM
   alone and the decode fleet's the fused kernels and KV scatter alone
   (inside replays of its captured graphs), the paged wire bytes under
   whole lanes; then ``python -m repro_torch.launch.serve_disagg --full
   --transport pipe`` with six requests (its decode fleet a subprocess
   that admits into a pool its graphs captured) must exit 0 with its OK
   line and print its ``[schedule_split @ pipe]`` pricing line;
   3d. placement and the On-Demand Cascade on phase 3's weights: the
   scheduler's placement on ``edge_accelerators()`` from the packed
   tree's brick bytes at the first request's 745 tokens, both objectives,
   printed with its joules and hours on a 2000 mAh pack (modeled, the
   reference's edge profiles); the request (right-padded to its 1024
   bucket) through the resident all-card plan, the placed plan (the NPU
   bricks through the host backend on the CPU, the embeds across one
   CPU -> card edge into a TABM ring on the card) and ``CascadeRunner``
   on the card (each brick's params pinned host-side, loaded, executed,
   released), a warm-up and five clocked runs each: the placed plan's
   and the cascade's logits within 5e-2 of the largest against the
   resident plan's, 168 ``dequant_gemm/wgmma`` launches a run and no
   other, the cascade's card allocation after each release back to its
   value before that brick's load plus at most the brick's output and
   1 MB, the cascade's card peak under the resident plan's, each trace
   event's ms and bytes (counted and allocated); then phase 3's four
   requests through ``ServingEngine(placement=, accels=)`` at 4 new
   tokens, every one finished and its first-step logits within 5e-2 of
   the largest against phase 3's;
   3e. the measured-energy loop.  On phase 3's engine after its serve:
   the card's energy counter read through NVML by ``ctypes`` (the handle
   picked by the device's UUID, never by index), its update step polled
   for ~1 s, then three windows of at least 50 updates each: idle
   (sleeps), decode (replays of the bucket-4 cohort graph on a copy of
   phase 3's timed state) and prefill (repeats of phase 3's largest
   prefill call), printed as joules per token gross and net of the idle
   watts with the card's name and power limit (where the counter answers
   NOT_SUPPORTED, ``nvmlDeviceGetPowerUsage`` integrated at 50 Hz, said
   on the line); phase 3's measured ledger and calibration table beside
   each brick's CUDA-event time over the same calls, and the placement
   the table gives beside the modeled one.  After 3d: phase 3's requests
   through an engine with phase 3d's placement and a table holding the
   decode window's joules (its KV energy pressure equal to the table's
   J/token over the modeled decoder step's, every admission round's
   budgets equal to ``kv_block_budgets`` recomputed, the thumbnail class
   keeping its share of the pool, the requests admitted and held under a
   40-step cap, its launches those of the fused kernels and the GEMM);
   ``repro_torch.launch.serve --calibration`` twice (the second run loads
   the first's table, whose decoder count grows by the second run's
   samples); ``repro_torch.launch.fleet_sim --smoke`` and ``--profile
   ledger`` on a ledger of the windows (the H100's J/token as survival on
   a 2000 mAh pack); then phase 3's requests under ``nanomind-sparse``
   (half of every decoder row pruned on the card before q4) with phase
   3's gates, every pruned row at least half zeros, and the card's prune
   of a ``wq`` leaf bit-equal to the CPU's.  Phase 3c also prints the
   split repriced from the wire's measured bandwidth, from the in-process
   fleets' stats and from the pipe launcher's line;
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
   magnitude, padded rows exactly zero, and in fp32 each output row
   against a float64 evaluation no worse than 2x the plain version's
   (``F64_RATIO``); then every kernel call of the serve on its own inputs,
   with the same gates.  The engine is held
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
   and at LLaVA's five shapes in fp32 (the split-TF32 route, beside
   dequantize + fp32 ``matmul``, with that route's own bound), the
   expert axis at DeepSeek-MoE-16B's up and down (64 experts x 120 rows)
   and DBRX's up (16 x 160) beside dequantize + a batched ``matmul``,
   the flash
   and GEMM times both from the profiler and from CUDA events around the
   loop, the cache-row-update
   kernel at the composed step's shape (a layer of a cohort-4 gathered
   context, beside ``index_put_``),
   the SSD kernel at its check shape in bf16 and fp32, with the device
   ms of its four phases (no single PyTorch call computes SSD), the
   linear-attention kernel at its check shape in bf16 and fp32 with the
   device ms of its three device kernels (nor that);
   beside the bound the card's published rates set (3.35 TB/s, 989
   TFLOP/s bf16, 67 TFLOP/s fp32 for the SSD's and the linear
   attention's fp32 arithmetic, whose operations ``ssd_work`` and
   ``linear_attention_work`` count; beside it the SSD's bf16 route's
   own count, ``ssd_mma_bound``), the fused-decode kernels' effective
   GB/s;
8. serve DeepSeek-MoE-16B at full width and depth (28 layers, 64 routed
   experts top-6 and two shared, ``attn_q_chunk=0``): ``init_params``
   seed 0 with ``nanomind-serve`` packing each stacked expert leaf as it
   is made (weights and the init's peak memory printed),
   ``ServingEngine(n_slots=4, block_size=64)``, ``max_len`` 2048, text
   prompts of 1024, 1000, 300 and 100 tokens, 16 new tokens each,
   greedy; prefill masks the right pads out of the routing, decode runs
   the composed step (the fused one refuses MoE) with the cohort's
   sentinel rows masked, one CUDA graph a bucket.  Every packed GEMM
   call of the serve (experts included) and every flash call is held
   against its plain version on its own inputs as it is made; the
   launch counts show every bf16 GEMM on ``wgmma`` and three
   ``dequant_gemm/experts`` a layer; one captured cohort state again
   through the eager step, bit-equal to the replay, with every row
   update and the KV scatter held bit for bit.  The engine against the
   port's own model, every comparison within 5e-2 of the largest logit
   (the flipped and dropped (token, choice) pairs of every call
   printed): the 1024- and 100-token requests' prefill logits against
   ``lm_prefill`` on the unpadded prompt (``valid_len``), which must
   route alike, and their first two decode steps against
   ``lm_decode_step`` made to take the experts the engine's step took;
   the 1000- and 300-token prompts padded to their bucket and the one
   above, which must route alike; the largest prefill group through the
   plain versions, made to take the kernel run's experts, row by row.
   Decode
   tokens/s, prefill ms, the busy share and the step's breakdown.  Then
   stablelm-12b (``attn_q_chunk=0``: flash at hd 160), nemotron-4-15b
   (ungated squared ReLU), deepseek-67b and dbrx-132b (16 experts top-4)
   at full width and 2 layers, a 512- and a 300-token request and 4 new
   tokens each, every kernel call held as above (the fused QKV and MLP
   of the dense configs' captured step too).  The MoE steps' decode goes
   through the routed experts' GEMV (``fused_mlp/experts``, held against
   ``ref_fused_mlp_experts`` in the eager step); DeepSeek's, DBRX's and
   (phase 9) Jamba's replayed step print beside their device ms with
   the GEMV as first written (``DECODE_MS_BEFORE``);
9. serve Jamba-1.5-Large at full width and one group of 8 sublayers
   (attention at position 4, Mamba-2 elsewhere, 16 experts top-2 on odd
   positions, ``attn_q_chunk=0``), packed as made, with phase 8's
   requests, checks and breakdowns; every SSD call of the serve is held
   too, and the packed GEMM's plain version dequantizes an expert leaf
   one expert at a time.  A bf16 GEMM call one rounding step from its
   plain version at the largest magnitude, beyond the 5e-3 gate, is
   held against a float64 evaluation instead (no worse than 2x the
   plain version): cuBLAS splits K = 24576 at 128 rows and sums in
   another order than the kernel (``scripts/long_k_gemm_plain.py``);
10. run seamless-m4t-large-v2, the encoder-decoder, at full width and
   depth (24 encoder and 24 decoder layers, ``attn_q_chunk=0``),
   ``init_params`` seed 0 packed as made under ``nanomind-serve``,
   through ``launch.steps.build_prefill_step`` / ``build_serve_step``
   at ``max_len`` 64: (a) 2 rows of 1024 stub audio frames and (b) 1
   row of 8192 frames (the config's ``enc_seq_len``), each with a
   16-token target prefix and 16 new greedy tokens.  Every packed GEMM
   (the encoder's and the cross K/V projections at B x T rows, the
   decoder's at B x 16), flash (non-causal encoder, causal target,
   cross at 16 queries), fused QKV / ungated-GELU MLP GEMV and
   cache-row-update call is held against its plain version as it is
   made; the launches counted around each input's run; the prefill's
   and every decode step's logits against the plain route (every
   kernel swapped for its plain version, teacher-forced on the served
   tokens) within 5e-2 of the largest; the encoder, the prefill and
   the eager decode step broken down by kernel; then input (a)'s first
   row through the resident plan of ``decompose(cfg)`` and through
   ``CascadeRunner`` on the card (logits against the prefill step's
   and each other's, the cascade's card peak under the resident
   plan's, each brick's load / execute / release ms), and the kernels
   at the phase's new shapes beside their plain versions and library
   calls;
11. train LLaVA-OneVision-0.5B at full width and depth on the card
   (``attn_q_chunk=0``, remat, bf16): ``init_params`` seed 0, the port's
   ``multimodal_batch_iter`` (seed 0, 4 x 2048 tokens, 729 of them
   vision), ``OptConfig(lr=3e-4, warmup_steps=2, total_steps=8)`` with
   fp32 moments, ``fit`` for 8 steps.  Step 1's gradient of every leaf
   against the same step through ``attn_q_chunk=512`` (the chunked
   plain attention) within 5e-2 of the leaf's largest magnitude; the
   loss falls; each step launches 48 flash forwards (24, and 24 again
   under remat) and 24 backwards; every backward call of step 1 and one
   of each later step held against the plain backward on its own
   inputs (rows within 2e-2; the first call also against float64); one
   more step under the profiler (device ms, busy share, the flash
   kernels' ms a call and share); tokens/s and FLOP/s against 989
   TFLOP/s; peak GB.  Then a 2-layer fp32 step at full width (the
   tf32x3 forward, the fp32 backward) held the same way (gradients
   within 2e-5, backward rows within 1e-4), and the backward kernel at
   the training shape beside its plain version and SDPA's backward.

Phase 2 also holds the flash backward kernel (``flash_attention/bwd``,
routes ``bwd_bf16`` / ``bwd_f32``) against ``ref_attention_backward``
at the training shape (B 4, S 2048, H 14, KV 2, hd 64), Qwen2-VL's head
counts (hd 128), a ragged S = 777, non-causal with Sq != Sk and the
reference grid, in bf16 and fp32: every dq / dk / dv row within 2e-2
(bf16) or 1e-4 (fp32) of that row's largest plain magnitude (a causal
dq's row 0, exactly 0, against the gradient's largest), against
float64 no worse than 2x the plain version, two launches bit-equal, and
the forward bit-equal with and without its lse; then it prints the
dK/dV and dQ grids' geometry at the training shape in both dtypes
(``flash_backward_geometry`` line: blocks, resident blocks an SM from
the occupancy API, registers, the longest block's tile pairs and the
mean, and whether the longest walks at most half a resident slot's
average).  Phase 11 prints the backward's times there
(``flash_backward_times``: ms a call and per device kernel beside the
function's bound, the route's own (bf16 wgmma at 989 TFLOP/s, fp32 at
mma.sync's sustained TF32 rate), the plain version and SDPA's
backward).  It also holds the
routed experts' GEMV at DeepSeek-MoE-16B's, DBRX's and Jamba's widths (cohorts 1-8, a row choosing one expert twice,
a sentinel row; bf16 within 2e-2 a row, fp32 within 1e-5 of the largest)
and the SSD kernel at P 128; phase 7 times the GEMV beside the routed
experts gathered, dequantized and run through batched ``bmm``, and SSD
at P 128 and flash at 64/8 heads.

Output: build, check and serve lines, the ``nvidia-smi`` name/power-limit
line, one JSON line ``{"kernels": [...]}``, and as the last line
``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16, published
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 (SIMT FFMA), published
TF32_FLOPS_PER_S = 495e12        # H100 SXM dense TF32, published
# what mma.sync m16n8k8 TF32 sustains on an H100 (scripts/mma_sync_rate.py,
# PERF.md §6): the fp32 flash backward's own route bound
MMA_SYNC_TF32_FLOPS_PER_S = 320.4e12
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
# seconds a serve waits for its requests' staging before its first step
# (stage_all: phase 3 admits its requests together)
STAGE_TIMEOUT_S = 120.0
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
# the flash backward held against its plain version (phase 2): the
# training shape (LLaVA, B 4, S 2048), Qwen2-VL's head counts (hd 128), a
# ragged S = 777, non-causal with Sq != Sk, then FLASH_REF_GRID causal and
# not; bf16 and fp32.  (B, Sq, Sk, H, KV, hd, causal)
FLASH_BWD_SHAPES = ((4, 2048, 2048, 14, 2, 64, True),
                    (1, 2048, 2048, 28, 4, 128, True),
                    (1, 777, 777, 14, 2, 64, True),
                    (1, 300, 1000, 28, 4, 128, False))
# of each row's max.  A causal dq's row 0 is 0 in exact arithmetic (its
# one key's dS = P (dP - D) with dP = D): it is held against the
# gradient's largest magnitude
FLASH_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# phase 11: train LLaVA-OneVision-0.5B at full width and depth,
# attn_q_chunk=0, remat, bf16: the data pipeline's batches of 4 x 2048
# tokens (729 of them vision), OptConfig(lr=3e-4, warmup 2, total 8) with
# fp32 moments, fit for TRAIN_STEPS steps
TRAIN_PATH = "llava-onevision-0.5b/train"
TRAIN_FP32_PATH = "llava-onevision-0.5b/train-fp32-2-layer"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
TRAIN_FP32_LAYERS = 2
# step 1's gradients, each leaf against the same step through
# attn_q_chunk=512 (the chunked plain attention), max |err| over the
# leaf's largest magnitude: bf16 through 24 layers rounds both paths'
# activations and cotangents at different points (worst leaf 0.0149 on
# an H100); fp32 differs by the summation order and the tf32x3 forward's
# split products (worst leaf 2.7e-6 over 2 layers)
TRAIN_GRAD_TOL = {"bfloat16": 5e-2, "float32": 2e-5}
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
# the disaggregated LLaVA serve: prefill fleet -> wire -> decode fleet
DISAGG_PATH = "llava-onevision-0.5b/disagg"
# phase 3d: phase 3's first request through a placed plan (schedule on
# edge_accelerators(): the vision side on the emulated NPU, the CPU), the
# On-Demand Cascade on the card, and phase 3's requests through an engine
# with that placement
PLACED_PATH = "llava-onevision-0.5b/placed"
CASCADE_PATH = "llava-onevision-0.5b/cascade"
PLACED_ENGINE_PATH = "llava-onevision-0.5b/placed-engine"
PLACED_ENGINE_NEW = 4
BATTERY_MAH = 2000.0             # the paper's Fig. 8 pack, modeled hours
# the plan runs the request right-padded to the engine's prefill bucket:
# the attention chunks (512, 1024) must divide a forward's length, as in
# the reference's model; causal, the pads reach none of the prompt's rows
PLACED_WIDTH = 1024
PLACED_RUNS = 5                  # clocked runs of each plan after a warm-up
RELEASE_SLACK = 1 << 20          # bytes a release may leave besides output
# the launcher's run over a pipe: more requests than the decode fleet's
# N_SLOTS slots, so it admits into a pool its cohort graph has captured
DISAGG_PIPE_REQUESTS = 6
# phase 3e, the measured-energy loop: NVML energy windows (each at least
# ENERGY_MIN_STEPS updates of the counter long), an engine under the
# decode window's energy pressure (a step cap: the hi-res class may
# never be admitted), the launcher's --calibration loop, the fleet
# simulator, and phase 3's requests under nanomind-sparse
ENERGY_PATH = "llava-onevision-0.5b/energy-pressure"
SPARSE_PATH = "llava-onevision-0.5b/sparse"
ENERGY_MIN_STEPS = 50
ENERGY_WINDOW_S = {"idle": 2.0, "decode": 5.0, "prefill": 3.0}
POWER_SAMPLE_S = 0.02            # 50 Hz, where the energy counter is absent
PRESSURE_STEPS = 40
CALIBRATION_SERVE_ARGS = ("--full", "--quantize", "nanomind-serve",
                          "--requests", "2", "--max-new", "4",
                          "--max-len", "2048")
ENERGY_DIR = os.path.join(ROOT, "build", "energy_loop")
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
# the kernel (launch-count route) every served call of a dtype must take:
# bf16 the warp-specialised wgmma kernels, fp32 the split-TF32 GEMM and
# flash kernels on the tensor cores
GEMM_ROUTE = {"bfloat16": "wgmma", "float32": "tf32x3"}
# fp32 kernels against a float64 evaluation: no worse than this many times
# the plain fp32 version's error on the same inputs (worst over a serve's
# calls; both sit near fp32's rounding level)
F64_RATIO = 2.0
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
                  "mamba2-1.3b": 2048, "seamless-m4t-large-v2": 2048}
# the bf16 flash timings beside SDPA, (B, Sq, Sk, H, KV, hd, causal) at
# Qwen2-VL's head counts: hd 64 and 128 at its 2 x 2048 prefill, hd 160 at
# 2 x 1024 (FLASH_HD160's first shape)
FLASH_HD_TIMES = ((2, 2048, 2048, 28, 4, 64, True),
                  (2, 2048, 2048, 28, 4, 128, True),
                  (2, 1024, 1024, 28, 4, 160, True))
# the expert contractions' checks: name -> (G groups, E experts, C
# capacity, D, F, dtype, (route of gecd,edf->gecf, of gecf,efd->gecd)).
# DeepSeek-MoE-16B at a 1 x 1024 prefill (4 groups of 256, capacity 30),
# DBRX at a 512 bucket (2 groups, capacity 80), an F off the wgmma rule's
# N % 64 (the tile kernel for up), and DeepSeek's in fp32 (tf32x3)
EXPERT_CHECKS = {
    "deepseek-moe-16b": (4, 64, 30, 2048, 1408, "bfloat16",
                         ("wgmma", "wgmma")),
    "dbrx-132b": (2, 16, 80, 6144, 10752, "bfloat16", ("wgmma", "wgmma")),
    "tile": (2, 7, 17, 256, 96, "bfloat16", ("tile", "wgmma")),
    "deepseek-moe-16b/fp32": (4, 64, 30, 2048, 1408, "float32",
                              ("tf32x3", "tf32x3"))}
# the expert contractions' timings (G, E, C, K, N): DeepSeek-MoE-16B's up
# and down at a 1 x 1024 prefill, DBRX's up at a 512 bucket
EXPERT_TIMES = {"deepseek-moe-16b up": (4, 64, 30, 2048, 1408),
                "deepseek-moe-16b down": (4, 64, 30, 1408, 2048),
                "dbrx-132b up": (2, 16, 80, 6144, 10752)}
# phase 8: DeepSeek-MoE-16B at full width and depth (attn_q_chunk=0),
# text prompts of these lengths, 16 new tokens, greedy; the first two
# decode steps of the 1024- and 100-token requests against the unpadded
# model, the 1000- and 300-token prompts padded to two widths
MOE_PATH = "deepseek-moe-16b"
MOE_PROMPTS = (1024, 1000, 300, 100)
MOE_NEW = 16
MOE_MAX_LEN = 2048
MOE_UNPADDED = (1024, 100)
MOE_PADDED = ((1000, (1024, 2048)), (300, (512, 1024)))
# then the dense configs and DBRX at full width and DENSE_LAYERS layers
# (DBRX's 40 layers of experts alone would take ~79 GB packed): a 512-
# and a 300-token request, 4 new tokens, max_len 1024 (buckets to 512)
DENSE_SERVES = (("stablelm-12b", {"attn_q_chunk": 0}),
                ("nemotron-4-15b", {}), ("deepseek-67b", {}),
                ("dbrx-132b", {}))
DENSE_LAYERS = 2
DENSE_PROMPTS = (512, 300)
DENSE_NEW = 4
DENSE_MAX_LEN = 1024
# the replayed decode step's device ms with the routed experts' GEMV as
# first written (four device kernels a call, a grid over all E experts;
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 5), printed beside
# this run's
DECODE_MS_BEFORE = {MOE_PATH: 51.77, "dbrx-132b/2-layer": 23.53,
                    "jamba-1.5-large-398b/1-group": 154.23}
DECODE_MS_BEFORE_SOURCE = ("NVIDIA H100 80GB HBM3, 700.00 W, the routed "
                           "experts' GEMV of four device kernels a call")
# the routed experts' GEMV of a decode step (fused_mlp/experts) at each
# MoE config's widths, (E, top_k, D, F); checked at every cohort of
# EXPERT_GEMV_BCS, timed at TIME_BC; each row within EXPERT_GEMV_TOL of
# its largest plain value (bf16) or of the largest plain value (fp32)
EXPERT_GEMV = {"deepseek-moe-16b": (64, 6, 2048, 1408),
               "dbrx-132b": (16, 4, 6144, 10752),
               "jamba-1.5-large-398b": (16, 2, 8192, 24576)}
EXPERT_GEMV_BCS = (1, 2, 4, 8)
EXPERT_GEMV_TOL = {"bfloat16": KERNEL_TOL, "float32": 1e-5}
# the cohorts it is timed at, each over this many routings taken in turn
EXPERT_TIME_BCS = (1, 4, 8)
EXPERT_ROTATIONS = 8
EXPERT_MS_SOURCE = ("a CUDA graph of the rotation's calls replayed, CUDA "
                    "events (as a decode step's graph runs them)")
# the SSD kernel at Jamba's Mamba-2 widths: 128 heads of P 128, one B/C
# group, state 128, chunk 256, at a 2 x 1024 prefill
SSD_P128_SHAPE = (2, 1024, 128, 128, 1, 128, 256)
# the flash kernel at Jamba's attention sublayer: GQA 64 / 8, hd 128, at a
# 2 x 1024 prefill, no RoPE
FLASH_JAMBA_SHAPE = (2, 1024, 1024, 64, 8, 128, True)
# phase 9: Jamba-1.5-Large at full width and one group of 8 sublayers
# (attn_q_chunk=0), packed as made; Mamba-2-1.3B's requests
HYBRID_PATH = "jamba-1.5-large-398b/1-group"
HYBRID_GROUPS = 1
HYBRID_PROMPTS = (1024, 1000, 300, 100)
HYBRID_NEW = 16
HYBRID_MAX_LEN = 2048
# phase 10: seamless-m4t-large-v2, the encoder-decoder, at full width and
# depth; inputs (name, rows, audio frames), each with a 16-token target
# prefix and 16 new greedy tokens
ENCDEC_PATH = "seamless-m4t-large-v2"
ENCDEC_INPUTS = (("a", 2, 1024), ("b", 1, 8192))
ENCDEC_PREFIX = 16
ENCDEC_NEW = 16
ENCDEC_MAX_LEN = 64
ENCDEC_RUNS = 3                  # clocked runs of each plan after a warm-up
# the flash kernel at the encoder's length and the cross-attention shapes
FLASH_ENCDEC_TIMES = ((1, 8192, 8192, 16, 16, 64, False),
                      (2, 16, 1024, 16, 16, 64, False),
                      (1, 16, 8192, 16, 16, 64, False))


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


def event_ms(fn, n_rot, iters):
    """Wall ms a call of ``fn(i)``, i rotating over ``n_rot`` inputs,
    between CUDA events around ``iters`` calls launched from Python (host
    overhead included, which dominates calls of a few microseconds),
    after one warm call of each input."""
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
    return start.elapsed_time(stop) / iters


def timed(fn, n_rot, iters=96):
    """(device ms, call ms, device kernels) per call of ``fn(i)``, i
    rotating over ``n_rot`` weight sets: the card's kernel time summed
    from the profiler's CUDA events (None if it recorded none), the wall
    time per call (``event_ms``) and the kernels one call runs on the
    card."""
    import torch
    call_ms = event_ms(fn, n_rot, iters)

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
                     "fused_mlp/experts": 0.0,
                     "kv_row_scatter": 0.0, "flash_attention": 0.0,
                     "flash_attention/bwd": 0.0,
                     "ssd": 0.0, "linear_attention": 0.0,
                     "dequant_gemm": 0.0, "cache_row_update": 0.0}
        self.eg_check = []               # the routed experts' GEMV
        self.worst_row_ratio = 0.0       # flash: max over rows err/max
        self.fp32_check = {}             # fp32 instances: worst err/max
        self.cu_check = {}
        self.ssd_check = {}
        self.la_check = []
        self.dg_check = {}
        self.bwd_check = {}

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

    def flash_held(self, q, k, v, causal, what, f64=None, got=None):
        """The flash kernel against its plain version on q, k, v: bf16
        every output row within KERNEL_TOL of that row's largest plain
        magnitude, fp32 within FLASH_FP32_TOL of the largest (the
        reference's measure); fp32 kernel and plain each also against a
        float64 evaluation in that measure, the worst of each kept in
        ``f64`` where given.  ``got``: the kernel's output of a call made
        already (a served one), else the kernel runs here.  Returns
        (err/max measure, max abs err)."""
        from repro_torch.kernels.flash_attention import (flash_attention,
                                                         ref_attention)
        if got is None:
            got = flash_attention(q, k, v, causal=causal)
        got = got.float()
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

    def flash_bwd_held(self, q, k, v, o, lse, do, causal, what, got=None,
                       f64=None):
        """The backward kernel's (dq, dk, dv) against the plain backward
        on the same q, k, v, o, lse, do: every row of each (b, position,
        head) within FLASH_BWD_TOL of that row's largest plain magnitude
        (a causal dq's row 0, exactly 0, of the gradient's largest);
        with ``f64`` (a dict), kernel and plain each against the float64
        backward (max |err| over the largest |exact|), the kernel no worse
        than F64_RATIO x the plain version, the worst kept.  ``got``: the
        kernel's gradients of a call made already (a trained step's),
        else the kernel runs here.  Returns (worst row ratio, max abs
        err)."""
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.flash_attention.ref import \
            ref_attention_backward
        torch = self.torch
        name = str(q.dtype).replace("torch.", "")
        if got is None:
            got = FK.launch_flash_attention_backward(q, k, v, o, lse, do,
                                                     causal=causal)
        with plain_sums():
            want = ref_attention_backward(q, k, v, o, lse, do, causal=causal)
        worst, err_max = 0.0, 0.0
        for part, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype \
                    or not g.isfinite().all():
                fail(f"flash_attention/bwd {what}: {part} shape, dtype or "
                     f"non-finite values")
            err = (g.float() - w.float()).abs().amax(-1)
            row = w.float().abs().amax(-1)
            den = row.clone()
            if part == "dq" and causal:
                den[:, 0] = row.max()
            ratio = err / den
            ratio = ratio.nan_to_num(nan=0.0, posinf=1e9)
            r = ratio.max().item()
            if not r <= FLASH_BWD_TOL[name]:
                at = divmod(int(ratio.argmax()), ratio.shape[-1])
                b, i = divmod(at[0], ratio.shape[1])
                fail(f"flash_attention/bwd {what}: {part} row (b {b}, "
                     f"position {i}, head {at[1]}) err/max {r}, the row's "
                     f"largest {row[b, i, at[1]].item()} of the "
                     f"gradient's {row.max().item()}")
            worst, err_max = max(worst, r), max(err_max, err.max().item())
        if f64 is not None:
            exact = ref_attention_backward(*(t.double() for t in (
                q, k, v, o, lse, do)), causal=causal)
            for part, g, w, x in zip(("dq", "dk", "dv"), got, want, exact):
                den = x.abs().max()
                k_err = ((g.double() - x).abs().max() / den).item()
                p_err = ((w.double() - x).abs().max() / den).item()
                if k_err > F64_RATIO * p_err:
                    fail(f"flash_attention/bwd {what}: {part} vs float64 "
                         f"{k_err}, plain {p_err}")
                rec = f64.setdefault(name, {"kernel": 0.0, "plain": 0.0,
                                            "worst_ratio": 0.0})
                rec["kernel"] = max(rec["kernel"], k_err)
                rec["plain"] = max(rec["plain"], p_err)
                rec["worst_ratio"] = max(rec["worst_ratio"], k_err / p_err)
            del exact
        del want
        self.errs["flash_attention/bwd"] = max(
            self.errs["flash_attention/bwd"], err_max)
        return worst, err_max

    def check_flash_backward(self):
        """The backward kernel at FLASH_BWD_SHAPES and the reference
        grid, causal and not, in bf16 and fp32: the forward with its lse
        bit-equal to the forward without; the gradients held by
        ``flash_bwd_held`` (rows, and against float64); two launches bit-
        equal.  Kept in ``bwd_check``."""
        from repro_torch.kernels.flash_attention import kernel as FK
        torch = self.torch
        cases = list(FLASH_BWD_SHAPES) + [
            (B, S, S, H, KV, hd, c) for B, S, H, KV, hd in FLASH_REF_GRID
            for c in (True, False)]
        worst, f64, rows = {}, {}, []
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            for B, Sq, Sk, H, KV, hd, causal in cases:
                what = (f"{name} B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} "
                        f"hd={hd} causal={causal}")
                q = self.randn(B, Sq, H, hd, dtype=dtype)
                k = self.randn(B, Sk, KV, hd, dtype=dtype)
                v = self.randn(B, Sk, KV, hd, dtype=dtype)
                do = self.randn(B, Sq, H, hd, dtype=dtype)
                o, lse = FK.launch_flash_attention(q, k, v, causal=causal,
                                                   want_lse=True)
                if not torch.equal(o, FK.launch_flash_attention(
                        q, k, v, causal=causal)):
                    fail(f"flash_attention {what}: the output differs when "
                         f"the lse is written")
                got = FK.launch_flash_attention_backward(q, k, v, o, lse, do,
                                                         causal=causal)
                again = FK.launch_flash_attention_backward(
                    q, k, v, o, lse, do, causal=causal)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"flash_attention/bwd {what}: two launches differ")
                w, err = self.flash_bwd_held(q, k, v, o, lse, do, causal,
                                             what, got=got, f64=f64)
                worst[name] = max(worst.get(name, 0.0), w)
                rows.append({"case": [B, Sq, Sk, H, KV, hd, causal],
                             "dtype": name, "row_err_over_row_max": w,
                             "max_abs_err": err})
                del q, k, v, do, o, lse, got, again
        torch.cuda.synchronize()
        self.bwd_check = {"cases": rows, "worst_row_err_over_row_max": worst,
                          "vs_float64_err_over_max": f64,
                          "tol": {"row": FLASH_BWD_TOL,
                                  "float64_ratio": F64_RATIO},
                          "forward_bit_equal_with_lse": True,
                          "two_launches_bit_equal": True}

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
        del args, x, dt, A, Bm, Cm
        # Jamba's widths: P 128 (two 64-wide P tiles a head)
        B, S, H, P, G, N, chunk = SSD_P128_SHAPE
        args = self.ssd_inputs(B, S, H, P, G, N)
        h_rel, head, y_abs, h_abs, _ = ssd_errors(
            args, ssd(*args, chunk=chunk), chunk, "ssd at P 128")
        self.errs["ssd"] = max(self.errs["ssd"], y_abs)
        self.ssd_check["p128"] = {
            "shape": list(SSD_P128_SHAPE), "h_rel_err": h_rel,
            "worst_head_y_err_over_max": head, "y_max_abs_err": y_abs,
            "h_max_abs_err": h_abs}
        del args
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
                if dtype == torch.float32:
                    f64_ratio_check(rec, f"linear_attention B={B} S={S} "
                                    f"valid_len={vl} fp32")
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

    def check_expert_gemm(self):
        """The MoE's expert contractions (``quant_einsum`` gecd,edf->gecf
        and gecf,efd->gecd, one launch over every expert) against their
        plain version (``dequantize`` + einsum) at EXPERT_CHECKS, q4 g32:
        each call one launch on its expected route and one under
        ``dequant_gemm/experts``; bf16 within DG_TOL, fp32 (tf32x3) within
        DG_TOL and against float64 no worse than F64_RATIO x the plain
        version.  Kept in ``dg_check["experts"]``."""
        from repro_torch.core.quantize import QuantSpec, dequantize, quantize
        from repro_torch.kernels import launch_counts, reset_launch_counts
        from repro_torch.kernels.dequant_gemm import (quant_einsum,
                                                      ref_quant_einsum)
        torch = self.torch
        spec32 = QuantSpec(4, group_size=32)
        rows = []
        for name, (G, E, C, D, F, dt, routes) in EXPERT_CHECKS.items():
            dtype = getattr(torch, dt)
            for spec, K, N, route in (("gecd,edf->gecf", D, F, routes[0]),
                                      ("gecf,efd->gecd", F, D, routes[1])):
                x = self.randn(G, E, C, K, dtype=dtype)
                w = quantize(self.randn(E, K, N, scale=K ** -0.5,
                                        dtype=dtype), spec32)
                reset_launch_counts()
                got = quant_einsum(spec, x, w)
                counts = {k: n for k, n in launch_counts().items() if n}
                want_n = {"dequant_gemm": 1, f"dequant_gemm/{route}": 1,
                          "dequant_gemm/experts": 1}
                if counts != want_n:
                    fail(f"experts {name} {spec}: launches {counts}, "
                         f"want {want_n}")
                with plain_sums():
                    want = ref_quant_einsum(spec, x, w)
                _, rel, err = gemm_error(f"experts {name} {spec}", got,
                                         want)
                self.errs["dequant_gemm"] = max(self.errs["dequant_gemm"],
                                                err)
                row = {"case": name, "spec": spec, "G": G, "E": E, "C": C,
                       "K": K, "N": N, "dtype": dt, "route": route,
                       "err_over_max": rel, "max_abs_err": err}
                if dtype == torch.float32:
                    exact = torch.einsum(spec, x.double(),
                                         dequantize(w).double())
                    m = exact.abs().max()
                    k_err, p_err = (((t.double() - exact).abs().max() / m)
                                    .item() for t in (got, want))
                    if k_err > F64_RATIO * p_err:
                        fail(f"experts {name} {spec}: fp32 vs float64 "
                             f"{k_err}, plain {p_err}")
                    row["vs_float64_err_over_max"] = {"kernel": k_err,
                                                      "plain": p_err}
                    del exact
                rows.append(row)
                del x, w, got, want
        torch.cuda.synchronize()
        self.dg_check["experts"] = rows


    def check_expert_gemv(self):
        """The routed experts' GEMV (``fused_decode.ops.fused_mlp_experts``)
        against its plain version (``ref_fused_mlp_experts``: each (row,
        choice) through its own expert's dequantized matrices) at each
        EXPERT_GEMV width, q4 g32, bf16, at every cohort of
        EXPERT_GEMV_BCS: one launch counted under ``fused_mlp/experts``,
        each valid row within EXPERT_GEMV_TOL of its largest plain value,
        sentinel rows (the cohort of 8's last) 0, a row that chooses one
        expert twice (cohort 2); then DeepSeek's widths in fp32, within
        1e-5 of the largest plain value.  Kept in ``eg_check``."""
        from repro_torch.kernels import launch_counts, reset_launch_counts
        from repro_torch.kernels.fused_decode import ops, ref
        torch = self.torch
        cases = [(arch, "bfloat16", bc) for arch in EXPERT_GEMV
                 for bc in EXPERT_GEMV_BCS]
        cases += [("deepseek-moe-16b", "float32", bc) for bc in (1, 4, 8)]
        weights = None
        for arch, dt, bc in cases:
            dtype = getattr(torch, dt)
            E, k, D, F = EXPERT_GEMV[arch]
            if weights is None or weights[0] != (arch, dt):
                weights = None
                free()
                weights = ((arch, dt), expert_weights(self, E, D, F, dtype))
            up, gate, down = weights[1]
            idx, gates, valid = expert_routes(self, bc, k, E,
                                              twice=(bc == 2),
                                              sentinel=(bc == 8))
            h = self.randn(bc, D, dtype=dtype)
            with torch.no_grad():
                reset_launch_counts()
                got = ops.fused_mlp_experts(h, up, down, gate, idx, gates,
                                            valid, act="swiglu")
                torch.cuda.synchronize()
                counts = {n: c for n, c in launch_counts().items() if c}
                if counts != {"fused_mlp/experts": 1}:
                    fail(f"fused_mlp/experts {arch} bc {bc}: launches "
                         f"{counts}")
                with plain_sums():
                    want = ref.ref_fused_mlp_experts(
                        h, up, down, gate, idx, gates, valid, act="swiglu")
            rel, err = expert_rows_error(f"fused_mlp/experts {arch} {dt} "
                                         f"bc {bc}", got, want, valid)
            self.errs["fused_mlp/experts"] = max(
                self.errs["fused_mlp/experts"], err)
            self.eg_check.append({
                "arch": arch, "dtype": dt, "bc": bc, "E": E, "top_k": k,
                "D": D, "F": F, "routed_experts": int(torch.unique(
                    idx[valid]).numel()),
                "sentinel_rows": int((~valid).sum()),
                "row_chooses_an_expert_twice": bc == 2,
                "err_over_max": rel, "max_abs_err": err,
                "tol": EXPERT_GEMV_TOL[dt]})
            del got, want, h
        del weights
        free()


def expert_weights(sm, E, D, F, dtype):
    """Stacked q4 g32 expert weights (E, D, F) x 2 (up, gate) and (E, F,
    D), drawn and packed one expert at a time
    (``core.quantize.quantize_stacked``)."""
    from repro_torch.core.quantize import QuantPolicy, quantize_stacked
    policy = QuantPolicy("q4-g32", ((".", "q4f16-g32"),))

    def draw(shape):
        for _ in range(E):
            yield sm.randn(*shape, scale=shape[0] ** -0.5, dtype=dtype)
    return [quantize_stacked("experts", (E,) + shape, dtype, draw(shape),
                             policy) for shape in ((D, F), (D, F), (F, D))]


def expert_routes(sm, bc, k, E, twice=False, sentinel=False):
    """A decode cohort's routing on the card: idx (bc, k) distinct experts
    a row (``twice``: row 0's second choice its first), renormalised
    gates (bc, k) fp32, valid (bc,) (``sentinel``: the last row not)."""
    torch = sm.torch
    idx = torch.stack([torch.randperm(E, generator=sm.gen, device=sm.dev)[:k]
                       for _ in range(bc)])
    if twice and k > 1:
        idx[0, 1] = idx[0, 0]
    g = torch.rand((bc, k), generator=sm.gen, device=sm.dev) + 0.1
    valid = torch.ones(bc, dtype=torch.bool, device=sm.dev)
    if sentinel:
        valid[-1] = False
    return idx, g / g.sum(-1, keepdim=True), valid


def expert_rows_error(what, got, want, valid):
    """The routed experts' GEMV's output against its plain version's:
    fails unless finite, of the plain shape and dtype, invalid rows 0, and
    each valid row within EXPERT_GEMV_TOL of its largest plain value
    (bf16) or of the largest plain value (fp32).  Returns (that ratio,
    max abs err)."""
    dt = str(want.dtype).replace("torch.", "")
    if not (got.shape == want.shape and got.dtype == want.dtype
            and got.isfinite().all() and not got[~valid].any()):
        fail(f"{what}: shape, dtype, non-finite output or a sentinel row "
             f"written")
    g, w = got[valid].float(), want[valid].float()
    err = (g - w).abs()
    rel = ((err.amax(-1) / w.abs().amax(-1)).max().item() if dt == "bfloat16"
           else (err.max() / w.abs().max()).item())
    if rel > EXPERT_GEMV_TOL[dt]:
        fail(f"{what}: err {rel} of the largest plain value "
             f"(tol {EXPERT_GEMV_TOL[dt]})")
    return rel, err.max().item()


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
    weight shape, dtype) of the calls.  fp32 calls also against a float64
    evaluation (max |err| over max |float64|): the kernel's worst no more
    than F64_RATIO times the plain version's worst."""
    import torch
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels.dequant_gemm import ref_quant_einsum
    if len(calls) != n_calls:
        fail(f"{cfg.name}: {len(calls)} packed-weight GEMM calls recorded "
             f"in one prefill call, expected {n_calls}")
    worst, err_max, shapes = 0.0, 0.0, set()
    f64 = {"kernel": 0.0, "plain": 0.0}
    with torch.no_grad():
        for spec, x, w, out in calls:
            plain = ref_quant_einsum(spec, x, w)
            _, rel, err = gemm_error(
                f"{cfg.name}: served {spec} at {tuple(x.shape)}", out, plain)
            worst, err_max = max(worst, rel), max(err_max, err)
            shapes.add((spec, tuple(x.shape), tuple(w.shape),
                        str(x.dtype).replace("torch.", "")))
            if x.dtype == torch.float32:
                want = torch.einsum(spec, x.double(), dequantize(w).double())
                m = want.abs().max()
                for key, got in (("kernel", out), ("plain", plain)):
                    f64[key] = max(f64[key], ((got.double() - want).abs()
                                              .max() / m).item())
                del want
    out = {"calls": len(calls), "worst_err_over_max": worst,
           "max_abs_err": err_max, "tol": DG_TOL,
           "shapes_spec_x_w_dtype": sorted(shapes)}
    if cfg.dtype == "float32":
        if f64["kernel"] > F64_RATIO * f64["plain"]:
            fail(f"{cfg.name}: fp32 GEMM vs float64 {f64['kernel']}, plain "
                 f"{f64['plain']} (at most {F64_RATIO}x)")
        out["vs_float64_err_over_max"] = dict(f64, max_ratio=F64_RATIO)
    return out


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


def time_gemm_shapes(sm, cfgs, dtype=None):
    """The packed-weight GEMM at every distinct projection shape of
    ``cfgs`` (q, k/v, o, up/gate, down; Mamba-2's in_proj and out_proj),
    q4 g32 at DG_SERVED_ROWS rows in bf16 (or ``dtype``), through
    ``quant_einsum`` (the kernel its route picks), beside ``dequantize`` +
    ``torch.matmul`` (fp32: full fp32, TF32 off) and ``torch.matmul`` on
    the weight dequantized beforehand; each time from the profiler
    (device ms) and from CUDA events around the loop (event ms), and the
    bound from the codes, scales, x and y bytes and 2 M N K operations
    (fp32: at the FFMA peak, and beside it the split-TF32 route's own
    three TF32 products at 495 TFLOP/s)."""
    import torch
    from repro_torch.core.quantize import QuantSpec, dequantize, quantize
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dequant_gemm import quant_einsum
    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    esize = 4 if fp32 else 2
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
            x = sm.randn(1, M, *xshape, dtype=dtype)
            w = quantize(sm.randn(*wshape, scale=wshape[0] ** -0.5,
                                  dtype=dtype), QuantSpec(4, group_size=32))
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
                   + esize * (M * K + M * N))
            fl = 2 * M * N * K
            b_ms, b_by = bound(byt, fl, FP32_FLOPS_PER_S if fp32
                               else BF16_FLOPS_PER_S)
            reset_launch_counts()       # the kernel this shape launches
            with torch.no_grad():
                quant_einsum(spec, x, w)
            route = [k.split("/", 1)[1] for k, n in launch_counts().items()
                     if k.startswith("dequant_gemm/") and n]
            row = {
                "model": cfg.name, "proj": names[spec], "M": M, "K": K,
                "N": N, "dtype": str(dtype).replace("torch.", ""),
                "route": route,
                "ms": dev_or_call(t_k), "event_ms": t_k[1],
                "bound_ms": b_ms, "bound_by": b_by,
                "dequantize_matmul_ms": dev_or_call(t_l),
                "dequantize_matmul_event_ms": t_l[1],
                "dense_matmul_ms": dev_or_call(t_d),
                "dense_matmul_event_ms": t_d[1]}
            if fp32:
                r_ms, r_by = bound(byt, 3 * fl, TF32_FLOPS_PER_S)
                row.update(bound_ms_tf32x3_route=r_ms,
                           bound_by_tf32x3_route=r_by)
            rows.append(row)
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
        self.err = 0.0                   # max abs err over the calls

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
        self.err = max(self.err, err.max().item())
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
        self.err = 0.0

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
            self.err = max(self.err, (o - w).abs().max().item())
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


class ExpertCalls(MlpCalls):
    """``MlpCalls`` for ``fused_decode.ops.fused_mlp_experts`` (the MoE's
    decode): each call made while ``armed`` against
    ``ref_fused_mlp_experts`` on its own inputs, ``expert_rows_error``'s
    gate (each valid row within EXPERT_GEMV_TOL, sentinel rows 0)."""

    def __init__(self):
        from repro_torch.kernels.fused_decode import ops, ref
        self.ops, self.inner = ops, ops.fused_mlp_experts
        self.ref = ref.ref_fused_mlp_experts
        self.armed, self.calls, self.worst, self.bc = False, 0, 0.0, 0
        self.err = 0.0

    def __call__(self, h, w_up, w_down, w_gate, idx, gates, valid, *, act):
        out = self.inner(h, w_up, w_down, w_gate, idx, gates, valid, act=act)
        if not self.armed:
            return out
        with plain_sums():
            want = self.ref(h, w_up, w_down, w_gate, idx, gates, valid,
                            act=act)
        rel, err = expert_rows_error(
            f"served fused_mlp_experts at {tuple(h.shape)}", out, want, valid)
        self.calls += 1
        self.worst, self.err = max(self.worst, rel), max(self.err, err)
        self.bc = int(h.shape[0])
        return out

    def __enter__(self):
        self.ops.fused_mlp_experts = self
        return self

    def __exit__(self, *exc):
        self.ops.fused_mlp_experts = self.inner


class HeldSsd:
    """Every SSD kernel call made inside the ``with`` block held, as it is
    made, against the plain ``ssd_chunked`` on its own inputs
    (``ssd_errors``' gates; the plain version counts no launch): calls,
    the worst errors, the share of y elements that differ, the (B, S,
    H, P, chunk) of the calls."""

    def __init__(self):
        from repro_torch.kernels.ssd import ops
        self.ops, self.inner = ops, ops.ssd
        self.keys = ("h_rel_err", "worst_head_y_err_over_max",
                     "y_max_abs_err", "h_max_abs_err")
        self.worst = dict.fromkeys(self.keys, 0.0)
        self.calls, self.differ, self.total, self.shapes = 0, 0, 0, set()

    def __call__(self, x, dt, A, Bm, Cm, *, chunk=256):
        out = self.inner(x, dt, A, Bm, Cm, chunk=chunk)
        *errs, n = ssd_errors((x, dt, A, Bm, Cm), out, chunk,
                              f"served ssd at {tuple(x.shape)}")
        for k, v in zip(self.keys, errs):
            self.worst[k] = max(self.worst[k], v)
        self.calls += 1
        self.differ, self.total = self.differ + n, self.total + out[0].numel()
        self.shapes.add(tuple(int(d) for d in x.shape) + (chunk,))
        return out

    def record(self):
        return dict(self.worst, calls=self.calls,
                    y_differing_share=self.differ / max(1, self.total),
                    shapes_B_S_H_P_chunk=sorted(self.shapes),
                    tol={"h": SSD_H_TOL, "y_head": KERNEL_TOL})

    def __enter__(self):
        self.ops.ssd = self
        return self

    def __exit__(self, *exc):
        self.ops.ssd = self.inner


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

    def held(self, sm, what):
        """Every kept call's served output against the plain version on
        its own inputs (``Smoke.flash_held``'s gates): calls, the worst
        error over the largest plain magnitude, the max abs error (into
        ``sm.errs``), the calls by (B, Sq, Sk, H, KV, hd, causal)."""
        worst, err_max, shapes = 0.0, 0.0, {}
        with sm.torch.no_grad():
            for q, k, v, causal, out in self.calls:
                w, err = sm.flash_held(q, k, v, causal, f"{what}: served "
                                       f"at {tuple(q.shape)}", got=out)
                worst, err_max = max(worst, w), max(err_max, err)
                key = str(tuple(q.shape[:2]) + (k.shape[1],)
                          + tuple(q.shape[2:3]) + tuple(k.shape[2:])
                          + (causal,))
                shapes[key] = shapes.get(key, 0) + 1
        sm.errs["flash_attention"] = max(sm.errs["flash_attention"], err_max)
        return {"calls": len(self.calls), "worst_err_over_max": worst,
                "max_abs_err": err_max, "tol": KERNEL_TOL,
                "calls_by_B_Sq_Sk_H_KV_hd_causal": shapes}

    def __enter__(self):
        self.mod.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.inner


def clone_pool(pool):
    return tuple(tuple(t.clone() for t in pos) for pos in pool)


class DecodeSteps:
    """Wraps an engine's ``_decode`` inside the ``with`` block: counts
    each decode step's launches (a replay adds its graph's), keeps each
    step's (slot ids, lengths, logits) with ``keep_steps``, and the first
    cohort state with at least two live rows: the pool before the step,
    the bucket graph's static inputs, the served step's logits and the
    pool after it, all cloned (the logits are the graph's static buffer,
    which the next replay of any bucket may overwrite)."""

    def __init__(self, eng, keep_steps=False):
        self.eng, self.inner, self.keep_steps = eng, eng._decode, keep_steps
        self.state, self.launches, self.steps = None, [], []

    def __call__(self, tokens, lengths, slot_ids, tables):
        from repro_torch.kernels import launch_counts
        take = self.state is None and len(self.eng.live) >= 2
        if take:
            self.state = {"pool": clone_pool(self.eng.slots.pool)}
        before = launch_counts()
        logits, pool = self.inner(tokens, lengths, slot_ids, tables)
        after = launch_counts()
        self.launches.append({k: after[k] - before[k] for k in after
                              if after[k] != before[k]})
        if take:
            fn = self.eng._cohort_fn(int(tokens.shape[0]))
            self.state.update(args=tuple(t.clone() for t in fn.inputs),
                              logits=logits.clone(),
                              pool_after=clone_pool(pool))
        if self.keep_steps:
            self.steps.append((slot_ids.tolist(), lengths.tolist(),
                               logits.clone()))
        return logits, pool

    def __enter__(self):
        self.eng._decode = self
        return self

    def __exit__(self, *exc):
        self.eng._decode = self.inner


def graph_check(cfg, eng, decode_steps):
    """The serve's CUDA graphs: one capture per distinct cohort bucket the
    serve decoded at, one replay per decode step."""
    buckets = sorted({eng._cohort_bucket(e.rid) for e in eng.trace
                      if e.event == "decode_cohort"})
    st = dict(eng.graph_stats)
    if st["captures"] != len(buckets) or st["replays"] != decode_steps:
        fail(f"{cfg.name}: cohort graphs {st} for buckets {buckets} and "
             f"{decode_steps} decode steps")
    return {"cohort_graph/capture": st["captures"],
            "cohort_graph/replay": st["replays"], "buckets": buckets,
            "capture_s": round(st["capture_s"], 3)}


def served_vs_eager(sm, cfg, eng, state, fused, held=()):
    """A captured cohort state (``DecodeSteps.state``) again through the
    eager ``ops.cohort_step`` that the engine's graph captured, on a copy
    of the pool before the step, with the kernel wrappers' held checks
    ``held`` armed: its logits and pool must equal the served (replayed)
    step's bit for bit.  Returns (record, eager logits, eager pool)."""
    from repro_torch.kernels.fused_decode import ops
    torch = sm.torch
    args = state["args"]
    pool = clone_pool(state["pool"])
    for h in held:
        h.armed = True
    try:
        with torch.no_grad():
            le, pe = ops.cohort_step(
                eng.params, cfg, *args, pool, block_size=eng.slots.block_size,
                paged=eng.slots.paged, use_fused=fused)
    finally:
        for h in held:
            h.armed = False
    torch.cuda.synchronize()
    pairs = [(a, b) for pa, pb in zip(pe, state["pool_after"])
             for a, b in zip(pa, pb)]
    if not (torch.equal(le, state["logits"])
            and all(torch.equal(a, b) for a, b in pairs)):
        err = (le - state["logits"]).abs().max().item()
        fail(f"{cfg.name}: the served (replayed) step differs from the "
             f"eager step: logits max err {err}, pool leaves equal "
             f"{[bool(torch.equal(a, b)) for a, b in pairs]}")
    return ({"logits_bit_equal": True, "pool_bit_equal": True,
             "bc": int(args[0].shape[0]),
             "rows": int((args[2] < eng.slots.n_slots).sum())}, le, pe)


# the kernels each decode breakdown times by name inside the step
STEP_KERNELS = ("kv_row_scatter", "cache_row_update", "gemv_kernel",
                "expert_up_kernel", "expert_down_kernel")


def step_kernels(per_step):
    """The device kernels of STEP_KERNELS that one decode step with the
    wrapper launches ``per_step`` runs: one KV-row scatter a
    ``kv_scatter``, one row update a ``cache_row_update``, one GEMV a
    ``fused_qkv/gemv`` and two a ``fused_mlp/gemv`` (one a stage), one
    routed experts' up stage and one down stage a ``fused_mlp/experts``."""
    return {"kv_row_scatter": per_step.get("kv_scatter", 0),
            "cache_row_update": per_step.get("cache_row_update", 0),
            "gemv_kernel": per_step.get("fused_qkv/gemv", 0)
            + 2 * per_step.get("fused_mlp/gemv", 0),
            "expert_up_kernel": per_step.get("fused_mlp/experts", 0),
            "expert_down_kernel": per_step.get("fused_mlp/experts", 0)}


def decode_breakdown(eng, host_args, rows, per_step):
    """One cohort step on the engine's pool, after the serve and its checks
    (the timed steps write into the pool), timed in turns two ways: as
    served, ``_decode``: one pinned copy of the host inputs and a replay
    of the bucket's CUDA graph (captured again: the serve's shutdown
    dropped it), and eagerly, ``ops.cohort_step`` on four host-to-device
    copies (the served step before the graphs).  Each: wall ms (host
    clock to a synchronize, median of 5 turns), device ms (the profiler's
    kernel time), busy share, tokens/s (``rows`` live rows over the wall
    time), the device ms and launches of the kernels named in
    STEP_KERNELS as one profiled run saw them, and the largest kernels.
    Fails unless the profiler sees kernels in each way, and a CUDA graph
    that captures the step, as the engine captures it for its replays,
    holds the kernels of STEP_KERNELS as often as the serve's launches
    ``per_step`` say (``step_kernels``): counted from the graph's own
    nodes (``captured_nodes``), not from the registry, nor from the
    profiler, which can miss a launch of a burst (``device_time``; its
    misses are reported)."""
    import torch
    from repro_torch.kernels import captured_nodes
    dev = eng.device
    want = step_kernels(per_step)
    with torch.no_grad():
        nodes = captured_nodes(eng._cohort_step,
                               *(torch.from_numpy(a).to(dev)
                                 for a in host_args), eng.slots.pool)
    captured = {k: sum(k in n for n in nodes) for k in STEP_KERNELS}
    if captured != want:
        fail(f"{eng.cfg.name}: a capture of the decode step holds "
             f"{captured} of {STEP_KERNELS} (want {want})")
    free()

    def graph():
        eng._decode(*host_args)
        torch.cuda.synchronize()

    def eager():
        with torch.no_grad():
            eng._cohort_step(*(torch.from_numpy(a).to(dev)
                               for a in host_args), eng.slots.pool)
        torch.cuda.synchronize()
    ways = (("eager", eager), ("graph", graph))
    walls = {name: [] for name, _ in ways}
    for _, f in ways:
        f()
    for _ in range(5):
        for name, f in ways:
            t0 = time.perf_counter()
            f()
            walls[name].append(time.perf_counter() - t0)
    out = {"bc": int(host_args[0].shape[0]), "rows": rows,
           "step_kernels_per_step": want, "step_kernels_captured": captured,
           "graph_nodes_captured": len(nodes)}
    for name, f in ways:
        kernel_us, by_name, n = device_time(f)
        counts = {k: [sum(us for nm, us, _ in by_name if k in nm) / 1e3,
                      sum(c for nm, _, c in by_name if k in nm)]
                  for k in STEP_KERNELS}
        wall_ms = sorted(walls[name])[2] * 1e3
        if n == 0:
            fail(f"{eng.cfg.name}: the profiler saw no kernel in the "
                 f"{name} step")
        out[name] = {"wall_ms": wall_ms, "device_ms": kernel_us / 1e3,
                     "device_ms_source": "profiler kernel time",
                     "device_kernels": n,
                     "profiler_missed": {k: want[k] - c for k, (_, c)
                                         in counts.items() if c != want[k]},
                     "device_busy_share": kernel_us / 1e3 / wall_ms,
                     "tok_s": rows / wall_ms * 1e3,
                     "kernels_ms_launches": counts,
                     "top_kernels_ms": [[k[:96], us / 1e3]
                                        for k, us, _ in by_name[:8]]}
    return out


def decode_rates(eng, decs):
    """The serve's decode rate from the engine's decode spans: tokens/s
    over the whole spans, which take in each bucket's warm-up and
    capture at its first step, and over the spans less the captures
    (``graph_stats["capture_s"]``)."""
    toks = sum(s.tokens for s in decs)
    span = sum(s.dt for s in decs)
    return {"decode_step_ms_mean": round(1e3 * span / max(1, len(decs)), 3),
            "decode_tok_s": round(toks / max(1e-9, span), 3),
            "decode_tok_s_excl_capture": round(
                toks / max(1e-9, span - eng.graph_stats["capture_s"]), 3)}


def stage_all(eng, timeout=STAGE_TIMEOUT_S):
    """Hand every queued vision request of ``eng`` to its staging threads
    (the engine's own hand-off, ``_feed_staging``, round after round as
    its per-class budgets allow) and wait until each is staged, failing
    past ``timeout`` seconds; a request that shares another's slab is
    staged when that one is bound.  Then the engine's first step admits
    them all together, whatever the staging threads' timing: its
    admission takes only staged requests.  The engine's policy is
    unchanged; only when its first step starts is."""
    if eng._worker is None:
        return
    pending = [r for r in eng.queue
               if r.vision_feats is not None and r.share_of is None]
    t_end = time.monotonic() + timeout
    while True:
        eng._feed_staging()
        waiting = [r for r in pending if not r.staged]
        if not waiting:
            break
        if time.monotonic() > t_end:
            fail(f"{eng.cfg.name}: requests {[r.rid for r in waiting]} "
                 f"not staged within {timeout} s")
        waiting[0]._staged_ev.wait(0.05)
    errors = [r.rid for r in pending if r.error is not None]
    if errors:
        fail(f"{eng.cfg.name}: staging failed for requests {errors}")


def serve_path(sm, cfg, reqs, use_fused=None, first_logits=None,
               policy="nanomind-serve", events=None, decode_state=None,
               staged=False):
    """Serve ``reqs`` on ``cfg`` at full width with the engine's decode
    step (``use_fused``: None, the engine's default, which must be the
    fused step; False, the composed step); check what the run must show,
    the launches of every decode step, the packed-weight GEMM calls of the
    first prefill call among it (``GemmCalls``, ``served_gemm_check``),
    every cache-row-update call of the captured step (``RowUpdateCalls``)
    and every flash call (``FlashCalls``, fp32 within FLASH_FP32_TOL,
    bf16 rows within KERNEL_TOL); return (serve record, engine, captured
    prefill: the largest group).  ``first_logits``, when given, is filled
    with each request's first-step (prefill) logits on the CPU; ``policy``
    packs the weights; ``events`` (a ``BrickEvents``) times each brick's
    calls of the run with CUDA events; ``decode_state``, when given,
    receives the timed cohort state (``host_args``, ``rows``, a clone of
    the ``pool`` before the step); ``staged``: every request staged
    (``stage_all``) before the engine's first step, so the serve admits
    them together and decodes at one cohort bucket."""
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
                               PROFILES[policy])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, params, n_slots=N_SLOTS,
                        max_len=MAX_LEN[cfg.name], block_size=BLOCK_SIZE,
                        use_fused=use_fused, device=sm.dev)
    del params
    if events is not None:
        events.attach(eng)
    fused = eng.use_fused
    if fused != (use_fused is None):
        fail(f"{cfg.name}: the engine selected use_fused={fused}")
    captured, prefills = {}, []
    prefill = eng._prefill
    steps = DecodeSteps(eng)

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
    eng._prefill = counting_prefill
    if first_logits is not None:
        record_first_logits(eng, first_logits)
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    with GemmCalls() as gemms, FlashCalls() as flashes, steps, eng:
        if staged:
            stage_all(eng)
        done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    eng._prefill = prefill
    if events is not None:
        events.detach()
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
    per_call = stack_gemms(cfg)
    want = {k: 0 for k in launches}
    want.update({k: n * decode_steps for k, n in per_step.items()})
    n_flash = L * n_prefill if cfg.attn_q_chunk == 0 else 0
    want["flash_attention"] = n_flash
    want[f"flash_attention/{FLASH_ROUTE[cfg.dtype]}"] = n_flash
    want["dequant_gemm"] = per_call * n_prefill
    want[f"dequant_gemm/{GEMM_ROUTE[cfg.dtype]}"] = per_call * n_prefill
    if not (launches == want and decode_steps > 0 and n_prefill > 0
            and len(steps.launches) == decode_steps
            and all(d == per_step for d in steps.launches)):
        fail(f"{cfg.name}: launch counts {launches} for {decode_steps} "
             f"decode steps and {n_prefill} prefill calls (want {want}; "
             f"per step {per_step}, got {steps.launches[:3]})")
    spans = eng.probe.samples()
    pre = [s for s in spans if s.brick == "decoder" and s.phase == "prefill"]
    decs = [s for s in spans if s.brick == "decoder" and s.phase == "decode"]
    serve = {"arch": cfg.name, "dtype": cfg.dtype, "policy": policy,
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
             **decode_rates(eng, decs),
             "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                  3),
             "kv_pool_mb": round(eng.slots.nbytes / 1e6, 3),
             "tabm": tstats, "launches": launches,
             "launches_per_decode_step": per_step,
             "cohort_graph": graph_check(cfg, eng, decode_steps)}
    serve["gemm_served_check"] = dict(served_gemm_check(
        cfg, gemms.calls, per_call), prefill_batch=captured[
        "prefill_batch"][0], prefill_width=captured["prefill_width"][0])
    del gemms
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

    # the captured cohort state again through the eager step the engine
    # captured, with the decode kernels' held checks armed (a replay runs
    # no Python, so they cannot sit in the served step): the served step
    # bit for bit against it; then through the fused and the plain
    # composed step (teacher-forced: the same inputs and pool)
    state = steps.state
    if state is None:
        fail(f"{cfg.name}: no multi-row cohort state was captured")
    args = state["args"]
    kw = dict(block_size=eng.slots.block_size, paged=eng.slots.paged)
    with RowUpdateCalls() as rows, MlpCalls() as mlps, QkvCalls() as qkvs:
        serve["served_vs_eager"], le, _ = served_vs_eager(
            sm, cfg, eng, state, fused, (rows, mlps, qkvs))
    if not fused and rows.calls != 2 * L:
        fail(f"{cfg.name}: {rows.calls} row-update calls held in the "
             f"eager step, expected {2 * L}")
    if fused and qkvs.calls != L:
        fail(f"{cfg.name}: {qkvs.calls} fused-QKV calls held in the "
             f"eager step, expected {L}")
    if fused and mlps.calls != L:
        fail(f"{cfg.name}: {mlps.calls} fused-MLP calls held in the "
             f"eager step, expected {L}")
    if fused:
        for key, held in (("qkv_served_check", qkvs),
                          ("mlp_served_check", mlps)):
            serve[key] = {
                "calls": held.calls, "worst_row_err_over_row_max": held.worst,
                "bc": held.bc, "dtype": cfg.dtype,
                "tol": MLP_ROW_TOL[cfg.dtype], "step": "eager"}
    else:
        serve["row_update_served_check"] = {
            "calls": rows.calls, "bit_exact": True, "step": "eager",
            "cache_shape_dtype_strides": sorted(rows.shapes)}
    with torch.no_grad():
        lf = le if fused else ops.cohort_step(
            eng.params, cfg, *args, clone_pool(state["pool"]),
            use_fused=True, **kw)[0]
        lr, pr = ref.ref_cohort_step(eng.params, cfg, *args, state["pool"],
                                     **kw)
    nrows = int((args[2] < eng.slots.n_slots).sum())
    if fused:
        serve["cohort_check"] = logit_check(cfg, lf[:nrows], lr[:nrows],
                                            "fused vs composed step")
    else:
        ls = state["logits"]
        same_pool = all(torch.equal(a, b) for a, b in
                        zip(state["pool_after"][0], pr[0]))
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
    del pr, le, lf, lr

    # where one decode step's time goes, served (graph replay) against
    # eager, on the captured state copied back into the engine's pool
    for pos, saved in zip(eng.slots.pool, state["pool"]):
        for leaf, t in zip(pos, saved):
            leaf.copy_(t)
    if decode_state is not None:
        decode_state.update(host_args=[t.cpu().numpy() for t in args],
                            rows=nrows, pool=clone_pool(state["pool"]))
    serve["decode_step_breakdown"] = decode_breakdown(
        eng, [t.cpu().numpy() for t in args], nrows, per_step)
    steps.state = state = None
    return serve, eng, prefills[0]


def same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape hold the same bytes."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.contiguous().reshape(-1), b.contiguous().reshape(-1)
    return bool(torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def serve_disagg(sm, cfg, reqs, single):
    """Serve ``reqs`` through ``serving.disagg.serve_disagg_inproc`` at
    full width: a prefill and a decode engine on the one card, the decode
    fleet on its own thread, the weights of phase 3 (``init_params`` seed
    0, ``nanomind-serve``), phase 3's engine settings (``single``: its
    serve record and tokens).  Clocks each request's hand-off (export to
    the host, encode, the send's byte movement, decode from the frame's
    first bytes to tensors, import to the card); holds every imported
    block bit for bit against the sender's export, the tokens against
    phase 3's, and the launch counts of each fleet (read when the
    prefill fleet sends ``done``, before which the decode fleet, holding
    all four requests in its four slots, takes no step).  Then runs the
    launcher with ``--full --transport pipe`` as a subprocess (the
    decode fleet a process of its own, more requests than its slots) and
    checks its exit code and OK line.  Returns the serve record."""
    import struct
    from repro_torch.core import transport as TR
    from repro_torch.core.bricks import decompose
    from repro_torch.core.scheduler import populate_brick_bytes
    from repro_torch.launch.serve_disagg import (recalibrated_line,
                                                 recalibrated_split)
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import init_params
    from repro_torch.serving.disagg import serve_disagg_inproc
    from repro_torch.serving.engine import ServingEngine
    torch = sm.torch
    if single["cohort_graph"]["buckets"] != [N_SLOTS]:
        fail(f"{DISAGG_PATH}: phase 3 decoded at buckets "
             f"{single['cohort_graph']['buckets']}; its tokens are held "
             f"against the decode fleet's, which decodes at {N_SLOTS}")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = quantize_tree(init_params(cfg, device=sm.dev, seed=0),
                               PROFILES["nanomind-serve"])
    hand = {r.rid: {"prompt_len": len(r.tokens)} for r in reqs}
    sent_kv, bit_equal, counts, engines = {}, {}, {}, {}
    export, admit = ServingEngine.export_remote, ServingEngine.admit_remote
    submit = ServingEngine.submit
    encode, send_frame = TR.encode_frame, TR.Transport.send_frame
    decode = TR.decode_frame

    def ms_since(t0):
        return round((time.perf_counter() - t0) * 1e3, 4)

    def stamped_submit(self, req):
        req.submit_t = time.time()      # time to first token from submit
        return submit(self, req)

    # the clocks synchronise their own thread's stream, never the whole
    # card: a device-wide sync in one thread would invalidate a capture
    # open in the other
    def timed_export(self, req):
        engines["prefill"] = self
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        rp = export(self, req)          # the copies to the host synchronise
        hand[rp.rid].update(export_d2h_ms=ms_since(t0),
                            kv_bytes=rp.kv_wire_bytes(),
                            slab_bytes=int(rp.slab.nbytes))
        sent_kv[rp.rid] = rp.kv
        return rp

    def timed_encode(kind, meta, arrays=(), rid=-1):
        t0 = time.perf_counter()
        frame = encode(kind, meta, arrays, rid)
        if kind == "prefill":
            hand[rid].update(encode_ms=ms_since(t0), frame_bytes=len(frame))
        return frame

    def timed_send(self, frame):
        _, rid, hl = struct.unpack_from("<4sqI", frame)
        kind = json.loads(frame[16:16 + hl])["kind"]
        if kind == "done" and "prefill" not in counts:
            counts["prefill"] = launch_counts()
        t0 = time.perf_counter()
        n = send_frame(self, frame)
        if kind == "prefill":
            hand[rid]["wire_ms"] = ms_since(t0)
        return n

    def timed_decode(read):
        first = []

        def clocked(n):
            out = read(n)
            if not first:               # the frame's first bytes in hand
                first.append(time.perf_counter())
            return out
        kind, meta, arrays, rid = decode(clocked)
        if kind == "prefill":
            hand[rid]["decode_ms"] = ms_since(first[0])
        return kind, meta, arrays, rid

    def timed_admit(self, msg):
        engines["decode"] = self
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        ok = admit(self, msg)
        torch.cuda.current_stream().synchronize()
        if ok:
            hand[msg.rid]["import_h2d_ms"] = ms_since(t0)
            slot = next(s for s, r in self.live.items() if r.rid == msg.rid)
            back = self.slots.export_blocks(slot, msg.kv[0][0].shape[1])
            bit_equal[msg.rid] = all(
                same_bits(got, want) and same_bits(got, wired)
                for p_got, p_want, p_wired in zip(back, sent_kv[msg.rid],
                                                  msg.kv)
                for got, want, wired in zip(p_got, p_want, p_wired))
        return ok

    kw = dict(n_slots=N_SLOTS, max_len=MAX_LEN[cfg.name],
              block_size=BLOCK_SIZE, async_staging=True, device=sm.dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with swapped(ServingEngine, "submit", stamped_submit), \
            swapped(ServingEngine, "export_remote", timed_export), \
            swapped(ServingEngine, "admit_remote", timed_admit), \
            swapped(TR, "encode_frame", timed_encode), \
            swapped(TR.Transport, "send_frame", timed_send), \
            swapped(TR, "decode_frame", timed_decode):
        results, stats = serve_disagg_inproc(
            cfg, params, reqs, prefill_kwargs=kw, decode_kwargs=kw)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    total = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pre, dec = engines["prefill"], engines["decode"]
    # the split repriced from what the in-process fleets' frames clocked
    graph = decompose(cfg)
    populate_brick_bytes(graph, params)
    resplit = recalibrated_split(graph, "inproc", stats, cfg.vision_tokens)
    del params, engines

    # the gates: every request served, its blocks landed bit for bit,
    # its tokens phase 3's, each fleet's kernels its own
    bad = [(rid, r.error) for rid, r in results.items() if r.error]
    if bad or sorted(results) != sorted(hand):
        fail(f"{DISAGG_PATH}: requests failed: {bad}")
    if sorted(bit_equal) != sorted(hand) or not all(bit_equal.values()):
        fail(f"{DISAGG_PATH}: imported blocks differ from the export: "
             f"{bit_equal}")
    want = single["tokens"]
    diverged = {rid: (r.tokens, want[rid]) for rid, r in results.items()
                if r.tokens != want[rid]}
    if diverged:
        fail(f"{DISAGG_PATH}: tokens differ from the single engine's: "
             f"{diverged}")
    if "prefill" not in counts:
        fail(f"{DISAGG_PATH}: the prefill fleet sent no done frame")
    pre_n = counts["prefill"]
    dec_n = {k: total[k] - pre_n[k] for k in total}
    L = cfg.n_layers
    pre_spans = [s for s in pre.probe.samples()
                 if s.brick == "decoder" and s.phase == "prefill"]
    decs = [s for s in dec.probe.samples()
            if s.brick == "decoder" and s.phase == "decode"]
    steps = sum(1 for e in dec.trace if e.event == "decode_step")
    g = dict(dec.graph_stats)
    per_call = stack_gemms(cfg)
    want_pre = {k: 0 for k in total}
    want_pre.update({"dequant_gemm": per_call * len(pre_spans),
                     f"dequant_gemm/{GEMM_ROUTE[cfg.dtype]}":
                     per_call * len(pre_spans)})
    want_dec = {k: 0 for k in total}
    want_dec.update({"fused_qkv": L * steps, f"fused_qkv/{MLP_ROUTE}":
                     L * steps, "fused_mlp": L * steps,
                     f"fused_mlp/{MLP_ROUTE}": L * steps,
                     "kv_scatter": steps})
    if not (pre_n == want_pre and dec_n == want_dec and pre_spans
            and steps > 0 and g["captures"] >= 1
            and g["replays"] == steps):
        fail(f"{DISAGG_PATH}: launches of the prefill fleet {pre_n} (want "
             f"{want_pre}), of the decode fleet {dec_n} (want {want_dec}); "
             f"{len(pre_spans)} prefill calls, {steps} decode steps, "
             f"graphs {g}")
    lanes = stats.sent * stats.lane_bytes_baseline
    if not 0 < stats.kv_wire_bytes < lanes:
        fail(f"{DISAGG_PATH}: {stats.kv_wire_bytes} bytes of paged KV on "
             f"the wire against {lanes} of whole lanes")
    if any(len(h) != 9 for h in hand.values()):
        fail(f"{DISAGG_PATH}: hand-off clocks missing: {hand}")
    for r in reqs:
        hand[r.rid]["slot_class"] = r.slot_class
    rates = decode_rates(dec, decs)
    serve = {
        "path": DISAGG_PATH, "arch": cfg.name, "dtype": cfg.dtype,
        "transport": stats.transport, "requests": len(results),
        "serve_s": round(serve_s, 3),
        "prefill_fleet": {
            "prefill_calls": len(pre_spans),
            "prefill_ms": [round(s.dt * 1e3, 3) for s in pre_spans],
            "ttft_ms": {r.rid: round((r.first_token_t - r.submit_t) * 1e3,
                                     3) for r in reqs},
            "launches": {k: n for k, n in pre_n.items() if n}},
        "handoff": hand,
        "wire": {"frames_bytes": stats.wire_bytes,
                 "kv_wire_bytes": stats.kv_wire_bytes,
                 "lane_bytes_baseline": stats.lane_bytes_baseline,
                 "lanes_bytes": lanes,
                 "kv_over_lanes": round(stats.kv_wire_bytes / lanes, 4),
                 "wire_seconds": round(stats.wire_seconds, 6)},
        "decode_fleet": dict(
            rates, decode_steps=steps, decoded_tokens=dec.stats
            .decoded_tokens, cohort_graph={
                "cohort_graph/capture": g["captures"],
                "cohort_graph/replay": g["replays"],
                "capture_s": round(g["capture_s"], 3)},
            launches={k: n for k, n in dec_n.items() if n}),
        "single_engine": {k: single[k] for k in (
            "decode_tok_s", "decode_tok_s_excl_capture", "peak_mem_gb")},
        "imported_blocks_bit_equal": len(bit_equal),
        "tokens_equal_single_engine": len(results),
        "peak_mem_gb": round(peak_gb, 3), "launches": total}
    del pre, dec
    free()

    # the launcher, its decode fleet a subprocess over a pipe
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_disagg", "--full",
           "--transport", "pipe", "--requests", str(DISAGG_PIPE_REQUESTS),
           "--max-new", "16"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    lines = proc.stdout.splitlines()
    ok = [ln for ln in lines if ln.startswith(
        "OK: disaggregated prefill/decode fleets over pipe")]
    if proc.returncode != 0 or not ok:
        fail(f"{DISAGG_PATH}: the pipe launcher exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    split = [ln for ln in lines if ln.startswith("[schedule_split @ pipe] ")]
    respl = [ln for ln in lines
             if ln.startswith("[schedule_split recalibrated @ ")]
    if len(split) != 1 or len(respl) != 1:
        fail(f"{DISAGG_PATH}: the pipe launcher printed {len(split)} split "
             f"pricing and {len(respl)} recalibrated lines: {lines[:20]}")
    serve["recalibrated_split"] = {
        "inproc_fleets": None if resplit is None
        else recalibrated_line(*resplit),
        "inproc_wire": {"bytes": stats.wire_bytes,
                        "seconds": stats.wire_seconds, "sent": stats.sent},
        "pipe_launcher": respl[0]}
    serve["pipe_launcher"] = {
        "cmd": " ".join(cmd[1:]), "rc": proc.returncode,
        "wall_s": round(time.perf_counter() - t0, 3),
        "lines": [ln for ln in lines if ln.startswith("[")] + ok}
    return serve


def record_first_logits(eng, into):
    """Each request's first picked logits row (its prefill's, teacher
    forced), as fp32 on the CPU, into ``into[rid]``."""
    pick_rows = eng._pick_rows

    def recording(logits, reqs):
        for b, r in enumerate(reqs):
            if r.rid not in into:
                into[r.rid] = logits[b].float().cpu()
        return pick_rows(logits, reqs)
    eng._pick_rows = recording


def card_trace():
    """A :class:`PlanTrace` that also reads the host clock and the card's
    allocated bytes at every event, into ``.card`` (the counted bytes
    are the plan's)."""
    import torch
    from repro_torch.core.plan import PlanTrace

    class CardTrace(PlanTrace):
        def record(self, brick, phase, resident):
            super().record(brick, phase, resident)
            self.card.append((time.perf_counter(),
                              torch.cuda.memory_allocated()))
    trace = CardTrace()
    trace.card = []
    return trace


def clocked_run(torch, run, *args):
    """``run(*args)`` between two CUDA events and two host reads, the
    current stream synchronised at both ends: (result, event ms, wall
    ms)."""
    torch.cuda.current_stream().synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    out = run(*args)
    e1.record()
    torch.cuda.current_stream().synchronize()
    return out, e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3


def clocked_plan_runs(make, inputs, n_runs, want, what):
    """Build a plan with ``make`` on a card holding nothing of the
    model, run ``inputs`` once to warm up and ``n_runs`` times clocked
    (``card_trace``, ``clocked_run``), each clocked run's launches equal
    to ``want``.  Returns (plan, output of the last run, its trace,
    launches of each clocked run, event ms and wall ms of each, peak
    allocated bytes, allocated bytes at the start)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    free()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    plan = make()
    evs, walls, counts = [], [], []
    with torch.no_grad():
        out, _ = plan.run(inputs)
        for _ in range(n_runs):
            del out
            trace = card_trace()
            reset_launch_counts()
            (out, _), ev_ms, wall_ms = clocked_run(torch, plan.run, inputs,
                                                   trace)
            counts.append(launch_counts())
            evs.append(ev_ms)
            walls.append(wall_ms)
    peak = torch.cuda.max_memory_allocated()
    if any(c != want for c in counts):
        fail(f"{what}: launches {counts} (want {want} a run)")
    return plan, out, trace, counts, evs, walls, peak, start


def run_times(evs, walls):
    return {"event_ms": evs, "wall_ms": walls,
            "event_ms_median": statistics.median(evs),
            "wall_ms_median": statistics.median(walls)}


def placed_and_cascade(sm, cfg, reqs, first3):
    """Phase 3d on phase 3's weights (``init_params`` seed 0, packed by
    ``nanomind-serve``) and first request (a 729-token image and 16
    text tokens, run right-padded to PLACED_WIDTH): the scheduler's
    placement on ``edge_accelerators()`` from the packed tree's brick
    bytes, both objectives (modeled, from the reference's edge
    profiles); the request through the resident
    all-card plan (the weights moved to the card once, the tied table
    shared by the embedding and the head), through the placed plan (the NPU bricks on the CPU,
    the embeds across one CPU -> card edge into a TABM ring on the card)
    and through the On-Demand Cascade on the card (each brick loaded,
    executed, released); then phase 3's requests through an engine with
    the placement.  Gates: logits within STEP_TOL of the largest against
    the resident plan's (the engine's first steps against phase 3's
    ``first3``), every decoder projection through the packed-weight GEMM
    (none from the CPU bricks), the cascade's card allocation back after
    every release to its value before that brick's load plus at most
    its output and RELEASE_SLACK, the cascade's card peak under the
    resident plan's.  Returns (record, launches by run)."""
    from repro_torch.analysis.energy import hours_on_battery
    from repro_torch.core.bricks import decompose
    from repro_torch.core.cascade import CascadeRunner
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.quantize import (PROFILES, QTensor, quantize_tree,
                                           tree_bytes)
    from repro_torch.core.scheduler import (edge_accelerators,
                                            populate_brick_bytes, schedule)
    from repro_torch.core.tabm import RingBuffer
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.tree import tree_map
    torch = sm.torch
    with torch.no_grad():
        params = quantize_tree(init_params(cfg, device=sm.dev, seed=0),
                               PROFILES["nanomind-serve"])
    host = tree_map(lambda l: l.to("cpu") if isinstance(
        l, (torch.Tensor, QTensor)) else l, params)
    del params
    free()
    req = reqs[0]
    n_tok = int(req.tokens.shape[0])
    tokens = torch.zeros((1, PLACED_WIDTH), dtype=torch.int32)
    tokens[0, :n_tok] = torch.from_numpy(req.tokens)
    inputs = {"tokens": tokens,
              "vision_feats": torch.from_numpy(req.vision_feats)}
    L = cfg.n_layers
    gemms = stack_gemms(cfg)
    route = f"dequant_gemm/{GEMM_ROUTE[cfg.dtype]}"

    # -- the placement, priced on the packed tree's bytes -----------------
    graph = decompose(cfg)
    populate_brick_bytes(graph, host)
    acc = edge_accelerators()
    placements = {obj: schedule(graph, acc, n_tok, obj)
                  for obj in ("latency", "energy")}
    pl = placements["latency"]
    if not (pl.backends["projector"] == "host"
            and pl.backends["decoder"] == "device"):
        fail(f"{PLACED_PATH}: the placement puts no brick across the "
             f"units: {pl}")
    rec = {"path": PLACED_PATH, "arch": cfg.name, "dtype": cfg.dtype,
           "prompt_tokens": n_tok, "run_width": PLACED_WIDTH,
           "brick_bytes": {b.name: b.param_bytes for b in graph.bricks},
           "sum_bytes_once": tree_bytes(host),
           "placement_modeled": {
               obj: {"placement": str(p), "assignment": p.assignment,
                     "backends": p.backends, "latency_s": p.latency_s,
                     "energy_j": p.energy_j,
                     "hours_on_battery": hours_on_battery(
                         p.energy_j / p.latency_s, BATTERY_MAH),
                     "battery_mah": BATTERY_MAH}
               for obj, p in placements.items()},
           "modeled_note": ("modeled, reference's edge profiles "
                            "(analysis/energy.py): not the card's")}
    for obj, p in placements.items():
        print(f"[placement {obj}] {p} hours={rec['placement_modeled'][obj]['hours_on_battery']:.3f} "
              f"on {BATTERY_MAH:.0f} mAh (modeled, reference's edge "
              f"profiles)")

    def card_run(make, what):
        """``clocked_plan_runs`` of the request, PLACED_RUNS clocked;
        the logits of the last run on the CPU."""
        plan, out, *rest = clocked_plan_runs(
            make, inputs, PLACED_RUNS, want_gemm,
            f"{what} (want the decoder's projections on the card, none "
            f"from the CPU bricks)")
        if tuple(out.shape) != (1, PLACED_WIDTH, cfg.padded_vocab):
            fail(f"{what}: logits of shape {tuple(out.shape)}")
        return (plan, out[0, :n_tok].float().cpu(), *rest)

    def on_card(tree):
        return tree_map(lambda l: l.to(sm.dev) if isinstance(
            l, (torch.Tensor, QTensor)) else l, tree)

    def summed(counts):
        return {k: sum(c[k] for c in counts) for k in counts[0]}

    want_gemm = {k: 0 for k in launch_counts()}
    want_gemm.update({"dequant_gemm": gemms, route: gemms})

    # -- the resident plan: every brick on the card, the weights moved
    # there once (the tied table shared by the embedding and the head) --
    plan, want, _, res_n, res_ev, res_wall, res_peak, res_start = card_run(
        lambda: compile_plan(graph, on_card(host)), f"{PLACED_PATH} resident")
    del plan

    # -- the placed plan: the NPU bricks on the CPU, one edge to the card -
    ring = RingBuffer(n_slots=2, max_tokens=cfg.vision_tokens,
                      dim=cfg.d_model, dtype=cfg.dtype, device=sm.dev)
    plan, got, _, pl_n, pl_ev, pl_wall, pl_peak, _ = card_run(
        lambda: compile_plan(graph, on_card(host), placement=pl, accels=acc,
                             tabm=ring), PLACED_PATH)
    on = {s.accel.name: s.backend.device.type for s in plan.steps}
    crossing = [(k[0], k[1]) for k in plan.pipes
                if k[0] != "-" and on[k[0]] == "cpu" and on[k[1]] == "cuda"]
    if len(crossing) != 1 or plan._tabm_transfer is None:
        fail(f"{PLACED_PATH}: CPU -> card edges {crossing} (want one, the "
             f"TABM edge, producer-side)")
    if not (ring.stats["writes"] == ring.stats["reads"] == PLACED_RUNS + 1
            and all(st == 0 for st in ring.states)):
        fail(f"{PLACED_PATH}: TABM ring {ring.stats} {ring.states}")
    rec["placed"] = {
        "describe": plan.describe(), "edges": [list(k[:2]) for k in
                                               plan.pipes],
        "cpu_to_card_edges": crossing, "tabm": dict(ring.stats),
        "vs_resident": logit_check(cfg, got, want, "placed vs resident"),
        "bit_equal_to_resident": bool(torch.equal(got, want)),
        **run_times(pl_ev, pl_wall), "card_peak_mb": pl_peak / 1e6,
        "launches_a_run": {k: n for k, n in pl_n[-1].items() if n}}
    del plan, ring, got
    free()

    # -- the cascade on the card: load -> execute -> release per brick ----
    outs, before = {}, []
    runner_box = []

    def make_cascade():
        runner = CascadeRunner(graph, host)
        be = runner.backend
        load = be.load

        def marked_load(brick, bound):
            before.append((brick.name, torch.cuda.memory_allocated()))
            return load(brick, bound)
        be.load = marked_load
        for st in runner.plan.steps:
            def sized(p, ctx, _fn=st.fn, _name=st.brick.name):
                out = _fn(p, ctx)
                outs[_name] = out.numel() * out.element_size()
                return out
            st.fn = sized
        runner_box.append(runner)
        return runner.plan

    plan, got, trace, cas_n, cas_ev, cas_wall, cas_peak, cas_start = \
        card_run(make_cascade, CASCADE_PATH)
    if cas_peak >= res_peak:
        fail(f"{CASCADE_PATH}: the card's peak {cas_peak} is not under the "
             f"resident plan's {res_peak}")
    names = graph.names()
    before = before[-len(names):]             # the clocked run's loads
    ev = [(e.brick, e.phase, e.t, e.resident_bytes, t, a)
          for e, (t, a) in zip(trace.events, trace.card)]
    bricks, t_prev = [], None
    for i, name in enumerate(names):
        (b0, a0), rows = before[i], ev[3 * i:3 * i + 3]
        if b0 != name or [r[:2] for r in rows] != [
                (name, "load"), (name, "execute"), (name, "release")]:
            fail(f"{CASCADE_PATH}: trace events {[r[:2] for r in rows]} "
                 f"for brick {name}")
        (_, _, _, c_load, t_load, a_load), (_, _, _, c_exec, t_exec,
                                             a_exec), \
            (_, _, _, c_rel, t_rel, a_rel) = rows
        loaded = a_load - a0
        left = a_rel - a0
        pbytes = graph.brick(name).param_bytes
        if loaded < pbytes or left > outs[name] + RELEASE_SLACK:
            fail(f"{CASCADE_PATH}: brick {name} loaded {loaded} bytes onto "
                 f"the card (params {pbytes}) and left {left} after its "
                 f"release (output {outs[name]})")
        bricks.append({
            "brick": name, "param_bytes": pbytes,
            "load_ms": None if t_prev is None else (t_load - t_prev) * 1e3,
            "execute_ms": (t_exec - t_load) * 1e3,
            "release_ms": (t_rel - t_exec) * 1e3,
            "counted_bytes": [c_load, c_exec, c_rel],
            "allocated_bytes": [a_load, a_exec, a_rel],
            "allocated_before_load": a0, "left_after_release": left,
            "output_bytes": outs[name]})
        t_prev = t_rel
    if trace.events[-1].resident_bytes != 0:
        fail(f"{CASCADE_PATH}: {trace.events[-1].resident_bytes} counted "
             f"bytes resident after the last release")
    rec["cascade"] = {
        "vs_resident": logit_check(cfg, got, want, "cascade vs resident"),
        "bit_equal_to_resident": bool(torch.equal(got, want)),
        **run_times(cas_ev, cas_wall), "trace_peak_bytes": trace.peak_bytes,
        "trace_sum_bytes": trace.sum_bytes,
        "peak_over_sum": trace.peak_bytes / trace.sum_bytes,
        "card_peak_mb": cas_peak / 1e6, "card_start_mb": cas_start / 1e6,
        "bricks": bricks,
        "first_load_ms_note": ("the first brick's load is not clocked apart "
                               "from the run's start"),
        "launches_a_run": {k: n for k, n in cas_n[-1].items() if n}}
    rec["resident"] = {**run_times(res_ev, res_wall),
                       "card_peak_mb": res_peak / 1e6,
                       "card_start_mb": res_start / 1e6,
                       "launches_a_run": {k: n for k, n in res_n[-1].items()
                                          if n}}
    rec["clocked_runs"] = PLACED_RUNS
    rec["card_peak_saved_mb"] = (res_peak - cas_peak) / 1e6
    del plan, runner_box, got, want
    free()

    # -- the engine with the placement: phase 3's requests ----------------
    firsts = {}
    eng = ServingEngine(cfg, host, n_slots=N_SLOTS, max_len=MAX_LEN[cfg.name],
                        block_size=BLOCK_SIZE, placement=pl, accels=acc,
                        device=sm.dev)
    record_first_logits(eng, firsts)
    if not (eng.plan.backend_of("projector").device.type == "cpu"
            and eng.plan._tabm_transfer is not None):
        fail(f"{PLACED_ENGINE_PATH}: the engine's plan is not placed: "
             f"{eng.plan.describe()}")
    for r in reqs:
        r.max_new_tokens = PLACED_ENGINE_NEW
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    with eng:
        done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    eng_n = launch_counts()
    bad = [r for r in done if r.error is not None
           or len(r.out_tokens) != PLACED_ENGINE_NEW]
    if len(done) != len(reqs) or bad:
        fail(f"{PLACED_ENGINE_PATH}: requests failed: "
             f"{[(r.rid, repr(r.error), r.out_tokens) for r in bad]}")
    spans = eng.probe.samples()
    n_pre = sum(1 for s in spans if s.brick == "decoder"
                and s.phase == "prefill")
    steps = sum(1 for e in eng.trace if e.event == "decode_step")
    want_eng = {k: 0 for k in eng_n}
    want_eng.update({"dequant_gemm": gemms * n_pre, route: gemms * n_pre,
                     "fused_qkv": L * steps, f"fused_qkv/{MLP_ROUTE}":
                     L * steps, "fused_mlp": L * steps,
                     f"fused_mlp/{MLP_ROUTE}": L * steps,
                     "kv_scatter": steps})
    if eng_n != want_eng or not n_pre or not steps:
        fail(f"{PLACED_ENGINE_PATH}: launches {eng_n} (want {want_eng}) "
             f"for {n_pre} prefill calls and {steps} decode steps")
    tstats = eng.tabm.stats
    if tstats["writes"] != tstats["reads"]:
        fail(f"{PLACED_ENGINE_PATH}: TABM writes/reads {tstats}")
    rids = sorted(first3)
    if sorted(firsts) != rids:
        fail(f"{PLACED_ENGINE_PATH}: first steps of {sorted(firsts)}, "
             f"phase 3 of {rids}")
    rec["engine"] = {
        "path": PLACED_ENGINE_PATH, "requests": len(done),
        "max_new_tokens": PLACED_ENGINE_NEW, "serve_s": serve_s,
        "prefill_calls": n_pre, "decode_steps": steps,
        "first_step_vs_phase3": logit_check(
            cfg, torch.stack([firsts[i] for i in rids]),
            torch.stack([first3[i] for i in rids]),
            "placed engine's first steps vs phase 3's"),
        "tabm": dict(tstats), "graph_stats": dict(eng.graph_stats),
        "launches": {k: n for k, n in eng_n.items() if n}}
    del eng
    free()
    return rec, {PLACED_PATH: summed(pl_n), CASCADE_PATH: summed(cas_n),
                 PLACED_ENGINE_PATH: eng_n}


def card_label():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


class Nvml:
    """The card's energy counter through NVML, by ``ctypes`` (the library
    ``nvidia-smi`` loads, ``libnvidia-ml.so.1``).  The handle is picked by
    the CUDA device's UUID (or, failing that, its PCI bus id), never by
    index: NVML's indices ignore ``CUDA_VISIBLE_DEVICES``.  ``window``
    reads ``nvmlDeviceGetTotalEnergyConsumption`` (mJ) around a workload;
    where the card answers NOT_SUPPORTED for the counter, it integrates
    ``nvmlDeviceGetPowerUsage`` sampled every POWER_SAMPLE_S instead.  Any
    other failing call fails the phase."""

    NOT_SUPPORTED = 3

    def __init__(self, dev):
        import ctypes
        import torch
        self.ct = ctypes
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        dev_p, c_int = ctypes.c_void_p, ctypes.c_int
        for fn, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByUUID",
                 [ctypes.c_char_p, ctypes.POINTER(dev_p)]),
                ("nvmlDeviceGetHandleByPciBusId_v2",
                 [ctypes.c_char_p, ctypes.POINTER(dev_p)]),
                ("nvmlDeviceGetName", [dev_p, ctypes.c_char_p,
                                       ctypes.c_uint]),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [dev_p, ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetPowerUsage",
                 [dev_p, ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [dev_p, ctypes.POINTER(ctypes.c_ulonglong)])):
            getattr(self.lib, fn).argtypes = args
            getattr(self.lib, fn).restype = c_int
        self.lib.nvmlErrorString.argtypes = [c_int]
        self.lib.nvmlErrorString.restype = ctypes.c_char_p
        self.call("nvmlInit_v2")
        props = torch.cuda.get_device_properties(dev)
        self.handle = ctypes.c_void_p()
        uuid = str(props.uuid)
        uuid = uuid if uuid.startswith("GPU-") else "GPU-" + uuid
        rc = self.lib.nvmlDeviceGetHandleByUUID(uuid.encode(),
                                                ctypes.byref(self.handle))
        if rc == 0:
            self.picked_by = f"uuid {uuid}"
        else:
            bus = (f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
                   f"{props.pci_device_id:02X}.0")
            self.call("nvmlDeviceGetHandleByPciBusId_v2", bus.encode(),
                      ctypes.byref(self.handle))
            self.picked_by = f"pci bus id {bus} (by uuid: {self.error(rc)})"
        name = ctypes.create_string_buffer(96)
        self.call("nvmlDeviceGetName", self.handle, name, ctypes.c_uint(96))
        self.name = name.value.decode()
        limit = ctypes.c_uint()
        self.call("nvmlDeviceGetEnforcedPowerLimit", self.handle,
                  ctypes.byref(limit))
        self.power_limit_w = limit.value / 1e3
        e = ctypes.c_ulonglong()
        rc = self.lib.nvmlDeviceGetTotalEnergyConsumption(self.handle,
                                                          ctypes.byref(e))
        if rc not in (0, self.NOT_SUPPORTED):
            fail(f"NVML nvmlDeviceGetTotalEnergyConsumption: "
                 f"{self.error(rc)}")
        self.counter = rc == 0
        self.period_s = POWER_SAMPLE_S

    def error(self, rc):
        return f"{rc} ({self.lib.nvmlErrorString(rc).decode()})"

    def call(self, fn, *args):
        rc = getattr(self.lib, fn)(*args)
        if rc != 0:
            fail(f"NVML {fn}: {self.error(rc)}")

    def energy_mj(self) -> int:
        e = self.ct.c_ulonglong()
        self.call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                  self.ct.byref(e))
        return e.value

    def power_w(self) -> float:
        p = self.ct.c_uint()
        self.call("nvmlDeviceGetPowerUsage", self.handle, self.ct.byref(p))
        return p.value / 1e3

    def counter_step(self, seconds=1.0):
        """Poll the counter for ``seconds``: its distinct increments (mJ)
        and the median time between updates, which sets every window's
        least length (ENERGY_MIN_STEPS updates)."""
        if not self.counter:
            return {"source": "nvmlDeviceGetPowerUsage integrated "
                              "(energy counter NOT_SUPPORTED)",
                    "period_s": POWER_SAMPLE_S}
        last, t_last = self.energy_mj(), None
        incs, periods = [], []
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            v = self.energy_mj()
            if v != last:
                t = time.perf_counter()
                incs.append(v - last)
                if t_last is not None:
                    periods.append(t - t_last)
                last, t_last = v, t
            time.sleep(0.0002)
        if len(periods) < 2:
            fail(f"NVML energy counter updated {len(incs)} times in "
                 f"{seconds} s")
        self.period_s = statistics.median(periods)
        return {"source": "nvmlDeviceGetTotalEnergyConsumption",
                "increments_mj": sorted(set(incs)), "updates": len(incs),
                "period_s": self.period_s,
                "period_s_min_max": [min(periods), max(periods)]}

    def window(self, fn, min_s):
        """Call ``fn()`` until at least ``min_s`` seconds and
        ENERGY_MIN_STEPS counter updates have passed; returns (seconds,
        joules, calls)."""
        import threading
        need = max(min_s, ENERGY_MIN_STEPS * self.period_s)
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                samples.append((time.perf_counter(), self.power_w()))
                time.sleep(POWER_SAMPLE_S)
        if self.counter:
            e0 = self.energy_mj()
        else:
            th = threading.Thread(target=sample, daemon=True)
            th.start()
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < need:
            fn()
            n += 1
        secs = time.perf_counter() - t0
        if self.counter:
            joules = (self.energy_mj() - e0) / 1e3
        else:
            stop.set()
            th.join()
            joules = sum((b[0] - a[0]) * (a[1] + b[1]) / 2
                         for a, b in zip(samples, samples[1:]))
        if joules <= 0:
            fail(f"NVML: {joules} J over a {secs:.3f} s window")
        return secs, joules, n

    def shutdown(self):
        self.lib.nvmlShutdown()


class BrickEvents:
    """CUDA events around each brick's calls during a serve (attached by
    ``serve_path``): the plan's staging steps (on the staging threads'
    default stream), the engine's prefill and decode calls.  Each call's
    span runs from an event recorded before it to one recorded after it
    on the same stream, so it is the card's time to the call's last
    kernel, where the probe's staging spans end at the dispatch and its
    decode spans take in a bucket's graph capture on the host."""

    def __init__(self):
        self.spans, self._undo = [], []

    def _wrap(self, fn, brick, phase):
        import torch

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.spans.append((brick, phase, start, end))
            return out
        return timed

    def attach(self, eng):
        for step in eng.plan.steps[:eng.plan._tabm_producer + 1]:
            self._undo.append((step, "fn", step.fn))
            step.fn = self._wrap(step.fn, step.brick.name, "stage")
        for name, phase in (("_prefill", "prefill"), ("_decode", "decode")):
            self._undo.append((eng, name, getattr(eng, name)))
            setattr(eng, name, self._wrap(getattr(eng, name), "decoder",
                                          phase))

    def detach(self):
        for obj, name, fn in reversed(self._undo):
            setattr(obj, name, fn)
        self._undo = []

    def seconds(self):
        """{(brick, phase): (event seconds summed, calls)}."""
        import torch
        torch.cuda.synchronize()
        out = {}
        for brick, phase, a, b in self.spans:
            s, n = out.get((brick, phase), (0.0, 0))
            out[(brick, phase)] = (s + a.elapsed_time(b) / 1e3, n + 1)
        return out


def energy_windows(sm, nv, eng, group, dstate):
    """Phase 3e's NVML windows on phase 3's engine, after its serve: the
    counter's update step (polled ~1 s), then an idle window (sleeps), a
    decode window (replays of the bucket-4 cohort graph on a copy of the
    timed cohort state ``dstate``, a synchronize after each, as the serve
    reads each step's tokens) and a prefill window (repeats of the largest
    prefill call ``group``).  Joules per token gross and net of the idle
    watts; tokens are the live rows of each replayed step and the prompt
    tokens of each prefill call."""
    torch = sm.torch
    step = nv.counter_step()
    torch.cuda.synchronize()
    idle = nv.window(lambda: time.sleep(0.02), ENERGY_WINDOW_S["idle"])
    idle_w = idle[1] / idle[0]
    for pos, saved in zip(eng.slots.pool, dstate["pool"]):
        for leaf, t in zip(pos, saved):
            leaf.copy_(t)
    args = dstate["host_args"]

    def decode():
        eng._decode(*args)
        torch.cuda.synchronize()
    tokens, vision, last_idx = group[:3]

    def prefill():
        with torch.no_grad():
            eng._prefill(tokens, vision, last_idx)
        torch.cuda.synchronize()
    out = {"card": card_label(), "nvml_name": nv.name,
           "nvml_power_limit_w": nv.power_limit_w,
           "handle_picked_by": nv.picked_by, "counter": step,
           "min_steps": ENERGY_MIN_STEPS,
           "idle": {"seconds": idle[0], "joules": idle[1], "mean_w": idle_w}}
    for name, fn, per_call in (
            ("decode", decode, int(dstate["rows"])),
            ("prefill", prefill, int(last_idx.sum()))):
        fn()
        secs, joules, calls = nv.window(fn, ENERGY_WINDOW_S[name])
        tok = calls * per_call
        out[name] = {
            "seconds": secs, "joules": joules, "calls": calls,
            "tokens": tok, "tokens_per_call": per_call,
            "mean_w": joules / secs, "tokens_per_s": tok / secs,
            "j_per_token": joules / tok,
            "j_per_token_net_of_idle": (joules - idle_w * secs) / tok,
            "counter_steps": secs / step["period_s"]}
    for name in ("idle", "decode", "prefill"):
        w = out[name]
        if w["seconds"] < ENERGY_MIN_STEPS * step["period_s"]:
            fail(f"energy window {name}: {w['seconds']} s is under "
                 f"{ENERGY_MIN_STEPS} counter steps of {step['period_s']} s")
    out["decode"]["bc"] = int(args[0].shape[0])
    out["prefill"]["shape"] = list(tokens.shape)
    return out


def served_calibration(sm, cfg, eng, events, n_tok, capture_s):
    """Phase 3's measured ledger and calibration table beside each brick's
    CUDA-event time over the same calls (one event pair a probe sample),
    and the placement the table gives (``schedule(..., calibration=)``)
    beside the modeled one, at ``n_tok`` tokens on ``edge_accelerators()``
    priced on the served tree's brick bytes.  The engine's default plan
    has no accelerators, so every key is (brick, None): the table prices
    every unit alike.  ``capture_s``: the serve's graph capture seconds,
    inside its first decode span on the host (and, as the card's idle
    time, inside that call's event pair too)."""
    from repro_torch.core.bricks import decompose
    from repro_torch.core.scheduler import (edge_accelerators,
                                            populate_brick_bytes, schedule)
    led = eng.measured_ledger()
    table = eng.measured_calibration()
    ev = events.seconds()
    rows = []
    for brick, phase, rec in led.items():
        e_s, e_n = ev.get((brick, phase), (0.0, 0))
        if e_n != rec.samples or e_s <= 0:
            fail(f"calibration: {brick}/{phase} has {rec.samples} probe "
                 f"samples and {e_n} event pairs ({e_s} s)")
        rows.append({"brick": brick, "phase": phase,
                     "probe_seconds": rec.seconds, "tokens": rec.tokens,
                     "n": rec.samples, "event_seconds": e_s,
                     "probe_over_event": rec.seconds / e_s})
    graph = decompose(cfg)
    populate_brick_bytes(graph, eng.params)
    acc = edge_accelerators()
    placements = {}
    for name, cal in (("modeled", None), ("calibrated", table)):
        for obj in ("latency", "energy"):
            p = schedule(graph, acc, n_tok, obj, calibration=cal)
            placements[f"{name}/{obj}"] = {
                "placement": str(p), "assignment": p.assignment,
                "per_brick_ms": {b: c.latency_s * 1e3
                                 for b, c in p.per_brick.items()}}
    dec = next(r for r in rows if (r["brick"], r["phase"])
               == ("decoder", "decode"))
    return {"ledger_rows": rows, "decode_capture_s": capture_s,
            "decode_probe_less_capture_over_event_less_capture": (
                (dec["probe_seconds"] - capture_s)
                / (dec["event_seconds"] - capture_s)),
            "table": [{"key": k, **v} for k, v in
                      table.to_dict()["table"].items()],
            "prior": table.prior, "n_tokens": n_tok,
            "placements": placements}


def pressure_engine(sm, cfg, reqs, windows):
    """Phase 3's requests through an engine with phase 3d's placement (the
    decoder on ``gpu``, the ``rk-gpu`` profile) and a table holding the
    decode window's seconds, tokens and joules: its KV energy pressure
    (the card's J/token over the modeled one), ``kv_block_budgets`` with
    and without it, and the requests admitted and held under a step cap
    (a hi-res budget below one request's blocks holds it: the reference's
    semantics).  Gates: the pressure equals the table's J/token over the
    modeled decoder step's, recomputed; every admission round's budgets
    equal ``kv_block_budgets`` recomputed on its arguments; the thumbnail
    class keeps its share of the pool.  Returns (record, launches)."""
    from repro_torch.core.bricks import decompose
    from repro_torch.core.quantize import PROFILES, QTensor, quantize_tree
    from repro_torch.core.scheduler import (brick_cost, edge_accelerators,
                                            kv_block_budgets,
                                            populate_brick_bytes, schedule)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import init_params
    from repro_torch.serving import engine as engine_mod
    from repro_torch.telemetry.calibration import CostCalibration
    from repro_torch.tree import tree_map
    torch = sm.torch
    dec = windows["decode"]
    table = CostCalibration()
    table.observe("decoder", None, seconds=dec["seconds"],
                  tokens=dec["tokens"], joules=dec["joules"],
                  n=dec["calls"])
    with torch.no_grad():
        params = quantize_tree(init_params(cfg, device=sm.dev, seed=0),
                               PROFILES["nanomind-serve"])
    host = tree_map(lambda l: l.to("cpu") if isinstance(
        l, (torch.Tensor, QTensor)) else l, params)
    del params
    graph = decompose(cfg)
    populate_brick_bytes(graph, host)
    acc = edge_accelerators()
    pl = schedule(graph, acc, int(reqs[0].tokens.shape[0]))
    if pl.assignment["decoder"] != "gpu":
        fail(f"{ENERGY_PATH}: the placement puts the decoder on "
             f"{pl.assignment['decoder']}")
    eng = engine_mod.ServingEngine(
        cfg, host, n_slots=N_SLOTS, max_len=MAX_LEN[cfg.name],
        block_size=BLOCK_SIZE, placement=pl, accels=acc, calibration=table,
        device=sm.dev)
    del host
    step = next(s for s in eng.plan.steps if s.brick.kind == "decoder")
    modeled = brick_cost(step.brick, step.accel, 1).energy_j
    press = eng._kv_energy_pressure()
    want = table.sample("decoder", step.accel.profile.name) \
        .joules_per_token / modeled
    if press != want:
        fail(f"{ENERGY_PATH}: pressure {press}, recomputed {want}")
    total = eng.slots.n_blocks
    classes = list(eng.tabm.classes)
    thumb = classes[0]
    calm = kv_block_budgets(eng.tabm, total, {}, 1.0)
    hot = kv_block_budgets(eng.tabm, total, {}, 1.0, energy_pressure=press)
    rounds = []

    def recording(pool, total_blocks, used, kv_scale=1.0,
                  energy_pressure=1.0):
        out = kv_block_budgets(pool, total_blocks, used, kv_scale,
                               energy_pressure=energy_pressure)
        rounds.append((dict(used), kv_scale, energy_pressure, dict(out),
                       kv_block_budgets(pool, total_blocks, dict(used),
                                        kv_scale,
                                        energy_pressure=energy_pressure),
                       kv_block_budgets(pool, total_blocks, dict(used),
                                        kv_scale)))
        return out
    for r in reqs:
        eng.submit(r)
    need = {r.rid: -(-(len(r.tokens) + r.max_new_tokens) // BLOCK_SIZE)
            for r in reqs}
    reset_launch_counts()
    t0 = time.perf_counter()
    with swapped(engine_mod, "kv_block_budgets", recording), eng:
        eng.run(max_steps=PRESSURE_STEPS)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        finished = sorted(r.rid for r in eng.done)
        live = sorted(r.rid for r in eng.live.values())
        held = sorted(r.rid for r in eng.queue)
    counts = launch_counts()
    bad = [(i, u, p) for i, (u, _, p, got, again, _) in enumerate(rounds)
           if p != press or got != again]
    thumb_bad = [(i, got[thumb], base[thumb]) for i, (_, _, _, got, _, base)
                 in enumerate(rounds) if got[thumb] != base[thumb]]
    if not rounds or bad or thumb_bad or hot[thumb] != calm[thumb] \
            or hot[thumb] != total:
        fail(f"{ENERGY_PATH}: {len(rounds)} admission rounds; pressure or "
             f"recomputed budgets differ at {bad[:3]}; thumbnail budgets "
             f"{thumb_bad[:3]}; without/with pressure {calm} / {hot}")
    spans = eng.probe.samples()
    n_pre = sum(1 for s in spans if s.brick == "decoder"
                and s.phase == "prefill")
    steps = sum(1 for e in eng.trace if e.event == "decode_step")
    L = cfg.n_layers
    gemms = stack_gemms(cfg)
    want_n = {k: 0 for k in counts}
    want_n.update({"dequant_gemm": gemms * n_pre,
                   f"dequant_gemm/{GEMM_ROUTE[cfg.dtype]}": gemms * n_pre,
                   "fused_qkv": L * steps, f"fused_qkv/{MLP_ROUTE}":
                   L * steps, "fused_mlp": L * steps,
                   f"fused_mlp/{MLP_ROUTE}": L * steps,
                   "kv_scatter": steps})
    if counts != want_n or not n_pre or not steps:
        fail(f"{ENERGY_PATH}: launches {counts} (want {want_n}) for "
             f"{n_pre} prefill calls and {steps} decode steps")
    rec = {"path": ENERGY_PATH, "placement": str(pl),
           "decoder_accel": step.accel.name,
           "decoder_profile": step.accel.profile.name,
           "table": table.to_dict()["table"],
           "measured_j_per_token": table.sample("decoder").joules_per_token,
           "modeled_j_per_token": modeled, "energy_pressure": press,
           "classes": classes, "total_blocks": total,
           "budgets_without_pressure": calm, "budgets_with_pressure": hot,
           "blocks_needed": need,
           "slot_class": {r.rid: r.slot_class for r in reqs},
           "step_cap": PRESSURE_STEPS, "serve_s": serve_s,
           "admission_rounds": len(rounds),
           "last_round": {"used": {str(k): v for k, v in rounds[-1][0]
                                   .items()}, "budgets": rounds[-1][3]},
           "finished": finished, "live_at_cap": live, "held": held,
           "prefill_calls": n_pre, "decode_steps": steps,
           "launches": {k: n for k, n in counts.items() if n}}
    del eng
    free()
    return rec, counts


def calibration_launcher():
    """``repro_torch.launch.serve --full --quantize nanomind-serve
    --calibration PATH`` twice, two requests of four new tokens: the
    second run loads the first's table, and the saved decoder row's count
    grows by the second run's own samples."""
    os.makedirs(ENERGY_DIR, exist_ok=True)
    path = os.path.join(ENERGY_DIR, "calibration.json")
    if os.path.exists(path):
        os.remove(path)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           *CALIBRATION_SERVE_ARGS, "--calibration", path]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, env=env, cwd=ROOT)
        lines = proc.stdout.splitlines()
        mark = "  calibration: this run measured "
        measured = [json.loads(ln[len(mark):]) for ln in lines
                    if ln.startswith(mark)]
        if proc.returncode != 0 or len(measured) != 1:
            fail(f"serve --calibration exited {proc.returncode}: "
                 f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
        with open(path) as f:
            saved = json.load(f)["table"]
        runs.append({"wall_s": time.perf_counter() - t0, "lines": lines,
                     "measured_n": measured[0], "saved": saved})
    loaded = [[ln for ln in r["lines"] if ln.startswith(
        "[serve] loaded calibration from ")] for r in runs]
    n1, n2 = (r["saved"]["decoder@"]["n"] for r in runs)
    if loaded[0] or len(loaded[1]) != 1 or \
            n2 != n1 + runs[1]["measured_n"]["decoder@"] or n2 <= n1:
        fail(f"serve --calibration: loaded lines {loaded}; decoder n "
             f"{n1} then {n2}, the second run measured "
             f"{runs[1]['measured_n']}")
    return {"cmd": " ".join(cmd[1:]), "runs": runs}


def start_fleet(windows, ledger3):
    """The fleet simulator twice, as subprocesses (host arithmetic only):
    ``--smoke`` (the modeled edge profile on a 150 mAh pack, with its
    acceptance checks), and ``--profile ledger`` on a ledger of phase 3's
    probe stage rows and decoder prefill and decode rows holding the NVML
    windows' seconds, tokens and joules: the H100's J/token as survival
    on a 2000 mAh pack.  Returns the running processes."""
    from repro_torch.telemetry.ledger import Ledger
    os.makedirs(ENERGY_DIR, exist_ok=True)
    led = Ledger(meta={"source": "phase 3 probe stage rows; decoder rows "
                                 "from NVML windows on the H100",
                       "card": windows["card"]})
    for brick, phase, rec in ledger3.items():
        if phase == "stage":
            led.accumulate(brick, phase, rec)
    for phase in ("prefill", "decode"):
        w = windows[phase]
        led.accumulate("decoder", phase, seconds=w["seconds"],
                       tokens=float(w["tokens"]), joules=w["joules"],
                       samples=w["calls"])
    path = led.save(os.path.join(ENERGY_DIR, "h100_ledger.json"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.fleet_sim"]
    return {name: subprocess.Popen(base + extra, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True,
                                   env=env, cwd=ROOT)
            for name, extra in (
                ("modeled_smoke_150mAh", ["--smoke"]),
                ("h100_ledger_2000mAh", ["--profile", "ledger",
                                         "--ledger", path]))}


def finish_fleet(procs):
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        lines = stdout.splitlines()
        if proc.returncode != 0 or (name.startswith("modeled") and not (
                lines and lines[-1].startswith("OK: fleet smoke passed"))):
            fail(f"fleet_sim {name} exited {proc.returncode}: "
                 f"{stdout[-2000:]} {stderr[-2000:]}")
        out[name] = lines
    return out


def pruned_weights_check(sm, cfg, eng):
    """The decode and prefill kernels on every layer's pruned, packed
    weights against their plain versions on random activations: the
    served inputs cannot test them, since pruning zeroes every stacked
    norm scale (all ones: no element above its row's threshold), so
    every layer's input in the sparse serve is zero.  Each packed-weight
    GEMM at the served prefill width (1 x 1024) within DG_TOL of the
    largest plain value; the fused QKV and MLP at cohort 4, every row
    within KERNEL_TOL of its largest plain value."""
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels.dequant_gemm import ops as dg
    from repro_torch.kernels.fused_decode import ops, ref
    from repro_torch.models import decoder as dec
    torch = sm.torch
    D, F = cfg.d_model, cfg.d_ff
    H, hd = cfg.n_heads, cfg.hd
    x_d = sm.randn(1, DG_SERVED_ROWS[cfg.name], D)
    x_f = sm.randn(1, DG_SERVED_ROWS[cfg.name], F)
    x_o = sm.randn(1, DG_SERVED_ROWS[cfg.name], H, hd)
    h4 = sm.randn(TIME_BC, 1, D)
    gemm, qkv, mlp, zero_norms = 0.0, 0.0, 0.0, 0
    calls = 0
    with torch.no_grad():
        for i in range(cfg.n_layers):
            lay = dec.layer_slice(eng.params["layers"], i)[0]
            m, f = lay["mixer"], lay["ffn"]
            for name in ("norm1", "norm2"):
                sc = lay[name]["scale"]
                sc = sc if torch.is_tensor(sc) else dequantize(sc)
                zero_norms += int(bool((sc == 0).all()))
            for spec, x, w in (
                    ("bsd,dhk->bshk", x_d, m["wq"]),
                    ("bsd,dhk->bshk", x_d, m["wk"]),
                    ("bsd,dhk->bshk", x_d, m["wv"]),
                    ("bshk,hkd->bsd", x_o, m["wo"]),
                    ("bsd,df->bsf", x_d, f["w_up"]),
                    ("bsd,df->bsf", x_d, f["w_gate"]),
                    ("bsf,fd->bsd", x_f, f["w_down"])):
                _, rel, _ = gemm_error(f"{SPARSE_PATH}: layer {i} {spec}",
                                       dg.quant_einsum(spec, x, w),
                                       dg.ref_quant_einsum(spec, x, w))
                gemm, calls = max(gemm, rel), calls + 1
            bias = [b if b is None or torch.is_tensor(b) else dequantize(b)
                    for b in (m.get("bq"), m.get("bk"), m.get("bv"))]
            got = ops.fused_qkv(h4, m["wq"], m["wk"], m["wv"], *bias)
            want = ref.ref_fused_qkv(h4, m["wq"], m["wk"], m["wv"], *bias)
            qkv = max(qkv, *(rows_err(g.reshape(TIME_BC, -1),
                                      w.reshape(TIME_BC, -1))
                             for g, w in zip(got, want)))
            got = ops.fused_mlp(h4, f["w_up"], f["w_down"], f["w_gate"],
                                act=cfg.act)
            want = ref.ref_fused_mlp(h4, f["w_up"], f["w_down"], f["w_gate"],
                                     act=cfg.act)
            mlp = max(mlp, rows_err(got.reshape(TIME_BC, -1),
                                    want.reshape(TIME_BC, -1)))
    torch.cuda.synchronize()
    if qkv > KERNEL_TOL or mlp > KERNEL_TOL:
        fail(f"{SPARSE_PATH}: pruned weights, fused QKV worst row "
             f"{qkv}, fused MLP {mlp} (tol {KERNEL_TOL})")
    return {"layers": cfg.n_layers, "gemm_calls": calls,
            "gemm_worst_err_over_max": gemm, "gemm_tol": DG_TOL,
            "gemm_rows": DG_SERVED_ROWS[cfg.name],
            "qkv_worst_row_err_over_row_max": qkv,
            "mlp_worst_row_err_over_row_max": mlp, "row_tol": KERNEL_TOL,
            "bc": TIME_BC, "norm_scales_all_zero": zero_norms,
            "inputs": "random bf16 activations"}


def sparse_serve(sm, cfg, reqs, base):
    """Phase 3's requests under ``nanomind-sparse`` (50 % of every decoder
    row pruned on the card, then q4 g32) through ``serve_path``, with
    phase 3's gates; besides, every pruned row holds at least
    floor(0.5 N) zeros before quantization, and the first 4-d leaf
    (``wq``, past ``torch.quantile``'s 2**24 elements) pruned on the card
    is bit-equal to the same leaf pruned on the CPU."""
    from repro_torch.core import quantize as QM
    torch = sm.torch
    real = QM.prune_weights
    seen = {"leaves": 0, "rows": 0, "min_zero_share": 1.0}

    def checked(w, sparsity, act=None):
        out = real(w, sparsity, act)
        n = w.shape[-1]
        zeros = (out == 0).reshape(-1, n).sum(-1)
        zmin = int(zeros.min())
        if zmin < int(sparsity * n):
            fail(f"{SPARSE_PATH}: a pruned row of {tuple(w.shape)} holds "
                 f"{zmin} zeros, under {int(sparsity * n)}")
        seen["leaves"] += 1
        seen["rows"] += int(zeros.numel())
        seen["min_zero_share"] = min(seen["min_zero_share"], zmin / n)
        if "leaf" not in seen and w.dim() == 4:
            seen.update(leaf=w.cpu(), card=out.cpu())
        return out
    with swapped(QM, "prune_weights", checked):
        serve, eng, _ = serve_path(sm, cfg, reqs, policy="nanomind-sparse")
    serve["pruned_weights_check"] = pruned_weights_check(sm, cfg, eng)
    del eng
    free()
    t0 = time.perf_counter()
    on_cpu = real(seen["leaf"], 0.5)
    same = bool(torch.equal(on_cpu.view(torch.int16),
                            seen["card"].view(torch.int16)))
    if not same or seen["leaves"] < 7:
        fail(f"{SPARSE_PATH}: {seen['leaves']} leaves pruned; the card's "
             f"prune of {tuple(seen['leaf'].shape)} bit-equal to the "
             f"CPU's: {same}")
    serve["path"] = SPARSE_PATH
    serve["prune_check"] = {
        "leaves": seen["leaves"], "rows": seen["rows"],
        "min_zero_share": seen["min_zero_share"],
        "cpu_equal_leaf_shape": list(seen["leaf"].shape),
        "cpu_equal_leaf_elements": seen["leaf"].numel(),
        "card_bit_equal_cpu": same,
        "cpu_prune_s": time.perf_counter() - t0}
    serve["nanomind_serve"] = {k: base[k] for k in (
        "decode_tok_s", "decode_tok_s_excl_capture", "prefill_ms")}
    return serve


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
    call through the plain projection route (``ref_quant_einsum``:
    ``dequantize`` + einsum per projection, the route before the
    packed-weight GEMM kernel), run in turn with it in this call of the
    script."""
    import torch
    from repro_torch.kernels.dequant_gemm import ops as dg_ops
    tokens, vision, last_idx = group[:3]

    def call():
        with torch.no_grad():
            eng._prefill(tokens, vision, last_idx)
        torch.cuda.synchronize()

    out = {"batch": int(tokens.shape[0]), "width": int(tokens.shape[1])}
    out.update(call_breakdown(call, names))
    with swapped(dg_ops, "quant_einsum", dg_ops.ref_quant_einsum):
        out["plain_projection_route"] = call_breakdown(call, names)
    return out


def call_breakdown(call, names, n_wall=3):
    """Where one synchronised ``call``'s time goes: its wall time (host
    clock, median of ``n_wall``) against the card's kernel time (the
    profiler), the busy share, the device time of the kernels whose names
    hold each of ``names`` and the largest kernels."""
    walls = []
    for _ in range(n_wall):
        t0 = time.perf_counter()
        call()
        walls.append(time.perf_counter() - t0)
    kernel_us, by_name, n = device_time(call)
    wall_ms = statistics.median(walls) * 1e3
    return {"wall_ms": wall_ms, "device_ms": kernel_us / 1e3,
            "device_busy_share": kernel_us / 1e3 / wall_ms,
            "device_kernels": n,
            "kernels_ms_by_name": {
                nm: sum(us for k, us, _ in by_name if nm in k) / 1e3
                for nm in names},
            "top_kernels_ms": [[k[:96], us / 1e3]
                               for k, us, _ in by_name[:10]]}


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
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
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
    groups, calls = [], []
    prefill = eng._prefill
    steps = DecodeSteps(eng, keep_steps=True)
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

    def recording_kernel(*args, **kwargs):
        out = kernel(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    eng._prefill = recording_prefill
    setattr(op_module, op_name, recording_kernel)
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with GemmCalls() as gemms, steps, eng:
            done = eng.run()
        torch.cuda.synchronize()
    finally:
        setattr(op_module, op_name, kernel)
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    eng._prefill = prefill
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
    per_call = stack_gemms(cfg)
    if not (launches[op_name] == launches[op_route]
            == cfg.n_layers * len(groups) == len(calls)
            and launches["dequant_gemm"] == launches[gemm_route]
            == per_call * len(groups)
            and groups and decode_steps > 0 and others == 0
            and len(steps.launches) == decode_steps
            and not any(steps.launches)):
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
             **decode_rates(eng, decs),
             "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                  3),
             "state_pool_mb": round(eng.slots.nbytes / 1e6, 3),
             "launches": launches,
             "cohort_graph": graph_check(cfg, eng, decode_steps),
             "gemm_served_check": dict(served_gemm_check(
                 cfg, gemms.calls, per_call),
                 prefill_batch=int(groups[0][0].shape[0]),
                 prefill_width=int(groups[0][0].shape[1]))}
    del gemms
    if eng.tabm is not None:
        serve["tabm"] = eng.tabm.stats
    if steps.state is None:
        fail(f"{cfg.name}: no multi-row cohort state was captured")
    serve["served_vs_eager"] = served_vs_eager(sm, cfg, eng, steps.state,
                                               False)[0]
    steps.state = None
    return serve, eng, (reqs, groups, steps.steps, calls)


def serve_mamba(sm, cfg):
    """Serve Mamba-2-1.3B's four text requests at full width with ``cfg``'s
    dtype, and hold every SSD kernel call of the serve (each layer of each
    prefill group, at the served shapes and dtype) against the plain
    ``ssd_chunked`` on the same inputs.  Returns ``serve_composed``'s
    (serve record, engine, run)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    reqs = text_requests(cfg, MAMBA_PROMPTS, 16, seed=2)
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
def plain_sums():
    """cuBLAS's bf16 GEMMs inside the block add their split-K partial sums
    in fp32, as the kernels do: by default cuBLAS may add them in bf16
    (at K = 24576 and few rows, Jamba's down projections), a rounding step
    the plain version of a kernel must not add.  The plain versions that
    a kernel is held against run inside it; the port's own paths, and the
    library calls timed beside the kernels, run outside it, with
    PyTorch's default."""
    import torch
    mm = torch.backends.cuda.matmul
    was = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction = was


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


def composed_decode_breakdown(eng):
    """Where one composed cohort-4 decode step's time goes, on the served
    slot pool after the serve and its checks (each slot holds its
    request's final state; the timed steps write into it):
    ``decode_breakdown`` of every slot decoding token 5 at length 1100.
    The slot-state step launches none of STEP_KERNELS."""
    import numpy as np
    n = eng.slots.n_slots
    host = [np.full((n, 1), 5, np.int32), np.full(n, 1100, np.int32),
            np.arange(n, dtype=np.int32),
            np.zeros((n, eng.slots.blocks_per_slot), np.int32)]
    return decode_breakdown(eng, host, n, {})


def linear_attention_f64(q, k, v, valid_len=None):
    """Causal linear attention evaluated in float64 throughout by its
    quadratic form, k/v expanded to q's heads, phi in float64; rows at or
    past ``valid_len`` drop out (the yardstick of the fp32 kernel's
    accuracy)."""
    import torch
    B, S, H, hd = q.shape
    G = H // k.shape[2]

    def phi(t):
        t = t.double()
        return torch.where(t > 0, t + 1.0, torch.exp(t))
    qf = phi(q)
    kf = phi(k).repeat_interleave(G, 2)
    vf = v.double().repeat_interleave(G, 2)
    if valid_len is not None:
        keep = (torch.arange(S, device=q.device)[None]
                < valid_len.to(q.device)[:, None])[..., None, None]
        qf, kf, vf = qf * keep, kf * keep, vf * keep
    s = torch.einsum("bihd,bjhd->bhij", qf, kf).tril()
    den = s.sum(-1).clamp_min(1e-6).transpose(1, 2)[..., None]
    return torch.einsum("bhij,bjhd->bihd", s, vf) / den


def rows_err(got, want):
    """The worst row (b, i, h): max |err| over that row's largest |want|
    (rows of zeros must be matched exactly)."""
    import torch
    err = (got.double() - want.double()).abs().amax(-1)
    m = want.double().abs().amax(-1)
    ratio = torch.where(m > 0, err / m.clamp_min(1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return ratio.max().item()


def linear_errors(args, out, chunk, valid_len, what):
    """The linear-attention kernel's (out, state, z) ``out`` on ``args``
    (q, k, v) against the plain chunked form: fails unless all are
    finite and of the plain shapes, state and z within LA_STATE_TOL of
    their largest magnitude, every output row (b, i, h) within
    LA_ROW_TOL of that row's largest plain magnitude, and every row at
    or past ``valid_len`` exactly zero.  fp32 inputs: the kernel's and the
    plain form's rows also against ``linear_attention_f64`` (reported;
    the callers gate the ratio).  Returns the errors."""
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
    row = rows_err(o, ro)
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
    rec = {"state_rel_err": s_rel, "z_rel_err": z_rel,
           "worst_row_err_over_max": row,
           "out_max_abs_err": err.max().item(),
           "padded_rows_exactly_zero": pad_rows}
    if o.dtype == torch.float32:
        f64 = linear_attention_f64(*args, valid_len)
        rec["vs_float64_row_err"] = rows_err(o, f64)
        rec["plain_vs_float64_row_err"] = rows_err(ro, f64)
        del f64
    return rec


def f64_ratio_check(rec, what):
    """Fails unless the kernel's worst row against float64 is within
    F64_RATIO times the plain version's (``linear_errors``' fp32 keys)."""
    if rec["vs_float64_row_err"] > F64_RATIO * rec["plain_vs_float64_row_err"]:
        fail(f"{what}: kernel vs float64 {rec['vs_float64_row_err']}, plain "
             f"{rec['plain_vs_float64_row_err']} (at most {F64_RATIO}x)")


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
    if cfg.dtype == "float32":
        f64_ratio_check(worst, f"{cfg.name}: served fp32 linear attention")
    serve["linear_served_check"] = dict(
        worst, calls=len(run[3]), shapes_B_S_chunk_dtype=sorted(shapes),
        tol={"state_z": LA_STATE_TOL, "row": LA_ROW_TOL,
             "vs_float64": f"{F64_RATIO}x plain"})
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


def linear_attention_route_flops(B, S, H, KV, hd, chunk, v_terms, tile=64):
    """The tensor-core operations of the kernel's split-TF32 route, on the
    products of ``linear_attention_tile_ops``: three TF32 products for each
    of phi(q).S_before and phi(q).phi(k)^T, ``v_terms`` for each product
    against v (s.v and the tile states' phi(k)^T v: two when v is bf16,
    exact in TF32, three in fp32).  The FFMA rest (phi, the scan, the
    denominator, the division) is left out: under 3 % of the work."""
    L = min(chunk, S)
    rows = [min(tile, L - i) for i in range(0, L, tile)] * (S // L)
    pairs = sum(r * (r + 1) // 2 for r in rows)
    return (3 * (B * H * pairs * 2 * hd + B * H * (S - rows[0]) * 2 * hd * hd)
            + v_terms * (B * H * pairs * 2 * hd + B * KV * S * 2 * hd * hd))


LA_PHASES = ("la_state", "la_scan", "la_out")


def time_linear(sm, dtype=None):
    """The linear-attention kernel and its plain version at LA_SHAPE
    (bf16, the served dtype, or ``dtype``), the work
    (``linear_attention_work``) that sets its bound, and the device ms of
    each of its three device kernels (profiler rows by kernel name, per
    call)."""
    import torch
    from repro_torch.kernels.linear_attention import (
        linear_attention, ref_linear_attention_chunked)
    dtype = dtype or torch.bfloat16
    B, S, H, KV, hd, chunk = LA_SHAPE
    args = sm.la_inputs(B, S, H, KV, hd, dtype)
    iters = 50
    with torch.no_grad():
        t_k = timed(lambda i: linear_attention(*args, chunk=chunk), 1,
                    iters=iters)
        t_p = timed(lambda i: ref_linear_attention_chunked(
            *args, chunk=chunk), 1, iters=10)

        def loop():
            for _ in range(iters):
                linear_attention(*args, chunk=chunk)
            torch.cuda.synchronize()
        _, rows, _ = device_time(loop)
    phases = {ph: sum(us for k, us, _ in rows if ph in k) / iters / 1e3
              for ph in LA_PHASES}
    esize = 4 if dtype == torch.float32 else 2
    return ((t_k, t_p) + linear_attention_work(*LA_SHAPE, esize=esize)
            + (phases,))


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


def time_ssd(sm, dtype=None, shape=None):
    """The SSD kernel and its plain version at ``shape`` (SSD_SHAPE by
    default; bf16 inputs, the served route, or ``dtype``), the work
    (``ssd_work``) that sets its bound, and the device ms of each of its
    four phases (profiler rows by kernel name, per call)."""
    import torch
    from repro_torch.kernels.ssd import ref_ssd_chunked, ssd
    shape = shape or SSD_SHAPE
    B, S, H, P, G, N, chunk = shape
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
    return (t_k, t_p) + ssd_work(*shape) + (phases,)


# -- phase 8: mixture of experts, the dense configs ---------------------------

def bf16_step(m):
    """One bf16 rounding step (a unit in the last place) at magnitude
    ``m``."""
    import math
    return 2.0 ** (math.floor(math.log2(m)) - 7)


def gemm_f64_errors(spec, x, w, got, want):
    """The packed-weight GEMM's output ``got`` and its plain version's
    ``want`` against a float64 evaluation of the same product: (kernel,
    plain) max |err| over max |float64|, an expert at a time for an
    expert contraction (Jamba's leaf would be 26 GB in float64)."""
    import torch
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels.dequant_gemm.ref import EXPERT_SPECS
    if spec in EXPERT_SPECS:
        parts = [(x[:, e:e + 1], w.layer(e), got[:, e:e + 1],
                  want[:, e:e + 1]) for e in range(w.shape[0])]
    else:
        parts = [(x, w, got, want)]
    k_err = p_err = m = 0.0
    for xe, we, ge, pe in parts:
        dense = dequantize(we).double()
        if spec in EXPERT_SPECS:
            dense = dense[None]
        exact = torch.einsum(spec, xe.double(), dense)
        m = max(m, exact.abs().max().item())
        k_err = max(k_err, (ge.double() - exact).abs().max().item())
        p_err = max(p_err, (pe.double() - exact).abs().max().item())
        del dense, exact
    return k_err / m, p_err / m


def sublayers(cfg):
    """(mixer, ffn) of every sublayer of ``cfg``'s stack, group by group:
    mixer "attn", "linear" or "mamba", ffn "mlp", "moe" or "none"."""
    from repro_torch.models import decoder as dec
    return [(dec.mixer_of(cfg, pos), dec.sublayer_spec(cfg, pos)[1])
            for _ in range(dec.n_groups(cfg))
            for pos in range(dec.group_size(cfg))]


def stack_gemms(cfg):
    """Packed GEMM launches of one prefill call over the whole stack:
    Mamba-2's in_proj and out_proj, attention's q, k, v, o, a dense FFN's
    up, gate (gated only) and down, an MoE's experts' three (each one
    launch over every expert) and its shared FFN's three."""
    n = 0
    for mixer, ffn in sublayers(cfg):
        n += 2 if mixer == "mamba" else 4
        if ffn == "moe":
            n += 3 + (3 if cfg.moe.n_shared else 0)
        elif ffn == "mlp":
            n += 3 if cfg.act in ("swiglu", "geglu") else 2
    return n


class HeldGemms:
    """Every packed-weight GEMM call made inside the ``with`` block held,
    as it is made, against its plain version on its own inputs
    (``gemm_error``'s gate; the plain version counts no launch): calls by
    contraction, the worst error, the (einsum, x, weight) shapes."""

    def __init__(self, sm):
        from repro_torch.core.quantize import QTensor
        from repro_torch.kernels.dequant_gemm import ops
        self.sm, self.ops, self.inner, self.packed = (sm, ops,
                                                      ops.quant_einsum,
                                                      QTensor)
        self.by_spec, self.worst, self.err, self.shapes = {}, 0.0, 0.0, set()
        self.apart_calls = []

    def __call__(self, spec, x, w):
        out = self.inner(spec, x, w)
        if isinstance(w, self.packed):
            with plain_sums():
                want = self.ops.ref_quant_einsum(spec, x, w)
            what = f"served {spec} at {tuple(x.shape)}"
            rel, err = self.apart(what, spec, x, w, out, want)
            if rel is None:
                _, rel, err = gemm_error(what, out, want)
            del want
            self.worst, self.err = max(self.worst, rel), max(self.err, err)
            self.by_spec[spec] = self.by_spec.get(spec, 0) + 1
            self.shapes.add((spec, tuple(x.shape), tuple(w.shape)))
            self.sm.errs["dequant_gemm"] = max(
                self.sm.errs["dequant_gemm"], err)
        return out

    def apart(self, what, spec, x, w, out, want):
        """A bf16 call whose output is one rounding step from the plain
        version's at its largest magnitude, beyond DG_TOL: the two sum
        their fp32 products in other orders (cuBLAS splits K = 24576 at
        128 rows, the kernel does not; ``scripts/long_k_gemm_plain.py``).
        Held instead against a float64 evaluation, as the fp32 calls
        are: the kernel's error no more than F64_RATIO times the plain
        version's.  Returns (err over max, max abs err), or (None, None)
        where DG_TOL decides."""
        if out.dtype != self.sm.torch.bfloat16 or out.shape != want.shape:
            return None, None
        err = (out.float() - want.float()).abs().max().item()
        m = want.float().abs().max().item()
        if err <= DG_TOL["bfloat16"] * m or not (0 < err <= bf16_step(m)):
            return None, None
        k_err, p_err = gemm_f64_errors(spec, x, w, out, want)
        if not (out.isfinite().all() and k_err <= F64_RATIO * p_err):
            fail(f"dequant_gemm {what}: one rounding step ({err} of max "
                 f"{m}) from the plain version, and against float64 "
                 f"{k_err}, plain {p_err}")
        self.apart_calls.append({"call": what, "err_over_max": err / m,
                                 "vs_float64_err_over_max": {
                                     "kernel": k_err, "plain": p_err}})
        return err / m, err

    def record(self):
        return {"calls": sum(self.by_spec.values()),
                "calls_by_spec": self.by_spec,
                "worst_err_over_max": self.worst, "max_abs_err": self.err,
                "tol": DG_TOL, "shapes_spec_x_w": sorted(self.shapes),
                "held_against_float64": self.apart_calls,
                "float64_rule": ("a bf16 call one rounding step from the "
                                 "plain version at its largest magnitude, "
                                 f"beyond DG_TOL: kernel vs float64 at most "
                                 f"{F64_RATIO} x plain vs float64")}

    def __enter__(self):
        self.ops.quant_einsum = self
        return self

    def __exit__(self, *exc):
        self.ops.quant_einsum = self.inner


class KvScatterCalls:
    """Holds every ``fused_decode.ops.kv_scatter`` call made while
    ``armed`` against the plain version on copies of the pools taken just
    before the call: bit for bit, in place."""

    def __init__(self):
        from repro_torch.kernels.fused_decode import ops, ref
        self.ops, self.inner, self.ref = ops, ops.kv_scatter, \
            ref.ref_kv_scatter
        self.armed, self.calls = False, 0

    def __call__(self, blk, off, k_rows, v_rows, k_pool, v_pool):
        import torch
        if not self.armed:
            return self.inner(blk, off, k_rows, v_rows, k_pool, v_pool)
        kb, vb = k_pool.clone(), v_pool.clone()
        out = self.inner(blk, off, k_rows, v_rows, k_pool, v_pool)
        want = self.ref(blk, off, k_rows, v_rows, kb, vb)
        if not (out[0] is k_pool and out[1] is v_pool
                and torch.equal(out[0], want[0])
                and torch.equal(out[1], want[1])):
            fail(f"served kv_scatter at {tuple(k_pool.shape)} differs from "
                 f"the plain version")
        self.calls += 1
        return out

    def __enter__(self):
        self.ops.kv_scatter = self
        return self

    def __exit__(self, *exc):
        self.ops.kv_scatter = self.inner


class RouteLog:
    """The MoE's routing decisions while ``run`` is active: for every
    ``models.moe.choices`` call (one a layer), the experts the router
    chose (``chosen``), the experts the call used (``idx``) and the
    choices it kept (``keep``), each (tokens, k) in the flattened,
    group-padded order (``moe_token_rows``).  ``run(force=)`` makes each
    call use the experts given for it (one (tokens, k) tensor a call),
    with gates from its own probabilities, so that two runs whose
    rounding differs take the same experts and their logits can be held
    against each other; what the router chose is still logged."""

    def __init__(self):
        from repro_torch.models import moe
        self.mod, self.inner, self.inner_top = moe, moe.choices, \
            moe.top_choices
        self.armed, self.force, self.calls, self.chosen = False, None, [], \
            None

    def top_choices(self, logits, top_k):
        import torch
        probs, gates, idx = self.inner_top(logits, top_k)
        self.chosen = idx
        if self.force is not None:
            idx = self.force[len(self.calls)].to(idx.device).reshape(
                idx.shape)
            g = probs.gather(-1, idx)
            gates = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
        return probs, gates, idx

    def __call__(self, logits, top_k, cap, mask=None):
        out = self.inner(logits, top_k, cap, mask)
        if self.armed:
            self.calls.append({
                "chosen": self.chosen.reshape(-1, top_k).clone(),
                "idx": out[2].reshape(-1, top_k).clone(),
                "keep": out[3].reshape(-1, top_k).clone()})
        return out

    @contextlib.contextmanager
    def run(self, force=None):
        """Arm for the block (with ``force``, a list of one (tokens, k)
        expert tensor a call); yields the list the block's calls land
        in."""
        self.calls, self.armed, self.force = [], True, force
        calls = self.calls
        try:
            yield calls
        finally:
            self.armed, self.force = False, None

    def __enter__(self):
        self.mod.choices, self.mod.top_choices = self, self.top_choices
        return self

    def __exit__(self, *exc):
        self.mod.choices, self.mod.top_choices = self.inner, self.inner_top


def moe_token_rows(b, width, n):
    """Where row ``b``'s first ``n`` tokens lie in a masked MoE call of
    ``width`` tokens a row (``RouteLog``'s order: each row padded on its
    own to whole groups)."""
    import torch
    from repro_torch.models.moe import GROUP_SIZE
    padded = -(-width // GROUP_SIZE) * GROUP_SIZE
    return torch.arange(b * padded, b * padded + n)


def routing_diff(a, rows_a, b, rows_b):
    """Two runs' routing (``RouteLog`` calls, one a layer) at token rows
    ``rows_a`` / ``rows_b``: the flipped (token, choice) pairs (a choice
    the router of ``b`` made whose expert is not among the token's
    experts in ``a``: two experts trading ranks is no flip), the dropped
    choices of each run, and whether they agree: each token used the same
    experts and kept the same ones, so its output takes the same experts
    (its gates aside)."""
    import torch
    if len(a) != len(b) or not a:
        fail(f"routing logs of {len(a)} and {len(b)} layers")
    flips, drops, same = 0, [0, 0], True
    for ca, cb in zip(a, b):
        ra, rb = rows_a.to(ca["idx"].device), rows_b.to(cb["idx"].device)
        ia, ka = ca["idx"][ra], ca["keep"][ra]
        ib, kb, chosen = cb["idx"][rb], cb["keep"][rb], cb["chosen"][rb]
        flips += int((~(chosen[:, :, None] == ia[:, None, :]).any(-1)).sum())
        drops[0] += int((~ka).sum())
        drops[1] += int((~kb).sum())
        kept_a = torch.where(ka, ia, -1).sort(-1).values
        kept_b = torch.where(kb, ib, -1).sort(-1).values
        same = same and bool(torch.equal(kept_a, kept_b))
    return {"flipped": flips, "dropped": drops, "agree": same}


def prefill_drops(group):
    """A served prefill group's routing: its valid tokens' choices and
    how many of them were dropped past capacity, over all layers."""
    import torch
    tokens, last, _, routing = group
    B, S = tokens.shape
    rows = torch.cat([moe_token_rows(b, S, int(last[b])) for b in range(B)])
    n = int(rows.numel())
    dropped = sum(int((~c["keep"][rows.to(c["keep"].device)]).sum())
                  for c in routing)
    return {"batch": int(B), "width": int(S), "valid_tokens": n,
            "choices": n * routing[0]["keep"].shape[1] * len(routing),
            "dropped": dropped}


def routed_alike(cfg, what, diff, call):
    """``routing_diff``'s record for ``call``; fails unless the runs
    agree."""
    if not diff["agree"]:
        fail(f"{cfg.name} {what}, {call}: the runs routed apart ({diff})")
    return dict(diff, call=call)


class MoeDecodeSteps(DecodeSteps):
    """``DecodeSteps`` that also saves, before each step in which one of
    ``tracked``'s requests decodes its first or second token, the pool and
    the step's host inputs, to run the step again eagerly with its
    routing recorded."""

    def __init__(self, eng, tracked):
        super().__init__(eng, keep_steps=True)
        self.tracked, self.saved = tracked, []

    def __call__(self, tokens, lengths, slot_ids, tables):
        want = any(r.slot in slot_ids.tolist() and lengths[
            slot_ids.tolist().index(r.slot)] - len(r.tokens) in (0, 1)
            for r in self.tracked if getattr(r, "slot", None) is not None)
        pool = clone_pool(self.eng.slots.pool) if want else None
        logits, out = super().__call__(tokens, lengths, slot_ids, tables)
        if want:
            self.saved.append(((tokens.copy(), lengths.copy(),
                                slot_ids.copy(), tables.copy()), pool,
                               logits.clone()))
        return logits, out


def text_requests(cfg, lengths, max_new, seed):
    """Text requests of ``lengths`` tokens drawn from ``seed``, ``max_new``
    new tokens each."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(3, cfg.vocab_size - 1, n)
                    .astype(np.int32), max_new_tokens=max_new)
            for i, n in enumerate(lengths)]


def serve_text(sm, cfg, reqs, max_len, tracked=(), route_log=None):
    """Serve text ``reqs`` on ``cfg`` at full width (``init_params`` seed
    0, ``nanomind-serve``, the experts packed as they are made) with the
    engine's decode step (the fused one for a dense config, the composed
    one for an MoE), holding every packed GEMM call of the serve as it is
    made (``HeldGemms``) and every flash call on its served output after
    it (``FlashCalls``), counting every launch; then the captured cohort state again through the eager
    step with the row-update, KV-scatter, fused-QKV and fused-MLP calls
    held, bit-equal to the replay; for a fused config that state through
    the plain composed step too.  With ``route_log`` armed in every
    prefill call, the groups' routing is kept.  Returns (serve record,
    engine, run): run = (prefill groups [(tokens, last_idx, logits,
    routing)], decode steps, the saved tracked steps)."""
    from repro_torch.core.quantize import PROFILES, tree_bytes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_decode import ref
    from repro_torch.models.decoder import group_size
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    torch = sm.torch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, device=sm.dev, seed=0,
                         policy=PROFILES["nanomind-serve"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    weights_gb = tree_bytes(params) / 1e9
    eng = ServingEngine(cfg, params, n_slots=N_SLOTS, max_len=max_len,
                        block_size=BLOCK_SIZE, device=sm.dev)
    del params
    fused = eng.use_fused
    if fused != (cfg.moe is None):
        fail(f"{cfg.name}: the engine selected use_fused={fused}")
    kinds = sublayers(cfg)
    n_attn = sum(m == "attn" for m, _ in kinds)
    n_moe = sum(f == "moe" for _, f in kinds)
    n_mamba = sum(m == "mamba" for m, _ in kinds)
    groups, prefill = [], eng._prefill
    steps = MoeDecodeSteps(eng, tracked)

    def recording_prefill(tokens, vision_embeds, last_idx):
        if route_log is None:
            logits, cache = prefill(tokens, vision_embeds, last_idx)
            routing = None
        else:
            with route_log.run() as routing:
                logits, cache = prefill(tokens, vision_embeds, last_idx)
        groups.append((tokens.clone(), last_idx.clone(), logits.clone(),
                       routing))
        return logits, cache
    eng._prefill = recording_prefill
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    with HeldGemms(sm) as gemms, FlashCalls() as flashes, HeldSsd() as ssds, \
            steps, eng:
        done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    eng._prefill = prefill
    L = cfg.n_layers
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
    n_pre = len(groups)
    per_step = ({"fused_qkv": L, f"fused_qkv/{MLP_ROUTE}": L, "fused_mlp": L,
                 f"fused_mlp/{MLP_ROUTE}": L, "kv_scatter": 1} if fused
                else {"cache_row_update": 2 * n_attn, "kv_scatter": 1})
    if n_moe:
        per_step["fused_mlp/experts"] = n_moe
    per_call = stack_gemms(cfg)
    want = {k: 0 for k in launches}
    want.update({k: n * decode_steps for k, n in per_step.items()})
    n_flash = n_attn * n_pre if cfg.attn_q_chunk == 0 else 0
    want["flash_attention"] = n_flash
    want[f"flash_attention/{FLASH_ROUTE[cfg.dtype]}"] = n_flash
    want["dequant_gemm"] = per_call * n_pre
    want[f"dequant_gemm/{GEMM_ROUTE[cfg.dtype]}"] = per_call * n_pre
    want["dequant_gemm/experts"] = 3 * n_moe * n_pre
    want["ssd"] = want[f"ssd/{SSD_ROUTE[cfg.dtype]}"] = n_mamba * n_pre
    if not (launches == want and decode_steps > 0 and n_pre > 0
            and len(steps.launches) == decode_steps
            and all(d == per_step for d in steps.launches)
            and gemms.record()["calls"] == per_call * n_pre
            and len(flashes.calls) == n_flash
            and ssds.calls == n_mamba * n_pre):
        fail(f"{cfg.name}: launch counts {launches} for {decode_steps} "
             f"decode steps and {n_pre} prefill calls (want {want}; per "
             f"step {per_step}, got {steps.launches[:3]}; held GEMM calls "
             f"{gemms.record()['calls']}, flash {len(flashes.calls)}, SSD "
             f"{ssds.calls})")
    spans = eng.probe.samples()
    pre = [s for s in spans if s.brick == "decoder" and s.phase == "prefill"]
    decs = [s for s in spans if s.brick == "decoder" and s.phase == "decode"]
    serve = {"arch": cfg.name, "n_layers": L, "dtype": cfg.dtype,
             "attn_q_chunk": cfg.attn_q_chunk,
             "decode_step": "fused" if fused else "composed",
             "requests": len(done), "prompt_tokens": [len(r.tokens)
                                                      for r in reqs],
             "decode_steps": decode_steps,
             "decoded_tokens": eng.stats.decoded_tokens,
             "setup_s": round(setup_s, 3), "serve_s": round(serve_s, 3),
             "weights_gb": round(weights_gb, 3),
             "init_peak_mem_gb": round(init_peak, 3),
             "prefill_calls": n_pre,
             "prefill_batch": [int(g[0].shape[0]) for g in groups],
             "prefill_width": [int(g[0].shape[1]) for g in groups],
             # every GEMM call of a prefill is held against its plain
             # version inside the span: prefill_breakdown times a call
             # without the checks
             "prefill_ms_with_held_checks": [round(s.dt * 1e3, 3)
                                             for s in pre],
             "prefill_tokens": [s.tokens for s in pre],
             **decode_rates(eng, decs),
             "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                  3),
             "kv_pool_mb": round(eng.slots.nbytes / 1e6, 3),
             "launches": launches, "launches_per_decode_step": per_step,
             "cohort_graph": graph_check(cfg, eng, decode_steps),
             "gemm_served_check": gemms.record()}
    if ssds.calls:
        serve["ssd_served_check"] = ssds.record()
        sm.errs["ssd"] = max(sm.errs["ssd"], ssds.worst["y_max_abs_err"])
    if n_mamba and n_attn:
        serve["sublayers"] = {"groups": len(kinds) // group_size(cfg),
                              "attn": n_attn,
                              "mamba": n_mamba, "moe": n_moe}
    if flashes.calls:
        serve["flash_served_check"] = flashes.held(sm, cfg.name)
    del gemms, flashes

    state = steps.state
    if state is None:
        fail(f"{cfg.name}: no multi-row cohort state was captured")
    args = state["args"]
    kw = dict(block_size=eng.slots.block_size, paged=eng.slots.paged)
    with RowUpdateCalls() as rows, MlpCalls() as mlps, QkvCalls() as qkvs, \
            KvScatterCalls() as kvs, ExpertCalls() as experts:
        serve["served_vs_eager"], le, _ = served_vs_eager(
            sm, cfg, eng, state, fused, (rows, mlps, qkvs, kvs, experts))
    if kvs.calls != 1 or experts.calls != n_moe or (
            rows.calls, qkvs.calls, mlps.calls) != (
            (0, L, L) if fused else (2 * n_attn, 0, 0)):
        fail(f"{cfg.name}: held in the eager step: {rows.calls} row "
             f"updates, {qkvs.calls} QKV, {mlps.calls} MLP, {kvs.calls} KV "
             f"scatters, {experts.calls} routed experts' GEMVs")
    if n_moe:
        serve["expert_served_check"] = {
            "calls": experts.calls, "worst_row_err_over_row_max":
            experts.worst, "max_abs_err": experts.err, "bc": experts.bc,
            "tol": EXPERT_GEMV_TOL[cfg.dtype], "step": "eager"}
        sm.errs["fused_mlp/experts"] = max(sm.errs["fused_mlp/experts"],
                                           experts.err)
    nrows = int((args[2] < eng.slots.n_slots).sum())
    if fused:
        serve["qkv_served_check"] = {
            "calls": qkvs.calls, "worst_row_err_over_row_max": qkvs.worst,
            "bc": qkvs.bc, "tol": MLP_ROW_TOL[cfg.dtype], "step": "eager"}
        serve["mlp_served_check"] = {
            "calls": mlps.calls, "worst_row_err_over_row_max": mlps.worst,
            "bc": mlps.bc, "tol": MLP_ROW_TOL[cfg.dtype], "step": "eager"}
        with torch.no_grad():
            lr, _ = ref.ref_cohort_step(eng.params, cfg, *args,
                                        state["pool"], **kw)
        serve["cohort_check"] = logit_check(cfg, le[:nrows], lr[:nrows],
                                            "fused vs composed step")
        del lr
    else:
        serve["row_update_served_check"] = {
            "calls": rows.calls, "bit_exact": True, "step": "eager",
            "cache_shape_dtype_strides": sorted(rows.shapes)}
    serve["kv_scatter_served_check"] = {"calls": kvs.calls,
                                        "bit_exact": True, "step": "eager"}
    for pos, saved in zip(eng.slots.pool, state["pool"]):
        for leaf, t in zip(pos, saved):
            leaf.copy_(t)
    serve["decode_step_breakdown"] = decode_breakdown(
        eng, [t.cpu().numpy() for t in args], nrows, per_step)
    steps.state = state = None
    del le
    return serve, eng, (groups, steps.steps, steps.saved)


def moe_checks(sm, cfg, eng, reqs, run, log, max_len=MOE_MAX_LEN):
    """Phase 8's (and 9's) model checks on a served MoE engine, every
    comparison held within STEP_TOL of the largest logit, with the
    flipped and dropped choices (``routing_diff``) recorded for every
    call: (a) MOE_UNPADDED's requests' prefill logits against
    ``lm_prefill`` on the unpadded prompt (``valid_len``: the engine's
    masked routing), which must route as the engine's prefill did; their
    first two decode steps against teacher-forced ``lm_decode_step`` made
    to take the experts the engine's step took (read from the saved steps
    run again eagerly, bit-equal to the replays: the paged and the
    contiguous attention round apart, so the router's own choices may
    flip, and the flips are counted); (b) MOE_PADDED: each prompt
    prefilled at two widths, routed alike in the prefill and the step,
    the same next-step logits; (c) the largest prefill group again
    through the plain versions (dequantize + einsum, an expert at a
    time; dense attention; the plain SSD), made to take the kernel run's
    experts, row by row.  A decode step routes each row alone (one token
    a row in ``RouteLog``'s order)."""
    from repro_torch.kernels.dequant_gemm import ops as dg_ops
    from repro_torch.kernels.flash_attention import ref_attention
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref_ssd_chunked
    from repro_torch.models import attention
    from repro_torch.models import model as M
    torch = sm.torch
    groups, _, saved = run
    dev = sm.dev
    checks, held = {}, 0

    def ar(n):
        return torch.arange(n)

    with torch.no_grad():
        # the saved decode steps again, eagerly, with their routing
        eager = []
        for host, pool, logits in saved:
            targs = [torch.from_numpy(a).to(dev) for a in host]
            with log.run() as routing:
                le, _ = eng._cohort_step(*targs, pool)
            if not torch.equal(le, logits):
                fail(f"{cfg.name}: a saved decode step run eagerly differs "
                     f"from its replay")
            eager.append((host, routing, logits))
        del saved[:]
        for n in MOE_UNPADDED:
            what = f"engine vs unpadded model ({n} tokens)"
            r = next(q for q in reqs if len(q.tokens) == n)
            tok = torch.from_numpy(r.tokens)
            g = next(g for g in groups if any(
                int(g[1][b]) == n and torch.equal(g[0][b, :n].cpu(), tok)
                for b in range(g[0].shape[0])))
            b = next(b for b in range(g[0].shape[0]) if int(g[1][b]) == n
                     and torch.equal(g[0][b, :n].cpu(), tok))
            S = int(g[0].shape[1])
            with log.run() as pre_route:
                l0, cache = M.lm_prefill(
                    eng.params, cfg, tok[None].to(dev), max_len,
                    valid_len=torch.tensor([n], device=dev))
            routes = [routed_alike(cfg, what, routing_diff(
                g[3], moe_token_rows(b, S, n), pre_route,
                moe_token_rows(0, n, n)), "prefill")]
            rows = [logit_check(cfg, g[2][b:b + 1], l0, f"{what}, prefill")]
            for j in range(2):
                host, e_route, e_logits = next(
                    e for e in eager if r.slot in e[0][2].tolist()
                    and e[0][1][e[0][2].tolist().index(r.slot)] == n + j)
                ci = host[2].tolist().index(r.slot)
                row = ar(1) + ci
                force = [c["idx"][row.to(c["idx"].device)]
                         for c in e_route]
                with log.run(force) as d_route:
                    lw, cache = M.lm_decode_step(
                        eng.params, cfg, torch.tensor(
                            [[int(r.out_tokens[j])]], dtype=torch.int32,
                            device=dev), cache)
                routes.append(routed_alike(cfg, what, routing_diff(
                    e_route, row, d_route, ar(1)), f"decode {j + 1}"))
                rows.append(logit_check(cfg, e_logits[ci:ci + 1], lw,
                                        f"{what}, decode {j + 1}"))
            held += len(rows)
            checks[f"unpadded_{n}"] = {
                "rows": [dict(x, call=c["call"]) for x, c in zip(rows,
                                                                   routes)],
                "routing": routes, "decode_experts": "the engine's"}

        for n, widths in MOE_PADDED:
            what = f"pad invariance ({n} tokens)"
            r = next(q for q in reqs if len(q.tokens) == n)
            outs = []
            for w in widths:
                with log.run() as route:
                    lw = padded_next_step(eng, cfg, r.tokens, None, n, w)
                outs.append((w, lw, list(route)))
            (wa, la, ra), (wb, lb, rb) = outs
            L = sum(f == "moe" for _, f in sublayers(cfg))
            routes = [routed_alike(cfg, what, routing_diff(
                          ra[:L], ar(n), rb[:L], ar(n)), "prefill"),
                      routed_alike(cfg, what, routing_diff(
                          ra[L:], ar(1), rb[L:], ar(1)), "decode 1")]
            held += 1
            checks[f"pad_{n}_{wa}_vs_{wb}"] = dict(
                logit_check(cfg, la, lb, what), routing=routes)

        tokens, last, logits, routing = max(groups,
                                            key=lambda g: g[0].numel())
        what = "kernel vs plain prefill"
        with swapped(attention, "flash_attention", ref_attention), \
                swapped(dg_ops, "quant_einsum", dg_ops.ref_quant_einsum), \
                plain_sums(), \
                swapped(ssd_ops, "ssd", ref_ssd_chunked), \
                log.run([c["idx"] for c in routing]) as plain_route:
            plain, _ = eng._prefill(tokens, None, last)
        S = int(tokens.shape[1])
        rows = {}
        for b in range(tokens.shape[0]):
            n = int(last[b])
            tr = moe_token_rows(b, S, n)
            rows[f"row_{b}_{n}_tokens"] = dict(
                logit_check(cfg, logits[b:b + 1], plain[b:b + 1], what),
                routing=routed_alike(cfg, what, routing_diff(
                    routing, tr, plain_route, tr), "prefill"))
            held += 1
        checks["kernel_vs_plain_prefill"] = dict(
            rows, batch=int(tokens.shape[0]), width=S, experts="the kernel "
            "run's")
    torch.cuda.synchronize()
    want = 3 * len(MOE_UNPADDED) + len(MOE_PADDED) + int(tokens.shape[0])
    if held != want:
        fail(f"{cfg.name}: {held} logit comparisons held, want {want}")
    checks["held"] = held
    return checks


def time_expert_gemm(sm, shape):
    """The expert contraction gecd,edf->gecf at ``shape`` (G, E, C, K, N),
    q4 g32, bf16, through ``quant_einsum`` (one launch over E), its plain
    version (``dequantize`` + einsum), ``dequantize`` + ``torch.matmul``
    on the expert-major rows (E, G C, K) and ``torch.matmul`` on the
    weight dequantized beforehand; the bytes (codes, scales, x, y once)
    and operations (2 E G C K N) that set its bound."""
    import torch
    from repro_torch.core.quantize import QuantSpec, dequantize, quantize
    from repro_torch.kernels.dequant_gemm import (quant_einsum,
                                                  ref_quant_einsum)
    G, E, C, K, N = shape
    spec = "gecd,edf->gecf"
    x = sm.randn(G, E, C, K)
    w = quantize(sm.randn(E, K, N, scale=K ** -0.5),
                 QuantSpec(4, group_size=32))
    dense = dequantize(w)
    xe = x.transpose(0, 1).reshape(E, G * C, K).contiguous()
    with torch.no_grad():
        t_k = timed(lambda i: quant_einsum(spec, x, w), 1, iters=20)
        t_p = timed(lambda i: ref_quant_einsum(spec, x, w), 1, iters=5)
        t_l = timed(lambda i: torch.matmul(xe, dequantize(w)), 1, iters=5)
        t_d = timed(lambda i: torch.matmul(xe, dense), 1, iters=20)
    byt = (w.codes.numel() * 4 + w.scales.numel() * 4
           + 2 * E * G * C * (K + N))
    out = (t_k, t_p, t_l, t_d, byt, 2 * E * G * C * K * N)
    del x, w, dense, xe
    free()
    return out


def replayed_ms(fn, n):
    """ms a call of ``fn(i)``, i over ``n`` inputs, as a CUDA graph of
    the n calls back to back replays them (CUDA events around 3 replays
    after one warm replay)."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (3 * n)


def time_expert_gemv(sm, arch):
    """The routed experts' GEMV at ``arch``'s widths (EXPERT_GEMV), q4
    g32, bf16, distinct experts a row, through ``fused_mlp_experts``, each
    cohort of EXPERT_TIME_BCS over EXPERT_ROTATIONS routings drawn once
    and taken in turn (each call reads other experts from device memory,
    as a decode step does; DeepSeek's 108 MB a call is about twice the
    50 MB L2); at TIME_BC also its plain version and the library form:
    the routed (row, choice) pairs' experts gathered, dequantized and
    run through batched ``torch.bmm``, a matrix at a time.  The bound's
    bytes are the routed experts' codes and scales read once, h and the
    output (the mean over the routings); its operations 2 x 3 D F a
    (row, choice).  Returns (TIME_BC's (kernel, plain, library, None,
    bytes, flops), its mean routed experts, {cohort: the kernel's ms a
    call as a CUDA graph replays the rotation's calls, each device
    kernel's profiled ms, bytes, bound, rate})."""
    import torch
    from repro_torch.core.quantize import QTensor, dequantize
    from repro_torch.kernels.fused_decode import expert as EK
    from repro_torch.kernels.fused_decode import ops, ref
    E, k, D, F = EXPERT_GEMV[arch]
    dtype = torch.bfloat16
    up, gate, down = expert_weights(sm, E, D, F, dtype)
    per_expert = sum(w.codes[0].numel() * 4 + w.scales[0].numel() * 4
                     for w in (up, gate, down))
    cohorts, main = {}, None
    for bc in EXPERT_TIME_BCS:
        routes = [expert_routes(sm, bc, k, E)
                  for _ in range(EXPERT_ROTATIONS)]
        h = sm.randn(bc, D, dtype=dtype)
        n_routed = [int(torch.unique(r[0]).numel()) for r in routes]
        byt = (sum(n_routed) / len(n_routed) * per_expert + 2 * 2 * bc * D)

        def kernel(i):
            idx, gates, valid = routes[i]
            return ops.fused_mlp_experts(h, up, down, gate, idx, gates,
                                         valid, act="swiglu")
        calls = 2 * EXPERT_ROTATIONS

        def loop():
            for i in range(calls):
                kernel(i % EXPERT_ROTATIONS)
            torch.cuda.synchronize()
        with torch.no_grad():
            call_ms = event_ms(kernel, EXPERT_ROTATIONS, iters=24)
            _, rows, n_kernels = device_time(loop)
            # a call's time as a decode step's graph replays it (no host
            # launch between the calls); the profiled kernels beside it
            ms = replayed_ms(kernel, EXPERT_ROTATIONS)
        per_kernel = {n: {"ms_a_launch": sum(us for nm, us, _ in rows
                                             if n in nm) / 1e3 / calls,
                          "launches_a_call": sum(c for nm, _, c in rows
                                                 if n in nm) / calls}
                      for n in EK.EXPERT_KERNELS}
        t_k = (ms, call_ms, n_kernels / calls)
        cohorts[bc] = {"ms": ms, "ms_source": "CUDA graph replay",
                       "profiled_kernels_sum_ms": sum(
                           us for nm, us, _ in rows
                           if any(n in nm for n in EK.EXPERT_KERNELS))
                       / 1e3 / calls, "call_ms": call_ms,
                       "device_kernels_a_call": t_k[2],
                       "kernels": per_kernel,
                       "routed_experts_mean": sum(n_routed) / len(n_routed),
                       "bytes": byt,
                       "bound_ms": byt / HBM_BYTES_PER_S * 1e3,
                       "achieved_GB_s": byt / ms / 1e6,
                       "bound_share": byt / HBM_BYTES_PER_S * 1e3 / ms,
                       "rotations": EXPERT_ROTATIONS}
        if bc != TIME_BC:
            continue
        idx, gates, valid = routes[0]
        pairs = idx.reshape(-1)
        hp = h.repeat_interleave(k, 0)[:, None]              # (P, 1, D)
        gp = gates.reshape(-1, 1, 1).to(dtype)

        def gathered(w):
            return dequantize(QTensor(w.codes[pairs], w.scales[pairs], w.spec,
                                      (pairs.numel(),) + tuple(w.shape[1:]),
                                      w.dtype))

        def library():
            u = torch.bmm(hp, gathered(up))
            g = torch.bmm(hp, gathered(gate))
            y = torch.bmm(torch.nn.functional.silu(g) * u, gathered(down))
            return (gp * y).reshape(TIME_BC, k, D).sum(1)
        with torch.no_grad():
            t_p = timed(lambda i: ref.ref_fused_mlp_experts(
                h, up, down, gate, idx, gates, valid, act="swiglu"), 1,
                iters=3)
            t_l = timed(lambda i: library(), 1, iters=3)
        main = ((t_k, t_p, t_l, None, byt, 2 * 3 * D * F * k * TIME_BC),
                cohorts[bc]["routed_experts_mean"])
    del up, gate, down
    free()
    return main + (cohorts,)


def serve_moe_and_dense(sm):
    """Phase 8: DeepSeek-MoE-16B at full width and depth, its model checks
    and breakdowns; then the DENSE_SERVES configs at full width and
    DENSE_LAYERS layers.  Returns {path: serve record}."""
    from repro_torch.configs import get_config
    out = {}
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              attn_q_chunk=0)
    reqs = text_requests(cfg, MOE_PROMPTS, MOE_NEW, seed=3)
    tracked = [r for r in reqs if len(r.tokens) in MOE_UNPADDED]
    with RouteLog() as log:
        serve, eng, run = serve_text(sm, cfg, reqs, MOE_MAX_LEN, tracked,
                                     route_log=log)
        serve["routing_by_prefill_call"] = [
            prefill_drops(g) for g in run[0]]
        serve["checks"] = moe_checks(sm, cfg, eng, reqs, run, log)
        g = max(run[0], key=lambda g: g[0].numel())
        serve["prefill_breakdown"] = prefill_breakdown(
            eng, (g[0], None, g[1]), ("dequant_gemm", "flash"))
        del g
    del eng, run
    free()
    out[MOE_PATH] = with_decode_before(MOE_PATH, serve)
    print(json.dumps({"serve": serve}))
    for name, over in DENSE_SERVES:
        cfg = dataclasses.replace(get_config(name), n_layers=DENSE_LAYERS,
                                  **over)
        serve, eng, _ = serve_text(sm, cfg, text_requests(
            cfg, DENSE_PROMPTS, DENSE_NEW, seed=4), DENSE_MAX_LEN)
        del eng
        free()
        path = f"{name}/{DENSE_LAYERS}-layer"
        out[path] = with_decode_before(path, serve)
        print(json.dumps({"serve": serve}))
    return out


def with_decode_before(path, serve):
    """``serve`` with its replayed decode step's device ms beside the one
    before the routed experts' GEMV (DECODE_MS_BEFORE), where there is
    one."""
    if path in DECODE_MS_BEFORE:
        graph = serve["decode_step_breakdown"]["graph"]
        serve["decode_step_device_ms_vs_before"] = {
            "now": graph["device_ms"], "before": DECODE_MS_BEFORE[path],
            "before_source": DECODE_MS_BEFORE_SOURCE,
            "tok_s_now": graph["tok_s"]}
    return serve


def serve_hybrid(sm):
    """Phase 9: Jamba-1.5-Large at full width and HYBRID_GROUPS group of
    8 sublayers (attention at position 4, Mamba-2 elsewhere, 16 experts
    top-2 on odd positions), ``attn_q_chunk=0``, packed as made: the
    MOE_PROMPTS-like text requests through ``serve_text`` (every GEMM,
    SSD and flash call of the serve held, the eager step's row updates,
    KV scatter and routed experts' GEMVs held, launch counts, replay
    bit-equal), the dropped choices of each prefill call, the model
    checks of ``moe_checks`` (the engine against the unpadded model,
    padded widths, the plain rerun on the kernel run's experts) and the
    prefill breakdown.  Returns its serve record."""
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import group_size
    base = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(base, n_layers=HYBRID_GROUPS * group_size(
        base), attn_q_chunk=0)
    reqs = text_requests(cfg, HYBRID_PROMPTS, HYBRID_NEW, seed=5)
    tracked = [r for r in reqs if len(r.tokens) in MOE_UNPADDED]
    with RouteLog() as log:
        serve, eng, run = serve_text(sm, cfg, reqs, HYBRID_MAX_LEN, tracked,
                                     route_log=log)
        serve["routing_by_prefill_call"] = [
            prefill_drops(g) for g in run[0]]
        serve["checks"] = moe_checks(sm, cfg, eng, reqs, run, log,
                                     max_len=HYBRID_MAX_LEN)
        g = max(run[0], key=lambda g: g[0].numel())
        serve["prefill_breakdown"] = prefill_breakdown(
            eng, (g[0], None, g[1]), ("dequant_gemm", "flash", "ssd_"))
        del g
    del eng, run
    free()
    serve = with_decode_before(HYBRID_PATH, serve)
    print(json.dumps({"serve": serve}))
    return serve


def encdec_batch(sm, cfg, rows, frames, seed):
    """``rows`` requests of ``frames`` stub audio frames (normal draws x
    0.02, fp32) and an ENCDEC_PREFIX-token target prefix, made on the card
    from ``seed``."""
    torch = sm.torch
    g = torch.Generator(device=sm.dev).manual_seed(seed)
    return {"src_embeds": torch.randn((rows, frames, cfg.d_model),
                                      generator=g, device=sm.dev) * 0.02,
            "tgt_tokens": torch.randint(3, cfg.vocab_size - 1,
                                        (rows, ENCDEC_PREFIX), generator=g,
                                        device=sm.dev, dtype=torch.int32)}


def encdec_generate(params, batch, prefill, serve, forced=None):
    """ENCDEC_NEW new tokens: the prefill step's, then ENCDEC_NEW - 1
    serve steps, greedy (or the ``forced`` tokens, teacher-forced).
    Returns (tokens (B, ENCDEC_NEW) int32, each call's logits)."""
    import torch
    logits, cache = prefill(params, batch)
    outs, toks = [logits], []
    for j in range(ENCDEC_NEW):
        tok = (logits.argmax(-1, keepdim=True).to(torch.int32)
               if forced is None else forced[:, j:j + 1])
        toks.append(tok)
        if j + 1 < ENCDEC_NEW:
            logits, cache = serve(params, tok, cache)
            outs.append(logits)
    return torch.cat(toks, 1), outs


def worst_logit_check(cfg, gots, wants, what):
    """``logit_check`` of each pair; the worst (by error over the largest
    logit) with the number of pairs and of rows whose top-1 agrees."""
    checks = [logit_check(cfg, g, w, f"{what} {i}")
              for i, (g, w) in enumerate(zip(gots, wants))]
    worst = max(checks, key=lambda c: c["max_abs_err"] / c["max_abs_logit"])
    return dict(worst, compared=len(checks),
                same_top1_all=sum(c["same_top1"] for c in checks),
                rows_all=sum(c["rows_compared"] for c in checks))


def time_encdec_gemv(sm, cfg, params, bc):
    """The fused QKV and the ungated GELU MLP GEMV at cohort ``bc`` over
    the served decoder layers' packed weights (rotated over the layers),
    beside their plain versions and the library form (``dequantize`` +
    ``torch.matmul``); the cache-row-update kernel at a layer of the
    self-cache (bc x ENCDEC_MAX_LEN), beside ``index_put_``."""
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels.cache_update import (cache_row_update,
                                                  ref_cache_row_update)
    from repro_torch.kernels.fused_decode import ops, ref
    from repro_torch.models import decoder as dec
    torch = sm.torch
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    KV, hd = cfg.n_kv_heads, cfg.hd
    layers = [dec.layer_slice(params["dec_layers"], i) for i in range(L)]
    h = sm.randn(bc, 1, D)
    x2 = h.reshape(bc, D)
    qkv = [tuple(lay["self_attn"][w] for w in ("wq", "wk", "wv"))
           for lay in layers]
    ffn = [(lay["ffn"]["w_up"], lay["ffn"]["w_down"]) for lay in layers]

    def nbytes(ws):
        return sum(w.codes.numel() * 4 + w.scales.numel() * 4 for w in ws)
    n_qkv = (cfg.n_heads + 2 * KV) * hd
    rec = {}
    with torch.no_grad():
        rec["fused_qkv"] = (
            timed(lambda i: ops.fused_qkv(h, *qkv[i]), L),
            timed(lambda i: ref.ref_fused_qkv(h, *qkv[i]), L),
            timed(lambda i: torch.matmul(x2, torch.cat([dequantize(
                w).reshape(D, -1) for w in qkv[i]], 1)), L), None,
            nbytes(qkv[0]) + 2 * (bc * D + bc * n_qkv), 2 * bc * D * n_qkv)
        rec["fused_mlp"] = (
            timed(lambda i: ops.fused_mlp(h, *ffn[i], None, act=cfg.act), L),
            timed(lambda i: ref.ref_fused_mlp(h, *ffn[i], None, act=cfg.act),
                  L),
            timed(lambda i: torch.matmul(torch.nn.functional.gelu(
                x2 @ dequantize(ffn[i][0]), approximate="tanh"),
                dequantize(ffn[i][1])), L), None,
            nbytes(ffn[0]) + 2 * 2 * bc * D, 2 * bc * 2 * D * F)
        stack = sm.randn(L, bc, ENCDEC_MAX_LEN, KV, hd)
        row = sm.randn(bc, KV, hd)
        idx = torch.tensor(ENCDEC_PREFIX, dtype=torch.int32, device=sm.dev)
        b_idx = torch.arange(bc, device=sm.dev)
        s_idx = torch.full((bc,), ENCDEC_PREFIX, device=sm.dev)
        rec["cache_row_update"] = (
            timed(lambda i: cache_row_update(stack[i], row, idx), L),
            timed(lambda i: ref_cache_row_update(stack[i], row, idx), L),
            timed(lambda i: stack[i].index_put_((b_idx, s_idx), row), L),
            None, 2 * 2 * bc * KV * hd + 4, 0)
    return rec


def encdec_plans(sm, cfg, host, batch, want_logits):
    """Phase 10's brick chain on input (a)'s first row, the weights
    ``host`` on the CPU and nothing of the model on the card: the
    resident plan (every brick on the card, the weights moved there
    once) and the On-Demand Cascade on the card (each brick's params
    pinned host-side, loaded, executed, released), a warm-up and
    ENCDEC_RUNS clocked runs each.  Gates: 6 E + 10 L packed GEMM and
    E + 2 L flash launches a run, all on wgmma; the last position's
    logits within STEP_TOL of the prefill step's for that row and the
    cascade's of the resident plan's; the cascade's card peak under the
    resident plan's.  Returns (record, launches by run)."""
    from repro_torch.core.bricks import decompose
    from repro_torch.core.cascade import CascadeRunner
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.quantize import QTensor, tree_bytes
    from repro_torch.core.scheduler import populate_brick_bytes
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import tree_map
    torch = sm.torch
    L, E = cfg.n_layers, cfg.n_enc_layers
    graph = decompose(cfg)
    populate_brick_bytes(graph, host)
    inputs = {k: v[:1].cpu() for k, v in batch.items()}
    want_n = {k: 0 for k in launch_counts()}
    for k, n in (("dequant_gemm", 6 * E + 10 * L), ("flash_attention",
                                                      E + 2 * L)):
        want_n[k] = want_n[f"{k}/wgmma"] = n

    def card_runs(make, what):
        plan, out, trace, counts, evs, walls, peak, start = \
            clocked_plan_runs(make, inputs, ENCDEC_RUNS, want_n, what)
        if tuple(out.shape) != (1, ENCDEC_PREFIX, cfg.padded_vocab):
            fail(f"{what}: logits of shape {tuple(out.shape)}")
        t0 = trace.card[0][0]
        events = [[e.brick, e.phase, (t - t0) * 1e3, e.resident_bytes, a]
                  for e, (t, a) in zip(trace.events, trace.card)]
        rec = dict(run_times(evs, walls), card_peak_mb=peak / 1e6,
                   card_start_mb=start / 1e6,
                   trace_peak_bytes=trace.peak_bytes,
                   trace_sum_bytes=trace.sum_bytes,
                   events_brick_phase_ms_counted_allocated=events,
                   launches_a_run={k: n for k, n in counts[-1].items() if n})
        logits = out[:, -1].float()
        del plan, out
        return logits, rec, {k: sum(c[k] for c in counts) for k in counts[0]}

    res_logits, res, res_n = card_runs(
        lambda: compile_plan(graph, tree_map(lambda l: l.to(sm.dev)
                                             if isinstance(l, (torch.Tensor,
                                                               QTensor))
                                             else l, host)),
        f"{ENCDEC_PATH}/resident")
    res["vs_prefill_step"] = logit_check(cfg, res_logits, want_logits,
                                         "resident plan vs prefill step")
    cas_logits, cas, cas_n = card_runs(lambda: CascadeRunner(graph,
                                                             host).plan,
                                       f"{ENCDEC_PATH}/cascade")
    cas["vs_resident"] = logit_check(cfg, cas_logits, res_logits,
                                     "cascade vs resident plan")
    cas["bit_equal_to_resident"] = bool(torch.equal(cas_logits, res_logits))
    if cas["card_peak_mb"] >= res["card_peak_mb"]:
        fail(f"{ENCDEC_PATH}/cascade: the card's peak {cas['card_peak_mb']} "
             f"MB is not under the resident plan's {res['card_peak_mb']}")
    if not cas["trace_peak_bytes"] < cas["trace_sum_bytes"]:
        fail(f"{ENCDEC_PATH}/cascade: trace peak {cas['trace_peak_bytes']} "
             f"not under the sum {cas['trace_sum_bytes']}")
    ev = cas["events_brick_phase_ms_counted_allocated"]
    names = graph.names()
    if [e[:2] for e in ev] != [[b, p] for b in names
                               for p in ("load", "execute", "release")]:
        fail(f"{ENCDEC_PATH}/cascade: trace {[e[:2] for e in ev]}")
    prev, bricks = None, []
    for i, name in enumerate(names):
        (_, _, t_l, _, _), (_, _, t_x, _, _), (_, _, t_r, _, _) = \
            ev[3 * i:3 * i + 3]
        bricks.append({"brick": name,
                       "param_bytes": graph.brick(name).param_bytes,
                       "load_ms": None if prev is None else t_l - prev,
                       "execute_ms": t_x - t_l, "release_ms": t_r - t_x})
        prev = t_r
    cas["bricks"] = bricks
    cas["first_load_ms_note"] = ("the first brick's load is not clocked "
                                 "apart from the run's start")
    rec = {"chain": names, "rows": 1, "frames": int(inputs[
        "src_embeds"].shape[1]), "target_tokens": ENCDEC_PREFIX,
           "clocked_runs": ENCDEC_RUNS, "sum_bytes_once": tree_bytes(host),
           "brick_bytes": {b.name: b.param_bytes for b in graph.bricks},
           "resident": res, "cascade": cas,
           "card_peak_saved_mb": res["card_peak_mb"] - cas["card_peak_mb"]}
    free()
    return rec, {f"{ENCDEC_PATH}/resident": res_n,
                 f"{ENCDEC_PATH}/cascade": cas_n}


def serve_encdec(sm):
    """Phase 10: seamless-m4t-large-v2 at full width and depth (24 encoder
    and 24 decoder layers), ``attn_q_chunk=0``, ``init_params`` seed 0
    packed as made under ``nanomind-serve``: ENCDEC_INPUTS through
    ``launch.steps.build_prefill_step`` / ``build_serve_step`` at
    ``max_len`` ENCDEC_MAX_LEN, ENCDEC_NEW greedy tokens each, every
    packed GEMM, flash, fused QKV / MLP and cache-row-update call held
    against its plain version as it is made; the launches counted
    around each input's run; the prefill and every decode step's logits
    against the plain route (every kernel swapped for its plain version,
    teacher-forced on the served tokens) within STEP_TOL; the encoder,
    prefill and eager decode step broken down; then the brick chain
    (``encdec_plans``) and the kernels at the new shapes.  Returns
    (record, launches by run, timings)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, QTensor, tree_bytes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.cache_update import ops as cu_ops
    from repro_torch.kernels.dequant_gemm import ops as dg_ops
    from repro_torch.kernels.flash_attention import ref_attention
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.fused_decode import ref as fd_ref
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, init_params)
    from repro_torch.models import attention
    from repro_torch.models import encdec as ED
    from repro_torch.tree import tree_map
    torch = sm.torch
    cfg = dataclasses.replace(get_config(ENCDEC_PATH), attn_q_chunk=0)
    L, E = cfg.n_layers, cfg.n_enc_layers
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, device=sm.dev, seed=0,
                         policy=PROFILES["nanomind-serve"])
    torch.cuda.synchronize()
    rec = {"arch": cfg.name, "n_enc_layers": E, "n_layers": L,
           "dtype": cfg.dtype, "attn_q_chunk": cfg.attn_q_chunk,
           "setup_s": time.perf_counter() - t0,
           "weights_gb": tree_bytes(params) / 1e9,
           "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "max_len": ENCDEC_MAX_LEN, "new_tokens": ENCDEC_NEW}
    prefill = build_prefill_step(cfg, ENCDEC_MAX_LEN)
    serve = build_serve_step(cfg)
    per_call = {"dequant_gemm": 6 * E + 10 * L, "flash_attention": E + 2 * L}
    per_step = {"fused_qkv": L, "fused_mlp": L, "cache_row_update": 2 * L}
    steps = ENCDEC_NEW - 1
    total = {k: 0 for k in launch_counts()}
    gemm_checks, inputs, first_row = [], {}, None
    worst = {"qkv": [0, 0.0, 0.0], "mlp": [0, 0.0, 0.0], "rows": 0}
    torch.cuda.reset_peak_memory_stats()
    for name, rows, frames in ENCDEC_INPUTS:
        batch = encdec_batch(sm, cfg, rows, frames, seed=10 + rows)
        reset_launch_counts()
        t0 = time.perf_counter()
        with HeldGemms(sm) as gemms, FlashCalls() as flashes, \
                RowUpdateCalls() as upd, MlpCalls() as mlps, \
                QkvCalls() as qkvs, torch.no_grad():
            upd.armed = mlps.armed = qkvs.armed = True
            toks, logits = encdec_generate(params, batch, prefill, serve)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        n = launch_counts()
        want = {k: 0 for k in n}
        for k, c in per_call.items():
            route = {"dequant_gemm": GEMM_ROUTE,
                     "flash_attention": FLASH_ROUTE}[k][cfg.dtype]
            want[k] = want[f"{k}/{route}"] = c
        for k, c in per_step.items():
            want[k] = c * steps
        want["fused_qkv/gemv"] = want["fused_mlp/gemv"] = L * steps
        held = (gemms.record()["calls"], len(flashes.calls), qkvs.calls,
                mlps.calls, upd.calls)
        if n != want or held != (per_call["dequant_gemm"],
                                 per_call["flash_attention"], L * steps,
                                 L * steps, 2 * L * steps):
            fail(f"{ENCDEC_PATH} ({name}): launches {n} (want {want}); held "
                 f"GEMM, flash, QKV, MLP, row-update calls {held}")
        for k in total:
            total[k] += n[k]
        if not (toks.shape == (rows, ENCDEC_NEW)
                and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab_size):
            fail(f"{ENCDEC_PATH} ({name}): tokens {toks.tolist()}")
        gemm_checks.append(gemms.record())
        sm.errs["fused_qkv"] = max(sm.errs["fused_qkv"], qkvs.err)
        sm.errs["fused_mlp"] = max(sm.errs["fused_mlp"], mlps.err)
        for key, c in (("qkv", qkvs), ("mlp", mlps)):
            worst[key] = [worst[key][0] + c.calls,
                          max(worst[key][1], c.worst),
                          max(worst[key][2], c.err)]
        worst["rows"] += upd.calls
        # the route the shape rule (``dequant_gemm/kernel.py route``)
        # picks for the decoder's prefill projections (rows x 16 rows),
        # read from the counts of one such call
        x = torch.zeros((rows, ENCDEC_PREFIX, cfg.d_model),
                        dtype=cfg.torch_dtype, device=sm.dev)
        reset_launch_counts()
        with torch.no_grad():
            dg_ops.quant_einsum("bsd,dhk->bshk", x, params["dec_layers"][
                "self_attn"]["wq"].layer(0))
        dec_route = [k.split("/", 1)[1] for k, c in launch_counts().items()
                     if k.startswith("dequant_gemm/") and c]
        # the plain route, teacher-forced on the served tokens
        with swapped(attention, "flash_attention", ref_attention), \
                swapped(dg_ops, "quant_einsum", dg_ops.ref_quant_einsum), \
                swapped(fd_ops, "fused_qkv", fd_ref.ref_fused_qkv), \
                swapped(fd_ops, "fused_mlp", fd_ref.ref_fused_mlp), \
                swapped(cu_ops, "cache_row_update",
                        cu_ops.ref_cache_row_update), \
                plain_sums(), torch.no_grad():
            _, plain = encdec_generate(params, batch, prefill, serve,
                                       forced=toks)
        torch.cuda.synchronize()
        inputs[name] = {
            "rows": rows, "frames": frames, "target_prefix": ENCDEC_PREFIX,
            "run_s_with_held_checks": run_s,
            "prefill_calls": 1, "decode_steps": steps,
            "decoder_prefill_rows": rows * ENCDEC_PREFIX,
            "decoder_prefill_route": dec_route,
            "tokens": toks.tolist(), "launches": {k: c for k, c in n.items()
                                                  if c},
            "flash_served_check": flashes.held(sm, f"{cfg.name} ({name})"),
            "prefill_vs_plain": logit_check(cfg, logits[0], plain[0],
                                            "prefill vs plain route"),
            "decode_vs_plain": worst_logit_check(
                cfg, logits[1:], plain[1:], "decode step vs plain route")}
        if first_row is None:
            first_row = ({k: v.clone() for k, v in batch.items()},
                         logits[0][:1].clone())
        del plain, logits, gemms, flashes

        # -- the breakdowns, no check held ---------------------------------
        def sync(fn):
            def call():
                with torch.no_grad():
                    fn()
                torch.cuda.synchronize()
            return call
        src = batch["src_embeds"]
        inputs[name]["encoder"] = call_breakdown(
            sync(lambda: ED.encode(params, cfg, src)),
            ("dequant_gemm", "flash"))
        inputs[name]["prefill"] = call_breakdown(
            sync(lambda: prefill(params, batch)), ("dequant_gemm", "flash"))
        with torch.no_grad():
            _, cache = prefill(params, batch)
        tok = toks[:, :1].contiguous()
        step = call_breakdown(sync(lambda: serve(params, tok, cache)),
                              ("gemv", "cache_row_update", "dequant"),
                              n_wall=5)
        step["tok_s"] = rows / step["wall_ms"] * 1e3
        step["tok_s_device"] = rows / step["device_ms"] * 1e3
        inputs[name]["decode_step_eager"] = step
        del cache, batch, src
        free()
    rec["inputs"] = inputs
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["prefill_calls"] = len(ENCDEC_INPUTS)
    rec["decode_steps"] = steps * len(ENCDEC_INPUTS)
    rec["launches"] = total
    rec["launches_per_prefill_call"] = per_call
    rec["launches_per_decode_step"] = per_step
    rec["gemm_served_check"] = {
        "calls": sum(c["calls"] for c in gemm_checks),
        "worst_err_over_max": max(c["worst_err_over_max"]
                                  for c in gemm_checks),
        "max_abs_err": max(c["max_abs_err"] for c in gemm_checks),
        "tol": DG_TOL, "held_against_float64": [
            a for c in gemm_checks for a in c["held_against_float64"]],
        "shapes_spec_x_w": sorted({tuple(s) for c in gemm_checks
                                   for s in c["shapes_spec_x_w"]})}
    rec["qkv_served_check"] = {
        "calls": worst["qkv"][0], "worst_row_err_over_row_max":
        worst["qkv"][1], "max_abs_err": worst["qkv"][2],
        "tol": MLP_ROW_TOL[cfg.dtype], "step": "every served step"}
    rec["mlp_served_check"] = {
        "calls": worst["mlp"][0], "worst_row_err_over_row_max":
        worst["mlp"][1], "max_abs_err": worst["mlp"][2], "act": cfg.act,
        "gated": False, "tol": MLP_ROW_TOL[cfg.dtype],
        "step": "every served step"}
    rec["row_update_served_check"] = {"calls": worst["rows"],
                                      "bit_exact": True,
                                      "step": "every served step"}
    times = time_encdec_gemv(sm, cfg, params, ENCDEC_INPUTS[0][1])
    host = tree_map(lambda l: l.to("cpu") if isinstance(
        l, (torch.Tensor, QTensor)) else l, params)
    del params
    free()
    plans, plan_runs = encdec_plans(sm, cfg, host, *first_row)
    rec["brick_chain"] = plans
    del host, first_row
    free()
    times["flash_attention"] = {shape: time_flash(sm, shape)
                                for shape in FLASH_ENCDEC_TIMES}
    times["dequant_gemm"] = time_gemm_shapes(sm, (cfg,))
    free()
    return rec, dict(plan_runs, **{ENCDEC_PATH: total}), times


def at_encdec(name, rec, runs, t, numbers):
    """Kernel ``name``'s numbers at phase 10's shapes (``rec``, ``runs``:
    ``serve_encdec``'s record and launches by run; ``t`` its timings of
    the kernel; ``numbers`` the kernels line's entry of a timing): its
    times there, its launches on phase 10's runs, its served check."""
    out = {"launches": {a: n[name] for a, n in runs.items()}}
    if name == "flash_attention":
        out["times"] = {str(list(shape)): dict(
            numbers(ts), event_ms=ts[0][1],
            library="F.scaled_dot_product_attention(enable_gqa)",
            shape=dict(zip(("B", "Sq", "Sk", "H", "KV", "hd", "causal"),
                           shape))) for shape, ts in t.items()}
        out["served_check"] = {n: i["flash_served_check"]
                               for n, i in rec["inputs"].items()}
    elif name == "dequant_gemm":
        out["served_shapes"] = t
        out["decoder_prefill_route"] = {
            i["decoder_prefill_rows"]: i["decoder_prefill_route"]
            for i in rec["inputs"].values()}
        out["served_check"] = rec["gemm_served_check"]
    else:
        out.update(numbers(t), event_ms=t[0][1], bc=ENCDEC_INPUTS[0][1],
                   launches_per_decode_step=rec[
                       "launches_per_decode_step"][name])
        out["library"] = {
            "fused_mlp": "gelu(x @ dequantize(w_up)) @ dequantize(w_down)",
            "fused_qkv": "x @ cat(dequantize(wq, wk, wv))",
            "cache_row_update": "cache[b, index] = row (index_put_)"}[name]
        if name == "fused_mlp":
            out["act"], out["gated"] = "gelu", False
    return out


# -- phase 11: training ----------------------------------------------------

class FlashBwdCalls:
    """Keeps flash backward launches of a training run (q, k, v, o, lse,
    do, causal and the kernel's gradients, by reference): every launch of
    step ``all_of``, the first of every other step.  ``step`` is set by
    ``StepFeed``; ``kernel.launch_flash_attention_backward`` is wrapped
    inside the ``with`` block."""

    def __init__(self, all_of=1):
        from repro_torch.kernels.flash_attention import kernel as FK
        self.mod, self.inner = FK, FK.launch_flash_attention_backward
        self.all_of, self.step = all_of, 0
        self.calls, self.per_step = [], {}

    def __call__(self, q, k, v, o, lse, do, *, causal):
        out = self.inner(q, k, v, o, lse, do, causal=causal)
        n = self.per_step.get(self.step, 0)
        self.per_step[self.step] = n + 1
        if self.step == self.all_of or n == 0:
            self.calls.append((self.step, q, k, v, o, lse, do, causal, out))
        return out

    def held(self, sm, what, f64_first=False):
        """Every kept call against the plain backward on its own inputs
        (``Smoke.flash_bwd_held``): calls by step, worst row ratio, max
        abs error; with ``f64_first`` the first call also against
        float64."""
        worst, err_max, by_step, f64 = 0.0, 0.0, {}, {}
        for i, (step, q, k, v, o, lse, do, causal, out) in enumerate(
                self.calls):
            w, err = sm.flash_bwd_held(
                q, k, v, o, lse, do, causal,
                f"{what} step {step} call at {tuple(q.shape)}", got=out,
                f64=f64 if (f64_first and i == 0) else None)
            worst, err_max = max(worst, w), max(err_max, err)
            by_step[step] = by_step.get(step, 0) + 1
        return {"held_calls_by_step": by_step,
                "worst_row_err_over_row_max": worst, "max_abs_err": err_max,
                "vs_float64_first_call": f64 or None,
                "tol": FLASH_BWD_TOL}

    def __enter__(self):
        self.mod.launch_flash_attention_backward = self
        return self

    def __exit__(self, *exc):
        self.mod.launch_flash_attention_backward = self.inner
        self.calls = []


class StepFeed:
    """The data iterator ``fit`` reads, one batch a step: each ``next``
    marks a step boundary (the launch counts so far, the step number of
    ``calls``)."""

    def __init__(self, it, calls):
        from repro_torch.kernels import launch_counts
        self.it, self.calls, self.counts = it, calls, launch_counts
        self.marks = []

    def __iter__(self):
        return self

    def __next__(self):
        self.marks.append(self.counts())
        self.calls.step += 1
        return next(self.it)

    def per_step(self):
        """Each step's launches (nonzero), from the marks and now."""
        marks = self.marks + [self.counts()]
        return [{k: b[k] - a[k] for k in b if b[k] - a[k]}
                for a, b in zip(marks, marks[1:])]


def train_step_flops(cfg, B, S):
    """Model FLOPs of one training step with remat: the projections and
    the head (2 a parameter a token forward, 4 backward, 2 again for the
    recomputed forward of every group and every head chunk), attention's
    two products (causal pairs) forward, recomputed, and the backward's
    five, and the vision projector's."""
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    layer = D * hd * (H + 2 * KV) + H * hd * D + 3 * D * F
    head = D * cfg.padded_vocab
    T = B * S
    mm = 2 * T * (cfg.n_layers * layer + head) * (1 + 2 + 1)
    attn = 2 * B * H * hd * causal_pairs(S, S) * cfg.n_layers * (2 + 2 + 5)
    vis = (2 * B * cfg.vision_tokens
           * (cfg.vision_feat_dim * D + D * D) * 3) if cfg.vlm else 0
    return mm + attn + vis


def causal_pairs(Sq, Sk):
    """(query, key) pairs a causal row set sees: key j <= query i."""
    return sum(min(i + 1, Sk) for i in range(Sq))


def grads_check(g_got, g_want, tol, what):
    """Each leaf's gradient within ``tol`` of the leaf's largest plain
    magnitude; returns {path: err/max} and the worst."""
    from repro_torch.tree import tree_leaves_with_path
    want = dict(tree_leaves_with_path(g_want))
    out = {}
    for path, g in tree_leaves_with_path(g_got):
        w = want[path].float()
        if g.shape != w.shape or not g.isfinite().all():
            fail(f"{what}: gradient of {path} has shape {tuple(g.shape)} "
                 f"or non-finite values")
        r = ((g.float() - w).abs().max() / w.abs().max()).item()
        if not r <= tol:
            fail(f"{what}: gradient of {path} err/max {r} > {tol}")
        out[path] = r
    return out, max(out.values())


def time_flash_backward(sm, shape, dtype):
    """The backward kernel, its plain version and SDPA's backward (GQA
    through ``enable_gqa``) at ``shape`` on the same inputs, and the
    work: (t_k, t_p, t_l, bytes, flops); t_k also carries each of the
    backward's device kernels' ms a launch (profiler)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import \
        ref_attention_backward
    B, Sq, Sk, H, KV, hd, causal = shape
    q = sm.randn(B, Sq, H, hd, dtype=dtype)
    k = sm.randn(B, Sk, KV, hd, dtype=dtype)
    v = sm.randn(B, Sk, KV, hd, dtype=dtype)
    do = sm.randn(B, Sq, H, hd, dtype=dtype)
    o, lse = FK.launch_flash_attention(q, k, v, causal=causal, want_lse=True)
    t_k = timed(lambda i: FK.launch_flash_attention_backward(
        q, k, v, o, lse, do, causal=causal), 1, iters=10)

    def ten():
        for _ in range(10):
            FK.launch_flash_attention_backward(q, k, v, o, lse, do,
                                               causal=causal)
        torch.cuda.synchronize()
    # each device kernel's mean ms a launch (D, dK/dV, dQ, the sum)
    t_k += ({re.search(r"flash_bwd_\w+", n).group(0): us / c / 1e3
             for n, us, c in device_time(ten)[1]
             if c and re.search(r"flash_bwd_\w+", n)},)
    t_p = timed(lambda i: ref_attention_backward(q, k, v, o, lse, do,
                                                 causal=causal), 1, iters=3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    ol = Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    t_l = timed(lambda i: torch.autograd.grad(ol, (qt, kt, vt), dot,
                                              retain_graph=True), 1,
                iters=10)
    byt = (q.element_size() * (4 * B * Sq * H * hd + 4 * B * Sk * KV * hd)
           + 4 * B * H * Sq)
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    fl = 5 * 2 * B * H * hd * pairs          # S, dV, dP, dQ, dK
    return t_k, t_p, t_l, byt, fl


def flash_bwd_geometry():
    """The backward kernels' grids at the training shape
    (FLASH_BWD_SHAPES[0]) in bf16 and fp32: the occupancy API's resident
    blocks an SM, registers and spills (``kernel.bwd_occupancy``), and
    ``kernel.bwd_geometry`` (blocks, tile pairs, the longest block and
    the mean, a resident slot's average and whether the longest walks at
    most half of it).  Needs no timing: phase 2 prints it."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    B, Sq, Sk, H, KV, hd, causal = FLASH_BWD_SHAPES[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"card": card_label(), "shape": list(FLASH_BWD_SHAPES[0]),
           "sms": sms}
    for dtype in (torch.bfloat16, torch.float32):
        occ = FK.bwd_occupancy(dtype, hd)
        out[str(dtype).replace("torch.", "")] = {
            "occupancy": occ,
            "geometry": FK.bwd_geometry(B, Sq, Sk, H, causal,
                                        {"dkdv": occ["dkdv_blocks_an_sm"],
                                         "dq": occ["dq_blocks_an_sm"]},
                                        sms=sms)}
    return out


def flash_bwd_times(timings):
    """The backward kernel at the training shape (phase 11's
    ``time_flash_backward`` tuples, ``timings["bwd"]`` and
    ``["bwd_f32"]``): ms a call and each device kernel's ms a launch
    beside the function's bound (five products at 989 TFLOP/s bf16, 67
    fp32 FFMA), the route's own (bf16: nine wgmma products at 989, dS in
    two terms; fp32: 33 TF32 products, S and dP (each twice) in six and
    dV, dK and dQ in three, at mma.sync's sustained 320.4), the plain
    version and SDPA's backward, with the grids (``flash_bwd_geometry``)."""
    out = flash_bwd_geometry()
    for key, name, rate, terms, route_rate in (
            ("bwd", "bfloat16", BF16_FLOPS_PER_S, 9, BF16_FLOPS_PER_S),
            ("bwd_f32", "float32", FP32_FLOPS_PER_S, 33,
             MMA_SYNC_TF32_FLOPS_PER_S)):
        t_k, t_p, t_l, byt, fl = timings[key]
        b_ms, b_by = bound(byt, fl, rate)
        r_ms, _ = bound(byt, fl / 5 * terms, route_rate)
        ms, sdpa = dev_or_call(t_k), dev_or_call(t_l)
        out[name].update(
            ms=ms, event_ms=t_k[1], device_kernels_per_call=t_k[2],
            kernel_ms_a_launch=t_k[3], bound_ms=b_ms, bound_by=b_by,
            route_bound_ms=r_ms, route_products=terms,
            plain_ms=dev_or_call(t_p), sdpa_backward_ms=sdpa,
            over_sdpa=ms / sdpa, over_bound=ms / b_ms)
    return out


def train_llava(sm):
    """Phase 11: LLaVA-OneVision-0.5B trained at full width and depth on
    the card (``attn_q_chunk=0``, remat, bf16), then a 2-layer fp32 step
    at full width; see the module docstring.  Returns (record, runs,
    timings)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import multimodal_batch_iter
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps as TS
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig, batch_to, fit
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("llava-onevision-0.5b"),
                              attn_q_chunk=0)
    if not cfg.remat or cfg.dtype != "bfloat16":
        fail(f"{TRAIN_PATH}: the config is not bf16 with remat")
    chunked = dataclasses.replace(cfg, attn_q_chunk=512)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    params = TS.init_params(cfg, device=sm.dev, seed=0)
    batch1 = batch_to(next(multimodal_batch_iter(cfg, B, S, seed=0)), sm.dev)
    if batch1["vision_feats"].shape[1] != 729:
        fail(f"{TRAIN_PATH}: vision tokens {batch1['vision_feats'].shape}")
    rec = {"shape": {"B": B, "S": S, "vision_tokens": cfg.vision_tokens,
                     "layers": cfg.n_layers, "d_model": cfg.d_model,
                     "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.hd,
                     "d_ff": cfg.d_ff, "vocab": cfg.padded_vocab},
           "opt": "OptConfig(lr=3e-4, warmup_steps=2, total_steps=8), "
                  "fp32 moments"}

    # step 1's gradients through the kernels against attn_q_chunk=512
    loss_k, _, g_k = TS.loss_and_grads(params, cfg, batch1)
    with plain_sums():
        loss_p, _, g_p = TS.loss_and_grads(params, chunked, batch1)
    rec["step1_grads_vs_chunked"] = dict(zip(("per_leaf", "worst"),
                                             grads_check(
        g_k, g_p, TRAIN_GRAD_TOL["bfloat16"], f"{TRAIN_PATH} step 1")),
        tol=TRAIN_GRAD_TOL["bfloat16"], loss_kernel=float(loss_k),
        loss_chunked=float(loss_p))
    del g_k, g_p
    free()

    # fit for TRAIN_STEPS steps, every launch counted, backward calls kept
    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    with FlashBwdCalls() as calls:
        feed = StepFeed(multimodal_batch_iter(cfg, B, S, seed=0), calls)
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fit(cfg, opt, TrainConfig(steps=TRAIN_STEPS, log_every=10 ** 9),
                  feed, params=params, log=lambda m: None, device=sm.dev)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts()
        per_step = feed.per_step()
        fit_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        held = calls.held(sm, TRAIN_PATH, f64_first=True)
    losses = [m["loss"] for m in res.metrics_history]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{TRAIN_PATH}: losses {losses} do not fall")
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention/wgmma": 2 * cfg.n_layers,
            "flash_attention/bwd": cfg.n_layers,
            "flash_attention/bwd_bf16": cfg.n_layers}
    for i, n in enumerate(per_step):
        if n != want:
            fail(f"{TRAIN_PATH}: step {i + 1} launched {n}, want {want}")
    walls = [m["dt"] for m in res.metrics_history]
    wall_ms = statistics.median(walls[1:]) * 1e3

    # one more step under the profiler: device time, the flash kernels';
    # the peak of its first run, with no backward call kept
    step_fn = TS.build_train_step(cfg, opt)
    from repro_torch.training.optimizer import init_opt
    st = init_opt(params, opt)
    free()
    torch.cuda.reset_peak_memory_stats()
    step_fn(params, st, batch1)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_us, rows, n_kernels = device_time(
        lambda: (step_fn(params, st, batch1), torch.cuda.synchronize()))
    fwd_us = sum(us for k, us, _ in rows if "flash_attention_kernel" in k)
    bwd_us = sum(us for k, us, _ in rows if "flash_bwd_" in k)
    del st
    free()
    flops = train_step_flops(cfg, B, S)
    dev_ms = dev_us / 1e3
    rec.update({
        "losses": losses, "grad_norms": [m["grad_norm"]
                                        for m in res.metrics_history],
        "lrs": [m["lr"] for m in res.metrics_history],
        "fit_s": fit_s, "step_wall_ms": [w * 1e3 for w in walls],
        "step_wall_ms_median_2_on": wall_ms,
        "step_device_ms": dev_ms if dev_us > 0 else None,
        "busy": dev_ms / wall_ms if dev_us > 0 else None,
        "device_kernels_a_step": n_kernels,
        "tokens_per_s": B * S / (wall_ms / 1e3),
        "model_flops_a_step": flops,
        "flops_per_s": flops / (wall_ms / 1e3),
        "flops_share_of_989T": flops / (wall_ms / 1e3) / BF16_FLOPS_PER_S,
        "ms_at_peak": flops / BF16_FLOPS_PER_S * 1e3,
        "peak_gb": peak_gb, "allocated_before_fit_gb": base_gb,
        "fit_peak_gb_with_held_calls": fit_peak_gb,
        "flash_fwd_ms_a_call": fwd_us / 1e3 / (2 * cfg.n_layers),
        "flash_bwd_ms_a_call": bwd_us / 1e3 / cfg.n_layers,
        "flash_fwd_share": fwd_us / dev_us if dev_us > 0 else None,
        "flash_bwd_share": bwd_us / dev_us if dev_us > 0 else None,
        "top_kernels_ms": [(k, us / 1e3, n) for k, us, n in rows[:12]],
        "launches_a_step": per_step, "launches_a_step_want": want,
        "flash_bwd_held": held})
    runs = {TRAIN_PATH: counts}
    del params, batch1, res, feed
    free()

    # a 2-layer fp32 step at full width: the tf32x3 forward, the fp32
    # backward, held the same way
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=TRAIN_FP32_LAYERS)
    params = TS.init_params(cfg32, device=sm.dev, seed=0)
    batch1 = batch_to(next(multimodal_batch_iter(cfg32, B, S, seed=0)),
                      sm.dev)
    with FlashBwdCalls() as calls:
        calls.step = 1
        reset_launch_counts()
        loss_k, _, g_k = TS.loss_and_grads(params, cfg32, batch1)
        torch.cuda.synchronize()
        counts32 = launch_counts()
        held32 = calls.held(sm, TRAIN_FP32_PATH, f64_first=True)
    want32 = {"flash_attention": 2 * TRAIN_FP32_LAYERS,
              "flash_attention/tf32x3": 2 * TRAIN_FP32_LAYERS,
              "flash_attention/bwd": TRAIN_FP32_LAYERS,
              "flash_attention/bwd_f32": TRAIN_FP32_LAYERS}
    got32 = {k: n for k, n in counts32.items() if n}
    if got32 != want32:
        fail(f"{TRAIN_FP32_PATH}: launched {got32}, want {want32}")
    loss_p, _, g_p = TS.loss_and_grads(params, dataclasses.replace(
        cfg32, attn_q_chunk=512), batch1)
    per_leaf, worst = grads_check(g_k, g_p, TRAIN_GRAD_TOL["float32"],
                                  TRAIN_FP32_PATH)
    rec["fp32_2_layer"] = {"grads_vs_chunked": {
        "per_leaf": per_leaf, "worst": worst,
        "tol": TRAIN_GRAD_TOL["float32"]},
        "loss_kernel": float(loss_k), "loss_chunked": float(loss_p),
        "launches": got32, "flash_bwd_held": held32}
    runs[TRAIN_FP32_PATH] = counts32
    del params, batch1, g_k, g_p
    free()

    # the backward kernel at the training shape beside its plain version
    # and SDPA's backward, bf16 and fp32; the forward at the same shape
    shape = (B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, True)
    timings = {"bwd": time_flash_backward(sm, shape, torch.bfloat16),
               "bwd_f32": time_flash_backward(sm, shape, torch.float32),
               "fwd": time_flash(sm, shape), "shape": shape}
    free()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, runs, timings


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
    from repro_torch.kernels.fused_decode import expert as EK
    from repro_torch.kernels.fused_decode import kernel as K
    from repro_torch.kernels.linear_attention import kernel as LK
    from repro_torch.kernels.ssd import kernel as SK
    libs = (K, EK, FK, SK, LK, DK, CK)

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
    sm.check_flash_backward()
    free()
    print(json.dumps({"flash_backward_geometry": flash_bwd_geometry()}))
    sm.check_cache_update(llava)
    sm.check_ssd()
    sm.check_linear_attention()
    # LLaVA's projections serve in fp32 too (the fp32 linear-attention
    # instance), Mamba-2's as well
    sm.check_dequant_gemm(((llava, (torch.bfloat16, torch.float32)),
                           (qwen, (torch.bfloat16,)),
                           (mamba, (torch.bfloat16, torch.float32))))
    free()
    sm.check_expert_gemm()
    free()
    sm.check_expert_gemv()
    free()
    print(json.dumps({"kernel_checks": {
        "fused_bc": {llava.name: [1, 2, 4, 8], qwen.name: [1, 2, 4]},
        "fp32": sm.fp32_check,
        "cache_row_update": sm.cu_check,
        "flash_shapes": [list(s) for s in FLASH_SHAPES],
        "flash_backward": sm.bwd_check,
        "ssd": sm.ssd_check,
        "dequant_gemm": sm.dg_check,
        "fused_mlp/experts": {"cases": sm.eg_check,
                              "tol": EXPERT_GEMV_TOL},
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
    first3, events3, dstate3 = {}, BrickEvents(), {}
    serve, eng, captured = serve_path(sm, llava, requests(
        llava, llava_reqs, seed=0), first_logits=first3, events=events3,
        decode_state=dstate3, staged=True)
    if serve["cohort_graph"]["buckets"] != [N_SLOTS]:
        fail(f"{llava.name}: phase 3 decoded at buckets "
             f"{serve['cohort_graph']['buckets']}, not [{N_SLOTS}]: its "
             f"requests were not admitted together")
    serve["prefill_breakdown"] = prefill_breakdown(eng, captured,
                                                   ("dequant_gemm",))
    print(json.dumps({"serve": serve}))
    serves[llava.name] = serve
    # -- 3e (on phase 3's engine): NVML energy windows, the measured
    # ledger and calibration table beside CUDA-event times ---------------
    nv = Nvml(sm.dev)
    try:
        energy = {"windows": energy_windows(sm, nv, eng, captured, dstate3)}
    finally:
        nv.shutdown()
    energy["calibration"] = served_calibration(
        sm, llava, eng, events3, int(requests(llava, llava_reqs, seed=0)[0]
                                     .tokens.shape[0]),
        serve["cohort_graph"]["capture_s"])
    ledger3 = eng.measured_ledger()
    del events3, dstate3
    timings[llava.name] = time_fused(sm, llava, eng)
    single = dict(serve, tokens={r.rid: list(r.out_tokens)
                                 for r in eng.done})
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
    serve["prefill_breakdown"] = prefill_breakdown(
        eng, captured, ("flash_attention", "dequant_gemm"))
    print(json.dumps({"serve": serve}))
    serves[FP32_PATH] = serve
    timings[FP32_PATH] = time_fused(sm, llava32, eng)
    del eng, captured
    free()

    # -- 3c. the same requests through disaggregated prefill and decode
    # fleets on the one card, then through the pipe launcher -------------
    disagg = serve_disagg(sm, llava, requests(llava, llava_reqs, seed=0),
                          single)
    print(json.dumps({"serve": disagg}))
    free()

    # -- 3d. phase 3's first request through the placed plan and the
    # On-Demand Cascade on the card, its requests through an engine with
    # the placement -----------------------------------------------------
    placed, placed_runs = placed_and_cascade(
        sm, llava, requests(llava, llava_reqs, seed=0), first3)
    print(json.dumps({"placement_cascade": placed}))
    del first3
    free()

    # -- 3e. the measured-energy loop: an engine under the decode window's
    # energy pressure, the launcher's --calibration loop, the fleet
    # simulator on the card's J/token, phase 3's requests under
    # nanomind-sparse ----------------------------------------------------
    fleet = start_fleet(energy["windows"], ledger3)
    energy["pressure"], pressure_n = pressure_engine(
        sm, llava, requests(llava, llava_reqs, seed=0), energy["windows"])
    energy["calibration_launcher"] = calibration_launcher()
    energy["fleet"] = finish_fleet(fleet)
    print(json.dumps({"energy_loop": energy}))
    serve = sparse_serve(sm, llava, requests(llava, llava_reqs, seed=0),
                         serves[llava.name])
    print(json.dumps({"serve": serve}))
    serves[SPARSE_PATH] = serve
    del ledger3, fleet
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
    serve["decode_step_breakdown"] = composed_decode_breakdown(eng)
    serve["softmax_kv_pool_mb"] = serves[llava.name]["kv_pool_mb"]
    del eng, run
    free()
    linear32 = dataclasses.replace(linear, dtype="float32")
    serve32, eng, run = serve_linear(sm, linear32, requests(
        linear32, llava_reqs, seed=0))
    serve["fp32"] = {k: serve32[k] for k in (
        "prefill_calls", "prefill_ms", "decode_tok_s",
        "decode_tok_s_excl_capture", "launches",
        "linear_served_check", "gemm_served_check", "cohort_graph",
        "served_vs_eager", "peak_mem_gb")}
    serve["fp32"]["checks"] = linear_checks(sm, linear32, eng, run, STEP_TOL)
    serve["fp32"]["prefill_breakdown"] = prefill_breakdown(
        eng, max(run[1], key=lambda g: g[0].numel()),
        ("la_", "dequant_gemm"))
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
    serve["decode_step_breakdown"] = composed_decode_breakdown(eng)
    del eng, run
    free()
    mamba32 = dataclasses.replace(mamba, dtype="float32")
    serve32, eng, run = serve_mamba(sm, mamba32)
    serve["fp32"] = {k: serve32[k] for k in (
        "prefill_calls", "prefill_ms", "decode_tok_s",
        "decode_tok_s_excl_capture", "launches",
        "ssd_served_check", "gemm_served_check", "cohort_graph",
        "served_vs_eager", "peak_mem_gb")}
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
    la32_t = time_linear(sm, torch.float32)
    dg_t = time_dequant_gemm(sm)
    gemm_rows = time_gemm_shapes(sm, (qwen, llava, mamba))
    gemm32_rows = time_gemm_shapes(sm, (llava,), torch.float32)
    print(json.dumps({"gemm_shapes": gemm_rows + gemm32_rows}))
    expert_ts = {name: time_expert_gemm(sm, shape)
                 for name, shape in EXPERT_TIMES.items()}
    expert_gemv_ts = {arch: time_expert_gemv(sm, arch)
                      for arch in EXPERT_GEMV}
    ssd128_t = time_ssd(sm, shape=SSD_P128_SHAPE)
    flash_jamba_t = time_flash(sm, FLASH_JAMBA_SHAPE)
    free()

    # -- 8. DeepSeek-MoE-16B at full width and depth, the experts through
    # the packed-weight GEMM's expert axis; the dense configs and DBRX at
    # full width and DENSE_LAYERS layers -----------------------------------
    moe_serves = serve_moe_and_dense(sm)

    # -- 9. Jamba-1.5-Large at full width and one group of 8 sublayers:
    # Mamba-2 and attention sublayers in one pool, the experts' decode
    # through the routed experts' GEMV ------------------------------------
    moe_serves[HYBRID_PATH] = serve_hybrid(sm)

    # -- 10. seamless-m4t-large-v2 at full width and depth: audio frames ->
    # encoder -> cross-attending prefill -> greedy decode through the step
    # builders; the brick chain resident and as the On-Demand Cascade ----
    encdec, encdec_runs, encdec_t = serve_encdec(sm)
    print(json.dumps({"serve": encdec}))
    free()

    # -- 11. train LLaVA-OneVision-0.5B at full width and depth: attention
    # forward and backward through the flash kernels, AdamW, the data
    # pipeline; then a 2-layer fp32 step --------------------------------
    train, train_runs, train_t = train_llava(sm)
    print(json.dumps({"train": train}))
    print(json.dumps({"flash_backward_times": flash_bwd_times(train_t)}))

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
    runs[DISAGG_PATH] = disagg["launches"]
    runs.update(placed_runs)
    runs[ENERGY_PATH] = pressure_n
    records.update(moe_serves)
    runs.update({a: r["launches"] for a, r in moe_serves.items()})
    records[ENCDEC_PATH] = encdec
    runs.update(encdec_runs)
    runs.update(train_runs)

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

    def in_graph(key):
        """Kernel ``key`` inside each serve's decode step: ms a launch and
        launches a step in the graph replay, beside the eager step's."""
        out = {}
        for a, r in serves.items():
            bd = r.get("decode_step_breakdown")
            if not bd or not bd["graph"]["kernels_ms_launches"][key][1]:
                continue
            out[a] = {}
            for way in ("graph", "eager"):
                ms, n = bd[way]["kernels_ms_launches"][key]
                out[a][way] = {"ms_a_launch": ms / max(1, n),
                               "launches_a_step": n}
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
                name, la_t[:4], ("B", "S", "H", "KV", "hd", "chunk"), LA_SHAPE,
                LINEAR_PATH, serves[LINEAR_PATH]["linear_served_check"]))
            tile_ops = linear_attention_tile_ops(*LA_SHAPE)
            entry["flops_of_kernel_form"] = tile_ops
            r_ms, r_by = bound(la_t[2], linear_attention_route_flops(
                *LA_SHAPE, v_terms=2), TF32_FLOPS_PER_S)
            entry.update(event_ms=la_t[0][1], phases_ms=la_t[4],
                         route="cuda", launches_by_route={"tf32x3": entry[
                             "launches"]},
                         bound_ms_tf32x3_route=r_ms,
                         bound_by_tf32x3_route=r_by)
            entry["bound_note"] = (
                "bound_ms at the fp32 FFMA peak (67 TFLOP/s): the kernel's "
                "contract is fp32 arithmetic; operations of the recurrent "
                "form, as linear_attention_work counts them; "
                "flops_of_kernel_form counts the kernel's 64-row tiles; "
                "bound_ms_tf32x3_route the route's own count of their "
                "products at 495 TFLOP/s dense TF32: three TF32 products "
                "each, two for those against v in bf16 (the fp32 entry: "
                "three throughout), the FFMA rest left out")
            r32_ms, r32_by = bound(la32_t[2], linear_attention_route_flops(
                *LA_SHAPE, v_terms=3), TF32_FLOPS_PER_S)
            entry["fp32"] = dict(
                fp32_numbers(name, la32_t[:4], ("B", "S", "H", "KV", "hd",
                                                "chunk"), LA_SHAPE,
                             LINEAR_PATH, serves[LINEAR_PATH]["fp32"][
                                 "linear_served_check"]),
                event_ms=la32_t[0][1], phases_ms=la32_t[4],
                bound_ms_tf32x3_route=r32_ms, bound_by_tf32x3_route=r32_by,
                inputs="float32 q, k, v")
            entry["fp32"]["launches_per_prefill_call"] = (
                serves[LINEAR_PATH]["fp32"]["launches"]["linear_attention"]
                / serves[LINEAR_PATH]["fp32"]["prefill_calls"])
        elif name == "dequant_gemm":
            entry.update(numbers(dg_t))
            entry["event_ms"] = dg_t[0][1]
            entry["launches_by_route"] = by_route(
                name, dict(GEMM_ROUTE, bf16_outside_wgmma_rule="tile"))
            entry["served_shapes"] = gemm_rows
            # the fp32 instance at LLaVA's up / gate projection, the
            # largest of the fp32 serves' shapes, and at all five
            up32 = next(r for r in gemm32_rows if r["proj"] == "up / gate")
            entry["fp32"] = {
                "route": GEMM_ROUTE["float32"],
                "shape": {k: up32[k] for k in ("M", "K", "N")},
                "ms": up32["ms"], "event_ms": up32["event_ms"],
                "bound_ms": up32["bound_ms"], "bound_by": up32["bound_by"],
                "bound_ms_tf32x3_route": up32["bound_ms_tf32x3_route"],
                "bound_by_tf32x3_route": up32["bound_by_tf32x3_route"],
                "library_ms": up32["dequantize_matmul_ms"],
                "plain_ms": up32["dequantize_matmul_ms"],
                "library": "dequantize + torch.matmul, fp32 (TF32 off)",
                "dense_matmul_ms": up32["dense_matmul_ms"],
                "bound_note": ("bound_ms at the fp32 FFMA peak (67 "
                               "TFLOP/s); bound_ms_tf32x3_route: the "
                               "route's own count, three TF32 products at "
                               "495 TFLOP/s dense"),
                "served_shapes": gemm32_rows,
                "prefill_breakdown": {
                    FP32_PATH: serves[FP32_PATH]["prefill_breakdown"],
                    f"{LINEAR_PATH}/fp32": serves[LINEAR_PATH]["fp32"][
                        "prefill_breakdown"]}}
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
            # the expert axis: the MoE's contractions, one launch over
            # every expert (row 4's expert instance)
            entry["experts"] = {
                "launches": sum(n["dequant_gemm/experts"]
                                for n in runs.values()),
                "launches_by_path": {
                    a: n["dequant_gemm/experts"] for a, n in runs.items()
                    if n["dequant_gemm/experts"]},
                "launches_per_prefill_call": {
                    a: r["launches"]["dequant_gemm/experts"]
                    / r["prefill_calls"] for a, r in moe_serves.items()
                    if r["launches"]["dequant_gemm/experts"]},
                "library": "dequantize + torch.matmul (batched over E)",
                "tma": "one 3-D tensor map each for x and the codes, the "
                       "expert their outermost dimension",
                "checks": sm.dg_check["experts"],
                "times": {name: dict(
                    numbers(t), event_ms=t[0][1],
                    dense_matmul_ms=dev_or_call(t[3]),
                    shape=dict(zip(("G", "E", "C", "K", "N"),
                                   EXPERT_TIMES[name]), bits=4, group=32,
                               dtype="bfloat16"))
                    for name, t in expert_ts.items()}}
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
            entry["in_cohort_graph"] = in_graph("cache_row_update")
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
                    a: serves[a]["decode_step_breakdown"]["graph"][
                        "device_ms"]
                    for a in (llava.name, FP32_PATH, qwen.name)}
            if name == "kv_row_scatter":
                entry["in_cohort_graph"] = in_graph("kv_row_scatter")
            entry["shape_of"] = llava.name
            entry["at_" + qwen.name] = numbers(timings[qwen.name][name])
            entry["fp32_at_" + llava.name] = numbers(
                timings[FP32_PATH][name], FP32_FLOPS_PER_S)
            if name != "kv_row_scatter":
                entry["fp32_checks"] = {
                    a: c["worst_err_over_max"].get(name)
                    for a, c in sm.fp32_check.items() if "bc" in c}
        if name == "ssd":
            entry["at_" + HYBRID_PATH] = dict(
                fp32_numbers(name, ssd128_t[:4], ("B", "S", "H", "P", "G",
                                                  "N", "chunk"),
                             SSD_P128_SHAPE, mamba.name,
                             moe_serves[HYBRID_PATH]["ssd_served_check"]),
                event_ms=ssd128_t[0][1], phases_ms=ssd128_t[4],
                bound_ms_mma_route=ssd_mma_bound(*SSD_P128_SHAPE)[0],
                launches=sum(n["ssd"] for a, n in runs.items()
                             if a == HYBRID_PATH))
            entry["at_" + HYBRID_PATH].pop("launches_per_prefill_call")
        if name == "flash_attention":
            entry["at_" + HYBRID_PATH] = dict(
                numbers(flash_jamba_t), event_ms=flash_jamba_t[0][1],
                shape=dict(zip(("B", "Sq", "Sk", "H", "KV", "hd", "causal"),
                               FLASH_JAMBA_SHAPE)),
                launches=runs[HYBRID_PATH]["flash_attention"],
                served_check=moe_serves[HYBRID_PATH].get(
                    "flash_served_check"))
        if name in encdec_t:
            entry["at_" + ENCDEC_PATH] = at_encdec(
                name, encdec, encdec_runs, encdec_t[name], numbers)
        kernels.append(entry)
    # the routed experts' GEMV of a decode step: fused_mlp_pallas with an
    # expert axis, its main numbers at DeepSeek-MoE-16B's widths
    by_path = {a: n["fused_mlp/experts"] for a, n in runs.items()
               if n["fused_mlp/experts"]}
    eg = expert_gemv_ts["deepseek-moe-16b"][0]
    entry = {"name": "fused_mlp/experts", "route": "cuda",
             "source": "src/repro_torch/csrc/expert_gemv.cu",
             "replaces": "src/repro/kernels/fused_decode/kernel.py:138",
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": sm.errs["fused_mlp/experts"]}
    entry.update(numbers(eg))
    entry.update(
        ms_source=EXPERT_MS_SOURCE,
        event_ms=eg[0][1], bc=TIME_BC, shape_of="deepseek-moe-16b",
        library="the routed (row, choice) pairs' experts gathered, "
                "dequantized and run through batched torch.bmm",
        bound_note="bytes: the routed experts' codes and scales read once, "
                   "h and the output, at 3.35 TB/s",
        launches_per_decode_step={
            a: r["launches"]["fused_mlp/experts"] / r["decode_steps"]
            for a, r in records.items()
            if r["launches"].get("fused_mlp/experts")},
        served_check={a: r["expert_served_check"]
                      for a, r in records.items()
                      if "expert_served_check" in r},
        kernel_checks=sm.eg_check,
        device_kernels_a_call=list(EK.EXPERT_KERNELS),
        times={arch: dict(numbers(t), ms_source=EXPERT_MS_SOURCE,
                          event_ms=t[0][1],
                          routed_experts=n_routed,
                          by_cohort=cohorts,
                          shape=dict(zip(("E", "top_k", "D", "F"),
                                         EXPERT_GEMV[arch]),
                                     bc=TIME_BC, bits=4, group=32,
                                     dtype="bfloat16"))
               for arch, (t, n_routed, cohorts) in expert_gemv_ts.items()},
        decode_step_device_ms={
            a: {k: r["decode_step_breakdown"]["graph"][v]
                for k, v in (("now", "device_ms"), ("tok_s_now", "tok_s"))}
            for a, r in records.items()
            if "decode_step_device_ms_vs_before" in r})
    if entry["launches"] <= 0:
        fail("fused_mlp/experts: no launch on the served paths")
    kernels.append(entry)
    # the flash backward (the gradient of flash_attention_pallas, which
    # has none in the reference: its training differentiates the dense
    # attention off the TPU), timed at phase 11's training shape
    by_path = {a: n["flash_attention/bwd"] for a, n in runs.items()
               if n["flash_attention/bwd"]}
    bt, bt32 = train_t["bwd"], train_t["bwd_f32"]
    shape = dict(zip(("B", "Sq", "Sk", "H", "KV", "hd", "causal"),
                     train_t["shape"]))
    entry = {"name": "flash_attention/bwd", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:55",
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "launches_by_route": {r: sum(n[f"flash_attention/{r}"]
                                          for n in runs.values())
                                   for r in ("bwd_bf16", "bwd_f32")},
             "max_abs_err": sm.errs["flash_attention/bwd"]}
    entry.update(numbers(bt[:3] + (None,) + bt[3:]))
    entry.update(
        event_ms=bt[0][1], kernel_ms_a_launch=bt[0][3], shape=shape,
        library="torch.autograd.grad of F.scaled_dot_product_attention"
                "(enable_gqa), the backward alone",
        bound_note="five products (S, dV, dP, dQ, dK) over the causal "
                   "pairs at 989 TFLOP/s bf16; the kernel runs nine on "
                   "wgmma (S and dP again for dQ, dS in two bf16 terms "
                   "for dQ and dK), fp32 seven in 33 split-TF32 products "
                   "on mma.sync",
        launches_per_train_step=train["launches_a_step"][0].get(
            "flash_attention/bwd"),
        kernel_checks=sm.bwd_check,
        served_check={TRAIN_PATH: train["flash_bwd_held"],
                      TRAIN_FP32_PATH: train["fp32_2_layer"][
                          "flash_bwd_held"]},
        forward_at_training_shape=dict(numbers(train_t["fwd"]),
                                       event_ms=train_t["fwd"][0][1]),
        fp32=dict(numbers(bt32[:3] + (None,) + bt32[3:], FP32_FLOPS_PER_S),
                  event_ms=bt32[0][1], kernel_ms_a_launch=bt32[0][3],
                  library="the same, fp32 (TF32 off)"))
    if entry["launches"] <= 0:
        fail("flash_attention/bwd: no launch on the training paths")
    kernels.append(entry)
    print(smi.stdout.strip())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

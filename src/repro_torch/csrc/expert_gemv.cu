// The routed experts' GEMV of a decode step, for Hopper (sm_90a).
//
// Replaces fused_mlp_pallas (src/repro/kernels/fused_decode/kernel.py)
// with an expert axis: the reference's MoE decode runs its experts through
// the dense MLP of each routed expert.  For a cohort h (bc <= 8, D), the
// router's top-k experts idx (bc, k), their gates (bc, k) fp32 and a row
// mask valid (bc,):
//
//   out[r] = rt(sum_j rt(g_rj) * rt(down_e(mid_re))),  e = idx[r, j],
//   mid_re = rt(rt(act(rt(gate_e(h_r)))) * rt(up_e(h_r)))
//            (ungated: rt(act(rt(up_e(h_r))))),
//
// summed in fp32 in choice order; an invalid row gets 0; rt rounds to the
// activations' dtype T (bf16 or fp32).  W is (E, K, N) per expert: packed
// int32 codes along N (q4 or q8, field j of a word at bit j*BITS) with one
// fp32 scale per group of N, or dense T.  A (row, choice) is a pair p =
// r * k + j; the pairs of one row that chose one expert share its
// "canonical" pair (the first of them): up, gate, mid and y are computed
// once per (expert, row), a row choosing an expert twice adds its y twice.
//
// Arithmetic.  Each product is fl(x * s) * code, fused into the fp32 sum
// (the group's scale folded into x once per row, group and K row, instead
// of rounding every weight code * scale to T as the reference's
// dequantize does); dense weights x * w.  The sums run in the order of the
// launch plan (kernels/fused_decode/expert.py expert_plan): each thread
// walks its K rows k0 + sub + s nsub in turn, a CTA adds its sub-rows in
// order, and the K splits are added in split order.  Then up, gate, mid,
// y and the gated sum round as above.  ref.emulate_fused_mlp_experts
// repeats this order on the CPU.
//
// What bounds it on an H100.  At bc <= 8 each routed expert's weights are
// read once for at most 8 rows (2 flops a weight a row): device-memory
// bytes.  At cohort 4, q4 g32 (0.625 bytes a weight with its scales),
// DeepSeek-MoE-16B's 20 routed experts are 108 MB (0.032 ms at 3.35
// TB/s), Jamba-1.5-Large's 6 are 2.26 GB (0.676 ms).  Jamba's 3.62 G
// weights leave about 6 instructions a weight at the card's issue rate,
// so the dequantize must be cheap too.
//
// What the design does about it.
//   - Two device kernels a call: expert_up_kernel (up and gate, the
//     activation into mid) and expert_down_kernel (down, the gated sum
//     into out).  Grid (column tiles, routed slots, K splits) from
//     (bc, k, E, D, F) alone (the CUDA graphs capture it): the slots are
//     min(bc k, E), the most experts the cohort can route.  Each CTA
//     lists the routed experts in order of first choice with one warp
//     (each lane a pair, its first occurrence found against the earlier
//     pairs, ranks by ballot), takes slot blockIdx.y's expert and the rows
//     that chose it, and exits before any load when the slot is past the
//     routed count: no code of an unrouted expert is read.
//   - 16-byte loads through a shared-memory ring, as gemv_kernel: a
//     thread owns one uint4 of codes (32 q4 outputs, one g32 group, one
//     scale; q8 16 outputs; dense 8 bf16 or 4 fp32) and walks the CTA's K
//     rows through a 16-stage cp.async ring, 15 vectors in flight (30 KB
//     a CTA, 90 KB an SM at three CTAs), issued before the CTA stages its
//     activations; a CTA's 128 threads are 8, 16 or 32 vector columns by
//     16, 8 or 4 K sub-rows, a warp reading whole 128-byte lines.  The
//     gated stage's columns are half up, half the matching gate columns.
//   - Fewer instructions a weight: a word's sign bits flipped once, its
//     two 16-bit halves give their fields as exact floats with one LOP3
//     (mask, 2^23 exponent) and one FADD each, the field's position
//     folded into x * s * 2^-(BITS j) (exact); with the scale folded into
//     x, the q4 loop (unrolled twice) is 286 instructions for 64 weights
//     at one row, 4.5 a weight with its FFMA (about 7 in the four-kernel
//     GEMV it replaced, counted from its source), 364 at two rows
//     (cuobjdump, scripts/expert_gemv_bench.py).  An expert's rows run in
//     passes of 1, 2 or 4 (a template on the count), so a lone row pays
//     one FFMA a weight, not four.
//   - The reductions in the same launch: a CTA's partial tile goes to an
//     fp32 scratch (pair, column) when K is split; the last of the K
//     splits' CTAs of its (slot, tile) to arrive (an integer counter)
//     adds them in split order and runs the epilogue (the activation into
//     mid, or y rounded to T); in the down stage the last of the routed
//     slots of a tile to arrive then sums each valid row's choices, in
//     order, with their gates.  The counters are zero before a launch and
//     left zero (each reset by its last arrival).  No float atomics:
//     results are bit-identical from run to run.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py, bf16 q4 g32,
// cohort 4, a CUDA graph of 8 calls over rotating routings): 0.0923 ms at
// DeepSeek-MoE-16B's widths (36.5 % of the 0.0337 ms bytes bound; the
// four-kernel GEMV it replaced: 0.2635), 0.633 at DBRX's (62 %; 1.540),
// 0.978 at Jamba's (75 %; 2.359).  DeepSeek's call is one wave of ~2.7
// CTAs an SM, bound by issue (11 warps an SM) and each CTA's fixed
// latencies (routing, staging, the split and gated sums), not by bytes.
//
// Interface: a plain C entry point (loaded with ctypes); it launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_math.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxRows = 8;     // cohort rows a launch
constexpr int kMaxPairs = 64;   // rows x choices a launch
constexpr int kThreads = 128;
constexpr int kRing = 16;       // cp.async ring stages: vectors in flight a thread
constexpr int kMaxKc = 1024;    // K rows a CTA (its activations in shared memory)
constexpr int kMaxR = 4;        // an expert's rows a pass

struct ExpertArgs {
  const void* x;          // up stage: h (bc, K) T; down stage: mid (P, K) T by pair
  const void* w[2];       // per segment: codes (E, K, N / PW) int32, or dense (E, K, N) T
  const float* sc[2];     // (E, K, N / group) fp32; null when dense
  int group;
  const int32_t* idx;     // (bc, k)
  const int32_t* valid;   // (bc,)
  const float* gates;     // (bc, k) fp32
  float* partial;         // (ks, P, nseg, N) fp32 when ks > 1
  float* y;               // down stage: (P, N) fp32 by pair, each rounded to T
  void* out;              // up stage: mid (P, N) T by pair; down stage: out (bc, N) T
  unsigned* counters;     // slots x tiles (+ tiles in the down stage)
  int bc, k, K, N, nseg, act;
  int ts, kc, ks;         // vector columns a CTA, K rows a CTA, K splits
};

// one stage's routing, listed by warp 0 of each CTA
struct Route {
  int n_routed;                   // experts some valid row chose
  int expert;                     // slot blockIdx.y's, or -1
  int nrows;                      // rows that chose it, in order:
  int row[kMaxRows];              //   the row
  int pair[kMaxRows];             //   and its canonical pair
  int vals[kMaxPairs];            // each pair's expert (-1: an invalid row's)
  int canon[kMaxPairs];           // each pair's canonical pair (-1: invalid)
};

__device__ __forceinline__ void route(const ExpertArgs& a, int slot, Route& rt) {
  const int lane = threadIdx.x;
  const int P = a.bc * a.k;
  int chosen[2] = {-1, -1}, ok[2] = {0, 0};   // both pairs' loads in flight at once
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane + 32 * h < P) {
      chosen[h] = a.idx[lane + 32 * h];
      ok[h] = a.valid[(lane + 32 * h) / a.k];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) rt.vals[lane + 32 * h] = ok[h] ? chosen[h] : -1;
  __syncwarp();
  bool lead[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = lane + 32 * h, v = rt.vals[p];
    int first = p, canon = v >= 0 ? p : -1;
    if (v >= 0) {
      for (int q = 0; q < p; ++q)
        if (rt.vals[q] == v) { first = q; break; }
      for (int q = p / a.k * a.k; q < p; ++q)
        if (rt.vals[q] == v) { canon = q; break; }
    }
    lead[h] = v >= 0 && first == p;
    rt.canon[p] = canon;
  }
  const unsigned b0 = __ballot_sync(~0u, lead[0]), b1 = __ballot_sync(~0u, lead[1]);
  const unsigned lt = (1u << lane) - 1u;
  if (lane == 0) {
    rt.n_routed = __popc(b0) + __popc(b1);
    rt.expert = -1;
  }
  __syncwarp();
  if (lead[0] && __popc(b0 & lt) == slot) rt.expert = rt.vals[lane];
  if (lead[1] && __popc(b0) + __popc(b1 & lt) == slot) rt.expert = rt.vals[lane + 32];
  __syncwarp();
  const int e = rt.expert;
  int c = -1;
  if (lane < a.bc && e >= 0)
    for (int j = 0; j < a.k; ++j)
      if (rt.vals[lane * a.k + j] == e) { c = lane * a.k + j; break; }
  const unsigned rows = __ballot_sync(~0u, c >= 0);
  if (c >= 0) {
    const int pos = __popc(rows & lt);
    rt.row[pos] = lane;
    rt.pair[pos] = c;
  }
  if (lane == 0) rt.nrows = __popc(rows);
}

// (w & m) | 2^23's exponent bits in one LOP3
__device__ __forceinline__ uint32_t mask_or_magic(uint32_t w, uint32_t m) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(w), "r"(m), "r"(0x4B000000u));
  return r;
}

template <int BITS, typename T>
struct EVec {
  static constexpr int V = BITS ? 128 / BITS : 16 / (int)sizeof(T);  // outputs a vector
  static constexpr int PW = BITS ? 32 / BITS : 1;                     // codes a word
};

// byte offsets of the dynamic shared memory: the ring of code vectors
// [kRing][threads] (after the K loop, the CTA's partial tile [kMaxR][ts]
// [V] in its first bytes) and scales [kRing][threads][NS], and the
// activations [kMaxR][kcp] (after the K loop, the sub-row reduction
// [threads][V + 4] in the same bytes)
template <int BITS, typename T, int NS>
struct ExpSmem {
  int sring, hs, total;
  __host__ __device__ explicit ExpSmem(const ExpertArgs& a) {
    constexpr int V = EVec<BITS, T>::V;
    static_assert(kMaxR * 32 * V * 4 <= kRing * kThreads * 16, "the partial tile fits the ring");
    const int nsub = kThreads / a.ts;
    const int kcp = (a.kc + nsub - 1) / nsub * nsub;
    const int hs_b = kMaxR * kcp * 4, red_b = kThreads * (V + 4) * 4;
    sring = kRing * kThreads * 16;
    hs = sring + kRing * kThreads * NS * 4;
    total = hs + ((hs_b > red_b ? hs_b : red_b) + 15) / 16 * 16;
  }
};

// the up stage's epilogue: mid of canonical pair `pair`, outputs col..col+3
// (act < 0 never here); the down stage's first: y rounded to T
template <int STAGE, typename T>
__device__ __forceinline__ void epilogue4(const ExpertArgs& a, int pair, int col, const float* up,
                                          const float* gate) {
  if constexpr (STAGE == 1) {
    T* mid = static_cast<T*>(a.out) + (size_t)pair * a.N + col;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m =
          a.nseg == 2
              ? __fmul_rn(round_t<T>(act_fn(a.act, round_t<T>(gate[i]))), round_t<T>(up[i]))
              : act_fn(a.act, round_t<T>(up[i]));
      mid[i] = from_f<T>(m);
    }
  } else {
    *reinterpret_cast<float4*>(a.y + (size_t)pair * a.N + col) = make_float4(
        round_t<T>(up[0]), round_t<T>(up[1]), round_t<T>(up[2]), round_t<T>(up[3]));
  }
}

// The CTA's GEMV: the slot's expert over the tile's columns and the
// split's K rows, for the expert's rows in passes of R; thread (slot,
// sub) owns vector `slot` of the tile and K rows k0 + sub + s nsub.  Each
// pass's sums go to the epilogue (one split) or to the scratch.
template <int STAGE, int BITS, typename T, int NS, int R>
__device__ __forceinline__ void expert_passes(const ExpertArgs& a, const Route& rt,
                                              unsigned char* smem) {
  constexpr int V = EVec<BITS, T>::V, PW = EVec<BITS, T>::PW;
  const ExpSmem<BITS, T, NS> L(a);
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* sring = reinterpret_cast<float*>(smem + L.sring);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* red = hs;
  float* part = reinterpret_cast<float*>(smem);   // the ring's bytes, after the K loop

  const int tid = threadIdx.x, ts = a.ts, nsub = kThreads / ts;
  const int slot = (tid & 31) % ts, sub = (tid & 31) / ts + (32 / ts) * (tid >> 5);
  const int sps = ts / a.nseg;                 // vector columns a segment
  const int nvec = a.N / V;
  const int seg = slot < sps ? 0 : 1;
  const int vec = blockIdx.x * sps + slot % sps;
  const bool valid = vec < nvec;
  const int k0 = blockIdx.z * a.kc, kn = max(0, min(a.kc, a.K - k0));
  const int steps = (a.kc + nsub - 1) / nsub, kcp = steps * nsub;
  const int P = a.bc * a.k;

  // the thread's first K row (sub) of its vector and scales; each stage
  // of the ring is nsub rows on (issue takes the stages in order, a
  // running pointer each)
  const void* const wbase = a.w[seg];
  const float* const sbase = a.sc[seg];
  const int ng = BITS ? a.N / a.group : 0;
  const size_t row0 = (size_t)rt.expert * a.K + k0 + sub;
  const uint4* const w0 = static_cast<const uint4*>(wbase) + row0 * nvec + vec;
  const float* const s0 = BITS ? sbase + row0 * ng + (size_t)vec * V / a.group : nullptr;
  const size_t wstep = (size_t)nsub * nvec, sstep = (size_t)nsub * ng;
  int sidx[NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) sidx[q] = BITS ? (vec * V + q * (V / NS)) / a.group - vec * V / a.group : 0;
  const uint4* wp = w0;
  const float* sp = s0;
  int kk = sub;

  auto issue = [&](int s) {
    if (s < steps) {
      const bool ok = valid && kk < kn;
      const int r = (s % kRing) * kThreads + tid;
      hopper::cp_async16_zfill(ring + r, ok ? wp : wbase, ok);
      if constexpr (BITS != 0) {
#pragma unroll
        for (int q = 0; q < NS; ++q)
          hopper::cp_async4_zfill(sring + r * NS + q, ok ? sp + sidx[q] : sbase, ok);
      }
      wp += wstep;
      sp += sstep;
      kk += nsub;
    }
    hopper::cp_async_commit();
  };

  const T* xg = static_cast<const T*>(a.x);
  const int passes = (rt.nrows + R - 1) / R;
  for (int pass = 0; pass < passes; ++pass) {
    const int rows = min(R, rt.nrows - pass * R);
    __syncthreads();                    // the previous pass has read red and part
    wp = w0;
    sp = s0;
    kk = sub;
    for (int s = 0; s < kRing - 1; ++s) issue(s);   // the codes need no x
    constexpr int kX = 8;               // the activations' loads in flight a thread
    for (int i0 = tid; i0 < R * kcp; i0 += kX * kThreads) {
      float v[kX];
#pragma unroll
      for (int u = 0; u < kX; ++u) {
        const int i = i0 + u * kThreads, b = i / kcp, kx = i - b * kcp;
        v[u] = 0.f;
        if (i < R * kcp && b < rows && kx < kn) {
          const int xr = STAGE == 1 ? rt.row[pass * R + b] : rt.pair[pass * R + b];
          v[u] = to_f(xg[(size_t)xr * a.K + k0 + kx]);
        }
      }
#pragma unroll
      for (int u = 0; u < kX; ++u)
        if (i0 + u * kThreads < R * kcp) hs[i0 + u * kThreads] = v[u];
    }
    float acc[R][V];
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[b][j] = 0.f;
    __syncthreads();                    // the activations are staged
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      issue(s + kRing - 1);
      hopper::cp_async_wait<kRing - 1>();
      const int r = (s % kRing) * kThreads + tid;
      const uint4 v = ring[r];
      float hv[R];
#pragma unroll
      for (int b = 0; b < R; ++b) hv[b] = hs[b * kcp + sub + s * nsub];
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      if constexpr (BITS == 0) {
        if constexpr (sizeof(T) == 2) {
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
            const float w0 = __uint_as_float(words[wi] << 16);
            const float w1 = __uint_as_float(words[wi] & 0xFFFF0000u);
#pragma unroll
            for (int b = 0; b < R; ++b) {
              acc[b][2 * wi] = fmaf(hv[b], w0, acc[b][2 * wi]);
              acc[b][2 * wi + 1] = fmaf(hv[b], w1, acc[b][2 * wi + 1]);
            }
          }
        } else {
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
            const float w = __uint_as_float(words[wi]);
#pragma unroll
            for (int b = 0; b < R; ++b) acc[b][wi] = fmaf(hv[b], w, acc[b][wi]);
          }
        }
      } else {
        // field j of a 16-bit half, its sign bit flipped (once a word), as
        // the low mantissa bits of 2^23 at its own position (one LOP3):
        // 2^23 + u 2^(BITS j), u = code + 2^(BITS-1); less 2^23 +
        // 2^(BITS-1) 2^(BITS j) (one FADD), the code times 2^(BITS j),
        // exactly; x s 2^-(BITS j) takes the power
        constexpr int HALF = PW / 2;
        constexpr uint32_t kMask = (1u << BITS) - 1u, kSign = 1u << (BITS - 1);
        constexpr uint32_t kFlip = BITS == 4 ? 0x88888888u : 0x80808080u;
        float xj[R][HALF];
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
          if (NS > 1 || wi == 0) {
            const float sc = sring[r * NS + (NS > 1 ? wi : 0)];
#pragma unroll
            for (int b = 0; b < R; ++b) {
              const float xs = hv[b] * sc;
#pragma unroll
              for (int j = 0; j < HALF; ++j) xj[b][j] = xs * (1.f / (float)(1u << (BITS * j)));
            }
          }
          const uint32_t lo = words[wi] ^ kFlip, hi = lo >> 16;
#pragma unroll
          for (int j = 0; j < HALF; ++j) {
            const float off = 8388608.f + (float)(kSign << (BITS * j));
            const float c0 = __uint_as_float(mask_or_magic(lo, kMask << (BITS * j))) - off;
            const float c1 = __uint_as_float(mask_or_magic(hi, kMask << (BITS * j))) - off;
#pragma unroll
            for (int b = 0; b < R; ++b) {
              acc[b][wi * PW + j] = fmaf(xj[b][j], c0, acc[b][wi * PW + j]);
              acc[b][wi * PW + HALF + j] = fmaf(xj[b][j], c1, acc[b][wi * PW + HALF + j]);
            }
          }
        }
      }
    }
    hopper::cp_async_wait<0>();         // the ring is refilled next pass
    __syncthreads();                    // every thread is past its reads of hs and the ring

    // the CTA's sub-rows, added in order, into its partial tile
#pragma unroll
    for (int b = 0; b < R; ++b) {
      if (b >= rows) break;
      float* dst = red + tid * (V + 4);
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(acc[b][j], acc[b][j + 1], acc[b][j + 2], acc[b][j + 3]);
      __syncthreads();
      for (int o = tid; o < ts * V; o += kThreads) {
        const int sl = o / V, j = o - sl * V;
        float sum = 0.f;
        for (int q = 0; q < nsub; ++q) {
          // thread (sl, q): lane (q % (32 / ts)) ts + sl of warp q / (32 / ts)
          const int t = (q / (32 / ts)) * 32 + (q % (32 / ts)) * ts + sl;
          sum += red[t * (V + 4) + j];
        }
        part[b * ts * V + o] = sum;
      }
      __syncthreads();
    }

    // the pass's sums: straight to the epilogue with one split, else into
    // the scratch (split, pair, segment, column)
    const int q4 = sps * V / 4;                // float4s of a segment's tile
    for (int i = tid; i < rows * q4; i += kThreads) {
      const int b = i / q4, c4 = i - b * q4;
      const int vl = c4 * 4 / V;
      if (blockIdx.x * sps + vl >= nvec) continue;
      const int col = (blockIdx.x * sps + vl) * V + (c4 * 4 - vl * V);
      const int pair = rt.pair[pass * R + b];
      const float* up = part + b * ts * V + c4 * 4;
      const float* gate = up + sps * V;
      if (a.ks == 1) {
        epilogue4<STAGE, T>(a, pair, col, up, gate);
      } else {
        float* dst = a.partial + ((size_t)blockIdx.z * P + pair) * a.nseg * a.N + col;
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(up);
        if (a.nseg == 2)
          *reinterpret_cast<float4*>(dst + a.N) = *reinterpret_cast<const float4*>(gate);
      }
    }
  }
}

// this CTA's arrival on `counter` of `expected`; true for the last, which
// resets the counter and sees every earlier arrival's writes
__device__ __forceinline__ bool arrive_last(unsigned* counter, unsigned expected, int& last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == expected - 1u;
    if (last) *counter = 0u;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// the last of a (slot, tile)'s K splits: each row's sums of the splits,
// added in split order, through the epilogue
template <int STAGE, typename T, int V>
__device__ __forceinline__ void split_sum(const ExpertArgs& a, const Route& rt) {
  constexpr int kB = 8;                        // splits' loads in flight
  const int sps = a.ts / a.nseg, nvec = a.N / V, q4 = sps * V / 4;
  const size_t zs = (size_t)a.bc * a.k * a.nseg * a.N;   // one split's scratch
  for (int i = threadIdx.x; i < rt.nrows * q4; i += kThreads) {
    const int b = i / q4, c4 = i - b * q4;
    const int vl = c4 * 4 / V;
    if (blockIdx.x * sps + vl >= nvec) continue;
    const int col = (blockIdx.x * sps + vl) * V + (c4 * 4 - vl * V);
    const int pair = rt.pair[b];
    const float* src = a.partial + (size_t)pair * a.nseg * a.N + col;
    float up[4] = {0.f, 0.f, 0.f, 0.f}, gate[4] = {0.f, 0.f, 0.f, 0.f};
    for (int z0 = 0; z0 < a.ks; z0 += kB) {
      float4 vu[kB], vg[kB];
#pragma unroll
      for (int zz = 0; zz < kB; ++zz) {
        const bool ok = z0 + zz < a.ks;
        const float* p = src + (size_t)(z0 + zz) * zs;
        vu[zz] = ok ? __ldcg(reinterpret_cast<const float4*>(p)) : make_float4(0, 0, 0, 0);
        vg[zz] = ok && a.nseg == 2 ? __ldcg(reinterpret_cast<const float4*>(p + a.N))
                                   : make_float4(0, 0, 0, 0);
      }
#pragma unroll
      for (int zz = 0; zz < kB; ++zz) {
        if (z0 + zz >= a.ks) break;
        up[0] += vu[zz].x; up[1] += vu[zz].y; up[2] += vu[zz].z; up[3] += vu[zz].w;
        gate[0] += vg[zz].x; gate[1] += vg[zz].y; gate[2] += vg[zz].z; gate[3] += vg[zz].w;
      }
    }
    epilogue4<STAGE, T>(a, pair, col, up, gate);
  }
}

// the last of a tile's routed slots in the down stage: out[r] = rt(sum_j
// rt(g_rj) y[canon(r k + j)]) over the tile's columns, in choice order;
// 0 for invalid rows
template <typename T, int V>
__device__ __forceinline__ void gated_sum(const ExpertArgs& a, const Route& rt) {
  const int nvec = a.N / V, q4 = a.ts * V / 4;
  for (int i = threadIdx.x; i < a.bc * q4; i += kThreads) {
    const int r = i / q4, c4 = i - r * q4;
    const int vl = c4 * 4 / V;
    if (blockIdx.x * a.ts + vl >= nvec) continue;
    const int col = (blockIdx.x * a.ts + vl) * V + (c4 * 4 - vl * V);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (rt.canon[r * a.k] >= 0) {
      float4 yv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < a.k)
          yv[j] = __ldcg(reinterpret_cast<const float4*>(
              a.y + (size_t)rt.canon[r * a.k + j] * a.N + col));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= a.k) break;
        const float g = round_t<T>(a.gates[r * a.k + j]);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(g, yv[j].x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(g, yv[j].y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(g, yv[j].z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(g, yv[j].w));
      }
    }
    T* o = static_cast<T*>(a.out) + (size_t)r * a.N + col;
#pragma unroll
    for (int t = 0; t < 4; ++t) o[t] = from_f<T>(acc[t]);
  }
}

template <int STAGE, int BITS, typename T, int NS>
__device__ __forceinline__ void expert_stage(const ExpertArgs& a) {
  constexpr int V = EVec<BITS, T>::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Route rt;
  __shared__ int last;
  const int slots = gridDim.y, tiles = gridDim.x;
  if (threadIdx.x < 32) route(a, blockIdx.y, rt);
  __syncthreads();
  if ((int)blockIdx.y >= rt.n_routed) {
    // no valid row at all: the down stage's first slot writes the zeros
    if (STAGE == 2 && rt.n_routed == 0 && blockIdx.y == 0 && blockIdx.z == 0) gated_sum<T, V>(a, rt);
    return;                             // before any load of a code
  }
  if (rt.nrows == 1)
    expert_passes<STAGE, BITS, T, NS, 1>(a, rt, smem_raw);
  else if (rt.nrows == 2)
    expert_passes<STAGE, BITS, T, NS, 2>(a, rt, smem_raw);
  else
    expert_passes<STAGE, BITS, T, NS, 4>(a, rt, smem_raw);
  if (a.ks > 1) {
    if (!arrive_last(a.counters + blockIdx.y * tiles + blockIdx.x, a.ks, last)) return;
    split_sum<STAGE, T, V>(a, rt);
  }
  if constexpr (STAGE == 2) {
    if (!arrive_last(a.counters + slots * tiles + blockIdx.x, rt.n_routed, last)) return;
    gated_sum<T, V>(a, rt);
  }
}

// grid (tiles, slots, ks), kThreads threads, ExpSmem<BITS, T, NS>(a).total
// bytes of dynamic shared memory
template <int BITS, typename T, int NS>
__global__ void __launch_bounds__(kThreads, 3) expert_up_kernel(const ExpertArgs a) {
  expert_stage<1, BITS, T, NS>(a);
}

template <int BITS, typename T, int NS>
__global__ void __launch_bounds__(kThreads, 3) expert_down_kernel(const ExpertArgs a) {
  expert_stage<2, BITS, T, NS>(a);
}

template <int STAGE, int BITS, typename T, int NS>
int launch_stage_t(const ExpertArgs& a, int tiles, int slots, cudaStream_t stream) {
  auto kernel = STAGE == 1 ? expert_up_kernel<BITS, T, NS> : expert_down_kernel<BITS, T, NS>;
  const int smem = ExpSmem<BITS, T, NS>(a).total;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(tiles, slots, a.ks), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// plan = {ts, kc, ks} (expert_plan in kernels/fused_decode/expert.py)
template <int STAGE, typename T>
int launch_stage(ExpertArgs a, int bits, const int* plan, int slots, cudaStream_t stream) {
  a.ts = plan[0];
  a.kc = plan[1];
  a.ks = plan[2];
  const int V = bits ? 128 / bits : 16 / (int)sizeof(T);
  const int nvec = a.N / V;
  if ((a.ts != 8 && a.ts != 16 && a.ts != 32) || a.kc < 1 || a.kc > kMaxKc || a.ks < 1 ||
      (long long)a.kc * a.ks < a.K || a.N % V != 0 ||
      (a.ks > 1 && a.partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int sps = a.ts / a.nseg;
  const int tiles = (nvec + sps - 1) / sps;
  // one scale a vector when its group holds whole vectors, else one a word
  const bool ns1 = bits == 0 || a.group % V == 0;
  switch (bits) {
    case 0: return launch_stage_t<STAGE, 0, T, 1>(a, tiles, slots, stream);
    case 4:
      return ns1 ? launch_stage_t<STAGE, 4, T, 1>(a, tiles, slots, stream)
                 : launch_stage_t<STAGE, 4, T, 4>(a, tiles, slots, stream);
    case 8:
      return ns1 ? launch_stage_t<STAGE, 8, T, 1>(a, tiles, slots, stream)
                 : launch_stage_t<STAGE, 8, T, 4>(a, tiles, slots, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int fused_mlp_experts_impl(const void* h, const int32_t* idx, const float* gates,
                           const int32_t* valid, int bc, int k, int E, int D, int F, int gated,
                           int act, const void* const* w, const float* const* scales,
                           const int* bits, const int* group, void* mid, float* y, void* out,
                           float* partial1, float* partial2, unsigned* counters,
                           const int* plan1, const int* plan2, cudaStream_t stream) {
  if (bc < 1 || bc > kMaxRows || k < 1 || k > 8 || bc * k > kMaxPairs || E < 1 || act < 0 ||
      act > kSquaredRelu || (gated && (bits[1] != bits[0] || group[1] != group[0])))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    if (bits[i] != 0 && bits[i] != 4 && bits[i] != 8) return (int)cudaErrorInvalidValue;
    const int n = i == 2 ? D : F;
    if (bits[i] != 0 && (group[i] < 8 || group[i] % 8 != 0 || n % group[i] != 0))
      return (int)cudaErrorInvalidValue;
  }
  const int slots = bc * k < E ? bc * k : E;
  // up stage: up (and gate) of every routed (expert, row) -> mid
  ExpertArgs a{};
  a.x = h;
  a.w[0] = w[0];
  a.sc[0] = scales[0];
  a.w[1] = w[1];
  a.sc[1] = scales[1];
  a.group = group[0];
  a.idx = idx;
  a.valid = valid;
  a.gates = gates;
  a.partial = partial1;
  a.out = mid;
  a.counters = counters;
  a.bc = bc;
  a.k = k;
  a.K = D;
  a.N = F;
  a.nseg = gated ? 2 : 1;
  a.act = act;
  int err = launch_stage<1, T>(a, bits[0], plan1, slots, stream);
  if (err) return err;
  // down stage: down of every routed (expert, row)'s mid -> y -> out
  ExpertArgs d = a;
  d.x = mid;
  d.w[0] = w[2];
  d.sc[0] = scales[2];
  d.w[1] = nullptr;
  d.sc[1] = nullptr;
  d.group = group[2];
  d.partial = partial2;
  d.y = y;
  d.out = out;
  d.K = F;
  d.N = D;
  d.nseg = 1;
  return launch_stage<2, T>(d, bits[2], plan2, slots, stream);
}

}  // namespace

extern "C" {

// The routed experts' GEMV of a decode step (fused_mlp with an expert
// axis).  h (bc, D) and out (bc, D) of the activations' dtype T (bf16, or
// fp32 when fp32 != 0); idx (bc, k) and valid (bc,) int32, gates (bc, k)
// fp32; w/scales/bits/group: [up, gate, down] of E experts each, up/gate
// (E, D, F), down (E, F, D), packed q4/q8 (groups a multiple of 8) or
// dense T (gate ignored unless gated; a gated pair shares bits and
// group).  act: 0 silu, 1 gelu (tanh), 2 relu, 3 squared relu.  Scratch,
// P = bc k: mid (P, F) T, y (P, D) floats, partial1 ks1 * P * (gated ? 2
// : 1) * F floats and partial2 ks2 * P * D floats (each unused when its ks
// is 1); counters: max(slots * tiles1, slots * tiles2 + tiles2) (slots =
// min(P, E)), zero before the call and left zero.  plan1 / plan2: {ts,
// kc, ks} of each stage.  Two device kernels, on the caller's stream.
int rt_fused_mlp_experts(const void* h, const int32_t* idx, const float* gates,
                         const int32_t* valid, int bc, int k, int E, int D, int F, int gated,
                         int act, const void* const* w, const float* const* scales,
                         const int* bits, const int* group, void* mid, float* y, void* out,
                         float* partial1, float* partial2, unsigned* counters, const int* plan1,
                         const int* plan2, int fp32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return fused_mlp_experts_impl<float>(h, idx, gates, valid, bc, k, E, D, F, gated, act, w,
                                         scales, bits, group, mid, y, out, partial1, partial2,
                                         counters, plan1, plan2, s);
  return fused_mlp_experts_impl<bf16>(h, idx, gates, valid, bc, k, E, D, F, gated, act, w,
                                      scales, bits, group, mid, y, out, partial1, partial2,
                                      counters, plan1, plan2, s);
}

}  // extern "C"

// Fused low-bit cohort-decode kernels for Hopper (sm_90a).
//
// Three kernels of the decode step, each the counterpart of a Pallas
// kernel of the reference package (src/repro/kernels/fused_decode/kernel.py;
// fused_mlp with an expert axis, the routed experts' GEMV, is in
// expert_gemv.cu):
//
//   fused_qkv   <- fused_qkv_pallas      q,k,v = h @ W{q,k,v} (+ bias)
//   fused_mlp   <- fused_mlp_pallas      mid = act(h @ W_gate) * (h @ W_up);
//                                        out = mid @ W_down
//   kv_row_scatter <- kv_row_scatter_pallas
//                                        pool[g, blk[b], off[b]] = row[g, b]
//
// What they compute.  Every GEMM here is a cohort GEMV: y[b, n] =
// sum_k h[b, k] * W[k, n] for bc <= 8 rows b of activations of the
// model's dtype T (bf16 or fp32; every kernel is a template on it).  W is
// either dense (T) or packed: int32 words along n, each holding
// 32/BITS two's-complement codes (field j at bit j*BITS), with one fp32
// scale per group of `group` consecutive n.  The weight is dequantized
// exactly like the reference's `dequantize` (code -> fp32, x scale in
// fp32, round to T: no rounding in fp32) and never exists dense in device
// memory.  Products accumulate in fp32; the output rounds to T, then the
// bias adds in fp32 and rounds again (the reference's einsum-then-add
// order); the MLP keeps the reference's order: up and gate each round to
// T, mid = rt(rt(act(rt(gate))) * rt(up)), out rounds to T.
//
// What bounds them on an H100.  At bc <= 8 a GEMV does 2*bc flops per
// weight element, far below the ~295 flop/byte balance point of the card:
// all three are bound by device-memory bytes.  fused_qkv streams ~0.65 MB
// of packed q4 weights per layer at LLaVA-OneVision-0.5B's widths and
// 10.3 MB at Qwen2-VL-7B's, fused_mlp ~8.2 MB and 127.3 MB (0.038 ms at
// 3.35 TB/s); the scatter writes 2*L*bc*KV*hd*2 bytes (a few KB): launch
// overhead dominates it.
//
// What the design does about it.
// Both GEMMs run one split-K GEMV kernel (gemv_kernel): fused_mlp one a
// stage, two device kernels a call (up and gate with the GLU epilogue
// into mid, then down with the round-and-store epilogue); fused_qkv one
// a call per distinct bit width among wq, wk and wv (one for every served
// profile), its weights side by side along the outputs (q | k | v), each
// in whole column tiles (its last padded), so each CTA reads one weight
// and finds it from its tile with two compares, the same for all its
// threads; the round, bias-add and round epilogue writes each weight's
// own output.  Each thread owns one
// 16-byte vector column of W (one uint4 of codes: 32 q4 outputs, one g32
// scale group and one scale load; q8 half a group, q2 two groups; dense 8
// bf16 or 4 fp32) and walks the CTA's K rows through an 8-stage cp.async
// ring in shared memory, so 7 independent 16-byte loads (43 KB an SM at
// three CTAs) stay in flight with no registers held for them; a warp
// reads 8, 16 or 32 consecutive vectors of a row.  A CTA's 128 threads
// are 8, 16 or 32 vector columns ("slots"; for the gated stage half up,
// half the matching gate columns) by 16, 8 or 4 K sub-rows, reduced in
// shared memory in sub-row order.  The K axis is split over CTAs to fill the 132 SMs
// (the down projection has only 3584 outputs): a thread-block cluster of
// up to 8 CTAs along K adds its CTAs' partial sums over distributed
// shared memory in rank order, each CTA a slice of the tile, and runs the
// epilogue in the same launch; where the split goes past one cluster,
// each cluster's sums go to an fp32 scratch, and for each slice the last
// of the clusters' CTAs holding it to arrive (a counter per tile and
// rank, reset by that CTA) adds them in cluster order and runs the
// epilogue.  The reductions keep several clusters' (ranks') loads in
// flight per thread: one load a round trip made them latency-bound.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// scripts/fused_mlp_ablation.py): the MLP 0.169 ms at Qwen2-VL-7B's
// widths and cohort 4, 754 GB/s, of which the loads, ring and reductions
// alone take 0.10 ms (1.0-1.5 TB/s) and the dequantize-and-multiply the
// rest; at LLaVA-OneVision-0.5B's widths 0.053 ms, mostly fixed costs.
// No float atomics: results are bit-identical from run to run.  The plans
// (slots, K rows per CTA, cluster size) are chosen by the wrapper
// (kernels/fused_decode/kernel.py gemv_plan, qkv_plan; the QKV's from
// scripts/fused_qkv_plan_sweep.py).  Cohorts past 4 rows (2 for q2) run
// in passes over the CTA's weights, so the accumulators stay at 128
// registers.
//
// Interface: plain C entry points (loaded with ctypes); each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_math.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxRows = 8;     // cohort rows per launch
constexpr int kMaxSegs = 3;     // weights side by side along a GEMV's outputs

__global__ void kv_row_scatter_kernel(const int32_t* __restrict__ blk,
                                      const int32_t* __restrict__ off,
                                      const uint4* __restrict__ k_rows,
                                      const uint4* __restrict__ v_rows,
                                      uint4* k_pool, uint4* v_pool, int bc,
                                      int n_blocks, int block_size, int row_vecs) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int bl = blk[b], o = off[b];
  // sentinel rows (blk == n_blocks) write nothing
  if (bl < 0 || bl >= n_blocks || o < 0 || o >= block_size) return;
  const size_t src = ((size_t)g * bc + b) * row_vecs;
  const size_t dst = (((size_t)g * n_blocks + bl) * block_size + o) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    k_pool[dst + i] = k_rows[src + i];
    v_pool[dst + i] = v_rows[src + i];
  }
}

// ---- the split-K GEMV ---------------------------------------------------------

constexpr int kGemvThreads = 128;
constexpr int kRing = 8;            // cp.async ring stages: loads in flight per thread
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMaxKChunk = 1024;    // K rows per CTA (activations in shared memory)
constexpr int kBatch = 8;           // items a thread reduces at once

template <int BITS, typename T>
struct Vec {
  static constexpr int kOut = BITS ? 128 / BITS : 16 / (int)sizeof(T);  // outputs a vector
  static constexpr int kScales = BITS == 2 ? 2 : (BITS ? 1 : 0);         // scale loads a vector
};

struct GemvSeg {
  const void* w;         // codes (K, n / (32 / BITS)) int32, or dense (K, n) T
  const float* scales;   // (K, n / group) fp32; null when dense
  int group;
  int n;                 // outputs of this weight
  int tile0;             // its first column tile (nseg 1: each tile lies in one weight)
  void* out;             // (bc, n) T: the epilogue's output (seg[0]'s for the GLU stage)
  const void* bias;      // (n,) T added by the store epilogue, or null
};

struct GemvArgs {
  // nseg 2 (the GLU stage): up and gate, each n outputs, a CTA's slots
  // half up, half the matching gate columns; nseg 1: ncat weights side
  // by side (q | k | v), each a whole number of vectors and of column
  // tiles (its last tile padded), n the launch's tiles x ts x V outputs
  // (one weight: its own n)
  GemvSeg seg[kMaxSegs];
  const void* h;         // (bc, K) T
  float* partial;        // (nck, bc, nseg * n) fp32 when nck > 1
  unsigned* counters;    // (grid.x, ck) zero before and after the launch
  int bc, K, n, nseg, ncat;
  int ts;                // vector columns (slots) a CTA: 8, 16 or 32
  int kc;                // K rows a CTA
  int ck, nck;           // CTAs a cluster along K, clusters along K
  int act;               // -1: round and store; else the activation
};

// byte offsets of the GEMV's dynamic shared memory: the ring of weight
// vectors [kRing][threads] and scales [kRing][threads][kScales], the
// activations [passes * R][kcp], the sub-row reduction [nsub][ts][V + 4]
// and the CTA's partial tile [R][ts][V]
template <int BITS, typename T, int R>
struct GemvSmem {
  static constexpr int V = Vec<BITS, T>::kOut, NS = Vec<BITS, T>::kScales;
  int scales, hs, red, part, total;
  __host__ __device__ explicit GemvSmem(const GemvArgs& a) {
    const int nsub = kGemvThreads / a.ts;
    const int kcp = (a.kc + nsub - 1) / nsub * nsub;
    const int passes = (a.bc + R - 1) / R;
    scales = kRing * kGemvThreads * 16;
    hs = scales + kRing * kGemvThreads * NS * 4;
    red = hs + (passes * R * kcp * 4 + 15) / 16 * 16;
    part = red + kGemvThreads * (V + 4) * 4;
    total = part + R * a.ts * V * 4;
  }
};

// the weight of column tile `tile` among the ncat side by side (the same
// for the whole CTA)
__device__ __forceinline__ int seg_of(const GemvArgs& a, int tile) {
  return (a.ncat > 1 && tile >= a.seg[1].tile0) + (a.ncat > 2 && tile >= a.seg[2].tile0);
}

// field F of weight si, by selects of the three parameters
#define SEG_FIELD(a, si, F) \
  ((si) == 0 ? (a).seg[0].F : ((si) == 1 ? (a).seg[1].F : (a).seg[2].F))

// the CTA's weight (the whole CTA's: up's for the GLU stage), its column
// tile within that weight, and the launch's first vector of that weight
struct CtaSeg {
  int si, tile, vec0;
};

__device__ __forceinline__ CtaSeg cta_seg(const GemvArgs& a, int bx, int sps) {
  const int si = a.nseg == 2 ? 0 : seg_of(a, bx);
  const int tile = bx - SEG_FIELD(a, si, tile0);
  return CtaSeg{si, tile, (bx - tile) * sps};
}

// the epilogues: out = rt(rt(sum) + bias) into the weight's own output
// (rt: round to T; the reference's einsum-then-add), mid = rt(rt(act(
// rt(gate))) * rt(up)) (nseg 2), mid = rt(act(rt(up))); `col` counts
// the outputs of weight `si` (the CTA's; up's for nseg 2); kCat: the
// weights side by side (q | k | v, act < 0) with their biases
template <int V, typename T, bool kCat>
__device__ __forceinline__ void gemv_epilogue(const GemvArgs& a, int si, int row, int col,
                                              float up, float gate) {
  if constexpr (kCat) {
    T* out = static_cast<T*>(SEG_FIELD(a, si, out)) + (size_t)row * SEG_FIELD(a, si, n) + col;
    const T* bias = static_cast<const T*>(SEG_FIELD(a, si, bias));
    *out = bias == nullptr ? from_f<T>(up) : from_f<T>(round_t<T>(up) + to_f(bias[col]));
    return;
  }
  T* out = static_cast<T*>(a.seg[0].out) + (size_t)row * a.n + col;
  if (a.act < 0) {
    *out = from_f<T>(up);
  } else if (a.nseg == 2) {
    const float g = round_t<T>(act_fn(a.act, round_t<T>(gate)));
    *out = from_f<T>(g * round_t<T>(up));
  } else {
    *out = from_f<T>(act_fn(a.act, round_t<T>(up)));
  }
}

// The GEMV's body: kCat, weights side by side (the fused QKV, or one
// weight with a bias), each CTA in one of them; else one weight, or the
// GLU stage's pair (the MLP), with none of that bookkeeping.  Thread
// (slot, sub) owns vector `slot` of the tile and K rows k0 + sub + s nsub.
template <int BITS, typename T, int R, bool kCat>
__device__ __forceinline__ void gemv_body(const GemvArgs& a) {
  constexpr int V = Vec<BITS, T>::kOut, NS = Vec<BITS, T>::kScales;
  constexpr int PW = BITS ? 32 / BITS : 1;        // codes a word
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const GemvSmem<BITS, T, R> L(a);
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  float* sring = reinterpret_cast<float*>(smem_raw + L.scales);
  float* hs = reinterpret_cast<float*>(smem_raw + L.hs);
  float* red = reinterpret_cast<float*>(smem_raw + L.red);
  float* part = reinterpret_cast<float*>(smem_raw + L.part);
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, ts = a.ts, nsub = kGemvThreads / ts;
  const int slot = (tid & 31) % ts, sub = (tid & 31) / ts + (32 / ts) * (tid >> 5);
  const int sps = ts / a.nseg;                     // slots a segment
  // the CTA's weight and its column tile within it (up's for the GLU
  // stage), and the thread's weight (up or gate by slot)
  const CtaSeg cw = kCat ? cta_seg(a, blockIdx.x, sps) : CtaSeg{0, (int)blockIdx.x, 0};
  const int nvec = (kCat ? SEG_FIELD(a, cw.si, n) : a.n) / V;   // the weight's vectors
  const int vec = cw.tile * sps + slot % sps;      // within the weight
  const bool valid = vec < nvec;
  const int si = kCat ? cw.si : (slot < sps ? 0 : 1);
  const int group =
      kCat ? SEG_FIELD(a, si, group) : (si == 0 ? a.seg[0].group : a.seg[1].group);
  const int k0 = blockIdx.y * a.kc;
  const int kn = max(0, min(a.kc, a.K - k0));
  const int steps = (a.kc + nsub - 1) / nsub, kcp = steps * nsub;
  const int passes = (a.bc + R - 1) / R;

  const void* const wbase = kCat ? SEG_FIELD(a, si, w) : (si == 0 ? a.seg[0].w : a.seg[1].w);
  const float* const sbase =
      kCat ? SEG_FIELD(a, si, scales) : (si == 0 ? a.seg[0].scales : a.seg[1].scales);
  const uint4* wsrc = static_cast<const uint4*>(wbase) + (size_t)k0 * nvec + vec;
  const int ng = BITS ? nvec * V / group : 0;
  const float* ssrc = BITS ? sbase + (size_t)k0 * ng + (size_t)vec * V / group : nullptr;
  // stage s of the ring: row k0 + sub + s nsub (zeros past the CTA's rows;
  // a zero-filled copy still names a valid address, the weight's own)
  auto issue = [&](int s) {
    const int kk = sub + s * nsub;
    if (s < steps) {
      const bool ok = valid && kk < kn;
      const int r = (s % kRing) * kGemvThreads + tid;
      hopper::cp_async16_zfill(ring + r, ok ? wsrc + (size_t)kk * nvec : wbase, ok);
#pragma unroll
      for (int q = 0; q < NS; ++q)
        hopper::cp_async4_zfill(sring + r * NS + q,
                                ok ? ssrc + (size_t)kk * ng + (q * (V / NS)) / group : sbase,
                                ok);
    }
    hopper::cp_async_commit();
  };

  // this CTA's slice of the tile's items (an output, or an up/gate pair)
  // in the cluster's reduction
  const int items = sps * V, gate_off = a.nseg == 2 ? sps * V : 0;
  const int rank = (int)cluster.block_rank();
  const int e0 = rank * items / a.ck, ne = (rank + 1) * items / a.ck - e0;

  // the CTA's activations, zero past bc and past its K rows
  const T* hg = static_cast<const T*>(a.h);
  for (int i = tid; i < passes * R * kcp; i += kGemvThreads) {
    const int b = i / kcp, kk = i - b * kcp;
    hs[i] = (b < a.bc && kk < kn) ? to_f(hg[(size_t)b * a.K + k0 + kk]) : 0.f;
  }

  float acc[R][V];
  for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[b][j] = 0.f;
    for (int s = 0; s < kRing - 1; ++s) issue(s);
    __syncthreads();                    // the activations are staged
    const float* hrow = hs + pass * R * kcp;
    for (int s = 0; s < steps; ++s) {
      issue(s + kRing - 1);
      hopper::cp_async_wait<kRing - 1>();
      const int r = (s % kRing) * kGemvThreads + tid;
      const uint4 v = ring[r];
      const int kk = sub + s * nsub;
      float hv[R];
#pragma unroll
      for (int b = 0; b < R; ++b) hv[b] = hrow[b * kcp + kk];
      if constexpr (BITS == 0) {
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float w = to_f(e[j]);
#pragma unroll
          for (int b = 0; b < R; ++b) acc[b][j] = fmaf(hv[b], w, acc[b][j]);
        }
      } else {
        float sc[NS];
#pragma unroll
        for (int q = 0; q < NS; ++q) sc[q] = sring[r * NS + q];
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
          const float s_w = sc[wi * NS / 4];
#pragma unroll
          for (int j = 0; j < PW; j += 2) {
            float w0 = hopper::code<BITS>(words[wi], j) * s_w;
            float w1 = hopper::code<BITS>(words[wi], j + 1) * s_w;
            round2_t<T>(w0, w1);
#pragma unroll
            for (int b = 0; b < R; ++b) {
              acc[b][wi * PW + j] = fmaf(hv[b], w0, acc[b][wi * PW + j]);
              acc[b][wi * PW + j + 1] = fmaf(hv[b], w1, acc[b][wi * PW + j + 1]);
            }
          }
        }
      }
    }
    hopper::cp_async_wait<0>();         // the ring is refilled next pass

    // the CTA's sub-rows, added in order, into its partial tile
#pragma unroll
    for (int b = 0; b < R; ++b) {
      float* dst = red + (sub * ts + slot) * (V + 4);
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(acc[b][j], acc[b][j + 1], acc[b][j + 2], acc[b][j + 3]);
      __syncthreads();
      for (int o = tid; o < ts * V; o += kGemvThreads) {
        const int sl = o / V, j = o - sl * V;
        float sum = 0.f;
        for (int q = 0; q < nsub; ++q) sum += red[(q * ts + sl) * (V + 4) + j];
        part[b * ts * V + o] = sum;
      }
      __syncthreads();
    }

    // the cluster's CTAs, added in rank order, over this CTA's slice,
    // kBatch items a thread at a time so their loads are in flight
    // together
    cluster.sync();
    const int rows = min(R, a.bc - pass * R);
    for (int i0 = tid; i0 < rows * ne; i0 += kBatch * kGemvThreads) {
      int off[kBatch];
      float up[kBatch], gate[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kGemvThreads;
        const int b = i / ne, e = e0 + i - b * ne;
        off[u] = i < rows * ne && cw.tile * sps + e / V < nvec ? b * ts * V + e : -1;
        up[u] = gate[u] = 0.f;
      }
      // four ranks' loads in flight at a time, added in rank order
      for (int q0 = 0; q0 < a.ck; q0 += 4) {
        float vu[4][kBatch], vg[4][kBatch];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const float* rp = cluster.map_shared_rank(part, min(q0 + qq, a.ck - 1));
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const bool ok = q0 + qq < a.ck && off[u] >= 0;
            vu[qq][u] = ok ? rp[off[u]] : 0.f;
            vg[qq][u] = ok && a.nseg == 2 ? rp[off[u] + gate_off] : 0.f;
          }
        }
#pragma unroll
        for (int qq = 0; qq < 4; ++qq)
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (q0 + qq < a.ck) {
              up[u] += vu[qq][u];
              gate[u] += vg[qq][u];
            }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (off[u] < 0) continue;
        const int b = off[u] / (ts * V), e = off[u] - b * ts * V;
        const int row = pass * R + b, col = (blockIdx.x * sps + e / V) * V + e % V;
        if (a.nck == 1) {
          gemv_epilogue<V, T, kCat>(a, cw.si, row, col - cw.vec0 * V, up[u], gate[u]);
        } else {
          float* pp = a.partial + ((size_t)(blockIdx.y / a.ck) * a.bc + row) * a.nseg * a.n;
          pp[col] = up[u];
          if (a.nseg == 2) pp[a.n + col] = gate[u];
        }
      }
    }
    cluster.sync();                     // the partial tiles are rewritten next pass
  }
  if (a.nck == 1) return;

  // past one cluster: each rank's slice of the column tile is added, in
  // cluster order, by the last of the clusters' CTAs of that rank to
  // arrive (a counter per tile and rank), which runs the epilogue
  __threadfence();
  __syncthreads();
  unsigned* counter = a.counters + blockIdx.x * a.ck + rank;
  if (tid == 0) last = atomicAdd(counter, 1u) == (unsigned)a.nck - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t cstride = (size_t)a.bc * a.nseg * a.n;   // one cluster's sums
  for (int i0 = tid; i0 < a.bc * ne; i0 += kBatch * kGemvThreads) {
    long long off[kBatch];
    float up[kBatch], gate[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kGemvThreads;
      const int b = i / ne, e = e0 + i - b * ne;
      const int v = blockIdx.x * sps + e / V;
      off[u] = i < a.bc * ne && cw.tile * sps + e / V < nvec
                   ? (long long)b * a.nseg * a.n + v * V + e % V
                   : -1;
      up[u] = gate[u] = 0.f;
    }
    // four clusters' loads in flight at a time, added in cluster order
    for (int q0 = 0; q0 < a.nck; q0 += 4) {
      float vu[4][kBatch], vg[4][kBatch];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float* pq = a.partial + (q0 + qq) * cstride;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool ok = q0 + qq < a.nck && off[u] >= 0;
          vu[qq][u] = ok ? __ldcg(pq + off[u]) : 0.f;
          vg[qq][u] = ok && a.nseg == 2 ? __ldcg(pq + off[u] + a.n) : 0.f;
        }
      }
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (q0 + qq < a.nck) {
            up[u] += vu[qq][u];
            gate[u] += vg[qq][u];
          }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (off[u] < 0) continue;
      const int b = (int)(off[u] / (a.nseg * a.n));
      gemv_epilogue<V, T, kCat>(
          a, cw.si, b, (int)(off[u] - (long long)b * a.nseg * a.n) - cw.vec0 * V, up[u], gate[u]);
    }
  }
  if (tid == 0) *counter = 0u;
}

// grid (tiles, ck * nck), cluster (1, ck, 1), kGemvThreads threads, dynamic
// shared memory GemvSmem<BITS, T, R>(a).total
template <int BITS, typename T, int R>
__global__ void __launch_bounds__(kGemvThreads, 3) gemv_kernel(const GemvArgs a) {
  if (a.ncat > 1 || a.seg[0].bias != nullptr)
    gemv_body<BITS, T, R, true>(a);
  else
    gemv_body<BITS, T, R, false>(a);
}

template <int BITS, typename T, int R>
int launch_gemv_t(const GemvArgs& a, int tiles, cudaStream_t stream) {
  const int smem = GemvSmem<BITS, T, R>(a).total;
  cudaError_t e = cudaFuncSetAttribute(gemv_kernel<BITS, T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, a.ck * a.nck, 1);
  cfg.blockDim = dim3(kGemvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.ck;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gemv_kernel<BITS, T, R>, a);
}

template <int BITS, typename T>
int launch_gemv_r(const GemvArgs& a, int R, int tiles, cudaStream_t stream) {
  if (R == 1) return launch_gemv_t<BITS, T, 1>(a, tiles, stream);
  if (R == 2) return launch_gemv_t<BITS, T, 2>(a, tiles, stream);
  if constexpr (Vec<BITS, T>::kOut * 4 <= 128)
    if (R == 4) return launch_gemv_t<BITS, T, 4>(a, tiles, stream);
  return (int)cudaErrorInvalidValue;
}

// plan = {R, ts, kc, ck, nck} (gemv_plan in kernels/fused_decode/kernel.py)
template <typename T>
int launch_gemv(GemvArgs a, int bits, const int* plan, cudaStream_t stream) {
  const int R = plan[0];
  a.ts = plan[1];
  a.kc = plan[2];
  a.ck = plan[3];
  a.nck = plan[4];
  const int V = bits ? 128 / bits : 16 / (int)sizeof(T);
  const int NS = bits == 2 ? 2 : 1;
  if (a.bc < 1 || a.bc > kMaxRows || (a.ts != 8 && a.ts != 16 && a.ts != 32) || a.nseg < 1 ||
      a.nseg > 2 || a.ncat < 1 || a.ncat > (a.nseg == 2 ? 1 : kMaxSegs) || a.n < V ||
      a.n % V != 0 || a.kc < 1 || a.kc > kMaxKChunk || a.ck < 1 || a.ck > kMaxCluster || a.nck < 1 ||
      (long long)a.kc * a.ck * a.nck < a.K ||
      (a.nck > 1 && (a.partial == nullptr || a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  // each weight a whole number of vectors, its scale groups whole vectors'
  // (two a vector for q2); the nseg-1 weights side by side in whole tiles
  const int sps = a.ts / a.nseg;
  int tiles = 0;
  for (int i = 0; i < a.nseg * a.ncat; ++i) {
    const GemvSeg& s = a.seg[i];
    if (s.n < V || s.n % V != 0 || s.tile0 != (a.nseg == 2 ? 0 : tiles) ||
        (a.nseg == 2 && s.n != a.n) ||
        (bits != 0 && (s.group < 1 || s.group % (V / NS) != 0 || s.n % s.group != 0)))
      return (int)cudaErrorInvalidValue;
    tiles += a.nseg == 2 ? 0 : (s.n / V + sps - 1) / sps;
  }
  if (a.nseg == 2) tiles = (a.n / V + sps - 1) / sps;
  if (a.nseg == 1 && a.n != (a.ncat == 1 ? a.seg[0].n : tiles * sps * V))
    return (int)cudaErrorInvalidValue;
  switch (bits) {
    case 0: return launch_gemv_r<0, T>(a, R, tiles, stream);
    case 2: return launch_gemv_r<2, T>(a, R, tiles, stream);
    case 4: return launch_gemv_r<4, T>(a, R, tiles, stream);
    case 8: return launch_gemv_r<8, T>(a, R, tiles, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int fused_mlp_impl(const void* h, int bc, int D, int F, int gated, int act,
                   const void* const* w, const float* const* scales, const int* bits,
                   const int* group, void* mid, void* out, const int* plan1, float* partial1,
                   const int* plan2, float* partial2, unsigned* counters, int tiles1,
                   cudaStream_t stream) {
  if (act < 0 || act > kSquaredRelu || (gated && (bits[1] != bits[0] || group[1] != group[0])))
    return (int)cudaErrorInvalidValue;
  // stage 1: up (and gate) -> act -> mid
  GemvArgs a{};
  a.seg[0] = GemvSeg{w[0], scales[0], group[0], F, 0, mid, nullptr};
  a.seg[1] = GemvSeg{w[1], scales[1], group[1], F, 0, nullptr, nullptr};
  a.h = h;
  a.partial = partial1;
  a.counters = counters;
  a.bc = bc;
  a.K = D;
  a.n = F;
  a.nseg = gated ? 2 : 1;
  a.ncat = 1;
  a.act = act;
  const int err = launch_gemv<T>(a, bits[0], plan1, stream);
  if (err) return err;
  // stage 2: mid @ W_down, rounded to T
  GemvArgs d{};
  d.seg[0] = GemvSeg{w[2], scales[2], group[2], D, 0, out, nullptr};
  d.h = mid;
  d.partial = partial2;
  d.counters = counters + tiles1;
  d.bc = bc;
  d.K = F;
  d.n = D;
  d.nseg = 1;
  d.ncat = 1;
  d.act = -1;
  return launch_gemv<T>(d, bits[2], plan2, stream);
}

// One GEMV launch per distinct bit width among the nseg weights (plan i
// for the i-th width in the order 0, 2, 4, 8), its weights side by side
// along the outputs in the callers' order; the launches share the scratch
// and the counters (one after another on the stream)
template <typename T>
int fused_qkv_impl(const void* h, int bc, int K, int nseg, const void* const* w,
                   const float* const* scales, const int* n, const int* bits, const int* group,
                   const void* const* bias, void* const* out, const int* plans, float* partial,
                   unsigned* counters, cudaStream_t stream) {
  if (nseg < 1 || nseg > kMaxSegs) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nseg; ++i)
    if (bits[i] != 0 && bits[i] != 2 && bits[i] != 4 && bits[i] != 8)
      return (int)cudaErrorInvalidValue;
  const int kBits[4] = {0, 2, 4, 8};
  int launch = 0;
  for (int bi = 0; bi < 4; ++bi) {
    const int V = kBits[bi] ? 128 / kBits[bi] : 16 / (int)sizeof(T);
    GemvArgs a{};
    for (int i = 0; i < nseg; ++i)
      if (bits[i] == kBits[bi])
        a.seg[a.ncat++] = GemvSeg{w[i], scales[i], group[i], n[i], 0, out[i], bias[i]};
    if (a.ncat == 0) continue;
    const int ts = plans[5 * launch + 1];   // each weight's tiles after the last's
    int tiles = 0;
    for (int i = 0; i < a.ncat; ++i) {
      a.seg[i].tile0 = tiles;
      tiles += (a.seg[i].n / V + ts - 1) / ts;
    }
    a.h = h;
    a.partial = partial;
    a.counters = counters;
    a.bc = bc;
    a.K = K;
    a.n = a.ncat == 1 ? a.seg[0].n : tiles * ts * V;
    a.nseg = 1;
    a.act = -1;
    const int err = launch_gemv<T>(a, kBits[bi], plans + 5 * launch++, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Activations, outputs, biases and dense weights of one dtype: bf16, or
// fp32 when fp32 != 0.  Per weight i (nseg <= 3): w[i] (codes or dense),
// scales[i] (null if dense), n[i] outputs (a multiple of the 16-byte
// vector's), bits[i] (0 = dense), group[i], bias[i] (null = none), out[i]
// (bc, n[i]).  plans: {R, ts, kc, ck, nck} of each launch, one per
// distinct bit width in the order 0, 2, 4, 8; partial: the largest
// launch's nck * bc * (its outputs) floats (unused when every nck is 1);
// counters: the largest launch's tiles x ck, zero before the call and
// left zero.
int rt_fused_qkv(const void* h, int bc, int K, int nseg, const void* const* w,
                 const float* const* scales, const int* n, const int* bits,
                 const int* group, const void* const* bias, void* const* out,
                 const int* plans, float* partial, unsigned* counters, int fp32,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return fused_qkv_impl<float>(h, bc, K, nseg, w, scales, n, bits, group, bias, out, plans,
                                 partial, counters, s);
  return fused_qkv_impl<bf16>(h, bc, K, nseg, w, scales, n, bits, group, bias, out, plans,
                              partial, counters, s);
}

// w/scales/bits/group: [up, gate, down] (gate ignored unless gated; a
// gated pair shares bits and group).  act: 0 silu, 1 gelu (tanh), 2 relu,
// 3 squared relu.  mid: (bc, F) scratch of the activations' dtype (bf16,
// or fp32 when fp32 != 0).  plan1 / plan2: {R, ts, kc, ck, nck} of each
// stage; partial1: nck1 * bc * (gated ? 2F : F) floats and partial2:
// nck2 * bc * D floats (each unused when its nck is 1); counters: the
// (tile, cluster rank) pairs of both stages (stage 2's from tiles1 on,
// tiles1 = stage 1's tiles x ck1), zero before the call and left zero.
int rt_fused_mlp(const void* h, int bc, int D, int F, int gated, int act,
                 const void* const* w, const float* const* scales,
                 const int* bits, const int* group, void* mid, void* out,
                 const int* plan1, float* partial1, const int* plan2, float* partial2,
                 unsigned* counters, int tiles1, int fp32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return fused_mlp_impl<float>(h, bc, D, F, gated, act, w, scales, bits, group, mid, out,
                                 plan1, partial1, plan2, partial2, counters, tiles1, s);
  return fused_mlp_impl<bf16>(h, bc, D, F, gated, act, w, scales, bits, group, mid, out, plan1,
                              partial1, plan2, partial2, counters, tiles1, s);
}

// Writes in place into k_pool / v_pool (L, n_blocks, block_size, row):
// row (g, b) of k_rows / v_rows (L, bc, row) lands at [g, blk[b], off[b]];
// rows whose blk is not a valid block id (the sentinel n_blocks) write
// nothing.  row_bytes must be a multiple of 16, pointers 16-byte aligned.
int rt_kv_row_scatter(const int32_t* blk, const int32_t* off, const void* k_rows,
                      const void* v_rows, void* k_pool, void* v_pool, int L, int bc,
                      int n_blocks, int block_size, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || L < 1 || bc < 1) return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  const int threads = row_vecs < 32 ? 32 : (row_vecs < 256 ? ((row_vecs + 31) / 32) * 32 : 256);
  kv_row_scatter_kernel<<<dim3(L, bc), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      blk, off, static_cast<const uint4*>(k_rows), static_cast<const uint4*>(v_rows),
      static_cast<uint4*>(k_pool), static_cast<uint4*>(v_pool), bc, n_blocks,
      block_size, row_vecs);
  return (int)cudaGetLastError();
}

}  // extern "C"

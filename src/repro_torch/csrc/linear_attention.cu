// Causal linear attention (phi = elu + 1) for Hopper (sm_90a).
//
// The counterpart of the reference's Pallas kernel linear_attention_pallas
// (src/repro/kernels/linear_attention/kernel.py:68): the paper's streaming
// attention (§3.2 GPU), from a zero state,
//   S_t = S_{t-1} + phi(k_t) v_t^T,  z_t = z_{t-1} + phi(k_t),
//   o_t = (phi(q_t) . S_t) / max(phi(q_t) . z_t, 1e-6),
// returning o and the final (S, z) so that decode continues the stream.
//
// What it computes, per (batch b, query head h) and 64-row tile of a
// chunk of L positions, all arithmetic in fp32, with S_before and
// z_before the sums over every row before the tile:
//   o_i = [phi(q_i) S_before + sum_{j<=i in tile} (phi(q_i).phi(k_j)) v_j]
//         / max(phi(q_i).z_before + sum_{j<=i in tile} phi(q_i).phi(k_j), eps)
// Head h reads kv head h / (H / KV) (GQA by index, never a repeat).  Rows
// at or past valid_len[b] add nothing to S and z, and their output is
// zero.  q (B, S, H, hd) and k/v (B, S, KV, hd) are read in the model's
// layout through strides (innermost axis contiguous); o (B, S, H, hd) is
// written contiguous in q's dtype, S (B, H, hd, hd) and z (B, H, hd) in
// fp32, one copy per query head.  bf16 or fp32 inputs; hd <= 128,
// L <= 256 with S % L == 0 (L may be any size: a ragged 127-row chunk
// is zero-filled and masked).
//
// What bounds it on an H100.  The least work the function needs is its
// recurrent form: per (b, kv head) and row, the state and normalizer
// updates (2 hd^2 + hd), and per (b, h) and row, phi(q).S_t and
// phi(q).z_t (2 hd^2 + 2 hd): 0.28 GFLOP at B 2, S 1024, H 14, KV 2,
// hd 64 against 8.9 MB moved, so it is bound by operations: 4.1 us at
// the 67 TFLOP/s of fp32 FFMA.  The contract is fp32 arithmetic (plain
// TF32's 10-bit mantissa would break the 1e-4 gate).
//
// What the design does about it.  The Pallas grid (B*H, S/C) walks the
// chunks in order with the (hd, hd) state in VMEM: at B 2, H 14 that is
// 28 blocks for 132 SMs.  Linear attention is SSD with no decay plus a
// normalizer, so the phases of csrc/ssd.cu carry over, each parallel over
// 64-row tiles, three device kernels a call:
//   1. la_state_kernel, per (b, kv head, row tile): the tile's own
//      phi(k)^T v and sum phi(k) over the rows before valid_len (per kv
//      head: H / KV times less work than per query head);
//   2. la_scan_kernel, per (b, kv head, element of S or z): the pass over
//      the row tiles that leaves each tile the sums over every row before
//      it, eight tiles' loads issued before their adds (one load a step
//      made it latency-bound), and writes the final S and z to each query
//      head of the group;
//   3. la_out_kernel, per (b, kv head, row tile, pair of 16-row slabs r
//      and 3 - r: equal causal work, two blocks a tile to fill the card):
//      one block serves every query head of the group, a warp a (head,
//      slab), so phi(k), v and S_before are loaded and transformed once
//      for all of them; per head and slab phi(q) S_before and the
//      diagonal tile's s = phi(q) phi(k)^T masked to j <= i, its row sums
//      and phi(q).z_before (FFMA, exact fp32) into the denominator, then
//      o += s v.  Row tiles wholly past valid_len are written as zeros.
// Every product runs on the tensor cores (mma.sync m16n8k8) in split TF32:
// an fp32 operand x is hi = tf32(x) plus lo = tf32(x - hi), within 2^-22
// of x, and a product of two split operands is three products lo.hi +
// hi.lo + hi.hi (hopper.cuh), fp32's accuracy.  Three terms: phi(q)
// S_before, phi(q) phi(k)^T, and with fp32 inputs phi(k)^T v and s v.
// Two terms: phi(k)^T v and s v when v is bf16, whose 8-bit mantissa is
// exact in tf32 (lo.v + hi.v).  phi(k), v and S_before are split once
// when staged (S_before at hd 128 as its fragments are read: both halves
// would not fit beside the others), phi(q) and s as their fragments are
// formed.  Each pair of k-steps' products (a k-step's in the state kernel)
// is summed in a fresh accumulator and added to the running sums in fp32,
// so the tensor cores' own sums (which truncate) never run over more than
// six products.  A block's staging issues all of a round's loads (sixteen
// a thread of each of k, v and S_before) before using any.  A quad's
// fragment reads take k columns 2t, 2t + 1 on both operands (mma's k t
// and t + 4), s's accumulator is read as the next product's A fragment
// with no shuffle, and shared rows are padded so every fragment read hits
// distinct banks.  Every term of the denominator is positive (phi > 0),
// so it grows with the prompt and nothing cancels.
//
// Interface: one plain C entry point (loaded with ctypes); it launches on
// the caller's stream, allocates nothing (the caller passes the
// (B, KV, nt, hd, hd) and (B, KV, nt, hd) fp32 scratch, nt = S / L *
// ceil(L / 64) row tiles) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::mma_tf32;
using hopper::split_tf32;

constexpr int kTile = 64;               // rows of a row tile
constexpr int kMaxChunk = 256;
constexpr int kMaxHd = 128;
constexpr float kEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;                 // (B,) or null (every row counts)
  void* out;                            // (B, S, H, hd)
  float* s_out;                         // (B, H, hd, hd)
  float* z_out;                         // (B, H, hd)
  float* states;                        // (B, KV, nt, hd, hd) scratch
  float* zs;                            // (B, KV, nt, hd) scratch
  int B, S, H, KV, hd, L, nc, G;
  int nt;                               // row tiles: nc * ceil(L / 64)
  long long q_sb, q_ss, q_sh;           // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// phi(x) = elu(x) + 1: x + 1 above zero, exp(x) (= expm1(x) + 1) at and
// below
__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expf(x); }

// Rows of chunk c that count: those before valid_len[b], at most L.
__device__ __forceinline__ int counted_rows(const Params& p, int b, int c) {
  int vl = p.valid_len ? p.valid_len[b] : p.S;
  vl = min(max(vl, 0), p.S);
  return min(max(vl - c * p.L, 0), p.L);
}

// Where row tile t (blockIdx.x) lies: chunk c, first row i0 in the chunk,
// the tile's rows in the chunk and how many of them count.
struct TilePos {
  int c, i0, tile_rows, counted;
  __device__ TilePos(const Params& p, int b, int t) {
    const int per_chunk = (p.L + kTile - 1) / kTile;
    c = t / per_chunk;
    i0 = (t - c * per_chunk) * kTile;
    tile_rows = min(kTile, p.L - i0);
    counted = min(max(counted_rows(p, b, c) - i0, 0), tile_rows);
  }
};

// The head dimension padded to 32, 64 or 128, and the shared-memory row
// strides: kS4 = HDP + 4 for operands read as (k 2t, n g) and (k 2t + 1,
// n g) (banks 8t + g), kS8 = HDP + 8 for ones read as 8-byte (n g, k 2t)
// pairs (banks 8g + 2t, per half warp).
template <int HDP>
struct LA {
  static constexpr int kS4 = HDP + 4, kS8 = HDP + 8;
  // out kernel: a (query head, slab) a warp, the 14 of a G = 7 group at
  // once at hd <= 64; eight at hd 128 (their accumulators need the
  // registers)
  static constexpr int kMaxWarps = HDP <= 64 ? 14 : 8;
  // S_before split once when staged, or (hd 128) as its fragments are read
  static constexpr bool kSplitS = HDP <= 64;
};

// acc += a b as split-TF32 products summed in a fresh accumulator (the
// tensor cores' own sum sees one k-step's three products) and added in
// fp32: three terms lo.hi + hi.lo + hi.hi, or two, lo.b + hi.b, where b is
// exact in tf32 (bl null)
__device__ __forceinline__ void mma_split_add(float (&acc)[4], const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                              const uint32_t* bl) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al, bh0, bh1);
  if (bl) mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// (hi, lo) of x into two float arrays at index i
__device__ __forceinline__ void put_split(float* hi, float* lo, int i, float x) {
  uint32_t h, l;
  split_tf32(x, h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

// A block's staging, in rounds whose loads are all issued before any is
// used: the row tile's phi(k) (hi and lo, rows of stride ks) and v (hi,
// and lo unless vl is null: a bf16 v is exact; rows of stride vs), kg / vg
// at the tile's
// first row and its kv head, and with WITH_S the S_before tile (fp32 sg
// (hd, hd); hi and lo, or hi alone where sl is null; rows of stride ss,
// zeros unless `before`).  Rows at or past `counted` and columns past hd
// are zero.
template <typename T, int HDP, bool WITH_S>
__device__ __forceinline__ void stage_tile(float* kh, float* kl, int ks, float* vh, float* vl,
                                           int vs, const T* __restrict__ kg, long long k_ss,
                                           const T* __restrict__ vg, long long v_ss, int counted,
                                           int hd, float* sh, float* sl, int ss,
                                           const float* __restrict__ sg, bool before) {
  constexpr int kB = 16, kKV = kTile * HDP, kSS = WITH_S ? HDP * HDP : 0;
  constexpr int kN = kKV > kSS ? kKV : kSS;
  for (int base = threadIdx.x; base < kN; base += kB * blockDim.x) {
    float xk[kB], xv[kB], xs[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int idx = base + u * blockDim.x, j = idx / HDP, e = idx - j * HDP;
      const bool kv = idx < kKV && j < counted && e < hd;
      xk[u] = kv ? to_f32(__ldg(kg + j * k_ss + e)) : 0.f;
      xv[u] = kv ? to_f32(__ldg(vg + j * v_ss + e)) : 0.f;
      if (WITH_S)                       // S_before (row j, column e)
        xs[u] = before && idx < kSS && j < hd && e < hd ? __ldg(sg + (long long)j * hd + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int idx = base + u * blockDim.x, j = idx / HDP, e = idx - j * HDP;
      if (idx < kKV) {
        put_split(kh, kl, j * ks + e, j < counted && e < hd ? phi(xk[u]) : 0.f);
        if (vl) put_split(vh, vl, j * vs + e, xv[u]);
        else vh[j * vs + e] = xv[u];
      }
      if (WITH_S && idx < kSS) {
        if (sl) put_split(sh, sl, j * ss + e, xs[u]);
        else sh[j * ss + e] = xs[u];
      }
    }
  }
}

// ---- phase 1: the row tiles' states ---------------------------------------

// grid (nt, B * KV), 256 threads; dynamic shared memory 4 * 64 * (HDP + 4)
// floats.  states[b, kv, tile] = phi(k)^T v (hd x hd) and zs[b, kv, tile] =
// sum_j phi(k_j) over the tile's counted rows: M = the hd rows e of the
// state (phi(k) read transposed as A), N = d, K = the tile's 64 rows.
template <typename T, int HDP>
__global__ void __launch_bounds__(256) la_state_kernel(const Params p) {
  constexpr int kS = LA<HDP>::kS4;
  constexpr bool kExactV = sizeof(T) == 2;      // bf16 v is exact in tf32
  constexpr int kSlabs = HDP / 16, kWarpsPerSlab = 8 / kSlabs;
  constexpr int kNF = HDP / 8 / kWarpsPerSlab;  // 8-column blocks of d a warp
  extern __shared__ __align__(16) float smem[];
  float* kh = smem;                     // phi(k) [j][e], hi and lo
  float* kl = kh + kTile * kS;
  float* vh = kl + kTile * kS;          // v [j][d], hi and lo (bf16: exact, hi only)
  float* vl = vh + kTile * kS;
  const int bk = blockIdx.y, b = bk / p.KV, kh_ = bk - b * p.KV;
  const TilePos tp(p, b, blockIdx.x);
  const long long row0 = (long long)tp.c * p.L + tp.i0;
  const long long HD2 = (long long)p.hd * p.hd;
  const long long tile = (long long)bk * p.nt + blockIdx.x;
  float* out = p.states + tile * HD2;
  if (tp.counted == 0) {                // the tile is padding: zeros
    for (long long i = threadIdx.x; i < HD2; i += blockDim.x) out[i] = 0.f;
    for (int e = threadIdx.x; e < p.hd; e += blockDim.x) p.zs[tile * p.hd + e] = 0.f;
    return;
  }
  stage_tile<T, HDP, false>(
      kh, kl, kS, vh, kExactV ? nullptr : vl, kS,
      static_cast<const T*>(p.k) + b * p.k_sb + row0 * p.k_ss + kh_ * p.k_sh, p.k_ss,
      static_cast<const T*>(p.v) + b * p.v_sb + row0 * p.v_ss + kh_ * p.v_sh, p.v_ss, tp.counted,
      p.hd, nullptr, nullptr, 0, nullptr, false);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int e0 = 16 * (warp % kSlabs), nf0 = (warp / kSlabs) * kNF;
  float acc[kNF][4];
#pragma unroll
  for (int i = 0; i < kNF; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int ksteps = (tp.counted + 7) / 8;
  for (int kk = 0; kk < ksteps; ++kk) {
    // A = phi(k)^T: rows e0 + g (+ 8), k rows j = 8 kk + 2t (+ 1)
    const int a = (8 * kk + 2 * t) * kS + e0 + g;
    const uint32_t ah[4] = {__float_as_uint(kh[a]), __float_as_uint(kh[a + 8]),
                            __float_as_uint(kh[a + kS]), __float_as_uint(kh[a + kS + 8])};
    const uint32_t al[4] = {__float_as_uint(kl[a]), __float_as_uint(kl[a + 8]),
                            __float_as_uint(kl[a + kS]), __float_as_uint(kl[a + kS + 8])};
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf) {
      const int o = (8 * kk + 2 * t) * kS + 8 * (nf0 + nf) + g;
      const uint32_t bl[2] = {__float_as_uint(vl[o]), __float_as_uint(vl[o + kS])};
      mma_split_add(acc[nf], ah, al, __float_as_uint(vh[o]), __float_as_uint(vh[o + kS]),
                    kExactV ? nullptr : bl);
    }
  }
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = e0 + g + 8 * (c >> 1), d = 8 * (nf0 + nf) + 2 * t + (c & 1);
      if (e < p.hd && d < p.hd) out[(long long)e * p.hd + d] = acc[nf][c];
    }
  // z: kP adjacent lanes a column e, each over rows j = part mod kP,
  // then added across the lanes in a fixed order
  constexpr int kP = 256 / HDP < 8 ? 256 / HDP : 8;
  for (int i = threadIdx.x; i < HDP * kP; i += 256) {
    const int e = i / kP, part = i - e * kP;
    float zacc = 0.f;
    for (int j = part; j < tp.counted; j += kP) zacc += kh[j * kS + e] + kl[j * kS + e];
#pragma unroll
    for (int off = 1; off < kP; off <<= 1) zacc += __shfl_xor_sync(kFull, zacc, off);
    if (part == 0 && e < p.hd) p.zs[tile * p.hd + e] = zacc;
  }
}

// ---- phase 2: the scan over row tiles --------------------------------------

// grid (ceil((hd*hd + hd) / 256), B*KV).  Each tile's sums are replaced by
// the sums before the tile, eight tiles' loads in flight before their
// adds, and the sums after the last tile go to each query head of the
// group.
__global__ void __launch_bounds__(256) la_scan_kernel(const Params p) {
  constexpr int kAhead = 8;
  const long long HD2 = (long long)p.hd * p.hd;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= HD2 + p.hd) return;
  const int bk = blockIdx.y, b = bk / p.KV, kh = bk - b * p.KV;
  const bool in_s = e < HD2;
  const long long stride = in_s ? HD2 : p.hd;
  float* s = in_s ? p.states + (long long)bk * p.nt * HD2 + e
                  : p.zs + (long long)bk * p.nt * p.hd + (e - HD2);
  float run = 0.f;
  for (int t0 = 0; t0 < p.nt; t0 += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) v[i] = t0 + i < p.nt ? s[(t0 + i) * stride] : 0.f;
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (t0 + i < p.nt) {
        s[(t0 + i) * stride] = run;
        run += v[i];
      }
  }
  for (int g = 0; g < p.G; ++g) {
    const long long bh = (long long)b * p.H + kh * p.G + g;
    if (in_s) p.s_out[bh * HD2 + e] = run;
    else p.z_out[bh * p.hd + (e - HD2)] = run;
  }
}

// ---- phase 3: the outputs ----------------------------------------------------

template <int HDP>
constexpr int out_smem_floats() {
  using C = LA<HDP>;
  // phi(k) hi/lo [j][kS8], v hi/lo [j][kS4], S_before [e][kS4] (hi/lo when
  // split on staging), z_before [HDP]
  return 2 * kTile * C::kS8 + 2 * kTile * C::kS4 + (C::kSplitS ? 2 : 1) * HDP * C::kS4 + HDP;
}

// one (query head, 16-row slab) of the out kernel: rows 16 r + g (+ 8) of
// the tile, every column of o
template <typename T, int HDP>
__device__ __forceinline__ void out_slab(const Params& p, const TilePos& tp, int b, int h, int r,
                                         bool before, const float* kh, const float* kl,
                                         const float* vh, const float* vl, const float* sh,
                                         const float* sl, const float* zb, int lane) {
  using C = LA<HDP>;
  constexpr int kS4 = C::kS4, kS8 = C::kS8, kNF = HDP / 8;
  constexpr bool kExactV = sizeof(T) == 2;
  const int g = lane >> 2, t = lane & 3;
  const int i_a = 16 * r + g, i_b = i_a + 8;          // rows of the lane in the tile
  const bool ok_a = i_a < tp.counted, ok_b = i_b < tp.counted;
  const long long row0 = (long long)tp.c * p.L + tp.i0;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + row0 * p.q_ss + h * p.q_sh;
  const int nj = 2 * r + 2;                           // key blocks of 8 up to the slab's diagonal

  float o[kNF][4], s[8][4];
#pragma unroll
  for (int i = 0; i < kNF; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
  float za = 0.f, zbb = 0.f;                          // phi(q).z_before, rows a and b

  // phi(q) S_before and phi(q) phi(k)^T over e in pairs of steps of 8:
  // phi(q)'s fragments (rows a, b; e 8 kk + 2t, + 1) formed and split once,
  // the next pair's q loaded before this pair's products, each pair's six
  // products summed apart and added in fp32
  auto load_q = [&](int e, float (&x)[4]) {         // (a, e), (b, e), (a, e+1), (b, e+1)
    x[0] = ok_a && e < p.hd ? to_f32(qg[(long long)i_a * p.q_ss + e]) : 0.f;
    x[1] = ok_b && e < p.hd ? to_f32(qg[(long long)i_b * p.q_ss + e]) : 0.f;
    x[2] = ok_a && e + 1 < p.hd ? to_f32(qg[(long long)i_a * p.q_ss + e + 1]) : 0.f;
    x[3] = ok_b && e + 1 < p.hd ? to_f32(qg[(long long)i_b * p.q_ss + e + 1]) : 0.f;
  };
  float xn[2][4];
  load_q(2 * t, xn[0]);
  load_q(8 + 2 * t, xn[1]);
#pragma unroll 1
  for (int kp = 0; kp < HDP / 16; ++kp) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = 16 * kp + 8 * u + 2 * t;
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = xn[u][i];
      if (kp + 1 < HDP / 16) load_q(e + 16, xn[u]);
      x[0] = ok_a && e < p.hd ? phi(x[0]) : 0.f;
      x[1] = ok_b && e < p.hd ? phi(x[1]) : 0.f;
      x[2] = ok_a && e + 1 < p.hd ? phi(x[2]) : 0.f;
      x[3] = ok_b && e + 1 < p.hd ? phi(x[3]) : 0.f;
      za = fmaf(x[0], zb[e], fmaf(x[2], zb[e + 1], za));
      zbb = fmaf(x[1], zb[e], fmaf(x[3], zb[e + 1], zbb));
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], ah[u][i], al[u][i]);
    }
    if (before) {
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i0 = (16 * kp + 8 * u + 2 * t) * kS4 + 8 * nf + g;   // S_before (e, d)
          uint32_t bh0, bh1, bl0, bl1;
          if constexpr (C::kSplitS) {
            bh0 = __float_as_uint(sh[i0]);
            bh1 = __float_as_uint(sh[i0 + kS4]);
            bl0 = __float_as_uint(sl[i0]);
            bl1 = __float_as_uint(sl[i0 + kS4]);
          } else {
            split_tf32(sh[i0], bh0, bl0);
            split_tf32(sh[i0 + kS4], bh1, bl1);
          }
          mma_tf32(d, al[u], bh0, bh1);
          mma_tf32(d, ah[u], bl0, bl1);
          mma_tf32(d, ah[u], bh0, bh1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) o[nf][i] += d[i];
      }
    }
#pragma unroll
    for (int jf = 0; jf < 8; ++jf) {
      if (jf < nj) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i0 = (8 * jf + g) * kS8 + 16 * kp + 8 * u + 2 * t;  // phi(k) (j, e, e + 1)
          const uint2 bh = *reinterpret_cast<const uint2*>(kh + i0);
          const uint2 bl = *reinterpret_cast<const uint2*>(kl + i0);
          mma_tf32(d, al[u], bh.x, bh.y);
          mma_tf32(d, ah[u], bl.x, bl.y);
          mma_tf32(d, ah[u], bh.x, bh.y);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s[jf][i] += d[i];
      }
    }
  }

  // causal mask on the diagonal 16 x 16 block, the row sums into the
  // denominator (a row's keys lie in its quad)
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int jf = 0; jf < 8; ++jf) {
    if (jf < nj) {
      const int j = 8 * jf + 2 * t;
      if (j > i_a) s[jf][0] = 0.f;
      if (j + 1 > i_a) s[jf][1] = 0.f;
      if (j > i_b) s[jf][2] = 0.f;
      if (j + 1 > i_b) s[jf][3] = 0.f;
      da += s[jf][0] + s[jf][1];
      db += s[jf][2] + s[jf][3];
    }
  }
  da += __shfl_xor_sync(kFull, da, 1);
  da += __shfl_xor_sync(kFull, da, 2);
  db += __shfl_xor_sync(kFull, db, 1);
  db += __shfl_xor_sync(kFull, db, 2);
  za += __shfl_xor_sync(kFull, za, 1);
  za += __shfl_xor_sync(kFull, za, 2);
  zbb += __shfl_xor_sync(kFull, zbb, 1);
  zbb += __shfl_xor_sync(kFull, zbb, 2);

  // o += s v, each pair of key blocks summed apart: s's accumulator (row,
  // key 2t / 2t + 1) is A's (row, k t / t + 4), v's rows taken as 2t,
  // 2t + 1 alike
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (2 * jp < nj) {                              // nj is even
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jf = 2 * jp + u;
        split_tf32(s[jf][0], ah[u][0], al[u][0]);
        split_tf32(s[jf][2], ah[u][1], al[u][1]);
        split_tf32(s[jf][1], ah[u][2], al[u][2]);
        split_tf32(s[jf][3], ah[u][3], al[u][3]);
      }
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i0 = (16 * jp + 8 * u + 2 * t) * kS4 + 8 * nf + g;
          const uint32_t b0 = __float_as_uint(vh[i0]), b1 = __float_as_uint(vh[i0 + kS4]);
          mma_tf32(d, al[u], b0, b1);
          if (!kExactV) mma_tf32(d, ah[u], __float_as_uint(vl[i0]), __float_as_uint(vl[i0 + kS4]));
          mma_tf32(d, ah[u], b0, b1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) o[nf][i] += d[i];
      }
    }
  }

  const float inv_a = 1.f / fmaxf(za + da, kEps), inv_b = 1.f / fmaxf(zbb + db, kEps);
  const long long HH = (long long)p.H * p.hd;
  T* og = static_cast<T*>(p.out) + ((long long)b * p.S + row0) * HH + (long long)h * p.hd;
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf) {
    const int d = 8 * nf + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = hh ? i_b : i_a;
      if (i >= tp.tile_rows) continue;
      const bool ok = hh ? ok_b : ok_a;
      const float inv = hh ? inv_b : inv_a;
      T* dst = og + (long long)i * HH + d;
      if (d < p.hd) store(dst, ok ? o[nf][2 * hh] * inv : 0.f);
      if (d + 1 < p.hd) store(dst + 1, ok ? o[nf][2 * hh + 1] * inv : 0.f);
    }
  }
}

// grid (nt, B * KV, 2), 32 * min(kMaxWarps, 2 G) threads; dynamic shared
// memory out_smem_floats<HDP>() floats.  blockIdx.z = z takes the tile's
// 16-row slabs z and 3 - z (2 + 8 and 4 + 6 key blocks: equal work), each
// warp one of them for one query head of the group.
template <typename T, int HDP>
__global__ void __launch_bounds__(32 * LA<HDP>::kMaxWarps, 1) la_out_kernel(const Params p) {
  using C = LA<HDP>;
  constexpr bool kExactV = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  float* kh = smem;                           // phi(k) [j][kS8]
  float* kl = kh + kTile * C::kS8;
  float* vh = kl + kTile * C::kS8;            // v [j][kS4]
  float* vl = vh + kTile * C::kS4;
  float* sh = vl + kTile * C::kS4;            // S_before [e][kS4]
  float* sl = sh + HDP * C::kS4;              // (its lo terms when split on staging)
  float* zb = sl + (C::kSplitS ? HDP * C::kS4 : 0);

  const int bk = blockIdx.y, b = bk / p.KV, kv = bk - b * p.KV;
  const TilePos tp(p, b, blockIdx.x);
  const long long row0 = (long long)tp.c * p.L + tp.i0;
  if (tp.counted == 0) {                      // the whole tile is padding
    const long long HH = (long long)p.H * p.hd;
    T* og = static_cast<T*>(p.out) + ((long long)b * p.S + row0) * HH + (long long)kv * p.G * p.hd;
    const int n = p.G * p.hd;                 // the group's heads are adjacent
    for (int idx = threadIdx.x; idx < 32 * n; idx += blockDim.x) {
      const int r = idx / n, slab = r < 16 ? blockIdx.z : 3 - blockIdx.z;
      const int i = 16 * slab + (r & 15);     // this block's slabs' rows
      if (i < tp.tile_rows) store(og + (long long)i * HH + (idx - r * n), 0.f);
    }
    return;
  }
  // S_before and z_before: the scan's sums over every row before the tile
  // (zero for the first)
  const bool before = blockIdx.x > 0;
  const long long tile = (long long)bk * p.nt + blockIdx.x;
  stage_tile<T, HDP, true>(
      kh, kl, C::kS8, vh, kExactV ? nullptr : vl, C::kS4,
      static_cast<const T*>(p.k) + b * p.k_sb + row0 * p.k_ss + kv * p.k_sh, p.k_ss,
      static_cast<const T*>(p.v) + b * p.v_sb + row0 * p.v_ss + kv * p.v_sh, p.v_ss, tp.counted,
      p.hd, sh, C::kSplitS ? sl : nullptr, C::kS4, p.states + tile * p.hd * p.hd, before);
  for (int e = threadIdx.x; e < HDP; e += blockDim.x)
    zb[e] = before && e < p.hd ? p.zs[tile * p.hd + e] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5, pair = blockIdx.z;
  for (int u = warp; u < 2 * p.G; u += n_warps)      // (head u / 2, slab pair or 3 - pair)
    out_slab<T, HDP>(p, tp, b, kv * p.G + (u >> 1), u & 1 ? 3 - pair : pair, before, kh, kl, vh,
                     vl, sh, sl, zb, lane);
}

template <typename T, int HDP>
int launch(const Params& p, cudaStream_t stream) {
  const int state_smem = 4 * kTile * LA<HDP>::kS4 * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(la_state_kernel<T, HDP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, state_smem);
  if (e != cudaSuccess) return (int)e;
  la_state_kernel<T, HDP><<<dim3(p.nt, p.B * p.KV), 256, state_smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)p.hd * p.hd + p.hd;
  la_scan_kernel<<<dim3((unsigned)((n + 255) / 256), p.B * p.KV), 256, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int out_smem = out_smem_floats<HDP>() * (int)sizeof(float);
  e = cudaFuncSetAttribute(la_out_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           out_smem);
  if (e != cudaSuccess) return (int)e;
  const int warps = min(LA<HDP>::kMaxWarps, 2 * p.G);
  la_out_kernel<T, HDP><<<dim3(p.nt, p.B * p.KV, 2), 32 * warps, out_smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int by_hd(const Params& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, 32>(p, stream);
  if (p.hd <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

extern "C" {

// q (B, S, H, hd) and k/v (B, S, KV, hd), bf16 (is_bf16 = 1) or fp32,
// with (batch, seq, head) strides in elements and the last axis
// contiguous; valid_len (B,) int32 or null.  out (B, S, H, hd) contiguous
// in q's dtype; s_out (B, H, hd, hd), z_out (B, H, hd), states (B, KV,
// nt, hd, hd) and zs (B, KV, nt, hd) contiguous fp32, nt = S / L *
// ceil(L / 64).  1 <= L <= 256,
// S % L == 0, 1 <= hd <= 128, H % KV == 0.
int rt_linear_attention(const void* q, const void* k, const void* v, const void* valid_len,
                        void* out, void* s_out, void* z_out, void* states, void* zs, int B,
                        int S, int H, int KV, int hd, int L, int is_bf16, long long q_sb,
                        long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || hd < 1 || hd > kMaxHd || L < 1 || L > kMaxChunk ||
      S % L != 0 || H % KV != 0 || (long long)B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(valid_len), out,
                 static_cast<float*>(s_out), static_cast<float*>(z_out),
                 static_cast<float*>(states), static_cast<float*>(zs),
                 B, S, H, KV, hd, L, S / L, H / KV, S / L * ((L + kTile - 1) / kTile),
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_hd<bf16>(p, s) : by_hd<float>(p, s);
}

}  // extern "C"

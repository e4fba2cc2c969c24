// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// The counterpart of the reference's Pallas kernel ssd_pallas
// (src/repro/kernels/ssd/kernel.py:69): the state-space-dual form of the
// Mamba-2 recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,
// y_t = C_t . h_t, from h = 0, returning y and the final state.
//
// What it computes, per (batch b, head h) and chunk of L positions, with
// fp32 accumulation: la = dt * A and cum = its inclusive cumsum within
// the chunk;
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//         + exp(cum_i) (C_i . h_prev)                              (inter)
//   h_new = exp(cum_last) h_prev + sum_j x_j (x) B_j dt_j exp(cum_last - cum_j)
// where h_prev is the state before the chunk.  Head h reads B/C group
// h / (H / G).  x (B, S, H, P), dt (B, S, H) fp32, B/C (B, S, G, N) are
// read in the model's layout through strides (innermost axis contiguous);
// y (B, S, H, P) is written contiguous in x's dtype and h_final
// (B, H, P, N) in fp32.  bf16 or fp32 inputs; P any size, N <= 128,
// L <= 256 with S % L == 0.
//
// What bounds it on an H100.  The function needs, per chunk, C.B^T once
// per group over the causal half (N L (L+1) flop), the weights times x
// per head over the causal half (P L (L+1)), C.h_prev (2 L N P, from the
// second chunk on) and the state (2 L P N): 12.7 GFLOP at B 2, S 2048,
// H 64, P 64, G 1, N 128, chunk 256 against 74 MB moved.  In fp32 FFMA
// (67 TFLOP/s) that is 0.19 ms, so bound by operations.  The served
// Mamba-2 path is bf16: x, B and C are bf16, and a bf16 x bf16 product is
// exact in an fp32 accumulator, so C.B^T takes one bf16 tensor-core
// product.  The other three products pair one exact bf16 operand (x, B or
// C) with one fp32 operand (the weights w, B dt exp(cum_last - cum), the
// state h_prev); split the fp32 operand v into hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid), which hold v's 24 significant
// bits exactly (for |v| >= 2^-110, or 0), and the three bf16 products
// summed in the fp32 accumulator match FFMA's accuracy.  Counted that way
// (C.B^T once, each split product 3x: 37.2 GFLOP at 989 TFLOP/s bf16,
// 0.21 GFLOP of elementwise work at 67) the bf16 route's bound is 0.041
// ms, beside 0.022 ms of bytes (chip_smoke.py ssd_mma_bound).  TF32 stays
// out: its 10-bit mantissa breaks the 1e-4 state tolerance.
//
// What the design does about it.  The Pallas grid (B, H, S/L) runs in
// order with the (P, N) state in VMEM; at Mamba-2-1.3B's B*H = 64..128
// that is under one wave of 132 SMs.  Here four kernels, each parallel
// over chunks, two routes picked by the inputs' dtype before the launch:
//   0. ssd_cb_*: per (b, group, chunk, 64x64 tile pair on or below the
//      diagonal), C.B^T into an fp32 scratch (B, G, nc, L, L) that stays
//      in L2 (4.2 MB at the shape above): computed once per group, not
//      once per head (64x fewer at G = 1);
//   1. ssd_state_*: per (b, h, chunk, 64x64 tile of the state), the
//      chunk's own state contribution sum_j x_j (x) B_j w_j, with
//      w_j = dt_j exp(cum_last - cum_j) and the exponent summed from the
//      chunk's end (sum_{k>j} dt_k A): taken as a difference of two
//      prefix sums, which reach thousands at A = -16, it keeps only
//      fp32's resolution at that size, and the state drifted by ~1e-4
//      of its largest value on Mamba-2-1.3B's served inputs;
//   2. ssd_scan_kernel: per (b, h, 4 state elements), the short
//      sequential pass over chunks, h <- decay_c h + s_c, which
//      overwrites each chunk's contribution with the state before it and
//      writes h_final; eight chunks' loads are issued before their updates
//      (with one load a round trip the scan was the second-slowest phase);
//   3. ssd_out_*: per (b, h, chunk, 64-row tile, 64-wide P tile), the
//      inter term from the state before the chunk, then the intra term
//      over the 64-column key tiles up to the diagonal (the causal half
//      only): w = (C B^T from the scratch) exp(cum_i - cum_j) dt_j, y +=
//      w x, masked to j <= i without evaluating exp on the masked half
//      (so no overflow and no 0 * inf).  Below the diagonal tile every
//      key precedes every row, and the mma route takes exp(cum_i - cum_j)
//      = exp(cum_i - cum_i0) exp(cum_i0 - cum_j), both factors <= 1: 128
//      exps a tile instead of 4096 (on the FFMA route it measured slower,
//      and the route keeps one exp an entry).  cum is summed in double
//      (chunk_cumsum): near the diagonal cum_i - cum_j is small while cum
//      reaches thousands at A = -16, and as a difference of two fp32
//      prefix sums it moved the fp32 y by 1.6e-4 of its largest value on
//      Mamba-2-1.3B's served inputs on an H100 (1e-4 is the reference's
//      bound).
// The "mma" route (bf16 inputs) runs every product on the tensor cores
// with warp-level mma.sync m16n8k16 (bf16 in, fp32 accumulate): eight
// warps a block, each a 16 x 32 slice of the 64 x 64 output tile; the
// tiles are small and ragged (any P, N <= 128, L <= 256), which a
// warpgroup's 64-row wgmma tile would not fit without waste.  The block's
// threads stage each operand into shared memory, rows padded by 8 bf16
// so ldmatrix reads are conflict-free: C and B K-major, x in its own
// [j][p] layout read transposed (ldmatrix.trans), with 16-byte loads
// where the strides allow (plain loads, not TMA: the tiles are a few KB
// and each is consumed once).  The fp32 operand is split into its three
// bf16 planes as it is staged, two values a thread with packed
// conversions, and each k16 step issues the three products into one
// accumulator.  On the diagonal key tile a warp skips the k16 steps
// wholly above its rows.  The "simt" route (fp32 inputs, both operands
// fp32) keeps FFMA: each thread owns a 4 x 4 register tile strided by 16
// in both directions, shared rows padded to an odd length, and reads
// C.B^T from the same scratch.  Both routes are deterministic (no
// atomics).  The per-chunk cumsum is recomputed by each block (L <= 256
// adds, in double) instead of stored.
//
// The backward (rt_ssd_backward) replaces no Pallas kernel: the reference
// trains Mamba-2 by differentiating ssd_chunked (src/repro/models/
// mamba2.py:51) off the TPU.  It computes the derivative of the same
// chunked form (kernels/ssd/ref.py ref_ssd_backward spells it out): from
// dy and dh, dx, ddt, dA, dB and dC.  Per (b, h, chunk), with M_ij = dy_i .
// x_j and T_ij = exp(cum_i - cum_j) dt_j M_ij on j <= i, the function
// needs M (L (L+1) P), dx's weights times dy (L (L+1) P), T B and T^T C
// (L (L+1) N each), and four products of 2 L P N: the chunk's reverse
// state contribution, dx's and dB's state terms and dC's inter term; 85.7
// GFLOP at B 4, S 2048, H 64, P 64, N 128, chunk 256 against 281 MB
// moved (chip_smoke.py ssd_bwd_work): bound by operations, 1.28 ms at 67
// TFLOP/s FFMA.  A first, simple design (FFMA with fp32 accumulation, bf16
// or fp32 inputs read as fp32; M computed twice), nine device kernels a
// call:
//   0. C.B^T per group (the forward's phase-0 kernel of the route);
//   1. ssd_bwd_state: per (b, h, chunk, 64x64 tile of the state), the
//      chunk's reverse contribution sum_i exp(cum_i) dy_i (x) C_i;
//   2. ssd_bwd_scan: per (b, h, 4 state elements), the pass over the
//      chunks from the last, from dh: each contribution is replaced by
//      the gradient of the state after its chunk, hn;
//   3. ssd_bwd_dx: per (b, h, chunk, 64 keys, 64-wide P tile), dx over
//      the row tiles on or below the diagonal, plus dt_j exp(after_j) hn
//      B_j;
//   4. ssd_bwd_dc / 5. ssd_bwd_db: per (b, h, chunk, 64 rows or keys), T
//      tile by tile (M recomputed in each), this head's share of dC (T B
//      plus exp(cum_i) h_prev^T dy_i, h_prev the forward's states) and of
//      dB (T^T C plus dt_j exp(after_j) hn^T x_j) into fp32 scratch
//      (B, H, S, N), and the per-position terms of ddt;
//   6. ssd_bwd_dt: per (b, h, chunk), d(cum) from those terms, d(la) its
//      reverse cumsum within the chunk in double, ddt = the direct terms
//      + d(la) A and the chunk's share of dA;
//   7. ssd_bwd_heads: dB and dC, the heads' shares summed over each group
//      in order; 8. ssd_bwd_da: dA, the chunks' shares summed in order.
// The exponents are the forward's: cum in double (chunk_cumsum), the state
// weights' exponent summed from the chunk's end (chunk_suffix), exp never
// evaluated on the masked half.  Every sum over heads, chunks or the
// batch runs in a fixed order with no atomics: two launches give the same
// bits.
//
// Interface: two plain C entry points (loaded with ctypes); each launches
// on the caller's stream, allocates nothing (the caller passes the fp32
// scratch: rt_ssd's (B, H, nc, P, N), (B, H, nc) and (B, G, nc, L, L),
// rt_ssd_backward's as its comment lists) and returns cudaGetLastError().
// rt_ssd leaves the state before each chunk in its states scratch, which
// the caller may keep for rt_ssd_backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows / columns of an output tile
constexpr int kPadTile = kTile + 1;     // odd row stride of 64-wide fp32 tiles
constexpr int kXS = kTile + 8;          // row stride of 64-deep bf16 tiles
constexpr int kMaxChunk = 256;
constexpr int kMaxN = 128;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* bm;
  const void* cm;
  void* y;
  float* h_out;                         // (B, H, P, N)
  float* states;                        // (B, H, nc, P, N) scratch
  float* decay;                         // (B, H, nc) scratch
  float* cb;                            // (B, G, nc, L, L) scratch
  int B, S, H, P, G, N, L, nc;
  long long x_sb, x_ss, x_sh;           // strides in elements
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  bool vec_x, vec_bc;                   // x / B and C rows in 16-byte vectors
};


// v = hi + mid + lo exactly, each term bf16 (round to nearest; the
// remainder after a rounding to nearest is exact in fp32), for two
// adjacent values: each plane written as one bf16 pair at dst, dst +
// plane, dst + 2 plane (dst 4-byte aligned)
__device__ __forceinline__ void split3_pair(float v0, float v1, bf16* dst, int plane) {
  using bf162 = __nv_bfloat162;
  const bf162 a = __floats2bfloat162_rn(v0, v1);
  v0 -= __low2float(a);
  v1 -= __high2float(a);
  const bf162 m = __floats2bfloat162_rn(v0, v1);
  v0 -= __low2float(m);
  v1 -= __high2float(m);
  *reinterpret_cast<bf162*>(dst) = a;
  *reinterpret_cast<bf162*>(dst + plane) = m;
  *reinterpret_cast<bf162*>(dst + 2 * plane) = __floats2bfloat162_rn(v0, v1);
}

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// the row stride (bf16) of an N-deep K-major tile: N rounded up to 16,
// plus 8 (a row stride of 4 mod 32 words)
__host__ __device__ __forceinline__ int n_stride(int N) { return ((N + 15) & ~15) + 8; }

// dt of chunk c into dts[0..L) and cum[j] = sum_{k<=j} dt_k A into cum,
// the fp32 terms dt_k A summed in double.  Warp 0 scans: each lane adds up
// to 8 consecutive terms in order, then a shuffle scan adds the lanes'
// totals.  Ends with __syncthreads().
__device__ void chunk_cumsum(const Params& p, int b, int h, int c, float* dts,
                             double* cum) {
  const float a = p.A[h];
  const float* dtg = p.dt + b * p.dt_sb + (long long)c * p.L * p.dt_ss + h * p.dt_sh;
  for (int j = threadIdx.x; j < p.L; j += blockDim.x) dts[j] = dtg[j * p.dt_ss];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (p.L + 31) / 32;    // <= 8
    const int j0 = lane * per;
    double loc[kMaxChunk / 32];
    double run = 0.0;
#pragma unroll
    for (int k = 0; k < kMaxChunk / 32; ++k) {
      const int j = j0 + k;
      if (k < per && j < p.L) run += (double)(dts[j] * a);
      loc[k] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const double base = incl - run;
#pragma unroll
    for (int k = 0; k < kMaxChunk / 32; ++k) {
      const int j = j0 + k;
      if (k < per && j < p.L) cum[j] = base + loc[k];
    }
  }
  __syncthreads();
}

// after[j] = sum_{k>j} dts[k] A, summed from the chunk's end: the mirror
// of chunk_cumsum (lanes own the same runs, added last to first, and a
// shuffle scan adds the later lanes' totals), so a term's rounding is
// relative to the sum after it.  Ends with __syncthreads().
__device__ void chunk_suffix(const Params& p, int h, const float* dts, float* after) {
  if (threadIdx.x < 32) {
    const float a = p.A[h];
    const int lane = threadIdx.x;
    const int per = (p.L + 31) / 32;
    const int j0 = lane * per;
    float loc[kMaxChunk / 32];
    float run = 0.f;
#pragma unroll
    for (int k = kMaxChunk / 32 - 1; k >= 0; --k) {
      const int j = j0 + k;
      loc[k] = run;                     // this lane's terms after j
      if (k < per && j < p.L) run += dts[j] * a;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_down_sync(kFull, incl, off);
      if (lane + off < 32) incl += t;
    }
    const float later = incl - run;     // the later lanes' terms
#pragma unroll
    for (int k = 0; k < kMaxChunk / 32; ++k) {
      const int j = j0 + k;
      if (k < per && j < p.L) after[j] = later + loc[k];
    }
  }
  __syncthreads();
}

// the chunk's state weights wgt[j] = dt_j exp(sum_{k>j} dt_k A) and, from
// the block with blockIdx.z == 0, decay[b, h, c] = exp(cum_last).  Ends
// with __syncthreads().
__device__ void state_weights(const Params& p, int bh, int h, int c, double* cum, float* dts,
                              float* after, float* wgt) {
  chunk_cumsum(p, bh / p.H, h, c, dts, cum);
  chunk_suffix(p, h, dts, after);
  for (int j = threadIdx.x; j < p.L; j += kThreads) wgt[j] = dts[j] * expf(after[j]);
  if (blockIdx.z == 0 && threadIdx.x == 0)
    p.decay[(long long)bh * p.nc + c] = expf((float)cum[p.L - 1]);
  __syncthreads();
}

// blockIdx.x = c * pairs + pair -> (c, it, jt), jt <= it: the 64 x 64 tile
// pairs on or below the diagonal of a chunk
__device__ __forceinline__ void tile_pair(const Params& p, int& c, int& it, int& jt) {
  const int n = (p.L + kTile - 1) / kTile;
  const int pairs = n * (n + 1) / 2;
  c = blockIdx.x / pairs;
  int q = blockIdx.x - c * pairs;
  it = 0;
  while (q > it) q -= ++it;
  jt = q;
}

__device__ __forceinline__ float* cb_tile(const Params& p, int b, int g, int c) {
  return p.cb + (((long long)b * p.G + g) * p.nc + c) * p.L * p.L;
}

// ---- the mma route (bf16 inputs) ---------------------------------------------

// rows [r0, r0 + 64) of a bf16 (rows, n) operand (row stride ld, the
// block's first column at src) into dst[64][sd], zeros past `rows` and
// past n up to `width` columns; 16-byte loads when `vec` (src, ld and n
// multiples of 8 elements)
__device__ void stage_rows(bf16* dst, int sd, const bf16* src, long long ld, int r0, int rows,
                           int n, int width, bool vec) {
  if (vec) {
    const int chunks = width / 8;
    for (int idx = threadIdx.x; idx < kTile * chunks; idx += kThreads) {
      const int r = idx / chunks, e = (idx - r * chunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows && e < n) v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + e);
      *reinterpret_cast<uint4*>(dst + r * sd + e) = v;
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < kTile * width; idx += kThreads) {
    const int r = idx / width, e = idx - r * width;
    dst[r * sd + e] = (r0 + r < rows && e < n) ? src[(long long)(r0 + r) * ld + e] : zero;
  }
}

// acc[16] (the warp's 16 x 32 slice: 4 n8 tiles) += sum over t < NT of
// A_t (16 rows of M, one k16 step at k) * B_t (32 columns of N); A_t = a +
// t sta, B_t = b + t stb (a stride of 0 reuses one exact operand).  A is
// stored [m][k] (row stride sa), or [k][m] when TA (ldmatrix.trans); B
// [n][k], or [k][n] when TB.
template <int NT, bool TA, bool TB>
__device__ __forceinline__ void mma_step(float* acc, const bf16* a, int sa, int sta,
                                         const bf16* b, int sb, int stb, int k) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = TA ? a + (k + (lane & 7) + (lane >> 4) * 8) * sa + ((lane >> 3) & 1) * 8
                      : a + (lane & 15) * sa + k + (lane >> 4) * 8;
  uint32_t fa[NT][4], fb[NT][2][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t == 0 || sta != 0) {
      if (TA) hopper::ldmatrix_x4_trans(fa[t], pa + t * sta);
      else hopper::ldmatrix_x4(fa[t], pa + t * sta);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) fa[t][q] = fa[0][q];
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      const bf16* pb = TB ? b + (k + (lane & 7) + ((lane >> 3) & 1) * 8) * sb + nj * 16 + (lane >> 4) * 8
                          : b + (nj * 16 + (lane >> 4) * 8 + (lane & 7)) * sb + k + ((lane >> 3) & 1) * 8;
      if (t == 0 || stb != 0) {
        if (TB) hopper::ldmatrix_x4_trans(fb[t][nj], pb + t * stb);
        else hopper::ldmatrix_x4(fb[t][nj], pb + t * stb);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) fb[t][nj][q] = fb[0][nj][q];
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      hopper::mma_bf16(acc + (2 * nj) * 4, fa[t], fb[t][nj][0], fb[t][nj][1]);
      hopper::mma_bf16(acc + (2 * nj + 1) * 4, fa[t], fb[t][nj][2], fb[t][nj][3]);
    }
}

// the warp's fragment rows (of 16) and columns (of 32): acc[ni * 4 + q]
// is at row (lane >> 2) + 8 (q >> 1), column 8 ni + 2 (lane & 3) + (q & 1)
__device__ __forceinline__ int frag_row(int q) { return ((threadIdx.x & 31) >> 2) + 8 * (q >> 1); }
__device__ __forceinline__ int frag_col(int ni, int q) {
  return 8 * ni + 2 * (threadIdx.x & 3) + (q & 1);
}

// Phase 0, mma: grid (nc * pairs, B*G); dynamic shared memory 2 tiles
// [64][n_stride(N)] bf16.  cb[i, j] = C_i . B_j over the tile pair.
__global__ void __launch_bounds__(kThreads) ssd_cb_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sd = n_stride(p.N), np = round16(p.N);
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = cs + kTile * sd;
  int c, it, jt;
  tile_pair(p, c, it, jt);
  const int b = blockIdx.y / p.G, g = blockIdx.y - b * p.G;
  const long long row0 = (long long)c * p.L;
  stage_rows(cs, sd, static_cast<const bf16*>(p.cm) + b * p.c_sb + row0 * p.c_ss + g * p.c_sg,
             p.c_ss, it * kTile, p.L, p.N, np, p.vec_bc);
  stage_rows(bs, sd, static_cast<const bf16*>(p.bm) + b * p.b_sb + row0 * p.b_ss + g * p.b_sg,
             p.b_ss, jt * kTile, p.L, p.N, np, p.vec_bc);
  __syncthreads();
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  float acc[16] = {};
  for (int k = 0; k < np; k += 16)
    mma_step<1, false, false>(acc, cs + wm * 16 * sd, sd, 0, bs + wn * 32 * sd, sd, 0, k);
  float* out = cb_tile(p, b, g, c);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = it * kTile + wm * 16 + frag_row(q);
      const int j = jt * kTile + wn * 32 + frag_col(ni, q);
      if (i < p.L && j < p.L) out[(long long)i * p.L + j] = acc[ni * 4 + q];
    }
}

// Phase 1, mma: grid (nc, B*H, P tiles x N tiles).  states[b, h, c, p, n]
// = sum_j x_j[p] (B_j[n] wgt_j): A = x stored [j][p] (exact bf16, read
// transposed), B = the split planes of B wgt stored [j][n] (read
// transposed).
__global__ void __launch_bounds__(kThreads) ssd_state_mma_kernel(const Params p) {
  __shared__ double cum[kMaxChunk];
  __shared__ float dts[kMaxChunk], after[kMaxChunk], wgt[kMaxChunk];
  __shared__ __align__(16) bf16 xs[kTile * kXS];          // x      [j][p]
  __shared__ __align__(16) bf16 bw[3][kTile * kXS];       // B w    [j][n], hi / mid / lo
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int n_ptiles = (p.P + kTile - 1) / kTile;
  const int p0 = (blockIdx.z % n_ptiles) * kTile;
  const int n0 = (blockIdx.z / n_ptiles) * kTile;
  state_weights(p, bh, h, c, cum, dts, after, wgt);

  const long long row0 = (long long)c * p.L;
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + row0 * p.x_ss + h * p.x_sh + p0;
  const bf16* bg = static_cast<const bf16*>(p.bm) + b * p.b_sb + row0 * p.b_ss + g * p.b_sg + n0;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  float acc[16] = {};
  for (int j0 = 0; j0 < p.L; j0 += kTile) {
    stage_rows(xs, kXS, xg, p.x_ss, j0, p.L, p.P - p0, kTile, p.vec_x);
    for (int idx = threadIdx.x; idx < kTile * kTile / 2; idx += kThreads) {
      const int jj = idx >> 5, e = (idx & 31) * 2, j = j0 + jj;
      const bf16* src = bg + (long long)j * p.b_ss + e;
      const bool row = j < p.L;
      const float w = row ? wgt[j] : 0.f;
      const float v0 = row && n0 + e < p.N ? __bfloat162float(src[0]) * w : 0.f;
      const float v1 = row && n0 + e + 1 < p.N ? __bfloat162float(src[1]) * w : 0.f;
      split3_pair(v0, v1, &bw[0][jj * kXS + e], kTile * kXS);
    }
    __syncthreads();
    const int kn = round16(min(kTile, p.L - j0));
    for (int k = 0; k < kn; k += 16)
      mma_step<3, true, true>(acc, xs + wm * 16, kXS, 0, bw[0] + wn * 32, kXS, kTile * kXS, k);
    __syncthreads();                    // xs, bw are refilled next round
  }

  const long long PN = (long long)p.P * p.N;
  float* out = p.states + ((long long)bh * p.nc + c) * PN;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = p0 + wm * 16 + frag_row(q), nn = n0 + wn * 32 + frag_col(ni, q);
      if (pp < p.P && nn < p.N) out[(long long)pp * p.N + nn] = acc[ni * 4 + q];
    }
}

int out_mma_smem_bytes(int N) {
  const int sd = n_stride(N);
  const int inter = 3 * kTile * sd, intra = 4 * kTile * kXS;  // h planes | w planes + x
  return (int)sizeof(double) * kMaxChunk + (int)sizeof(float) * 3 * kMaxChunk +
         (int)sizeof(bf16) * (kTile * sd + (inter > intra ? inter : intra));
}

// Phase 3, mma: grid (nc * row tiles, B*H, P tiles); dynamic shared memory
// out_mma_smem_bytes(N).  Row tiles are issued longest (most key tiles)
// first.
__global__ void __launch_bounds__(kThreads) ssd_out_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sd = n_stride(p.N);
  double* cum = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(cum + kMaxChunk);
  float* ea = dts + kMaxChunk;                          // exp(cum_i - cum_i0)
  float* eb = ea + kMaxChunk;                           // exp(cum_i0 - cum_j) dt_j
  bf16* cs = reinterpret_cast<bf16*>(eb + kMaxChunk);   // C rows of this tile [64][sd]
  bf16* hs = cs + kTile * sd;                           // h_prev planes   3 x [64][sd]
  bf16* ws = hs;                                        // w planes        3 x [64][kXS]
  bf16* xs = ws + 3 * kTile * kXS;                      // x               [j][p]

  const int n_itiles = (p.L + kTile - 1) / kTile;
  const int c = blockIdx.x / n_itiles;
  const int it = n_itiles - 1 - (blockIdx.x - c * n_itiles);
  const int i0 = it * kTile;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int p0 = blockIdx.z * kTile;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const long long row0 = (long long)c * p.L;   // the chunk's first position

  chunk_cumsum(p, b, h, c, dts, cum);
  for (int ii = threadIdx.x; ii < kTile; ii += kThreads)
    ea[ii] = i0 + ii < p.L ? expf((float)(cum[i0 + ii] - cum[i0])) : 0.f;
  float acc[16] = {};

  // inter-chunk term: exp(cum_i) (C_i . h_prev); h_prev = 0 in chunk 0
  if (c > 0) {
    const int np = round16(p.N);
    stage_rows(cs, sd, static_cast<const bf16*>(p.cm) + b * p.c_sb + row0 * p.c_ss + g * p.c_sg,
               p.c_ss, i0, p.L, p.N, np, p.vec_bc);
    const float* hg = p.states + ((long long)bh * p.nc + c) * p.P * p.N + (long long)p0 * p.N;
    for (int idx = threadIdx.x; idx < kTile * np / 2; idx += kThreads) {
      const int pp = idx / (np / 2), e = (idx - pp * (np / 2)) * 2;
      const float* src = hg + (long long)pp * p.N + e;
      const bool row = p0 + pp < p.P;
      split3_pair(row && e < p.N ? src[0] : 0.f, row && e + 1 < p.N ? src[1] : 0.f,
                  hs + pp * sd + e, kTile * sd);
    }
    __syncthreads();
    for (int k = 0; k < np; k += 16)
      mma_step<3, false, false>(acc, cs + wm * 16 * sd, sd, 0, hs + wn * 32 * sd, sd, kTile * sd, k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + wm * 16 + frag_row(q);
      const float ei = i < p.L ? expf((float)cum[i]) : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) acc[ni * 4 + q] *= ei;
    }
  }
  __syncthreads();                      // ea; the h planes' space is refilled below

  // intra-chunk term over the key tiles up to the diagonal
  const float* cbg = cb_tile(p, b, g, c);
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + row0 * p.x_ss + h * p.x_sh + p0;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    if (jt < it) {
      // below the diagonal every key precedes every row: exp(cum_i - cum_j)
      // = exp(cum_i - cum_i0) exp(cum_i0 - cum_j), both factors <= 1
      for (int jj = threadIdx.x; jj < kTile; jj += kThreads)
        eb[jj] = expf((float)(cum[i0] - cum[j0 + jj])) * dts[j0 + jj];
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kTile * kTile / 2; idx += kThreads) {
      const int ii = idx >> 5, jj = (idx & 31) * 2, i = i0 + ii, j = j0 + jj;
      const float* src = cbg + (long long)i * p.L + j;
      float w0 = 0.f, w1 = 0.f;
      if (i < p.L) {
        if (jt < it) {
          w0 = src[0] * ea[ii] * eb[jj];
          w1 = src[1] * ea[ii] * eb[jj + 1];
        } else {
          // masked entries never evaluate exp: cum_i - cum_j > 0 for j > i
          if (j <= i) w0 = src[0] * expf((float)(cum[i] - cum[j])) * dts[j];
          if (j + 1 <= i) w1 = src[1] * expf((float)(cum[i] - cum[j + 1])) * dts[j + 1];
        }
      }
      split3_pair(w0, w1, ws + ii * kXS + jj, kTile * kXS);
    }
    stage_rows(xs, kXS, xg, p.x_ss, j0, p.L, p.P - p0, kTile, p.vec_x);
    __syncthreads();
    // on the diagonal tile the warp's rows 16 wm .. 16 wm + 15 reach key
    // 16 wm + 15 at most: k16 steps past wm are zero
    const int ksteps = jt == it ? wm + 1 : kTile / 16;
    for (int kk = 0; kk < ksteps; ++kk)
      mma_step<3, false, true>(acc, ws + wm * 16 * kXS, kXS, kTile * kXS, xs + wn * 32, kXS, 0,
                               kk * 16);
    __syncthreads();                    // eb, ws, xs are refilled next round
  }

  const long long HP = (long long)p.H * p.P;
  bf16* yg = static_cast<bf16*>(p.y) + ((long long)b * p.S + row0 + i0) * HP + (long long)h * p.P + p0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ii = wm * 16 + frag_row(q), pp = wn * 32 + frag_col(ni, q);
      if (i0 + ii < p.L && p0 + pp < p.P) yg[ii * HP + pp] = __float2bfloat16(acc[ni * 4 + q]);
    }
}

// ---- the simt route (fp32 inputs) --------------------------------------------

// Phase 0, simt: grid (nc * pairs, B*G); dynamic shared memory 2 tiles
// [64][N | 1] fp32.
__global__ void __launch_bounds__(kThreads) ssd_cb_simt_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int sn = p.N | 1;
  float* cs = smem;
  float* bs = cs + kTile * sn;
  int c, it, jt;
  tile_pair(p, c, it, jt);
  const int b = blockIdx.y / p.G, g = blockIdx.y - b * p.G;
  const int i0 = it * kTile, j0 = jt * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)c * p.L;
  const float* cg = static_cast<const float*>(p.cm) + b * p.c_sb + row0 * p.c_ss + g * p.c_sg;
  const float* bg = static_cast<const float*>(p.bm) + b * p.b_sb + row0 * p.b_ss + g * p.b_sg;
  for (int idx = tid; idx < kTile * p.N; idx += kThreads) {
    const int r = idx / p.N, e = idx - r * p.N;
    cs[r * sn + e] = i0 + r < p.L ? cg[(long long)(i0 + r) * p.c_ss + e] : 0.f;
    bs[r * sn + e] = j0 + r < p.L ? bg[(long long)(j0 + r) * p.b_ss + e] : 0.f;
  }
  __syncthreads();
  float s[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
#pragma unroll 4
  for (int n = 0; n < p.N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * sn + n];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = bs[(tx + 16 * q) * sn + n];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = fmaf(cv[r], bv[q], s[r][q]);
  }
  float* out = cb_tile(p, b, g, c);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
      if (i < p.L && j < p.L) out[(long long)i * p.L + j] = s[r][q];
    }
}

// Phase 1, simt: grid (nc, B*H, P tiles x N tiles).
__global__ void __launch_bounds__(kThreads) ssd_state_simt_kernel(const Params p) {
  __shared__ double cum[kMaxChunk];
  __shared__ float dts[kMaxChunk], after[kMaxChunk], wgt[kMaxChunk];
  __shared__ float xs[kTile * kPadTile], bs[kTile * kPadTile];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int n_ptiles = (p.P + kTile - 1) / kTile;
  const int p0 = (blockIdx.z % n_ptiles) * kTile;
  const int n0 = (blockIdx.z / n_ptiles) * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  state_weights(p, bh, h, c, cum, dts, after, wgt);

  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + (long long)c * p.L * p.x_ss +
                    h * p.x_sh + p0;
  const float* bg = static_cast<const float*>(p.bm) + b * p.b_sb + (long long)c * p.L * p.b_ss +
                    g * p.b_sg + n0;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int j0 = 0; j0 < p.L; j0 += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int jj = idx >> 6, e = idx & 63, j = j0 + jj;
      const bool row = j < p.L;
      xs[jj * kPadTile + e] = (row && p0 + e < p.P) ? xg[(long long)j * p.x_ss + e] : 0.f;
      bs[jj * kPadTile + e] = (row && n0 + e < p.N) ? bg[(long long)j * p.b_ss + e] * wgt[j] : 0.f;
    }
    __syncthreads();
    const int jn = min(kTile, p.L - j0);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      float xv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[jj * kPadTile + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bs[jj * kPadTile + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xv[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }

  const long long PN = (long long)p.P * p.N;
  float* out = p.states + ((long long)bh * p.nc + c) * PN;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int pp = p0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nn = n0 + tx + 16 * q;
      if (pp < p.P && nn < p.N) out[(long long)pp * p.N + nn] = acc[r][q];
    }
  }
}

// Phase 2 (both routes): grid (ceil(P*N / (256 V)), B*H), V = 4 elements
// a thread when P*N % 4 == 0, else 1.  Walks the chunks in order: each
// chunk's contribution is replaced by the state before the chunk, and the
// state after the last chunk is h_final.  Eight chunks' loads are issued
// before their updates.
template <int V>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
  using Vt = typename std::conditional<V == 4, float4, float>::type;
  const long long PN = (long long)p.P * p.N;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= PN) return;
  const int bh = blockIdx.y;
  Vt* s = reinterpret_cast<Vt*>(p.states + (long long)bh * p.nc * PN + e);
  const long long step = PN / V;
  const float* d = p.decay + (long long)bh * p.nc;
  Vt hv = {};
  for (int c0 = 0; c0 < p.nc; c0 += 8) {
    Vt v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (c0 + q < p.nc) v[q] = s[(c0 + q) * step];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (c0 + q < p.nc) {
        s[(c0 + q) * step] = hv;
        const float a = d[c0 + q];
        if constexpr (V == 4) {
          hv.x = a * hv.x + v[q].x;
          hv.y = a * hv.y + v[q].y;
          hv.z = a * hv.z + v[q].z;
          hv.w = a * hv.w + v[q].w;
        } else {
          hv = a * hv + v[q];
        }
      }
  }
  *reinterpret_cast<Vt*>(p.h_out + (long long)bh * PN + e) = hv;
}

int out_simt_smem_bytes(int N) {
  const int sn = N | 1;
  return (int)sizeof(double) * kMaxChunk +
         (int)sizeof(float) * (kMaxChunk + 2 * kTile * sn + 2 * kTile * kPadTile);
}

// Phase 3, simt: grid (nc * row tiles, B*H, P tiles); dynamic shared
// memory out_simt_smem_bytes(N).  Row tiles are issued longest first.
__global__ void __launch_bounds__(kThreads) ssd_out_simt_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int sn = p.N | 1;               // odd row stride of N-wide tiles
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + kMaxChunk);
  float* cs = dts + kMaxChunk;          // C rows of this tile      [64][sn]
  float* bs = cs + kTile * sn;          // state tile               [64][sn]
  float* xs = bs + kTile * sn;          // x tile                   [64][65]
  float* ws = xs + kTile * kPadTile;    // w tile                   [64][65]

  const int n_itiles = (p.L + kTile - 1) / kTile;
  const int c = blockIdx.x / n_itiles;
  const int it = n_itiles - 1 - (blockIdx.x - c * n_itiles);
  const int i0 = it * kTile;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int p0 = blockIdx.z * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)c * p.L;   // the chunk's first position

  chunk_cumsum(p, b, h, c, dts, cum);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  // inter-chunk term: exp(cum_i) (C_i . h_prev); h_prev = 0 in chunk 0
  if (c > 0) {
    const float* cg = static_cast<const float*>(p.cm) + b * p.c_sb + (row0 + i0) * p.c_ss +
                      g * p.c_sg;
    const float* hg = p.states + ((long long)bh * p.nc + c) * p.P * p.N + (long long)p0 * p.N;
    for (int idx = tid; idx < kTile * p.N; idx += kThreads) {
      const int r = idx / p.N, e = idx - r * p.N;
      cs[r * sn + e] = i0 + r < p.L ? cg[(long long)r * p.c_ss + e] : 0.f;
      bs[r * sn + e] = p0 + r < p.P ? hg[(long long)r * p.N + e] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < p.N; ++n) {
      float cv[4], hv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * sn + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) hv[q] = bs[(tx + 16 * q) * sn + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], hv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      const float ei = i < p.L ? expf((float)cum[i]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= ei;
    }
  }

  // intra-chunk term over the key tiles up to the diagonal
  const float* cbg = cb_tile(p, b, g, c);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + (row0 + j0) * p.x_ss +
                      h * p.x_sh + p0;
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int jj = idx >> 6, e = idx & 63;
      xs[jj * kPadTile + e] = (j0 + jj < p.L && p0 + e < p.P) ? xg[(long long)jj * p.x_ss + e] : 0.f;
      // w row jj (i = i0 + jj), key e (j = j0 + e); masked entries never
      // evaluate exp: cum_i - cum_j > 0 for j > i
      const int i = i0 + jj, j = j0 + e;
      ws[jj * kPadTile + e] =
          (j <= i && i < p.L) ? cbg[(long long)i * p.L + j] * expf((float)(cum[i] - cum[j])) * dts[j]
                              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float wv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wv[r] = ws[(ty + 16 * r) * kPadTile + jj];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[jj * kPadTile + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r], xv[q], acc[r][q]);
    }
    __syncthreads();                    // xs, ws are refilled next round
  }

  const long long HP = (long long)p.H * p.P;
  float* yg = static_cast<float*>(p.y) + ((long long)b * p.S + row0 + i0) * HP + (long long)h * p.P + p0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ii = ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tx + 16 * q;
      if (i0 + ii < p.L && p0 + pp < p.P) yg[ii * HP + pp] = acc[r][q];
    }
  }
}

template <typename K, typename Q>
int launch_one(K kernel, dim3 grid, int smem, const Q& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const Params& p, bool mma, cudaStream_t stream) {
  const int ptiles = (p.P + kTile - 1) / kTile;
  const int ntiles = (p.N + kTile - 1) / kTile;
  const int itiles = (p.L + kTile - 1) / kTile;
  const int pairs = itiles * (itiles + 1) / 2;
  const dim3 g_cb(p.nc * pairs, p.B * p.G), g_state(p.nc, p.B * p.H, ptiles * ntiles);
  const long long PN = (long long)p.P * p.N;
  const int sv = PN % 4 == 0 ? 4 : 1;
  const dim3 g_scan((unsigned)((PN / sv + kThreads - 1) / kThreads), p.B * p.H);
  const dim3 g_out(p.nc * itiles, p.B * p.H, ptiles);
  int e;
  if (mma) {
    if ((e = launch_one(ssd_cb_mma_kernel, g_cb, 2 * kTile * n_stride(p.N) * (int)sizeof(bf16), p,
                        stream)))
      return e;
    if ((e = launch_one(ssd_state_mma_kernel, g_state, 0, p, stream))) return e;
  } else {
    if ((e = launch_one(ssd_cb_simt_kernel, g_cb, 2 * kTile * (p.N | 1) * (int)sizeof(float), p,
                        stream)))
      return e;
    if ((e = launch_one(ssd_state_simt_kernel, g_state, 0, p, stream))) return e;
  }
  if ((e = sv == 4 ? launch_one(ssd_scan_kernel<4>, g_scan, 0, p, stream)
                   : launch_one(ssd_scan_kernel<1>, g_scan, 0, p, stream)))
    return e;
  return mma ? launch_one(ssd_out_mma_kernel, g_out, out_mma_smem_bytes(p.N), p, stream)
             : launch_one(ssd_out_simt_kernel, g_out, out_simt_smem_bytes(p.N), p, stream);
}


// ---- the backward ------------------------------------------------------------

struct BwdParams {
  Params f;             // the forward's inputs and strides; f.states: the state
                        // before each chunk as the forward wrote it, f.decay and
                        // f.cb this call's scratch
  const void* dy;       // (B, S, H, P) contiguous, x's dtype
  const float* dh;      // (B, H, P, N) or nullptr (zero)
  float* dstate;        // (B, H, nc, P, N): each chunk's reverse contribution,
                        // then the gradient of the state after the chunk
  void* dx;             // (B, S, H, P) contiguous, x's dtype
  float* ddt;           // (B, S, H) contiguous
  float* dA;            // (H,)
  void* dbm;            // (B, S, G, N) contiguous, B's dtype
  void* dcm;
  float* dbh;           // (B, H, S, N) each head's share of dB
  float* dch;           //                          and of dC
  double* vec;          // (kVecs, B, H, S) per-position terms of ddt
  float* da_part;       // (B, H, nc) each chunk's share of dA
};

constexpr int kVecs = 5;
enum { kRowW = 0, kEi = 1, kGsum = 2, kSv = 3, kSd = 4 };
constexpr int kNS = kMaxN + 1;          // odd row stride of 128-wide fp32 tiles

__device__ __forceinline__ float ld(const float* a) { return *a; }
__device__ __forceinline__ float ld(const bf16* a) { return __bfloat162float(*a); }
__device__ __forceinline__ void st(float* a, float v) { *a = v; }
__device__ __forceinline__ void st(bf16* a, float v) { *a = __float2bfloat16(v); }

template <typename T>
__device__ __forceinline__ const T* x_at(const Params& p, int b, long long s, int h) {
  return static_cast<const T*>(p.x) + b * p.x_sb + s * p.x_ss + h * p.x_sh;
}
template <typename T>
__device__ __forceinline__ const T* b_at(const Params& p, int b, long long s, int g) {
  return static_cast<const T*>(p.bm) + b * p.b_sb + s * p.b_ss + g * p.b_sg;
}
template <typename T>
__device__ __forceinline__ const T* c_at(const Params& p, int b, long long s, int g) {
  return static_cast<const T*>(p.cm) + b * p.c_sb + s * p.c_ss + g * p.c_sg;
}
template <typename T>
__device__ __forceinline__ const T* dy_at(const BwdParams& q, int b, long long s, int h) {
  return static_cast<const T*>(q.dy) + (((long long)b * q.f.S + s) * q.f.H + h) * q.f.P;
}
__device__ __forceinline__ double* vec_at(const BwdParams& q, int k, int bh, long long s) {
  return q.vec + ((long long)k * q.f.B * q.f.H + bh) * q.f.S + s;
}

// Backward 1: grid (nc, B*H, P tiles x N tiles).  The chunk's reverse
// contribution to the gradient of the state before it, sum_i exp(cum_i)
// dy_i (x) C_i, into dstate; decay[b, h, c] = exp(cum_last).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(const BwdParams q) {
  const Params& p = q.f;
  __shared__ double cum[kMaxChunk];
  __shared__ float dts[kMaxChunk], ecum[kMaxChunk];
  __shared__ float ys[kTile * kPadTile], cs[kTile * kPadTile];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int n_ptiles = (p.P + kTile - 1) / kTile;
  const int p0 = (blockIdx.z % n_ptiles) * kTile;
  const int n0 = (blockIdx.z / n_ptiles) * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  chunk_cumsum(p, b, h, c, dts, cum);
  for (int j = tid; j < p.L; j += kThreads) ecum[j] = expf((float)cum[j]);
  if (blockIdx.z == 0 && tid == 0) p.decay[(long long)bh * p.nc + c] = expf((float)cum[p.L - 1]);
  __syncthreads();
  const long long row0 = (long long)c * p.L;
  float acc[4][4] = {};
  for (int j0 = 0; j0 < p.L; j0 += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int jj = idx >> 6, e = idx & 63, j = j0 + jj;
      const bool row = j < p.L;
      ys[jj * kPadTile + e] =
          (row && p0 + e < p.P) ? ld(dy_at<T>(q, b, row0 + j, h) + p0 + e) * ecum[j] : 0.f;
      cs[jj * kPadTile + e] = (row && n0 + e < p.N) ? ld(c_at<T>(p, b, row0 + j, g) + n0 + e) : 0.f;
    }
    __syncthreads();
    const int jn = min(kTile, p.L - j0);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      float yv[4], cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = ys[jj * kPadTile + ty + 16 * r];
#pragma unroll
      for (int u = 0; u < 4; ++u) cv[u] = cs[jj * kPadTile + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(yv[r], cv[u], acc[r][u]);
    }
    __syncthreads();
  }
  float* out = q.dstate + ((long long)bh * p.nc + c) * p.P * p.N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int pp = p0 + ty + 16 * r;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int nn = n0 + tx + 16 * u;
      if (pp < p.P && nn < p.N) out[(long long)pp * p.N + nn] = acc[r][u];
    }
  }
}

// Backward 2: grid (ceil(P*N / (256 V)), B*H).  The reverse pass over the
// chunks, last to first, from dh: each chunk's contribution is replaced by
// the gradient of the state after the chunk, g, and g <- decay_c g + the
// contribution.  Eight chunks' loads are issued before their updates.
template <int V>
__global__ void __launch_bounds__(kThreads) ssd_bwd_scan_kernel(const BwdParams q) {
  const Params& p = q.f;
  using Vt = typename std::conditional<V == 4, float4, float>::type;
  const long long PN = (long long)p.P * p.N;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= PN) return;
  const int bh = blockIdx.y;
  Vt* s = reinterpret_cast<Vt*>(q.dstate + (long long)bh * p.nc * PN + e);
  const long long step = PN / V;
  const float* d = p.decay + (long long)bh * p.nc;
  Vt gv = {};
  if (q.dh != nullptr) gv = *reinterpret_cast<const Vt*>(q.dh + (long long)bh * PN + e);
  for (int c1 = p.nc; c1 > 0; c1 -= 8) {
    Vt v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c1 - 1 - u >= 0) v[u] = s[(c1 - 1 - u) * step];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c1 - 1 - u;
      if (c >= 0) {
        s[c * step] = gv;
        const float a = d[c];
        if constexpr (V == 4) {
          gv.x = a * gv.x + v[u].x;
          gv.y = a * gv.y + v[u].y;
          gv.z = a * gv.z + v[u].z;
          gv.w = a * gv.w + v[u].w;
        } else {
          gv = a * gv + v[u];
        }
      }
    }
  }
}

// Backward 3: grid (nc * key tiles, B*H, P tiles).  dx_j = sum_{i>=j}
// (C_i . B_j) exp(cum_i - cum_j) dt_j dy_i + dt_j exp(after_j) hn B_j over
// a 64-key, 64-wide P tile; the row tiles on or below the diagonal only,
// masked entries never evaluating exp.  Key tile 0 (the most row tiles) is
// issued first.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dx_kernel(const BwdParams q) {
  const Params& p = q.f;
  __shared__ double cum[kMaxChunk];
  __shared__ float dts[kMaxChunk], after[kMaxChunk], wgt[kMaxChunk];
  __shared__ float ws[kTile * kPadTile], ds[kTile * kPadTile];
  const int n_t = (p.L + kTile - 1) / kTile;
  const int c = blockIdx.x / n_t, jt = blockIdx.x - c * n_t;
  const int j0 = jt * kTile;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int p0 = blockIdx.z * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  chunk_cumsum(p, b, h, c, dts, cum);
  chunk_suffix(p, h, dts, after);
  for (int j = tid; j < p.L; j += kThreads) wgt[j] = dts[j] * expf(after[j]);
  __syncthreads();
  const long long row0 = (long long)c * p.L;
  const float* cbg = cb_tile(p, b, g, c);
  float acc[4][4] = {};
  for (int it = jt; it < n_t; ++it) {
    const int i0 = it * kTile;
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int rr = idx >> 6, e = idx & 63;
      // ws[key j0 + rr][row i0 + e]: the weight, on j <= i only
      const int j = j0 + rr, i = i0 + e;
      ws[rr * kPadTile + e] = (j <= i && i < p.L)
                                  ? cbg[(long long)i * p.L + j] * expf((float)(cum[i] - cum[j])) * dts[j]
                                  : 0.f;
      // ds[row i0 + rr][p0 + e]
      ds[rr * kPadTile + e] =
          (i0 + rr < p.L && p0 + e < p.P) ? ld(dy_at<T>(q, b, row0 + i0 + rr, h) + p0 + e) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      float wv[4], dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wv[r] = ws[(ty + 16 * r) * kPadTile + ii];
#pragma unroll
      for (int u = 0; u < 4; ++u) dv[u] = ds[ii * kPadTile + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(wv[r], dv[u], acc[r][u]);
    }
    __syncthreads();                    // ws, ds are refilled next round
  }
  // the state term: B_j wgt_j against the gradient of the state after the chunk
  const float* hn = q.dstate + ((long long)bh * p.nc + c) * p.P * p.N;
  for (int n0 = 0; n0 < p.N; n0 += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int rr = idx >> 6, e = idx & 63, j = j0 + rr;
      ws[rr * kPadTile + e] =
          (j < p.L && n0 + e < p.N) ? ld(b_at<T>(p, b, row0 + j, g) + n0 + e) * wgt[j] : 0.f;
      ds[rr * kPadTile + e] =
          (p0 + rr < p.P && n0 + e < p.N) ? hn[(long long)(p0 + rr) * p.N + n0 + e] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < kTile; ++e) {
      float bv[4], hv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = ws[(ty + 16 * r) * kPadTile + e];
#pragma unroll
      for (int u = 0; u < 4; ++u) hv[u] = ds[(tx + 16 * u) * kPadTile + e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(bv[r], hv[u], acc[r][u]);
    }
    __syncthreads();
  }
  const long long HP = (long long)p.H * p.P;
  T* dxg = static_cast<T*>(q.dx) + ((long long)b * p.S + row0 + j0) * HP + (long long)h * p.P + p0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int jj = ty + 16 * r;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pp = tx + 16 * u;
      if (j0 + jj < p.L && p0 + pp < p.P) st(dxg + jj * HP + pp, acc[r][u]);
    }
  }
}

int bwd_tiles_smem_bytes() {
  return (int)sizeof(double) * (kMaxChunk + kTile) +
         (int)sizeof(float) * (3 * kMaxChunk + 3 * kTile * kPadTile + kTile * kNS);
}

// m[r][u] (rows a0 + ty + 16 r of `ra`, rows b0 + tx + 16 u of `rb`) =
// sum over p of ra[.][p] rb[.][p]: the two (rows, P) operands staged 64
// columns of P at a time into as / bs ([64][65]); ends synchronised.
template <typename T, typename FA, typename FB>
__device__ __forceinline__ void rows_dot(float (&m)[4][4], const Params& p, FA ra, FB rb, int na,
                                         int nb, float* as, float* bs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int pc = 0; pc < p.P; pc += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int rr = idx >> 6, e = idx & 63;
      const bool col = pc + e < p.P;
      as[rr * kPadTile + e] = (rr < na && col) ? ld(ra(rr) + pc + e) : 0.f;
      bs[rr * kPadTile + e] = (rr < nb && col) ? ld(rb(rr) + pc + e) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int e = 0; e < kTile; ++e) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = as[(ty + 16 * r) * kPadTile + e];
#pragma unroll
      for (int u = 0; u < 4; ++u) bv[u] = bs[(tx + 16 * u) * kPadTile + e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) m[r][u] = fmaf(av[r], bv[u], m[r][u]);
    }
    __syncthreads();
  }
}

// acc[r][u] (rows ty + 16 r, state columns tx + 16 u, u < 8) += sum over
// p of ys[row][p] * state[p][column], the (P, N) fp32 state at `st` staged
// 64 rows at a time into ws ([64][129]) and the (rows, P) operand by `ra`
// into ys; ends synchronised.
template <typename T, typename FA>
__device__ __forceinline__ void rows_state(float (&acc)[4][8], const Params& p, FA ra, int na,
                                           const float* stt, float* ys, float* ws) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int pc = 0; pc < p.P; pc += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int rr = idx >> 6, e = idx & 63;
      ys[rr * kPadTile + e] = (rr < na && pc + e < p.P) ? ld(ra(rr) + pc + e) : 0.f;
    }
    for (int idx = tid; idx < kTile * kMaxN; idx += kThreads) {
      const int pp = idx >> 7, n = idx & (kMaxN - 1);
      ws[pp * kNS + n] = (pc + pp < p.P && n < p.N) ? stt[(long long)(pc + pp) * p.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int e = 0; e < kTile; ++e) {
      float yv[4], hv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = ys[(ty + 16 * r) * kPadTile + e];
#pragma unroll
      for (int u = 0; u < 8; ++u) hv[u] = ws[e * kNS + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[r][u] = fmaf(yv[r], hv[u], acc[r][u]);
    }
    __syncthreads();
  }
}

// sum of v over the 16 threads of a row (a half-warp), in a fixed order
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Backward 4: grid (nc * row tiles, B*H); dynamic shared memory
// bwd_tiles_smem_bytes().  For 64 rows i and every state column: this
// head's share of dC_i = sum_{j<=i} T_ij B_j + exp(cum_i) h_prev^T dy_i,
// with T_ij = exp(cum_i - cum_j) dt_j (dy_i . x_j), into dch; the row
// sums sum_j (C_i . B_j) T_ij and E_i = exp(cum_i) dy_i . (h_prev C_i)
// into vec (summed in double).  Row tiles are issued longest first.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dc_kernel(const BwdParams q) {
  const Params& p = q.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);
  double* rs = cum + kMaxChunk;         // row sums, one a row
  float* dts = reinterpret_cast<float*>(rs + kTile);
  float* ys = dts + 3 * kMaxChunk;      // dy rows      [64][65]
  float* xs = ys + kTile * kPadTile;    // x rows       [64][65]
  float* ts = xs + kTile * kPadTile;    // T            [i][j]
  float* ws = ts + kTile * kPadTile;    // B rows [j][n], then h_prev [p][n]
  const int n_t = (p.L + kTile - 1) / kTile;
  const int c = blockIdx.x / n_t, it = n_t - 1 - (blockIdx.x - c * n_t);
  const int i0 = it * kTile;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)c * p.L;
  chunk_cumsum(p, b, h, c, dts, cum);
  if (tid < kTile) rs[tid] = 0.0;
  const float* cbg = cb_tile(p, b, g, c);
  const int ni = min(kTile, p.L - i0);
  auto dy_row = [&](int rr) { return dy_at<T>(q, b, row0 + i0 + rr, h); };
  float acc[4][8] = {};
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    float m[4][4] = {};
    rows_dot<T>(m, p, dy_row, [&](int rr) { return x_at<T>(p, b, row0 + j0 + rr, h); }, ni,
                min(kTile, p.L - j0), ys, xs);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ii = ty + 16 * r, jj = tx + 16 * u, i = i0 + ii, j = j0 + jj;
        ts[ii * kPadTile + jj] =
            (j <= i && i < p.L) ? expf((float)(cum[i] - cum[j])) * dts[j] * m[r][u] : 0.f;
      }
    for (int idx = tid; idx < kTile * kMaxN; idx += kThreads) {
      const int rr = idx >> 7, n = idx & (kMaxN - 1);
      ws[rr * kNS + n] = (j0 + rr < p.L && n < p.N) ? ld(b_at<T>(p, b, row0 + j0 + rr, g) + n) : 0.f;
    }
    __syncthreads();
    if (tid < kTile && i0 + tid < p.L) {
      const int i = i0 + tid, jn = min(kTile, i - j0 + 1);
      double sum = 0.0;
      for (int jj = 0; jj < jn; ++jj)
        sum += (double)cbg[(long long)i * p.L + j0 + jj] * (double)ts[tid * kPadTile + jj];
      rs[tid] += sum;
    }
#pragma unroll 2
    for (int jj = 0; jj < kTile; ++jj) {
      float tv[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) tv[r] = ts[(ty + 16 * r) * kPadTile + jj];
#pragma unroll
      for (int u = 0; u < 8; ++u) bv[u] = ws[jj * kNS + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[r][u] = fmaf(tv[r], bv[u], acc[r][u]);
    }
    __syncthreads();                    // ts, ws are refilled next round
  }
  // the inter-chunk term, from the state before the chunk (zero in chunk 0)
  float e_part[4] = {};
  if (c > 0) {
    float v[4][8] = {};
    rows_state<T>(v, p, dy_row, ni, p.states + ((long long)bh * p.nc + c) * p.P * p.N, ys, ws);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= p.L) continue;
      const float ei = expf((float)cum[i]);
      const T* ci = c_at<T>(p, b, row0 + i, g);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int n = tx + 16 * u;
        const float t = v[r][u] * ei;
        acc[r][u] += t;
        if (n < p.N) e_part[r] = fmaf(t, ld(ci + n), e_part[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) e_part[r] = row_sum16(e_part[r]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= p.L) continue;
    float* out = q.dch + (((long long)b * p.H + h) * p.S + row0 + i) * p.N;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int n = tx + 16 * u;
      if (n < p.N) out[n] = acc[r][u];
    }
    if (tx == 0) *vec_at(q, kEi, bh, row0 + i) = e_part[r];
  }
  if (tid < kTile && i0 + tid < p.L) *vec_at(q, kRowW, bh, row0 + i0 + tid) = rs[tid];
}

// Backward 5: grid (nc * key tiles, B*H); dynamic shared memory
// bwd_tiles_smem_bytes().  For 64 keys j and every state column: this
// head's share of dB_j = dt_j sum_{i>=j} exp(cum_i - cum_j) (dy_i . x_j)
// C_i + dt_j exp(after_j) hn^T x_j, into dbh; the column sums G_j =
// sum_i (C_i . B_j) exp(cum_i - cum_j) (dy_i . x_j) and the state term's
// Sd_j = exp(after_j) <hn, x_j (x) B_j> and dt_j Sd_j into vec.  Key tile
// 0 (the most row tiles) is issued first.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_db_kernel(const BwdParams q) {
  const Params& p = q.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);
  double* gs = cum + kMaxChunk;         // column sums, one a key
  float* dts = reinterpret_cast<float*>(gs + kTile);
  float* after = dts + kMaxChunk;
  float* xs = dts + 3 * kMaxChunk;      // x rows       [64][65]
  float* ys = xs + kTile * kPadTile;    // dy rows      [64][65]
  float* ts = ys + kTile * kPadTile;    // exp(.) M     [j][i]
  float* ws = ts + kTile * kPadTile;    // C rows [i][n], then hn [p][n]
  const int n_t = (p.L + kTile - 1) / kTile;
  const int c = blockIdx.x / n_t, jt = blockIdx.x - c * n_t;
  const int j0 = jt * kTile;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)c * p.L;
  chunk_cumsum(p, b, h, c, dts, cum);
  chunk_suffix(p, h, dts, after);
  if (tid < kTile) gs[tid] = 0.0;
  const float* cbg = cb_tile(p, b, g, c);
  const int nj = min(kTile, p.L - j0);
  auto x_row = [&](int rr) { return x_at<T>(p, b, row0 + j0 + rr, h); };
  float acc[4][8] = {};
  for (int it = jt; it < n_t; ++it) {
    const int i0 = it * kTile;
    float m[4][4] = {};
    rows_dot<T>(m, p, x_row, [&](int rr) { return dy_at<T>(q, b, row0 + i0 + rr, h); }, nj,
                min(kTile, p.L - i0), xs, ys);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = ty + 16 * r, ii = tx + 16 * u, j = j0 + jj, i = i0 + ii;
        ts[jj * kPadTile + ii] =
            (j <= i && i < p.L) ? expf((float)(cum[i] - cum[j])) * m[r][u] : 0.f;
      }
    for (int idx = tid; idx < kTile * kMaxN; idx += kThreads) {
      const int rr = idx >> 7, n = idx & (kMaxN - 1);
      ws[rr * kNS + n] = (i0 + rr < p.L && n < p.N) ? ld(c_at<T>(p, b, row0 + i0 + rr, g) + n) : 0.f;
    }
    __syncthreads();
    if (tid < kTile && j0 + tid < p.L) {
      const int j = j0 + tid, ii0 = max(0, j - i0), in_ = min(kTile, p.L - i0);
      double sum = 0.0;
      for (int ii = ii0; ii < in_; ++ii)
        sum += (double)cbg[(long long)(i0 + ii) * p.L + j] * (double)ts[tid * kPadTile + ii];
      gs[tid] += sum;
    }
#pragma unroll 2
    for (int ii = 0; ii < kTile; ++ii) {
      float tv[4], cv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) tv[r] = ts[(ty + 16 * r) * kPadTile + ii];
#pragma unroll
      for (int u = 0; u < 8; ++u) cv[u] = ws[ii * kNS + tx + 16 * u];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[r][u] = fmaf(tv[r], cv[u], acc[r][u]);
    }
    __syncthreads();
  }
  // the state term: hn^T x_j, weighted by dt_j exp(after_j)
  float v[4][8] = {};
  rows_state<T>(v, p, x_row, nj, q.dstate + ((long long)bh * p.nc + c) * p.P * p.N, xs, ws);
  float sd[4] = {};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= p.L) continue;
    const float w = dts[j] * expf(after[j]);
    const T* bj = b_at<T>(p, b, row0 + j, g);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int n = tx + 16 * u;
      acc[r][u] = fmaf(w, v[r][u], dts[j] * acc[r][u]);
      if (n < p.N) sd[r] = fmaf(v[r][u], ld(bj + n), sd[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) sd[r] = row_sum16(sd[r]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= p.L) continue;
    float* out = q.dbh + (((long long)b * p.H + h) * p.S + row0 + j) * p.N;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int n = tx + 16 * u;
      if (n < p.N) out[n] = acc[r][u];
    }
    if (tx == 0) {
      const double s_d = (double)expf(after[j]) * (double)sd[r];
      *vec_at(q, kSd, bh, row0 + j) = s_d;
      *vec_at(q, kSv, bh, row0 + j) = (double)dts[j] * s_d;
    }
  }
  if (tid < kTile && j0 + tid < p.L) *vec_at(q, kGsum, bh, row0 + j0 + tid) = gs[tid];
}

// Backward 6: grid (nc, B*H).  The exponents' gradient d(cum) from the
// per-position terms, d(la) its reverse cumsum within the chunk (in
// double, one thread), ddt and the chunk's share of dA.
__global__ void __launch_bounds__(kThreads) ssd_bwd_dt_kernel(const BwdParams q) {
  const Params& p = q.f;
  __shared__ double cum[kMaxChunk];
  __shared__ float dts[kMaxChunk];
  __shared__ double vs[kVecs][kMaxChunk];
  __shared__ float red[kThreads];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x;
  chunk_cumsum(p, b, h, c, dts, cum);
  const long long row0 = (long long)c * p.L;
  for (int idx = tid; idx < kVecs * p.L; idx += kThreads) {
    const int k = idx / p.L, j = idx - k * p.L;
    vs[k][j] = *vec_at(q, k, bh, row0 + j);
  }
  // <hn, h_prev> over the chunk's state, summed in a fixed order
  const long long PN = (long long)p.P * p.N;
  const float* hn = q.dstate + ((long long)bh * p.nc + c) * PN;
  const float* hp = p.states + ((long long)bh * p.nc + c) * PN;
  float part = 0.f;
  for (long long e = tid; e < PN; e += kThreads) part = fmaf(hn[e], hp[e], part);
  red[tid] = part;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    const double d_c = (double)expf((float)cum[p.L - 1]) * (double)red[0];
    double s_tot = 0.0;
    for (int j = 0; j < p.L; ++j) s_tot += vs[kSv][j];
    const float a = p.A[h];
    double run = 0.0, da = 0.0;
    float* ddt = q.ddt + ((long long)b * p.S + row0) * p.H + h;
    for (int k = p.L - 1; k >= 0; --k) {
      double dcum = vs[kRowW][k] - (double)dts[k] * vs[kGsum][k] + vs[kEi][k] - vs[kSv][k];
      if (k == p.L - 1) dcum += s_tot + d_c;
      run += dcum;
      ddt[(long long)k * p.H] = (float)(vs[kGsum][k] + vs[kSd][k] + run * (double)a);
      da += run * (double)dts[k];
    }
    q.da_part[(long long)bh * p.nc + c] = (float)da;
  }
}

// Backward 7: one thread an element of (B, S, G, N): dB and dC, each head's
// share summed over the group's heads in order, in B's dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_heads_kernel(const BwdParams q) {
  const Params& p = q.f;
  const long long total = (long long)p.B * p.S * p.G * p.N;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int n = (int)(idx % p.N);
  long long t = idx / p.N;
  const int g = (int)(t % p.G);
  t /= p.G;
  const long long s = t % p.S;
  const int b = (int)(t / p.S);
  const int rep = p.H / p.G;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < rep; ++k) {
    const long long off = (((long long)b * p.H + g * rep + k) * p.S + s) * p.N + n;
    sb += q.dbh[off];
    sc += q.dch[off];
  }
  st(static_cast<T*>(q.dbm) + idx, sb);
  st(static_cast<T*>(q.dcm) + idx, sc);
}

// Backward 8: one thread a head: dA[h], the chunks' shares summed over the
// batch and the chunks in order.
__global__ void __launch_bounds__(kThreads) ssd_bwd_da_kernel(const BwdParams q) {
  const Params& p = q.f;
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= p.H) return;
  double s = 0.0;
  for (int b = 0; b < p.B; ++b)
    for (int c = 0; c < p.nc; ++c) s += q.da_part[((long long)b * p.H + h) * p.nc + c];
  q.dA[h] = (float)s;
}

template <typename T>
int launch_bwd(const BwdParams& q, cudaStream_t stream) {
  const Params& p = q.f;
  const bool mma = std::is_same<T, bf16>::value;
  const int ptiles = (p.P + kTile - 1) / kTile;
  const int ntiles = (p.N + kTile - 1) / kTile;
  const int itiles = (p.L + kTile - 1) / kTile;
  const int pairs = itiles * (itiles + 1) / 2;
  const long long PN = (long long)p.P * p.N;
  const int sv = PN % 4 == 0 ? 4 : 1;
  const int smem = bwd_tiles_smem_bytes();
  int e;
  // C.B^T once per group, as the forward's phase 0
  if (mma) {
    if ((e = launch_one(ssd_cb_mma_kernel, dim3(p.nc * pairs, p.B * p.G),
                        2 * kTile * n_stride(p.N) * (int)sizeof(bf16), p, stream)))
      return e;
  } else {
    if ((e = launch_one(ssd_cb_simt_kernel, dim3(p.nc * pairs, p.B * p.G),
                        2 * kTile * (p.N | 1) * (int)sizeof(float), p, stream)))
      return e;
  }
  if ((e = launch_one(ssd_bwd_state_kernel<T>, dim3(p.nc, p.B * p.H, ptiles * ntiles), 0, q, stream)))
    return e;
  const dim3 g_scan((unsigned)((PN / sv + kThreads - 1) / kThreads), p.B * p.H);
  if ((e = sv == 4 ? launch_one(ssd_bwd_scan_kernel<4>, g_scan, 0, q, stream)
                   : launch_one(ssd_bwd_scan_kernel<1>, g_scan, 0, q, stream)))
    return e;
  if ((e = launch_one(ssd_bwd_dx_kernel<T>, dim3(p.nc * itiles, p.B * p.H, ptiles), 0, q, stream)))
    return e;
  if ((e = launch_one(ssd_bwd_dc_kernel<T>, dim3(p.nc * itiles, p.B * p.H), smem, q, stream))) return e;
  if ((e = launch_one(ssd_bwd_db_kernel<T>, dim3(p.nc * itiles, p.B * p.H), smem, q, stream))) return e;
  if ((e = launch_one(ssd_bwd_dt_kernel, dim3(p.nc, p.B * p.H), 0, q, stream))) return e;
  const long long total = (long long)p.B * p.S * p.G * p.N;
  if ((e = launch_one(ssd_bwd_heads_kernel<T>, dim3((unsigned)((total + kThreads - 1) / kThreads)), 0,
                      q, stream)))
    return e;
  return launch_one(ssd_bwd_da_kernel, dim3((p.H + kThreads - 1) / kThreads), 0, q, stream);
}

// bf16 rows of n elements at ptr with these strides (elements) in 16-byte
// vectors: the base 16-byte aligned, n and every stride multiples of 8
bool aligned8(const void* ptr, int n, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && n % 8 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

}  // namespace

extern "C" {

// x (B, S, H, P) and B/C (B, S, G, N), bf16 (is_bf16 = 1: the mma route)
// or fp32 (the simt route), with (batch, seq, head/group) strides in
// elements and the last axis contiguous; dt (B, S, H) fp32 by strides; A
// (H,) fp32.  y (B, S, H, P) contiguous in x's dtype; h_out (B, H, P, N),
// states (B, H, S/L, P, N), decay (B, H, S/L) and cb (B, G, S/L, L, L)
// contiguous fp32.  1 <= L <= 256, S % L == 0, 1 <= N <= 128, H % G == 0.
int rt_ssd(const void* x, const void* dt, const void* A, const void* bm, const void* cm, void* y,
           void* h_out, void* states, void* decay, void* cb, int B, int S, int H, int P, int G,
           int N, int L, int is_bf16, long long x_sb, long long x_ss, long long x_sh,
           long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
           long long b_sg, long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || N < 1 || N > kMaxN || L < 1 ||
      L > kMaxChunk || S % L != 0 || H % G != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), bm, cm, y,
                 static_cast<float*>(h_out), static_cast<float*>(states),
                 static_cast<float*>(decay), static_cast<float*>(cb), B, S, H, P, G, N, L, S / L,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
                 aligned8(x, P, x_sb, x_ss, x_sh), aligned8(bm, N, b_sb, b_ss, b_sg) &&
                                                       aligned8(cm, N, c_sb, c_ss, c_sg)};
  return launch(p, is_bf16 != 0, static_cast<cudaStream_t>(stream));
}


// The backward of rt_ssd.  x, dt, A, bm, cm, the strides, B .. L and
// is_bf16 as rt_ssd's; states (B, H, S/L, P, N) fp32: the state before each
// chunk as rt_ssd wrote it; dy (B, S, H, P) contiguous in x's dtype; dh
// (B, H, P, N) fp32 or null.  Writes dx (B, S, H, P) in x's dtype, ddt (B,
// S, H) and dA (H,) fp32, dbm and dcm (B, S, G, N) in B's dtype, all
// contiguous; dstate (B, H, S/L, P, N), decay (B, H, S/L), cb (B, G, S/L,
// L, L), dbh and dch (B, H, S, N) and da_part (B, H, S/L) are fp32
// scratch, vec (5, B, H, S) float64 scratch.
int rt_ssd_backward(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                    const void* states, const void* dy, const void* dh, void* dstate, void* decay,
                    void* cb, void* dx, void* ddt, void* dA, void* dbm, void* dcm, void* dbh,
                    void* dch, void* vec, void* da_part, int B, int S, int H, int P, int G, int N,
                    int L, int is_bf16, long long x_sb, long long x_ss, long long x_sh,
                    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
                    long long b_ss, long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                    void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || N < 1 || N > kMaxN || L < 1 ||
      L > kMaxChunk || S % L != 0 || H % G != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params f{x, static_cast<const float*>(dt), static_cast<const float*>(A), bm, cm, nullptr,
                 nullptr, const_cast<float*>(static_cast<const float*>(states)),
                 static_cast<float*>(decay), static_cast<float*>(cb), B, S, H, P, G, N, L, S / L,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
                 aligned8(x, P, x_sb, x_ss, x_sh), aligned8(bm, N, b_sb, b_ss, b_sg) &&
                                                       aligned8(cm, N, c_sb, c_ss, c_sg)};
  const BwdParams q{f, dy, static_cast<const float*>(dh), static_cast<float*>(dstate), dx,
                    static_cast<float*>(ddt), static_cast<float*>(dA), dbm, dcm,
                    static_cast<float*>(dbh), static_cast<float*>(dch), static_cast<double*>(vec),
                    static_cast<float*>(da_part)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<bf16>(q, st) : launch_bwd<float>(q, st);
}

}  // extern "C"

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
// moved (chip_smoke.py ssd_bwd_work): 1.28 ms at 67 TFLOP/s FFMA.  On the
// tensor cores the bf16 route's own count (C.B^T once, M twice, each
// product with an fp32 operand three times) is 0.26 ms at 989 TFLOP/s,
// the fp32 route's (every product as three TF32 products) 0.89 ms at
// mma.sync's sustained 320 TFLOP/s (chip_smoke.py ssd_bwd_mma_bound): bound
// by operations.  The first design (FFMA, M formed twice and dx in a third
// pass, operands staged an element at a time, each head's dB and dC into
// (B, H, S, N) fp32 scratch, the ddt sums on 64 threads) ran 5.6x its
// FFMA bound.
//
// What the design does about it: seven device kernels a call.
//   0. C.B^T once per group (the forward's phase-0 kernel of the route);
//   1. ssd_bwd_state: per (b, h, chunk, 64 rows of P), the chunk's reverse
//      contribution sum_i exp(cum_i) dy_i (x) C_i, a (P x L)(L x N) product
//      on the tensor cores over every state column;
//   2. ssd_bwd_scan: per (b, h, 4 state elements), the pass over the
//      chunks from the last, from dh: each contribution is replaced by
//      the gradient of the state after its chunk, hn;
//   3. ssd_bwd_keys: per (b, group, head slice, chunk, 64 keys), the
//      slice's heads in order; per head the state terms (dx_j = wgt_j hn
//      B_j, dB_j += wgt_j hn^T x_j), then over the row tiles i >= j the
//      M tile, T, w and the column sums in registers and dx_j += w^T dy_i,
//      dB_j += T^T C_i: dx folds into the pass that forms dB's T;
//   4. ssd_bwd_rows: per (b, group, head slice, chunk, 64 rows), the
//      inter term dC_i += exp(cum_i) h_prev^T dy_i, then over the key
//      tiles j <= i the M tile and T in registers, dC_i += T B_j and the
//      row sums;
//   5. ssd_bwd_dt: per (b, h, chunk), a thread a position: d(cum) from the
//      per-position sums, d(la) its reverse cumsum in double (a shuffle
//      scan), ddt and the chunk's share of dA;
//   6. ssd_bwd_sums: dB and dC, the head slices' shares added in order,
//      and dA, the chunks' shares summed in order.
// Every product runs on mma.sync.  bf16 ("bwd_bf16"): m16n8k16 from
// ldmatrix; M = dy x^T and C.B^T are bf16 x bf16, exact in the fp32
// accumulator, one product each; the fp32 operands (w and T, exp(cum) dy,
// hn, h_prev) are split into three bf16 planes (split3_pair) as the
// forward's mma route does, three products into one accumulator; a scale
// of the output row (wgt_j of the state terms, exp(cum_i) of the inter
// term) is applied after the product.  fp32 ("bwd_f32"): split TF32 on
// m16n8k8, lo.hi + hi.lo + hi.hi, each k-step's products summed in a
// fresh accumulator and then added (the forward's FFMA C.B^T kernel, 0.3
// % of the work, stays; splitting the shared dy or x tile once for the
// block, rather than in each warp, measured slower: more registers).
// The row scales wgt_j = dt_j exp(after_j) and exp(cum_i) are taken in
// double, each scaled term rounded once (where the decay is strong they
// fall below fp32's normal range); the fp32 route's register operand
// enters the tensor cores lifted by 2^40 (prod_frag: they drop subnormal
// terms).  The keys and rows kernels are four
// warps of 16 rows: the
// M tile comes out of its product in the accumulator layout, where w^T,
// T^T and T are formed and split in registers and taken as the next
// product's A fragments (bf16: as they stand; fp32: the accumulator's
// columns 2t, 2t + 1 read as A's t, t + 4), so they never touch shared
// memory; on the diagonal tile a warp skips the k16 steps wholly masked.
// A block sums dB (keys) or dC (rows) over its head slice in registers
// and writes one fp32 partial a slice (in B's dtype when one slice holds
// the group): kernel.py::bwd_slice picks the slice so the grid keeps at
// least 512 blocks (at G 1 and B 4 one slice of all 64 heads would leave
// 128; scripts/ssd_bwd_slice_sweep.py times every slice).  The ddt row
// and column sums come out of the product's epilogue: each thread sums
// its fragment in double, a fixed-order shuffle over the quad finishes
// the row; each product (C_i . B_j) T_ij or (C_i . B_j) e M is formed in
// double (exact), as in the first design: rounded to fp32 first, the row
// and column sums, whose difference d(cum) cancels over the chunk, left
// Mamba-2-1.3B's fp32 2-layer step with an A_log gradient 8.6e-5 of its
// largest off the float64 route, past the fp32 plain route's 5.9e-5
// (chip_smoke.py phase 13).  x, dy, B, C and C.B^T rows arrive by
// 16-byte cp.async where
// the strides allow.  Shared memory holds the scalars, the block's
// resident rows and one region used by the state terms (hn or h_prev, as
// bf16 planes or fp32) and then by the loop's tiles: at P 64, N 128, 83 KB
// (bf16) or 91 KB (fp32), two blocks an SM.  What bounds these kernels
// is latency at that occupancy (the accumulators of 64 rows times P + N +
// 64 columns fill a quarter of the register file): taking the elementwise
// work out cut the bf16 keys kernel from 1.09 to 0.78 ms, the products
// (w^T dy, T^T C) only to 0.90.  P > 64 takes 128-wide P windows, and P >
// 128 one grid pass of dx's columns a window, with M summed over the
// windows.  The exponents are the forward's: cum in double
// (chunk_cumsum), the state weights' exponent summed from the chunk's end
// (chunk_suffix), exp never evaluated on the masked half, and below the
// diagonal tile exp(cum_i - cum_j) = exp(cum_i - cum_i0) exp(cum_i0 -
// cum_j), both factors <= 1.  Every sum over heads, slices, chunks or the
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
int launch_one(K kernel, dim3 grid, int smem, const Q& p, cudaStream_t stream,
               int threads = kThreads) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
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
  float* dbp;           // (nsl, B, S, G, N): each head slice's share of dB
  float* dcp;           //                    and of dC (nsl > 1, else unused)
  double* vec;          // (kVecs, B, H, S) per-position terms of ddt
  float* da_part;       // (B, H, nc) each chunk's share of dA
  int hs, nsl;          // heads a slice, slices a group
  bool vx, vbc, vdy;    // x / B and C / dy rows in 16-byte vectors
};

constexpr int kVecs = 5;
enum { kRowW = 0, kEi = 1, kGsum = 2, kSv = 3, kSd = 4 };
constexpr int kBwdThreads = 128;        // the keys and rows kernels: four warps of 16 rows
constexpr int kCbKeys = kTile + 4;      // row strides of the fp32 C.B^T tile: conflict-free
constexpr int kCbRows = kTile + 8;      // fragment reads in the keys / rows layout
// the per-head scalars of the keys and rows kernels: cum (double), dts,
// after, and the two exp factors of a tile below the diagonal
constexpr int kScalBytes = 8 * kMaxChunk + 4 * (2 * kMaxChunk + 2 * kTile);

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

template <typename T>
__host__ __device__ constexpr bool is_bf() { return std::is_same<T, bf16>::value; }
// the row stride of a shared tile `w` wide: bf16 w + 8 (ldmatrix reads
// conflict-free), fp32 w + 4 (4 mod 32 words: the m16n8k8 fragment reads)
template <typename T>
__host__ __device__ constexpr int tile_stride(int w) { return is_bf<T>() ? w + 8 : w + 4; }
// the k-step of a product: 16 (bf16, m16n8k16) or 8 (tf32, m16n8k8)
template <typename T>
__host__ __device__ constexpr int k_step() { return is_bf<T>() ? 16 : 8; }
template <typename T>
__device__ __forceinline__ int round_k(int n) { return (n + k_step<T>() - 1) & ~(k_step<T>() - 1); }

// cp.async copies issued so far (and this thread's plain stores) landed,
// and the block's visible to all
__device__ __forceinline__ void land() {
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
}

// rows [r0, r0 + 64) of a (rows, n) operand (row stride ld, the block's
// first column at src) into dst[64][sd], zeros past `rows` and past n up
// to `width` columns.  With `vec` (src, ld and n multiples of 16 bytes) as
// 16-byte cp.async copies, which the caller commits and waits for (land);
// else plain loads and stores.
template <typename T>
__device__ void stage_t(T* dst, int sd, const T* src, long long ld_, int r0, int rows, int n,
                        int width, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int chunks = width / V;
    for (int idx = threadIdx.x; idx < kTile * chunks; idx += blockDim.x) {
      const int r = idx / chunks, e = (idx - r * chunks) * V;
      const bool ok = r0 + r < rows && e < n;
      hopper::cp_async16_zfill(dst + r * sd + e, ok ? src + (long long)(r0 + r) * ld_ + e : src, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTile * width; idx += blockDim.x) {
    const int r = idx / width, e = idx - r * width;
    const float v = (r0 + r < rows && e < n) ? ld(src + (long long)(r0 + r) * ld_ + e) : 0.f;
    st(dst + r * sd + e, v);
  }
}

// rows [p0, p0 + rows) of a (P, N) fp32 state (row stride N) into
// dst[rows][sd], zeros past P and past N up to `width` columns: bf16 as
// its three planes (split3_pair, `plane` apart), fp32 as it is.  With N %
// 4 == 0, fp32 by cp.async (the caller lands it) and bf16 from 16-byte
// loads issued eight a thread before their splits.
template <typename T>
__device__ void stage_state(T* dst, int sd, int plane, const float* src, int p0, int rows, int P,
                            int N, int width) {
  if (N % 4 == 0) {
    const int quads = width / 4, total = rows * quads;
    if constexpr (!is_bf<T>()) {
      for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int r = idx / quads, e = (idx - r * quads) * 4;
        const bool ok = p0 + r < P && e < N;
        hopper::cp_async16_zfill(dst + r * sd + e, ok ? src + (long long)(p0 + r) * N + e : src, ok);
      }
    } else {
      for (int base = threadIdx.x; base < total; base += 8 * blockDim.x) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = base + u * blockDim.x, r = idx / quads, e = (idx - r * quads) * 4;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < total && p0 + r < P && e < N)
            v[u] = *reinterpret_cast<const float4*>(src + (long long)(p0 + r) * N + e);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = base + u * blockDim.x, r = idx / quads, e = (idx - r * quads) * 4;
          if (idx < total) {
            split3_pair(v[u].x, v[u].y, dst + r * sd + e, plane);
            split3_pair(v[u].z, v[u].w, dst + r * sd + e + 2, plane);
          }
        }
      }
    }
    return;
  }
  const int half = width / 2;
  for (int idx = threadIdx.x; idx < rows * half; idx += blockDim.x) {
    const int r = idx / half, e = (idx - r * half) * 2, pp = p0 + r;
    const float* s = src + (long long)pp * N + e;
    float v0 = 0.f, v1 = 0.f;
    if (pp < P) {
      if (e + 1 < N && (N & 1) == 0) {
        const float2 v = *reinterpret_cast<const float2*>(s);
        v0 = v.x;
        v1 = v.y;
      } else {
        if (e < N) v0 = s[0];
        if (e + 1 < N) v1 = s[1];
      }
    }
    if constexpr (is_bf<T>()) {
      split3_pair(v0, v1, dst + r * sd + e, plane);
    } else {
      dst[r * sd + e] = v0;
      dst[r * sd + e + 1] = v1;
    }
  }
}

// C.B^T rows [i0, i0 + 64), columns [j0, j0 + 64) of the chunk's (L, L)
// fp32 tile into dst[64][sd], zeros past L; by cp.async when L % 4 == 0
__device__ void stage_cb(float* dst, int sd, const float* cbg, int L, int i0, int j0) {
  if (L % 4 == 0) {
    for (int idx = threadIdx.x; idx < kTile * kTile / 4; idx += blockDim.x) {
      const int r = idx >> 4, e = (idx & 15) * 4;
      const bool ok = i0 + r < L && j0 + e < L;
      hopper::cp_async16_zfill(dst + r * sd + e, ok ? cbg + (long long)(i0 + r) * L + j0 + e : cbg, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
    const int r = idx >> 6, e = idx & 63;
    dst[r * sd + e] = (i0 + r < L && j0 + e < L) ? cbg[(long long)(i0 + r) * L + j0 + e] : 0.f;
  }
}

// ---- the warps' products -------------------------------------------------------
// Each writes acc, the warp's 16 x 8 NB accumulator (n8 tile ni: acc[4 ni
// + q] at row (lane >> 2) + 8 (q >> 1), column 8 ni + 2 (lane & 3) + (q &
// 1)).  bf16: mma.sync m16n8k16 from ldmatrix; fp32: split TF32 on
// mma.sync m16n8k8 (lo.hi + hi.lo + hi.hi, each k-step's three products
// summed in a fresh accumulator, then added).

// fp32: acc += A B over k < K (a multiple of 8), A(r, k) = a[r ar + k ak]
// for the warp's 16 rows, B(k, n) = b[k bk + n bn]
template <int NB>
__device__ __forceinline__ void f32_product(float* acc, const float* a, int ar, int ak,
                                            const float* b, int bk, int bn, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    hopper::split_tf32(a[g * ar + (k + t) * ak], ah[0], al[0]);
    hopper::split_tf32(a[(g + 8) * ar + (k + t) * ak], ah[1], al[1]);
    hopper::split_tf32(a[g * ar + (k + t + 4) * ak], ah[2], al[2]);
    hopper::split_tf32(a[(g + 8) * ar + (k + t + 4) * ak], ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int o0 = (k + t) * bk + (8 * nb + g) * bn;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      hopper::mma_3xtf32(d, ah, al, b[o0], b[o0 + 4 * bk]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * nb + i] += d[i];
    }
  }
}

// acc += A B^T: A the warp's 16 rows of a ([m][k], row stride sa), B 8 NB
// rows of b ([n][k], row stride sb); bf16 one exact product, fp32 split
// TF32.  M = dy x^T.
template <int NB>
__device__ __forceinline__ void prod_nk(float* acc, const bf16* a, int sa, const bf16* b, int sb,
                                        int K) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < K; k += 16) {
    uint32_t fa[4];
    hopper::ldmatrix_x4(fa, a + (lane & 15) * sa + k + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < NB / 2; ++nj) {
      uint32_t fb[4];
      hopper::ldmatrix_x4(fb, b + (nj * 16 + (lane >> 4) * 8 + (lane & 7)) * sb + k + ((lane >> 3) & 1) * 8);
      hopper::mma_bf16(acc + 8 * nj, fa, fb[0], fb[1]);
      hopper::mma_bf16(acc + 8 * nj + 4, fa, fb[2], fb[3]);
    }
  }
}
template <int NB>
__device__ __forceinline__ void prod_nk(float* acc, const float* a, int sa, const float* b, int sb,
                                        int K) {
  f32_product<NB>(acc, a, sa, 1, b, 1, sb, K);
}

// acc += A B: A exact (the warp's 16 rows of a, [m][k]), B the split
// operand stored [n][k] or, TB, [k][n]: bf16 its three planes (`plane`
// apart; each k16 step issues hi, mid, lo into acc), fp32 the fp32 tile
// (split TF32)
template <int NB, bool TB>
__device__ __forceinline__ void prod_split(float* acc, const bf16* a, int sa, const bf16* b, int sb,
                                           int plane, int K) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < K; k += 16) {
    uint32_t fa[4];
    hopper::ldmatrix_x4(fa, a + (lane & 15) * sa + k + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < NB / 2; ++nj) {
      const bf16* pb = TB ? b + (k + (lane & 7) + ((lane >> 3) & 1) * 8) * sb + nj * 16 + (lane >> 4) * 8
                          : b + (nj * 16 + (lane >> 4) * 8 + (lane & 7)) * sb + k + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        uint32_t fb[4];
        if (TB) hopper::ldmatrix_x4_trans(fb, pb + pl * plane);
        else hopper::ldmatrix_x4(fb, pb + pl * plane);
        hopper::mma_bf16(acc + 8 * nj, fa, fb[0], fb[1]);
        hopper::mma_bf16(acc + 8 * nj + 4, fa, fb[2], fb[3]);
      }
    }
  }
}
template <int NB, bool TB>
__device__ __forceinline__ void prod_split(float* acc, const float* a, int sa, const float* b,
                                           int sb, int, int K) {
  f32_product<NB>(acc, a, sa, 1, b, TB ? sb : 1, TB ? 1 : sb, K);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the three bf16 planes of (v0, v1) (split3_pair's) as packed registers
__device__ __forceinline__ void split3_regs(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v0, v1);
  v0 -= __low2float(a);
  v1 -= __high2float(a);
  const __nv_bfloat162 m = __floats2bfloat162_rn(v0, v1);
  v0 -= __low2float(m);
  v1 -= __high2float(m);
  hi = bits(a);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(v0, v1));
}

// acc += X B over one k16 step: X the warp's 16 x 16 operand in registers
// in the accumulator layout (x[0..3] its first n8 tile, x[4..7] the second:
// the rows' weights, w^T, T^T or T), B rows k .. k + 15 of b ([k][n], row
// stride sb).  bf16: X's three planes are A fragments as they stand;
// fp32: X's columns 2t, 2t + 1 read as A's columns t, t + 4 and B's rows
// taken in the same order, two k8 steps.
template <int NB>
__device__ __forceinline__ void prod_frag(float* acc, const float (&x)[8], const bf16* b, int sb) {
  const int lane = threadIdx.x & 31;
  uint32_t a[3][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split3_regs(x[2 * r], x[2 * r + 1], a[0][r], a[1][r], a[2][r]);
#pragma unroll
  for (int nj = 0; nj < NB / 2; ++nj) {
    uint32_t fb[4];
    hopper::ldmatrix_x4_trans(fb, b + ((lane & 7) + ((lane >> 3) & 1) * 8) * sb + nj * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      hopper::mma_bf16(acc + 8 * nj, a[pl], fb[0], fb[1]);
      hopper::mma_bf16(acc + 8 * nj + 4, a[pl], fb[2], fb[3]);
    }
  }
}
// fp32: X enters scaled by 2^40 and each k-step's sum leaves scaled back
// (exact powers of two: the same bits in fp32's normal range).  Below it
// w and T can be subnormal where the decay is strong, and the tensor
// cores drop subnormal terms, which left rows of Mamba-2-1.3B's fp32
// 2-layer step (a few subnormal steps wide) further from the float64
// backward than the plain version (chip_smoke.py phase 13).
constexpr float kLift = 1099511627776.f, kDrop = 1.f / 1099511627776.f;   // 2^40, 2^-40
template <int NB>
__device__ __forceinline__ void prod_frag(float* acc, const float (&x)[8], const float* b, int sb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t ah[4], al[4];
    hopper::split_tf32(x[4 * s] * kLift, ah[0], al[0]);
    hopper::split_tf32(x[4 * s + 2] * kLift, ah[1], al[1]);
    hopper::split_tf32(x[4 * s + 1] * kLift, ah[2], al[2]);
    hopper::split_tf32(x[4 * s + 3] * kLift, ah[3], al[3]);
    const int o = (8 * s + 2 * t) * sb + g;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      hopper::mma_3xtf32(d, ah, al, b[o + 8 * nb], b[o + sb + 8 * nb]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * nb + i] = fmaf(d[i], kDrop, acc[4 * nb + i]);
    }
  }
}

// the two rows' sums of a quad (the four lanes of a fragment row), added
// in a fixed order (xor 1, then xor 2)
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// The backward state kernel's shared memory: cum, dts and exp(cum), then
// exp(cum) dy (bf16: three planes) and C, 64 rows each.  (Two stages, the
// next one's loads in flight during a step's products, measured slower:
// 0.143 / 0.268 ms against 0.135 / 0.247 bf16 / fp32 at the training
// shape, at two blocks an SM in place of three or four.)
template <typename T>
constexpr int kStateRowsS = is_bf<T>() ? kXS : kTile + 8;        // 8 mod 32 words (fp32)
constexpr int kStateRowsN = kMaxN + 8;
template <typename T>
constexpr int state_smem_bytes() {
  return 8 * kMaxChunk + 8 * kMaxChunk +
         (int)sizeof(T) * kTile * ((is_bf<T>() ? 3 : 1) * kStateRowsS<T> + kStateRowsN);
}

// Backward 1: grid (nc, B*H, P tiles), 256 threads; dynamic shared memory
// state_smem_bytes.  The chunk's reverse contribution to the gradient of
// the state before it, sum_i exp(cum_i) dy_i (x) C_i, into dstate: a (P x
// L)(L x N) product of exp(cum) dy (split) and C (exact), eight warps of 16
// x 64 over a 64-row P tile and every state column; decay[b, h, c] =
// exp(cum_last).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(const BwdParams q) {
  const Params& p = q.f;
  constexpr int kS = kStateRowsS<T>, kSN = kStateRowsN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(cum + kMaxChunk);
  float* ecum = dts + kMaxChunk;
  T* ys = reinterpret_cast<T*>(ecum + kMaxChunk);     // exp(cum) dy  [i][p] (bf16: hi / mid / lo)
  T* cs = ys + (is_bf<T>() ? 3 : 1) * kTile * kS;     // C            [i][n]
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int p0 = blockIdx.z * kTile;
  chunk_cumsum(p, b, h, c, dts, cum);
  for (int j = threadIdx.x; j < p.L; j += kThreads) ecum[j] = expf((float)cum[j]);
  if (blockIdx.z == 0 && threadIdx.x == 0) p.decay[(long long)bh * p.nc + c] = expf((float)cum[p.L - 1]);
  __syncthreads();
  const long long row0 = (long long)c * p.L;
  const T* dyg = dy_at<T>(q, b, row0, h) + p0;
  const long long ldy = (long long)p.H * p.P;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  float acc[32] = {};
  // exp(cum_i) dy_i of the tile's rows: pairs (v0, v1) at column e
  auto put = [&](int ii, int e, float v0, float v1) {
    if constexpr (is_bf<T>()) {
      split3_pair(v0, v1, &ys[ii * kS + e], kTile * kS);
    } else {
      ys[ii * kS + e] = v0;
      ys[ii * kS + e + 1] = v1;
    }
  };
  for (int i0 = 0; i0 < p.L; i0 += kTile) {
    stage_t<T>(cs, kSN, c_at<T>(p, b, row0, g), p.c_ss, i0, p.L, p.N, kMaxN, q.vbc);
    if (q.vdy) {
      // 16-byte rows, every thread's loads issued before their splits
      constexpr int V = 16 / sizeof(T), kPer = kTile * kTile / V / kThreads;
      uint4 raw[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = threadIdx.x + u * kThreads, ii = idx / (kTile / V);
        const int e = (idx - ii * (kTile / V)) * V, i = i0 + ii;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < p.L && p0 + e < p.P)
          raw[u] = *reinterpret_cast<const uint4*>(dyg + (long long)i * ldy + e);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = threadIdx.x + u * kThreads, ii = idx / (kTile / V);
        const int e = (idx - ii * (kTile / V)) * V, i = i0 + ii;
        const float w = i < p.L ? ecum[i] : 0.f;
        const T* v = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int k = 0; k < V; k += 2) put(ii, e + k, ld(v + k) * w, ld(v + k + 1) * w);
      }
    } else {
      for (int idx = threadIdx.x; idx < kTile * kTile / 2; idx += kThreads) {
        const int ii = idx >> 5, e = (idx & 31) * 2, i = i0 + ii;
        const T* src = dyg + (long long)i * ldy + e;
        const bool row = i < p.L;
        const float w = row ? ecum[i] : 0.f;
        put(ii, e, row && p0 + e < p.P ? ld(src) * w : 0.f,
            row && p0 + e + 1 < p.P ? ld(src + 1) * w : 0.f);
      }
    }
    land();
    const int kn = round_k<T>(min(kTile, p.L - i0));
    if constexpr (is_bf<T>()) {
      for (int k = 0; k < kn; k += 16) {
        mma_step<3, true, true>(acc, ys + wm * 16, kS, kTile * kS, cs + wn * 64, kSN, 0, k);
        mma_step<3, true, true>(acc + 16, ys + wm * 16, kS, kTile * kS, cs + wn * 64 + 32, kSN, 0, k);
      }
    } else {
      f32_product<8>(acc, ys + wm * 16, 1, kS, cs + wn * 64, kSN, 1, kn);
    }
    __syncthreads();                    // ys, cs are refilled next round
  }
  float* out = q.dstate + ((long long)bh * p.nc + c) * p.P * p.N;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int pp = p0 + wm * 16 + frag_row(qq), nn = wn * 64 + frag_col(ni, qq);
      if (pp < p.P && nn < p.N) out[(long long)pp * p.N + nn] = acc[ni * 4 + qq];
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

// The shared memory of the keys and rows kernels at a P window of PW and
// state columns NW: the scalars, the block's resident rows (x of the keys
// or dy of the rows), then one region: first the state terms' (B or C
// rows and a state window), then the loop's tiles (dy or x rows, C or B
// rows, C.B^T), filled by cp.async.  (Two stages, the next filled while
// one is in use, measured slower: 1.087 / 0.839 ms against 0.992 / 0.758
// for the bf16 keys / rows kernels at the training shape.)
template <typename T, int PW, int NW>
struct BwdTiles {
  static constexpr int kSP = tile_stride<T>(PW), kSN = tile_stride<T>(NW);
  static constexpr int kRowsP = kTile * kSP * (int)sizeof(T);       // x or dy rows
  static constexpr int kRowsN = kTile * kSN * (int)sizeof(T);       // B or C rows
  static constexpr int kState = (is_bf<T>() ? 3 : 1) * PW * kSN * (int)sizeof(T);  // a state window
  static constexpr int kCb = kTile * kCbRows * (int)sizeof(float);
  static constexpr int kStage = kRowsP + kRowsN + kCb;
  static constexpr int kRegion = kRowsN + kState > kStage ? kRowsN + kState : kStage;
  static constexpr int kBytes = kScalBytes + kRowsP + kRegion;
};

// blockIdx.x = ((b G + g) nsl + slice) nc + c
__device__ __forceinline__ void slice_of(const BwdParams& q, int& b, int& g, int& sl, int& c) {
  int r = blockIdx.x;
  c = r % q.f.nc;
  r /= q.f.nc;
  sl = r % q.nsl;
  r /= q.nsl;
  g = r % q.f.G;
  b = r / q.f.G;
}

// The pointers of the keys and rows kernels' shared memory
template <typename T, int PW, int NW>
struct BwdSmem {
  using Tl = BwdTiles<T, PW, NW>;
  double* cum;
  float *dts, *aft, *ea, *eb;
  T* res;                               // the resident rows
  unsigned char* region;
  __device__ explicit BwdSmem(unsigned char* raw) {
    cum = reinterpret_cast<double*>(raw);
    dts = reinterpret_cast<float*>(cum + kMaxChunk);
    aft = dts + kMaxChunk;
    ea = aft + kMaxChunk;
    eb = ea + kTile;
    res = reinterpret_cast<T*>(raw + kScalBytes);
    region = raw + kScalBytes + Tl::kRowsP;
  }
  __device__ T* rows_n() const { return reinterpret_cast<T*>(region); }
  __device__ T* state() const { return reinterpret_cast<T*>(region + Tl::kRowsN); }
  __device__ T* tile_p() const { return reinterpret_cast<T*>(region); }
  __device__ T* tile_n() const { return reinterpret_cast<T*>(region + Tl::kRowsP); }
  __device__ float* tile_cb() const {
    return reinterpret_cast<float*>(region + Tl::kRowsP + Tl::kRowsN);
  }
};

// the exp factors of a tile below the diagonal (rows from i0, keys from
// j0 < i0) into ea / eb: exp(cum_i - cum_i0), exp(cum_i0 - cum_j)
__device__ __forceinline__ void tile_exps(const double* cum, float* ea, float* eb, int L, int i0,
                                          int j0) {
  const int r = threadIdx.x & (kTile - 1);
  if (threadIdx.x < kTile) ea[r] = i0 + r < L ? expf((float)(cum[i0 + r] - cum[i0])) : 0.f;
  else if (threadIdx.x < 2 * kTile) eb[r] = expf((float)(cum[i0] - cum[j0 + r]));
}

// Backward 3, keys: grid (B G nsl nc, key tiles, P windows), 128 threads;
// dynamic shared memory BwdTiles::kBytes.  For 64 keys j of a chunk and a
// slice of a group's heads, head by head in order, each warp 16 keys:
//  - the state terms from hn, the gradient of the state after the chunk:
//    dx_j = wgt_j (hn B_j) over the P window, and (pass 0) u_j = hn^T x_j,
//    Sd_j = exp(after_j) B_j . u_j, dB_j += wgt_j u_j;
//  - over the row tiles i >= j: M^T = x dy^T, then in registers e_ij =
//    exp(cum_i - cum_j) (below the diagonal exp(cum_i - cum_i0)
//    exp(cum_i0 - cum_j)), w = (C_i . B_j) e dt_j, T = e M dt_j and the
//    column sums G_j = sum_i (C_i . B_j) e M; dx_j += w^T dy_i and (pass 0)
//    dB_j += T^T C_i;
//  - dx of the head and (pass 0) G_j, Sd_j, dt_j Sd_j into vec.
// Pass z takes dx's columns [z PW, (z + 1) PW); pass 0 also dB, which
// sums over the slice's heads in registers and is written once: B's dtype
// when the slice is the whole group, else fp32 into dbp.
template <typename T, int PW, int NW>
__global__ void __launch_bounds__(kBwdThreads) ssd_bwd_keys_kernel(const BwdParams q) {
  using Tl = BwdTiles<T, PW, NW>;
  constexpr int kSP = Tl::kSP, kSN = Tl::kSN, kNP = PW / 8, kNN = NW / 8;
  constexpr int plane = PW * kSN;
  const Params& p = q.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdSmem<T, PW, NW> sm(smem_raw);
  T* xs = sm.res;                       // x    [j][p]
  T* bt = sm.rows_n();                  // B    [j][n]
  T* hs = sm.state();                   // hn   [p][n] (planes)

  int b, g, sl, c;
  slice_of(q, b, g, sl, c);
  const int n_t = (p.L + kTile - 1) / kTile;
  const int jt = blockIdx.y, j0 = jt * kTile;
  const int pass = blockIdx.z, nwin = (p.P + PW - 1) / PW;
  const bool first = pass == 0;         // dB and the column sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int jw = warp * 16;             // the warp's first key of the tile
  const long long row0 = (long long)c * p.L;
  const int kN = round_k<T>(p.N);
  auto win_k = [&](int w) { return round_k<T>(min(PW, p.P - w * PW)); };
  const float* cbg = cb_tile(p, b, g, c);
  const T* bg = b_at<T>(p, b, row0, g);
  const T* cg = c_at<T>(p, b, row0, g);
  const long long ldy = (long long)p.H * p.P;

  float dB[kNN * 4] = {};
  for (int hh = 0; hh < q.hs; ++hh) {
    const int h = g * (p.H / p.G) + sl * q.hs + hh, bh = b * p.H + h;
    const T* xg = x_at<T>(p, b, row0, h);
    const T* dyg = dy_at<T>(q, b, row0, h);
    const float* hn = q.dstate + ((long long)bh * p.nc + c) * p.P * p.N;
    __syncthreads();                    // the previous head's readers are done
    chunk_cumsum(p, b, h, c, sm.dts, sm.cum);
    chunk_suffix(p, h, sm.dts, sm.aft);
    float dtj[2];
    double ea_j[2], wj[2];              // exp(after_j), wgt_j, in double
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j0 + jw + gq + 8 * rr;
      dtj[rr] = j < p.L ? sm.dts[j] : 0.f;
      ea_j[rr] = j < p.L ? exp((double)sm.aft[j]) : 0.0;
      wj[rr] = (double)dtj[rr] * ea_j[rr];
    }

    // the state terms
    stage_t<T>(bt, kSN, bg, p.b_ss, j0, p.L, p.N, NW, q.vbc);
    if (nwin == 1) stage_t<T>(xs, kSP, xg, p.x_ss, j0, p.L, p.P, PW, q.vx);
    stage_state<T>(hs, kSN, plane, hn, pass * PW, PW, p.P, p.N, NW);
    land();
    float dx[kNP * 4] = {};
    prod_split<kNP, false>(dx, bt + jw * kSN, kSN, hs, kSN, plane, kN);
#pragma unroll
    for (int i = 0; i < kNP * 4; ++i) dx[i] = (float)((double)dx[i] * wj[(i >> 1) & 1]);
    if (first) {
      double sd[2] = {0.0, 0.0};
#pragma unroll
      for (int nh = 0; nh < NW / 64; ++nh) {
        float u[32] = {};
        for (int w = 0; w < nwin; ++w) {
          if (nwin > 1) {
            __syncthreads();
            stage_t<T>(xs, kSP, xg + w * PW, p.x_ss, j0, p.L, p.P - w * PW, PW, q.vx);
            stage_state<T>(hs, kSN, plane, hn, w * PW, PW, p.P, p.N, NW);
            land();
          }
          prod_split<8, true>(u, xs + jw * kSP, kSP, hs + nh * 64, kSN, plane, win_k(w));
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int rr = qq >> 1, n = nh * 64 + 8 * ni + 2 * tq + (qq & 1);
            const float v = u[ni * 4 + qq];
            if (n < p.N) sd[rr] += (double)v * (double)ld(bt + (jw + gq + 8 * rr) * kSN + n);
            dB[(nh * 8 + ni) * 4 + qq] += (float)(wj[rr] * (double)v);
          }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const double s = quad_sum(sd[rr]);
        const int j = j0 + jw + gq + 8 * rr;
        if (tq == 0 && j < p.L) {
          const double s_d = ea_j[rr] * s;
          *vec_at(q, kSd, bh, row0 + j) = s_d;
          *vec_at(q, kSv, bh, row0 + j) = (double)sm.dts[j] * s_d;
        }
      }
    }
    __syncthreads();                    // the state terms' tiles are read

    // the row tiles on and below the diagonal
    T* dyt = sm.tile_p();               // dy   [i][p]
    const T* ct = sm.tile_n();          // C    [i][n]
    const float* cbt = sm.tile_cb();    // C.B^T [i][j]
    double gs[2] = {0.0, 0.0};
    for (int it = jt; it < n_t; ++it) {
      const int i0 = it * kTile;
      const bool diag = it == jt, full = !diag && i0 + kTile <= p.L;
      if (nwin == 1) stage_t<T>(dyt, kSP, dyg, ldy, i0, p.L, p.P, PW, q.vdy);
      if (first) stage_t<T>(sm.tile_n(), kSN, cg, p.c_ss, i0, p.L, p.N, NW, q.vbc);
      stage_cb(sm.tile_cb(), kCbKeys, cbg, p.L, i0, j0);
      if (!diag) tile_exps(sm.cum, sm.ea, sm.eb, p.L, i0, j0);
      land();
      float m[32] = {};
      for (int k2 = 0; k2 < nwin; ++k2) {
        // more than one window: the pass's own last, so its dy stays staged
        const int w = (pass + 1 + k2) % nwin;
        if (nwin > 1) {
          __syncthreads();
          stage_t<T>(xs, kSP, xg + w * PW, p.x_ss, j0, p.L, p.P - w * PW, PW, q.vx);
          stage_t<T>(dyt, kSP, dyg + w * PW, ldy, i0, p.L, p.P - w * PW, PW, q.vdy);
          land();
        }
        prod_nk<8>(m, xs + jw * kSP, kSP, dyt, kSP, win_k(w));
      }
      // the warp's two keys' factors; on the diagonal tile cum_j
      float ebj[2];
      double cj[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        ebj[rr] = diag ? 0.f : sm.eb[jw + gq + 8 * rr];
        cj[rr] = sm.cum[min(j0 + jw + gq + 8 * rr, p.L - 1)];
      }
      // on the diagonal tile the warp's keys start at jw: k16 steps of rows
      // wholly before them are zero (unrolled: m stays in registers)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (diag && kk < warp) continue;
        float tv[8], wv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ni = 2 * kk + (e >> 2), qq = e & 3, rr = qq >> 1;
          const int jj = jw + gq + 8 * rr, ii = 8 * ni + 2 * tq + (qq & 1), i = i0 + ii;
          float t = 0.f, wt = 0.f;
          // masked entries never evaluate exp
          if (full || (i < p.L && (!diag || ii >= jj))) {
            const float ev = diag ? expf((float)(sm.cum[i] - cj[rr])) : sm.ea[ii] * ebj[rr];
            const float cbv = cbt[ii * kCbKeys + jj];
            const float em = ev * m[ni * 4 + qq];
            t = em * dtj[rr];
            wt = cbv * ev * dtj[rr];
            gs[rr] = fma((double)cbv, (double)em, gs[rr]);
          }
          tv[e] = t;
          wv[e] = wt;
        }
        prod_frag<kNP>(dx, wv, dyt + 16 * kk * kSP, kSP);
        if (first) prod_frag<kNN>(dB, tv, ct + 16 * kk * kSN, kSN);
      }
      __syncthreads();                  // the tiles are refilled next
    }

    T* dxg = static_cast<T*>(q.dx) + (((long long)b * p.S + row0) * p.H + h) * p.P + pass * PW;
#pragma unroll
    for (int ni = 0; ni < kNP; ++ni)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int j = j0 + jw + gq + 8 * (qq >> 1), col = 8 * ni + 2 * tq + (qq & 1);
        if (j < p.L && pass * PW + col < p.P) st(dxg + (long long)j * ldy + col, dx[ni * 4 + qq]);
      }
    if (first) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const double s = quad_sum(gs[rr]);
        const int j = j0 + jw + gq + 8 * rr;
        if (tq == 0 && j < p.L) *vec_at(q, kGsum, bh, row0 + j) = s;
      }
    }
  }
  if (!first) return;
  const long long GN = (long long)p.G * p.N;
#pragma unroll
  for (int ni = 0; ni < kNN; ++ni)
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int j = j0 + jw + gq + 8 * (qq >> 1), n = 8 * ni + 2 * tq + (qq & 1);
      if (j >= p.L || n >= p.N) continue;
      const long long o = ((long long)b * p.S + row0 + j) * GN + (long long)g * p.N + n;
      if (q.nsl == 1) st(static_cast<T*>(q.dbm) + o, dB[ni * 4 + qq]);
      else q.dbp[(long long)sl * p.B * p.S * GN + o] = dB[ni * 4 + qq];
    }
}

// Backward 4, rows: grid (B G nsl nc, row tiles), 128 threads; dynamic
// shared memory BwdTiles::kBytes.  Row tiles are issued longest first.
// For 64 rows i of a chunk and a slice of a group's heads, head by head in
// order, each warp 16 rows:
//  - the inter term from h_prev (the forward's state before the chunk,
//    from the second chunk on): v_i = h_prev^T dy_i, dC_i += exp(cum_i)
//    v_i, E_i = exp(cum_i) C_i . v_i;
//  - over the key tiles j <= i: M = dy x^T, T = e M dt_j in registers,
//    dC_i += T B_j and the row sums sum_j (C_i . B_j) T_ij;
//  - those sums and E_i into vec.
// dC sums over the slice's heads in registers and is written once, as
// the keys kernel's dB.
template <typename T, int PW, int NW>
__global__ void __launch_bounds__(kBwdThreads) ssd_bwd_rows_kernel(const BwdParams q) {
  using Tl = BwdTiles<T, PW, NW>;
  constexpr int kSP = Tl::kSP, kSN = Tl::kSN, kNN = NW / 8;
  constexpr int plane = PW * kSN;
  const Params& p = q.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdSmem<T, PW, NW> sm(smem_raw);
  T* dys = sm.res;                      // dy   [i][p]
  T* cs = sm.rows_n();                  // C    [i][n]
  T* hs = sm.state();                   // h_prev [p][n] (planes)

  int b, g, sl, c;
  slice_of(q, b, g, sl, c);
  const int n_t = (p.L + kTile - 1) / kTile;
  const int it = n_t - 1 - blockIdx.y, i0 = it * kTile;
  const int nwin = (p.P + PW - 1) / PW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int iw = warp * 16;             // the warp's first row of the tile
  const long long row0 = (long long)c * p.L;
  auto win_k = [&](int w) { return round_k<T>(min(PW, p.P - w * PW)); };
  const float* cbg = cb_tile(p, b, g, c);
  const T* bg = b_at<T>(p, b, row0, g);
  const T* cg = c_at<T>(p, b, row0, g);
  const long long ldy = (long long)p.H * p.P;

  float dC[kNN * 4] = {};
  for (int hh = 0; hh < q.hs; ++hh) {
    const int h = g * (p.H / p.G) + sl * q.hs + hh, bh = b * p.H + h;
    const T* xg = x_at<T>(p, b, row0, h);
    const T* dyg = dy_at<T>(q, b, row0, h);
    __syncthreads();                    // the previous head's readers are done
    chunk_cumsum(p, b, h, c, sm.dts, sm.cum);
    double es[2] = {0.0, 0.0}, rs[2] = {0.0, 0.0};
    if (nwin == 1) stage_t<T>(dys, kSP, dyg, ldy, i0, p.L, p.P, PW, q.vdy);

    // the inter term, from the state before the chunk (zero in chunk 0)
    if (c > 0) {
      const float* hp = p.states + ((long long)bh * p.nc + c) * p.P * p.N;
      double ei[2];                     // exp(cum_i), in double
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = i0 + iw + gq + 8 * rr;
        ei[rr] = i < p.L ? exp(sm.cum[i]) : 0.0;
      }
      stage_t<T>(cs, kSN, cg, p.c_ss, i0, p.L, p.N, NW, q.vbc);
      if (nwin == 1) stage_state<T>(hs, kSN, plane, hp, 0, PW, p.P, p.N, NW);
      land();
#pragma unroll
      for (int nh = 0; nh < NW / 64; ++nh) {
        float v[32] = {};
        for (int w = 0; w < nwin; ++w) {
          if (nwin > 1) {
            __syncthreads();
            stage_t<T>(dys, kSP, dyg + w * PW, ldy, i0, p.L, p.P - w * PW, PW, q.vdy);
            stage_state<T>(hs, kSN, plane, hp, w * PW, PW, p.P, p.N, NW);
            land();
          }
          prod_split<8, true>(v, dys + iw * kSP, kSP, hs + nh * 64, kSN, plane, win_k(w));
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int rr = qq >> 1, n = nh * 64 + 8 * ni + 2 * tq + (qq & 1);
            const double t = (double)v[ni * 4 + qq] * ei[rr];
            dC[(nh * 8 + ni) * 4 + qq] += (float)t;
            if (n < p.N) es[rr] += t * (double)ld(cs + (iw + gq + 8 * rr) * kSN + n);
          }
      }
    }
    __syncthreads();                    // the inter term's tiles are read

    // the key tiles on and below the diagonal
    T* xt = sm.tile_p();                // x    [j][p]
    const T* bt = sm.tile_n();          // B    [j][n]
    const float* cbt = sm.tile_cb();    // C.B^T [i][j]
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      const bool diag = jt == it, full = !diag && i0 + kTile <= p.L;
      if (nwin == 1) stage_t<T>(xt, kSP, xg, p.x_ss, j0, p.L, p.P, PW, q.vx);
      stage_t<T>(sm.tile_n(), kSN, bg, p.b_ss, j0, p.L, p.N, NW, q.vbc);
      stage_cb(sm.tile_cb(), kCbRows, cbg, p.L, i0, j0);
      if (!diag) tile_exps(sm.cum, sm.ea, sm.eb, p.L, i0, j0);
      land();
      float m[32] = {};
      for (int w = 0; w < nwin; ++w) {
        if (nwin > 1) {
          __syncthreads();
          stage_t<T>(dys, kSP, dyg + w * PW, ldy, i0, p.L, p.P - w * PW, PW, q.vdy);
          stage_t<T>(xt, kSP, xg + w * PW, p.x_ss, j0, p.L, p.P - w * PW, PW, q.vx);
          land();
        }
        prod_nk<8>(m, dys + iw * kSP, kSP, xt, kSP, win_k(w));
      }
      // the warp's two rows' factors; on the diagonal tile cum_i
      float eai[2];
      double ci[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        eai[rr] = diag ? 0.f : sm.ea[iw + gq + 8 * rr];
        ci[rr] = sm.cum[min(i0 + iw + gq + 8 * rr, p.L - 1)];
      }
      // on the diagonal tile the warp's rows reach key iw + 15 at most
      // (unrolled: m stays in registers)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (diag && kk > warp) continue;
        float tv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ni = 2 * kk + (e >> 2), qq = e & 3, rr = qq >> 1;
          const int ii = iw + gq + 8 * rr, jj = 8 * ni + 2 * tq + (qq & 1), i = i0 + ii, j = j0 + jj;
          float t = 0.f;
          if (full || (i < p.L && (!diag || jj <= ii))) {
            const float ev = diag ? expf((float)(ci[rr] - sm.cum[j])) : eai[rr] * sm.eb[jj];
            t = ev * m[ni * 4 + qq] * sm.dts[j];
            rs[rr] = fma((double)cbt[ii * kCbRows + jj], (double)t, rs[rr]);
          }
          tv[e] = t;
        }
        prod_frag<kNN>(dC, tv, bt + 16 * kk * kSN, kSN);
      }
      __syncthreads();                  // the tiles are refilled next
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const double r_s = quad_sum(rs[rr]), e_s = quad_sum(es[rr]);
      const int i = i0 + iw + gq + 8 * rr;
      if (tq == 0 && i < p.L) {
        *vec_at(q, kRowW, bh, row0 + i) = r_s;
        *vec_at(q, kEi, bh, row0 + i) = e_s;
      }
    }
  }
  const long long GN = (long long)p.G * p.N;
#pragma unroll
  for (int ni = 0; ni < kNN; ++ni)
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int i = i0 + iw + gq + 8 * (qq >> 1), n = 8 * ni + 2 * tq + (qq & 1);
      if (i >= p.L || n >= p.N) continue;
      const long long o = ((long long)b * p.S + row0 + i) * GN + (long long)g * p.N + n;
      if (q.nsl == 1) st(static_cast<T*>(q.dcm) + o, dC[ni * 4 + qq]);
      else q.dcp[(long long)sl * p.B * p.S * GN + o] = dC[ni * 4 + qq];
    }
}

// the sum of v over the block's kThreads threads, every thread's the same
// bits: a shuffle tree in each warp, then the warps' sums in order
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();                      // red's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// sum_{m >= k} v_m for thread k of the block: a shuffle scan in each warp,
// then the later warps' totals added in order
__device__ double block_rev_scan(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += t;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double later = 0.0;
  for (int w = kThreads / 32 - 1; w > warp; --w) later += red[w];
  return v + later;
}

// Backward 5: grid (nc, B*H).  The exponents' gradient d(cum) from the
// per-position terms, one thread a position: d(la) its reverse cumsum
// within the chunk (in double, block_rev_scan), ddt and the chunk's share
// of dA.
__global__ void __launch_bounds__(kThreads) ssd_bwd_dt_kernel(const BwdParams q) {
  const Params& p = q.f;
  __shared__ double cum[kMaxChunk];
  __shared__ float dts[kMaxChunk];
  __shared__ float red[kThreads];
  __shared__ double dred[kThreads / 32];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x;
  chunk_cumsum(p, b, h, c, dts, cum);
  const long long row0 = (long long)c * p.L;
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
  const int k = tid;                    // the position
  const bool in = k < p.L;
  double v[kVecs] = {};
  if (in)
#pragma unroll
    for (int u = 0; u < kVecs; ++u) v[u] = *vec_at(q, u, bh, row0 + k);
  const double s_tot = block_sum(v[kSv], dred);
  double dcum = in ? v[kRowW] - (double)dts[k] * v[kGsum] + v[kEi] - v[kSv] : 0.0;
  if (k == p.L - 1) dcum += s_tot + (double)expf((float)cum[p.L - 1]) * (double)red[0];
  const double run = block_rev_scan(dcum, dred);
  if (in)
    q.ddt[((long long)b * p.S + row0 + k) * p.H + h] =
        (float)(v[kGsum] + v[kSd] + run * (double)p.A[h]);
  const double da = block_sum(in ? run * (double)dts[k] : 0.0, dred);
  if (tid == 0) q.da_part[(long long)bh * p.nc + c] = (float)da;
}

// Backward 6: one thread an element of (B, S, G, N): dB and dC, the head
// slices' shares added in order (nsl > 1), in B's dtype; the last block:
// dA[h], the chunks' shares summed over the batch and the chunks in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_sums_kernel(const BwdParams q) {
  const Params& p = q.f;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < p.H; h += kThreads) {
      double s = 0.0;
      for (int b = 0; b < p.B; ++b)
        for (int c = 0; c < p.nc; ++c) s += q.da_part[((long long)b * p.H + h) * p.nc + c];
      q.dA[h] = (float)s;
    }
    return;
  }
  const long long total = (long long)p.B * p.S * p.G * p.N;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < q.nsl; ++k) {
    sb += q.dbp[k * total + idx];
    sc += q.dcp[k * total + idx];
  }
  st(static_cast<T*>(q.dbm) + idx, sb);
  st(static_cast<T*>(q.dcm) + idx, sc);
}

// the keys and rows kernels at a P window of PW and state columns NW
template <typename T, int PW, int NW>
int launch_tiles(const BwdParams& q, cudaStream_t stream) {
  using Tl = BwdTiles<T, PW, NW>;
  const Params& p = q.f;
  const int n_t = (p.L + kTile - 1) / kTile;
  const unsigned blocks = (unsigned)(p.nc * q.nsl * p.G * p.B);
  int e;
  if ((e = launch_one(ssd_bwd_keys_kernel<T, PW, NW>, dim3(blocks, n_t, (p.P + PW - 1) / PW),
                      Tl::kBytes, q, stream, kBwdThreads)))
    return e;
  return launch_one(ssd_bwd_rows_kernel<T, PW, NW>, dim3(blocks, n_t), Tl::kBytes, q, stream,
                    kBwdThreads);
}

template <typename T>
int launch_bwd(const BwdParams& q, cudaStream_t stream) {
  const Params& p = q.f;
  const bool mma = is_bf<T>();
  const int ptiles = (p.P + kTile - 1) / kTile;
  const int itiles = (p.L + kTile - 1) / kTile;
  const int pairs = itiles * (itiles + 1) / 2;
  const long long PN = (long long)p.P * p.N;
  const int sv = PN % 4 == 0 ? 4 : 1;
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
  if ((e = launch_one(ssd_bwd_state_kernel<T>, dim3(p.nc, p.B * p.H, ptiles), state_smem_bytes<T>(),
                      q, stream)))
    return e;
  const dim3 g_scan((unsigned)((PN / sv + kThreads - 1) / kThreads), p.B * p.H);
  if ((e = sv == 4 ? launch_one(ssd_bwd_scan_kernel<4>, g_scan, 0, q, stream)
                   : launch_one(ssd_bwd_scan_kernel<1>, g_scan, 0, q, stream)))
    return e;
  if (p.P > 64) e = launch_tiles<T, 128, 128>(q, stream);
  else if (p.N > 64) e = launch_tiles<T, 64, 128>(q, stream);
  else e = launch_tiles<T, 64, 64>(q, stream);
  if (e) return e;
  if ((e = launch_one(ssd_bwd_dt_kernel, dim3(p.nc, p.B * p.H), 0, q, stream))) return e;
  const long long total = q.nsl > 1 ? (long long)p.B * p.S * p.G * p.N : 0;
  return launch_one(ssd_bwd_sums_kernel<T>, dim3((unsigned)((total + kThreads - 1) / kThreads) + 1),
                    0, q, stream);
}

// rows of n elements at ptr with these strides (elements) in 16-byte
// vectors of `v` elements: the base 16-byte aligned, n and every stride
// multiples of v
bool aligned_rows(const void* ptr, int n, long long s0, long long s1, long long s2, int v) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && n % v == 0 && s0 % v == 0 &&
         s1 % v == 0 && s2 % v == 0;
}

// bf16 rows in 16-byte vectors (eight elements)
bool aligned8(const void* ptr, int n, long long s0, long long s1, long long s2) {
  return aligned_rows(ptr, n, s0, s1, s2, 8);
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
// (B, H, P, N) fp32 or null; hs the heads a slice (dividing H / G).
// Writes dx (B, S, H, P) in x's dtype, ddt (B, S, H) and dA (H,) fp32,
// dbm and dcm (B, S, G, N) in B's dtype, all contiguous; dstate (B, H, S/L,
// P, N), decay (B, H, S/L), cb (B, G, S/L, L, L) and da_part (B, H, S/L)
// are fp32 scratch, dbp and dcp (H / G / hs, B, S, G, N) fp32 scratch when
// H / G / hs > 1 (else unused), vec (5, B, H, S) float64 scratch.
int rt_ssd_backward(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                    const void* states, const void* dy, const void* dh, void* dstate, void* decay,
                    void* cb, void* dx, void* ddt, void* dA, void* dbm, void* dcm, void* dbp,
                    void* dcp, void* vec, void* da_part, int B, int S, int H, int P, int G, int N,
                    int L, int is_bf16, int hs, long long x_sb, long long x_ss, long long x_sh,
                    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
                    long long b_ss, long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                    void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || N < 1 || N > kMaxN || L < 1 ||
      L > kMaxChunk || S % L != 0 || H % G != 0 || (long long)B * H > 65535 || hs < 1 ||
      (H / G) % hs != 0 || ((H / G / hs > 1) && (dbp == nullptr || dcp == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params f{x, static_cast<const float*>(dt), static_cast<const float*>(A), bm, cm, nullptr,
                 nullptr, const_cast<float*>(static_cast<const float*>(states)),
                 static_cast<float*>(decay), static_cast<float*>(cb), B, S, H, P, G, N, L, S / L,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
                 aligned8(x, P, x_sb, x_ss, x_sh), aligned8(bm, N, b_sb, b_ss, b_sg) &&
                                                       aligned8(cm, N, c_sb, c_ss, c_sg)};
  const int v = is_bf16 ? 8 : 4;        // elements a 16-byte vector
  const long long HP = (long long)H * P;
  const BwdParams q{f, dy, static_cast<const float*>(dh), static_cast<float*>(dstate), dx,
                    static_cast<float*>(ddt), static_cast<float*>(dA), dbm, dcm,
                    static_cast<float*>(dbp), static_cast<float*>(dcp), static_cast<double*>(vec),
                    static_cast<float*>(da_part), hs, H / G / hs,
                    aligned_rows(x, P, x_sb, x_ss, x_sh, v),
                    aligned_rows(bm, N, b_sb, b_ss, b_sg, v) && aligned_rows(cm, N, c_sb, c_ss, c_sg, v),
                    aligned_rows(dy, P, S * HP, HP, P, v)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<bf16>(q, st) : launch_bwd<float>(q, st);
}

}  // extern "C"

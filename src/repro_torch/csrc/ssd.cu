// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// The counterpart of the reference's Pallas kernel ssd_pallas
// (src/repro/kernels/ssd/kernel.py:69): the state-space-dual form of the
// Mamba-2 recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,
// y_t = C_t . h_t, from h = 0, returning y and the final state.
//
// What it computes, per (batch b, head h) and chunk of L positions, all
// arithmetic in fp32: la = dt * A and cum = its inclusive cumsum within
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
// H 64, P 64, G 1, N 128, chunk 256 against 74 MB moved, so it is bound
// by operations.  The contract is fp32 arithmetic (TF32 tensor cores
// would break the 1e-4 state tolerance), so the bound that applies is
// the 67 TFLOP/s of fp32 FFMA, not the 989 of bf16 products.  This
// kernel computes C.B^T per head (64 x the need at G = 1).
//
// What the design does about it.  The Pallas grid (B, H, S/L) runs in
// order with the (P, N) state in VMEM; at Mamba-2-1.3B's B*H = 64..128
// that is under one wave of 132 SMs.  Here three kernels each parallel
// over chunks:
//   1. ssd_state_kernel: per (b, h, chunk, 64x64 tile of the state), the
//      chunk's own state contribution sum_j x_j (x) B_j w_j, with
//      w_j = dt_j exp(cum_last - cum_j) and the exponent summed from the
//      chunk's end (sum_{k>j} dt_k A): taken as a difference of two
//      prefix sums, which reach thousands at A = -16, it keeps only
//      fp32's resolution at that size, and the state drifted by ~1e-4
//      of its largest value on Mamba-2-1.3B's served inputs;
//   2. ssd_scan_kernel: per (b, h, state element), the short sequential
//      pass over chunks, h <- decay_c h + s_c, which overwrites each
//      chunk's contribution with the state before it and writes h_final;
//   3. ssd_out_kernel: per (b, h, chunk, 64-row tile, 64-wide P tile),
//      the inter term from the state before the chunk, then the intra
//      term over the 64-column key tiles up to the diagonal (the causal
//      half only): S = C B^T tile, w = S exp(cum_i - cum_j) dt_j masked
//      to j <= i without evaluating exp on the masked half (so no
//      overflow and no 0 * inf), y += w x.  cum is summed in double
//      (chunk_cumsum): near the diagonal cum_i - cum_j is small while
//      cum reaches thousands at A = -16, and as a difference of two fp32
//      prefix sums it moved the fp32 y by 1.6e-4 of its largest value on
//      Mamba-2-1.3B's served inputs on an H100 (1e-4 is the reference's
//      bound).
// Tiles of 64 rows keep a 256 x 128 B or C chunk (128 KB) and the
// 256 x 256 decay matrix (256 KB) out of shared memory: kernel 3 holds
// one C row tile, one B (or state) tile, one x tile and one w tile, 100
// KB at N 128.  Each thread owns a 4 x 4 register tile strided by 16 in
// both directions, and shared rows are padded to an odd length, so the
// operand reads are conflict-free broadcasts or consecutive words.  Plain
// FFMA on SIMT cores.  Sharing C B^T across the H / G heads of a group,
// wgmma and TMA are later work.  The per-chunk cumsum is recomputed by
// each block (L <= 256 adds, in double) instead of stored.
//
// Interface: one plain C entry point (loaded with ctypes); it launches on
// the caller's stream, allocates nothing (the caller passes the
// (B, H, nc, P, N) and (B, H, nc) fp32 scratch) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows / columns of an output tile
constexpr int kPadTile = kTile + 1;     // odd row stride of 64-wide tiles
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
  int B, S, H, P, G, N, L, nc;
  long long x_sb, x_ss, x_sh;           // strides in elements
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

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

// Phase 1: grid (nc, B*H, P tiles x N tiles).  states[b, h, c, p, n] =
// sum_j x_j[p] B_j[n] dt_j exp(cum_last - cum_j); decay[b, h, c] =
// exp(cum_last).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(const Params p) {
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

  chunk_cumsum(p, b, h, c, dts, cum);
  chunk_suffix(p, h, dts, after);
  for (int j = tid; j < p.L; j += kThreads) wgt[j] = dts[j] * expf(after[j]);
  if (blockIdx.z == 0 && tid == 0) p.decay[(long long)bh * p.nc + c] = expf((float)cum[p.L - 1]);
  __syncthreads();

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + (long long)c * p.L * p.x_ss +
                h * p.x_sh + p0;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + (long long)c * p.L * p.b_ss +
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
      xs[jj * kPadTile + e] =
          (row && p0 + e < p.P) ? to_f32(xg[(long long)j * p.x_ss + e]) : 0.f;
      bs[jj * kPadTile + e] =
          (row && n0 + e < p.N) ? to_f32(bg[(long long)j * p.b_ss + e]) * wgt[j] : 0.f;
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

// Phase 2: grid (ceil(P*N / 256), B*H).  Walks the chunks in order: each
// chunk's contribution is replaced by the state before the chunk, and the
// state after the last chunk is h_final.
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
  const long long PN = (long long)p.P * p.N;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int bh = blockIdx.y;
  float* s = p.states + (long long)bh * p.nc * PN + e;
  const float* d = p.decay + (long long)bh * p.nc;
  float hv = 0.f;
  for (int c = 0; c < p.nc; ++c) {
    const float sc = s[c * PN];
    s[c * PN] = hv;
    hv = d[c] * hv + sc;
  }
  p.h_out[(long long)bh * PN + e] = hv;
}

// Phase 3: grid (nc * row tiles, B*H, P tiles); dynamic shared memory
// (see out_smem_bytes).  Row tiles are issued longest (most key tiles)
// first.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_out_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int sn = p.N | 1;               // odd row stride of N-wide tiles
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + kMaxChunk);
  float* cs = dts + kMaxChunk;          // C rows of this tile      [64][sn]
  float* bs = cs + kTile * sn;          // state tile, then B tiles [64][sn]
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

  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + (row0 + i0) * p.c_ss + g * p.c_sg;
  for (int idx = tid; idx < kTile * p.N; idx += kThreads) {
    const int ii = idx / p.N, e = idx - ii * p.N;
    cs[ii * sn + e] = i0 + ii < p.L ? to_f32(cg[(long long)ii * p.c_ss + e]) : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  // inter-chunk term: exp(cum_i) (C_i . h_prev); h_prev = 0 in chunk 0
  if (c > 0) {
    const float* hg = p.states + ((long long)bh * p.nc + c) * p.P * p.N + (long long)p0 * p.N;
    for (int idx = tid; idx < kTile * p.N; idx += kThreads) {
      const int pp = idx / p.N, e = idx - pp * p.N;
      bs[pp * sn + e] = p0 + pp < p.P ? hg[(long long)pp * p.N + e] : 0.f;
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
    __syncthreads();                    // bs is refilled below
  }

  // intra-chunk term over the key tiles up to the diagonal
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + (row0 + j0) * p.b_ss + g * p.b_sg;
    const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + (row0 + j0) * p.x_ss + h * p.x_sh + p0;
    for (int idx = tid; idx < kTile * p.N; idx += kThreads) {
      const int jj = idx / p.N, e = idx - jj * p.N;
      bs[jj * sn + e] = j0 + jj < p.L ? to_f32(bg[(long long)jj * p.b_ss + e]) : 0.f;
    }
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int jj = idx >> 6, e = idx & 63;
      xs[jj * kPadTile + e] = (j0 + jj < p.L && p0 + e < p.P)
                                  ? to_f32(xg[(long long)jj * p.x_ss + e]) : 0.f;
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
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tx + 16 * q;
        // masked entries never evaluate exp: cum_i - cum_j > 0 for j > i
        const float w =
            (j <= i && i < p.L) ? s[r][q] * expf((float)(cum[i] - cum[j])) * dts[j] : 0.f;
        ws[(ty + 16 * r) * kPadTile + tx + 16 * q] = w;
      }
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
    __syncthreads();                    // bs, xs, ws are refilled next round
  }

  const long long HP = (long long)p.H * p.P;
  T* yg = static_cast<T*>(p.y) + ((long long)b * p.S + row0 + i0) * HP + (long long)h * p.P + p0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ii = ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tx + 16 * q;
      if (i0 + ii < p.L && p0 + pp < p.P) store(yg + ii * HP + pp, acc[r][q]);
    }
  }
}

int out_smem_bytes(int N) {
  const int sn = N | 1;
  return (int)sizeof(double) * kMaxChunk +
         (int)sizeof(float) * (kMaxChunk + 2 * kTile * sn + 2 * kTile * kPadTile);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int ptiles = (p.P + kTile - 1) / kTile;
  const int ntiles = (p.N + kTile - 1) / kTile;
  ssd_state_kernel<T><<<dim3(p.nc, p.B * p.H, ptiles * ntiles), kThreads, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long PN = (long long)p.P * p.N;
  ssd_scan_kernel<<<dim3((unsigned)((PN + kThreads - 1) / kThreads), p.B * p.H), kThreads, 0,
                    stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = out_smem_bytes(p.N);
  e = cudaFuncSetAttribute(ssd_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int itiles = (p.L + kTile - 1) / kTile;
  ssd_out_kernel<T><<<dim3(p.nc * itiles, p.B * p.H, ptiles), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, H, P) and B/C (B, S, G, N), bf16 (is_bf16 = 1) or fp32, with
// (batch, seq, head/group) strides in elements and the last axis
// contiguous; dt (B, S, H) fp32 by strides; A (H,) fp32.  y (B, S, H, P)
// contiguous in x's dtype; h_out (B, H, P, N), states (B, H, S/L, P, N)
// and decay (B, H, S/L) contiguous fp32.  1 <= L <= 256, S % L == 0,
// 1 <= N <= 128, H % G == 0.
int rt_ssd(const void* x, const void* dt, const void* A, const void* bm, const void* cm, void* y,
           void* h_out, void* states, void* decay, int B, int S, int H, int P, int G, int N, int L,
           int is_bf16, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
           long long dt_ss, long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
           long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || N < 1 || N > kMaxN || L < 1 ||
      L > kMaxChunk || S % L != 0 || H % G != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), bm, cm, y,
                 static_cast<float*>(h_out), static_cast<float*>(states),
                 static_cast<float*>(decay), B, S, H, P, G, N, L, S / L,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(p, s) : launch<float>(p, s);
}

}  // extern "C"

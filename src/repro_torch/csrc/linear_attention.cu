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
// hd 64 against 8.9 MB moved, so it is bound by operations.  The contract
// is fp32 arithmetic (TF32 would break the 1e-4 gate), so the bound is
// the 67 TFLOP/s of fp32 FFMA.  This kernel's 64-row-tile form does
// about twice that: the diagonal tile's causal pairs (4 hd + 1 a pair)
// besides phi(q).S_before.
//
// What the design does about it.  The Pallas grid (B*H, S/C) walks the
// chunks in order with the (hd, hd) state in VMEM: at B 2, H 14 that is
// 28 blocks for 132 SMs.  Linear attention is SSD with no decay plus a
// normalizer, so the three phases of csrc/ssd.cu carry over, each
// parallel over row tiles:
//   1. la_state_kernel: per (b, kv head, 64-row tile of a chunk, 64 x 64
//      tile of S), the tile's own phi(k)^T v and sum phi(k) (the d-tile
//      0 block), over the rows before valid_len: per kv head, H / KV
//      times less work than per query head, and per row tile rather
//      than per chunk, so that B * KV * S / 64 blocks share the work;
//   2. la_scan_kernel: per (b, kv head, element of S or z), the short
//      pass over the row tiles that leaves each tile the sums over every
//      row before it and writes the final S and z to each query head of
//      the group;
//   3. la_out_kernel: per (b, h, 64-row tile, 64-wide d tile), the inter
//      term phi(q) S_before and phi(q).z_before, then the diagonal key
//      tile: s = phi(q) phi(k)^T masked to j <= i, its row sums into the
//      denominator (a 16-lane shuffle at the end), o += s v.  With no
//      decay the chunk changes only where the sums are cut, not the
//      function.  Row tiles wholly past valid_len are written as zeros.
// Every term of the denominator is positive (phi > 0), so it grows with
// the prompt (like its length) and nothing cancels in it.  Each thread
// owns a 4 x 4 register tile strided by 16 in both directions, and shared
// rows are padded to an odd length, so operand reads are conflict-free
// broadcasts or consecutive words.  Plain FFMA on SIMT cores; wgmma with
// an fp32-accurate split and TMA are later work.
//
// Interface: one plain C entry point (loaded with ctypes); it launches on
// the caller's stream, allocates nothing (the caller passes the
// (B, KV, nt, hd, hd) and (B, KV, nt, hd) fp32 scratch, nt = S / L *
// ceil(L / 64) row tiles) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows / columns of an output tile
constexpr int kPadTile = kTile + 1;     // odd row stride of 64-wide tiles
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

// phi(x) = elu(x) + 1, as the reference forms it (expm1 below zero)
__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expm1f(x) + 1.f; }

// Rows of chunk c that count: those before valid_len[b], at most L.
__device__ __forceinline__ int counted_rows(const Params& p, int b, int c) {
  int vl = p.valid_len ? p.valid_len[b] : p.S;
  vl = min(max(vl, 0), p.S);
  return min(max(vl - c * p.L, 0), p.L);
}

// Phase 1: grid (nt, B*KV, hd tiles x hd tiles), row tile t of chunk c
// at blockIdx.x = c * ceil(L / 64) + t.  states[b, kv, tile, k, d] =
// sum_j phi(k_j)[k] v_j[d] and zs[b, kv, tile, k] = sum_j phi(k_j)[k]
// over the tile's counted rows.
template <typename T>
__global__ void __launch_bounds__(kThreads) la_state_kernel(const Params p) {
  __shared__ float ks[kTile * kPadTile], vs[kTile * kPadTile];
  const int tiles_per_chunk = (p.L + kTile - 1) / kTile;
  const int c = blockIdx.x / tiles_per_chunk, bk = blockIdx.y;
  const int j0 = (blockIdx.x - c * tiles_per_chunk) * kTile;
  const int b = bk / p.KV, kh = bk - b * p.KV;
  const int n_tiles = (p.hd + kTile - 1) / kTile;
  const int k0 = (blockIdx.z % n_tiles) * kTile;
  const int d0 = (blockIdx.z / n_tiles) * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = counted_rows(p, b, c);
  const long long row0 = (long long)c * p.L;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + row0 * p.k_ss + kh * p.k_sh + k0;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + row0 * p.v_ss + kh * p.v_sh + d0;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  float zacc = 0.f;                     // threads < 64 of the d-tile 0 block

  if (j0 < rows) {                      // else the tile is padding: zeros
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int jj = idx >> 6, e = idx & 63, j = j0 + jj;
      const bool row = j < rows;
      ks[jj * kPadTile + e] = (row && k0 + e < p.hd) ? phi(to_f32(kg[(long long)j * p.k_ss + e])) : 0.f;
      vs[jj * kPadTile + e] = (row && d0 + e < p.hd) ? to_f32(vg[(long long)j * p.v_ss + e]) : 0.f;
    }
    __syncthreads();
    const int jn = min(kTile, rows - j0);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      float kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) kv[r] = ks[jj * kPadTile + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) vv[q] = vs[jj * kPadTile + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(kv[r], vv[q], acc[r][q]);
    }
    if (d0 == 0 && tid < kTile)
      for (int jj = 0; jj < jn; ++jj) zacc += ks[jj * kPadTile + tid];
    __syncthreads();
  }

  const long long HD2 = (long long)p.hd * p.hd;
  const long long tile = (long long)bk * p.nt + blockIdx.x;
  float* out = p.states + tile * HD2;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kk = k0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dd = d0 + tx + 16 * q;
      if (kk < p.hd && dd < p.hd) out[(long long)kk * p.hd + dd] = acc[r][q];
    }
  }
  if (d0 == 0 && tid < kTile && k0 + tid < p.hd) p.zs[tile * p.hd + k0 + tid] = zacc;
}

// Phase 2: grid (ceil((hd*hd + hd) / 256), B*KV).  Walks the row tiles in
// order: each tile's sums are replaced by the sums before the tile, and
// the sums after the last tile go to each query head of the group.
__global__ void __launch_bounds__(kThreads) la_scan_kernel(const Params p) {
  const long long HD2 = (long long)p.hd * p.hd;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= HD2 + p.hd) return;
  const int bk = blockIdx.y, b = bk / p.KV, kh = bk - b * p.KV;
  const bool in_s = e < HD2;
  const long long stride = in_s ? HD2 : p.hd;
  float* s = in_s ? p.states + (long long)bk * p.nt * HD2 + e
                  : p.zs + (long long)bk * p.nt * p.hd + (e - HD2);
  float run = 0.f;
  for (int t = 0; t < p.nt; ++t) {
    const float st = s[t * stride];
    s[t * stride] = run;
    run += st;
  }
  for (int g = 0; g < p.G; ++g) {
    const long long bh = (long long)b * p.H + kh * p.G + g;
    if (in_s) p.s_out[bh * HD2 + e] = run;
    else p.z_out[bh * p.hd + (e - HD2)] = run;
  }
}

// Phase 3: grid (nc * row tiles, B*H, hd tiles); dynamic shared memory
// (see out_smem_bytes).  Row tile t = blockIdx.x is tile t % ceil(L / 64)
// of chunk t / ceil(L / 64).
template <typename T>
__global__ void __launch_bounds__(kThreads) la_out_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int sn = p.hd | 1;              // odd row stride of hd-wide tiles
  float* qs = smem;                     // phi(q) rows of this tile    [64][sn]
  float* ks = qs + kTile * sn;          // S_before tile, then phi(k)  [64][sn]
  float* vs = ks + kTile * sn;          // v tile                      [64][65]
  float* ws = vs + kTile * kPadTile;    // masked scores               [64][65]
  float* zsm = ws + kTile * kPadTile;   // z_before                    [hd]

  const int n_itiles = (p.L + kTile - 1) / kTile;
  const int tile = blockIdx.x, c = tile / n_itiles;
  const int i0 = (tile - c * n_itiles) * kTile;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kh = h / p.G, bk = b * p.KV + kh;
  const int d0 = blockIdx.z * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rows = counted_rows(p, b, c);
  const int tile_rows = min(kTile, p.L - i0);
  const long long row0 = (long long)c * p.L;
  const long long HH = (long long)p.H * p.hd;
  T* og = static_cast<T*>(p.out) + ((long long)b * p.S + row0 + i0) * HH + (long long)h * p.hd + d0;

  if (i0 >= rows) {                     // the whole tile is padding
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int ii = idx >> 6, dd = idx & 63;
      if (ii < tile_rows && d0 + dd < p.hd) store(og + ii * HH + dd, 0.f);
    }
    return;
  }

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + (row0 + i0) * p.q_ss + h * p.q_sh;
  for (int idx = tid; idx < kTile * p.hd; idx += kThreads) {
    const int ii = idx / p.hd, e = idx - ii * p.hd;
    qs[ii * sn + e] = i0 + ii < rows ? phi(to_f32(qg[(long long)ii * p.q_ss + e])) : 0.f;
  }

  float acc[4][4], den[4], part[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    den[r] = 0.f;
    part[r] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  }

  // inter term: phi(q_i) S_before and phi(q_i).z_before, the sums over
  // every row before the tile (zero for the first tile)
  if (tile > 0) {
    const long long HD2 = (long long)p.hd * p.hd;
    const long long before = (long long)bk * p.nt + tile;
    const float* sg = p.states + before * HD2 + d0;
    for (int idx = tid; idx < kTile * p.hd; idx += kThreads) {
      const int kk = idx >> 6, dd = idx & 63;   // S_before[kk][d0 + dd] -> ks[dd][kk]
      ks[dd * sn + kk] = d0 + dd < p.hd ? sg[(long long)kk * p.hd + dd] : 0.f;
    }
    const float* zg = p.zs + before * p.hd;
    for (int e = tid; e < p.hd; e += kThreads) zsm[e] = zg[e];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < p.hd; ++kk) {
      float qv[4], sv[4];
      const float zk = zsm[kk];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty + 16 * r) * sn + kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = ks[(tx + 16 * q) * sn + kk];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        den[r] = fmaf(qv[r], zk, den[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(qv[r], sv[q], acc[r][q]);
      }
    }
    __syncthreads();                    // ks is refilled below
  }

  // intra term: the diagonal key tile, masked to j <= i (rows past
  // valid_len are zero-filled)
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + (row0 + i0) * p.k_ss + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + (row0 + i0) * p.v_ss + kh * p.v_sh + d0;
  for (int idx = tid; idx < kTile * p.hd; idx += kThreads) {
    const int jj = idx / p.hd, e = idx - jj * p.hd;
    ks[jj * sn + e] = i0 + jj < rows ? phi(to_f32(kg[(long long)jj * p.k_ss + e])) : 0.f;
  }
  for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
    const int jj = idx >> 6, e = idx & 63;
    vs[jj * kPadTile + e] = (i0 + jj < rows && d0 + e < p.hd)
                                ? to_f32(vg[(long long)jj * p.v_ss + e]) : 0.f;
  }
  __syncthreads();

  float s[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
#pragma unroll 4
  for (int e = 0; e < p.hd; ++e) {
    float qv[4], kv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) qv[r] = qs[(ty + 16 * r) * sn + e];
#pragma unroll
    for (int q = 0; q < 4; ++q) kv[q] = ks[(tx + 16 * q) * sn + e];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = fmaf(qv[r], kv[q], s[r][q]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tx + 16 * q;
      const float w = j <= i ? s[r][q] : 0.f;
      part[r] += w;
      ws[i * kPadTile + j] = w;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int jj = 0; jj < kTile; ++jj) {
    float wv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wv[r] = ws[(ty + 16 * r) * kPadTile + jj];
#pragma unroll
    for (int q = 0; q < 4; ++q) vv[q] = vs[jj * kPadTile + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r], vv[q], acc[r][q]);
  }

  // the row sums: each row's 64 columns lie with the 16 lanes sharing ty
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part[r] += __shfl_xor_sync(kFull, part[r], off);

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ii = ty + 16 * r;
    const bool counted = i0 + ii < rows;
    const float inv = 1.f / fmaxf(den[r] + part[r], kEps);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dd = tx + 16 * q;
      if (ii < tile_rows && d0 + dd < p.hd)
        store(og + ii * HH + dd, counted ? acc[r][q] * inv : 0.f);
    }
  }
}

int out_smem_bytes(int hd) {
  const int sn = hd | 1;
  return (int)sizeof(float) * (2 * kTile * sn + 2 * kTile * kPadTile + kMaxHd);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int tiles = (p.hd + kTile - 1) / kTile;
  la_state_kernel<T><<<dim3(p.nt, p.B * p.KV, tiles * tiles), kThreads, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)p.hd * p.hd + p.hd;
  la_scan_kernel<<<dim3((unsigned)((n + kThreads - 1) / kThreads), p.B * p.KV), kThreads, 0,
                   stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = out_smem_bytes(p.hd);
  e = cudaFuncSetAttribute(la_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int itiles = (p.L + kTile - 1) / kTile;
  la_out_kernel<T><<<dim3(p.nc * itiles, p.B * p.H, tiles), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
      S % L != 0 || H % KV != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(valid_len), out,
                 static_cast<float*>(s_out), static_cast<float*>(z_out),
                 static_cast<float*>(states), static_cast<float*>(zs),
                 B, S, H, KV, hd, L, S / L, H / KV, S / L * ((L + kTile - 1) / kTile),
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(p, s) : launch<float>(p, s);
}

}  // extern "C"

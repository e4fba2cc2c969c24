// Flash attention for Hopper (sm_90a).
//
// The counterpart of the reference's Pallas kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py:55): causal or non-causal
// attention with an online softmax, GQA by kv row.
//
// What it computes.  o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / G] with
// s_ij = (q[b, i, h] . k[b, j, h / G]) * hd^-1/2 in fp32, where causal masks
// keys j > i to -1e30 (query and key positions both counted from 0, as the
// Pallas kernel's iota origin).  Per query row the running max m, running
// sum l and the accumulator live in fp32; each tile's probabilities
// p = exp(s - m) are rounded to bf16 before P.V (the Pallas kernel's
// p.astype(v.dtype)); the output is acc / max(l, 1e-30) rounded to bf16.
// q (B, Sq, H, hd), k/v (B, Sk, KV, hd) and o (B, Sq, H, hd) are read and
// written in the model's own layout through strides: the head axis must
// be contiguous and rows 16-byte aligned.  Two instances, each at hd 16,
// 32, 64, 128 and 160 (the reference's test grid and every served or
// listed config): bf16 on the tensor cores, and fp32.
//
// What bounds it on an H100.  At prefill lengths it is bound by
// operations: two products of 2 * B * H * Sq * Sk * hd flop each (half of
// that when causal) against 989 TFLOP/s dense bf16 (67 TFLOP/s fp32
// FFMA), while it moves only q, k, v and o once (the score matrix never
// reaches device memory).
//
// What the design does about it (bf16).  Both products run on the tensor cores
// with mma.sync m16n8k16 (bf16 in, fp32 accumulate).  One block of four
// warps owns 64 query rows of one (batch, head); each warp owns 16 rows
// and keeps its Q fragments, its fp32 scores and its fp32 output
// accumulator in registers, so the score tile goes from the S product
// straight into the A operand of the P.V product without touching shared
// memory.  K/V stream through shared memory in 64-key tiles, double
// buffered with 16-byte cp.async copies (the next tile loads while this
// one computes); V's B fragments come from ldmatrix.trans.  Rows are
// padded by 8 elements so the fragment loads hit 32 distinct banks.  A
// causal block stops at its diagonal tile, and blocks are issued longest
// rows first so the short ones fill the tail.  Ragged tile edges read
// zeros and mask scores to -1e30.  wgmma, TMA and warp specialisation are
// later work.
//
// The fp32 instance keeps the same online-softmax structure on SIMT FFMA
// (as csrc/ssd.cu and csrc/linear_attention.cu do): TF32 tensor cores
// keep a 10-bit mantissa and would miss the reference's 1e-4 gate.  One
// block of 128 threads owns 32 query rows of one (batch, head), four
// threads a row; Q and 32-key K/V tiles sit in shared memory (rows padded
// by 4 floats: conflict-free float4 reads), each thread holds 8 of its
// row's 32 scores and hd / 4 output columns in registers, and the fp32
// probabilities go through a small shared tile into P.V unrounded (the
// Pallas p.astype(v.dtype) is the identity in fp32).
//
// Interface: two plain C entry points, bf16 and fp32 (loaded with ctypes);
// each launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;             // query rows per block, 16 per warp
constexpr int kBlockN = 64;             // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                 // bf16 row padding in shared memory
constexpr int kTiles = 5;               // shared tiles: Q, 2 x K, 2 x V
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, Sq, Sk, H, KV, causal;
  long long q_sb, q_ss, q_sh;           // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8x8 bf16 matrices; lanes 8m..8m+7 give matrix m's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// two fp32 values -> a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 rows x HD of a strided source into a padded shared tile; rows at or
// past `valid` are zero-filled (a zero V row times a zero p stays 0)
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int valid) {
  constexpr int kChunks = HD / 8;       // 16-byte chunks per row
  constexpr int kStride = HD + kPad;
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < valid;
    cp_async16(dst + r * kStride + c * 8, src + (ok ? r * row_stride : 0) + c * 8,
               ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr int kStride = HD + kPad;
  constexpr int kTile = kBlockN * kStride;
  constexpr int kK = HD / 16;           // k-steps of the q.k product
  constexpr int kN = kBlockN / 8;       // 8-key column tiles of a score tile
  constexpr int kD = HD / 8;            // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile;                // two buffers
  bf16* vs = ks + 2 * kTile;            // two buffers

  const int nq = (p.Sq + kBlockM - 1) / kBlockM;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBlockM;   // longest rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const bf16* qg = p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh;
  const bf16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + kvh * p.v_sh;

  int n_tiles = (p.Sk + kBlockN - 1) / kBlockN;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBlockM, p.Sq) - 1) / kBlockN + 1);

  load_tile<HD>(qs, qg, p.q_ss, p.Sq - q0);
  load_tile<HD>(ks, kg, p.k_ss, p.Sk);
  load_tile<HD>(vs, vg, p.v_ss, p.Sk);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;       // this thread's rows: row0, row0 + 8
  const int qpos0 = q0 + row0, qpos1 = qpos0 + 8;

  uint32_t qf[kK][4];
  float acc[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {              // the next tile loads under this one
      const int nb = (j + 1) & 1;
      const int k1 = (j + 1) * kBlockN;
      load_tile<HD>(ks + nb * kTile, kg + k1 * p.k_ss, p.k_ss, p.Sk - k1);
      load_tile<HD>(vs + nb * kTile, vg + k1 * p.v_ss, p.v_ss, p.Sk - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const bf16* r = qs + row0 * kStride + kk * 16 + 2 * t;
        qf[kk][0] = lds32(r);
        qf[kk][1] = lds32(r + 8 * kStride);
        qf[kk][2] = lds32(r + 8);
        qf[kk][3] = lds32(r + 8 * kStride + 8);
      }
    }
    const bf16* kt = ks + (j & 1) * kTile;
    const bf16* vt = vs + (j & 1) * kTile;

    // scores of this warp's 16 rows x 64 keys
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kr = kt + (n * 8 + g) * kStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        mma_bf16(s[n], qf[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }

    const int k0 = j * kBlockN;
    const bool edge = k0 + kBlockN > p.Sk || (p.causal && k0 + kBlockN - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * p.scale;
        if (edge) {
          const int kp = k0 + n * 8 + 2 * t + (c & 1);
          const int qp = c < 2 ? qpos0 : qpos1;
          if (kp >= p.Sk || (p.causal && kp > qp)) x = kNegInf;
        }
        s[n][c] = x;
        if (c < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    // a row's 64 scores are spread over the 4 lanes of its quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    // per-lane partial sums; the quad's lanes are added at the end
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      acc[d][0] *= corr0;
      acc[d][1] *= corr0;
      acc[d][2] *= corr1;
      acc[d][3] *= corr1;
    }

    // acc += bf16(P) V: the score accumulators are the A fragments
    const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = vt + (kk * 16 + (mat & 1) * 8 + mrow) * kStride + (mat >> 1) * 8;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vr + dp * 16);
        mma_bf16(acc[2 * dp], a, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();                    // this buffer is refilled next round
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  bf16* o0 = p.o + b * p.o_sb + qpos0 * p.o_ss + h * p.o_sh + 2 * t;
  bf16* o1 = o0 + 8 * p.o_ss;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    if (qpos0 < p.Sq)
      *reinterpret_cast<uint32_t*>(o0 + d * 8) = pack_bf16(acc[d][0] / den0, acc[d][1] / den0);
    if (qpos1 < p.Sq)
      *reinterpret_cast<uint32_t*>(o1 + d * 8) = pack_bf16(acc[d][2] / den1, acc[d][3] / den1);
  }
}

// ---- fp32: SIMT FFMA -------------------------------------------------------

constexpr int kBM32 = 32;               // query rows per block, 4 threads a row
constexpr int kBN32 = 32;               // keys per K/V tile
constexpr int kThreads32 = 128;

struct ParamsF {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, Sq, Sk, H, KV, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
};

// 32 rows x HD of a strided fp32 source into a shared tile of row stride
// HD + 4; rows at or past `valid` are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long row_stride, int valid) {
  constexpr int kV = HD / 4;            // float4 per row
  for (int i = threadIdx.x; i < kBN32 * kV; i += kThreads32) {
    const int r = i / kV, c = i - r * kV;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * row_stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c * 4) = x;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads32) flash_attention_f32_kernel(const ParamsF p) {
  constexpr int kS = HD + 4;            // shared row stride (floats)
  constexpr int kP = kBN32 + 1;         // probability tile row stride
  constexpr int kN = kBN32 / 4;         // scores per thread
  constexpr int kO = HD / 16;           // float4 output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBM32 * kS;
  float* vs = ks + kBN32 * kS;
  float* ps = vs + kBN32 * kS;

  const int nq = (p.Sq + kBM32 - 1) / kBM32;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBM32;   // longest rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const float* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  int n_tiles = (p.Sk + kBN32 - 1) / kBN32;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBM32, p.Sq) - 1) / kBN32 + 1);

  load_rows_f32<HD>(qs, p.q + b * p.q_sb + q0 * p.q_ss + h * p.q_sh, p.q_ss, p.Sq - q0);

  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;  // row r; keys c + 4n
  const int qpos = q0 + r;
  float acc[kO][4];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN32;
    __syncthreads();                    // the last tile's readers are done
    load_rows_f32<HD>(ks, kg + k0 * p.k_ss, p.k_ss, p.Sk - k0);
    load_rows_f32<HD>(vs, vg + k0 * p.v_ss, p.v_ss, p.Sk - k0);
    __syncthreads();

    float s[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) s[n] = 0.f;
    const float* qr = qs + r * kS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (c + 4 * n) * kS + d);
        s[n] = fmaf(qv.x, kv.x, s[n]);
        s[n] = fmaf(qv.y, kv.y, s[n]);
        s[n] = fmaf(qv.z, kv.z, s[n]);
        s[n] = fmaf(qv.w, kv.w, s[n]);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int kp = k0 + c + 4 * n;
      float x = s[n] * p.scale;
      if (kp >= p.Sk || (p.causal && kp > qpos)) x = kNegInf;
      s[n] = x;
      mx = fmaxf(mx, x);
    }
    // a row's 32 scores are spread over the 4 neighbouring lanes of its row
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float psum = 0.f;
    float* pr = ps + r * kP;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float e = expf(s[n] - mn);
      psum += e;
      pr[c + 4 * n] = e;
    }
    l = l * corr + psum;                // per-lane partial; lanes added at the end
#pragma unroll
    for (int i = 0; i < kO; ++i) {
      acc[i][0] *= corr;
      acc[i][1] *= corr;
      acc[i][2] *= corr;
      acc[i][3] *= corr;
    }
    __syncwarp();                       // row r's probabilities: its 4 lanes
#pragma unroll 4
    for (int n = 0; n < kBN32; ++n) {
      const float pn = pr[n];
      const float* vr = vs + n * kS + 4 * c;
#pragma unroll
      for (int i = 0; i < kO; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 16 * i);
        acc[i][0] = fmaf(pn, vv.x, acc[i][0]);
        acc[i][1] = fmaf(pn, vv.y, acc[i][1]);
        acc[i][2] = fmaf(pn, vv.z, acc[i][2]);
        acc[i][3] = fmaf(pn, vv.w, acc[i][3]);
      }
    }
  }

  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  if (qpos < p.Sq) {
    const float den = fmaxf(l, 1e-30f);
    float* o = p.o + b * p.o_sb + qpos * p.o_ss + h * p.o_sh + 4 * c;
#pragma unroll
    for (int i = 0; i < kO; ++i)
      *reinterpret_cast<float4*>(o + 16 * i) =
          make_float4(acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den);
  }
}

template <int HD>
int launch_f32(const ParamsF& p, cudaStream_t stream) {
  const int smem = (3 * kBM32 * (HD + 4) + kBM32 * (kBN32 + 1)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_f32_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + kBM32 - 1) / kBM32, p.B * p.H);
  flash_attention_f32_kernel<HD><<<grid, kThreads32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = kTiles * kBlockN * (HD + kPad) * (int)sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.B * p.H);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd), o (B, Sq, H, hd), all bf16, with
// (batch, seq, head) strides in elements (head axis contiguous, strides
// multiples of 8, pointers 16-byte aligned).  hd is 16, 32, 64, 128 or
// 160; H % KV == 0.
int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Sk, int H, int KV, int hd, int causal, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                       long long o_sb, long long o_ss, long long o_sh, float scale,
                       void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(o),
                 B, Sq, Sk, H, KV, causal,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    case 160: return launch<160>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same in fp32: strides multiples of 4, pointers 16-byte aligned.
int rt_flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                           int Sq, int Sk, int H, int KV, int hd, int causal,
                           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                           float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const ParamsF p{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  B, Sq, Sk, H, KV, causal,
                  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                  scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_f32<16>(p, s);
    case 32: return launch_f32<32>(p, s);
    case 64: return launch_f32<64>(p, s);
    case 128: return launch_f32<128>(p, s);
    case 160: return launch_f32<160>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

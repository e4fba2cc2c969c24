// Fused low-bit cohort-decode kernels for Hopper (sm_90a).
//
// Three kernels of the decode step, each the counterpart of a Pallas
// kernel of the reference package (src/repro/kernels/fused_decode/kernel.py):
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
// order).  A dense unit is one 16-byte vector: 8 bf16 or 4 fp32 values.
//
// What bounds them on an H100.  At bc <= 8 a GEMV does 2*bc flops per
// weight element, far below the ~295 flop/byte balance point of the card:
// all three are bound by device-memory bytes.  fused_qkv streams ~0.65 MB
// of packed q4 weights per layer, fused_mlp ~8.2 MB, and the scatter
// writes 2*L*bc*KV*hd*2 bytes (a few KB): launch overhead dominates it.
//
// What the design does about it.  The packed weights are read once, in
// 32-byte sectors fully used: a warp covers 8 consecutive words (one
// sector) of 4 consecutive K rows.  To keep enough loads in flight the K
// axis is split twice: among the 8 warps of a block (reduced in shared
// memory) and among blocks (grid.y).  Blocks cannot wait on each other,
// so each block writes fp32 partial sums to a scratch buffer and a second
// small kernel adds the K-splits in a fixed order and applies the
// epilogue (rounding, bias, activation).  No atomics: results are
// deterministic.  The TPU kernel fuses the whole MLP into one call; here
// the down projection needs every column of `mid`, so the MLP is two
// GEMV stages (gate/up -> act -> mid in scratch, then down).
//
// Interface: plain C entry points (loaded with ctypes); each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 8;     // cohort rows per launch
constexpr int kTile = 8;        // weight units (words / 16-byte vectors) per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKRows = 4 * kWarps;  // K rows per block iteration
constexpr int kMaxChunk = 128;  // K rows per block (grid.y split)
constexpr int kMaxSegs = 3;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round an fp32 value to T and back (the identity for fp32)
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// outputs per weight unit: one int32 word of codes, or one 16-byte vector
template <int BITS, typename T> struct Unit {
  static constexpr int kOut = BITS ? 32 / BITS : 16 / (int)sizeof(T);
};

struct Seg {
  const void* w;         // codes (K, n / kOut) int32, or dense (K, n) T
  const float* scales;   // (K, n / group) fp32; null when dense
  int n;                 // outputs of this segment
  int group;             // scale group size along n (packed only)
  int col;               // first column of this segment in `partial`
  int tile0;             // first grid.x tile of this segment
};

struct Segs {
  Seg s[kMaxSegs];
  int count;
};

// dequantize one weight unit of row k into fp32 values already rounded to T
template <int BITS, typename T>
__device__ __forceinline__ void load_unit(const Seg& sg, size_t k, int unit,
                                          float (&w)[Unit<BITS, T>::kOut]) {
  constexpr int kOut = Unit<BITS, T>::kOut;
  if constexpr (BITS == 0) {
    const uint4* row = reinterpret_cast<const uint4*>(
        static_cast<const T*>(sg.w) + k * (size_t)sg.n);
    const uint4 v = __ldg(row + unit);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < kOut; ++j) w[j] = to_f(e[j]);
  } else {
    const int units = sg.n / kOut;
    const int32_t word =
        __ldg(static_cast<const int32_t*>(sg.w) + k * (size_t)units + unit);
    const float sc =
        __ldg(sg.scales + k * (size_t)(sg.n / sg.group) + (unit * kOut) / sg.group);
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      int f = (word >> (j * BITS)) & ((1 << BITS) - 1);
      if (f >= (1 << (BITS - 1))) f -= (1 << BITS);
      w[j] = round_t<T>(static_cast<float>(f) * sc);
    }
  }
}

// partial[ks, b, col + n] = sum over this block's K chunk of h[b, k] W[k, n]
template <int BITS, typename T>
__global__ void __launch_bounds__(kThreads)
gemv_partial_kernel(Segs segs, const T* __restrict__ h, int bc, int K,
                    int k_chunk, int n_total, float* __restrict__ partial) {
  constexpr int kOut = Unit<BITS, T>::kOut;
  __shared__ float hs[kMaxRows * kMaxChunk];
  __shared__ float red[kWarps * kTile * kMaxRows * kOut];

  const int tile = blockIdx.x;
  int si = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegs; ++i)
    if (i < segs.count && tile >= segs.s[i].tile0) si = i;
  const Seg sg = segs.s[si];
  const int units = sg.n / kOut;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane & (kTile - 1);
  const int unit = (tile - sg.tile0) * kTile + c;
  const int krow = (lane >> 3) + 4 * warp;
  const int k0 = blockIdx.y * k_chunk;
  const int kn = min(k_chunk, K - k0);

  for (int i = threadIdx.x; i < bc * kn; i += kThreads) {
    const int b = i / kn, kk = i - b * kn;
    hs[b * kMaxChunk + kk] = to_f(h[(size_t)b * K + k0 + kk]);
  }
  __syncthreads();

  float acc[kMaxRows][kOut];
#pragma unroll
  for (int b = 0; b < kMaxRows; ++b)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[b][j] = 0.f;

  if (unit < units) {
#pragma unroll 2
    for (int kk = krow; kk < kn; kk += kKRows) {
      float w[kOut];
      load_unit<BITS, T>(sg, (size_t)(k0 + kk), unit, w);
#pragma unroll
      for (int b = 0; b < kMaxRows; ++b) {
        if (b < bc) {
          const float hv = hs[b * kMaxChunk + kk];
#pragma unroll
          for (int j = 0; j < kOut; ++j) acc[b][j] = fmaf(hv, w[j], acc[b][j]);
        }
      }
    }
  }

  // the 4 K-rows of a warp: lanes c, c+8, c+16, c+24
#pragma unroll
  for (int b = 0; b < kMaxRows; ++b)
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      float v = acc[b][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[b][j] = v;
    }
  if (lane < kTile) {
#pragma unroll
    for (int b = 0; b < kMaxRows; ++b)
      if (b < bc)
#pragma unroll
        for (int j = 0; j < kOut; ++j)
          red[((warp * kTile + c) * kMaxRows + b) * kOut + j] = acc[b][j];
  }
  __syncthreads();

  // the 8 warps, added in a fixed order
  for (int i = threadIdx.x; i < kTile * bc * kOut; i += kThreads) {
    const int cc = i / (bc * kOut);
    const int r = i - cc * bc * kOut;
    const int b = r / kOut, j = r - b * kOut;
    const int u = (tile - sg.tile0) * kTile + cc;
    if (u >= units) continue;
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8)
      s += red[((w8 * kTile + cc) * kMaxRows + b) * kOut + j];
    partial[((size_t)blockIdx.y * bc + b) * n_total + sg.col + u * kOut + j] = s;
  }
}

struct OutSeg {
  void* out;           // (bc, n) T
  const void* bias;    // (n,) T or null
  int n;
  int col;             // first column in `partial`
};

struct OutSegs {
  OutSeg s[kMaxSegs];
  int count;
};

// out[b, n] = rt(rt(sum_ks partial[ks, b, col + n]) + bias[n]), rt = round to T
template <typename T>
__global__ void store_epilogue_kernel(OutSegs segs, const float* __restrict__ partial,
                                      int ksplit, int bc, int n_total) {
  const int total = bc * n_total;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int b = i / n_total, col = i - b * n_total;
    int si = 0;
#pragma unroll
    for (int t = 1; t < kMaxSegs; ++t)
      if (t < segs.count && col >= segs.s[t].col) si = t;
    const OutSeg o = segs.s[si];
    const int j = col - o.col;
    float s = 0.f;
    for (int ks = 0; ks < ksplit; ++ks)
      s += partial[((size_t)ks * bc + b) * n_total + col];
    float y = round_t<T>(s);
    if (o.bias != nullptr)
      y = round_t<T>(y + to_f(static_cast<const T*>(o.bias)[j]));
    static_cast<T*>(o.out)[(size_t)b * o.n + j] = from_f<T>(y);
  }
}

enum Act { kSilu = 0, kGelu = 1, kRelu = 2, kSquaredRelu = 3 };

__device__ __forceinline__ float act_fn(int act, float x) {
  switch (act) {
    case kSilu: return x / (1.f + expf(-x));
    case kGelu: {
      const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
    }
    case kRelu: return fmaxf(x, 0.f);
    default: { const float r = fmaxf(x, 0.f); return r * r; }
  }
}

// mid[b, j] = rt(rt(act(rt(gate))) * rt(up))  (gated), or rt(act(rt(up)))
// partial columns: up at [0, F), gate at [F, 2F)
template <typename T>
__global__ void glu_epilogue_kernel(const float* __restrict__ partial, int ksplit,
                                    int bc, int F, int gated, int act,
                                    T* __restrict__ mid) {
  const int n_total = gated ? 2 * F : F;
  const int total = bc * F;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int b = i / F, j = i - b * F;
    float up = 0.f, gate = 0.f;
    for (int ks = 0; ks < ksplit; ++ks) {
      const float* row = partial + ((size_t)ks * bc + b) * n_total;
      up += row[j];
      if (gated) gate += row[F + j];
    }
    up = round_t<T>(up);
    float m;
    if (gated) {
      const float a = round_t<T>(act_fn(act, round_t<T>(gate)));
      m = round_t<T>(a * up);
    } else {
      m = round_t<T>(act_fn(act, up));
    }
    mid[(size_t)b * F + j] = from_f<T>(m);
  }
}

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

int ksplit_of(int K, int k_chunk) { return (K + k_chunk - 1) / k_chunk; }

// One partial-GEMV launch per distinct BITS among the segments.
template <typename T>
int launch_partials(const T* h, int bc, int K, int nseg, const void* const* w,
                    const float* const* scales, const int* n, const int* bits,
                    const int* group, float* partial, int n_total, int k_chunk,
                    cudaStream_t stream) {
  if (bc < 1 || bc > kMaxRows || k_chunk < 1 || k_chunk > kMaxChunk ||
      nseg < 1 || nseg > kMaxSegs)
    return (int)cudaErrorInvalidValue;
  const int ks = ksplit_of(K, k_chunk);
  int col = 0;
  int cols[kMaxSegs];
  for (int i = 0; i < nseg; ++i) {
    if (bits[i] != 0 && bits[i] != 2 && bits[i] != 4 && bits[i] != 8)
      return (int)cudaErrorInvalidValue;
    cols[i] = col;
    col += n[i];
  }
  if (col != n_total) return (int)cudaErrorInvalidValue;
  const int kBits[4] = {0, 2, 4, 8};
  for (int bi = 0; bi < 4; ++bi) {
    Segs segs{};
    int tiles = 0;
    for (int i = 0; i < nseg; ++i) {
      if (bits[i] != kBits[bi]) continue;
      const int out = bits[i] ? 32 / bits[i] : 16 / (int)sizeof(T);
      if (n[i] % out != 0 || (bits[i] && (group[i] % out != 0 || n[i] % group[i] != 0)))
        return (int)cudaErrorInvalidValue;
      Seg& s = segs.s[segs.count++];
      s.w = w[i];
      s.scales = scales[i];
      s.n = n[i];
      s.group = bits[i] ? group[i] : 1;
      s.col = cols[i];
      s.tile0 = tiles;
      tiles += (n[i] / out + kTile - 1) / kTile;
    }
    if (segs.count == 0) continue;
    const dim3 grid(tiles, ks);
    switch (kBits[bi]) {
      case 0: gemv_partial_kernel<0, T><<<grid, kThreads, 0, stream>>>(segs, h, bc, K, k_chunk, n_total, partial); break;
      case 2: gemv_partial_kernel<2, T><<<grid, kThreads, 0, stream>>>(segs, h, bc, K, k_chunk, n_total, partial); break;
      case 4: gemv_partial_kernel<4, T><<<grid, kThreads, 0, stream>>>(segs, h, bc, K, k_chunk, n_total, partial); break;
      default: gemv_partial_kernel<8, T><<<grid, kThreads, 0, stream>>>(segs, h, bc, K, k_chunk, n_total, partial); break;
    }
  }
  return (int)cudaGetLastError();
}

int epilogue_blocks(int total) { return (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024; }

template <typename T>
int fused_qkv_impl(const void* h, int bc, int K, int nseg, const void* const* w,
                   const float* const* scales, const int* n, const int* bits,
                   const int* group, const void* const* bias, void* const* out,
                   float* partial, int k_chunk, cudaStream_t stream) {
  int n_total = 0;
  for (int i = 0; i < nseg; ++i) n_total += n[i];
  int err = launch_partials<T>(static_cast<const T*>(h), bc, K, nseg, w, scales, n,
                               bits, group, partial, n_total, k_chunk, stream);
  if (err) return err;
  OutSegs segs{};
  int col = 0;
  for (int i = 0; i < nseg; ++i) {
    OutSeg& o = segs.s[segs.count++];
    o.out = out[i];
    o.bias = bias[i];
    o.n = n[i];
    o.col = col;
    col += n[i];
  }
  store_epilogue_kernel<T><<<epilogue_blocks(bc * n_total), 256, 0, stream>>>(
      segs, partial, ksplit_of(K, k_chunk), bc, n_total);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_mlp_impl(const void* h, int bc, int D, int F, int gated, int act,
                   const void* const* w, const float* const* scales,
                   const int* bits, const int* group, void* mid, void* out,
                   float* partial1, int k_chunk1, float* partial2, int k_chunk2,
                   cudaStream_t stream) {
  // stage 1: up (and gate) -> act -> mid
  const int n1[2] = {F, F};
  const void* w1[2] = {w[0], w[1]};
  const float* s1[2] = {scales[0], scales[1]};
  const int b1[2] = {bits[0], bits[1]};
  const int g1[2] = {group[0], group[1]};
  const int nseg1 = gated ? 2 : 1;
  int err = launch_partials<T>(static_cast<const T*>(h), bc, D, nseg1, w1, s1, n1,
                               b1, g1, partial1, nseg1 * F, k_chunk1, stream);
  if (err) return err;
  glu_epilogue_kernel<T><<<epilogue_blocks(bc * F), 256, 0, stream>>>(
      partial1, ksplit_of(D, k_chunk1), bc, F, gated, act, static_cast<T*>(mid));
  err = (int)cudaGetLastError();
  if (err) return err;
  // stage 2: mid @ W_down
  const int n2[1] = {D};
  const void* w2[1] = {w[2]};
  const float* s2[1] = {scales[2]};
  const int b2[1] = {bits[2]};
  const int g2[1] = {group[2]};
  err = launch_partials<T>(static_cast<const T*>(mid), bc, F, 1, w2, s2, n2, b2, g2,
                           partial2, D, k_chunk2, stream);
  if (err) return err;
  OutSegs segs{};
  segs.count = 1;
  segs.s[0].out = out;
  segs.s[0].bias = nullptr;
  segs.s[0].n = D;
  segs.s[0].col = 0;
  store_epilogue_kernel<T><<<epilogue_blocks(bc * D), 256, 0, stream>>>(
      segs, partial2, ksplit_of(F, k_chunk2), bc, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Activations, outputs, biases and dense weights of one dtype: bf16, or
// fp32 when fp32 != 0.  Per segment i: w[i] (codes or dense), scales[i]
// (null if dense), n[i] outputs, bits[i] (0 = dense), group[i], bias[i]
// (null = none), out[i] (bc, n[i]).  partial: fp32 scratch of
// ceil(K / k_chunk) * bc * sum(n) floats.
int rt_fused_qkv(const void* h, int bc, int K, int nseg, const void* const* w,
                 const float* const* scales, const int* n, const int* bits,
                 const int* group, const void* const* bias, void* const* out,
                 float* partial, int k_chunk, int fp32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return fused_qkv_impl<float>(h, bc, K, nseg, w, scales, n, bits, group, bias, out,
                                 partial, k_chunk, s);
  return fused_qkv_impl<bf16>(h, bc, K, nseg, w, scales, n, bits, group, bias, out,
                              partial, k_chunk, s);
}

// w/scales/bits/group: [up, gate, down] (gate ignored unless gated).
// act: 0 silu, 1 gelu (tanh), 2 relu, 3 squared relu.  mid: (bc, F)
// scratch of the activations' dtype (bf16, or fp32 when fp32 != 0);
// partial1: ceil(D/k_chunk1)*bc*(gated ? 2F : F) floats; partial2:
// ceil(F/k_chunk2)*bc*D floats.
int rt_fused_mlp(const void* h, int bc, int D, int F, int gated, int act,
                 const void* const* w, const float* const* scales,
                 const int* bits, const int* group, void* mid, void* out,
                 float* partial1, int k_chunk1, float* partial2, int k_chunk2,
                 int fp32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return fused_mlp_impl<float>(h, bc, D, F, gated, act, w, scales, bits, group, mid,
                                 out, partial1, k_chunk1, partial2, k_chunk2, s);
  return fused_mlp_impl<bf16>(h, bc, D, F, gated, act, w, scales, bits, group, mid,
                              out, partial1, k_chunk1, partial2, k_chunk2, s);
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

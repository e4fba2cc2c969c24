// Packed-weight (W2/W4/W8, A16) GEMM for Hopper (sm_90a).
//
// The counterpart of the reference's Pallas kernel dequant_gemm_pallas
// (src/repro/kernels/dequant_gemm/kernel.py:84): y = act(x W + b) with W
// stored as int32 words of 32/BITS two's-complement codes (field j at bit
// j*BITS) plus one fp32 scale per group of `group` consecutive codes.
//
// What it computes.  y[m, n] = act(sum_k x[m, k] * W[k, n] + b[n]) with
// an fp32 accumulator, the bias added and the activation applied in fp32
// (relu, silu, tanh-gelu, squared relu), one rounding to x's dtype.  The
// weight is dequantized tile by tile in shared memory with the cast chain
// of `dequantize`: code -> fp32, x scale in fp32, round to x's dtype
// (__float2bfloat16_rn for bf16, nothing for fp32), so the W it multiplies
// is bit-identical to dequantize(qt) and no dense weight ever reaches
// device memory.  The packed operand comes in two layouts:
//   "nk" (the Pallas kernel's): codes (N, ldw), scales (N, lds), packed and
//        grouped along K: W[k, n] = field(codes[n, k / pw], k % pw) *
//        scales[n, k / group];
//   "kn" (the model's): codes (K, ldw), scales (K, lds), packed along the
//        output axis, which is N1 segments of n2 outputs, each padded to
//        n2p (a multiple of max(group, pw)): output n reads word
//        (n / n2) * (n2p / pw) + (n % n2) / pw and scale (n / n2) *
//        (n2p / group) + (n % n2) / group of row k.  With N1 = 1 that is
//        one padded row (w_up, in_proj, wo); q/k/v have N1 = heads, n2 = hd.
// Any M, N and K; group a multiple of pw; the logical N (or K) is read
// and nothing past it is written.
//
// What bounds it on an H100.  At prefill widths (M = 1024-4096 rows, K
// and N in the thousands) the function is bound by operations: 2 M N K
// flop against 989 TFLOP/s dense bf16 (67 TFLOP/s fp32 FFMA for fp32
// activations); it needs to move only the packed weight (half a byte a
// q4 code), x and y once.  A kernel built on mma.sync has two costs the
// function does not: the unpack (ALU work, once per weight element per
// row tile) and the fragment traffic through shared memory.
//
// What the design does about it.  One block of 16 warps owns a 256 x 128
// output tile, so each unpacked weight tile serves 256 rows of x (half
// the unpack's instructions per product of a 128-row tile), and walks K
// in steps of 64 (bf16) or 32 (fp32).  The x tile (16-byte cp.async when
// x's rows are 16-byte aligned), the packed words and the scales (4-byte
// cp.async: scale rows such as Mamba-2's 266 fp32 are not 16-byte
// aligned) stream through a ring of three stages, the next step's loads
// in flight under this step's work.  Each step's words are unpacked into
// a W tile [n][k] of x's dtype, double buffered, so one barrier a step
// separates the products of step s (tensor pipe) from the unpack of step
// s + 1 (ALU), which the warps then overlap.  The unpack has no integer
// conversion: a field u (sign bit flipped) placed under the exponent of
// 2^23 is the float 2^23 + u exactly, and one subtraction gives the code;
// a thread unpacks one word of two adjacent k rows and stores bf16 pairs.
// bf16 runs mma.sync m16n8k16 (fp32 accumulate; each warp 64 x 32
// outputs, fragments by ldmatrix); fp32 runs SIMT FFMA in full fp32 (each
// thread 8 x 8 outputs; TF32 would lose the digits fp32 configs are
// checked to).  The layout is a template parameter of one kernel: only
// the loader and the unpack differ.  Left without its unpack or without
// its products (scripts/dequant_gemm_ablation.py, PERF.md) it keeps most
// of its time: what the two share, the loads and the shared-memory
// traffic of the x tile, the W tile and their fragments, bounds it.
// wgmma (the tensor core reads its operands from shared memory once per
// warpgroup), TMA and a persistent schedule are the next step.
//
// Interface: one plain C entry point (loaded with ctypes); it launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 256;                // output rows per block: each unpacked tile serves 256
constexpr int kBN = 128;                // output columns per block
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;              // x / packed-word ring
constexpr int kNK = 0, kKN = 1;         // layouts of the packed operand

using bf16 = __nv_bfloat16;

template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int kBK = 64;        // K per step
  static constexpr int kXStride = 72;   // padded rows: fragment loads hit 32 banks
  static constexpr int kWStride = 72;
};
template <> struct Tile<float> {
  static constexpr int kBK = 32;
  static constexpr int kXStride = 36;   // 16-byte rows for cp.async
  static constexpr int kWStride = 33;   // odd: column reads hit distinct banks
};

struct Params {
  const void* x;            // (M, K) row-major, T
  const int32_t* codes;     // nk: (N, ldw); kn: (K, ldw)
  const float* scales;      // nk: (N, lds); kn: (K, lds)
  const float* bias;        // (N,) or null
  void* y;                  // (M, N) row-major, T
  int M, N, K;
  int ldw, lds;             // words / scales per row of codes / scales
  int group;
  int n2, n2p;              // kn: outputs of a segment and its padded length
  int ps_stride, ss_stride; // shared words per staged packed / scale row
  int act;                  // 0 none, 1 relu, 2 silu, 3 gelu (tanh), 4 squared relu
  int x_vec;                // x's rows are 16-byte aligned
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8m..8m+7 give matrix m's row addresses
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// code j of a word as an exact float: the field (a logical shift of the
// unsigned word: the top field holds bit 31) with its sign bit flipped is
// u = code + 2^(BITS-1); as the low mantissa bits of 2^23 it is the float
// 2^23 + u, and subtracting 2^23 + 2^(BITS-1) leaves the code
template <int BITS>
__device__ __forceinline__ float code(uint32_t word, int j) {
  constexpr uint32_t kMask = (1u << BITS) - 1u, kSign = 1u << (BITS - 1);
  const uint32_t u = ((word >> (j * BITS)) & kMask) ^ (kSign | 0x4B000000u);
  return __uint_as_float(u) - (8388608.f + static_cast<float>(kSign));
}

// two adjacent values of a row of the W tile (dst 4-byte aligned for bf16)
__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  dst[0] = a;
  dst[1] = b;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);
    case 2: return v / (1.f + expf(-v));
    case 3: {
      const float c = 0.7978845608028654f;     // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case 4: {
      const float r = fmaxf(v, 0.f);
      return r * r;
    }
    default: return v;
  }
}

__device__ __forceinline__ float epilogue(const Params& p, float acc, int n) {
  if (p.bias) acc += p.bias[n];
  return activate(acc, p.act);
}

// kn: the word and the scale column of output n in a row of the packed operand
template <int PW>
__device__ __forceinline__ int kn_word(const Params& p, int n) {
  const int s = n / p.n2;
  return s * (p.n2p / PW) + (n - s * p.n2) / PW;
}
__device__ __forceinline__ int kn_scale(const Params& p, int n) {
  const int s = n / p.n2;
  return s * (p.n2p / p.group) + (n - s * p.n2) / p.group;
}

// x rows m0.. and columns k0.. of one step into a padded tile; what lies
// outside (M, K) is zero
template <typename T>
__device__ __forceinline__ void load_x(T* xs, const Params& p, int m0, int k0) {
  constexpr int kBK = Tile<T>::kBK, kXS = Tile<T>::kXStride;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kBK / kVec;
  const T* x = static_cast<const T*>(p.x);
  for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * kVec;
    const int m = m0 + r, k = k0 + c;
    T* dst = xs + r * kXS + c;
    const T* src = x + (size_t)m * p.K + k;
    if (m >= p.M || k >= p.K) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (p.x_vec) {                // K % kVec == 0: the chunk is whole
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[j] = k + j < p.K ? src[j] : from_f<T>(0.f);
    }
  }
}

// the packed words and scales one step reads into shared memory (zeros
// outside the operand)
template <typename T, int PW, int LAYOUT>
__device__ __forceinline__ void load_packed(int32_t* ps, float* ss, const Params& p, int n0,
                                            int k0, int w_lo, int nw, int s_lo, int ns) {
  constexpr int kBK = Tile<T>::kBK;
  if (LAYOUT == kKN) {                   // kLanes threads a staged row
    constexpr int kLanes = kThreads / kBK;
    const int r = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
    int32_t* prow = ps + r * p.ps_stride;
    float* srow = ss + r * p.ss_stride;
    if (k0 + r < p.K) {
      const int32_t* wsrc = p.codes + (size_t)(k0 + r) * p.ldw + w_lo;
      const float* ssrc = p.scales + (size_t)(k0 + r) * p.lds + s_lo;
      for (int c = sub; c < nw; c += kLanes) cp_async4(prow + c, wsrc + c);
      for (int c = sub; c < ns; c += kLanes) cp_async4(srow + c, ssrc + c);
    } else {
      for (int c = sub; c < nw; c += kLanes) prow[c] = 0;
      for (int c = sub; c < ns; c += kLanes) srow[c] = 0.f;
    }
  } else {
    constexpr int kWpr = kBK / PW;       // words of a row in one step
    const int kw0 = k0 / PW;
    for (int i = threadIdx.x; i < kBN * kWpr; i += kThreads) {
      const int r = i / kWpr, c = i - r * kWpr;
      int32_t* dst = ps + r * kWpr + c;
      if (n0 + r < p.N && kw0 + c < p.ldw) cp_async4(dst, p.codes + (size_t)(n0 + r) * p.ldw + kw0 + c);
      else *dst = 0;
    }
    const int sc0 = k0 / p.group;
    for (int i = threadIdx.x; i < kBN * p.ss_stride; i += kThreads) {
      const int r = i / p.ss_stride, c = i - r * p.ss_stride;
      float* dst = ss + r * p.ss_stride + c;
      if (n0 + r < p.N && sc0 + c < p.lds) cp_async4(dst, p.scales + (size_t)(n0 + r) * p.lds + sc0 + c);
      else *dst = 0.f;
    }
  }
}

// kn: per staged word column c of this tile, the tile column of its first
// code, its scale column among the staged ones and how many of its codes
// are outputs (the rest pad the segment)
struct WordMap {
  int* col;
  int* scale;
  int* valid;
};

// the staged words -> the W tile [n][k] in T, `dequantize`'s cast chain
// (code -> fp32, x scale in fp32, round to T)
template <typename T, int BITS, int LAYOUT>
__device__ __forceinline__ void unpack(T* ws, const int32_t* ps, const float* ss,
                                       const Params& p, const WordMap& map, int k0, int nw) {
  constexpr int kBK = Tile<T>::kBK, kWS = Tile<T>::kWStride;
  constexpr int PW = 32 / BITS;
  if (LAYOUT == kKN) {
    constexpr int kPairs = kBK / 2;
    for (int i = threadIdx.x; i < kPairs * nw; i += kThreads) {
      const int k = 2 * (i % kPairs), c = i / kPairs;   // lanes on consecutive k pairs
      const uint32_t w0 = static_cast<uint32_t>(ps[k * p.ps_stride + c]);
      const uint32_t w1 = static_cast<uint32_t>(ps[(k + 1) * p.ps_stride + c]);
      const float s0 = ss[k * p.ss_stride + map.scale[c]];
      const float s1 = ss[(k + 1) * p.ss_stride + map.scale[c]];
      const int col0 = map.col[c], valid = map.valid[c];
      T* dst = ws + k;
      if (col0 >= 0 && col0 + PW <= kBN && valid == PW) {
#pragma unroll
        for (int j = 0; j < PW; ++j)
          store_pair(dst + (col0 + j) * kWS, code<BITS>(w0, j) * s0, code<BITS>(w1, j) * s1);
      } else {                          // a tile edge inside the word, or segment padding
#pragma unroll
        for (int j = 0; j < PW; ++j)
          if (j < valid && col0 + j >= 0 && col0 + j < kBN)
            store_pair(dst + (col0 + j) * kWS, code<BITS>(w0, j) * s0,
                       code<BITS>(w1, j) * s1);
      }
    }
  } else {
    constexpr int kWpr = kBK / PW;
    const int sc0 = k0 / p.group;
    for (int i = threadIdx.x; i < kBN * kWpr; i += kThreads) {
      const int r = i / kWpr, c = i - r * kWpr;
      const uint32_t word = static_cast<uint32_t>(ps[r * kWpr + c]);
      const float sc = ss[r * p.ss_stride + (k0 + c * PW) / p.group - sc0];
      T* dst = ws + r * kWS + c * PW;
#pragma unroll
      for (int j = 0; j < PW; j += 2)
        store_pair(dst + j, code<BITS>(word, j) * sc, code<BITS>(word, j + 1) * sc);
    }
  }
}

template <typename T>
__host__ __device__ constexpr int packed_rows(int layout) {
  return layout == kKN ? Tile<T>::kBK : kBN;
}

// x ring, two W tiles, the packed-word and scale ring, the word map
template <typename T>
size_t smem_bytes(int layout, int ps_stride, int ss_stride) {
  return (kStages * kBM * Tile<T>::kXStride + 2 * kBN * Tile<T>::kWStride) * sizeof(T) +
         (kStages * (size_t)packed_rows<T>(layout) * (ps_stride + ss_stride) + 3 * ps_stride) * 4;
}

template <typename T, int BITS, int LAYOUT>
__global__ void __launch_bounds__(kThreads) dequant_gemm_kernel(const Params p) {
  constexpr int kBK = Tile<T>::kBK, kXS = Tile<T>::kXStride, kWS = Tile<T>::kWStride;
  constexpr int PW = 32 / BITS;
  constexpr bool kMma = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);                          // kStages buffers
  T* ws = xs + kStages * kBM * kXS;                                 // two buffers
  int32_t* ps = reinterpret_cast<int32_t*>(ws + 2 * kBN * kWS);    // kStages buffers
  const int p_words = packed_rows<T>(LAYOUT) * p.ps_stride;
  float* ss = reinterpret_cast<float*>(ps + kStages * p_words);    // kStages buffers
  const int s_words = packed_rows<T>(LAYOUT) * p.ss_stride;
  int* map_base = reinterpret_cast<int*>(ss + kStages * s_words);
  const WordMap map{map_base, map_base + p.ps_stride, map_base + 2 * p.ps_stride};

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  int w_lo = 0, nw = 0, s_lo = 0, ns = 0;
  if (LAYOUT == kKN) {                  // the words and scales this tile's outputs read
    const int n_last = min(n0 + kBN, p.N) - 1;
    w_lo = kn_word<PW>(p, n0);
    nw = kn_word<PW>(p, n_last) - w_lo + 1;
    s_lo = kn_scale(p, n0);
    ns = kn_scale(p, n_last) - s_lo + 1;
    const int wps = p.n2p / PW, sps = p.n2p / p.group;
    for (int c = threadIdx.x; c < nw; c += kThreads) {
      const int w = w_lo + c, seg = w / wps;
      const int j0 = (w - seg * wps) * PW;         // first code of the word in its segment
      map.col[c] = seg * p.n2 + j0 - n0;
      map.scale[c] = seg * sps + j0 / p.group - s_lo;
      map.valid[c] = min(PW, p.n2 - j0);
    }
  }
  const int n_steps = (p.K + kBK - 1) / kBK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;           // mma: 4 x 4 warps of 64 x 32
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;   // FFMA: rows tm + 32 i, cols tn + 16 j
  // mma: acc[(mi * 4 + ni) * 4 + c], the fragment of 16 x 8 tile (mi, ni);
  // FFMA: acc[i * 8 + j], output (tm + 32 i, tn + 16 j)
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto load_stage = [&](int step) {
    const int b = step % kStages, k0 = step * kBK;
    load_x<T>(xs + b * kBM * kXS, p, m0, k0);
    load_packed<T, PW, LAYOUT>(ps + b * p_words, ss + b * s_words, p, n0, k0, w_lo, nw, s_lo, ns);
  };
  // steps 0 and 1 in flight; step 0 unpacked before the loop
  load_stage(0);
  cp_async_commit();
  if (n_steps > 1) load_stage(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  unpack<T, BITS, LAYOUT>(ws, ps, ss, p, map, 0, nw);
  for (int step = 0; step < n_steps; ++step) {
    // step + 1's words landed and step's W tile written, by every thread;
    // every warp is done with step - 1's buffers, which step + 2 refills
    cp_async_wait<0>();
    __syncthreads();
    if (step + 2 < n_steps) load_stage(step + 2);
    cp_async_commit();
    const T* xt = xs + (step % kStages) * kBM * kXS;
    const T* wt = ws + (step & 1) * kBN * kWS;
    if constexpr (kMma) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(a[mi], xt + (wm * 64 + mi * 16 + (lane & 15)) * kXS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(r, wt + (wn * 32 + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * kWS + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(&acc[(mi * 4 + ni) * 4], a[mi], b[ni][0], b[ni][1]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = xt[(tm + 32 * i) * kXS + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = wt[(tn + 16 * j) * kWS + k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
      }
    }
    if (step + 1 < n_steps)             // the ALU work beside the other warps' products
      unpack<T, BITS, LAYOUT>(ws + ((step + 1) & 1) * kBN * kWS,
                              ps + ((step + 1) % kStages) * p_words,
                              ss + ((step + 1) % kStages) * s_words, p, map, (step + 1) * kBK, nw);
  }

  T* y = static_cast<T*>(p.y);
  if constexpr (kMma) {
    const bool pairs = (p.N & 1) == 0;  // a pair at an even column is 4-byte aligned
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
          const int n = n0 + wn * 32 + ni * 8 + 2 * t;
          if (m >= p.M || n >= p.N) continue;
          bf16* dst = reinterpret_cast<bf16*>(y) + (size_t)m * p.N + n;
          const float v0 = epilogue(p, acc[(mi * 4 + ni) * 4 + 2 * h], n);
          if (n + 1 < p.N) {
            const float v1 = epilogue(p, acc[(mi * 4 + ni) * 4 + 2 * h + 1], n + 1);
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
            } else {
              dst[0] = __float2bfloat16_rn(v0);
              dst[1] = __float2bfloat16_rn(v1);
            }
          } else {
            dst[0] = __float2bfloat16_rn(v0);
          }
        }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + tm + 32 * i;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tn + 16 * j;
        if (n < p.N) y[(size_t)m * p.N + n] = from_f<T>(epilogue(p, acc[i * 8 + j], n));
      }
    }
  }
}

template <typename T, int BITS, int LAYOUT>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(LAYOUT, p.ps_stride, p.ss_stride);
  cudaError_t e = cudaFuncSetAttribute(dequant_gemm_kernel<T, BITS, LAYOUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  dequant_gemm_kernel<T, BITS, LAYOUT><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int LAYOUT>
int by_bits(const Params& p, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<T, 2, LAYOUT>(p, stream);
    case 4: return launch<T, 4, LAYOUT>(p, stream);
    case 8: return launch<T, 8, LAYOUT>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_layout(Params p, int bits, int layout, int span_w, int span_s, cudaStream_t stream) {
  const int pw = 32 / bits;
  if (layout == kKN) {
    p.ps_stride = span_w | 1;           // odd: the unpack's column reads hit distinct banks
    p.ss_stride = span_s | 1;
  } else {
    p.ps_stride = Tile<T>::kBK / pw;
    p.ss_stride = Tile<T>::kBK / pw + 1;   // scale columns one step can touch (group >= pw)
  }
  if (smem_bytes<T>(layout, p.ps_stride, p.ss_stride) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  return layout == kKN ? by_bits<T, kKN>(p, bits, stream) : by_bits<T, kNK>(p, bits, stream);
}

}  // namespace

extern "C" {

// x (M, K) and y (M, N) row-major in bf16 (dtype 0) or fp32 (dtype 1);
// codes int32 and scales fp32, row-major with ldw / lds per row: (N, .)
// for layout 0 ("nk"), (K, .) for layout 1 ("kn", with segments n2 padded
// to n2p; span_w / span_s bound the words and scale columns one 128-column
// tile reads).  bias (N,) fp32 or null; act 0-4 (none, relu, silu, gelu,
// squared relu); x_vec: x 16-byte aligned with 16-byte rows.
int rt_dequant_gemm(const void* x, const void* codes, const void* scales, const void* bias,
                    void* y, int M, int N, int K, int bits, int group, int layout, int dtype,
                    int ldw, int lds, int n2, int n2p, int span_w, int span_s, int act,
                    int x_vec, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (bits != 2 && bits != 4 && bits != 8) || group < 1 ||
      group % (32 / bits) != 0 || act < 0 || act > 4 || (layout != kNK && layout != kKN) ||
      (layout == kKN && (n2 < 1 || n2p < n2 || n2p % group || N % n2 || span_w < 1 ||
                         span_s < 1)) ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const int32_t*>(codes), static_cast<const float*>(scales),
           static_cast<const float*>(bias), y, M, N, K, ldw, lds, group, n2, n2p, 0, 0, act,
           x_vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_layout<bf16>(p, bits, layout, span_w, span_s, s);
    case 1: return by_layout<float>(p, bits, layout, span_w, span_s, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

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
// What the design does about it.  Two kernels.
//
// bf16, warp-specialised on wgmma (dequant_gemm_wgmma_kernel): one block
// of three warpgroups owns a 256 x 128 output tile, so each unpacked W
// tile serves 256 rows of x, and walks K in steps of 64 through a ring of
// four stages.  Warpgroups 0 and 1 consume: each runs wgmma m64n128k16 on
// its two 64-row halves of the stage's x tile (K-major, 128-byte swizzle,
// TMA-loaded) against the stage's W tile, keeps two 64 x 128 fp32
// accumulators in registers, and releases a stage once the products that
// read it have retired.  Warpgroup 2 produces (setmaxnreg moves registers
// from it to the consumers at run time; ptxas compiles every warpgroup to
// the launch bound's 168): one thread TMA-loads each stage's x tile and,
// kPre - 1 steps ahead, the step's packed words into a staging slot; the
// 128 threads copy the tile rows' distinct scales into the slot by 4-byte
// cp.async (scale rows such as Mamba-2's 266 fp32 are not 16-byte aligned
// for TMA), neighbouring threads on neighbouring addresses; then each
// thread unpacks one run of 64 codes (one k row of 64 n in "kn", one n row
// of 64 k in "nk") into the bf16 W tile in the swizzled layout wgmma
// reads, with `dequantize`'s cast chain (the 2^23 + u float trick below),
// one 16-byte store per 8 codes, and publishes it (async-proxy fence,
// arrival on the stage's barrier).  The unpack so runs on other warps than
// the products, and the tensor core reads each operand from shared memory
// once per warpgroup; the unpack's ALU work on four warps is what bounds
// the kernel (scripts/dequant_gemm_ablation.py, PERF.md).  The model's layout ("kn": a word is 8 consecutive n of one
// k) fills an MN-major W tile (the transpose bit); the Pallas layout
// ("nk": 8 consecutive k of one n) a K-major one.  Epilogue: bias and
// activation in fp32, one rounding, rows and columns past (M, N) skipped.
// It takes a bf16 call when (`route` in the launcher checks the same
// before launch): x is 16-byte aligned with K % 8 == 0 (TMA's row stride),
// the group is 16, 32, 64 or a multiple of 128 (a tile row's scales
// then start at its first column, at most 8 of them), the codes are 16-byte aligned with
// 16-byte rows, and for "kn" the segments carry no padding (n2p == n2)
// and N % 64 == 0.  Every served projection is such a call.
//
// The tile kernel (dequant_gemm_kernel: fp32 always, bf16 calls outside
// the rule above): one block of 16 warps owns a 256 x 128 output tile, so
// each unpacked weight tile serves 256 rows of x, and walks K in steps of
// 64 (bf16) or 32 (fp32).  The x tile (16-byte cp.async when x's rows are
// 16-byte aligned), the packed words and the scales (4-byte cp.async:
// scale rows such as Mamba-2's 266 fp32 are not 16-byte aligned) stream
// through a ring of three stages, the next step's loads in flight under
// this step's work.  Each step's words are unpacked into a W tile [n][k] of
// x's dtype, double buffered, so one barrier a step separates the products
// of step s (tensor pipe) from the unpack of step s + 1 (ALU), which the
// warps then overlap.  The unpack has no integer conversion: a field u
// (sign bit flipped) placed under the exponent of 2^23 is the float 2^23 +
// u exactly, and one subtraction gives the code; a thread unpacks one word
// of two adjacent k rows and stores bf16 pairs.  bf16 runs mma.sync
// m16n8k16 (fp32 accumulate; each warp 64 x 32 outputs, fragments by
// ldmatrix); fp32 runs SIMT FFMA in full fp32 (each thread 8 x 8 outputs;
// TF32 would lose the digits fp32 configs are checked to).  Left without
// its unpack or without its products it keeps most of its time: the
// loads and the shared-memory traffic of the x tile, the W tile and their
// fragments bound it (PERF.md).
//
// Interface: two plain C entry points (loaded with ctypes), one a kernel;
// each launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or the error of encoding a tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

using hopper::code;

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
          hopper::ldmatrix_x4(a[mi], xt + (wm * 64 + mi * 16 + (lane & 15)) * kXS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t r[4];
          hopper::ldmatrix_x4(r, wt + (wn * 32 + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * kWS + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) hopper::mma_bf16(&acc[(mi * 4 + ni) * 4], a[mi], b[ni][0], b[ni][1]);
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

// ---- bf16: wgmma, TMA, warp specialisation ---------------------------------

constexpr int kWM = 256, kWN = 128, kWK = 64;   // output tile, K step
constexpr int kWStages = 4;                     // x / W tile ring
constexpr int kPre = 3;                         // staged steps: kPre - 2 of slack
constexpr int kWThreads = 384;                  // warpgroups 0-1 consume, 2 produces
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kXTileBytes = kWM * kWK * 2;      // 32 KB
constexpr int kWTileBytes = kWN * kWK * 2;      // 16 KB
constexpr int kStageBar = 1;                    // the producer warpgroup's named barrier

// One step's packed words and scales, staged by the producer warpgroup:
// "kn" 64 k rows of 128 n, "nk" 128 n rows of 64 k.  The words arrive by
// TMA as [row][words]; each row's distinct scales follow (the rule on the
// group makes a row's scales start at the tile's first column and their
// count a power of two), in rows padded to an odd pitch so that the
// unpack's reads (a thread a row) hit distinct banks.
template <int BITS, int LAYOUT>
struct Staged {
  static constexpr int kRows = LAYOUT == kKN ? kWK : kWN;
  static constexpr int kCols = LAYOUT == kKN ? kWN : kWK;           // codes a row
  static constexpr int kRowWords = kCols * BITS / 32;
  static constexpr int kWordBytes = kRows * kRowWords * 4;
  static constexpr int kSPitch = kCols / 16 + 1;                    // floats, odd
  static constexpr int kBytes = kWordBytes + ((kRows * kSPitch * 4 + 127) & ~127);
};

template <int BITS, int LAYOUT>
constexpr int wgmma_smem() {
  return 1024 + kWStages * (kXTileBytes + kWTileBytes) + kPre * Staged<BITS, LAYOUT>::kBytes +
         24 * kWStages + 8 * kPre;
}

// two fp32 values -> a bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct WParams {
  const int32_t* codes;     // nk: (N, ldw); kn: (K, ldw)
  const float* scales;      // nk: (N, lds); kn: (K, lds)
  const float* bias;        // (N,) or null
  bf16* y;                  // (M, N) row-major
  int M, N, K, ldw, lds, group, act;
};

// The scales a tile row reads: log2 of their count (the row's codes over
// the group, at least one) and, for chunk r of producer thread pt's run,
// its scale's slot among them.
template <int LAYOUT>
__device__ __forceinline__ int scale_shift(int group) {
  constexpr int kCols = LAYOUT == kKN ? kWN : kWK;
  return group >= kCols ? 0 : 31 - __clz(kCols / group);
}
template <int LAYOUT>
__device__ __forceinline__ int scale_slot(int group, int pt, int r) {
  constexpr int kCols = LAYOUT == kKN ? kWN : kWK;
  const int c = (LAYOUT == kKN ? 64 * (pt / 64) : 0) + 8 * r;   // code of the row
  return group >= kCols ? 0 : c / group;
}

// producer thread pt's share of staging the rows' distinct scales (1 <<
// sshift a row) of the step at k0 into `slot` by 4-byte cp.async (scale
// rows such as Mamba-2's 266 fp32 are not 16-byte aligned for TMA),
// neighbouring threads on neighbouring addresses; zeros outside the weight
template <int BITS, int LAYOUT>
__device__ __forceinline__ void stage_scales(unsigned char* slot, const WParams& p, int n0,
                                             int k0, int pt, int sshift) {
  using S = Staged<BITS, LAYOUT>;
  const int r0 = LAYOUT == kKN ? k0 : n0;
  const int rows = LAYOUT == kKN ? p.K : p.N;
  const int first = (LAYOUT == kKN ? n0 : k0) / p.group;
  float* sdst = reinterpret_cast<float*>(slot + S::kWordBytes);
  for (int i = pt; i < S::kRows << sshift; i += 128) {
    const int row = i >> sshift, c = i & ((1 << sshift) - 1);
    const bool ok = r0 + row < rows && first + c < p.lds;
    hopper::cp_async4_zfill(sdst + row * S::kSPitch + c,
                              p.scales + (ok ? (size_t)(r0 + row) * p.lds + first + c : 0), ok);
  }
}

// producer thread pt's run of the staged step: 64 consecutive codes of one
// row ("kn": k row pt % 64, n half pt / 64; "nk": n row pt) -> 8 chunks of
// the W tile, each 8 values of `dequantize`'s cast chain in one 16-byte
// store: "kn" MN-major [k 64][n 128] in two 64-column atoms 8 KB apart,
// "nk" K-major [n 128][k 64]; both 128-byte swizzled.  sslot: each chunk's
// scale among its row's.
template <int BITS, int LAYOUT>
__device__ __forceinline__ void unpack_run(unsigned char* wt, const unsigned char* slot, int pt,
                                           const int (&sslot)[8]) {
  using S = Staged<BITS, LAYOUT>;
  constexpr int PW = 32 / BITS, kVecs = BITS / 2;     // 16-byte word vectors of a run
  const int row = LAYOUT == kKN ? pt % 64 : pt, half = LAYOUT == kKN ? pt / 64 : 0;
  uint32_t w[4 * kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const uint4 x = *reinterpret_cast<const uint4*>(slot + row * S::kRowWords * 4 +
                                                    (half * kVecs + v) * 16);
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }
  const float* srow = reinterpret_cast<const float*>(slot + S::kWordBytes) + row * S::kSPitch;
  const int base = LAYOUT == kKN ? half * (kWK * 128) + row * 128 : row * 128;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float sc = srow[sslot[r]];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 8 * r + j;          // code i of the run: word i / PW, field i % PW
      v[j] = code<BITS>(w[i / PW], i % PW) * sc;
    }
    uint4 out;
    out.x = pack_bf16(v[0], v[1]);
    out.y = pack_bf16(v[2], v[3]);
    out.z = pack_bf16(v[4], v[5]);
    out.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(wt + base + ((r ^ (row & 7)) << 4)) = out;
  }
}

// one m64n128 accumulator (this thread's rows m, m + 8 and columns n +
// 8 c, + 1) through the epilogue into y: bias and activation in fp32, one
// rounding; rows and columns past (M, N) are skipped
__device__ __forceinline__ void store_rows(const WParams& p, const float (&acc)[64], int m,
                                           int n) {
  const bool pairs = (p.N & 1) == 0;    // a pair at an even column is 4-byte aligned
#pragma unroll
  for (int c = 0; c < kWN / 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int mr = m + 8 * hh, nc = n + 8 * c;
      if (mr >= p.M || nc >= p.N) continue;
      bf16* dst = p.y + (size_t)mr * p.N + nc;
      float v0 = acc[4 * c + 2 * hh];
      if (p.bias) v0 += p.bias[nc];
      v0 = activate(v0, p.act);
      if (nc + 1 < p.N) {
        float v1 = acc[4 * c + 2 * hh + 1];
        if (p.bias) v1 += p.bias[nc + 1];
        v1 = activate(v1, p.act);
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
}

template <int BITS, int LAYOUT>
__global__ void __launch_bounds__(kWThreads, 1)
    dequant_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                              const __grid_constant__ CUtensorMap tw, const WParams p) {
  using S = Staged<BITS, LAYOUT>;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* smem = hopper::align1024(smem_tiles);
  unsigned char* xs = smem;                                // [stage][256 rows][64 k]
  unsigned char* ws = xs + kWStages * kXTileBytes;         // [stage] W tile
  unsigned char* staged = ws + kWStages * kWTileBytes;     // [kPre] staged steps
  uint64_t* x_full = reinterpret_cast<uint64_t*>(staged + kPre * S::kBytes);
  uint64_t* w_full = x_full + kWStages;                    // the stage's W tile unpacked
  uint64_t* empty = w_full + kWStages;                     // the stage's products retired
  uint64_t* words = empty + kWStages;                      // [kPre] a slot's words landed

  const int n0 = blockIdx.x * kWN, m0 = blockIdx.y * kWM;
  const int n_steps = (p.K + kWK - 1) / kWK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&x_full[s], 1);
      hopper::mbar_init(&w_full[s], 128);     // the unpacking threads
      hopper::mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    for (int s = 0; s < kPre; ++s) hopper::mbar_init(&words[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread TMA-loads each step's x tile and the packed
    // words kPre - 1 steps ahead; every thread stages its share of the
    // scales (cp.async) kPre - 1 steps ahead and unpacks one run of each
    // step's words into the W tile ----------------------------------------
    hopper::reg_dealloc<kProducerRegs>();
    const int pt = threadIdx.x - 256;
    const int sshift = scale_shift<LAYOUT>(p.group);
    int sslot[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) sslot[r] = scale_slot<LAYOUT>(p.group, pt, r);
    auto load_x = [&](int s) {          // from thread 0, the stage being free
      const int st = s % kWStages;
      hopper::mbar_arrive_expect_tx(&x_full[st], kXTileBytes);
      hopper::tma_load_2d(xs + st * kXTileBytes, &tx, &x_full[st], s * kWK, m0);
    };
    auto stage = [&](int s) {           // step s into its slot (free: see below)
      const int slot = s % kPre, k0 = s * kWK;
      if (pt == 0) {
        hopper::mbar_arrive_expect_tx(&words[slot], S::kWordBytes);
        hopper::tma_load_2d(staged + slot * S::kBytes, &tw, &words[slot],
                            (LAYOUT == kKN ? n0 : k0) / (32 / BITS), LAYOUT == kKN ? k0 : n0);
      }
      stage_scales<BITS, LAYOUT>(staged + slot * S::kBytes, p, n0, k0, pt, sshift);
    };
#pragma unroll 1
    for (int s = 0; s < kPre - 1; ++s) {
      if (s < n_steps) stage(s);
      hopper::cp_async_commit();
    }
#pragma unroll 1
    for (int step = 0; step < n_steps; ++step) {
      const int st = step % kWStages, use = step / kWStages, slot = step % kPre;
      hopper::cp_async_wait<kPre - 2>();       // this thread's scales of `step` landed
      // every thread's scales of `step` landed, and every thread is done
      // with the slot of step - 1, which is staged below
      hopper::named_barrier_sync(kStageBar, 128);
      hopper::mbar_wait(&words[slot], (step / kPre) & 1);
      if (use > 0) hopper::mbar_wait(&empty[st], (use - 1) & 1);
      if (pt == 0) load_x(step);
      unpack_run<BITS, LAYOUT>(ws + st * kWTileBytes, staged + slot * S::kBytes, pt, sslot);
      hopper::fence_async_smem();
      hopper::mbar_arrive(&w_full[st]);
      // issued after the fence, so that the fence waits on no copy in flight
      if (step + kPre - 1 < n_steps) stage(step + kPre - 1);
      hopper::cp_async_commit();
    }
  } else {
    // ---- consumers: 128 rows x 128 columns each, two m64 halves ------------
    hopper::reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, q4 = lane & 3;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int step = 0; step < n_steps; ++step) {
      const int st = step % kWStages;
      hopper::mbar_wait(&x_full[st], (step / kWStages) & 1);
      hopper::mbar_wait(&w_full[st], (step / kWStages) & 1);
      const uint32_t xa = hopper::smem_u32(xs + st * kXTileBytes) + wg * 128 * 128;
      const uint32_t wb = hopper::smem_u32(ws + st * kWTileBytes);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        const uint64_t da0 = hopper::make_desc(xa + kk * 32, 16, 1024, 128);
        const uint64_t da1 = hopper::make_desc(xa + 64 * 128 + kk * 32, 16, 1024, 128);
        if (LAYOUT == kKN) {
          const uint64_t db = hopper::make_desc(wb + kk * 16 * 128, kWK * 128, 1024, 128);
          hopper::wgmma_ss_n128<1>(acc0, da0, db);
          hopper::wgmma_ss_n128<1>(acc1, da1, db);
        } else {
          const uint64_t db = hopper::make_desc(wb + kk * 32, 16, 1024, 128);
          hopper::wgmma_ss_n128<0>(acc0, da0, db);
          hopper::wgmma_ss_n128<0>(acc1, da1, db);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();          // the stage is free for the producer
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
    hopper::fence_regs(acc0);
    hopper::fence_regs(acc1);

    store_rows(p, acc0, m0 + 128 * wg + 16 * warp + g, n0 + 2 * q4);
    store_rows(p, acc1, m0 + 128 * wg + 64 + 16 * warp + g, n0 + 2 * q4);
  }
}

template <int BITS, int LAYOUT>
int launch_wgmma(const void* x, const WParams& p, cudaStream_t stream) {
  CUtensorMap tx;
  const uint64_t dims[2] = {(uint64_t)p.K, (uint64_t)p.M};
  const uint64_t strides[1] = {(uint64_t)p.K * 2};
  const uint32_t box[2] = {kWK, kWM};
  int e = hopper_host::encode_bf16(&tx, x, 2, dims, strides, box, 128);
  if (e != 0) return e;
  CUtensorMap tw;                       // the packed words: (rows, ldw) int32
  using S = Staged<BITS, LAYOUT>;
  const uint64_t wdims[2] = {(uint64_t)p.ldw, (uint64_t)(LAYOUT == kKN ? p.K : p.N)};
  const uint64_t wstrides[1] = {(uint64_t)p.ldw * 4};
  const uint32_t wbox[2] = {(uint32_t)S::kRowWords, (uint32_t)S::kRows};
  e = hopper_host::encode(&tw, CU_TENSOR_MAP_DATA_TYPE_INT32, p.codes, 2, wdims, wstrides, wbox,
                          0);
  if (e != 0) return e;
  constexpr int smem = wgmma_smem<BITS, LAYOUT>();
  cudaError_t ce = cudaFuncSetAttribute(dequant_gemm_wgmma_kernel<BITS, LAYOUT>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((p.N + kWN - 1) / kWN, (p.M + kWM - 1) / kWM);
  dequant_gemm_wgmma_kernel<BITS, LAYOUT><<<grid, kWThreads, smem, stream>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int wgmma_by_bits(const void* x, const WParams& p, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch_wgmma<2, LAYOUT>(x, p, stream);
    case 4: return launch_wgmma<4, LAYOUT>(x, p, stream);
    case 8: return launch_wgmma<8, LAYOUT>(x, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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


// The warp-specialised bf16 kernel: x (M, K) and y (M, N) row-major bf16;
// codes int32 and scales fp32 as for rt_dequant_gemm, "kn" without segment
// padding (codes (K, N / pw), scales (K, N / group)).  Takes x 16-byte
// aligned with K % 8 == 0, codes 16-byte aligned with ldw % 4 == 0 (16-byte
// rows), a group of 16, 32, 64 or a multiple of 128, and for "kn"
// N % 64 == 0; anything else returns cudaErrorInvalidValue.
int rt_dequant_gemm_wgmma(const void* x, const void* codes, const void* scales, const void* bias,
                          void* y, int M, int N, int K, int bits, int group, int layout, int ldw,
                          int lds, int act, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 != 0 || (bits != 2 && bits != 4 && bits != 8) ||
      group < 16 || (128 % group != 0 && group % 128 != 0) ||
      group % (32 / bits) != 0 || act < 0 || act > 4 ||
      (layout != kNK && layout != kKN) || (layout == kKN && N % 64 != 0) || ldw % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      (M + kWM - 1) / kWM > 65535)
    return (int)cudaErrorInvalidValue;
  const WParams p{static_cast<const int32_t*>(codes), static_cast<const float*>(scales),
                  static_cast<const float*>(bias), static_cast<bf16*>(y), M, N, K, ldw, lds,
                  group, act};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layout == kKN ? wgmma_by_bits<kKN>(x, p, bits, s) : wgmma_by_bits<kNK>(x, p, bits, s);
}

}  // extern "C"

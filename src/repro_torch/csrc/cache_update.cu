// KV-cache row update for Hopper (sm_90a).
//
// The counterpart of the reference's Pallas kernel cache_row_update_pallas
// (src/repro/kernels/cache_update/kernel.py:31): the zero-copy write of one
// decode step's new K or V row into a donated cache.
//
// What it computes.  cache[b, index[b]] = row[b], cast to the cache's
// dtype, in place, for every row b whose index lies in [0, S); a row whose
// index is out of range writes nothing.  cache (B, S, KV, hd) and row
// (B, KV, hd) are read through their (b, s, kv) strides with the hd axis
// contiguous, so a layer slice of a stacked cache is written where it
// lies.  bf16 or fp32 cache, bf16 or fp32 row; a same-dtype write is a
// bit copy, a cast rounds to nearest even.
//
// What bounds it on an H100.  Bytes: each row is read once and written
// once, 2 * B * KV * hd elements (4 KB for a cohort-4 bf16 step at
// LLaVA-OneVision-0.5B's widths), under a nanosecond at 3.35 TB/s.  The
// launch itself (a few microseconds) is the whole cost.
//
// What the design does about it.  Nothing else of the cache moves (the
// reference's input_output_aliasing): one block per row b; where the row
// is contiguous in both tensors, of one dtype and 16-byte aligned, its
// threads copy 16-byte vectors, else one element each with the cast.
//
// Interface: one plain C entry point (loaded with ctypes); it launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename D, typename S> __device__ __forceinline__ D cast_to(S x);
template <> __device__ __forceinline__ bf16 cast_to<bf16, bf16>(bf16 x) { return x; }
template <> __device__ __forceinline__ float cast_to<float, float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 cast_to<bf16, float>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float cast_to<float, bf16>(bf16 x) {
  return __bfloat162float(x);
}

struct Params {
  void* cache;
  const void* row;
  const int32_t* index;
  int S, KV, hd;
  long long c_sb, c_ss, c_sk;           // cache strides in elements
  long long r_sb, r_sk;                 // row strides in elements
  int vec16;                            // 16-byte vectors per row, 0: elementwise
};

template <typename TC, typename TR>
__global__ void cache_row_update_kernel(const Params p) {
  const int b = blockIdx.x;
  const int s = p.index[b];
  if (s < 0 || s >= p.S) return;        // out of range: dropped
  TC* dst = static_cast<TC*>(p.cache) + b * p.c_sb + s * p.c_ss;
  const TR* src = static_cast<const TR*>(p.row) + b * p.r_sb;
  if (p.vec16) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* r = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < p.vec16; i += blockDim.x) d[i] = r[i];
    return;
  }
  const int n = p.KV * p.hd;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / p.hd, e = i - k * p.hd;
    dst[k * p.c_sk + e] = cast_to<TC, TR>(src[k * p.r_sk + e]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// cache (B, S, KV, hd) written in place, row (B, KV, hd), index (B,) int32
// on the device; strides in elements, the hd axis contiguous in both.
// cache_fp32 / row_fp32: 1 for fp32, 0 for bf16.
int rt_cache_row_update(void* cache, const void* row, const int32_t* index, int B, int S,
                        int KV, int hd, long long c_sb, long long c_ss, long long c_sk,
                        long long r_sb, long long r_sk, int cache_fp32, int row_fp32,
                        void* stream) {
  if (B < 1 || S < 1 || KV < 1 || hd < 1) return (int)cudaErrorInvalidValue;
  const int esize = cache_fp32 ? 4 : 2;
  const long long row_bytes = (long long)KV * hd * esize;
  const bool vec = cache_fp32 == row_fp32 && c_sk == hd && r_sk == hd &&
                   row_bytes % 16 == 0 && (c_sb * esize) % 16 == 0 &&
                   (c_ss * esize) % 16 == 0 && (r_sb * esize) % 16 == 0 &&
                   aligned16(cache) && aligned16(row);
  const Params p{cache, row, index, S, KV, hd, c_sb, c_ss, c_sk, r_sb, r_sk,
                 vec ? (int)(row_bytes / 16) : 0};
  const int work = vec ? p.vec16 : KV * hd;
  const int threads = work >= 256 ? 256 : ((work + 31) / 32) * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_fp32 && row_fp32)
    cache_row_update_kernel<float, float><<<B, threads, 0, s>>>(p);
  else if (cache_fp32)
    cache_row_update_kernel<float, bf16><<<B, threads, 0, s>>>(p);
  else if (row_fp32)
    cache_row_update_kernel<bf16, float><<<B, threads, 0, s>>>(p);
  else
    cache_row_update_kernel<bf16, bf16><<<B, threads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"

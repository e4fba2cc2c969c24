// Scalar helpers of the decode kernels (fused_decode.cu, expert_gemv.cu):
// the activation dtype T (bf16 or fp32) to and from fp32, rounding to T,
// and the MLP's activations.

#pragma once

#include <cuda_bf16.h>

namespace {

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

// round two fp32 values to T and back (one packed conversion for bf16)
template <typename T> __device__ __forceinline__ void round2_t(float& a, float& b);
template <> __device__ __forceinline__ void round2_t<float>(float&, float&) {}
template <> __device__ __forceinline__ void round2_t<bf16>(float& a, float& b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  a = __low2float(p);
  b = __high2float(p);
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

}  // namespace

// Shared helpers of the ocflow_torch kernels: fp32 <-> storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ocf {

// dtype codes passed from Python (kernels/_build.py callers)
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// n / d by one multiply-high, exact for d >= 2 and 0 <= n, n * d < 2^32
// (the staged conv kernels' halo indexing; tests check every divisor and
// range their tiles give)
struct FastDiv {
  unsigned m;
  __device__ explicit FastDiv(int d) : m(0xffffffffu / d + 1) {}
  __device__ int operator()(int n) const { return (int)__umulhi((unsigned)n, m); }
};

}  // namespace ocf

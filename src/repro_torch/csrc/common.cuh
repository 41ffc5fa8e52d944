// Shared helpers of the SpMM kernels: value conversion and the rounding
// contract (products round at the operand dtype, sums run in fp32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Value type codes passed from Python (0 = float32, 1 = bfloat16).
constexpr int VALUE_F32 = 0;
constexpr int VALUE_BF16 = 1;
// Index type codes (0 = int32, 1 = int16).
constexpr int INDEX_I32 = 0;
constexpr int INDEX_I16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int to_i32(int32_t x) { return x; }
__device__ __forceinline__ int to_i32(int16_t x) { return static_cast<int>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A product of two operand-dtype values, rounded at that dtype.  A bf16 x
// bf16 product is exact in fp32, so rounding it once to bf16 gives the
// bf16 product the reference's ``gathered * vals`` forms.
template <typename V>
__device__ __forceinline__ float round_product(float p);
template <>
__device__ __forceinline__ float round_product<float>(float p) { return p; }
template <>
__device__ __forceinline__ float round_product<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

}  // namespace repro

// Helpers shared by the ViT kernels (layernorm.cu, ln_gemm.cu,
// packed_attn.cu): fp32 <-> storage-type conversions, a warp sum, and the
// error-string export every library gives its ctypes wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vrl {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the value a T store would keep.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace vrl

#define VRL_ERROR_STRING_EXPORT                                   \
  extern "C" const char* vrl_cuda_error_string(int err) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(err));     \
  }

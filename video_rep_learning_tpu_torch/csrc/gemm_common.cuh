// Device helpers shared by the ViT GEMMs (ln_gemm.cu, mlp_block.cu):
// cp.async copies, the LayerNorm prologue into a shared A panel, and the
// fp32 activation epilogue.
#pragma once

#include "common.cuh"

namespace vrl {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows m0 .. m0+BM-1 of x into the shared A panel (row stride lda), through
// the LN when g is given, rounded to T; rows past M are zeros. One warp a
// row at a time.
template <typename T, int BM, int Threads>
__device__ void load_a_panel(const T* __restrict__ x, const float* __restrict__ g,
                             const float* __restrict__ be, T* As, int lda, int m0,
                             int M, int K, float eps) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < BM; r += Threads / 32) {
    T* dst = As + (size_t)r * lda;
    const int m = m0 + r;
    if (m >= M) {
      for (int c = lane; c < K; c += 32) dst[c] = vrl::from_f32<T>(0.f);
      continue;
    }
    const T* src = x + (size_t)m * K;
    if (g == nullptr) {
      for (int c = lane; c < K; c += 32) dst[c] = src[c];
      continue;
    }
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s += vrl::to_f32(src[c]);
    const float mu = vrl::warp_sum(s) / K;
    float v = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = vrl::to_f32(src[c]) - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(vrl::warp_sum(v) / K + eps);
    for (int c = lane; c < K; c += 32)
      dst[c] = vrl::from_f32<T>((vrl::to_f32(src[c]) - mu) * rstd * g[c] + be[c]);
  }
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
  if (act == 2) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
  }
  return y;
}

}  // namespace vrl

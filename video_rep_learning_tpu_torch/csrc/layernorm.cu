// Row LayerNorm for Hopper (sm_90a): y = (x - mean) / sqrt(var + eps) * scale
// + bias over the last dim, fp32 statistics, output in the input's type.
//
// Replaces the TPU kernel `_ln_kernel` of
// video_rep_learning_tpu/ops/layernorm_pallas.py (the ViT's final norm). The
// mean first, then the centred variance mean((x - mean)^2), as that kernel
// computes it (not E[x^2] - mean^2); scale and bias are fp32.
//
// What bounds it on the H100: bytes. At the MV-Former chunk (40 frames x 785
// tokens x 768, bf16) it reads and writes 48 MB and does ~8 operations a
// value, far under the card's 20 operations a byte. Design: one warp per row,
// eight rows a 256-thread block; the row is read three times (sum, centred
// sum of squares, normalise), the second and third from L1/L2.
//
// x, y (rows, D) contiguous, fp32 or bf16; scale, bias (D,) fp32. No
// allocation; launches on the caller's stream and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ y, int rows,
                 int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += vrl::to_f32(xr[c]);
  const float mu = vrl::warp_sum(s) / D;
  float v = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = vrl::to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(vrl::warp_sum(v) / D + eps);
  T* yr = y + (size_t)row * D;
  for (int c = lane; c < D; c += 32)
    yr[c] = vrl::from_f32<T>((vrl::to_f32(xr[c]) - mu) * rstd * scale[c] + bias[c]);
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   int rows, int D, float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  layernorm_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), rows, D, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Returns a cudaError_t (0 = success).
int vrl_layernorm(const void* x, const void* scale, const void* bias, void* y,
                  int rows, int D, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, bias, y, rows, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, bias, y, rows, D, eps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

// A tensor-core matrix product for Hopper (sm_90a), int8 and bf16:
//   out (M, F) = x (M, K) @ w (K, F),
// int8 x int8 summed exactly in int32, or bf16 x bf16 summed in fp32, with w
// in its (K, F) layout as the TPU kernel takes it.
//
// Replaces the TPU kernel `_mm_kernel` (tools/bench_int8_pallas.py:28,
// `_pallas_mm` :37): the ViT-B/8 fc1 product of a 40-frame chunk, (31360,
// 768) x (768, 3072), which that script times in int8 against bf16 to decide
// whether a quantized backbone is worth a GEMM of its own.
//
// What bounds it on the H100: int8, bytes (the int32 output, 385 MB, is most
// of the 412 MB it moves; the 148 G operations take 0.075 ms at 1,979
// TOPS); bf16, operations (0.150 ms at 989 TFLOP/s). This first version is
// simple and right: a block owns 128 x 128 outputs, 8 warps of 32 x 64 in
// WMMA 16x16x16 tiles (s8 -> s32, bf16 -> f32), K walked in 32-deep tiles of
// x and w double-buffered by cp.async. The shared tiles are stored as
// 16-column panels (16 elements a row) so that every WMMA fragment starts
// 256-bit aligned, which int8 fragments 16 bytes deep need. The sums go to
// device memory straight from the fragments. wgmma and TMA come later.
//
// x (M, K), w (K, F), out (M, F) contiguous and 16-byte aligned; M a multiple
// of 128, K of 32, F of 128. No allocation; launches on the caller's stream
// and returns cudaGetLastError().

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

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

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;

template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads)
tc_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, Acc* __restrict__ out,
               int K, int F) {
  __shared__ __align__(128) T As[2][kBK / 16][kBM][16];
  __shared__ __align__(128) T Bs[2][kBN / 16][kBK][16];
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte copy
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  auto load = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    for (int v = tid; v < kBM * kBK / kVec; v += kThreads) {
      const int r = v / (kBK / kVec), c = (v % (kBK / kVec)) * kVec;
      cp_async16(&As[buf][c / 16][r][c % 16], x + (size_t)(m0 + r) * K + k0 + c);
    }
    for (int v = tid; v < kBK * kBN / kVec; v += kThreads) {
      const int r = v / (kBN / kVec), c = (v % (kBN / kVec)) * kVec;
      cp_async16(&Bs[buf][c / 16][r][c % 16], w + (size_t)(k0 + r) * F + n0 + c);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  const int nk = K / kBK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt is in
    const int buf = kt & 1;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][kk][wm * 32 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[buf][wn * 4 + j][kk * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with tile kt before it is refilled
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(out + (size_t)(m0 + wm * 32 + i * 16) * F + n0 + wn * 64 + j * 16,
                              acc[i][j], F, wmma::mem_row_major);
}

template <typename T, typename Acc>
cudaError_t launch(const void* x, const void* w, void* out, int M, int K, int F,
                   cudaStream_t s) {
  const dim3 grid(F / kBN, M / kBM);
  tc_gemm_kernel<T, Acc><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<Acc*>(out), K, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 2: int8 in, int32 out; dtype 1: bf16 in, fp32 out. Returns a
// cudaError_t (0 = success); cudaErrorInvalidValue for a shape or type the
// kernel does not take.
int vrl_tc_gemm(const void* x, const void* w, void* out, int M, int K, int F, int dtype,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || F <= 0 || M % kBM || K % kBK || F % kBN || M / kBM > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 2) return launch<signed char, int>(x, w, out, M, K, F, s);
  if (dtype == 1) return launch<bf16, float>(x, w, out, M, K, F, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

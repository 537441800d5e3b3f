// LayerNorm + matmul + bias + activation (+ residual) for Hopper (sm_90a):
//   y = act(LN(x) W^T + b) [+ r]      (LN optional, act none / erf GELU / tanh GELU)
//
// Replaces the TPU kernel `_kernel_ln` of
// video_rep_learning_tpu/ops/matmul_gelu_pallas.py (`ln_matmul_bias_act`):
// LN2 + fc1 + GELU of every ViT block, and LN1 + qkv inside the attention
// half-block. With the LN off and a residual it also computes that
// half-block's projection, `x + attn W_proj^T + b` (vit_block_pallas.py:166);
// with the LN off and the GELU epilogue it replaces `_kernel` of the same
// file (#7, `matmul_bias_gelu`: gelu(x W^T + b), the same product and
// epilogue), the MLP's fc1 under VRL_FUSED_LN_MM=0.
//
// What bounds it on the H100: operations. fc1 at the MV-Former chunk
// (31400 x 768 -> 3072, bf16) is 148 GFLOP against 290 MB of traffic, above
// the card's ~295 operations a byte. This first version is simple and right:
//   - a block owns BM rows x 128 output columns. Its prologue normalises the
//     rows over the full K (fp32 mean, then the centred variance, as
//     `_ln_rows` does) and keeps the normalised A panel, rounded to the
//     compute type as `_ln_rows` rounds it, in shared memory
//     (64 x 768 bf16 = 96 KB);
//   - it reads nn.Linear's (out, in) weight as it is: 128 x 32 tiles of W
//     are the column-major B operand, double-buffered with cp.async;
//   - bf16 operands go through the tensor cores (WMMA 16x16x16, fp32
//     accumulators; 8 warps of 32 x 32); fp32 operands through fp32 FMA
//     (4 x 4 outputs a thread), never TF32;
//   - the epilogue adds the fp32 bias, applies the activation in fp32
//     (erff for the exact GELU), adds the residual in fp32 and rounds once.
// The ragged M edge (n * 785 rows) is masked: rows past M normalise as
// zeros and are never stored. K must be a multiple of 32, F of 128.
// wgmma, TMA and a persistent schedule come in a later PR.
//
// x (M, K), w (F, K), residual and out (M, F): contiguous, all fp32 or all
// bf16; ln_scale, ln_bias (K,) and bias (F,) fp32; ln_scale null = no LN,
// residual null = none. No allocation; launches on the caller's stream and
// returns cudaGetLastError().
//
// `vrl_ln_gemm_ln_once` is the same function in the LN-once schedule of the
// TPU micro-benchmark `_kernel_scratch` (tools/bench_ln_matmul.py:67,
// `build_scratch`: the image's rows normalised once into VMEM scratch at
// j == 0, every weight column tile reusing them), where `vrl_ln_gemm` is
// that script's `_kernel_jouter` (:34), the prologue recomputed for every
// column tile. bf16 only, the TPU script's type. A block owns 64 rows,
// normalises them once into shared memory and then walks all F / 128
// column tiles, the W tiles streamed through one cp.async double buffer
// across the tile boundaries;
// the bf16 epilogue stages through its own fp32 region, since the A panel
// stays live (99,328 + 33,792 + 20,480 = 153,600 bytes at K = 768: one
// block an SM). The grid is M / 64 row blocks, 491 at the MV-Former chunk:
// 3.7 waves on 132 SMs, so the last wave runs 0.7 full.

#include <mma.h>

#include "common.cuh"
#include "gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
using namespace vrl;

constexpr int kThreads = 256;
constexpr int kBN = 128;            // output columns a block
constexpr int kBK = 32;             // K of one W tile
constexpr int kBLd = kBK + 8;       // bf16 W tile row stride (16 B pad)
constexpr int kCLd = kBN + 4;       // fp32 staging of the bf16 block's C
constexpr int kBMBf16 = 64;
constexpr int kBMF32 = 32;
constexpr int kMaxSmem = 232448;    // 227 KB a block on the H100

template <typename T>
__device__ __forceinline__ void finish(float acc, int m, int n, int F,
                                       const float* __restrict__ bias,
                                       const T* __restrict__ res, T* __restrict__ out,
                                       int act) {
  float y = activate(acc + bias[n], act);
  const size_t i = (size_t)m * F + n;
  if (res != nullptr) y += vrl::to_f32(res[i]);
  out[i] = vrl::from_f32<T>(y);
}

size_t a_region_bf16(int K) {
  const size_t a = sizeof(bf16) * kBMBf16 * (K + 8);
  const size_t c = sizeof(float) * kBMBf16 * kCLd;
  return a > c ? a : c;
}
size_t smem_bf16(int K) { return a_region_bf16(K) + 2 * sizeof(bf16) * kBN * kBLd; }
size_t smem_f32(int K) { return sizeof(float) * (kBMF32 * K + kBN * (kBK + 1)); }

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ be, const bf16* __restrict__ w,
                 const float* __restrict__ bias, const bf16* __restrict__ res,
                 bf16* __restrict__ out, int M, int K, int F, int act, float eps,
                 int a_region) {
  constexpr int BM = kBMBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = K + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // over the A panel once it is dead
  bf16* Bs = reinterpret_cast<bf16*>(smem + a_region);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const bf16* wb = w + (size_t)n0 * K;

  auto load_b = [&](int kt, int buf) {
    bf16* dst = Bs + buf * kBN * kBLd;
    for (int v = tid; v < kBN * kBK / 8; v += kThreads) {
      const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
      cp_async16(dst + r * kBLd + c, wb + (size_t)r * K + kt * kBK + c);
    }
  };

  const int nk = K / kBK;
  load_b(0, 0);
  cp_async_commit();
  load_a_panel<bf16, BM, kThreads>(x, g, be, As, lda, m0, M, K, eps);

  const int warp = tid >> 5, wm = warp >> 2, wn = warp & 3;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_b(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, the first time, the A panel) is in
    const bf16* Bt = Bs + (kt & 1) * kBN * kBLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * lda + kt * kBK + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bt + (wn * 32 + j * 16) * kBLd + kk, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();  // every warp is done with tile kt before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16,
                              c[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * kBN; idx += kThreads) {
    const int r = idx / kBN, cc = idx % kBN;
    if (m0 + r < M) finish(Cs[r * kCLd + cc], m0 + r, n0 + cc, F, bias, res, out, act);
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ be, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ out, int M, int K, int F, int act, float eps) {
  constexpr int BM = kBMF32;
  constexpr int kBS = kBK + 1;  // padded W tile row: conflict-free reads
  extern __shared__ float smf[];
  float* As = smf;
  float* Bs = smf + BM * K;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  load_a_panel<float, BM, kThreads>(x, g, be, As, K, m0, M, K, eps);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the A panel is in; the last tile's reads are done
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      Bs[r * kBS + cc] = w[(size_t)(n0 + r) * K + k0 + cc];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 8 * i) * K + k0 + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 32 * j) * kBS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) finish(acc[i][j], m, n0 + tx + 32 * j, F, bias, res, out, act);
    }
  }
}

// The LN-once schedule (see the header): one block a row panel, every
// column tile of F in turn.
size_t ln_once_smem_bf16(int K) {
  return sizeof(bf16) * kBMBf16 * (K + 8) + sizeof(float) * kBMBf16 * kCLd +
         2 * sizeof(bf16) * kBN * kBLd;
}

__global__ void __launch_bounds__(kThreads)
gemm_bf16_ln_once_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ be, const bf16* __restrict__ w,
                         const float* __restrict__ bias, const bf16* __restrict__ res,
                         bf16* __restrict__ out, int M, int K, int F, int act,
                         float eps) {
  constexpr int BM = kBMBf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = K + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + sizeof(bf16) * BM * lda);
  bf16* Bs = reinterpret_cast<bf16*>(smem + sizeof(bf16) * BM * lda +
                                     sizeof(float) * BM * kCLd);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int nk = K / kBK, total = (F / kBN) * nk;  // (column tile, K tile) pairs

  auto load_b = [&](int t, int buf) {
    const bf16* wt = w + (size_t)(t / nk) * kBN * K + (t % nk) * kBK;
    bf16* dst = Bs + buf * kBN * kBLd;
    for (int v = tid; v < kBN * kBK / 8; v += kThreads) {
      const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
      cp_async16(dst + r * kBLd + c, wt + (size_t)r * K + c);
    }
  };

  load_b(0, 0);
  cp_async_commit();
  load_a_panel<bf16, BM, kThreads>(x, g, be, As, lda, m0, M, K, eps);

  const int warp = tid >> 5, wm = warp >> 2, wn = warp & 3;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int t = 0; t < total; ++t) {
    const int kt = t % nk;
    if (t + 1 < total) {
      load_b(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, the first time, the A panel) is in
    const bf16* Bt = Bs + (t & 1) * kBN * kBLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * lda + kt * kBK + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bt + (wn * 32 + j * 16) * kBLd + kk, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();  // every warp is done with tile t before it is refilled
    if (kt == nk - 1) {  // this column tile's sums are complete
      const int n0 = (t / nk) * kBN;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16,
                                  c[i][j], kCLd, wmma::mem_row_major);
          wmma::fill_fragment(c[i][j], 0.f);
        }
      __syncthreads();
      for (int idx = tid; idx < BM * kBN; idx += kThreads) {
        const int r = idx / kBN, cc = idx % kBN;
        if (m0 + r < M) finish(Cs[r * kCLd + cc], m0 + r, n0 + cc, F, bias, res, out, act);
      }
      // the next column tile's stores to Cs come after nk more barriers
    }
  }
}

}  // namespace

extern "C" {

// act: 0 none, 1 exact (erf) GELU, 2 tanh GELU. dtype: 0 fp32, 1 bf16.
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a shape the
// kernel does not take (K % 32, F % 128, or a panel over 227 KB).
int vrl_ln_gemm(const void* x, const void* ln_scale, const void* ln_bias,
                const void* w, const void* bias, const void* residual, void* out,
                int M, int K, int F, int act, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % kBK || F <= 0 || F % kBN || act < 0 || act > 2)
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ln_scale);
  const auto* be = static_cast<const float*>(ln_bias);
  const auto* b = static_cast<const float*>(bias);
  if (dtype == 1) {
    const size_t smem = smem_bf16(K);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(F / kBN, (M + kBMBf16 - 1) / kBMBf16);
    gemm_bf16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), g, be, static_cast<const bf16*>(w), b,
        static_cast<const bf16*>(residual), static_cast<bf16*>(out), M, K, F, act,
        eps, (int)a_region_bf16(K));
    return cudaGetLastError();
  }
  if (dtype == 0) {
    const size_t smem = smem_f32(K);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(F / kBN, (M + kBMF32 - 1) / kBMF32);
    gemm_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), g, be, static_cast<const float*>(w), b,
        static_cast<const float*>(residual), static_cast<float*>(out), M, K, F, act,
        eps);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// The same function and arguments as vrl_ln_gemm in the LN-once schedule,
// for bf16 (dtype 1) only.
int vrl_ln_gemm_ln_once(const void* x, const void* ln_scale, const void* ln_bias,
                        const void* w, const void* bias, const void* residual,
                        void* out, int M, int K, int F, int act, int dtype, float eps,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % kBK || F <= 0 || F % kBN || act < 0 || act > 2)
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ln_scale);
  const auto* be = static_cast<const float*>(ln_bias);
  const auto* b = static_cast<const float*>(bias);
  if (dtype == 1) {
    const size_t smem = ln_once_smem_bf16(K);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_ln_once_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    gemm_bf16_ln_once_kernel<<<(M + kBMBf16 - 1) / kBMBf16, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), g, be, static_cast<const bf16*>(w), b,
        static_cast<const bf16*>(residual), static_cast<bf16*>(out), M, K, F, act, eps);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

// The ViT's whole MLP half-block for Hopper (sm_90a), in one launch:
//   y = x + act(LN(x) W1^T + b1) W2^T + b2      (act: erf GELU / tanh GELU / none)
//
// Replaces the TPU kernel `_kernel_mlp` of
// video_rep_learning_tpu/ops/matmul_gelu_pallas.py (`ln_mlp_block`, #9),
// which the JAX package takes under VRL_FUSED_MLP=1. Rounding points are the
// TPU kernel's: the LN output is rounded to the compute type; fc1 sums in
// fp32, adds b1, applies the activation and rounds once to the compute type
// before fc2; fc2 sums in fp32, adds b2 and x in fp32 and rounds once.
//
// What bounds it on the H100: operations. At the MV-Former chunk (31400
// rows, K 768, F 3072, bf16) it is 296 GFLOP against 97 MB of traffic. The
// point of the fusion is that the (rows, F) activation never reaches device
// memory (193 MB each way a chunk between an fc1 kernel and fc2). The TPU
// kernel keeps one image's rows in 15 MB of VMEM; a Hopper block has 227 KB,
// so the design is K streaming over row blocks:
//   - a block owns 32 token rows. Its prologue normalises them over the full
//     K into a shared A panel in the compute type (32 x 768 bf16 = 48.5 KB,
//     with padding), as ln_gemm.cu does;
//   - it walks F in tiles of 64 (bf16) or 32 (fp32) columns. Each tile of
//     the fc1 output is formed against W1 streamed in 64-wide K chunks
//     (cp.async, double-buffered), gets b1 and the activation in fp32, is
//     rounded into shared memory and consumed at once by fc2, whose K is
//     that tile: W2's (768 x 64) column slab is loaded whole for it;
//   - fc2's (32 x 768) fp32 sum lives in registers for the whole walk: in
//     bf16 each of the 8 warps owns 96 output columns as 2 x 6 WMMA
//     accumulators (96 floats a thread); in fp32 each thread owns 4 rows x
//     24 columns;
//   - bf16 operands go through the tensor cores (WMMA 16x16x16, fp32
//     accumulators); fp32 operands through fp32 FMA, never TF32.
// Shared memory at K 768: bf16 A 49,664 + W1 chunks 18,432 + W2 slab
// 110,592 + fc1 tile 4,608 + its fp32 staging 8,704 = 192,000 bytes; fp32
// A 98,304 + W2 slab 101,376 + W1 chunk 4,224 + tile 4,224 = 208,128
// bytes. Either way one block an SM (8 warps): simple and right first;
// wgmma, TMA and more rows a block (the accumulator then needs shared
// memory or two consumer warpgroups) come in a later PR.
//
// x, out (M, K); w1 (F, K); w2 (K, F): contiguous, all fp32 or all bf16;
// ln_scale, ln_bias, b2 (K,) and b1 (F,) fp32. K a multiple of 128 up to
// 768, F a multiple of 64. The ragged M edge is masked: rows past M
// normalise as zeros and are never stored. No allocation; launches on the
// caller's stream and returns cudaGetLastError().

#include <mma.h>

#include "common.cuh"
#include "gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
using namespace vrl;

constexpr int kThreads = 256;
constexpr int kBM = 32;          // token rows a block
constexpr int kBF = 64;          // fc1 columns (= fc2 depth) a tile, bf16
constexpr int kBK = 64;          // K of one streamed W1 chunk, bf16
constexpr int kLdw1 = kBK + 8;   // W1 chunk row stride (16 B pad)
constexpr int kLdh = kBF + 8;    // fc1 tile and W2 slab row stride
constexpr int kLds = kBF + 4;    // fp32 staging of the fc1 tile
constexpr int kBF32 = 32;        // fc1 columns a tile, fp32
constexpr int kLd32 = kBF32 + 1; // fp32 tiles' row stride: conflict-free reads
constexpr int kMaxSmem = 232448; // 227 KB a block on the H100

// Byte offsets of the bf16 kernel's shared regions (each 32 B aligned, as
// WMMA loads and stores want). The final fp32 staging of the output
// (kBM x (K + 4)) reuses the W2 slab once the walk is done.
struct Bf16Smem {
  size_t a, w1, w2, h, s, total;
};
__host__ __device__ inline Bf16Smem bf16_smem(int K) {
  Bf16Smem L;
  L.a = 0;
  L.w1 = L.a + sizeof(bf16) * kBM * (K + 8);
  L.w2 = L.w1 + sizeof(bf16) * 2 * kBF * kLdw1;
  const size_t slab = sizeof(bf16) * K * kLdh;
  const size_t stage = sizeof(float) * kBM * (K + 4);
  L.h = L.w2 + (slab > stage ? slab : stage);
  L.s = L.h + sizeof(bf16) * kBM * kLdh;
  L.total = L.s + sizeof(float) * kBM * kLds;
  return L;
}
inline size_t f32_smem(int K) {
  return sizeof(float) * (kBM * K + K * kLd32 + 2 * kBF32 * kLd32);
}

// NF: the 16-column output fragments a warp owns; K = 8 warps x 16 x NF.
template <int NF>
__global__ void __launch_bounds__(kThreads, 1)
mlp_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ be, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out, int M,
                int F, int act, float eps) {
  constexpr int K = 128 * NF;
  constexpr int lda = K + 8;
  constexpr int ldo = K + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Smem L = bf16_smem(K);
  bf16* As = reinterpret_cast<bf16*>(smem + L.a);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L.w2);
  float* Os = reinterpret_cast<float*>(smem + L.w2);  // after the walk
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.h);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM;
  const int fm = warp >> 2, fn = warp & 3;  // this warp's 16 x 16 of the fc1 tile
  constexpr int nk = K / kBK;

  load_a_panel<bf16, kBM, kThreads>(x, g, be, As, lda, m0, M, K, eps);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int f0 = 0; f0 < F; f0 += kBF) {
    // W2[:, f0:f0+64] -> the slab (K rows of 64), then the first W1 chunk
    for (int v = tid; v < K * (kBF / 8); v += kThreads) {
      const int r = v / (kBF / 8), c = (v % (kBF / 8)) * 8;
      cp_async16(W2s + r * kLdh + c, w2 + (size_t)r * F + f0 + c);
    }
    cp_async_commit();
    auto load_w1 = [&](int kt, int buf) {
      bf16* dst = W1s + buf * kBF * kLdw1;
      for (int v = tid; v < kBF * (kBK / 8); v += kThreads) {
        const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
        cp_async16(dst + r * kLdw1 + c, w1 + (size_t)(f0 + r) * K + kt * kBK + c);
      }
    };
    load_w1(0, 0);
    cp_async_commit();

    // fc1 tile: S = A W1[f0:f0+64]^T, one 16 x 16 fragment a warp
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.f);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load_w1(kt + 1, (kt + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();  // the slab and chunk kt are in
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* Bt = W1s + (kt & 1) * kBF * kLdw1;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, As + (fm * 16) * lda + kt * kBK + kk, lda);
        wmma::load_matrix_sync(b, Bt + (fn * 16) * kLdw1 + kk, kLdw1);
        wmma::mma_sync(s, a, b, s);
      }
      __syncthreads();  // every warp is done with chunk kt before it is refilled
    }
    // + b1, activation in fp32, one rounding to bf16
    wmma::store_matrix_sync(Ss + (fm * 16) * kLds + fn * 16, s, kLds,
                            wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kBM * kBF; i += kThreads) {
      const int r = i / kBF, c = i % kBF;
      Hs[r * kLdh + c] = from_f32<bf16>(activate(Ss[r * kLds + c] + b1[f0 + c], act));
    }
    __syncthreads();

    // fc2: acc += H W2[:, f0:f0+64]^T over this warp's 16 * NF columns
#pragma unroll
    for (int kk = 0; kk < kBF; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Hs + (i * 16) * kLdh + kk, kLdh);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, W2s + (warp * 16 * NF + j * 16) * kLdh + kk, kLdh);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();  // the slab and the tile are free for the next one
  }

  // out = x + acc + b2, in fp32, one rounding
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(Os + (i * 16) * ldo + warp * 16 * NF + j * 16,
                              acc[i][j], ldo, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kBM * K; idx += kThreads) {
    const int r = idx / K, c = idx % K, m = m0 + r;
    if (m < M) {
      const size_t o = (size_t)m * K + c;
      out[o] = from_f32<bf16>(Os[r * ldo + c] + b2[c] + to_f32(x[o]));
    }
  }
}

// NJ: output columns a thread owns (cg + 32 j); K = 32 x NJ. Thread
// (rg, cg) = (tid / 32, tid % 32) owns rows 4 rg .. 4 rg + 3.
template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ be, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int M,
               int F, int act, float eps) {
  constexpr int K = 32 * NJ;
  extern __shared__ float smf[];
  float* As = smf;                 // kBM x K
  float* W2s = As + kBM * K;       // K x kBF32 (stride kLd32)
  float* W1s = W2s + K * kLd32;    // kBF32 x 32-wide K chunk
  float* Hs = W1s + kBF32 * kLd32; // kBM x kBF32
  const int tid = threadIdx.x, rg = tid >> 5, cg = tid & 31;
  const int m0 = blockIdx.x * kBM;
  load_a_panel<float, kBM, kThreads>(x, g, be, As, K, m0, M, K, eps);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kBF32) {
    __syncthreads();  // the A panel is in; the last tile's reads are done
    for (int i = tid; i < K * kBF32; i += kThreads) {
      const int r = i / kBF32, c = i % kBF32;
      W2s[r * kLd32 + c] = w2[(size_t)r * F + f0 + c];
    }
    // fc1: thread (rg, cg) forms rows 4 rg + i, column cg of the tile
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 32) {
      __syncthreads();  // the last chunk's reads are done
      for (int i = tid; i < kBF32 * 32; i += kThreads) {
        const int r = i / 32, c = i % 32;
        W1s[r * kLd32 + c] = w1[(size_t)(f0 + r) * K + k0 + c];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const float b = W1s[cg * kLd32 + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = fmaf(As[(rg * 4 + i) * K + k0 + k], b, h[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Hs[(rg * 4 + i) * kLd32 + cg] = activate(h[i] + b1[f0 + cg], act);
    __syncthreads();  // the tile and the slab are in
    for (int f = 0; f < kBF32; ++f) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Hs[(rg * 4 + i) * kLd32 + f];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float b = W2s[(cg + 32 * j) * kLd32 + f];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rg * 4 + i;
    if (m < M) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const size_t o = (size_t)m * K + cg + 32 * j;
        out[o] = acc[i][j] + b2[cg + 32 * j] + x[o];
      }
    }
  }
}

template <int NF>
cudaError_t run_bf16(int M, int F, int act, float eps, cudaStream_t s,
                     const void* x, const float* g, const float* be,
                     const void* w1, const float* b1, const void* w2,
                     const float* b2, void* out) {
  const size_t smem = bf16_smem(128 * NF).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bf16_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlp_bf16_kernel<NF><<<(M + kBM - 1) / kBM, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), g, be, static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), M, F, act, eps);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t run_f32(int M, int F, int act, float eps, cudaStream_t s,
                    const void* x, const float* g, const float* be,
                    const void* w1, const float* b1, const void* w2,
                    const float* b2, void* out) {
  const size_t smem = f32_smem(32 * NJ);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlp_f32_kernel<NJ><<<(M + kBM - 1) / kBM, kThreads, smem, s>>>(
      static_cast<const float*>(x), g, be, static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<float*>(out), M, F, act, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 none, 1 exact (erf) GELU, 2 tanh GELU. dtype: 0 fp32, 1 bf16.
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a shape the
// kernel does not take (K not a multiple of 128 in [128, 768], F not a
// multiple of 64, M < 1) or a missing LN.
int vrl_mlp_block(const void* x, const void* ln_scale, const void* ln_bias,
                  const void* w1, const void* b1, const void* w2, const void* b2,
                  void* out, int M, int K, int F, int act, int dtype, float eps,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K < 128 || K > 768 || K % 128 || F <= 0 || F % kBF || act < 0 ||
      act > 2 || ln_scale == nullptr || ln_bias == nullptr)
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ln_scale);
  const auto* be = static_cast<const float*>(ln_bias);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* c2 = static_cast<const float*>(b2);
#define VRL_MLP_ARGS M, F, act, eps, s, x, g, be, w1, c1, w2, c2, out
  if (dtype == 1) {
    switch (K / 128) {
      case 1: return run_bf16<1>(VRL_MLP_ARGS);
      case 2: return run_bf16<2>(VRL_MLP_ARGS);
      case 3: return run_bf16<3>(VRL_MLP_ARGS);
      case 4: return run_bf16<4>(VRL_MLP_ARGS);
      case 5: return run_bf16<5>(VRL_MLP_ARGS);
      case 6: return run_bf16<6>(VRL_MLP_ARGS);
    }
  }
  if (dtype == 0) {
    switch (K / 128) {
      case 1: return run_f32<4>(VRL_MLP_ARGS);
      case 2: return run_f32<8>(VRL_MLP_ARGS);
      case 3: return run_f32<12>(VRL_MLP_ARGS);
      case 4: return run_f32<16>(VRL_MLP_ARGS);
      case 5: return run_f32<20>(VRL_MLP_ARGS);
      case 6: return run_f32<24>(VRL_MLP_ARGS);
    }
  }
#undef VRL_MLP_ARGS
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

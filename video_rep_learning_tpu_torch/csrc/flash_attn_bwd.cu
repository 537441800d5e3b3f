// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of masked
// softmax(q k^T * scale) v from the forward's log-sum-exp, never
// materialising the (Sq, Sk) score matrix.
//
// Replaces the TPU kernel `_fused_bwd_kernel` of
// video_rep_learning_tpu/ops/attention_pallas.py (and the XLA remat backward
// its streaming path took): one backward covers every key length.
//
// The math is the TPU kernel's: p = exp(s - lse) recomputed from the
// forward's LSE, delta = rowsum(dO * O) (a pre-pass here), dv = p^T dO,
// dp = dO v^T, ds = p (dp - delta) scale, dq = ds k, dk = ds^T q. A masked key
// scores the finite NEG_INF, as in the forward, so a fully masked row keeps
// its p and contributes to dv (and, as on the TPU, to dq and dk); keys past Sk
// in a ragged tile take p = 0. With bf16 inputs p is rounded to bf16 before
// p^T dO and ds before its two products, as the TPU kernel rounds them to the
// input type; every sum is fp32.
//
// Accumulation is deterministic, with no atomics: one launch over
// (k tile, h, b) walks all q tiles and writes dk, dv; another over
// (q tile, h, b) walks all k tiles and writes dq. Each recomputes p and dp.
//
// What bounds it on the H100: the CARL training step calls it at
// (2, 8, 240, 32) fp32, about 0.2 GFLOP a layer over 64 blocks per launch:
// far under one wave on 132 SMs, so latency (shared-memory loads, the
// __syncthreads between the tile phases) bounds it, not tensor-core or HBM
// throughput. Like the forward, it is fp32 FMA on CUDA cores with a 4 x 4
// register micro-tile per thread and padded shared-memory tiles; wgmma/TMA
// come later.
//
// Layout: q, dO, out (B, H, Sq, D), k, v (B, H, Sk, D), contiguous, fp32 or
// bf16; mask (B, Sk) fp32 or null; lse and delta (B, H, Sq) fp32 (delta is
// scratch the wrapper allocates). Launches on the caller's stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;  // q rows and keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // -0.7 * fp32 max

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// the TPU kernel's cast of p and ds to the input type before a product
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                             float* __restrict__ delta, size_t rows, int D) {
  const size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* a = dout + r * D;
  const T* b = out + r * D;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(to_f32(a[d]), to_f32(b[d]), acc);
  delta[r] = acc;
}

// Load a (kBlock, D) tile of rows [r0, r0 + kBlock) into padded shared memory
// (row stride D + 1), zero past n.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int n) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (r0 + r < n) ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// For the (q tile, k tile) pair in shared memory, thread (tr, tc) computes
// p and ds for q rows tr + 16 i and keys tc + 16 j.
template <int D, typename T>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks, const float* dOs,
                                       const float* Vs, const float* lse_s,
                                       const float* delta_s, const float* valid,
                                       float scale, float p[4][4], float ds[4][4]) {
  constexpr int kS = D + 1;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(tr + 16 * i) * kS + d];
      dov[i] = dOs[(tr + 16 * i) * kS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tc + 16 * j) * kS + d];
      vv[j] = Vs[(tc + 16 * j) * kS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = lse_s[tr + 16 * i], dl = delta_s[tr + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f = valid[tc + 16 * j];
      const float pij = f > 0.f ? expf(s[i][j] * scale - l)
                                : (f == 0.f ? expf(kNegInf - l) : 0.f);
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - dl) * scale;
    }
  }
}

__device__ __forceinline__ void load_rowstats(float* lse_s, float* delta_s, const float* lse,
                                              const float* delta, int q0, int Sq) {
  if (threadIdx.x < kBlock) {
    const int r = q0 + threadIdx.x;
    // rows past Sq: zero dO and Q make their p and ds contribute nothing
    lse_s[threadIdx.x] = r < Sq ? lse[r] : 0.f;
    delta_s[threadIdx.x] = r < Sq ? delta[r] : 0.f;
  }
}

__device__ __forceinline__ void load_valid(float* valid, const float* mb, int k0, int Sk) {
  if (threadIdx.x < kBlock) {
    const int key = k0 + threadIdx.x;
    valid[threadIdx.x] = key >= Sk ? -1.f : (mb == nullptr || mb[key] != 0.f) ? 1.f : 0.f;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // Q, dO, K, V tiles (padded), one (kBlock, kBlock + 1) tile of p or ds per
  // kind, lse, delta and the key flags
  return sizeof(float) * (4 * kBlock * (D + 1) + 2 * kBlock * (kBlock + 1) + 3 * kBlock);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ mask, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk, float scale) {
  constexpr int kS = D + 1, kP = kBlock + 1, kCols = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlock * kS;
  float* Ks = dOs + kBlock * kS;
  float* Vs = Ks + kBlock * kS;
  float* Ps = Vs + kBlock * kS;
  float* dSs = Ps + kBlock * kP;
  float* lse_s = dSs + kBlock * kP;
  float* delta_s = lse_s + kBlock;
  float* valid = delta_s + kBlock;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int k0 = blockIdx.x * kBlock;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* mb = mask ? mask + (size_t)blockIdx.z * Sk : nullptr;

  load_tile<D>(Ks, k + bh * Sk * D, k0, Sk);
  load_tile<D>(Vs, v + bh * Sk * D, k0, Sk);
  load_valid(valid, mb, k0, Sk);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kBlock) {
    __syncthreads();  // the previous q tile's reads are done
    load_tile<D>(Qs, q + bh * Sq * D, q0, Sq);
    load_tile<D>(dOs, dout + bh * Sq * D, q0, Sq);
    load_rowstats(lse_s, delta_s, lse + bh * Sq, delta + bh * Sq, q0, Sq);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<D, T>(Qs, Ks, dOs, Vs, lse_s, delta_s, valid, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(tr + 16 * i) * kP + tc + 16 * j] = round_to(p[i][j], T());
        dSs[(tr + 16 * i) * kP + tc + 16 * j] = round_to(ds[i][j], T());
      }
    __syncthreads();
    // thread (tr, tc) owns keys tr + 16 i, columns tc + 16 c
    const int qn = min(kBlock, Sq - q0);
    for (int r = 0; r < qn; ++r) {
      float pv[4], dsv[4], dov[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * kP + tr + 16 * i];
        dsv[i] = dSs[r * kP + tr + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = dOs[r * kS + tc + 16 * c];
        qv[c] = Qs[r * kS + tc + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_v[i][c] = fmaf(pv[i], dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], qv[c], acc_k[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key < Sk) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        store(dk + (bh * Sk + key) * D + tc + 16 * c, acc_k[i][c]);
        store(dv + (bh * Sk + key) * D + tc + 16 * c, acc_v[i][c]);
      }
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ mask, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int Sq, int Sk, float scale) {
  constexpr int kS = D + 1, kP = kBlock + 1, kCols = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlock * kS;
  float* Ks = dOs + kBlock * kS;
  float* Vs = Ks + kBlock * kS;
  float* dSs = Vs + kBlock * kS;
  float* lse_s = dSs + 2 * kBlock * kP;
  float* delta_s = lse_s + kBlock;
  float* valid = delta_s + kBlock;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * kBlock;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* mb = mask ? mask + (size_t)blockIdx.z * Sk : nullptr;

  load_tile<D>(Qs, q + bh * Sq * D, q0, Sq);
  load_tile<D>(dOs, dout + bh * Sq * D, q0, Sq);
  load_rowstats(lse_s, delta_s, lse + bh * Sq, delta + bh * Sq, q0, Sq);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBlock) {
    __syncthreads();  // the previous k tile's reads are done
    load_tile<D>(Ks, k + bh * Sk * D, k0, Sk);
    load_tile<D>(Vs, v + bh * Sk * D, k0, Sk);
    load_valid(valid, mb, k0, Sk);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<D, T>(Qs, Ks, dOs, Vs, lse_s, delta_s, valid, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(tr + 16 * i) * kP + tc + 16 * j] = round_to(ds[i][j], T());
    __syncthreads();
    // thread (tr, tc) owns q rows tr + 16 i, columns tc + 16 c
    const int kn = min(kBlock, Sk - k0);
    for (int key = 0; key < kn; ++key) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(tr + 16 * i) * kP + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[key * kS + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r < Sq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) store(dq + (bh * Sq + r) * D + tc + 16 * c, acc[i][c]);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   const void* out, const void* dout, const void* lse, void* delta,
                   void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const size_t rows = (size_t)B * H * Sq;
  delta_kernel<T><<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(out), static_cast<float*>(delta),
      rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kv_kernel = dkdv_kernel<D, T>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3((Sk + kBlock - 1) / kBlock, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto q_kernel = dq_kernel<D, T>;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3((Sq + kBlock - 1) / kBlock, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq),
      H, Sq, Sk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a head width or dtype the kernel does not take.
int vrl_flash_attn_bwd(const void* q, const void* k, const void* v, const void* mask,
                       const void* out, const void* dout, const void* lse, void* delta,
                       void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                       int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 32)
    return launch<32, float>(q, k, v, mask, out, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk,
                             scale, s);
  if (dtype == 0 && D == 64)
    return launch<64, float>(q, k, v, mask, out, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk,
                             scale, s);
  if (dtype == 1 && D == 32)
    return launch<32, __nv_bfloat16>(q, k, v, mask, out, dout, lse, delta, dq, dk, dv, B, H,
                                     Sq, Sk, scale, s);
  if (dtype == 1 && D == 64)
    return launch<64, __nv_bfloat16>(q, k, v, mask, out, dout, lse, delta, dq, dk, dv, B, H,
                                     Sq, Sk, scale, s);
  return cudaErrorInvalidValue;
}

const char* vrl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

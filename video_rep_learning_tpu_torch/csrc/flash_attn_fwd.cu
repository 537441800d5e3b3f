// Flash-attention forward for Hopper (sm_90a): masked softmax(q k^T * scale) v
// plus the row log-sum-exp, never materialising the (Sq, Sk) score matrix.
//
// Replaces the TPU kernels `_fused_fwd_kernel` and `_stream_kernel` of
// video_rep_learning_tpu/ops/attention_pallas.py. Those are two schedules of
// one function, chosen there by a VMEM budget; here one online-softmax kernel
// covers every key length.
//
// What bounds it on the H100: the CARL temporal encoder calls it at
// (B=1, H=8, S<=1000, d=32) in fp32, about 1 GFLOP per layer and 128 blocks of
// work. That is one wave on 132 SMs, so the kernel is bound by latency (smem
// loads, the per-tile reductions and __syncthreads), not by tensor-core or
// HBM throughput. The design keeps it simple and right first: fp32 FMA on
// CUDA cores, a 4x4 register micro-tile of scores per thread, bank-conflict
// free padded tiles in shared memory. wgmma/TMA come later.
//
// Layout and contract (matches the JAX package's flash_attention):
//   q (B, H, Sq, D), k and v (B, H, Sk, D), contiguous, fp32 or bf16;
//   mask (B, Sk) fp32 or null, nonzero = attend;
//   out (B, H, Sq, D) in the input type, lse (B, H, Sq) fp32.
// A masked key scores the finite NEG_INF after scaling, so a fully masked row
// softmaxes to uniform weights (the mean of V), as on the TPU. Keys past Sk
// (the ragged last tile) score -inf and take no weight at all. Accumulation is
// fp32 for both input types; P stays fp32 in the P.V product.
//
// Grid (ceil(Sq/64), H, B), 256 threads; no allocation, launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // -0.7 * fp32 max

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to D+1 floats a row, V unpadded, P padded to BK+1,
  // plus one validity flag per key of the tile.
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1) + kBlockK);
}

// Thread t owns rows tr + 16*i (i < 4) of the q tile and keys tc + 16*j
// (j < 4) of each k tile, with tr = t / 16 and tc = t % 16. Its output
// columns are tc + 16*c (c < D/16). The 16 threads sharing a row are 16
// neighbouring lanes of one warp, so row reductions are 4 xor-shuffles.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                 int Sk, float scale) {
  constexpr int kQS = D + 1;
  constexpr int kPS = kBlockK + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * kQS;
  float* Vs = Ks + kBlockK * kQS;
  float* Ps = Vs + kBlockK * D;
  float* valid = Ps + kBlockQ * kPS;  // 1 attend, 0 masked, -1 past Sk

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const float* mb = mask ? mask + (size_t)blockIdx.z * Sk : nullptr;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * kQS + c] = (q0 + r < Sq) ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      const size_t g = (size_t)(k0 + r) * D + c;
      Ks[r * kQS + c] = in ? to_f32(kb[g]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[g]) : 0.f;
    }
    if (tid < kBlockK) {
      const int key = k0 + tid;
      valid[tid] = key >= Sk ? -1.f : (mb == nullptr || mb[key] != 0.f) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * kQS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f = valid[tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = f > 0.f ? s[i][j] * scale : (f == 0.f ? kNegInf : -CUDART_INF_F);
    }

    // Online softmax: every tile holds at least one key < Sk, so the running
    // max is finite after the first tile and exp(-inf - m) is 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(tr + 16 * i) * kPS + tc + 16 * j] = s[i][j];
    }
    __syncthreads();

    const int kn = min(kBlockK, Sk - k0);
    for (int key = 0; key < kn; ++key) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * kPS + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[key * D + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r < Sq) {
      const float inv = 1.f / l[i];
      T* orow = out + (bh * Sq + r) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) store_out(orow + tc + 16 * c, o[i][c] * inv);
      if (tc == 0) lse[bh * Sq + r] = m[i] + logf(l[i]);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* out, void* lse, int B, int H, int Sq, int Sk,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, Sq, Sk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a head width or dtype the kernel does not take.
int vrl_flash_attn_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int H,
                       int Sq, int Sk, int D, int dtype, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 32)
    return launch<32, float>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, s);
  if (dtype == 0 && D == 64)
    return launch<64, float>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, s);
  if (dtype == 1 && D == 32)
    return launch<32, __nv_bfloat16>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, s);
  if (dtype == 1 && D == 64)
    return launch<64, __nv_bfloat16>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, s);
  return cudaErrorInvalidValue;
}

const char* vrl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

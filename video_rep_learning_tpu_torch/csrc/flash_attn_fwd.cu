// Flash-attention forward for Hopper (sm_90a): masked softmax(q k^T * scale) v
// plus the row log-sum-exp, never materialising the (Sq, Sk) score matrix.
//
// Replaces the TPU kernels `_fused_fwd_kernel` and `_stream_kernel` of
// video_rep_learning_tpu/ops/attention_pallas.py. Those are two schedules of
// one function, chosen there by a VMEM budget; here one online-softmax kernel
// covers every key length.
//
// What bounds it on the H100. The CARL step calls it at (2, 8, 240, 32) and
// the MV-Former encoder at (2, 8, 720, 32), both fp32: 0.03-0.3 GFLOP over 16
// (batch, head) pairs. That is too little work to fill 132 SMs with 64-row
// query tiles, so the card's fill and each warp's chain of dependent steps
// bound it, not tensor-core or HBM throughput. The design:
// - Every product is on the tensor cores through mma.sync (`mma.cuh`): bf16
//   as m16n8k16; fp32 as 3xTF32 m16n8k8 (each operand split into a tf32 hi
//   and lo, three products summed in fp32), which keeps about fp32's
//   accuracy.
// - A warp owns 16 query rows. Their Q fragments stay in registers for the
//   whole walk, and so do the scores S and the output O: P is re-packed
//   from the S accumulators as the A operand of P V (for bf16 rounded to
//   bf16, as the TPU kernel casts p to the input type), with no trip
//   through shared memory.
// - A block is four warps: RG row groups of 16 rows times 4 / RG slices of
//   each 64-key step. The slices' (m, l, O) are merged at the end through
//   shared memory in slice order, so every output is the same bit for bit
//   from launch to launch (no atomics). The host picks RG from the grid:
//   the most rows a block that still gives 1.5 blocks an SM, else 16 rows
//   a block with the keys split four ways (CARL's (2, 8, 240, 32): 240
//   blocks, not the 64 of 64-row blocks; the encoder's (2, 8, 720, 32):
//   32-row blocks).
// - K, V and the mask are double buffered with cp.async: step i + 1 lands
//   while step i computes. Shared rows are padded (fp32: D + 4, bf16: D + 8
//   elements) so that both the row and the column fragment reads are free of
//   bank conflicts.
//
// Layout and contract (matches the JAX package's flash_attention):
//   q (B, H, Sq, D), k and v (B, H, Sk, D), contiguous and 16-byte aligned,
//   fp32 or bf16, D 32 or 64; mask (B, Sk) fp32 or null, nonzero = attend;
//   out (B, H, Sq, D) in the input type, lse (B, H, Sq) fp32.
// A masked key scores the finite NEG_INF after scaling, so a fully masked row
// softmaxes to uniform weights (the mean of V), as on the TPU. Keys past Sk
// (the ragged last step) score -inf and take no weight at all. Sums are fp32
// for both input types.
//
// Grid (ceil(Sq / (16 RG)), H, B), 128 threads; no allocation, launches on
// the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using vrl::cp_async16;
using vrl::cp_async4;
using vrl::cp_async_commit;
using vrl::cp_async_wait;
using vrl::Mma;
using vrl::quad_max;
using vrl::quad_sum;
using vrl::stage_rows;
using vrl::store2;

constexpr int kStep = 64;     // keys a step stages
constexpr int kThreads = 128;  // four warps
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // -0.7 * fp32 max

template <int D, typename T, int RG>
struct Smem {
  static constexpr int kLd = D + (sizeof(T) == 4 ? 4 : 8);  // padded row, elements
  static constexpr int kRow = kLd * sizeof(T);               // bytes a row
  static constexpr int kQ = 16 * RG * kRow;
  static constexpr int kBuf = 2 * kStep * kRow + kStep * 4;  // K, V, mask
  static constexpr int kBytes = kQ + 2 * kBuf;
  static_assert(kRow % 16 == 0, "cp.async needs 16-byte rows");
};

template <int D, typename T, int RG>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int H, int Sq,
                     int Sk, float scale) {
  using M = Mma<T>;
  using L = Smem<D, T, RG>;
  constexpr int kLd = L::kLd;
  constexpr int kSlices = 4 / RG;        // ways each step's keys are split
  constexpr int kKw = kStep / kSlices;   // keys a warp takes a step
  constexpr int kN = kKw / 8;            // score tiles of 8 keys
  constexpr int kO = D / 8;              // output tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  auto kbuf = [&](int b) { return reinterpret_cast<T*>(smem + L::kQ + b * L::kBuf); };
  auto vbuf = [&](int b) { return kbuf(b) + kStep * kLd; };
  auto mbuf = [&](int b) {
    return reinterpret_cast<float*>(smem + L::kQ + b * L::kBuf + 2 * kStep * L::kRow);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % RG, h = warp / RG, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * 16 * RG;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const float* mb = mask ? mask + (size_t)blockIdx.z * Sk : nullptr;

  stage_rows<D, 16 * RG, L::kLd, kThreads>(Qs, q + bh * Sq * D, q0, Sq);
  auto stage = [&](int b, int key0) {
    stage_rows<D, kStep, L::kLd, kThreads>(kbuf(b), kb, key0, Sk);
    stage_rows<D, kStep, L::kLd, kThreads>(vbuf(b), vb, key0, Sk);
    if (mb != nullptr) {
      for (int i = threadIdx.x; i < kStep; i += kThreads) {
        const bool in = key0 + i < Sk;
        cp_async4(mbuf(b) + i, in ? mb + key0 + i : mb, in);
      }
    }
  };
  stage(0, 0);
  cp_async_commit();

  typename M::A qf[D / M::kK];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float o[kO][4];
#pragma unroll
  for (int n = 0; n < kO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int steps = (Sk + kStep - 1) / kStep;
  for (int it = 0; it < steps; ++it) {
    const int b = it & 1;
    if (it + 1 < steps) {
      stage(b ^ 1, (it + 1) * kStep);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {  // the Q tile landed with the first step
#pragma unroll
      for (int kk = 0; kk < D / M::kK; ++kk) qf[kk] = M::rows_a(Qs, kLd, 16 * rg, kk * M::kK);
    }
    const T* Kt = kbuf(b) + h * kKw * kLd;
    const T* Vt = vbuf(b) + h * kKw * kLd;
    const float* mt = mbuf(b) + h * kKw;
    const int key0 = it * kStep + h * kKw;

    // S = Q K^T over this warp's keys of the step: 16 rows x kKw keys
    float s[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / M::kK; ++kk)
#pragma unroll
      for (int j = 0; j < kN; ++j) M::mma(s[j], qf[kk], M::rows_b(Kt, kLd, 8 * j, kk * M::kK));

    // scale and mask; the running max of rows g and g + 8
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const bool past = key0 + col >= Sk;
        const bool masked = mb != nullptr && mt[col] == 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[j][2 * i + c];
          x = past ? -CUDART_INF_F : (masked ? kNegInf : x * scale);
          mx[i] = fmaxf(mx[i], x);
        }
      }
    // online softmax: a row whose keys so far are all past Sk keeps m = -inf,
    // l = 0 and O = 0 (its exponent base is taken as 0, exp(-inf) = 0)
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      base[i] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[i] = __expf(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - base[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    // O = alpha O + P V, P from the score accumulators. The step's P V is
    // summed on the tensor cores from zero and added to O on the CUDA cores,
    // whose adds round to nearest: a tensor-core sum carried over 6000 keys
    // drifts by ~1e-5 of |O| (chip_smoke's Sk 6000 case)
    float pv[kO][4];
#pragma unroll
    for (int n = 0; n < kO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKw / M::kK; ++kk) {
      const typename M::A ap = M::acc_a(s, kk);
#pragma unroll
      for (int n = 0; n < kO; ++n) M::mma(pv[n], ap, M::cols_b(Vt, kLd, kk * M::kK, 8 * n));
    }
#pragma unroll
    for (int n = 0; n < kO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] * alpha[e >> 1] + pv[n][e];
    __syncthreads();  // buffer b is free for step it + 2
  }

  // each lane summed its own columns of a row: add the quad's
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (kSlices > 1) {
    // merge the slices' (m, l, O) in slice order through the idle buffers
    constexpr int kVals = 4 + 4 * kO;  // m, l of two rows, then O
    float* red = reinterpret_cast<float*>(smem + L::kQ);
    if (h > 0) {
      float* dst = red + ((h - 1) * RG + rg) * kVals * 32 + lane;
      dst[0] = m[0];
      dst[32] = m[1];
      dst[64] = l[0];
      dst[96] = l[1];
#pragma unroll
      for (int n = 0; n < kO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(4 + 4 * n + e) * 32] = o[n][e];
    }
    __syncthreads();
    if (h > 0) return;
    float top[2] = {m[0], m[1]};
    for (int w = 1; w < kSlices; ++w) {
      const float* src = red + ((w - 1) * RG + rg) * kVals * 32 + lane;
      top[0] = fmaxf(top[0], src[0]);
      top[1] = fmaxf(top[1], src[32]);
    }
    // slice 0 saw key 0 (< Sk), so top is finite
    float f[2] = {__expf(m[0] - top[0]), __expf(m[1] - top[1])};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] *= f[i];
#pragma unroll
      for (int n = 0; n < kO; ++n) {
        o[n][2 * i] *= f[i];
        o[n][2 * i + 1] *= f[i];
      }
    }
    for (int w = 1; w < kSlices; ++w) {
      const float* src = red + ((w - 1) * RG + rg) * kVals * 32 + lane;
      f[0] = __expf(src[0] - top[0]);
      f[1] = __expf(src[32] - top[1]);
      l[0] += src[64] * f[0];
      l[1] += src[96] * f[1];
#pragma unroll
      for (int n = 0; n < kO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += src[(4 + 4 * n + e) * 32] * f[e >> 1];
    }
    m[0] = top[0];
    m[1] = top[1];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 16 * rg + g + 8 * i;
    if (r < Sq) {
      const float inv = 1.f / l[i];
      T* orow = out + (bh * Sq + r) * D;
#pragma unroll
      for (int n = 0; n < kO; ++n)
        store2(orow + 8 * n + 2 * t, o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      if (t == 0) lse[bh * Sq + r] = m[i] + logf(l[i]);
    }
  }
}

template <int D, typename T, int RG>
cudaError_t launch_rg(const void* q, const void* k, const void* v, const void* mask,
                      void* out, void* lse, int B, int H, int Sq, int Sk, float scale,
                      cudaStream_t stream) {
  constexpr int smem = Smem<D, T, RG>::kBytes;
  auto kernel = flash_fwd_mma_kernel<D, T, RG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 16 * RG - 1) / (16 * RG), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(lse), H, Sq,
      Sk, scale);
  return cudaGetLastError();
}

// RG: the most 16-row groups a block that still gives at least 1.5 blocks an
// SM, else 1 (the keys split four ways). A probe on the H100 put the turn
// there: 32-row blocks lose to 16-row ones at 128 blocks ((2, 8, 240, 32))
// and win at 256 ((1, 8, 1000, 32)); 64-row blocks lose at 192 ((2, 8, 720,
// 32)).
template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int B, int H, int Sq, int Sk, float scale, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)B * H;
  auto blocks = [&](int rg) { return pairs * ((Sq + 16 * rg - 1) / (16 * rg)); };
  if (2 * blocks(4) >= 3LL * sms)
    return launch_rg<D, T, 4>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, stream);
  if (2 * blocks(2) >= 3LL * sms)
    return launch_rg<D, T, 2>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, stream);
  return launch_rg<D, T, 1>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a head width, dtype or length the kernel does not
// take.
int vrl_flash_attn_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* lse, int B, int H,
                       int Sq, int Sk, int D, int dtype, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq < 1 || Sk < 1) return cudaErrorInvalidValue;
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

}  // extern "C"

VRL_ERROR_STRING_EXPORT

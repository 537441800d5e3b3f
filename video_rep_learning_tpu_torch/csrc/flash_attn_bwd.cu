// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of masked
// softmax(q k^T * scale) v from the forward's log-sum-exp, never
// materialising the (Sq, Sk) score matrix.
//
// Replaces the TPU kernel `_fused_bwd_kernel` of
// video_rep_learning_tpu/ops/attention_pallas.py (and the XLA remat backward
// its streaming path took): one backward covers every key length.
//
// The math is the TPU kernel's: p = exp(s - lse) recomputed from the
// forward's LSE, delta = rowsum(dO * O), dv = p^T dO, dp = dO v^T,
// ds = p (dp - delta) scale, dq = ds k, dk = ds^T q. A masked key scores the
// finite NEG_INF, as in the forward, so a fully masked row keeps its p and
// contributes to dv (and, as on the TPU, to dq and dk); keys past Sk take
// p = 0. With bf16 inputs p is rounded to bf16 before p^T dO and ds before
// its two products, as the TPU kernel rounds them to the input type; every
// sum is fp32.
//
// What bounds it on the H100. The CARL step calls it at (2, 8, 240, 32) and
// the MV-Former encoder at (2, 8, 720, 32), both fp32: 0.02-0.2 GFLOP over
// 16 (batch, head) pairs, far too little work to fill 132 SMs with 64-row
// tiles, so latency and the card's fill bound it, not tensor-core or HBM
// throughput. The design:
// - One launch of two block roles, with no atomics and no second pass:
//   blocks [0, n_kv) own 32 keys each, walk every q row and write dk, dv;
//   blocks [n_kv, n_kv + n_q) own 32 q rows each, walk every key and write
//   dq. Each role recomputes s and dp. That is (8 + 8) x 16 = 256 blocks of
//   four warps at (2, 8, 240, 32).
// - The four warps of a block are two row groups of 16 owned rows times two
//   halves of each 64-row step of the walk; the halves' partial sums are
//   added in a fixed order (half 0 + half 1) through shared memory at the
//   end, so every output is deterministic.
// - delta is folded in: the dk/dv role stages the O tile beside dO and each
//   lane sums its row's dO * O; the dq role does the same once for its own
//   rows. No scratch tensor, no pre-pass.
// - Every product is on the tensor cores through mma.sync (`mma.cuh`): bf16
//   as m16n8k16; fp32 as 3xTF32 m16n8k8 (each operand split into a tf32 hi and
//   lo, and hi*lo' + lo*hi' + hi*hi' summed in fp32), which keeps about
//   fp32's accuracy where one TF32 product would lose ~3 digits. The
//   accumulators of s^T / p^T (keys as rows) are the A operand of p^T dO and
//   ds^T q straight from registers, with no trip through shared memory; for
//   TF32 that fixes the k order of those products at (2t, 2t + 1), which the
//   B operand follows (`cols_b`).
// - The walked tiles are double buffered with cp.async: step i + 1 lands
//   while step i computes. Shared-memory rows are padded (fp32: D + 4, bf16:
//   D + 8 elements) so that both the row and the column fragment reads are
//   free of bank conflicts.
//
// Layout: q, dO, out (B, H, Sq, D), k, v (B, H, Sk, D), contiguous and
// 16-byte aligned, fp32 or bf16; mask (B, Sk) fp32 or null; lse (B, H, Sq)
// fp32. Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using vrl::cp_async16;
using vrl::cp_async4;
using vrl::cp_async_commit;
using vrl::cp_async_wait;
using vrl::Mma;
using vrl::stage_rows;
using vrl::store2;
using vrl::to_f32;

constexpr int kOwn = 32;          // rows a block owns: keys or q rows
constexpr int kHalf = 32;         // rows of the walk a warp takes a step
constexpr int kStep = 2 * kHalf;  // rows of the walk a step stages
constexpr int kThreads = 128;     // 2 row groups x 2 halves
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // -0.7 * fp32 max

// --- shared memory ----------------------------------------------------------

template <int D, typename T>
struct Smem {
  static constexpr int kLd = D + (sizeof(T) == 4 ? 4 : 8);  // padded row, elements
  static constexpr int kTile = kLd * sizeof(T);              // bytes a row
  // dk/dv role: K, V owned; Q, dO, O and lse walked, two buffers
  static constexpr int kKvStep = 3 * kStep * kTile + kStep * 4;
  static constexpr int kKv = 2 * kOwn * kTile + 2 * kKvStep;
  // dq role: Q, dO, O owned; K, V and the mask walked, two buffers
  static constexpr int kQStep = 2 * kStep * kTile + kStep * 4;
  static constexpr int kQ = 3 * kOwn * kTile + 2 * kQStep;
  static constexpr int kBytes = kKv > kQ ? kKv : kQ;
  static_assert(kTile % 16 == 0, "cp.async needs 16-byte rows");
};

// Values [r0, r0 + kStep) of an fp32 vector, zero past n.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < kStep; i += kThreads) {
    const bool in = r0 + i < n;
    cp_async4(dst + i, in ? src + r0 + i : src, in);
  }
}

// rowsum(dO * O) of shared row `r`, the columns rotated by the row so that
// the lanes of a warp read different banks.
template <int D, typename T>
__device__ __forceinline__ float row_delta(const T* dO, const T* O, int r) {
  constexpr int kLd = Smem<D, T>::kLd;
  const T* a = dO + r * kLd;
  const T* b = O + r * kLd;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < D; ++i) {
    const int c = (i + r) & (D - 1);
    acc = fmaf(to_f32(a[c]), to_f32(b[c]), acc);
  }
  return acc;
}

__device__ __forceinline__ float probability(float s, float flag, float lse, float scale) {
  // flag 1: an attended key; 0: masked, scores NEG_INF; -1: past Sk
  return flag > 0.f ? __expf(s * scale - lse) : (flag == 0.f ? __expf(kNegInf - lse) : 0.f);
}

// After the walk: the half-1 warps hand their accumulators to the half-0
// warps of the same row group, which add them (half 0 + half 1, a fixed
// order) into `acc`. `red` is the walk's (now idle) shared memory.
template <int N>
__device__ __forceinline__ void sum_halves(float (&acc)[N][4], float* red, int rg, int h) {
  const int lane = threadIdx.x & 31;
  __syncthreads();  // every warp is past its last read of the walk's tiles
  if (h == 1) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[((4 * j + e) * 2 + rg) * 32 + lane] = acc[j][e];
  }
  __syncthreads();
  if (h == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += red[((4 * j + e) * 2 + rg) * 32 + lane];
  }
}

// Rows rg * 16 + g (+ 8) of a 16 x D accumulator into out rows r0 + ..., up
// to n.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (*acc)[4], int r0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r < n) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(out + (size_t)r * D + 8 * j + 2 * t, acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// --- the dk / dv role: 32 keys owned, every q row walked ------------------

template <int D, typename T>
__device__ __forceinline__ void dkdv_role(unsigned char* smem, const T* q, const T* k,
                                          const T* v, const float* mask, const T* out,
                                          const T* dout, const float* lse, T* dk, T* dv,
                                          int k0, int Sq, int Sk, float scale) {
  using M = Mma<T>;
  using L = Smem<D, T>;
  constexpr int kLd = L::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 1, h = warp >> 1, g = lane >> 2, t = lane & 3;

  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kOwn * kLd;
  unsigned char* walk = reinterpret_cast<unsigned char*>(Vs + kOwn * kLd);
  auto buf = [&](int b, int i) {  // i: 0 Q, 1 dO, 2 O
    return reinterpret_cast<T*>(walk + b * L::kKvStep) + i * kStep * kLd;
  };
  auto lse_buf = [&](int b) {
    return reinterpret_cast<float*>(walk + b * L::kKvStep + 3 * kStep * L::kTile);
  };

  stage_rows<D, kOwn, L::kLd, kThreads>(Ks, k, k0, Sk);
  stage_rows<D, kOwn, L::kLd, kThreads>(Vs, v, k0, Sk);
  auto stage = [&](int b, int q0) {
    stage_rows<D, kStep, L::kLd, kThreads>(buf(b, 0), q, q0, Sq);
    stage_rows<D, kStep, L::kLd, kThreads>(buf(b, 1), dout, q0, Sq);
    stage_rows<D, kStep, L::kLd, kThreads>(buf(b, 2), out, q0, Sq);
    stage_vec(lse_buf(b), lse, q0, Sq);
  };
  stage(0, 0);
  cp_async_commit();

  // the flags of this thread's two keys
  float flag[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + rg * 16 + g + 8 * i;
    flag[i] = key >= Sk ? -1.f : (mask == nullptr || mask[key] != 0.f) ? 1.f : 0.f;
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  const int steps = (Sq + kStep - 1) / kStep;
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
    const T* Qt = buf(b, 0) + h * kHalf * kLd;
    const T* dOt = buf(b, 1) + h * kHalf * kLd;
    const T* Ot = buf(b, 2) + h * kHalf * kLd;
    // s^T and dp^T: 16 keys x this half's 32 q rows
    float s[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += M::kK) {
      const typename M::A ak = M::rows_a(Ks, kLd, rg * 16, kk);
      const typename M::A av = M::rows_a(Vs, kLd, rg * 16, kk);
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        M::mma(s[j], ak, M::rows_b(Qt, kLd, 8 * j, kk));
        M::mma(dp[j], av, M::rows_b(dOt, kLd, 8 * j, kk));
      }
    }
    // lane r holds q row r's LSE and delta; columns fetch theirs by shuffle
    const int r = lane & (kHalf - 1);
    const float lse_r = lse_buf(b)[h * kHalf + r];
    const float delta_r = row_delta<D, T>(dOt, Ot, r);
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const float l = __shfl_sync(0xffffffffu, lse_r, col);
        const float dl = __shfl_sync(0xffffffffu, delta_r, col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + c;
          const float p = probability(s[j][e], flag[i], l, scale);
          dp[j][e] = p * (dp[j][e] - dl) * scale;
          s[j][e] = p;
        }
      }
    // dv += p^T dO, dk += ds^T q over this half's 32 q rows
#pragma unroll
    for (int kk = 0; kk < kHalf / M::kK; ++kk) {
      const typename M::A ap = M::acc_a(s, kk);
      const typename M::A ad = M::acc_a(dp, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        M::mma(acc_v[n], ap, M::cols_b(dOt, kLd, kk * M::kK, 8 * n));
        M::mma(acc_k[n], ad, M::cols_b(Qt, kLd, kk * M::kK, 8 * n));
      }
    }
    __syncthreads();  // buffer b is free for step it + 2
  }

  float* red = reinterpret_cast<float*>(walk);
  sum_halves(acc_k, red, rg, h);
  sum_halves(acc_v, red, rg, h);
  if (h == 0) {
    store_rows<D, T>(dk, acc_k, k0 + rg * 16, Sk);
    store_rows<D, T>(dv, acc_v, k0 + rg * 16, Sk);
  }
}

// --- the dq role: 32 q rows owned, every key walked -----------------------

template <int D, typename T>
__device__ __forceinline__ void dq_role(unsigned char* smem, const T* q, const T* k,
                                        const T* v, const float* mask, const T* out,
                                        const T* dout, const float* lse, T* dq, int q0,
                                        int Sq, int Sk, float scale) {
  using M = Mma<T>;
  using L = Smem<D, T>;
  constexpr int kLd = L::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 1, h = warp >> 1, g = lane >> 2, t = lane & 3;

  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kOwn * kLd;
  T* Os = dOs + kOwn * kLd;
  unsigned char* walk = reinterpret_cast<unsigned char*>(Os + kOwn * kLd);
  auto buf = [&](int b, int i) {  // i: 0 K, 1 V
    return reinterpret_cast<T*>(walk + b * L::kQStep) + i * kStep * kLd;
  };
  auto mask_buf = [&](int b) {
    return reinterpret_cast<float*>(walk + b * L::kQStep + 2 * kStep * L::kTile);
  };

  stage_rows<D, kOwn, L::kLd, kThreads>(Qs, q, q0, Sq);
  stage_rows<D, kOwn, L::kLd, kThreads>(dOs, dout, q0, Sq);
  stage_rows<D, kOwn, L::kLd, kThreads>(Os, out, q0, Sq);
  auto stage = [&](int b, int key0) {
    stage_rows<D, kStep, L::kLd, kThreads>(buf(b, 0), k, key0, Sk);
    stage_rows<D, kStep, L::kLd, kThreads>(buf(b, 1), v, key0, Sk);
    if (mask != nullptr) stage_vec(mask_buf(b), mask, key0, Sk);
  };
  stage(0, 0);
  cp_async_commit();

  // this thread's two q rows: the forward's LSE (0 past Sq, where dO and q
  // are zero and p, ds contribute nothing)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rg * 16 + g + 8 * i;
    lse_r[i] = r < Sq ? lse[r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

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
    if (it == 0) {  // the owned tiles landed with the first step
      const float d = row_delta<D, T>(dOs, Os, rg * 16 + (lane & 15));
      delta_r[0] = __shfl_sync(0xffffffffu, d, g);
      delta_r[1] = __shfl_sync(0xffffffffu, d, g + 8);
    }
    const int key0 = it * kStep + h * kHalf;
    const T* Kt = buf(b, 0) + h * kHalf * kLd;
    const T* Vt = buf(b, 1) + h * kHalf * kLd;
    const float* mt = mask_buf(b) + h * kHalf;
    // s and dp: 16 q rows x this half's 32 keys
    float s[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += M::kK) {
      const typename M::A aq = M::rows_a(Qs, kLd, rg * 16, kk);
      const typename M::A ao = M::rows_a(dOs, kLd, rg * 16, kk);
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        M::mma(s[j], aq, M::rows_b(Kt, kLd, 8 * j, kk));
        M::mma(dp[j], ao, M::rows_b(Vt, kLd, 8 * j, kk));
      }
    }
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const float flag = key0 + col >= Sk ? -1.f
                           : (mask == nullptr || mt[col] != 0.f) ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + c;
          const float p = probability(s[j][e], flag, lse_r[i], scale);
          dp[j][e] = p * (dp[j][e] - delta_r[i]) * scale;
        }
      }
    // dq += ds k over this half's 32 keys
#pragma unroll
    for (int kk = 0; kk < kHalf / M::kK; ++kk) {
      const typename M::A ad = M::acc_a(dp, kk);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) M::mma(acc[n], ad, M::cols_b(Kt, kLd, kk * M::kK, 8 * n));
    }
    __syncthreads();  // buffer b is free for step it + 2
  }

  sum_halves(acc, reinterpret_cast<float*>(walk), rg, h);
  if (h == 0) store_rows<D, T>(dq, acc, q0 + rg * 16, Sq);
}

// Blocks [0, n_kv) take the dk / dv role, the rest the dq role; y is the
// head, z the batch row.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, const T* __restrict__ out,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int H,
                     int Sq, int Sk, int n_kv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const size_t qo = bh * Sq * D, ko = bh * Sk * D;
  const float* mb = mask ? mask + (size_t)blockIdx.z * Sk : nullptr;
  if ((int)blockIdx.x < n_kv)
    dkdv_role<D, T>(smem, q + qo, k + ko, v + ko, mb, out + qo, dout + qo, lse + bh * Sq,
                    dk + ko, dv + ko, blockIdx.x * kOwn, Sq, Sk, scale);
  else
    dq_role<D, T>(smem, q + qo, k + ko, v + ko, mb, out + qo, dout + qo, lse + bh * Sq,
                  dq + qo, (blockIdx.x - n_kv) * kOwn, Sq, Sk, scale);
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   const void* out, const void* dout, const void* lse, void* dq, void* dk,
                   void* dv, int B, int H, int Sq, int Sk, float scale, cudaStream_t stream) {
  constexpr int smem = Smem<D, T>::kBytes;
  auto kernel = flash_bwd_mma_kernel<D, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_kv = (Sk + kOwn - 1) / kOwn, n_q = (Sq + kOwn - 1) / kOwn;
  kernel<<<dim3(n_kv + n_q, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, n_kv, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a head width or dtype the kernel does not take.
int vrl_flash_attn_bwd(const void* q, const void* k, const void* v, const void* mask,
                       const void* out, const void* dout, const void* lse, void* dq,
                       void* dk, void* dv, int B, int H, int Sq, int Sk, int D, int dtype,
                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq < 1 || Sk < 1) return cudaErrorInvalidValue;
  if (dtype == 0 && D == 32)
    return launch<32, float>(q, k, v, mask, out, dout, lse, dq, dk, dv, B, H, Sq, Sk, scale, s);
  if (dtype == 0 && D == 64)
    return launch<64, float>(q, k, v, mask, out, dout, lse, dq, dk, dv, B, H, Sq, Sk, scale, s);
  if (dtype == 1 && D == 32)
    return launch<32, __nv_bfloat16>(q, k, v, mask, out, dout, lse, dq, dk, dv, B, H, Sq, Sk,
                                     scale, s);
  if (dtype == 1 && D == 64)
    return launch<64, __nv_bfloat16>(q, k, v, mask, out, dout, lse, dq, dk, dv, B, H, Sq, Sk,
                                     scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

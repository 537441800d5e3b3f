// The variants of packed ViT self-attention that the TPU micro-benchmarks
// compare, for Hopper (sm_90a): out[b, n, h*64:(h+1)*64] = softmax(q_h k_h^T
// * scale) v_h read straight from the packed (B, N, 3D) qkv, as
// packed_attn.cu does, with each variant's own softmax and rounding.
//
// Replaces the TPU kernels `_kernel_var` (tools/bench_packed_attn.py:57,
// `build_variant`), `_kernel_multi_img` (:96, `build_multi`), `_kernel_grouped`
// and `_kernel_rowtile` (tools/bench_attn_variants.py:54, :72, `build`). Their
// flags map onto template flags and launch arguments:
//   EXP2   log2(e) folded into the scale, exp2 in place of exp;
//   NOMAX  the max-free softmax of `_softmax` (bench_packed_attn.py:43):
//          p = exp2(min(s, 110)) (exp(min(s, 76)) without EXP2), no row max,
//          so one pass over the keys with no rescale of the accumulator and
//          the row sum l reduced once at the end;
//          without it, the exact max-subtracted softmax, online over 64-key
//          tiles (the TPU subtracts the full-row max at once);
//   BF16P  l sums p rounded to bf16 (`build_multi(bf16p=True)`); otherwise l
//          sums the fp32 p. P is rounded to bf16 before P.V in every form;
//   BQ     query rows a block: 64, or 256 for `rowtile`, whose K and V tiles
//          are loaded once for all 256 rows (four 64-row sub-tiles);
//   heads_per_block (1, 2, 12) and images_per_block (1, 2, 4): the heads and
//          images one block walks in turn (the TPU's head pairs a program and
//          `imgs`); they set the schedule, not the values.
// Rounding against the TPU's one-shot softmax: with the max subtracted, a
// tile's p is rounded against the running max and rescaled in fp32 later,
// so a value may land a bf16 ulp from the one-shot form; the max-free forms
// round the same p at the same point.
//
// What bounds it on the H100: operations, 4 N^2 dh a head and image (75.7
// GFLOP at 40 x 12 heads x 785 tokens x 64). This first version keeps
// packed_attn.cu's layout: fp32 FMA on CUDA cores, a 4x4 register micro-tile
// of scores a thread, K and V streamed through shared memory in 64-key
// tiles. Tensor cores come with #4's redesign.
//
// qkv (B, N, 3D) and out (B, N, D), contiguous bf16, D = H * 64. No
// allocation; launches on the caller's stream and returns cudaGetLastError().

#include <math_constants.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kDH = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kQS = kDH + 1;      // padded Q / K rows
constexpr int kPS = kBlockK + 1;  // padded P rows
constexpr int kCols = kDH / 16;   // output columns a thread

template <int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * kQS + kBlockK * kQS + kBlockK * kDH + 64 * kPS + kBlockK);
}

template <bool EXP2>
__device__ __forceinline__ float expo(float x) {
  return EXP2 ? exp2f(x) : expf(x);
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Thread t owns rows tr + 16*i (i < 4) of each 64-row sub-tile and keys
// tc + 16*j (j < 4) of each key tile, tr = t / 16, tc = t % 16; its output
// columns are tc + 16*c (c < 4).
template <bool EXP2, bool NOMAX, bool BF16P, int BQ>
__global__ void __launch_bounds__(kThreads)
attn_variant_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int H,
                    int N, float scale, int heads_per_block, int images_per_block) {
  constexpr int kSub = BQ / 64;
  constexpr float kClamp = EXP2 ? 110.f : 76.f;  // the TPU's, in its units
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * kQS;
  float* Vs = Ks + kBlockK * kQS;
  float* Ps = Vs + kBlockK * kDH;
  float* valid = Ps + 64 * kPS;

  const int D = H * kDH;
  const size_t row3 = 3 * (size_t)D;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * BQ;

  for (int ii = 0; ii < images_per_block; ++ii) {
    const int b = blockIdx.z * images_per_block + ii;
    for (int hh = 0; hh < heads_per_block; ++hh) {
      const int h = blockIdx.y * heads_per_block + hh;
      const bf16* base = qkv + (size_t)b * N * row3 + h * kDH;
      bf16* ob = out + (size_t)b * N * D + h * kDH;

      __syncthreads();  // the previous head's reads of Qs are done
      for (int i = tid; i < BQ * kDH; i += kThreads) {
        const int r = i / kDH, c = i % kDH;
        Qs[r * kQS + c] = (q0 + r < N) ? vrl::to_f32(base[(q0 + r) * row3 + c]) : 0.f;
      }

      float m[kSub][4], l[kSub][4], o[kSub][4][kCols];
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          m[u][i] = -CUDART_INF_F;
          l[u][i] = 0.f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) o[u][i][c] = 0.f;
        }

      for (int k0 = 0; k0 < N; k0 += kBlockK) {
        __syncthreads();  // the previous tile's reads of Ks/Vs/Ps are done
        for (int i = tid; i < kBlockK * kDH; i += kThreads) {
          const int r = i / kDH, c = i % kDH;
          const bool in = k0 + r < N;
          const bf16* kv = base + (k0 + r) * row3 + c;
          Ks[r * kQS + c] = in ? vrl::to_f32(kv[D]) : 0.f;
          Vs[r * kDH + c] = in ? vrl::to_f32(kv[2 * D]) : 0.f;
        }
        if (tid < kBlockK) valid[tid] = k0 + tid < N ? 1.f : 0.f;
        __syncthreads();
        const int kn = min(kBlockK, N - k0);

#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          float s[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
          for (int d = 0; d < kDH; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(u * 64 + tr + 16 * i) * kQS + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * kQS + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = valid[tc + 16 * j] > 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][j] = in ? s[i][j] * scale : -CUDART_INF_F;
          }

#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (NOMAX) {
              // this thread's part of l; the 16 lanes of a row add up once
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float p = expo<EXP2>(fminf(s[i][j], kClamp));
                const float pr = vrl::round_to<bf16>(p);
                l[u][i] += BF16P ? pr : p;
                s[i][j] = pr;
              }
            } else {
              // online softmax: every tile holds a key < N, so the running
              // max is finite after the first tile and expo(-inf - m) is 0
              float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
              for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
              const float m_new = fmaxf(m[u][i], mx);
              const float alpha = expo<EXP2>(m[u][i] - m_new);
              float rs = 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float p = expo<EXP2>(s[i][j] - m_new);
                const float pr = vrl::round_to<bf16>(p);
                rs += BF16P ? pr : p;
                s[i][j] = pr;
              }
              l[u][i] = l[u][i] * alpha + row_sum16(rs);
              m[u][i] = m_new;
#pragma unroll
              for (int c = 0; c < kCols; ++c) o[u][i][c] *= alpha;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) Ps[(tr + 16 * i) * kPS + tc + 16 * j] = s[i][j];
          }
          __syncthreads();

          for (int key = 0; key < kn; ++key) {
            float pv[4], vv[kCols];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * kPS + key];
#pragma unroll
            for (int c = 0; c < kCols; ++c) vv[c] = Vs[key * kDH + tc + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < kCols; ++c) o[u][i][c] = fmaf(pv[i], vv[c], o[u][i][c]);
          }
          if (u + 1 < kSub) __syncthreads();  // Ps is refilled by the next sub-tile
        }
      }

#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float li = NOMAX ? row_sum16(l[u][i]) : l[u][i];
          const int r = q0 + u * 64 + tr + 16 * i;
          if (r < N) {
            bf16* orow = ob + (size_t)r * D;
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              orow[tc + 16 * c] = vrl::from_f32<bf16>(o[u][i][c] / li);
          }
        }
    }
  }
}

template <bool EXP2, bool NOMAX, bool BF16P, int BQ>
cudaError_t launch(const void* qkv, void* out, int B, int H, int N, float scale,
                   int hpb, int ipb, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BQ>();
  auto kernel = attn_variant_kernel<EXP2, NOMAX, BF16P, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, H / hpb, B / ipb);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(qkv),
                                           static_cast<bf16*>(out), H, N, scale,
                                           hpb, ipb);
  return cudaGetLastError();
}

template <bool EXP2, bool NOMAX, bool BF16P>
cudaError_t by_block_q(int block_q, const void* qkv, void* out, int B, int H, int N,
                       float scale, int hpb, int ipb, cudaStream_t s) {
  if (block_q == 64) return launch<EXP2, NOMAX, BF16P, 64>(qkv, out, B, H, N, scale, hpb, ipb, s);
  if (block_q == 256) return launch<EXP2, NOMAX, BF16P, 256>(qkv, out, B, H, N, scale, hpb, ipb, s);
  return cudaErrorInvalidValue;
}

template <bool EXP2, bool NOMAX>
cudaError_t by_bf16p(int bf16p, int block_q, const void* qkv, void* out, int B, int H,
                     int N, float scale, int hpb, int ipb, cudaStream_t s) {
  return bf16p ? by_block_q<EXP2, NOMAX, true>(block_q, qkv, out, B, H, N, scale, hpb, ipb, s)
               : by_block_q<EXP2, NOMAX, false>(block_q, qkv, out, B, H, N, scale, hpb, ipb, s);
}

}  // namespace

extern "C" {

// exp2, nomax, bf16p: 0 or 1; block_q 64 or 256; H % heads_per_block == 0,
// B % images_per_block == 0. `scale` is the TPU kernel's: 1/sqrt(64), times
// log2(e) with exp2. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a shape or flag the kernel does not take.
int vrl_packed_attn_variant(const void* qkv, void* out, int B, int H, int N, int exp2,
                            int nomax, int bf16p, int block_q, int heads_per_block,
                            int images_per_block, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || N <= 0 || heads_per_block <= 0 || images_per_block <= 0 ||
      H % heads_per_block || B % images_per_block || B / images_per_block > 65535 ||
      H / heads_per_block > 65535)
    return cudaErrorInvalidValue;
  const int hpb = heads_per_block, ipb = images_per_block;
  if (exp2 && nomax) return by_bf16p<true, true>(bf16p, block_q, qkv, out, B, H, N, scale, hpb, ipb, s);
  if (exp2) return by_bf16p<true, false>(bf16p, block_q, qkv, out, B, H, N, scale, hpb, ipb, s);
  if (nomax) return by_bf16p<false, true>(bf16p, block_q, qkv, out, B, H, N, scale, hpb, ipb, s);
  return by_bf16p<false, false>(bf16p, block_q, qkv, out, B, H, N, scale, hpb, ipb, s);
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

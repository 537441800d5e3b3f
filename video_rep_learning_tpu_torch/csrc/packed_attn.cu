// Multi-head self-attention straight from the packed qkv projection, for
// Hopper (sm_90a): out[b, n, h*dh:(h+1)*dh] = softmax(q_h k_h^T * scale) v_h,
// reading q, k and v at their offsets in the (B, N, 3D) rows and writing
// (B, N, D), with no head transposes and no copies.
//
// Replaces the TPU kernel `_packed_kernel` of
// video_rep_learning_tpu/ops/attention_pallas.py (`packed_vit_attention`),
// which the ViT attention half-block runs in every block.
//
// Softmax: the exact max-subtracted one, online over 64-key tiles. The TPU
// kernel's max-free exp2 with a clamp (`_NOMAX_CLAMP`) is the same function
// for |logits| <= ~76, which LayerNormed ViT activations stay well under.
// Rounding follows the TPU kernel: with bf16 input the probabilities are
// rounded to bf16 before P.V (here each tile's exp(s - running max), there
// the clamped exp2), sums are fp32, the output is rounded once.
//
// What bounds it on the H100: operations (4 N^2 dh a head: 75.7 GFLOP at the
// MV-Former chunk of 40 x 12 heads x 785 tokens x 64). This first version is
// simple and right: one block per (image, head, 64-query tile), K and V
// streamed through shared memory in 64-key tiles, fp32 FMA on CUDA cores with
// a 4x4 register micro-tile of scores a thread (the layout of
// flash_attn_fwd.cu). N = 785 leaves ragged last q and k tiles: keys past N
// score -inf, queries past N are not stored. Tensor cores come later.
//
// qkv (B, N, 3D) and out (B, N, D), contiguous, fp32 or bf16, D = H * dh with
// dh 32 or 64. No allocation; launches on the caller's stream and returns
// cudaGetLastError().

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to DH+1 floats a row, V unpadded, P padded to BK+1,
  // plus one validity flag per key of the tile.
  return sizeof(float) * (kBlockQ * (DH + 1) + kBlockK * (DH + 1) + kBlockK * DH +
                          kBlockQ * (kBlockK + 1) + kBlockK);
}

// Thread t owns rows tr + 16*i (i < 4) of the q tile and keys tc + 16*j
// (j < 4) of each k tile, with tr = t / 16 and tc = t % 16; its output columns
// are tc + 16*c (c < DH/16). Row reductions are 4 xor-shuffles.
template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
packed_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out, int H, int N,
                   float scale) {
  constexpr int kQS = DH + 1;
  constexpr int kPS = kBlockK + 1;
  constexpr int kCols = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * kQS;
  float* Vs = Ks + kBlockK * kQS;
  float* Ps = Vs + kBlockK * DH;
  float* valid = Ps + kBlockQ * kPS;  // 1 in range, 0 past N

  const int D = H * DH;
  const size_t row3 = 3 * (size_t)D;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const T* base = qkv + (size_t)blockIdx.z * N * row3 + h * DH;  // q of head h
  T* ob = out + (size_t)blockIdx.z * N * D + h * DH;

  for (int i = tid; i < kBlockQ * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    Qs[r * kQS + c] = (q0 + r < N) ? vrl::to_f32(base[(q0 + r) * row3 + c]) : 0.f;
  }

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kBlockK) {
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps are done
    for (int i = tid; i < kBlockK * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      const bool in = k0 + r < N;
      const T* kv = base + (k0 + r) * row3 + c;
      Ks[r * kQS + c] = in ? vrl::to_f32(kv[D]) : 0.f;
      Vs[r * DH + c] = in ? vrl::to_f32(kv[2 * D]) : 0.f;
    }
    if (tid < kBlockK) valid[tid] = k0 + tid < N ? 1.f : 0.f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
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
      const bool in = valid[tc + 16 * j] > 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = in ? s[i][j] * scale : -CUDART_INF_F;
    }

    // Online softmax: every tile holds at least one key < N, so the running
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
      for (int j = 0; j < 4; ++j)
        Ps[(tr + 16 * i) * kPS + tc + 16 * j] = vrl::round_to<T>(s[i][j]);
    }
    __syncthreads();

    const int kn = min(kBlockK, N - k0);
    for (int key = 0; key < kn; ++key) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * kPS + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[key * DH + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    if (r < N) {
      const float inv = 1.f / l[i];
      T* orow = ob + (size_t)r * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) orow[tc + 16 * c] = vrl::from_f32<T>(o[i][c] * inv);
    }
  }
}

template <int DH, typename T>
cudaError_t launch(const void* qkv, void* out, int B, int H, int N, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kernel = packed_attn_kernel<DH, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                           static_cast<T*>(out), H, N, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a head width or dtype the kernel does not take.
int vrl_packed_attn(const void* qkv, void* out, int B, int H, int N, int dh,
                    int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return cudaErrorInvalidValue;
  if (dtype == 0 && dh == 32) return launch<32, float>(qkv, out, B, H, N, scale, s);
  if (dtype == 0 && dh == 64) return launch<64, float>(qkv, out, B, H, N, scale, s);
  if (dtype == 1 && dh == 32) return launch<32, __nv_bfloat16>(qkv, out, B, H, N, scale, s);
  if (dtype == 1 && dh == 64) return launch<64, __nv_bfloat16>(qkv, out, B, H, N, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

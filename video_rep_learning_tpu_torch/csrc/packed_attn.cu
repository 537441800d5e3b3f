// Multi-head self-attention straight from the packed qkv projection, for
// Hopper (sm_90a): out[b, n, h*dh:(h+1)*dh] = softmax(q_h k_h^T * scale) v_h,
// reading q, k and v at their offsets in the (B, N, 3D) rows and writing
// (B, N, D), with no head transposes and no copies.
//
// Replaces the TPU kernel `_packed_kernel` of
// video_rep_learning_tpu/ops/attention_pallas.py:485 (`packed_vit_attention`),
// which the ViT attention half-block runs in every block.
//
// bf16: the TPU kernel's arithmetic. s = q k^T of bf16 operands summed in
// fp32; by default the max-free softmax p = exp2(clip(s * scale * log2 e,
// -120, 110)) (`_NOMAX_CLAMP`, `_NOMAX_FLOOR`); l = the fp32 row sum of the
// unrounded p; o = bf16(p) v summed in fp32; out = o * (1 / l), rounded once.
// With MAXSUB (VRL_ATTN_MAXSUB=1, read by the wrapper at each call) the
// online max-subtracted form: p = exp2((s - running max) * scale * log2 e)
// a 64-key tile at a time, l and o rescaled when the max moves.
//
// What bounds it on the H100: operations, 4 N^2 dh a head: 75.7 GFLOP at
// the MV-Former chunk (40 images x 12 heads x 785 tokens, dh 64), 0.077 ms
// at the 989 TFLOP/s bf16 tensor-core peak, against 193 MB of qkv and out
// (0.058 ms at 3.35 TB/s). Both products run on the tensor cores:
//   - one block (one warpgroup, 128 threads) per (64 query rows, head,
//     image); consecutive blocks share a head, so its K and V stay in L2;
//   - one 3-D TMA tensor map over the packed (B, N, 3D) rows gives every
//     tile: boxes of (64 rows, dh) at column offsets h dh (q), D + h dh (k)
//     and 2D + h dh (v) of image b. Rows past N are zero-filled, so an image
//     never reads its neighbour; keys past N are masked to p = 0, query rows
//     past N are not stored. 128 B swizzle at dh 64, 64 B at dh 32;
//   - K and V tiles stream through a two-stage ring: thread 0 issues the
//     next tile's TMA before the block waits on the current one's mbarrier;
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//     (dh / 16 steps); the softmax runs on the accumulator registers, a
//     quad of lanes sharing each row;
//   - P is rounded to bf16 in registers and is wgmma's A operand for
//     O += P V (m64n{dh}k16, 4 steps of 16 keys): the accumulator layout of
//     S, packed in pairs, is the register-A layout, so P never touches
//     shared memory. V is the B operand read transposed (MN-major) from the
//     same swizzled tile;
//   - O stays in fp32 registers; each thread stores its bf16 pairs.
// Several blocks an SM (41 KB of shared memory each) overlap one block's
// softmax with another's products. ptxas -v (sm_90a): 90 / 95
// registers (dh 64, max-free / max-subtracted), 75 / 74 (dh 32), no stack,
// no spills; dynamic shared memory 42,008 B (dh 64: 1 KB alignment slack,
// Q, two K and two V tiles of 8 KB, three barriers) or 21,528 B (dh 32).
// The fp32 kernel: 80 / 64 registers (dh 64 / 32), no spills, 66,560 /
// 41,984 B of shared memory.
//
// fp32 stays on the CUDA cores in the online max-subtracted form (TF32 is
// not the same function): one block per (image, head, 64-query tile), K and
// V streamed through shared memory in 64-key tiles, fp32 FMA with a 4x4
// register micro-tile of scores a thread.
//
// qkv (B, N, 3D) and out (B, N, D), contiguous, fp32 or bf16 (16 B aligned),
// D = H * dh with dh 32 or 64. No allocation; launches on the caller's
// stream and returns cudaGetLastError() (or the tensor map's refusal).

#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace vrl::sm90;

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

// fp32. Thread t owns rows tr + 16*i (i < 4) of the q tile and keys tc + 16*j
// (j < 4) of each k tile, with tr = t / 16 and tc = t % 16; its output columns
// are tc + 16*c (c < DH/16). Row reductions are 4 xor-shuffles.
template <int DH>
__global__ void __launch_bounds__(kThreads)
packed_attn_kernel(const float* __restrict__ qkv, float* __restrict__ out, int H, int N,
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
  const float* base = qkv + (size_t)blockIdx.z * N * row3 + h * DH;  // q of head h
  float* ob = out + (size_t)blockIdx.z * N * D + h * DH;

  for (int i = tid; i < kBlockQ * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    Qs[r * kQS + c] = (q0 + r < N) ? base[(q0 + r) * row3 + c] : 0.f;
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
      const float* kv = base + (k0 + r) * row3 + c;
      Ks[r * kQS + c] = in ? kv[D] : 0.f;
      Vs[r * DH + c] = in ? kv[2 * D] : 0.f;
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
        Ps[(tr + 16 * i) * kPS + tc + 16 * j] = s[i][j];
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
      float* orow = ob + (size_t)r * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) orow[tc + 16 * c] = o[i][c] * inv;
    }
  }
}

// bf16 on the tensor cores (see the header). 128 threads, one warpgroup.
template <int DH>
__host__ __device__ constexpr int tile_bytes() { return kBlockQ * DH * 2; }
template <int DH>
constexpr size_t wgmma_smem_bytes() {
  return 1024 + 5 * tile_bytes<DH>() + 3 * sizeof(uint64_t);  // align, Q, K x2, V x2, bars
}

template <int DH, bool MAXSUB>
__global__ void __launch_bounds__(128)
packed_attn_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                         bf16* __restrict__ out, int H, int N, float scale_log2) {
  constexpr int kTile = tile_bytes<DH>();
  constexpr int kRow = DH * 2;          // bytes of a tile row: the swizzle span
  constexpr uint32_t kGroup = 8 * kRow;  // 8 rows: the descriptors' stride
  constexpr int kLayout = DH == 64 ? kSwizzle128 : kSwizzle64;
  constexpr int kO = DH / 2;            // O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + kTile;      // stage s at Ks + s * kTile
  unsigned char* Vs = smem + 3 * kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 5 * kTile);  // Q, stage 0, 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int nk = (N + kBlockQ - 1) / kBlockQ;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], kTile);
    tma_load_3d(Qs, &qkv_map, &bars[0], h * DH, q0, b);
    mbar_expect_tx(&bars[1], 2 * kTile);
    tma_load_3d(Ks, &qkv_map, &bars[1], D + h * DH, 0, b);
    tma_load_3d(Vs, &qkv_map, &bars[1], 2 * D + h * DH, 0, b);
  }

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;                          // rows r and r + 8
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;      // MAXSUB's running max
  const uint64_t dq = make_desc(Qs, kGroup, kGroup, kLayout);
  const int col = 2 * (lane & 3);                    // first key of a pair

  mbar_wait(&bars[0], 0);
  for (int j = 0; j < nk; ++j) {
    const int s = j & 1;
    if (tid == 0 && j + 1 < nk) {  // stage s ^ 1 was released at the end of j - 1
      uint64_t* bar = &bars[1 + (s ^ 1)];
      mbar_expect_tx(bar, 2 * kTile);
      tma_load_3d(Ks + (s ^ 1) * kTile, &qkv_map, bar, D + h * DH, (j + 1) * kBlockQ, b);
      tma_load_3d(Vs + (s ^ 1) * kTile, &qkv_map, bar, 2 * D + h * DH, (j + 1) * kBlockQ, b);
    }
    mbar_wait(&bars[1 + s], (j >> 1) & 1);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    const uint64_t dk = make_desc(Ks + s * kTile, kGroup, kGroup, kLayout);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<64>(sc, desc_add(dq, 32 * kk), desc_add(dk, 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int kn = N - j * kBlockQ;  // keys of this tile below N (>= 1)
    if constexpr (!MAXSUB) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fminf(fmaxf(sc[4 * jj + e] * scale_log2, -120.f), 110.f));
          p = 8 * jj + col + (e & 1) < kn ? p : 0.f;
          sc[4 * jj + e] = p;
          if (e < 2) l0 += p; else l1 += p;
        }
    } else {
      float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = 8 * jj + col + (e & 1) < kn ? sc[4 * jj + e] * scale_log2
                                                       : -CUDART_INF_F;
          sc[4 * jj + e] = v;
          if (e < 2) x0 = fmaxf(x0, v); else x1 = fmaxf(x1, v);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      }
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);  // finite: kn >= 1
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int jj = 0; jj < kO / 4; ++jj) {
        o[4 * jj] *= a0;
        o[4 * jj + 1] *= a0;
        o[4 * jj + 2] *= a1;
        o[4 * jj + 3] *= a1;
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * jj + e] - (e < 2 ? n0 : n1));
          sc[4 * jj + e] = p;
          if (e < 2) l0 += p; else l1 += p;
        }
    }

    // P in bf16 as the A operand: keys 16t .. 16t + 15 are accumulator
    // columns 8(2t) .. 8(2t + 1) + 7
    uint32_t pa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      pa[t][0] = pack_bf16(sc[8 * t + 0], sc[8 * t + 1]);
      pa[t][1] = pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
      pa[t][2] = pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
      pa[t][3] = pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
    }
    const uint64_t dv = make_desc(Vs + s * kTile, kGroup, kGroup, kLayout);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) wgmma_rs_tb<DH>(o, pa[t], desc_add(dv, 16 * kRow * t), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
  bf16* ob = out + (size_t)b * N * D + h * DH + col;
#pragma unroll
  for (int jj = 0; jj < kO / 4; ++jj) {
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + 8 * jj) =
          __floats2bfloat162_rn(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + 8 * jj) =
          __floats2bfloat162_rn(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
  }
}

cudaError_t launch_f32(const void* qkv, void* out, int B, int H, int N, int dh,
                       float scale, cudaStream_t stream) {
  auto go = [&](auto kernel, size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(qkv),
                                             static_cast<float*>(out), H, N, scale);
    return cudaGetLastError();
  };
  if (dh == 32) return go(packed_attn_kernel<32>, smem_bytes<32>());
  return go(packed_attn_kernel<64>, smem_bytes<64>());
}

template <int DH, bool MAXSUB>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int H, int N, float scale,
                        cudaStream_t stream) {
  const int D = H * DH;
  CUtensorMap map;
  const uint64_t dims[3] = {(uint64_t)3 * D, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)3 * D * 2, (uint64_t)N * 3 * D * 2};
  const uint32_t box[3] = {DH, kBlockQ, 1};
  cudaError_t err = vrl::encode_bf16_map(
      &map, 3, qkv, dims, strides, box,
      DH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  auto kernel = packed_attn_wgmma_kernel<DH, MAXSUB>;
  constexpr size_t smem = wgmma_smem_bytes<DH>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, 128, smem, stream>>>(map, static_cast<bf16*>(out), H, N,
                                      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16; maxsub (bf16 only): 0 the max-free softmax,
// 1 the max-subtracted one. Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a head width or dtype the kernel does not take.
int vrl_packed_attn(const void* qkv, void* out, int B, int H, int N, int dh,
                    int dtype, int maxsub, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || (dh != 32 && dh != 64)) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(qkv, out, B, H, N, dh, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (dh == 32)
    return maxsub ? launch_bf16<32, true>(qkv, out, B, H, N, scale, s)
                  : launch_bf16<32, false>(qkv, out, B, H, N, scale, s);
  return maxsub ? launch_bf16<64, true>(qkv, out, B, H, N, scale, s)
                : launch_bf16<64, false>(qkv, out, B, H, N, scale, s);
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

// The LayerNorm prologue of the bf16 wgmma kernels (ln_gemm.cu,
// mlp_block.cu): 64 rows of x, normalised once over the full K in fp32 and
// rounded to bf16, written straight into the 128 B-swizzled K-major layout
// wgmma reads A from (hopper.cuh): K / 64 column blocks of 64 rows x 128 B.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vrl {
namespace sm90 {

constexpr int kPanelRows = 64;
constexpr int kChunkK = 64;         // K of a panel block (128 B of bf16)
constexpr int kChunkBytes = kPanelRows * kChunkK * 2;  // 8 KB
constexpr int kMaxRowChunks = 6;    // 16 B chunks a lane holds: K <= 1536

// The 8 bf16 values of a 16 B chunk as fp32 (exact), and back, rounded.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One row's 16 B chunks (lane + 32 i) through the LN in place, as bf16.
__device__ __forceinline__ void ln_row(uint4 (&v)[kMaxRowChunks], const float* __restrict__ g,
                                       const float* __restrict__ be, int K, int kc,
                                       float eps, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) s += bf16_lo(w[k]) + bf16_hi(w[k]);
  }
  const float mu = warp_sum(s) / K;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    if (lane + 32 * i < kc) {
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d0 = bf16_lo(w[k]) - mu, d1 = bf16_hi(w[k]) - mu;
        q += d0 * d0;
        q += d1 * d1;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / K + eps);
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < kc) {
      uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      const float* gc = g + 8 * c;
      const float* bc = be + 8 * c;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = pack_bf16((bf16_lo(w[k]) - mu) * rstd * gc[2 * k] + bc[2 * k],
                         (bf16_hi(w[k]) - mu) * rstd * gc[2 * k + 1] + bc[2 * k + 1]);
      v[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Rows m0 .. m0 + 63 of x, through the LN when g is given, as bf16 into the
// swizzled panel; zeros past M and past K up to the 64-column block. Warp
// `warp` of 8 takes rows warp + 16 j and warp + 16 j + 8 together (their
// loads in flight at once); a lane holds its 16 B chunks (lane + 32 i) of
// each row in registers. x is 16 B aligned.
__device__ void load_panel(unsigned char* panel, const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ g, const float* __restrict__ be,
                           int m0, int M, int K, float eps, int warp, int lane) {
  const int kc = K / 8, pc = (K + kChunkK - 1) / kChunkK * (kChunkK / 8);
  for (int r0 = warp; r0 < kPanelRows; r0 += 16) {
    uint4 v[2][kMaxRowChunks];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
#pragma unroll
      for (int i = 0; i < kMaxRowChunks; ++i) {
        const int c = lane + 32 * i;
        v[h][i] = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && c < kc)
          v[h][i] = *reinterpret_cast<const uint4*>(x + (size_t)m * K + 8 * c);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (g != nullptr && m0 + r < M) ln_row(v[h], g, be, K, kc, eps, lane);
#pragma unroll
      for (int i = 0; i < kMaxRowChunks; ++i) {
        const int c = lane + 32 * i;
        if (c < pc)
          *reinterpret_cast<uint4*>(panel + (c >> 3) * kChunkBytes + r * 128 +
                                    (((c & 7) ^ (r & 7)) << 4)) = v[h][i];
      }
    }
  }
}

}  // namespace sm90
}  // namespace vrl

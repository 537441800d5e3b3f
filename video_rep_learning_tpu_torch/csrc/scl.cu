// Fused SCL (sequence contrastive loss) for Hopper (sm_90a): the loss and its
// gradient over the N x N frame similarities without any (N, N) buffer in
// device memory, in four passes that each write per-row values.
//
// Replaces the TPU kernels of video_rep_learning_tpu/ops/scl_pallas.py:
//   pass 1 `_rowsum_kernel` (:104)  negsum_i = sum_j w_ij exp(l_ij),
//                                   possum_i = sum_j pos_ij
//   pass 2 `_loss_kernel`   (:122)  sum_j KL(label_ij || exp(l_ij) / negsum_i)
//   pass 3 `_srow_kernel`   (:151)  S_i = sum_j im_ij label_ij c_ij
//   pass 4 `_grad_kernel`   (:176)  de_i = sum_j (G_ij + G_ji) e_j
// with l = e e^T / tau, the pair terms of `_pair_terms` / `_gauss_tile` and the
// same guards (NaN -> 0 divisions, 1e-6 weight on masked pairs, 0 on padding,
// log(r + 1e-6), rinv = 0 where negsum is 0, dist = 1e6 on masked pairs).
// exp has no max shift: on unit-norm embeddings l <= 1 / tau. One departure:
// the backward's labels are pos / possum with NaN -> 0, as the forward's are,
// not pos * (1 / possum), which overflows to inf (and gives NaN) when possum
// is subnormal: this build keeps subnormals, where the TPU flushes them.
//
// What bounds it on the H100: operations, and most of them on few pairs.
// Every pass forms 64 x 64 logits tiles (2 C flops a pair) and does ~20-45
// fp32 operations a pair of elementwise work; the inputs are O(N C) bytes.
// Under `single_noself` (the default SCL.NEGATIVE_TYPE) only the pairs of one
// clip, and those of a masked frame (weight 1e-6), carry work. The design:
// - A block owns 64 rows and walks one of `splits` interleaved subsets of the
//   64-column tiles (J = split, split + splits, ...), grid (Np / 64, splits).
//   The wrapper takes enough splits for eight blocks an SM in passes 1-3 and
//   for two in pass 4, whose scratch slices are (Np, C) each: N 480 runs 64
//   blocks a pass (one a tile), not 8; N 8640 1080 and 270. Split 0 writes
//   its per-row values to the output, split k to scratch slice k - 1, and
//   `vrl_scl_sum_splits` adds the slices to the output in split order: no
//   atomics, so every launch gives the same bits.
// - The walk skips tiles that carry no work: `tiles` (Np / 64)^2 flags from
//   the metadata (`ops/scl.py::scl_tiles`), bit 0 where a pair has a nonzero
//   weight or a positive label (passes 1 and 4), bit 1 where a pair is a
//   positive (passes 2 and 3, whose terms are 0 elsewhere). An empty tile's
//   terms are all exact zeros, so skipping it changes no bit.
// - The logits tile and pass 4's (G_IJ + G_JI^T) e_J are on the tensor cores:
//   mma.sync 3xTF32 m16n8k8 (`mma.cuh`), about fp32's accuracy (one TF32
//   product's ~3 digits would be multiplied by exp(l / 0.1)). Eight warps
//   own 16 rows x 32 columns of a tile each; a warp's logits stay in
//   registers, pass 4 turns them into G in place and feeds G to G e_J as
//   the A operand from registers. The two column halves' sums are added in
//   a fixed order at the end.
// - Only a cross pair (one clip's two views) has a gaussian, a label and
//   G's second term; a tile with no positive (bit 1) skips them all, a tile
//   with one forms them for every pair, branch-free, and selects.
//   The logits are scaled by 1 / tau (a multiply, where the plain version
//   divides: at most an ulp of l / tau, 6e-7 of exp(l / tau)).
// - e_J and the metadata of the next tile land by cp.async while the current
//   one computes. Shared rows are padded to C + 4 floats, free of bank
//   conflicts for the row and the column fragment reads.
//
// Layout: e (Np, C) fp32, 16-byte aligned, with Np % 64 == 0 and C % 16 == 0,
// C <= 128; meta (8, Np) fp32, rows step, len, mask, sample, view, is_real
// (padding rows are all zero); rows (Np, 2) fp32 = (negsum, possum); s (Np,)
// fp32; tiles (Np / 64, Np / 64) uint8 or null (walk every tile). No
// allocation; launches on the caller's stream and returns cudaGetLastError().

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using vrl::cp_async16;
using vrl::cp_async_commit;
using vrl::cp_async_wait;
using vrl::quad_sum;
using M = vrl::Mma<float>;

constexpr int kTile = 64;
constexpr int kThreads = 256;   // 4 row groups of 16 x 2 column halves
constexpr int kHalfCols = 32;
constexpr int kMaxC = 128;
constexpr int kMetaRows = 6;

enum Pass { kRowsum = 0, kLoss = 1, kSrow = 2, kGrad = 3 };

struct Params {
  int Np, C;
  float tau, var;
  bool single, noself;
};

struct Frame {
  float step, len, mask, sample, view, real;
};

// Frame k of a meta tile in shared memory (kMetaRows x kTile values).
__device__ __forceinline__ Frame frame(const float* m, int k) {
  return Frame{m[k], m[kTile + k], m[2 * kTile + k], m[3 * kTile + k], m[4 * kTile + k],
               m[5 * kTile + k]};
}

struct Pair {
  float w, im_raw, im;
  bool cross;
};

// `_pair_terms`: weight, raw and effective masks, cross-view (same sample,
// other view), with padding taking no part.
__device__ __forceinline__ Pair pair_terms(const Frame& a, const Frame& b, const Params& p) {
  Pair r;
  r.im_raw = a.mask * b.mask;
  const bool same_sample = a.sample == b.sample;
  const bool same_view = same_sample && a.view == b.view;
  float w = 1.f;
  if (p.single && !same_sample) w = 0.f;
  if (p.noself && same_view) w = 0.f;
  if (r.im_raw == 0.f) w = 1e-6f;
  const bool pad = a.real * b.real == 0.f;
  r.w = pad ? 0.f : w;
  r.im = pad ? 0.f : r.im_raw;
  r.cross = same_sample && !same_view && !pad;
  return r;
}

// `_gauss_tile`: dist on frame a's timeline, |step_a / len_a * len_b - step_b|,
// each operation rounded on its own as the plain version rounds it: a fused
// multiply-add here moves dist by an ulp of the step (~6e-5 at 600), which
// exp(-dist^2 / 2 var) turns into ~1e-4 of a far positive's weight, and the
// label pos / possum of a row whose positives are all far carries it whole.
// `ratio_a` is __fdiv_rn(step_a, len_a). Called for cross pairs only: the
// gaussian is 0 elsewhere.
__device__ __forceinline__ float gauss(float ratio_a, const Frame& b, const Pair& t,
                                       float var) {
  float dist = fabsf(__fsub_rn(__fmul_rn(ratio_a, b.len), b.step));
  if (t.im_raw == 0.f) dist = 1e6f;
  return expf(-(dist * dist) / (2.f * var));
}

__device__ __forceinline__ float safe_div(float a, float b) {
  const float q = a / b;
  return isnan(q) ? 0.f : q;
}

__device__ __forceinline__ float inv_or_zero(float x) { return x > 0.f ? 1.f / x : 0.f; }

// 64 rows of e from row r0 into shared rows of `ld` floats.
__device__ __forceinline__ void stage_e(float* dst, const float* e, int r0, int C, int ld) {
  const int per_row = C / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    cp_async16(dst + r * ld + c, e + (size_t)(r0 + r) * C + c, true);
  }
}

// Columns [r0, r0 + 64) of the first kMetaRows rows of meta (8, Np).
__device__ __forceinline__ void stage_meta(float* dst, const float* meta, int r0, int Np) {
  for (int i = threadIdx.x; i < kMetaRows * kTile / 4; i += kThreads) {
    const int r = i / (kTile / 4), c = (i % (kTile / 4)) * 4;
    cp_async16(dst + r * kTile + c, meta + (size_t)r * Np + r0 + c, true);
  }
}

// `n` floats from src into dst, n % 4 == 0.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i, true);
}

size_t pass_smem(int pass, int C) {
  const size_t ld = C + 4;
  const size_t buf = kTile * ld + kMetaRows * kTile + (pass == kGrad ? 3 * kTile : 0);
  return sizeof(float) * (kTile * ld + kMetaRows * kTile + 2 * buf);
}

// One pass over the tiles (I, J) of row tile I = blockIdx.x whose J lies in
// split blockIdx.y; see the header for what each pass sums. Warp w owns rows
// 16 (w % 4) .. + 16 and the columns 32 (w / 4) .. + 32 of every tile; the
// two column halves' sums are added (half 0 + half 1) at the end.
template <int PASS>
__global__ void __launch_bounds__(kThreads)
scl_pass_kernel(const float* __restrict__ e, const float* __restrict__ meta,
                const float* __restrict__ rows, const float* __restrict__ srow,
                const uint8_t* __restrict__ tiles, float* __restrict__ out,
                float* __restrict__ scratch, Params p) {
  constexpr int kN = kHalfCols / 8;  // score tiles of 8 columns a warp
  extern __shared__ __align__(16) float smem[];
  const int ld = p.C + 4;
  const int buf_len = kTile * ld + kMetaRows * kTile + (PASS == kGrad ? 3 * kTile : 0);
  float* Ei = smem;
  float* Mi = Ei + kTile * ld;
  auto Ej = [&](int b) { return Mi + kMetaRows * kTile + b * buf_len; };
  auto Mj = [&](int b) { return Ej(b) + kTile * ld; };
  auto Rj = [&](int b) { return Mj(b) + kMetaRows * kTile; };  // pass 4: rows, then s

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, ch = warp >> 2;
  const int nT = p.Np / kTile, I = blockIdx.x, splits = gridDim.y;
  const int i0 = I * kTile;
  const uint8_t bit = (PASS == kRowsum || PASS == kGrad) ? 1 : 2;
  auto flags = [&](int j) { return tiles == nullptr ? 3 : tiles[(size_t)I * nT + j]; };
  auto next = [&](int j) {
    do j += splits;
    while (j < nT && !(flags(j) & bit));
    return j;
  };
  auto stage = [&](int b, int j) {
    stage_e(Ej(b), e, j * kTile, p.C, ld);
    stage_meta(Mj(b), meta, j * kTile, p.Np);
    if (PASS == kGrad) {
      stage_vec(Rj(b), rows + (size_t)j * kTile * 2, 2 * kTile);
      stage_vec(Rj(b) + 2 * kTile, srow + (size_t)j * kTile, kTile);
    }
  };

  int j = blockIdx.y;
  if (j < nT && !(flags(j) & bit)) j = next(j);
  stage_e(Ei, e, i0, p.C, ld);
  stage_meta(Mi, meta, i0, p.Np);
  if (j < nT) stage(0, j);
  cp_async_commit();

  // this thread's two rows (g and g + 8 of the warp's 16) and their values
  const int lr[2] = {16 * rg + g, 16 * rg + g + 8};
  float ra[2], rb[2], rc[2];  // per pass: negsum | rinv, possum, rinv * S
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = i0 + lr[i];
    if (PASS != kRowsum) {
      const float neg = rows[r * 2];
      ra[i] = PASS == kLoss ? neg : inv_or_zero(neg);
      rb[i] = rows[r * 2 + 1];
      rc[i] = PASS == kGrad ? ra[i] * srow[r] : 0.f;
    }
  }

  float acc0[2] = {0.f, 0.f}, acc1[2] = {0.f, 0.f};
  float de[kMaxC / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxC / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) de[n][q] = 0.f;

  Frame fi[2];
  float ratio_i[2];  // step / len of the two rows, for their gaussians
  const float inv_tau = 1.f / p.tau;
  for (int b = 0; j < nT; b ^= 1) {
    const int jn = next(j);
    // a tile without a positive (bit 1) has no cross pair of two unmasked
    // frames, so no gaussian, label, loss, S or second G term: none is formed
    const bool positive = flags(j) & 2;
    if (jn < nT) {
      stage(b ^ 1, jn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      fi[i] = frame(Mi, lr[i]);
      ratio_i[i] = __fdiv_rn(fi[i].step, fi[i].len);
    }
    const float* Et = Ej(b);
    const float* Mt = Mj(b);

    // the warp's 16 x 32 logits
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[n][q] = 0.f;
    for (int kk = 0; kk < p.C; kk += 8) {
      const M::A a = M::rows_a(Ei, ld, 16 * rg, kk);
#pragma unroll
      for (int n = 0; n < kN; ++n)
        M::mma(s[n], a, M::rows_b(Et, ld, kHalfCols * ch + 8 * n, kk));
    }

    // the pair terms. Only a cross pair (one clip's two views) has a
    // gaussian, a label, a loss or S term and G's second term; they are
    // formed for every pair of a positive tile and selected, elsewhere
    // they are exact zeros, which add nothing
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int lj = kHalfCols * ch + 8 * n + 2 * t + c;
        const Frame fj = frame(Mt, lj);
        float rinv_j = 0.f, possum_j = 0.f, rs_j = 0.f;
        if (PASS == kGrad) {
          rinv_j = inv_or_zero(Rj(b)[2 * lj]);
          possum_j = Rj(b)[2 * lj + 1];
          rs_j = rinv_j * Rj(b)[2 * kTile + lj];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[n][2 * i + c];
          const float el = expf(x * inv_tau);
          const Pair pt = pair_terms(fi[i], fj, p);
          if (PASS == kRowsum) {
            acc0[i] += pt.w * el;
            if (positive) {
              const float pos = gauss(ratio_i[i], fj, pt, p.var);
              acc1[i] += pt.cross ? pos : 0.f;
            }
          } else if (PASS == kLoss) {
            const float label = safe_div(gauss(ratio_i[i], fj, pt, p.var), rb[i]);
            const float log_input = logf(safe_div(el, ra[i]) + 1e-6f);
            const float xlogx = label > 0.f ? label * logf(label) : 0.f;
            const float term = xlogx - label * log_input;
            // the im > 0 guard stops 0 * inf on padded rows (negsum == 0)
            acc0[i] += pt.cross && pt.im > 0.f ? term : 0.f;
          } else if (PASS == kSrow) {
            const float r = el * ra[i];
            const float label = safe_div(gauss(ratio_i[i], fj, pt, p.var), rb[i]);
            const float term = pt.im * label * (r / (r + 1e-6f));
            acc0[i] += pt.cross ? term : 0.f;
          } else {
            // term 1, shared by both orientations (weight and exp are symmetric)
            float gv = pt.w * el * (rc[i] + rs_j);
            if (positive) {
              // term 2, IJ orientation: row i's gaussian and normalisers
              const float r_ij = el * ra[i];
              const float ij = pt.im * safe_div(gauss(ratio_i[i], fj, pt, p.var), rb[i]) *
                               (r_ij / (r_ij + 1e-6f));
              // term 2, JI orientation laid out as (I, J): row j's timeline
              const float r_ji = el * rinv_j;
              const float ji = pt.im *
                               safe_div(gauss(__fdiv_rn(fj.step, fj.len), fi[i], pt, p.var),
                                        possum_j) * (r_ji / (r_ji + 1e-6f));
              gv -= pt.cross ? ij : 0.f;
              gv -= pt.cross ? ji : 0.f;
            }
            x = gv;
          }
        }
      }
    if (PASS == kGrad) {
      // de_I += G e_J over this warp's 32 columns: G from the accumulators,
      // e_J read down its rows
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        const M::A a = M::acc_a(s, kk);
#pragma unroll
        for (int n = 0; n < kMaxC / 8; ++n)
          if (8 * n < p.C) M::mma(de[n], a, M::cols_b(Et, ld, kHalfCols * ch + 8 * kk, 8 * n));
      }
    }
    __syncthreads();  // buffer b is free for the tile after next
    j = jn;
  }
  cp_async_wait<0>();  // a split with no tile never waited for its own rows
  __syncthreads();     // every warp is past its last read of the tiles

  // column half 1 hands its sums to half 0 through the idle shared memory
  float* red = smem;
  float* dst = blockIdx.y == 0 ? out
               : scratch + (size_t)(blockIdx.y - 1) * p.Np * (PASS == kRowsum ? 2
                                                             : PASS == kGrad ? p.C : 1);
  if (PASS == kGrad) {
    float* mine = red + rg * p.C * 16 + lane;  // C / 8 x 4 values a lane
    if (ch == 1) {
#pragma unroll
      for (int n = 0; n < kMaxC / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (8 * n < p.C) mine[(4 * n + q) * 32] = de[n][q];
    }
    __syncthreads();
    if (ch == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t r = i0 + lr[i];
#pragma unroll
      for (int n = 0; n < kMaxC / 8; ++n)
        if (8 * n < p.C)
          *reinterpret_cast<float2*>(dst + r * p.C + 8 * n + 2 * t) =
              make_float2(de[n][2 * i] + mine[(4 * n + 2 * i) * 32],
                          de[n][2 * i + 1] + mine[(4 * n + 2 * i + 1) * 32]);
    }
  } else {
    float v0[2], v1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v0[i] = quad_sum(acc0[i]);
      v1[i] = PASS == kRowsum ? quad_sum(acc1[i]) : 0.f;
      if (ch == 1 && t == 0) {
        red[2 * lr[i]] = v0[i];
        red[2 * lr[i] + 1] = v1[i];
      }
    }
    __syncthreads();
    if (ch == 1 || t != 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t r = i0 + lr[i];
      if (PASS == kRowsum) {
        dst[r * 2] = v0[i] + red[2 * lr[i]];
        dst[r * 2 + 1] = v1[i] + red[2 * lr[i] + 1];
      } else {
        dst[r] = v0[i] + red[2 * lr[i]];
      }
    }
  }
}

// out[i] += scratch[0][i] + ... + scratch[splits - 2][i], in that order.
__global__ void scl_sum_splits_kernel(float* __restrict__ out, const float* __restrict__ scratch,
                                      int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = out[i];
  for (int k = 0; k + 1 < splits; ++k) x += scratch[(size_t)k * n + i];
  out[i] = x;
}

bool bad_shape(int Np, int C) {
  return Np <= 0 || Np % kTile || C < 16 || C > kMaxC || C % 16;
}

template <int PASS>
cudaError_t launch(const void* e, const void* meta, const void* rows, const void* srow,
                   const void* tiles, void* out, void* scratch, const Params& p, int splits,
                   cudaStream_t stream) {
  const size_t smem = pass_smem(PASS, p.C);
  auto kernel = scl_pass_kernel<PASS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.Np / kTile, splits), kThreads, smem, stream>>>(
      static_cast<const float*>(e), static_cast<const float*>(meta),
      static_cast<const float*>(rows), static_cast<const float*>(srow),
      static_cast<const uint8_t*>(tiles), static_cast<float*>(out),
      static_cast<float*>(scratch), p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pass: 0 = row sums (out (Np, 2); `rows` and `s` unused), 1 = loss rows (out
// (Np,)), 2 = S rows (out (Np,)), 3 = gradient (out (Np, C), unscaled by
// g / (mask_sum tau); needs `s`). `splits` blocks walk a row tile's columns;
// `scratch` holds splits - 1 slices of the output's size (null for one
// split), added to the output by `vrl_scl_sum_splits`. Returns a
// cudaError_t (0 = success); cudaErrorInvalidValue for a shape, pass or split
// count the kernel does not take.
int vrl_scl_pass(const void* e, const void* meta, const void* rows, const void* srow,
                 const void* tiles, void* out, void* scratch, int Np, int C, float tau,
                 float var, int single, int noself, int pass, int splits, void* stream) {
  const Params p{Np, C, tau, var, single != 0, noself != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(Np, C) || splits < 1 || splits > Np / kTile || splits > 65535 ||
      (splits > 1 && scratch == nullptr) || (pass != kRowsum && rows == nullptr) ||
      (pass == kGrad && srow == nullptr))
    return cudaErrorInvalidValue;
  if (pass == kRowsum) return launch<kRowsum>(e, meta, rows, srow, tiles, out, scratch, p, splits, s);
  if (pass == kLoss) return launch<kLoss>(e, meta, rows, srow, tiles, out, scratch, p, splits, s);
  if (pass == kSrow) return launch<kSrow>(e, meta, rows, srow, tiles, out, scratch, p, splits, s);
  if (pass == kGrad) return launch<kGrad>(e, meta, rows, srow, tiles, out, scratch, p, splits, s);
  return cudaErrorInvalidValue;
}

// out (n,) += the splits - 1 slices of scratch, in slice order.
int vrl_scl_sum_splits(void* out, const void* scratch, int n, int splits, void* stream) {
  if (n <= 0 || splits < 2) return cudaErrorInvalidValue;
  scl_sum_splits_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(scratch), n, splits);
  return cudaGetLastError();
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

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
// What bounds it on the H100: operations. Every pass forms the 64 x 64 logits
// tile (2 C flops a pair) and ~20-45 fp32 operations a pair of elementwise
// work; the inputs are O(N C) bytes. Design, simple first: one block owns 64
// rows and loops over every 64-column tile; e_I and e_J sit in shared memory
// (64 x (C + 1) fp32, padded against bank conflicts); a thread owns a 4 x 4
// register micro-tile of the logits (rows tr + 16 i, columns tc + 16 j, as in
// flash_attn_fwd.cu), formed with fp32 FMA (no TF32). Row sums are reduced
// across the 16 lanes that share a row and written by the block that owns the
// row: no atomics, so every run gives the same bits. The gradient pass writes
// the G tile (both orientations, `_grad_kernel`'s G_IJ + G_JI^T) to shared
// memory and accumulates de_I += G e_J in registers (4 rows x C / 16 columns a
// thread). wgmma on TF32/bf16 and skipping tiles with no weight wait for a
// later change.
//
// Layout: e (Np, C) fp32 with Np % 64 == 0 and C % 16 == 0, C <= 128; meta
// (8, Np) fp32, rows step, len, mask, sample, view, is_real (padding rows are
// all zero); rows (Np, 2) fp32 = (negsum, possum); s (Np,) fp32. No
// allocation; launches on the caller's stream and returns cudaGetLastError().

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxCols = 8;  // C / 16 output columns a thread, C <= 128
constexpr int kMetaRows = 6;
constexpr int kGS = kTile + 1;  // padded row of the G tile

enum Pass { kRowsum = 0, kLoss = 1, kSrow = 2 };

struct Params {
  int Np, C;
  float tau, var;
  bool single, noself;
};

// Meta tile in shared memory: kMetaRows x kTile values.
__device__ __forceinline__ float mget(const float* m, int row, int k) {
  return m[row * kTile + k];
}

struct Pair {
  float w, im_raw, im;
  bool cross;
};

// `_pair_terms`: weight, raw and effective masks, cross-view (same sample,
// other view), with padding taking no part.
__device__ __forceinline__ Pair pair_terms(const float* Mi, int i, const float* Mj,
                                           int j, const Params& p) {
  Pair r;
  r.im_raw = mget(Mi, 2, i) * mget(Mj, 2, j);
  const bool same_sample = mget(Mi, 3, i) == mget(Mj, 3, j);
  const bool same_view = same_sample && mget(Mi, 4, i) == mget(Mj, 4, j);
  float w = 1.f;
  if (p.single && !same_sample) w = 0.f;
  if (p.noself && same_view) w = 0.f;
  if (r.im_raw == 0.f) w = 1e-6f;
  const bool pad = mget(Mi, 5, i) * mget(Mj, 5, j) == 0.f;
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
__device__ __forceinline__ float gauss(float step_a, float len_a, float step_b,
                                       float len_b, const Pair& t, float var) {
  float dist = fabsf(__fsub_rn(__fmul_rn(__fdiv_rn(step_a, len_a), len_b), step_b));
  if (t.im_raw == 0.f) dist = 1e6f;
  return t.cross ? expf(-(dist * dist) / (2.f * var)) : 0.f;
}

__device__ __forceinline__ float safe_div(float a, float b) {
  const float q = a / b;
  return isnan(q) ? 0.f : q;
}

__device__ __forceinline__ float inv_or_zero(float x) { return x > 0.f ? 1.f / x : 0.f; }

__device__ __forceinline__ void load_rows_tile(float* dst, const float* e, int r0, int C) {
  const int ES = C + 1;
  for (int idx = threadIdx.x; idx < kTile * C; idx += kThreads) {
    const int r = idx / C, c = idx - r * C;
    dst[r * ES + c] = e[(size_t)(r0 + r) * C + c];
  }
}

__device__ __forceinline__ void load_meta_tile(float* dst, const float* meta, int r0, int Np) {
  for (int idx = threadIdx.x; idx < kMetaRows * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx - r * kTile;
    dst[idx] = meta[(size_t)r * Np + r0 + c];
  }
}

// s[a][b] = <e_I[tr + 16 a], e_J[tc + 16 b]>
__device__ __forceinline__ void logits_tile(const float* Ei, const float* Ej, int C,
                                            int tr, int tc, float s[4][4]) {
  const int ES = C + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < C; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = Ei[(tr + 16 * a) * ES + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = Ej[(tc + 16 * b) * ES + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(x[a], y[b], s[a][b]);
  }
}

// The sum over the 16 neighbouring lanes that share a row.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t rows_smem(int C) {
  return sizeof(float) * (2 * kTile * (C + 1) + 2 * kMetaRows * kTile + 2 * kTile);
}

// Passes 1-3: one block per 64 rows, a loop over every column tile.
template <int PASS>
__global__ void __launch_bounds__(kThreads)
scl_rows_kernel(const float* __restrict__ e, const float* __restrict__ meta,
                const float* __restrict__ rows, float* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const int ES = p.C + 1;
  float* Ei = smem;
  float* Ej = Ei + kTile * ES;
  float* Mi = Ej + kTile * ES;
  float* Mj = Mi + kMetaRows * kTile;
  float* R = Mj + kMetaRows * kTile;  // per row: negsum (pass 2) or rinv (3), possum

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int i0 = blockIdx.x * kTile;
  load_rows_tile(Ei, e, i0, p.C);
  load_meta_tile(Mi, meta, i0, p.Np);
  if (PASS != kRowsum && tid < kTile) {
    const float neg = rows[(size_t)(i0 + tid) * 2], pos = rows[(size_t)(i0 + tid) * 2 + 1];
    R[tid] = PASS == kLoss ? neg : inv_or_zero(neg);
    R[kTile + tid] = pos;
  }

  float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < p.Np; j0 += kTile) {
    __syncthreads();  // the previous tile's reads of Ej / Mj are done
    load_rows_tile(Ej, e, j0, p.C);
    load_meta_tile(Mj, meta, j0, p.Np);
    __syncthreads();
    float s[4][4];
    logits_tile(Ei, Ej, p.C, tr, tc, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int li = tr + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int lj = tc + 16 * b;
        const float el = expf(s[a][b] / p.tau);
        const Pair t = pair_terms(Mi, li, Mj, lj, p);
        const float pos = gauss(mget(Mi, 0, li), mget(Mi, 1, li), mget(Mj, 0, lj),
                                mget(Mj, 1, lj), t, p.var);
        if (PASS == kRowsum) {
          acc0[a] += t.w * el;
          acc1[a] += pos;
        } else if (PASS == kLoss) {
          const float label = t.cross ? safe_div(pos, R[kTile + li]) : 0.f;
          const float log_input = logf(safe_div(el, R[li]) + 1e-6f);
          const float xlogx = label > 0.f ? label * logf(label) : 0.f;
          // the im > 0 guard stops 0 * inf on padded rows (negsum == 0)
          if (t.im > 0.f) acc0[a] += xlogx - label * log_input;
        } else {
          const float r = el * R[li];
          const float c = r / (r + 1e-6f);
          const float label = t.cross ? safe_div(pos, R[kTile + li]) : 0.f;
          acc0[a] += t.im * label * c;
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float v0 = row_sum16(acc0[a]);
    const float v1 = PASS == kRowsum ? row_sum16(acc1[a]) : 0.f;
    if (tc == 0) {
      const int row = i0 + tr + 16 * a;
      if (PASS == kRowsum) {
        out[(size_t)row * 2] = v0;
        out[(size_t)row * 2 + 1] = v1;
      } else {
        out[row] = v0;
      }
    }
  }
}

size_t grad_smem(int C) {
  return sizeof(float) * (2 * kTile * (C + 1) + 2 * kMetaRows * kTile + 6 * kTile +
                          kTile * kGS);
}

// Pass 4: de_I = sum_J (G_IJ + G_JI^T) e_J, unscaled by g / (mask_sum tau).
__global__ void __launch_bounds__(kThreads)
scl_grad_kernel(const float* __restrict__ e, const float* __restrict__ meta,
                const float* __restrict__ rows, const float* __restrict__ srow,
                float* __restrict__ de, Params p) {
  extern __shared__ float smem[];
  const int ES = p.C + 1;
  float* Ei = smem;
  float* Ej = Ei + kTile * ES;
  float* Mi = Ej + kTile * ES;
  float* Mj = Mi + kMetaRows * kTile;
  float* Si = Mj + kMetaRows * kTile;  // rinv, possum, rinv * S of the I rows
  float* Sj = Si + 3 * kTile;          // and of the J rows
  float* G = Sj + 3 * kTile;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int i0 = blockIdx.x * kTile;
  const int ncols = p.C / 16;
  load_rows_tile(Ei, e, i0, p.C);
  load_meta_tile(Mi, meta, i0, p.Np);
  if (tid < kTile) {
    const size_t r = i0 + tid;
    const float rinv = inv_or_zero(rows[r * 2]);
    Si[tid] = rinv;
    Si[kTile + tid] = rows[r * 2 + 1];
    Si[2 * kTile + tid] = rinv * srow[r];
  }

  float o[4][kMaxCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) o[a][c] = 0.f;

  for (int j0 = 0; j0 < p.Np; j0 += kTile) {
    __syncthreads();  // the previous tile's reads of Ej / Mj / Sj / G are done
    load_rows_tile(Ej, e, j0, p.C);
    load_meta_tile(Mj, meta, j0, p.Np);
    if (tid < kTile) {
      const size_t r = j0 + tid;
      const float rinv = inv_or_zero(rows[r * 2]);
      Sj[tid] = rinv;
      Sj[kTile + tid] = rows[r * 2 + 1];
      Sj[2 * kTile + tid] = rinv * srow[r];
    }
    __syncthreads();
    float s[4][4];
    logits_tile(Ei, Ej, p.C, tr, tc, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int li = tr + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int lj = tc + 16 * b;
        const float el = expf(s[a][b] / p.tau);
        const Pair t = pair_terms(Mi, li, Mj, lj, p);
        const float step_i = mget(Mi, 0, li), len_i = mget(Mi, 1, li);
        const float step_j = mget(Mj, 0, lj), len_j = mget(Mj, 1, lj);
        // term 1, shared by both orientations (weight and exp are symmetric)
        float g = t.w * el * (Si[2 * kTile + li] + Sj[2 * kTile + lj]);
        // term 2, IJ orientation: row i's gaussian and normalisers
        const float pos_ij = gauss(step_i, len_i, step_j, len_j, t, p.var);
        const float r_ij = el * Si[li];
        g -= t.im * safe_div(pos_ij, Si[kTile + li]) * (r_ij / (r_ij + 1e-6f));
        // term 2, JI orientation laid out as (I, J): row j's timeline
        const float pos_ji = gauss(step_j, len_j, step_i, len_i, t, p.var);
        const float r_ji = el * Sj[lj];
        g -= t.im * safe_div(pos_ji, Sj[kTile + lj]) * (r_ji / (r_ji + 1e-6f));
        G[li * kGS + lj] = g;
      }
    }
    __syncthreads();
    for (int k = 0; k < kTile; ++k) {
      float gv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) gv[a] = G[(tr + 16 * a) * kGS + k];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < ncols) {
          const float ev = Ej[k * ES + tc + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) o[a][c] = fmaf(gv[a], ev, o[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float* row = de + (size_t)(i0 + tr + 16 * a) * p.C;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
      if (c < ncols) row[tc + 16 * c] = o[a][c];
  }
}

bool bad_shape(int Np, int C) {
  return Np <= 0 || Np % kTile || C < 16 || C > 16 * kMaxCols || C % 16;
}

template <int PASS>
cudaError_t launch_rows(const void* e, const void* meta, const void* rows, void* out,
                        const Params& p, cudaStream_t stream) {
  if (bad_shape(p.Np, p.C)) return cudaErrorInvalidValue;
  const size_t smem = rows_smem(p.C);
  auto kernel = scl_rows_kernel<PASS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.Np / kTile, kThreads, smem, stream>>>(
      static_cast<const float*>(e), static_cast<const float*>(meta),
      static_cast<const float*>(rows), static_cast<float*>(out), p);
  return cudaGetLastError();
}

Params make_params(int Np, int C, float tau, float var, int single, int noself) {
  Params p;
  p.Np = Np;
  p.C = C;
  p.tau = tau;
  p.var = var;
  p.single = single != 0;
  p.noself = noself != 0;
  return p;
}

}  // namespace

extern "C" {

// pass: 0 = row sums (out (Np, 2)), 1 = loss rows (out (Np,)), 2 = S rows
// (out (Np,)); `rows` is unused by pass 0. Returns a cudaError_t (0 =
// success); cudaErrorInvalidValue for a shape the kernel does not take.
int vrl_scl_rows(const void* e, const void* meta, const void* rows, void* out,
                 int Np, int C, float tau, float var, int single, int noself,
                 int pass, void* stream) {
  const Params p = make_params(Np, C, tau, var, single, noself);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == kRowsum) return launch_rows<kRowsum>(e, meta, rows, out, p, s);
  if (pass == kLoss) return launch_rows<kLoss>(e, meta, rows, out, p, s);
  if (pass == kSrow) return launch_rows<kSrow>(e, meta, rows, out, p, s);
  return cudaErrorInvalidValue;
}

// de (Np, C), unscaled. Returns a cudaError_t (0 = success).
int vrl_scl_grad(const void* e, const void* meta, const void* rows,
                 const void* srow, void* de, int Np, int C, float tau, float var,
                 int single, int noself, void* stream) {
  const Params p = make_params(Np, C, tau, var, single, noself);
  if (bad_shape(Np, C)) return cudaErrorInvalidValue;
  const size_t smem = grad_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      scl_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  scl_grad_kernel<<<Np / kTile, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(meta),
      static_cast<const float*>(rows), static_cast<const float*>(srow),
      static_cast<float*>(de), p);
  return cudaGetLastError();
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

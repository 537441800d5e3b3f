// LayerNorm + matmul + bias + activation (+ residual) for Hopper (sm_90a):
//   y = act(LN(x) W^T + b) [+ r]      (LN optional, act none / erf GELU / tanh GELU)
//
// Replaces the TPU kernel `_kernel_ln` of
// video_rep_learning_tpu/ops/matmul_gelu_pallas.py:198 (`ln_matmul_bias_act`,
// #6): LN2 + fc1 + GELU of every ViT block, and LN1 + qkv inside the
// attention half-block. With the LN off and a residual it also computes that
// half-block's projection, `x + attn W_proj^T + b` (vit_block_pallas.py:166);
// with the LN off and the GELU epilogue it replaces `_kernel` of the same
// file (:72, #7, `matmul_bias_gelu`), the MLP's fc1 under VRL_FUSED_LN_MM=0.
// It is also the port of both schedules of the TPU micro-benchmark
// tools/bench_ln_matmul.py (`_kernel_jouter` :34, `_kernel_scratch` :67): it
// normalises each row panel once, whatever the TPU schedule was.
//
// Rounding points are the TPU kernel's: the LN over the full K in fp32
// (mean, then the centred variance), rounded to the compute type before the
// product; products summed in fp32; bias, activation and residual in fp32,
// rounded once.
//
// What bounds it on the H100: operations. fc1 at the MV-Former chunk
// (31400 x 768 -> 3072, bf16) is 148 GFLOP (0.150 ms at 989 TFLOP/s)
// against 290 MB of traffic (0.087 ms at 3.35 TB/s). bf16 runs
// `ln_gemm_wgmma_kernel`:
//   - a persistent grid, one block an SM, walks row panels of 64 rows. Its
//     two consumer warpgroups normalise the panel once (`ln_panel.cuh`: 16 B
//     loads, one warp two rows at a time, each row held in registers; the
//     panel's rows were
//     prefetched into L2 while the block worked on the one before) and write
//     it straight into the 128 B-swizzled K-major layout wgmma reads A
//     from: K / 64 column blocks of 64 rows x 128 B;
//   - the panel's 128-column tiles alternate between the two warpgroups,
//     block b starting at tile b % (F / 128) so that the blocks stream
//     different parts of W at once. Producer warp r streams warpgroup r's
//     tiles of W's (F, K) rows by TMA, boxes of 128 rows x 64 K (16 KB,
//     128 B swizzle; K past the end zero-filled), into ring r of
//     mbarrier-guarded stages: each warpgroup waits on its own stages in
//     order (an mbarrier's parity names one phase, and a consumer that
//     skipped the other warpgroup's phases of a shared ring could read a
//     stale one);
//   - each warpgroup runs wgmma m64n128k16 from the panel and its ring, 4 a
//     stage, and releases a stage once the next stage's products are
//     issued; one warpgroup's epilogue runs under the other's products;
//   - the epilogue works on the accumulator registers: bias, activation,
//     residual in fp32, one bf16 rounding. Without an activation (qkv,
//     proj) it goes through a 16 KB shared tile a warpgroup in the 128 B
//     swizzle (the residual tile comes in by TMA, the output goes out by two
//     TMA stores, rows past M not written); with the GELU each thread
//     stores its bf16 pairs itself (see `staged_epilogue`).
// The activation is a template parameter: as a runtime argument it cost
// ~20% even where it was none (qkv 0.435 -> 0.342 ms, `chip_smoke.py`).
// What this leaves (NVIDIA H100 80GB HBM3, 700 W; PERF.md): qkv ~0.34 ms,
// proj ~0.13, fc1 ~0.67, 217-325 TFLOP/s. Each W stage feeds only 64 rows
// (a 128-row full-K panel would leave no room for a ring), so W crosses L2
// and shared memory once per 64 rows; the panel's LN stalls both
// warpgroups; and fc1's erf GELU epilogue is longer than the other
// warpgroup's products it should hide under (without the GELU, fc1 ran at
// qkv's rate).
// Shared memory (227 KB = 232,448 B a block; 1,280 B of alignment slack
// and barriers besides): the panel is 128 K bytes, the staging 32 KB where
// the epilogue is staged, and each ring takes min(4, what is left / 32 KB)
// stages of 16 KB:
//   K =  384: panel  49,152 [+ staging 32,768] + 2 x 4 stages 131,072
//             = 180,224 B [212,992 B]
//   K =  768: panel  98,304 + 2 x 4 stages 131,072 = 229,376 B
//             [panel + staging 32,768 + 2 x 3 stages 98,304 = 229,376 B]
//   K = 1024: panel 131,072 + 2 x 3 stages  98,304 = 229,376 B
//             [panel + staging 32,768 + 2 x 2 stages 65,536 = 229,376 B]
//   K = 1536: panel 196,608 + 2 x 1 stage   32,768 = 229,376 B, never
//             staged (a ring of one stage: each stage is released as soon
//             as its products are done, before the next is waited on)
// ptxas -v (sm_90a): 167 registers without an activation (the staged
// epilogue), 150 with the erf GELU, 148 with the tanh GELU; no stack, no
// spills; dynamic shared memory 230,656 B at K = 768 (the sums above plus
// the slack); one block of 320 threads an SM. The fp32 kernel: 64
// registers, no spills, 115,200 B at K = 768.
// fp32 operands stay on fp32 FMA (4 x 4 outputs a thread, 32-row blocks),
// never TF32.
//
// x (M, K), w (F, K), residual and out (M, F): contiguous, all fp32 or all
// bf16 (bf16: 16 B aligned); ln_scale, ln_bias (K,) and bias (F,) fp32;
// ln_scale null = no LN, residual null = none. K a multiple of 32 up to
// 1536, F of 128, any M. No allocation; launches on the caller's stream and
// returns cudaGetLastError() (or the tensor map's refusal).

#include "common.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"
#include "ln_panel.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace vrl;
using namespace vrl::sm90;

constexpr int kThreads = 256;       // fp32 kernel
constexpr int kBN = 128;            // output columns a tile
constexpr int kBK = 32;             // K of one fp32 W tile; K's multiple
constexpr int kBMF32 = 32;
constexpr int kMaxSmem = 232448;    // 227 KB a block on the H100

// the bf16 wgmma kernel
constexpr int kWgThreads = 320;     // two consumer warpgroups + two producer warps
constexpr int kStageBytes = kBN * kChunkK * 2;          // 16 KB
constexpr int kMaxStages = 8;       // both rings together
constexpr int kSmemSlack = 1024 + 256;  // alignment, barriers
constexpr int kStagedMaxK = 1024;   // above it the tile staging does not fit
constexpr int kStagingBytes = kPanelRows * kBN * 2;     // 16 KB a warpgroup

__device__ __forceinline__ void finish(float acc, int m, int n, int F,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ res,
                                       float* __restrict__ out, int act) {
  float y = activate(acc + bias[n], act);
  const size_t i = (size_t)m * F + n;
  if (res != nullptr) y += res[i];
  out[i] = y;
}

int panel_bytes(int K) { return (K + kChunkK - 1) / kChunkK * kChunkBytes; }
// Whether the epilogue goes through shared memory and TMA stores: without an
// activation, where the stores (and the residual's loads) are most of it
// (proj 0.220 -> 0.151 ms at the MV-Former chunk on an H100 80GB HBM3,
// `chip_smoke.py`); with the GELU its arithmetic is, and staging it ran
// slower than the ring stage the staging takes.
__host__ __device__ inline bool staged_epilogue(int K, int act) {
  return K <= kStagedMaxK && act == 0;
}
int staging_bytes(int K, int act) { return staged_epilogue(K, act) ? 2 * kStagingBytes : 0; }
// Stages of each of the two rings.
int ring_stages(int K, int act) {
  const int s = (kMaxSmem - kSmemSlack - panel_bytes(K) - staging_bytes(K, act)) /
                (2 * kStageBytes);
  return s < kMaxStages / 2 ? s : kMaxStages / 2;
}
size_t smem_wgmma(int K, int act) {
  return kSmemSlack + panel_bytes(K) + staging_bytes(K, act) +
         (size_t)2 * ring_stages(K, act) * kStageBytes;
}
size_t smem_f32(int K) { return sizeof(float) * (kBMF32 * K + kBN * (kBK + 1)); }

template <int ACT>
__global__ void __launch_bounds__(kWgThreads, 1)
ln_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap out_map,
                     const __grid_constant__ CUtensorMap res_map,
                     const bf16* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ be, const float* __restrict__ bias,
                     const bf16* __restrict__ res, bf16* __restrict__ out, int M, int K,
                     int F, float eps, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* panel = align1024(smem_raw);
  const int nkc = (K + kChunkK - 1) / kChunkK;
  const bool staged = staged_epilogue(K, ACT);
  // two rings of `stages` stages, ring r feeding warpgroup r; then each
  // warpgroup's output staging (two 64 x 64 halves, 128 B swizzle)
  unsigned char* rings = panel + nkc * kChunkBytes;
  unsigned char* staging = rings + 2 * stages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + (staged ? 2 * kStagingBytes : 0));
  uint64_t* empty = full + kMaxStages;
  uint64_t* resbar = empty + kMaxStages;  // a warpgroup's residual tile is in
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nj = F / kBN, panels = (M + kPanelRows - 1) / kPanelRows;
  // block b walks the column tiles from tile b % nj on, so that the blocks
  // stream different parts of W at any one time
  const int first = blockIdx.x % nj;

  if (tid == 0) {
    for (int s = 0; s < 2 * stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init(&resbar[0], 1);
    mbar_init(&resbar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warp 8 + r: ring r's W stages in (panel, tile,
    const int r = warp - 8;  // K block) order, its tiles being j = r, r + 2, ...
    if (lane == 0) {
      uint32_t t = 0;
      for (int p = blockIdx.x; p < panels; p += gridDim.x) {
        const int next = p + gridDim.x;  // its rows into L2 while this one runs
        if (r == 0 && next < panels) {
          const int rows = min(kPanelRows, M - next * kPanelRows);
          prefetch_l2(x + (size_t)next * kPanelRows * K, (uint32_t)rows * K * 2);
        }
        for (int jj = r; jj < nj; jj += 2) {
          const int j = (first + jj) % nj;
          for (int c = 0; c < nkc; ++c, ++t) {
            const int s = r * stages + t % stages;
            mbar_wait(&empty[s], ((t / stages) & 1) ^ 1);
            mbar_expect_tx(&full[s], kStageBytes);
            tma_load_2d(rings + s * kStageBytes, &w_map, &full[s], c * kChunkK, j * kBN);
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // consumer warpgroup: tiles wg, wg + 2, ... from ring wg
  const int row = 16 * (warp & 3) + (lane >> 2), col = 2 * (lane & 3);
  const bool issuer = (tid & 127) == 0;  // the warpgroup's TMA thread
  unsigned char* stage_out = staging + wg * kStagingBytes;
  uint32_t t = 0;            // stages this warpgroup has consumed
  uint32_t tiles = 0;        // tiles it has finished
  for (int p = blockIdx.x; p < panels; p += gridDim.x) {
    const int m0 = p * kPanelRows;
    named_barrier(1, 256);  // every product on the previous panel is done
    load_panel(panel, x, g, be, m0, M, K, eps, warp, lane);
    fence_proxy_async();
    named_barrier(1, 256);
    for (int jj = wg; jj < nj; jj += 2, ++tiles) {
      const int j = (first + jj) % nj;
      const int n0 = j * kBN;
      if (staged && issuer) {  // the last tile's stores have read the staging:
        bulk_wait_read();      // the residual tile may come into it
        if (res != nullptr) {
          mbar_expect_tx(&resbar[wg], kStagingBytes);
          tma_load_2d(stage_out, &res_map, &resbar[wg], n0, m0);
          tma_load_2d(stage_out + kStagingBytes / 2, &res_map, &resbar[wg], n0 + 64, m0);
        }
      }
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int c = 0; c < nkc; ++c, ++t) {
        const int s = wg * stages + t % stages;
        mbar_wait(&full[s], (t / stages) & 1);
        const uint64_t da = make_desc(panel + c * kChunkBytes, 1024, 1024, kSwizzle128);
        const uint64_t db = make_desc(rings + s * kStageBytes, 1024, 1024, kSwizzle128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunkK / 16; ++kk)
          wgmma_ss<128>(acc, desc_add(da, 32 * kk), desc_add(db, 32 * kk), 1);
        wgmma_commit();
        if (stages > 1) {  // the previous stage's products are done: release it
          wgmma_wait<1>();
          if (c > 0 && lane == 0) mbar_arrive(&empty[prev]);
        } else {           // one stage a ring (K > 1024): release it now
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (stages > 1 && lane == 0) mbar_arrive(&empty[prev]);

      if (staged) {
        // through the staging: each value to its place in the swizzled
        // (64 x 64) x 2 tile (conflict-free: the 8 rows a store instruction
        // touches sit in 8 different 16 B chunks), then two TMA stores
        named_barrier(2 + wg, 128);  // the issuer has seen the staging free
        if (res != nullptr) mbar_wait(&resbar[wg], tiles & 1);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int n = n0 + col + 8 * q;
          const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row + 8 * half;
            unsigned char* at = stage_out + (q >> 3) * (kStagingBytes / 2) + r * 128 +
                                (((q & 7) ^ (r & 7)) << 4) + 4 * (lane & 3);
            float y0 = activate(acc[4 * q + 2 * half] + b0, ACT);
            float y1 = activate(acc[4 * q + 2 * half + 1] + b1, ACT);
            if (res != nullptr) {
              const uint32_t rr = *reinterpret_cast<const uint32_t*>(at);
              y0 += bf16_lo(rr);
              y1 += bf16_hi(rr);
            }
            *reinterpret_cast<uint32_t*>(at) = pack_bf16(y0, y1);
          }
        }
        fence_proxy_async();
        named_barrier(2 + wg, 128);
        if (issuer) {  // rows past M are not written
          tma_store_2d(&out_map, stage_out, n0, m0);
          tma_store_2d(&out_map, stage_out + kStagingBytes / 2, n0 + 64, m0);
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int n = n0 + col + 8 * q;
          const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + row + 8 * half;
            if (m < M) {
              float y0 = activate(acc[4 * q + 2 * half] + b0, ACT);
              float y1 = activate(acc[4 * q + 2 * half + 1] + b1, ACT);
              const size_t i = (size_t)m * F + n;
              if (res != nullptr) {
                const uint32_t rr = *reinterpret_cast<const uint32_t*>(res + i);
                y0 += bf16_lo(rr);
                y1 += bf16_hi(rr);
              }
              *reinterpret_cast<uint32_t*>(out + i) = pack_bf16(y0, y1);
            }
          }
        }
      }
    }
  }
  if (issuer) bulk_wait();  // the last stores are complete before the block ends
}

__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ be, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ out, int M, int K, int F, int act, float eps) {
  constexpr int BM = kBMF32;
  constexpr int kBS = kBK + 1;  // padded W tile row: conflict-free reads
  extern __shared__ float smf[];
  float* As = smf;
  float* Bs = smf + BM * K;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  load_a_panel<float, BM, kThreads>(x, g, be, As, K, m0, M, K, eps);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the A panel is in; the last tile's reads are done
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      Bs[r * kBS + cc] = w[(size_t)(n0 + r) * K + k0 + cc];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 8 * i) * K + k0 + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 32 * j) * kBS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) finish(acc[i][j], m, n0 + tx + 32 * j, F, bias, res, out, act);
    }
  }
}

template <int ACT>
cudaError_t launch_bf16(const void* x, const float* g, const float* be, const void* w,
                        const float* b, const void* residual, void* out, int M, int K,
                        int F, float eps, cudaStream_t s) {
  constexpr int act = ACT;
  const int stages = ring_stages(K, act);
  if (stages < 1) return cudaErrorInvalidValue;
  CUtensorMap map, out_map, res_map;
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)F};
  const uint64_t strides[1] = {(uint64_t)K * 2};
  const uint32_t box[2] = {kChunkK, kBN};
  cudaError_t err = encode_bf16_map(&map, 2, w, dims, strides, box,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  // a staged epilogue's out and residual in boxes of 64 rows x 64 columns
  // (128 B swizzle); the maps go unread otherwise
  out_map = res_map = map;
  if (staged_epilogue(K, act)) {
    const uint64_t odims[2] = {(uint64_t)F, (uint64_t)M};
    const uint64_t ostrides[1] = {(uint64_t)F * 2};
    const uint32_t obox[2] = {64, kPanelRows};
    err = encode_bf16_map(&out_map, 2, out, odims, ostrides, obox,
                          CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess && residual != nullptr)
      err = encode_bf16_map(&res_map, 2, residual, odims, ostrides, obox,
                            CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = smem_wgmma(K, act);
  err = cudaFuncSetAttribute(ln_gemm_wgmma_kernel<ACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int panels = (M + kPanelRows - 1) / kPanelRows;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  ln_gemm_wgmma_kernel<ACT><<<panels < sms ? panels : sms, kWgThreads, smem, s>>>(
      map, out_map, res_map, static_cast<const bf16*>(x), g, be, b,
      static_cast<const bf16*>(residual),
      static_cast<bf16*>(out), M, K, F, eps, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 none, 1 exact (erf) GELU, 2 tanh GELU. dtype: 0 fp32, 1 bf16.
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a shape the
// kernel does not take (K % 32, F % 128, K > 1536 in bf16, a panel over
// 227 KB in fp32).
int vrl_ln_gemm(const void* x, const void* ln_scale, const void* ln_bias,
                const void* w, const void* bias, const void* residual, void* out,
                int M, int K, int F, int act, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || K % kBK || F <= 0 || F % kBN || act < 0 || act > 2)
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ln_scale);
  const auto* be = static_cast<const float*>(ln_bias);
  const auto* b = static_cast<const float*>(bias);
  if (dtype == 1) {
    if (K > kMaxRowChunks * 32 * 8) return cudaErrorInvalidValue;
    if (act == 1) return launch_bf16<1>(x, g, be, w, b, residual, out, M, K, F, eps, s);
    if (act == 2) return launch_bf16<2>(x, g, be, w, b, residual, out, M, K, F, eps, s);
    return launch_bf16<0>(x, g, be, w, b, residual, out, M, K, F, eps, s);
  }
  if (dtype == 0) {
    const size_t smem = smem_f32(K);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(F / kBN, (M + kBMF32 - 1) / kBMF32);
    gemm_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), g, be, static_cast<const float*>(w), b,
        static_cast<const float*>(residual), static_cast<float*>(out), M, K, F, act,
        eps);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

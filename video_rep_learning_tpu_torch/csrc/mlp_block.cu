// The ViT's whole MLP half-block for Hopper (sm_90a), in one launch:
//   y = x + act(LN(x) W1^T + b1) W2^T + b2      (act: erf GELU / tanh GELU / none)
//
// Replaces the TPU kernel `_kernel_mlp` of
// video_rep_learning_tpu/ops/matmul_gelu_pallas.py:341 (`ln_mlp_block`, #9),
// which the JAX package takes under VRL_FUSED_MLP=1. Rounding points are the
// TPU kernel's: the LN over the full K in fp32, rounded to the compute type;
// fc1 sums in fp32, adds b1, applies the activation in fp32 and rounds once
// to the compute type before fc2; fc2 sums in fp32, adds b2 and x in fp32
// and rounds once.
//
// What bounds it on the H100: operations. At the MV-Former chunk (31400
// rows, K 768, F 3072, bf16) it is 296 GFLOP (0.30 ms at 989 TFLOP/s)
// against 97 MB of device traffic. The point of the fusion is that the
// (rows, F) activation never reaches device memory (193 MB each way a chunk
// between an fc1 kernel and fc2). The TPU kernel keeps one image's rows in
// 15 MB of VMEM; a Hopper SM has 227 KB of shared memory and 256 KB of
// registers, and a 64-row panel's fc2 sum alone (64 x 768 fp32) is 192 KB.
// bf16 runs `mlp_wgmma_kernel`:
//   - a persistent grid, one block an SM, walks row panels of 64 rows
//     (wgmma's M). Two consumer warpgroups normalise the panel once into the
//     128 B-swizzled K-major layout wgmma reads A from (`ln_panel.cuh`,
//     96 KB at K 768); rows past M are zeros and are never stored;
//   - fc2's (64 x K) fp32 sum is split by output columns: consumer
//     warpgroup w owns columns [w K/2, (w+1) K/2) as K/128 m64n64
//     accumulators (192 registers a thread at K 768). setmaxnreg hands the
//     producer warpgroup's registers to the consumers (240 each, the
//     producer 24: 2 x 128 x 240 + 128 x 24 = 65,536 - 1,024);
//   - F is walked in tiles of 64 columns. Each warpgroup forms its 32
//     columns of the tile's fc1 (m64n32k16 from the panel; 16 registers),
//     adds b1, applies the activation and rounds in registers, and writes
//     bf16 pairs into the tile's 8 KB `h` (64 x 64, 128 B swizzle). A named
//     barrier of both warpgroups hands `h` over; each then runs fc2 with `h`
//     as A and its own rows of W2 as B. `h` is double-buffered: a warpgroup
//     writes tile j's `h` only after both have passed tile j-1's barrier,
//     which each reaches after its fc2 of tile j-2 is done;
//   - one producer warp a consumer warpgroup streams that warpgroup's
//     weights by TMA into its own ring of 8 KB stages guarded by mbarriers
//     (a ring a consumer: an mbarrier's parity names one phase, so two
//     consumers skipping each other's phases of one ring could read a stale
//     stage): per tile, K/128 stages of W1 (two boxes of 32 rows x 64 K)
//     then K/128 stages of W2 (64 output rows x the tile's 64 columns of
//     F). A consumer releases a stage once the next stage's products are
//     issued and the previous group is done. Blocks start their walk of F
//     at different tiles, so that they stream different parts of W at once;
//   - the epilogue adds b2 and x (read from device memory) to the sum in
//     fp32, rounds once, writes bf16 into the panel's buffer (the panel is
//     no longer read by then) in the 128 B swizzle, and TMA stores the
//     warpgroup's columns in 64 x 64 boxes (rows past M not written). The
//     next panel's LN waits until the stores have read the buffer.
// Per 64-row panel the block streams all of W1 and W2 from L2 (9.44 MB at K
// 768 and F 3072, 64 FLOP a byte); a 128-row panel would need twice the
// accumulator registers.
// Shared memory (227 KB = 232,448 B a block; 1,280 B of alignment slack
// and barriers besides): the panel K / 64 x 8 KB, `h` 2 x 8 KB, and two
// rings of min(8, what is left / 16 KB) stages of 8 KB:
//   K = 128: panel 16,384 + h 16,384 + 2 x 8 stages 131,072 = 163,840 B
//   K = 384: panel 49,152 + h 16,384 + 2 x 8 stages 131,072 = 196,608 B
//   K = 768: panel 98,304 + h 16,384 + 2 x 7 stages 114,688 = 229,376 B
// ptxas -v (sm_90a): 168 registers at launch (384 threads; setmaxnreg then
// gives the consumers 240), no stack or spills without an activation or
// with the tanh GELU, 24 B of stack and spill stores (32 B of loads) with
// the erf GELU; dynamic shared memory 230,656 B at K = 768; one block of
// 384 threads an SM. The fp32 kernel: 162 registers at K = 768, no spills.
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 1.23 ms at
// the chunk (242 TFLOP/s, a quarter of the bound), 13.5 ms at 480 frames,
// ~1.9x layer_norm + linear + gelu + linear + add. W does not set the pace:
// multicasting each W stage to a 2-block cluster halved the L2 traffic
// and ran no faster, and the time follows the number of blocks. A tile
// (64 rows x 64 columns of F) takes ~6.4 us an SM (4 panels of 48 tiles
// on the busiest SMs) against 1.7 us of tensor work at the peak: small
// wgmma groups, one in flight a warpgroup while the next is issued, and the
// pipe drained for the activation. Keeping more groups in flight, or
// running the activation under fc2's products, each needed more than 240
// registers at K = 768 (ptxas serialised the wgmmas and spilled; both ran
// slower): the register file bounds this design, not W or shared memory.
// fp32 operands stay on fp32 FMA (`mlp_f32_kernel`: 32-row blocks, fc2's sum
// in registers, 4 rows x K/32 columns a thread), never TF32.
//
// x, out (M, K); w1 (F, K); w2 (K, F): contiguous, all fp32 or all bf16
// (bf16: 16 B aligned); ln_scale, ln_bias, b2 (K,) and b1 (F,) fp32. K a
// multiple of 128 up to 768, F a multiple of 64, any M. No allocation;
// launches on the caller's stream and returns cudaGetLastError() (or the
// tensor map's refusal).

#include "common.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"
#include "ln_panel.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace vrl;
using namespace vrl::sm90;

constexpr int kMaxSmem = 232448;    // 227 KB a block on the H100

// the fp32 FMA kernel
constexpr int kThreads = 256;
constexpr int kBM = 32;          // token rows a block
constexpr int kBF32 = 32;        // fc1 columns a tile
constexpr int kLd32 = kBF32 + 1; // fp32 tiles' row stride: conflict-free reads

inline size_t f32_smem(int K) {
  return sizeof(float) * (kBM * K + K * kLd32 + 2 * kBF32 * kLd32);
}

// the bf16 wgmma kernel
constexpr int kWgThreads = 384;     // two consumer warpgroups + one producer warpgroup
constexpr int kConsumerRegs = 240;  // setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 384 x 168
constexpr int kProducerRegs = 24;
constexpr int kBF = 64;             // fc1 columns (= fc2 depth) a tile
constexpr int kHalfBF = kBF / 2;    // of which a consumer warpgroup forms
constexpr int kMaxNK = 6;           // K / 128 <= 6: fc2's accumulators a warpgroup
constexpr int kStageBytes = 8192;   // W1: 32 rows x 128 K; W2: 64 rows x 64 F
constexpr int kW1BoxBytes = kHalfBF * kChunkK * 2;  // 4 KB: 32 rows x 64 K
constexpr int kHBytes = kPanelRows * kBF * 2;       // 8 KB: the fc1 tile in bf16
constexpr int kMaxStages = 8;       // each ring
constexpr int kSmemSlack = 1024 + 256;  // alignment, barriers

// Stages of each of the two rings.
int ring_stages(int K) {
  const int s = (kMaxSmem - kSmemSlack - K / kChunkK * kChunkBytes - 2 * kHBytes) /
                (2 * kStageBytes);
  return s < kMaxStages ? s : kMaxStages;
}
size_t smem_wgmma(int K) {
  return kSmemSlack + (size_t)K / kChunkK * kChunkBytes + 2 * kHBytes +
         (size_t)2 * ring_stages(K) * kStageBytes;
}

template <int ACT>
__global__ void __launch_bounds__(kWgThreads, 1)
mlp_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                 const __grid_constant__ CUtensorMap w2_map,
                 const __grid_constant__ CUtensorMap out_map,
                 const bf16* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ be, const float* __restrict__ b1,
                 const float* __restrict__ b2, int M, int K, int F, float eps,
                 int stages) {
  extern __shared__ unsigned char smem_raw[];
  const int nk = K / 128;  // stages of W1 and of W2 a tile; fc2's accumulators
  unsigned char* panel = align1024(smem_raw);
  unsigned char* hbuf = panel + 2 * nk * kChunkBytes;
  unsigned char* rings = hbuf + 2 * kHBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(rings + 2 * stages * kStageBytes);
  uint64_t* empty = full + 2 * kMaxStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = F / kBF, panels = (M + kPanelRows - 1) / kPanelRows;
  // block b walks the tiles of F from tile b % nt on
  const int first = blockIdx.x % nt;

  if (tid == 0) {
    for (int s = 0; s < 2 * stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup; warp 8 + r fills ring r
    setmaxnreg_dec<kProducerRegs>();
    const int r = warp - 8;
    if (r < 2 && lane == 0) {
      uint32_t t = 0;
      for (int p = blockIdx.x; p < panels; p += gridDim.x) {
        const int next = p + gridDim.x;  // its rows into L2 while this one runs
        if (r == 0 && next < panels) {
          const int rows = min(kPanelRows, M - next * kPanelRows);
          prefetch_l2(x + (size_t)next * kPanelRows * K, (uint32_t)rows * K * 2);
        }
        for (int jj = 0; jj < nt; ++jj) {
          const int f0 = (first + jj) % nt * kBF;
          for (int c = 0; c < 2 * nk; ++c, ++t) {  // nk stages of W1, then nk of W2
            const int s = r * stages + t % stages;
            unsigned char* dst = rings + s * kStageBytes;
            mbar_wait(&empty[s], ((t / stages) & 1) ^ 1);
            mbar_expect_tx(&full[s], kStageBytes);
            if (c < nk) {  // W1 rows f0 + 32 r .., K 128 c .. 128 c + 127
              tma_load_2d(dst, &w1_map, &full[s], 128 * c, f0 + kHalfBF * r);
              tma_load_2d(dst + kW1BoxBytes, &w1_map, &full[s], 128 * c + 64,
                          f0 + kHalfBF * r);
            } else {       // W2 rows (output columns) 64 nk r + 64 b .., F f0 ..
              tma_load_2d(dst, &w2_map, &full[s], f0, 64 * (nk * r + c - nk));
            }
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp >> 2;  // consumer warpgroup: ring wg, output columns of half wg
  const int row = 16 * (warp & 3) + (lane >> 2), q = lane & 3;
  const bool issuer = (tid & 127) == 0;  // the warpgroup's TMA store thread
  unsigned char* ring = rings + wg * stages * kStageBytes;
  uint64_t* wfull = full + wg * stages;
  uint64_t* wempty = empty + wg * stages;
  uint32_t t = 0;      // stages this warpgroup has consumed
  uint32_t tiles = 0;  // tiles it has formed: `h` buffer tiles & 1
  int prev = -1;       // the stage whose products may still run
  float acc[kMaxNK][32];
  auto release = [&](int s) {  // stage s of this warpgroup's ring
    if (lane == 0) mbar_arrive(&wempty[s]);
  };

  for (int p = blockIdx.x; p < panels; p += gridDim.x) {
    const int m0 = p * kPanelRows;
    if (issuer) bulk_wait_read();  // the last panel's stores have read the buffer
    named_barrier(1, 256);
    load_panel(panel, x, g, be, m0, M, K, eps, warp, lane);
    fence_proxy_async();
    named_barrier(1, 256);
#pragma unroll
    for (int b = 0; b < kMaxNK; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;

    for (int jj = 0; jj < nt; ++jj, ++tiles) {
      const int f0 = (first + jj) % nt * kBF;
      unsigned char* h = hbuf + (tiles & 1) * kHBytes;
      // fc1: this warpgroup's 32 columns of the tile, over K in 128-wide stages
      float s1[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s1[i] = 0.f;
      for (int c = 0; c < nk; ++c, ++t) {
        const int s = t % stages;
        mbar_wait(&wfull[s], (t / stages) & 1);
        const uint64_t da = make_desc(panel + 2 * c * kChunkBytes, 1024, 1024, kSwizzle128);
        const uint64_t db = make_desc(ring + s * kStageBytes, 1024, 1024, kSwizzle128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<32>(s1, desc_add(da, 32 * kk), desc_add(db, 32 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<32>(s1, desc_add(da, kChunkBytes + 32 * kk),
                       desc_add(db, kW1BoxBytes + 32 * kk), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0) release(prev);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(s1);
      release(prev);
      prev = -1;
      // + b1, the activation and one rounding in registers; bf16 pairs into
      // this warpgroup's half of h (row r's 16 B chunk c at c ^ (r % 8):
      // the 8 rows a store touches sit in 8 different chunks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kHalfBF * wg + 8 * j + 2 * q;
        const float c0 = b1[f0 + col], c1 = b1[f0 + col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row + 8 * half;
          *reinterpret_cast<uint32_t*>(h + r * 128 + (((col >> 3) ^ (r & 7)) << 4) + 4 * q) =
              pack_bf16(activate(s1[4 * j + 2 * half] + c0, ACT),
                        activate(s1[4 * j + 2 * half + 1] + c1, ACT));
        }
      }
      fence_proxy_async();
      named_barrier(1, 256);  // both halves of h are in
      // fc2: acc += h W2[own columns, f0 .. f0 + 63]^T, one 64-column block a stage
      const uint64_t dh = make_desc(h, 1024, 1024, kSwizzle128);
#pragma unroll
      for (int b = 0; b < kMaxNK; ++b) {
        if (b < nk) {
          const int s = t % stages;
          mbar_wait(&wfull[s], (t / stages) & 1);
          const uint64_t db = make_desc(ring + s * kStageBytes, 1024, 1024, kSwizzle128);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<64>(acc[b], desc_add(dh, 32 * kk), desc_add(db, 32 * kk), 1);
          wgmma_commit();
          wgmma_wait<1>();
          if (prev >= 0) release(prev);
          prev = s;
          ++t;
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < kMaxNK; ++b) fence_regs(acc[b]);
    if (prev >= 0) release(prev);
    prev = -1;

    // out = acc + b2 + x in fp32, one rounding, into the panel's buffer (its
    // 64-column block nk wg + b, 128 B swizzle), then TMA stores
#pragma unroll
    for (int b = 0; b < kMaxNK; ++b) {
      if (b < nk) {
        unsigned char* blk = panel + (nk * wg + b) * kChunkBytes;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = 64 * (nk * wg + b) + 8 * j + 2 * q;
          const float c0 = b2[n], c1 = b2[n + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row + 8 * half, m = m0 + r;
            float y0 = acc[b][4 * j + 2 * half] + c0;
            float y1 = acc[b][4 * j + 2 * half + 1] + c1;
            if (m < M) {
              const uint32_t xr = *reinterpret_cast<const uint32_t*>(x + (size_t)m * K + n);
              y0 += bf16_lo(xr);
              y1 += bf16_hi(xr);
            }
            *reinterpret_cast<uint32_t*>(blk + r * 128 + ((j ^ (r & 7)) << 4) + 4 * q) =
                pack_bf16(y0, y1);
          }
        }
      }
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (issuer) {  // rows past M are not written
      for (int b = 0; b < nk; ++b)
        tma_store_2d(&out_map, panel + (nk * wg + b) * kChunkBytes, 64 * (nk * wg + b), m0);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait();  // the last stores are complete before the block ends
}

// NJ: output columns a thread owns (cg + 32 j); K = 32 x NJ. Thread
// (rg, cg) = (tid / 32, tid % 32) owns rows 4 rg .. 4 rg + 3.
template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ be, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int M,
               int F, int act, float eps) {
  constexpr int K = 32 * NJ;
  extern __shared__ float smf[];
  float* As = smf;                 // kBM x K
  float* W2s = As + kBM * K;       // K x kBF32 (stride kLd32)
  float* W1s = W2s + K * kLd32;    // kBF32 x 32-wide K chunk
  float* Hs = W1s + kBF32 * kLd32; // kBM x kBF32
  const int tid = threadIdx.x, rg = tid >> 5, cg = tid & 31;
  const int m0 = blockIdx.x * kBM;
  load_a_panel<float, kBM, kThreads>(x, g, be, As, K, m0, M, K, eps);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kBF32) {
    __syncthreads();  // the A panel is in; the last tile's reads are done
    for (int i = tid; i < K * kBF32; i += kThreads) {
      const int r = i / kBF32, c = i % kBF32;
      W2s[r * kLd32 + c] = w2[(size_t)r * F + f0 + c];
    }
    // fc1: thread (rg, cg) forms rows 4 rg + i, column cg of the tile
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 32) {
      __syncthreads();  // the last chunk's reads are done
      for (int i = tid; i < kBF32 * 32; i += kThreads) {
        const int r = i / 32, c = i % 32;
        W1s[r * kLd32 + c] = w1[(size_t)(f0 + r) * K + k0 + c];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const float b = W1s[cg * kLd32 + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = fmaf(As[(rg * 4 + i) * K + k0 + k], b, h[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Hs[(rg * 4 + i) * kLd32 + cg] = activate(h[i] + b1[f0 + cg], act);
    __syncthreads();  // the tile and the slab are in
    for (int f = 0; f < kBF32; ++f) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Hs[(rg * 4 + i) * kLd32 + f];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float b = W2s[(cg + 32 * j) * kLd32 + f];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rg * 4 + i;
    if (m < M) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const size_t o = (size_t)m * K + cg + 32 * j;
        out[o] = acc[i][j] + b2[cg + 32 * j] + x[o];
      }
    }
  }
}

template <int NJ>
cudaError_t run_f32(int M, int F, int act, float eps, cudaStream_t s,
                    const void* x, const float* g, const float* be,
                    const void* w1, const float* b1, const void* w2,
                    const float* b2, void* out) {
  const size_t smem = f32_smem(32 * NJ);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlp_f32_kernel<NJ><<<(M + kBM - 1) / kBM, kThreads, smem, s>>>(
      static_cast<const float*>(x), g, be, static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<float*>(out), M, F, act, eps);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_bf16(const void* x, const float* g, const float* be, const void* w1,
                        const float* b1, const void* w2, const float* b2, void* out,
                        int M, int K, int F, float eps, cudaStream_t s) {
  const int stages = ring_stages(K);
  if (stages < 2) return cudaErrorInvalidValue;
  // W1 (F, K) in boxes of 32 rows x 64 K; W2 (K, F) in boxes of 64 rows x
  // 64 F; out (M, K) in boxes of 64 rows x 64 columns; all 128 B swizzle
  CUtensorMap w1_map, w2_map, out_map;
  const uint64_t d1[2] = {(uint64_t)K, (uint64_t)F}, s1[1] = {(uint64_t)K * 2};
  const uint32_t box1[2] = {kChunkK, kHalfBF};
  const uint64_t d2[2] = {(uint64_t)F, (uint64_t)K}, s2[1] = {(uint64_t)F * 2};
  const uint64_t d3[2] = {(uint64_t)K, (uint64_t)M};
  const uint32_t box64[2] = {kChunkK, kPanelRows};
  cudaError_t err = encode_bf16_map(&w1_map, 2, w1, d1, s1, box1, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = encode_bf16_map(&w2_map, 2, w2, d2, s2, box64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = encode_bf16_map(&out_map, 2, out, d3, s1, box64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_wgmma(K);
  err = cudaFuncSetAttribute(mlp_wgmma_kernel<ACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int panels = (M + kPanelRows - 1) / kPanelRows;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  mlp_wgmma_kernel<ACT><<<panels < sms ? panels : sms, kWgThreads, smem, s>>>(
      w1_map, w2_map, out_map, static_cast<const bf16*>(x), g, be, b1, b2, M, K, F,
      eps, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 none, 1 exact (erf) GELU, 2 tanh GELU. dtype: 0 fp32, 1 bf16.
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a shape the
// kernel does not take (K not a multiple of 128 in [128, 768], F not a
// multiple of 64, M < 1) or a missing LN.
int vrl_mlp_block(const void* x, const void* ln_scale, const void* ln_bias,
                  const void* w1, const void* b1, const void* w2, const void* b2,
                  void* out, int M, int K, int F, int act, int dtype, float eps,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K < 128 || K > 128 * kMaxNK || K % 128 || F <= 0 || F % kBF ||
      act < 0 || act > 2 || ln_scale == nullptr || ln_bias == nullptr)
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ln_scale);
  const auto* be = static_cast<const float*>(ln_bias);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* c2 = static_cast<const float*>(b2);
  if (dtype == 1) {
    if (act == 1) return launch_bf16<1>(x, g, be, w1, c1, w2, c2, out, M, K, F, eps, s);
    if (act == 2) return launch_bf16<2>(x, g, be, w1, c1, w2, c2, out, M, K, F, eps, s);
    return launch_bf16<0>(x, g, be, w1, c1, w2, c2, out, M, K, F, eps, s);
  }
  if (dtype == 0) {
#define VRL_MLP_ARGS M, F, act, eps, s, x, g, be, w1, c1, w2, c2, out
    switch (K / 128) {
      case 1: return run_f32<4>(VRL_MLP_ARGS);
      case 2: return run_f32<8>(VRL_MLP_ARGS);
      case 3: return run_f32<12>(VRL_MLP_ARGS);
      case 4: return run_f32<16>(VRL_MLP_ARGS);
      case 5: return run_f32<20>(VRL_MLP_ARGS);
      case 6: return run_f32<24>(VRL_MLP_ARGS);
    }
#undef VRL_MLP_ARGS
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

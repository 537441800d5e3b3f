// A tensor-core matrix product for Hopper (sm_90a), int8 and bf16:
//   out (M, F) = x (M, K) @ w (K, F),
// int8 x int8 summed exactly in int32, or bf16 x bf16 summed in fp32, with w
// in its (K, F) layout as the TPU kernel takes it. No dequantization: the
// TPU kernel returns the int32 sums.
//
// Replaces the TPU kernel `_mm_kernel` (tools/bench_int8_pallas.py:28,
// `_pallas_mm` :37): the ViT-B/8 fc1 product of a 40-frame chunk, (31360,
// 768) x (768, 3072), which that script times in int8 against bf16 to decide
// whether a quantized backbone is worth a GEMM of its own.
//
// What bounds it on the H100: int8, bytes (the int32 output, 385 MB, is most
// of the 412 MB it moves: 0.123 ms at 3.35 TB/s; the 148 G operations take
// 0.075 ms at 1,979 TOPS); bf16, operations (0.150 ms at 989 TFLOP/s, with
// 434 MB to move under it). `gemm_wgmma_kernel`:
//   - persistent: one block an SM walks the 128 x 128 output tiles, tile
//     blockIdx.x + i gridDim.x, F's tiles fastest, so the blocks at work
//     share a few row panels of x and all of w in L2;
//   - a producer warp keeps a TMA ring of 32 KB stages full (five stages,
//     guarded by a "full" and an "empty" mbarrier each; the empty barrier
//     counts lane 0 of each of the eight consumer warps): x as a 128-row
//     box 128 B deep (64 bf16 or 128 int8 of K), w as 128 columns of F by
//     the same depth; the walk of K runs on across tiles, so the next
//     tile's first stages load during this tile's epilogue;
//   - two consumer warpgroups, 64 rows of the tile each, run wgmma with both
//     operands in shared memory: bf16 m64n128k16 with fp32 sums, w read
//     as it lies (K, F) through an MN-major B descriptor (the transpose
//     bit); int8 m64n128k32 with int32 sums. wgmma takes 8-bit operands
//     K-major only, so for int8 the wrapper's scratch holds w transposed to
//     (F, K) by `transpose_s8_kernel` first (2.4 MB read and written at
//     fc1's shape, against w re-read by each of the 245 row panels). A
//     stage is released once the next stage's products are issued and the
//     previous group is done;
//   - the epilogue: each warpgroup writes its 64 x 128 sums (fp32 or int32)
//     into its own 32 KB staging buffer in four 64 x 32 boxes in the 128 B
//     swizzle (conflict-free st.shared), and one thread stores them with
//     TMA. The next tile's products run under the stores; the buffer is
//     reused only after `bulk_wait_read` says the stores have read it.
// Shared memory: 2 x 32 KB staging + 5 x 32 KB stages + 1,280 B of
// alignment and barriers = 230,656 B; 288 threads, one block an SM. ptxas
// -v (sm_90a): 95 registers in both types, no stack, no spills.
// What the card showed (NVIDIA H100 80GB HBM3, 700 W; PERF.md): int8
// at ~70% of its bytes bound; bf16 at half the tensor-core peak, ~6.4 us a
// tile against 3.4 us of products at the peak. The likeliest limit (no L2
// counters are readable there) is operand traffic: a 128 x 128 tile reads
// 393 KB of x and w from L2 for 25 MFLOP (64 FLOP a byte, ~8 TB/s at the
// measured rate); wider tiles need more staging for the fp32 output than
// shared memory holds beside a ring.
//
// x (M, K), w (K, F), out (M, F) contiguous and 16-byte aligned; M a multiple
// of 128, K of 32, F of 128 (a K tail below the stage's depth is TMA's zero
// fill); for int8 a scratch of F x K bytes. No allocation; launches on the
// caller's stream and returns cudaGetLastError() (or a tensor map's
// refusal).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace vrl::sm90;

constexpr int kBM = 128, kBN = 128;    // an output tile
constexpr int kDepthBytes = 128;       // K a stage, in bytes: one 128 B swizzle row
constexpr int kBoxBytes = kBM * kDepthBytes;  // 16 KB: x's box, and w's
constexpr int kStageBytes = 2 * kBoxBytes;
constexpr int kOutBox = 64 * 32 * 4;   // 8 KB: 64 rows x 32 fp32 / int32
constexpr int kOutBytes = 4 * kOutBox; // a warpgroup's 64 x 128 sums
constexpr int kThreads = 288;          // two consumer warpgroups, one producer warp
constexpr int kMaxSmem = 232448;       // 227 KB a block on the H100
constexpr int kSlack = 1024 + 256;     // alignment, barriers
constexpr int kMaxStages = 8;

int ring_stages() {
  const int s = (kMaxSmem - kSlack - 2 * kOutBytes) / kStageBytes;
  return s < kMaxStages ? s : kMaxStages;
}

// One 128 x 128 tile's product for a consumer warpgroup: `nk` stages of the
// ring from stage count `t` on, A its 64 rows of the x box.
template <bool INT8, typename Acc>
__device__ __forceinline__ void tile_products(Acc (&acc)[64], unsigned char* ring,
                                              uint64_t* full, uint64_t* empty, int stages,
                                              uint32_t& t, int nk, int wg, int lane) {
  int prev = -1;
  for (int ks = 0; ks < nk; ++ks, ++t) {
    const int s = t % stages;
    mbar_wait(&full[s], (t / stages) & 1);
    unsigned char* stage = ring + s * kStageBytes;
    const uint64_t da = make_desc(stage + wg * (kBoxBytes / 2), 1024, 1024, kSwizzle128);
    wgmma_fence();
    if constexpr (INT8) {
      // wT (F, K): 128 rows of F, K-major like x
      const uint64_t db = make_desc(stage + kBoxBytes, 1024, 1024, kSwizzle128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_s8<128>(acc, desc_add(da, 32 * kk), desc_add(db, 32 * kk), ks | kk);
    } else {
      // w (K, F): two boxes of 64 columns of F (the leading offset, 8 KB
      // apart) x 64 rows of K (16 rows a k16 step)
      const uint64_t db = make_desc(stage + kBoxBytes, kBoxBytes / 2, 1024, kSwizzle128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_tb<128>(acc, desc_add(da, 32 * kk), desc_add(db, 2048 * kk), ks | kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(&empty[prev]);
}

template <bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap out_map, int M, int K, int F,
                  int stages) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  using Acc2 = typename std::conditional<INT8, int2, float2>::type;
  constexpr int kDepth = INT8 ? kDepthBytes : kDepthBytes / 2;  // K a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* staging = align1024(smem_raw);
  unsigned char* ring = staging + 2 * kOutBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = F / kBN, tiles = M / kBM * tiles_n;
  const int nk = (K + kDepth - 1) / kDepth;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      uint32_t t = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
        for (int ks = 0; ks < nk; ++ks, ++t) {
          const int s = t % stages, k0 = ks * kDepth;
          unsigned char* stage = ring + s * kStageBytes;
          mbar_wait(&empty[s], ((t / stages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(stage, &x_map, &full[s], k0, m0);
          if constexpr (INT8) {
            tma_load_2d(stage + kBoxBytes, &w_map, &full[s], k0, n0);
          } else {
            tma_load_2d(stage + kBoxBytes, &w_map, &full[s], n0, k0);
            tma_load_2d(stage + kBoxBytes + kBoxBytes / 2, &w_map, &full[s], n0 + 64, k0);
          }
        }
      }
    }
    return;
  }

  const int wg = warpgroup_index();
  const bool issuer = (tid & 127) == 0;  // the warpgroup's TMA store thread
  unsigned char* out_buf = staging + wg * kOutBytes;
  const int row = 16 * (warp & 3) + (lane >> 2);
  uint32_t t = 0;
  Acc acc[64];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
    tile_products<INT8>(acc, ring, full, empty, stages, t, nk, wg, lane);

    // the sums into the staging buffer: columns 8j + 2(lane % 4) + {0, 1}
    // of rows `row` and `row` + 8, box j / 4, 16 B chunk c at c ^ (r % 8)
    if (issuer) bulk_wait_read();  // the last tile's stores have read it
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int chunk = 2 * (j & 3) + ((lane & 3) >> 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        Acc2 v;
        v.x = acc[4 * j + 2 * half];
        v.y = acc[4 * j + 2 * half + 1];
        *reinterpret_cast<Acc2*>(out_buf + (j >> 2) * kOutBox + r * 128 +
                                 ((chunk ^ (r & 7)) << 4) + 8 * (lane & 1)) = v;
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (issuer) {
      for (int b = 0; b < 4; ++b)
        tma_store_2d(&out_map, out_buf + b * kOutBox, n0 + 32 * b, m0 + 64 * wg);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait();  // the last stores are complete before the block ends
}

// wt (F, K) = w (K, F)^T in bytes, a 32 x 32 tile a block of 32 x 8 threads.
__global__ void transpose_s8_kernel(const signed char* __restrict__ w,
                                    signed char* __restrict__ wt, int K, int F) {
  __shared__ signed char tile[32][33];
  const int f0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8)
    tile[r][threadIdx.x] = w[(size_t)(k0 + r) * F + f0 + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8)
    wt[(size_t)(f0 + r) * K + k0 + threadIdx.x] = tile[threadIdx.x][r];
}

template <bool INT8>
cudaError_t launch(const void* x, const void* w, void* out, void* scratch, int M, int K,
                   int F, cudaStream_t s) {
  const CUtensorMapDataType in_type =
      INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t esize = INT8 ? 1 : 2;
  const uint32_t depth = kDepthBytes / esize;
  CUtensorMap x_map, w_map, out_map;
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)M}, sx[1] = {K * esize};
  const uint32_t box_x[2] = {depth, kBM};
  cudaError_t err = vrl::encode_map(&x_map, in_type, 2, x, dx, sx, box_x,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if (INT8) {  // wT (F, K) in boxes of 128 rows x 128 K
    const dim3 grid(F / 32, K / 32);
    transpose_s8_kernel<<<grid, dim3(32, 8), 0, s>>>(static_cast<const signed char*>(w),
                                                     static_cast<signed char*>(scratch), K, F);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const uint64_t dw[2] = {(uint64_t)K, (uint64_t)F}, sw[1] = {(uint64_t)K};
    const uint32_t box_w[2] = {depth, kBN};
    err = vrl::encode_map(&w_map, in_type, 2, scratch, dw, sw, box_w,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  } else {     // w (K, F) in boxes of 64 K rows x 64 columns of F
    const uint64_t dw[2] = {(uint64_t)F, (uint64_t)K}, sw[1] = {(uint64_t)F * 2};
    const uint32_t box_w[2] = {64, depth};
    err = vrl::encode_map(&w_map, in_type, 2, w, dw, sw, box_w, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return err;
  const uint64_t dout[2] = {(uint64_t)F, (uint64_t)M}, sout[1] = {(uint64_t)F * 4};
  const uint32_t box_out[2] = {32, 64};
  err = vrl::encode_map(&out_map,
                        INT8 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        2, out, dout, sout, box_out, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;

  const int stages = ring_stages();
  const size_t smem = kSlack + 2 * (size_t)kOutBytes + (size_t)stages * kStageBytes;
  err = cudaFuncSetAttribute(gemm_wgmma_kernel<INT8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = vrl::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = M / kBM * (F / kBN);
  gemm_wgmma_kernel<INT8><<<tiles < sms ? tiles : sms, kThreads, smem, s>>>(
      x_map, w_map, out_map, M, K, F, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 2: int8 in, int32 out, `scratch` F x K bytes (w transposed there);
// dtype 1: bf16 in, fp32 out, no scratch. Returns a cudaError_t (0 =
// success); cudaErrorInvalidValue for a shape or type the kernel does not
// take.
int vrl_tc_gemm(const void* x, const void* w, void* out, void* scratch, int M, int K,
                int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || F <= 0 || M % kBM || K % 32 || F % kBN)
    return cudaErrorInvalidValue;
  if (dtype == 2 && scratch != nullptr) return launch<true>(x, w, out, scratch, M, K, F, s);
  if (dtype == 1) return launch<false>(x, w, out, nullptr, M, K, F, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

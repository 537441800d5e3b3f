// The variants of packed ViT self-attention that the TPU micro-benchmarks
// compare, for Hopper (sm_90a): out[b, n, h*64:(h+1)*64] = softmax(q_h k_h^T
// * scale) v_h read straight from the packed (B, N, 3D) qkv, as
// packed_attn.cu does, with each variant's own softmax and rounding.
//
// Replaces the TPU kernels `_kernel_var` (tools/bench_packed_attn.py:57,
// `build_variant`), `_kernel_multi_img` (:96, `build_multi`), `_kernel_grouped`
// and `_kernel_rowtile` (tools/bench_attn_variants.py:54, :72, `build`). Their
// flags map onto template flags and launch arguments:
//   EXP2   log2(e) folded into the scale, exp2 in place of exp; without it
//          expf of the scaled logit (the rows that measure exp vs exp2);
//   NOMAX  the max-free softmax of `_softmax` (bench_packed_attn.py:43):
//          p = exp2(min(s, 110)) (exp(min(s, 76)) without EXP2), no floor
//          and no row max, so one pass over the keys with no rescale of the
//          accumulator and the row sum l reduced once at the end; without
//          it, the exact max-subtracted softmax, online over 64-key tiles
//          as packed_attn.cu's MAXSUB (the TPU subtracts the full-row max
//          at once);
//   bf16p  l sums p rounded to bf16 (`build_multi(bf16p=True)`); otherwise l
//          sums the fp32 p. P is rounded to bf16 before P V in every form;
//   block_q 64, or 256 for `rowtile`: four consumer warpgroups of 64 rows
//          that share every K and V tile, loaded once for all 256 rows;
//   heads_per_block (1, 2, 12) and images_per_block (1, 2, 4): one block
//          covers those heads x images x block_q rows (the TPU's head pairs a
//          program and `imgs`); they set the schedule, not the values.
// Rounding against the TPU's one-shot softmax: with the max subtracted, a
// tile's p is rounded against the running max and rescaled in fp32 later,
// so a value may land a bf16 ulp from the one-shot form; the max-free forms
// round the same p at the same point.
//
// What bounds it on the H100: operations, 4 N^2 dh a head and image (75.7
// GFLOP at 40 x 12 heads x 785 tokens x 64: 0.077 ms at 989 TFLOP/s). Both
// products run on the tensor cores, in packed_attn.cu's (#4's) design:
//   - one 3-D TMA tensor map over the packed (B, N, 3D) rows gives every
//     tile, rows past N zero-filled (keys past N are masked to p = 0, query
//     rows past N are not stored); 128 B swizzle;
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory; the
//     softmax runs on the accumulator registers; P, rounded to bf16 in
//     registers, is the A operand of O += P V (m64n64k16) with V read
//     MN-major; O stays in fp32 registers and each thread stores its bf16
//     pairs of o / l.
// The schedule. A block's items are its (image, head) pairs. Its consumer
// warpgroups form `groups` groups of SUB = block_q / 64 warpgroups; group g
// walks items g, g + groups, ... and each of its warpgroups owns 64 of the
// block's query rows. Each group has one ring of K/V stages (16 KB: a K and
// a V tile) with a "full" mbarrier (the TMA bytes) and an "empty" one a
// stage, whose arrival count is the group's warpgroups: a warpgroup arrives
// once all four of its warps are done with the stage, so the ring is
// refilled only when every warpgroup has read it, and none can fall two
// phases behind and read a stale stage (an mbarrier's parity names one
// phase). One producer warp after the consumers fills every group's ring,
// a tile of each group in turn, behind the empty barriers; a group's walk
// runs on across item boundaries, so the next item's first tiles are in
// flight during the current item's last ones. Each warpgroup loads its own
// 64 rows of Q an item into one of two Q buffers, the next item's while
// the current one runs. A warpgroup whose 64 rows all lie past N (rowtile's
// last query tile) only waits for and releases each stage.
// Why a group a few items wide: a block of many items (img4: 48, at B 40
// only 130 blocks) on one warpgroup would leave most of each SM idle, and
// the row would measure SM starvation, not the schedule. So with block_q 64
// a block runs two warpgroups, one group each (a two-stage ring each, 48 KB
// a warpgroup with its Q buffers), two blocks an SM; where the grid has
// fewer blocks than two an SM (img2, img4 at B 40), four, one block an SM;
// never more than its items. rowtile runs one group of four warpgroups on
// a four-stage ring. Every tool row thus keeps four consumer warpgroups on
// an SM, each computing one 64-row tile at a time, so that one's softmax
// overlaps another's products.
// ptxas -v (sm_90a): 90 registers (max-free exp2), 92, 96 (expf,
// max-subtracted), no stack, no spills; dynamic shared memory 99,424 B (two
// warpgroups), 197,824 B (four) or 132,224 B (rowtile).
// Why a producer warp of its own: in thread 0 of a consumer warpgroup, as
// #4 has it, the ring's bookkeeping (the empty wait, the TMA coordinates,
// the walk's counters) lies on that warpgroup's critical path every tile
// (measured in PERF.md); the walk is counters, not divisions, for
// the same reason.
// Why its own kernel and not #4's body: #4 (packed_attn.cu) is one
// warpgroup a block that refills its own two-stage ring behind
// __syncthreads; the variants need a ring shared by several warpgroups
// with empty barriers, Q buffers that run ahead across items, and expf.
// Sharing one templated body would change #4's compiled code, which was
// redesigned, measured and is not to be taken again; it stays byte for
// byte as it was.
//
// qkv (B, N, 3D) and out (B, N, D), contiguous bf16 (16 B aligned), D =
// H * 64. No allocation; launches on the caller's stream and returns
// cudaGetLastError() (or the tensor map's refusal).

#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace vrl::sm90;

constexpr int kDH = 64;
constexpr int kRows = 64;               // a warpgroup's query rows; a tile's keys
constexpr int kTile = kRows * kDH * 2;  // 8 KB: one 64 x 64 bf16 tile, 128 B rows
constexpr uint32_t kGroup = 1024;       // 8 rows of 128 B: the descriptors' stride
constexpr int kMaxWarpgroups = 4;       // consumer warpgroups a block (and a producer warp)

// K/V stages of a group's ring: two for a lone warpgroup (as #4), four
// for rowtile's four warpgroups on one ring.
template <int SUB>
__host__ __device__ constexpr int ring_stages() { return SUB > 1 ? 4 : 2; }

template <int SUB>
size_t smem_bytes(int groups) {
  const int wgs = SUB * groups, stages = ring_stages<SUB>();
  return 1024 + (size_t)wgs * 2 * kTile + (size_t)groups * stages * 2 * kTile +
         sizeof(uint64_t) * (2 * groups * stages + 2 * wgs);
}

template <bool EXP2>
__device__ __forceinline__ float expo(float x) {
  return EXP2 ? exp2f(x) : expf(x);
}

// SUB: the 64-row warpgroups of a group (block_q / 64). The block is its
// consumer warpgroups, then one producer warp. The bound of 576 threads
// holds registers to 112 a thread, so that two blocks of two warpgroups and
// a producer warp (2 x 288 threads) fit an SM.
template <bool EXP2, bool NOMAX, bool BF16P, int SUB>
__global__ void __launch_bounds__(2 * (2 * 128 + 32), 1)
attn_variant_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                          bf16* __restrict__ out, int H, int N, float scale, int hpb,
                          int ipb, int groups) {
  constexpr int kStages = ring_stages<SUB>();
  constexpr float kClamp = EXP2 ? 110.f : 76.f;  // the TPU's, in its units
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int wgs = SUB * groups;
  unsigned char* qbuf = smem;                    // two Q tiles a warpgroup
  unsigned char* ring = smem + wgs * 2 * kTile;  // kStages (K, V) stages a group
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + groups * kStages * 2 * kTile);
  uint64_t* empty = full + groups * kStages;
  uint64_t* qbar = empty + groups * kStages;     // two a warpgroup

  const int tid = threadIdx.x, wg = warpgroup_index(), warp = (tid >> 5) & 3,
            lane = tid & 31;
  const int D = H * kDH, items = hpb * ipb;
  const int nk = (N + kRows - 1) / kRows;

  if (tid == 0) {
    for (int s = 0; s < groups * kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SUB);
    }
    for (int i = 0; i < 2 * wgs; ++i) mbar_init(&qbar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // item n of group g: image and head
  auto image_of = [&](int g, int n) { return blockIdx.z * ipb + (g + groups * n) / hpb; };
  auto head_of = [&](int g, int n) { return blockIdx.y * hpb + (g + groups * n) % hpb; };

  if (wg == wgs) {  // the producer warp: every group's walk, a tile of each in turn
    if (lane == 0) {
      const int walk = (items + groups - 1) / groups * nk;  // group 0's, the longest
      int j = 0, n = 0, s = 0, round = 0;
      for (int t = 0; t < walk; ++t) {
        for (int g = 0; g < groups; ++g) {
          if (g + groups * n >= items) continue;  // group g's walk has ended
          const int st = g * kStages + s, b = image_of(g, n), h = head_of(g, n);
          mbar_wait(&empty[st], (round & 1) ^ 1);  // its warpgroups are done with round - 1
          unsigned char* dst = ring + st * 2 * kTile;
          mbar_expect_tx(&full[st], 2 * kTile);
          tma_load_3d(dst, &qkv_map, &full[st], D + h * kDH, j * kRows, b);
          tma_load_3d(dst + kTile, &qkv_map, &full[st], 2 * D + h * kDH, j * kRows, b);
        }
        if (++s == kStages) s = 0, ++round;
        if (++j == nk) j = 0, ++n;
      }
    }
    return;
  }

  const int g = wg / SUB, u = wg % SUB;
  const bool wg_lead = (tid & 127) == 0;
  const int mine = (items - g + groups - 1) / groups;  // items g, g + groups, ...
  const int q0 = (blockIdx.x * SUB + u) * kRows;
  const bool live = q0 < N;
  unsigned char* gring = ring + g * kStages * 2 * kTile;
  uint64_t* gfull = full + g * kStages;
  uint64_t* gempty = empty + g * kStages;
  uint64_t* wq = qbar + 2 * wg;
  auto load_q = [&](int n) {  // this warpgroup's rows of item n into buffer n & 1
    uint64_t* bar = &wq[n & 1];
    mbar_expect_tx(bar, kTile);
    tma_load_3d(qbuf + (2 * wg + (n & 1)) * kTile, &qkv_map, bar, head_of(g, n) * kDH, q0,
                image_of(g, n));
  };

  if (live && wg_lead) load_q(0);
  const int col = 2 * (lane & 3);  // first key (and output column) of a pair
  int s = 0, round = 0;            // this warpgroup's stage and ring round
  for (int n = 0; n < mine; ++n) {
    // buffer (n + 1) & 1 held item n - 1's Q, whose products are all done
    if (live && wg_lead && n + 1 < mine) load_q(n + 1);
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float l0 = 0.f, l1 = 0.f;                      // rows r and r + 8
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // the running max (max-subtracted)
    const uint64_t dq = make_desc(qbuf + (2 * wg + (n & 1)) * kTile, kGroup, kGroup,
                                  kSwizzle128);

    for (int j = 0; j < nk; ++j) {
      if (live && j == 0) mbar_wait(&wq[n & 1], (n >> 1) & 1);
      mbar_wait(&gfull[s], round & 1);
      unsigned char* kv = gring + s * 2 * kTile;

      if (live) {
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        const uint64_t dk = make_desc(kv, kGroup, kGroup, kSwizzle128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDH / 16; ++kk)
          wgmma_ss<64>(sc, desc_add(dq, 32 * kk), desc_add(dk, 32 * kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        const int kn = N - j * kRows;  // keys of this tile below N (>= 1)
        if constexpr (NOMAX) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = expo<EXP2>(fminf(sc[4 * jj + e] * scale, kClamp));
              p = 8 * jj + col + (e & 1) < kn ? p : 0.f;
              const float lp = BF16P ? vrl::round_to<bf16>(p) : p;
              if (e < 2) l0 += lp; else l1 += lp;
              sc[4 * jj + e] = p;
            }
        } else {
          float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = 8 * jj + col + (e & 1) < kn ? sc[4 * jj + e] * scale
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
          const float a0 = expo<EXP2>(m0 - n0), a1 = expo<EXP2>(m1 - n1);
          m0 = n0;
          m1 = n1;
          l0 *= a0;
          l1 *= a1;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            o[4 * jj] *= a0;
            o[4 * jj + 1] *= a0;
            o[4 * jj + 2] *= a1;
            o[4 * jj + 3] *= a1;
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = expo<EXP2>(sc[4 * jj + e] - (e < 2 ? n0 : n1));
              const float lp = BF16P ? vrl::round_to<bf16>(p) : p;
              if (e < 2) l0 += lp; else l1 += lp;
              sc[4 * jj + e] = p;
            }
        }

        // P in bf16 as the A operand: keys 16t .. 16t + 15 are accumulator
        // columns 8(2t) .. 8(2t + 1) + 7
        uint32_t pa[4][4];
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          pa[t4][0] = pack_bf16(sc[8 * t4 + 0], sc[8 * t4 + 1]);
          pa[t4][1] = pack_bf16(sc[8 * t4 + 2], sc[8 * t4 + 3]);
          pa[t4][2] = pack_bf16(sc[8 * t4 + 4], sc[8 * t4 + 5]);
          pa[t4][3] = pack_bf16(sc[8 * t4 + 6], sc[8 * t4 + 7]);
        }
        const uint64_t dv = make_desc(kv + kTile, kGroup, kGroup, kSwizzle128);
        wgmma_fence();
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4)
          wgmma_rs_tb<64>(o, pa[t4], desc_add(dv, 16 * 128 * t4), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      named_barrier(1 + wg, 128);  // all four warps are done with stage s
      if (wg_lead) mbar_arrive(&gempty[s]);
      if (++s == kStages) s = 0, ++round;
    }

    if (live) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const int r0 = q0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
      bf16* ob = out + (size_t)image_of(g, n) * N * D + head_of(g, n) * kDH + col;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (r0 < N)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + 8 * jj) =
              __floats2bfloat162_rn(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
        if (r1 < N)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + 8 * jj) =
              __floats2bfloat162_rn(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
      }
    }
  }
}

template <bool EXP2, bool NOMAX, bool BF16P, int SUB>
cudaError_t launch_sub(const CUtensorMap& map, void* out, int B, int H, int N, float scale,
                       int hpb, int ipb, cudaStream_t stream) {
  const dim3 grid((N + SUB * kRows - 1) / (SUB * kRows), H / hpb, B / ipb);
  int sms = 0;
  cudaError_t err = vrl::sm_count(&sms);
  if (err != cudaSuccess) return err;
  // block_q 64: two warpgroups a block (two blocks an SM) where the grid
  // has blocks for two an SM, else four (one block an SM); never more
  // than the block's items
  const int items = hpb * ipb;
  int groups = SUB > 1 ? 1 : (grid.x * grid.y * grid.z >= 2u * sms ? 2 : kMaxWarpgroups);
  if (groups > items) groups = items;
  const size_t smem = smem_bytes<SUB>(groups);
  auto kernel = attn_variant_wgmma_kernel<EXP2, NOMAX, BF16P, SUB>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, SUB * groups * 128 + 32, smem, stream>>>(map, static_cast<bf16*>(out), H, N,
                                                     scale, hpb, ipb, groups);
  return cudaGetLastError();
}

template <bool EXP2, bool NOMAX, bool BF16P>
cudaError_t launch(const void* qkv, void* out, int B, int H, int N, float scale,
                   int block_q, int hpb, int ipb, cudaStream_t stream) {
  const int D = H * kDH;
  CUtensorMap map;
  const uint64_t dims[3] = {(uint64_t)3 * D, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)3 * D * 2, (uint64_t)N * 3 * D * 2};
  const uint32_t box[3] = {kDH, kRows, 1};
  cudaError_t err = vrl::encode_bf16_map(&map, 3, qkv, dims, strides, box,
                                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if (block_q == 256)
    return launch_sub<EXP2, NOMAX, BF16P, 4>(map, out, B, H, N, scale, hpb, ipb, stream);
  return launch_sub<EXP2, NOMAX, BF16P, 1>(map, out, B, H, N, scale, hpb, ipb, stream);
}

template <bool EXP2, bool NOMAX>
cudaError_t by_bf16p(int bf16p, const void* qkv, void* out, int B, int H, int N,
                     float scale, int block_q, int hpb, int ipb, cudaStream_t s) {
  return bf16p ? launch<EXP2, NOMAX, true>(qkv, out, B, H, N, scale, block_q, hpb, ipb, s)
               : launch<EXP2, NOMAX, false>(qkv, out, B, H, N, scale, block_q, hpb, ipb, s);
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
      H / heads_per_block > 65535 || (block_q != 64 && block_q != 256))
    return cudaErrorInvalidValue;
  const int hpb = heads_per_block, ipb = images_per_block;
  if (exp2 && nomax) return by_bf16p<true, true>(bf16p, qkv, out, B, H, N, scale, block_q, hpb, ipb, s);
  if (exp2) return by_bf16p<true, false>(bf16p, qkv, out, B, H, N, scale, block_q, hpb, ipb, s);
  if (nomax) return by_bf16p<false, true>(bf16p, qkv, out, B, H, N, scale, block_q, hpb, ipb, s);
  return by_bf16p<false, false>(bf16p, qkv, out, B, H, N, scale, block_q, hpb, ipb, s);
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

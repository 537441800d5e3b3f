// SSL augmentation for Hopper (sm_90a): RandomResizedCrop on the uint8 canvas
// plus the photometric tail (ColorJitter in a per-view op order, GaussianBlur,
// grayscale, horizontal flip, ImageNet normalisation), or the tail alone on
// frames that are already cropped.
//
// Replaces the TPU kernels `_crop_photometric_kernel` (src_kind 1: uint8
// (BV, T, 3, H, W) canvas, crop rh . x . rw inside the kernel;
// `crop_strip_kernel` below) and `_photometric_kernel` (src_kind 0: already
// cropped fp32 (BV, T, 3, S, S); `photometric_strip_kernel`) of
// video_rep_learning_tpu/ops/photometric_pallas.py.
//
// The TPU kernels hold a whole (3, S, S) frame in VMEM (602 KB in fp32 at
// S = 224); a Hopper block has 227 KB of shared memory. The chain has two
// whole-frame dependencies: the contrast op needs the frame's luma mean (in
// the middle of a random op order), and the blur needs neighbours 4 rows and
// 2 columns away.
//
// Both kernels are one design, `strip_frame`, templated on the source. A
// frame is one thread-block cluster of kStrips = 16 blocks (a non-portable
// cluster size, which the H100 takes), each owning a strip of `rows` output
// rows (14 at S = 224: 16 x 480 = 7,680 blocks of 256 threads a CARL step,
// three an SM). A block:
//   1. stages its strip's source once:
//      - the uint8 canvas (#12): the canvas rows the taps of its rows read,
//        over the crop's columns, 3 channels, by 16-byte loads (byte loads
//        where the canvas width is no multiple of 16); then computes crop +
//        the jitter ops before contrast once a pixel, into shared memory in
//        fp32;
//      - the cropped fp32 frames (#11): its rows of each channel plane, three
//        contiguous runs of rows x S x 4 bytes, copied by `cp.async.bulk`
//        into the fp32 buffer and completing on an mbarrier (4-byte loads
//        where S x 4 bytes or the pointer is no multiple of 16); the jitter
//        ops before contrast then run in place in that buffer;
//   2. sums the luma of its rows, and the cluster exchanges the partial sums
//      through distributed shared memory, each block adding all of them in
//      rank order: the same deterministic mean in every block, with no
//      second pass over the source and no second launch (skipped for a view
//      with jitter off);
//   3. applies contrast and the ops after it in place, then blurs separably:
//      9 taps down into a buffer that takes the dead band's place, reading
//      the 4 halo rows each side from the neighbouring strips' shared memory
//      (distributed shared memory, after a cluster barrier) rather than
//      computing them again, then 5 across; grays, flips, normalises and
//      writes 8 outputs a thread with 16-byte stores.
// Where a strip's rows (and band) do not fit shared memory (S 512, canvases
// above ~1000 rows at S 224) the host plans chunks: a chunk stages its rows
// and their halo and computes the halo again, and since its pre-contrast
// rows cannot wait in shared memory for the mean, the strip sums the luma in
// a first sweep over its rows and applies every op in a second.
// The op order is packed into two bit fields (2 bits an op), read the same
// way by every thread of a block: no per-thread array, no stack frame. Hue
// takes one approximate reciprocal where the TPU kernel's HSV divides five
// times; the clamps are saturating instructions.
//
// What bounds them on the H100 (`ops/bounds.py`): #12 reads 3 H W bytes and
// writes 3 S^2 outputs a frame, and does ~200 fp32 operations an output
// pixel: 0.07 ms of bytes at the CARL step, under the instruction issue of
// the chain (the crop's byte loads, the jitter ops, the two blur passes) and
// the latency of each block's staging and cluster barriers, which three
// blocks an SM only partly hide. #11 moves 4 bytes in and 4 (or 2) out a
// value: 0.17 ms of bytes at (2, 240, 3, 224, 224) fp32, which the bulk
// copies let a block wait on without spending an instruction a value.
//
// The crop reads each resample row as two adjacent taps (index, w0, w1), the
// exact compact form of a linear resample matrix without antialiasing; the
// blur reads its 9 and 5 stencil taps. Both are computed by the wrapper
// (ops/photometric.py) from the dense matrices the plain version uses; it also
// plans the strips (`crop_plan`, `photometric_plan`).
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSize = 512;

__device__ __forceinline__ float luma(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

enum { F_JITTER, F_FB, F_FC, F_FS, F_FH, F_BLUR, F_GRAY, F_FLIP };

namespace strip {

constexpr int kStrips = 16;  // blocks a frame: one (non-portable) cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = 4;      // rows each side of the 9-tap vertical blur
constexpr int kVrows = 8;     // output rows the vertical blur buffers at once
constexpr int kMaxSmem = 232448;  // the H100's dynamic shared memory a block

// What the host plans per launch (ops/photometric.py::crop_plan,
// photometric_plan): output rows a strip, rows a chunk of it (a strip of one
// chunk reads its blur halo from its neighbours' shared memory; a chunked
// one recomputes it), and the capacity of the band (canvas rows, bytes a
// row; 0 for the fp32 source) and of the vertical blur's buffer (rows, at
// most kVrows).
struct Plan {
  int rows, chunk, band_rows, band_cols, vrows;
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of the dynamic shared memory: the pre-blur frame rows P
// (3 x pre x S fp32: the strip's rows, or a chunk's and its halo), the region
// shared by the band (3 x band_rows x band_cols uint8) and the vertical
// blur's output (3 x vrows x S fp32), for the crop the column taps
// (S x (w0, w1, index)) and the row taps (pre x (w0, w1, index)), and 512 B
// of block sums, band bounds, the vertical blur's row table and the bulk
// copy's mbarrier. ops/photometric.py::crop_smem computes the same total.
struct Layout {
  int pre, region, cols, rows, misc, total;
};
__host__ __device__ inline Layout layout(const Plan& pl, int S, bool crop) {
  Layout l;
  l.pre = pl.chunk == pl.rows ? pl.rows : pl.chunk + 2 * kHalo < S ? pl.chunk + 2 * kHalo : S;
  l.region = round16(12 * l.pre * S);
  const int band = 3 * pl.band_rows * pl.band_cols, vb = 12 * pl.vrows * S;
  l.cols = l.region + round16(band > vb ? band : vb);
  l.rows = l.cols + (crop ? round16(12 * S) : 0);
  l.misc = l.rows + (crop ? round16(12 * l.pre) : 0);
  l.total = l.misc + 512;
  return l;
}

// A view's scalars, read the same by every thread of the block: the jitter
// ops before contrast (`pre`) and from contrast on (`post`) as 2-bit codes,
// lowest first (0 brightness, 1 contrast, 2 saturation, 3 hue).
struct ViewScalars {
  bool jit, blur, gray, flip;
  float fb, fc, fs, fh;
  int pre, npre, post, npost;
};

__device__ __forceinline__ ViewScalars load_view(const float* fscal, const int* orders,
                                                 int bv) {
  ViewScalars v;
  const float* f = fscal + bv * 8;
  v.jit = f[F_JITTER] > 0.f;
  v.fb = f[F_FB];
  v.fc = f[F_FC];
  v.fs = f[F_FS];
  v.fh = f[F_FH];
  v.blur = f[F_BLUR] > 0.f;
  v.gray = f[F_GRAY] > 0.f;
  v.flip = f[F_FLIP] > 0.f;
  const int* o = orders + bv * 4;
  const int o0 = o[0], o1 = o[1], o2 = o[2], o3 = o[3];
  const int code = o0 | (o1 << 2) | (o2 << 4) | (o3 << 6);
  const int pc = o0 == 1 ? 0 : o1 == 1 ? 1 : o2 == 1 ? 2 : 3;
  v.pre = code;
  v.npre = pc;
  v.post = code >> (2 * pc);
  v.npost = 4 - pc;
  return v;
}

// adjust_hue as `hue` above, with one approximate reciprocal (2 ulp) where
// that one divides five times, and no sextant index: each channel of the
// rotated colour is max - delta * clamp(min(k, 4 - k), 0, 1) with
// k = (n + 6 h) mod 6, n = 5, 3, 1 for r, g, b, the closed form of the
// v, p, q, t table (v (1 - s) = min, v (1 - s f) = max - f delta,
// v (1 - s (1 - f)) = min + f delta), so s is never formed either.
__device__ __forceinline__ void hue_one_rcp(float& r, float& g, float& b, float f) {
  r = __saturatef(r);
  g = __saturatef(g);
  b = __saturatef(b);
  const float maxc = fmaxf(fmaxf(r, g), b), minc = fminf(fminf(r, g), b);
  const float delta = maxc - minc;
  const float inv = delta > 0.f ? __fdividef(1.f, delta) : 0.f;
  float h = maxc == r ? (g - b) * inv : (maxc == g ? 2.f + (b - r) * inv : 4.f + (r - g) * inv);
  h *= 1.f / 6.f;
  h = delta > 0.f ? h - floorf(h) : 0.f;
  h += f;
  h -= floorf(h);
  const float h6 = h * 6.f;
  auto channel = [&](float n) {
    float k = n + h6;
    k = k >= 6.f ? k - 6.f : k;
    return maxc - delta * __saturatef(fminf(k, 4.f - k));
  };
  r = channel(5.f);
  g = channel(3.f);
  b = channel(1.f);
}

// `n` ops of `code` on one pixel; every thread of a block walks the same ops
__device__ __forceinline__ void run_ops(int code, int n, const ViewScalars& v, float mean,
                                        float& r, float& g, float& b) {
  for (int i = 0; i < n; ++i, code >>= 2) {
    const int op = code & 3;
    if (op == 0) {
      r = __saturatef(r * v.fb); g = __saturatef(g * v.fb); b = __saturatef(b * v.fb);
    } else if (op == 1) {
      const float m = mean * (1.f - v.fc);
      r = __saturatef(r * v.fc + m); g = __saturatef(g * v.fc + m);
      b = __saturatef(b * v.fc + m);
    } else if (op == 2) {
      const float gray = luma(r, g, b) * (1.f - v.fs);
      r = __saturatef(r * v.fs + gray); g = __saturatef(g * v.fs + gray);
      b = __saturatef(b * v.fs + gray);
    } else {
      hue_one_rcp(r, g, b, v.fh);
    }
  }
}

// A byte as fp32, exactly, on the integer and fp32 pipes (2^23 + b has b in
// its mantissa) rather than the quarter-rate conversion unit.
__device__ __forceinline__ float u8_to_f32(unsigned char b) {
  return __int_as_float(0x4B000000 | b) - 8388608.f;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Calls f(local row, x) for every pixel of `nrows` rows of S columns, a warp
// taking 32 consecutive columns of one row at a time.
template <typename F>
__device__ __forceinline__ void for_pixels(int nrows, int S, F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nxb = (S + 31) >> 5;
  int rl = warp / nxb, xb = warp - rl * nxb;
  while (rl < nrows) {
    const int x = (xb << 5) + lane;
    if (x < S) f(rl, x);
    xb += kWarps;
    while (xb >= nxb) {
      xb -= nxb;
      ++rl;
    }
  }
}

// Two values rounded to bf16, the first in the low half.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&t);
}

// Grayscale, normalisation and the store of eight outputs of one row from
// their horizontally blurred values h (source columns xs0 .. xs0 + 7; a flip
// reverses them), with 16-byte stores.
template <typename OutT>
__device__ __forceinline__ void store8(const ViewScalars& v, float (&h)[3][8], OutT* out,
                                       int S, int y, int xo) {
  if (v.gray) {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[0][i] = h[1][i] = h[2][i] = luma(h[0][i], h[1][i], h[2][i]);
  }
  const float mean[3] = {0.485f, 0.456f, 0.406f};
  const float inv_std[3] = {1.f / 0.229f, 1.f / 0.224f, 1.f / 0.225f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = ((v.flip ? h[c][7 - i] : h[c][i]) - mean[c]) * inv_std[c];
    OutT* p = out + ((size_t)c * S + y) * S + xo;
    if constexpr (sizeof(OutT) == 2) {
      *reinterpret_cast<uint4*>(p) = make_uint4(bf16x2(o[0], o[1]), bf16x2(o[2], o[3]),
                                                bf16x2(o[4], o[5]), bf16x2(o[6], o[7]));
    } else {
      reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
  }
}

// Writes output rows [y0, y0 + n) from buffer rows `buf` (3 planes of
// `plane` floats, S a row; buffer row 0 is output row y0): the horizontal
// blur with taps `wx` (if on), grayscale, flip, normalisation.
template <typename OutT>
__device__ __forceinline__ void finish_rows(const ViewScalars& v, const float* wx,
                                            const float* buf, int plane, int n, int y0, int S,
                                            bool vec_out, OutT* out) {
  float tx[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) tx[k] = wx[k];
  if (vec_out) {  // S % 8 == 0: 8 outputs a thread, 16-byte stores
    const int ng = S >> 3;
    for (int item = threadIdx.x; item < n * ng; item += kThreads) {
      const int o = item / ng, gi = item - o * ng;
      const int xo = gi << 3;
      const int xs0 = v.flip ? S - 8 - xo : xo;
      float h[3][8];
#pragma unroll
      for (int c = 0; c < 3; ++c) {  // one channel at a time: 12 values live
        const float* row = buf + c * plane + o * S;
        float in[12];
        if (xs0 >= 2 && xs0 + 10 <= S) {  // 8 aligned values and 2 each side
          const float2 l = *reinterpret_cast<const float2*>(row + xs0 - 2);
          const float4 a = *reinterpret_cast<const float4*>(row + xs0);
          const float4 b = *reinterpret_cast<const float4*>(row + xs0 + 4);
          const float2 r = *reinterpret_cast<const float2*>(row + xs0 + 8);
          const float vals[12] = {l.x, l.y, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, r.x, r.y};
#pragma unroll
          for (int k = 0; k < 12; ++k) in[k] = vals[k];
        } else {
#pragma unroll
          for (int k = 0; k < 12; ++k) in[k] = row[reflect(xs0 - 2 + k, S)];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < 5; ++k) acc = fmaf(tx[k], in[i + k], acc);
          h[c][i] = v.blur ? acc : in[i + 2];
        }
      }
      store8(v, h, out, S, y0 + o, xo);
    }
  } else {  // one output a thread
    const float mean[3] = {0.485f, 0.456f, 0.406f};
    const float inv_std[3] = {1.f / 0.229f, 1.f / 0.224f, 1.f / 0.225f};
    for (int item = threadIdx.x; item < n * S; item += kThreads) {
      const int o = item / S, xo = item - o * S;
      const int xs = v.flip ? S - 1 - xo : xo;
      float h[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* row = buf + c * plane + o * S;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 5; ++k) acc = fmaf(tx[k], row[reflect(xs - 2 + k, S)], acc);
        h[c] = v.blur ? acc : row[xs];
      }
      if (v.gray) h[0] = h[1] = h[2] = luma(h[0], h[1], h[2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float val = (h[c] - mean[c]) * inv_std[c];
        OutT* p = out + ((size_t)c * S + y0 + o) * S + xo;
        if constexpr (sizeof(OutT) == 2) *p = __float2bfloat16(val);
        else *p = val;
      }
    }
  }
}

// The block's sum (its warps' sums in warp order), then every block of the
// cluster adds all the blocks' sums in rank order: the frame's luma mean,
// bit-identical in every block. misc[0..kWarps) holds the warp sums,
// misc[kWarps] the block's.
__device__ __forceinline__ float cluster_mean(float part, float* misc, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) misc[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += misc[w];
    misc[kWarps] = s;
  }
  cluster.sync();  // every block's sum is written
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < kStrips; ++r) total += *cluster.map_shared_rank(misc + kWarps, r);
  return total / (float)(S * S);
}

// kNoOps: the crop alone (or, for the fp32 source, nothing: P holds the rows)
enum Mode { kNoOps, kPreContrast, kAllOps, kSumOnly };

// One frame's strip, as a block of its cluster. kCrop: src is the uint8
// (BV, T, 3, H, W) canvas read through the taps; else the fp32 (BV, T, 3, S,
// S) frames (H = W = S, no taps), copied in rows by `cp.async.bulk` where
// vec_in says that rows and pointer are 16-byte aligned.
template <typename OutT, bool kCrop>
__device__ __forceinline__ void strip_frame(
    const void* __restrict__ src, const int* __restrict__ h_idx, const float* __restrict__ h_w,
    const int* __restrict__ w_idx, const float* __restrict__ w_w,
    const float* __restrict__ fscal, const int* __restrict__ orders,
    const float* __restrict__ wy, const float* __restrict__ wx, int T, int H, int W, int S,
    const Plan& plan, int vec_in, int vec_out, OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char strip_smem[];
  unsigned char* smem = strip_smem;
  const Layout lay = layout(plan, S, kCrop);
  float* P = reinterpret_cast<float*>(smem);  // [3][lay.pre][S]
  unsigned char* band = smem + lay.region;     // [3][band_rows][band_cols]
  float* vbuf = reinterpret_cast<float*>(smem + lay.region);  // [3][vrows][S]
  // taps: (w0, w1) pairs first, 8-byte aligned whatever S, then the indices
  float2* cw = reinterpret_cast<float2*>(smem + lay.cols);
  int* ci = reinterpret_cast<int*>(cw + S);
  float2* rw = reinterpret_cast<float2*>(smem + lay.rows);
  int* ri = reinterpret_cast<int*>(rw + lay.pre);
  float* misc = reinterpret_cast<float*>(smem + lay.misc);
  int* bounds = reinterpret_cast<int*>(misc + 32);
  const float** table = reinterpret_cast<const float**>(smem + lay.misc + 256);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.misc + 384);  // the bulk copies'

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cg::this_cluster().block_rank();
  const int t = blockIdx.y, bv = blockIdx.z;
  const uint8_t* frame = static_cast<const uint8_t*>(src) + ((size_t)bv * T + t) * 3 * H * W;
  const float* fframe = static_cast<const float*>(src) + ((size_t)bv * T + t) * 3 * S * S;
  OutT* fout = out + ((size_t)bv * T + t) * 3 * S * S;
  const ViewScalars v = load_view(fscal, orders, bv);
  // the blur's taps, visible to all after the first staging's barriers
  float* taps = misc + 16;  // 9 down, then 5 across
  if (tid < 9) taps[tid] = wy[bv * 9 + tid];
  else if (tid < 14) taps[tid] = wx[bv * 5 + tid - 9];
  const int y0 = min(S, rank * plan.rows), y1 = min(S, y0 + plan.rows);
  const int pstride = lay.pre * S;  // floats a channel of P
  uint32_t phase = 0;               // of `bar`, flipped at each bulk staging
  if (!kCrop && vec_in && tid == 0) {
    vrl::sm90::mbar_init(bar, 1);
    vrl::sm90::mbar_init_fence();
  }

  // For the fp32 source: rows [ra, rb) of the three planes into P rows
  // [0, rb - ra), as they lie.
  auto stage_rows = [&](int ra, int rb) {
    const int n = rb - ra;
    vrl::sm90::fence_proxy_async();  // this thread's writes to P before the copy's
    __syncthreads();  // the previous chunk is done with P
    if (n <= 0) return;
    if (vec_in) {
      if (tid == 0) {
        const uint32_t bytes = 4u * n * S;
        vrl::sm90::mbar_expect_tx(bar, 3 * bytes);
        for (int c = 0; c < 3; ++c)
          vrl::sm90::bulk_load(P + c * pstride, fframe + ((size_t)c * S + ra) * S, bytes, bar);
      }
      vrl::sm90::mbar_wait(bar, phase);
      phase ^= 1;
    } else {
      const int per_c = n * S;
      for (int i = tid; i < 3 * per_c; i += kThreads) {
        const int c = i / per_c, j = i - c * per_c;
        P[c * pstride + j] = __ldg(fframe + ((size_t)c * S + ra) * S + j);
      }
      __syncthreads();
    }
  };

  // Stages output rows [ra, rb): for the crop, their row taps (1/255 folded
  // in) and, on the first call, the column taps, in one round trip; warp 0
  // then finds the canvas rows they read and warp 1 the columns, and the
  // block copies that band. A band the plan cannot hold means rh or rw is no
  // box resample: the kernel traps rather than read past its buffer.
  int clo = 0, ncols = 0;
  auto stage = [&](int ra, int rb) {
    if constexpr (!kCrop) {
      stage_rows(ra, rb);
      return;
    }
    const int n = rb - ra;
    const bool first = ncols == 0;
    __syncthreads();  // the previous chunk is done with the taps and the band
    if (first) {
      for (int x = tid; x < S; x += kThreads) {
        const size_t i = (size_t)bv * S + x;
        ci[x] = w_idx[i];
        cw[x] = make_float2(w_w[2 * i], w_w[2 * i + 1]);
      }
    }
    for (int i = tid; i < n; i += kThreads) {
      const size_t j = (size_t)bv * S + ra + i;
      ri[i] = h_idx[j];
      rw[i] = make_float2(h_w[2 * j] * (1.f / 255.f), h_w[2 * j + 1] * (1.f / 255.f));
    }
    __syncthreads();
    if (warp < 2 && (warp == 0 || first)) {
      const int* idx = warp == 0 ? ri : ci;
      const float2* w = warp == 0 ? rw : cw;
      const int m = warp == 0 ? n : S;
      int lo = 0x7fffffff, hi = -1;
      for (int i = lane; i < m; i += 32)
        if (w[i].x != 0.f || w[i].y != 0.f) {
          lo = min(lo, idx[i]);
          hi = max(hi, idx[i] + 1);
        }
      lo = warp_min(lo);
      hi = warp_max(hi);
      if (lane == 0) {
        if (hi < 0) lo = 0, hi = 1;  // every weight zero: read anything
        if (warp == 0) {
          bounds[2] = lo;
          bounds[3] = n > 0 ? hi + 1 - lo : 0;
        } else {
          bounds[0] = vec_in ? lo & ~15 : lo;
          bounds[1] = vec_in ? min(W, (hi + 16) & ~15) : hi + 1;
        }
      }
    }
    __syncthreads();
    if (first) {
      clo = bounds[0];
      ncols = bounds[1] - clo;
      if (ncols > plan.band_cols) __trap();
      for (int x = tid; x < S; x += kThreads) ci[x] = min(max(ci[x] - clo, 0), ncols - 2);
    }
    const int lo = bounds[2], nb = bounds[3];
    if (nb > plan.band_rows) __trap();
    for (int i = tid; i < n; i += kThreads) ri[i] = min(max(ri[i] - lo, 0), nb - 2);
    if (vec_in) {
      const int n16 = ncols >> 4, per_c = nb * n16;
      for (int i = tid; i < 3 * per_c; i += kThreads) {
        const int c = i / per_c, rem = i - c * per_c, r = rem / n16, j = rem - r * n16;
        const uint4* s = reinterpret_cast<const uint4*>(frame + ((size_t)c * H + lo + r) * W + clo) + j;
        reinterpret_cast<uint4*>(band + (c * plan.band_rows + r) * plan.band_cols)[j] = __ldg(s);
      }
    } else {
      const int per_c = nb * ncols;
      for (int i = tid; i < 3 * per_c; i += kThreads) {
        const int c = i / per_c, rem = i - c * per_c, r = rem / ncols, j = rem - r * ncols;
        band[(c * plan.band_rows + r) * plan.band_cols + j] =
            frame[((size_t)c * H + lo + r) * W + clo + j];
      }
    }
    __syncthreads();
  };

  // Crop (or, for the fp32 source, the staged values) + ops of rows
  // [ra, rb) into P (not for kSumOnly); returns this thread's luma sum over
  // rows [c0, c1) where the mode sums.
  auto pre_pass = [&](Mode mode, int ra, int rb, int c0, int c1, float mean) {
    float part = 0.f;
    for_pixels(rb - ra, S, [&](int rl, int x) {
      float* p = P + rl * S + x;
      float r, g, b;
      if constexpr (kCrop) {
        const float h0 = rw[rl].x, h1 = rw[rl].y, w0 = cw[x].x, w1 = cw[x].y;
        const unsigned char* a0 = band + ri[rl] * plan.band_cols + ci[x];
        float px[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const unsigned char* a = a0 + c * plan.band_rows * plan.band_cols;
          const unsigned char* b = a + plan.band_cols;
          // (rh . x) first, then . rw, as the plain version's two matmuls
          const float t0 = h0 * u8_to_f32(a[0]) + h1 * u8_to_f32(b[0]);
          const float t1 = h0 * u8_to_f32(a[1]) + h1 * u8_to_f32(b[1]);
          px[c] = t0 * w0 + t1 * w1;
        }
        r = px[0];
        g = px[1];
        b = px[2];
      } else {
        r = p[0];
        g = p[pstride];
        b = p[2 * pstride];
      }
      if (mode != kNoOps) run_ops(v.pre, v.npre, v, 0.f, r, g, b);
      const int y = ra + rl;
      if ((mode == kPreContrast || mode == kSumOnly) && y >= c0 && y < c1) part += luma(r, g, b);
      if (mode == kAllOps) run_ops(v.post, v.npost, v, mean, r, g, b);
      if (mode != kSumOnly) {
        p[0] = r;
        p[pstride] = g;
        p[2 * pstride] = b;
      }
    });
    return part;
  };

  // The blur and the finish of output rows [c0, c1), whose pre-blur values
  // are this block's P from row `ra` on, or (a single-chunk strip with blur)
  // the strips' P across the cluster.
  const bool two_sweep = plan.chunk < plan.rows;
  auto finish_chunk = [&](int ra, int c0, int c1) {
    if (!v.blur) {
      finish_rows(v, taps + 9, P + (c0 - ra) * S, pstride, c1 - c0, c0, S, vec_out != 0, fout);
      return;
    }
    for (int s0 = c0; s0 < c1; s0 += plan.vrows) {
      const int nv = min(plan.vrows, c1 - s0);
      // where each of the nv + 8 rows the 9 taps read lives: this block's P,
      // or the P of the strip that owns it
      if (tid < nv + 2 * kHalo) {
        const int yr = reflect(s0 - kHalo + tid, S);
        if (two_sweep) {
          table[tid] = P + (yr - ra) * S;
        } else {
          const int owner = yr / plan.rows;
          table[tid] = cg::this_cluster().map_shared_rank(P, owner) + (yr - owner * plan.rows) * S;
        }
      }
      __syncthreads();
      // 9 taps down: a thread takes the nv rows of one column of one
      // channel, reading the nv + 8 rows they share once
      float ty[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) ty[k] = taps[k];
      for (int item = tid; item < 3 * S; item += kThreads) {
        const int c = item / S, x = item - c * S;
        const int off = c * pstride + x;
        float w[kVrows + 8];
#pragma unroll
        for (int k = 0; k < kVrows + 8; ++k) w[k] = k < nv + 8 ? table[k][off] : 0.f;
        float* dst = vbuf + c * plan.vrows * S + x;
#pragma unroll
        for (int o = 0; o < kVrows; ++o) {
          if (o < nv) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < 9; ++k) acc = fmaf(ty[k], w[o + k], acc);
            dst[o * S] = acc;
          }
        }
      }
      __syncthreads();
      finish_rows(v, taps + 9, vbuf, plan.vrows * S, nv, s0, S, vec_out != 0, fout);
      __syncthreads();
    }
  };

  float mean = 0.f;
  if (v.jit && two_sweep) {  // the mean first: crop + the ops before contrast
    float part = 0.f;
    for (int c0 = y0; c0 < y1; c0 += plan.chunk) {
      const int c1 = min(y1, c0 + plan.chunk);
      stage(c0, c1);
      part += pre_pass(kSumOnly, c0, c1, c0, c1, 0.f);
    }
    __syncthreads();
    mean = cluster_mean(part, misc, S);
  }
  // a single-chunk strip takes exactly one chunk, even an empty one, so that
  // every block of the cluster reaches each cluster barrier
  const int chunks = two_sweep ? (y1 - y0 + plan.chunk - 1) / plan.chunk : 1;
  const bool recompute_halo = v.blur && two_sweep;
  for (int k = 0; k < chunks; ++k) {
    const int c0 = y0 + k * plan.chunk, c1 = min(y1, c0 + plan.chunk);
    const int ra = recompute_halo ? max(0, c0 - kHalo) : c0;
    const int rb = c0 >= c1 ? ra : (recompute_halo ? min(S, c1 + kHalo) : c1);
    stage(ra, rb);
    const Mode mode = !v.jit ? kNoOps : two_sweep ? kAllOps : kPreContrast;
    // the fp32 source's staged rows are final where no op runs
    const float part = kCrop || mode != kNoOps ? pre_pass(mode, ra, rb, c0, c1, mean) : 0.f;
    __syncthreads();
    if (mode == kPreContrast) {  // the mean, then contrast and the ops after it
      mean = cluster_mean(part, misc, S);
      for_pixels(rb - ra, S, [&](int rl, int x) {
        float* p = P + rl * S + x;
        float r = p[0], g = p[pstride], b = p[2 * pstride];
        run_ops(v.post, v.npost, v, mean, r, g, b);
        p[0] = r;
        p[pstride] = g;
        p[2 * pstride] = b;
      });
      __syncthreads();
    }
    if (v.blur && !two_sweep) cg::this_cluster().sync();  // every strip's rows are final
    finish_chunk(ra, c0, c1);
  }
  // no block leaves while another may still read its sum or its rows
  if (v.jit || (v.blur && !two_sweep)) cg::this_cluster().sync();
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
crop_strip_kernel(const uint8_t* __restrict__ src, const int* __restrict__ h_idx,
                  const float* __restrict__ h_w, const int* __restrict__ w_idx,
                  const float* __restrict__ w_w, const float* __restrict__ fscal,
                  const int* __restrict__ orders, const float* __restrict__ wy,
                  const float* __restrict__ wx, int T, int H, int W, int S, Plan plan,
                  int vec_in, int vec_out, OutT* __restrict__ out) {
  strip_frame<OutT, true>(src, h_idx, h_w, w_idx, w_w, fscal, orders, wy, wx, T, H, W, S, plan,
                          vec_in, vec_out, out);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
photometric_strip_kernel(const float* __restrict__ src, const float* __restrict__ fscal,
                         const int* __restrict__ orders, const float* __restrict__ wy,
                         const float* __restrict__ wx, int T, int S, Plan plan, int vec_in,
                         int vec_out, OutT* __restrict__ out) {
  strip_frame<OutT, false>(src, nullptr, nullptr, nullptr, nullptr, fscal, orders, wy, wx, T, S,
                           S, S, plan, vec_in, vec_out, out);
}

// A grid of (kStrips, T, BV) blocks in clusters of kStrips (above the
// portable 8, which the H100 allows).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int smem, int T, int BV,
                            cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kStrips, T, BV);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kStrips;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch(int src_kind, const void* src, const void* h_idx, const void* h_w,
                   const void* w_idx, const void* w_w, const void* fscal, const void* orders,
                   const void* wy, const void* wx, int BV, int T, int H, int W, int S,
                   const Plan& plan, void* out, cudaStream_t stream) {
  const Layout l = layout(plan, S, src_kind == 1);
  if (l.total > kMaxSmem) return cudaErrorInvalidValue;
  const uintptr_t src_addr = reinterpret_cast<uintptr_t>(src);
  const int vec_out = S % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* fs = static_cast<const float*>(fscal);
  const int* ord = static_cast<const int*>(orders);
  const float *ty = static_cast<const float*>(wy), *tx = static_cast<const float*>(wx);
  OutT* o = static_cast<OutT*>(out);
  if (src_kind == 1)
    return launch_clusters(crop_strip_kernel<OutT>, l.total, T, BV, stream,
                           static_cast<const uint8_t*>(src), static_cast<const int*>(h_idx),
                           static_cast<const float*>(h_w), static_cast<const int*>(w_idx),
                           static_cast<const float*>(w_w), fs, ord, ty, tx, T, H, W, S, plan,
                           (int)(W % 16 == 0 && src_addr % 16 == 0), vec_out, o);
  return launch_clusters(photometric_strip_kernel<OutT>, l.total, T, BV, stream,
                         static_cast<const float*>(src), fs, ord, ty, tx, T, S, plan,
                         (int)(S % 4 == 0 && src_addr % 16 == 0), vec_out, o);
}

}  // namespace strip

}  // namespace

extern "C" {

// src_kind: 1 = uint8 (BV, T, 3, H, W) canvas cropped through the taps
// (crop_strip_kernel), 0 = fp32 (BV, T, 3, S, S) frames (H = W = S;
// photometric_strip_kernel; taps unused, band_rows = band_cols = 0); both
// planned by rows / chunk / band_rows / band_cols / vrows. out_dtype: 0 fp32,
// 1 bf16. Returns a cudaError_t (0 = success); cudaErrorInvalidValue for
// arguments the kernels do not take.
int vrl_photometric(const void* src, const void* h_idx, const void* h_w,
                    const void* w_idx, const void* w_w, const void* fscal,
                    const void* orders, const void* wy, const void* wx, int src_kind,
                    int BV, int T, int H, int W, int S, int out_dtype, void* out,
                    void* stream, int rows, int chunk, int band_rows, int band_cols,
                    int vrows) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((src_kind != 0 && src_kind != 1) || S < 9 || S > kMaxSize || BV < 1 || BV > 65535 ||
      T < 1 || T > 65535)
    return cudaErrorInvalidValue;
  if (rows < 1 || rows * strip::kStrips < S || chunk < 1 || chunk > rows || vrows < 1 ||
      vrows > chunk || vrows > strip::kVrows)
    return cudaErrorInvalidValue;
  if (src_kind == 1 && (H < 2 || W < 2 || band_rows < 2 || band_cols < 2))
    return cudaErrorInvalidValue;
  if (src_kind == 0 && (H != S || W != S || band_rows != 0 || band_cols != 0))
    return cudaErrorInvalidValue;
  const strip::Plan plan{rows, chunk, band_rows, band_cols, vrows};
  if (out_dtype == 0)
    return strip::launch<float>(src_kind, src, h_idx, h_w, w_idx, w_w, fscal, orders, wy, wx,
                                BV, T, H, W, S, plan, out, st);
  if (out_dtype == 1)
    return strip::launch<__nv_bfloat16>(src_kind, src, h_idx, h_w, w_idx, w_w, fscal, orders,
                                        wy, wx, BV, T, H, W, S, plan, out, st);
  return cudaErrorInvalidValue;
}

const char* vrl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// SSL augmentation for Hopper (sm_90a): RandomResizedCrop on the uint8 canvas
// plus the photometric tail (ColorJitter in a per-view op order, GaussianBlur,
// grayscale, horizontal flip, ImageNet normalisation), one frame per block.
//
// Replaces the TPU kernels `_crop_photometric_kernel` (src_kind 1: uint8
// (BV, T, 3, H, W) canvas, crop rh . x . rw inside the kernel) and
// `_photometric_kernel` (src_kind 0: already cropped fp32 (BV, T, 3, S, S)) of
// video_rep_learning_tpu/ops/photometric_pallas.py. The tail is one
// __device__ routine shared by both.
//
// Where the frame lives. The TPU kernel holds a whole (3, S, S) frame in VMEM
// (602 KB in fp32 at S = 224); a Hopper block has 227 KB of shared memory. The
// chain has two whole-frame dependencies: the contrast op needs the frame's
// luma mean (in the middle of a random op order), and the blur needs
// neighbours 4 rows and 2 columns away. This kernel keeps no frame anywhere:
// every pre-blur pixel is a pure function of the uint8 source, the view's
// scalars and (after contrast) one mean, so one block per frame
//   1. recomputes crop + the ops before contrast over the frame and reduces
//      the luma mean in the block (only when jitter is on);
//   2. walks the frame in tiles of kTileRows output rows: it recomputes the
//      whole pre-blur chain for the tile plus its 4-row / 2-column halo
//      (reflect-mapped indices) into shared memory, then blurs as a 9 x 5
//      stencil, grays, flips by index reversal and normalises on the way out.
// The price is recompute (the crop and the ops before contrast twice, the
// halo rows once more); the gain is that the source is read from L2/HBM as
// uint8 and only the output is written, with no scratch frame.
//
// What bounds it on the H100: per frame it reads 3 H W bytes and writes
// 3 S^2 outputs, and does a few hundred flops per output value (hue's
// divides, the 45-tap blur): bytes and operations are both small, and the
// CARL step's 480 frames are 480 blocks (under 2 waves at 2-3 blocks per SM).
// Simple and right first; fp32 everywhere, bf16 only on the output write.
//
// The crop reads each resample row as two adjacent taps (index, w0, w1), the
// exact compact form of a linear resample matrix without antialiasing; the
// blur reads its 9 and 5 stencil taps. Both are computed by the wrapper
// (ops/photometric.py) from the dense matrices the plain version uses.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 16;
constexpr int kHaloRows = 4;  // 9-tap vertical blur
constexpr int kHaloCols = 2;  // 5-tap horizontal blur
constexpr int kMaxSize = 512;

enum { F_JITTER, F_FB, F_FC, F_FS, F_FH, F_BLUR, F_GRAY, F_FLIP };

struct View {
  float f[8];
  int order[4];
  float wy[9];
  float wx[5];
  float mean;  // luma mean before the contrast op
};

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }
__device__ __forceinline__ float luma(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// torchvision adjust_hue through HSV, as the JAX kernel's `_hue`: delta == 0
// keeps h = 0, and the sextant index 6 (h rounding to 1.0) wraps to 0.
__device__ void hue(float& r, float& g, float& b, float f) {
  r = clamp01(r);
  g = clamp01(g);
  b = clamp01(b);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float v = maxc;
  const float delta = maxc - minc;
  const float s = maxc > 0.f ? delta / fmaxf(maxc, 1e-12f) : 0.f;
  const float safe = delta > 0.f ? delta : 1.f;
  const float rc = (maxc - r) / safe, gc = (maxc - g) / safe, bc = (maxc - b) / safe;
  float h = maxc == r ? bc - gc : (maxc == g ? 2.f + rc - bc : 4.f + gc - rc);
  h = h / 6.f;
  h = delta > 0.f ? h - floorf(h) : 0.f;
  h = h + f;
  h = h - floorf(h);
  const float i6 = floorf(h * 6.f);
  const float frac = h * 6.f - i6;
  const float p = v * (1.f - s);
  const float q = v * (1.f - frac * s);
  const float t = v * (1.f - (1.f - frac) * s);
  int i = (int)i6;
  if (i >= 6) i -= 6;
  switch (i) {
    case 0: r = v; g = t; b = p; break;
    case 1: r = q; g = v; b = p; break;
    case 2: r = p; g = v; b = t; break;
    case 3: r = p; g = q; b = v; break;
    case 4: r = t; g = p; b = v; break;
    default: r = v; g = p; b = q; break;
  }
}

// Jitter ops order[from..to) on one pixel.
__device__ void jitter(const View& vw, int from, int to, float& r, float& g, float& b) {
  for (int i = from; i < to; ++i) {
    switch (vw.order[i]) {
      case 0: {
        const float fb = vw.f[F_FB];
        r = clamp01(r * fb); g = clamp01(g * fb); b = clamp01(b * fb);
        break;
      }
      case 1: {
        const float fc = vw.f[F_FC];
        const float m = vw.mean * (1.f - fc);
        r = clamp01(r * fc + m); g = clamp01(g * fc + m); b = clamp01(b * fc + m);
        break;
      }
      case 2: {
        const float fs = vw.f[F_FS];
        const float gray = luma(r, g, b) * (1.f - fs);
        r = clamp01(r * fs + gray); g = clamp01(g * fs + gray); b = clamp01(b * fs + gray);
        break;
      }
      default:
        hue(r, g, b, vw.f[F_FH]);
    }
  }
}

// The source pixel at output position (y, x) before any photometric op.
template <bool kCrop>
struct Source {
  const void* frame;  // this frame's (3, H, W) uint8 or (3, S, S) fp32
  int H, W, S;
  const int* rows_i;  // shared: per output row / column, the first tap and
  const float* rows_w;  // its two weights
  const int* cols_i;
  const float* cols_w;

  __device__ __forceinline__ void load(int y, int x, float& r, float& g, float& b) const {
    if constexpr (kCrop) {
      const uint8_t* p = static_cast<const uint8_t*>(frame);
      const int i0 = rows_i[y], j0 = cols_i[x];
      const float h0 = rows_w[2 * y], h1 = rows_w[2 * y + 1];
      const float w0 = cols_w[2 * x], w1 = cols_w[2 * x + 1];
      float out[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint8_t* a = p + ((size_t)c * H + i0) * W + j0;
        const uint8_t* bb = a + W;
        const float k = 1.f / 255.f;
        // (rh . x) first, then . rw, as the plain version's two matmuls
        const float t0 = h0 * ((float)a[0] * k) + h1 * ((float)bb[0] * k);
        const float t1 = h0 * ((float)a[1] * k) + h1 * ((float)bb[1] * k);
        out[c] = t0 * w0 + t1 * w1;
      }
      r = out[0]; g = out[1]; b = out[2];
    } else {
      const float* p = static_cast<const float*>(frame);
      const size_t plane = (size_t)S * S, o = (size_t)y * S + x;
      r = p[o]; g = p[plane + o]; b = p[2 * plane + o];
    }
  }
};

__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

template <bool kCrop>
__device__ __forceinline__ void pre_blur(const Source<kCrop>& src, const View& vw,
                                         bool jit, int y, int x, float& r, float& g,
                                         float& b) {
  src.load(y, x, r, g, b);
  if (jit) jitter(vw, 0, 4, r, g, b);
}

template <typename OutT>
__device__ __forceinline__ void finish(const View& vw, OutT* out, int S, int y, int x,
                                       float r, float g, float b) {
  if (vw.f[F_GRAY] > 0.f) r = g = b = luma(r, g, b);
  const int xo = vw.f[F_FLIP] > 0.f ? S - 1 - x : x;
  const size_t plane = (size_t)S * S, o = (size_t)y * S + xo;
  store_out(out + o, (r - 0.485f) / 0.229f);
  store_out(out + plane + o, (g - 0.456f) / 0.224f);
  store_out(out + 2 * plane + o, (b - 0.406f) / 0.225f);
}

template <bool kCrop, typename OutT>
__global__ void __launch_bounds__(kThreads)
photometric_kernel(const void* __restrict__ src, const int* __restrict__ h_idx,
                   const float* __restrict__ h_w, const int* __restrict__ w_idx,
                   const float* __restrict__ w_w, const float* __restrict__ fscal,
                   const int* __restrict__ orders, const float* __restrict__ wy,
                   const float* __restrict__ wx, int T, int H, int W, int S,
                   OutT* __restrict__ out) {
  extern __shared__ float smem[];
  // [rows_w 2S | cols_w 2S | rows_i S | cols_i S | tile 3 x (kTileRows+8) x (S+4)]
  float* rows_w = smem;
  float* cols_w = rows_w + 2 * S;
  int* rows_i = reinterpret_cast<int*>(cols_w + 2 * S);
  int* cols_i = rows_i + S;
  float* tile = reinterpret_cast<float*>(cols_i + S);
  __shared__ float red[kThreads / 32];

  const int tid = threadIdx.x;
  const int t = blockIdx.x, bv = blockIdx.y;
  const size_t frame_id = (size_t)bv * T + t;

  View vw;
#pragma unroll
  for (int i = 0; i < 8; ++i) vw.f[i] = fscal[bv * 8 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) vw.order[i] = orders[bv * 4 + i];
#pragma unroll
  for (int i = 0; i < 9; ++i) vw.wy[i] = wy[bv * 9 + i];
#pragma unroll
  for (int i = 0; i < 5; ++i) vw.wx[i] = wx[bv * 5 + i];
  vw.mean = 0.f;
  const bool jit = vw.f[F_JITTER] > 0.f;
  const bool blur = vw.f[F_BLUR] > 0.f;

  Source<kCrop> s;
  s.H = H; s.W = W; s.S = S;
  s.rows_i = rows_i; s.rows_w = rows_w; s.cols_i = cols_i; s.cols_w = cols_w;
  if constexpr (kCrop) {
    s.frame = static_cast<const uint8_t*>(src) + frame_id * 3 * H * W;
    for (int i = tid; i < S; i += kThreads) {
      rows_i[i] = h_idx[(size_t)bv * S + i];
      cols_i[i] = w_idx[(size_t)bv * S + i];
      rows_w[2 * i] = h_w[((size_t)bv * S + i) * 2];
      rows_w[2 * i + 1] = h_w[((size_t)bv * S + i) * 2 + 1];
      cols_w[2 * i] = w_w[((size_t)bv * S + i) * 2];
      cols_w[2 * i + 1] = w_w[((size_t)bv * S + i) * 2 + 1];
    }
  } else {
    s.frame = static_cast<const float*>(src) + frame_id * 3 * S * S;
  }
  __syncthreads();

  // 1. the luma mean the contrast op sees: crop + the ops before contrast
  if (jit) {
    int pc = 0;
    while (vw.order[pc] != 1) ++pc;
    float acc = 0.f;
    for (int i = tid; i < S * S; i += kThreads) {
      float r, g, b;
      s.load(i / S, i % S, r, g, b);
      jitter(vw, 0, pc, r, g, b);
      acc += luma(r, g, b);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if ((tid & 31) == 0) red[tid >> 5] = acc;
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
    vw.mean = sum / (float)(S * S);
  }

  OutT* o = out + frame_id * 3 * S * S;
  if (!blur) {  // every pixel on its own
    for (int i = tid; i < S * S; i += kThreads) {
      const int y = i / S, x = i % S;
      float r, g, b;
      pre_blur(s, vw, jit, y, x, r, g, b);
      finish(vw, o, S, y, x, r, g, b);
    }
    return;
  }

  // 2. tiles of rows: pre-blur values with their reflected halo in shared
  // memory, then the 9 x 5 stencil
  const int tw = S + 2 * kHaloCols;
  for (int y0 = 0; y0 < S; y0 += kTileRows) {
    const int rows = min(kTileRows, S - y0);
    const int th = rows + 2 * kHaloRows;
    const int plane = th * tw;
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < plane; i += kThreads) {
      const int ty = i / tw, tx = i % tw;
      const int y = reflect(y0 - kHaloRows + ty, S);
      const int x = reflect(tx - kHaloCols, S);
      float r, g, b;
      pre_blur(s, vw, jit, y, x, r, g, b);
      tile[i] = r;
      tile[plane + i] = g;
      tile[2 * plane + i] = b;
    }
    __syncthreads();
    for (int i = tid; i < rows * S; i += kThreads) {
      const int ty = i / S, x = i % S;
      float c3[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* p = tile + c * plane + ty * tw + x;
        float acc = 0.f;
#pragma unroll
        for (int kx = 0; kx < 5; ++kx) {
          float col = 0.f;
#pragma unroll
          for (int ky = 0; ky < 9; ++ky) col += vw.wy[ky] * p[ky * tw + kx];
          acc += vw.wx[kx] * col;
        }
        c3[c] = acc;
      }
      finish(vw, o, S, y0 + ty, x, c3[0], c3[1], c3[2]);
    }
  }
}

size_t smem_bytes(int S) {
  return sizeof(float) * (4 * (size_t)S) + sizeof(int) * (2 * (size_t)S) +
         sizeof(float) * 3 * (size_t)(kTileRows + 2 * kHaloRows) * (S + 2 * kHaloCols);
}

template <bool kCrop, typename OutT>
cudaError_t launch(const void* src, const void* h_idx, const void* h_w, const void* w_idx,
                   const void* w_w, const void* fscal, const void* orders, const void* wy,
                   const void* wx, int BV, int T, int H, int W, int S, void* out,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
  auto kernel = photometric_kernel<kCrop, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T, BV), kThreads, smem, stream>>>(
      src, static_cast<const int*>(h_idx), static_cast<const float*>(h_w),
      static_cast<const int*>(w_idx), static_cast<const float*>(w_w),
      static_cast<const float*>(fscal), static_cast<const int*>(orders),
      static_cast<const float*>(wy), static_cast<const float*>(wx), T, H, W, S,
      static_cast<OutT*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src_kind: 1 = uint8 (BV, T, 3, H, W) canvas cropped through the taps,
// 0 = fp32 (BV, T, 3, S, S) frames (taps unused). out_dtype: 0 fp32, 1 bf16.
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for arguments
// the kernel does not take.
int vrl_photometric(const void* src, const void* h_idx, const void* h_w,
                    const void* w_idx, const void* w_w, const void* fscal,
                    const void* orders, const void* wy, const void* wx, int src_kind,
                    int BV, int T, int H, int W, int S, int out_dtype, void* out,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 9 || S > kMaxSize || BV < 1 || BV > 65535 || T < 1) return cudaErrorInvalidValue;
  if (src_kind == 1 && (H < 2 || W < 2)) return cudaErrorInvalidValue;
  if (src_kind == 1 && out_dtype == 0)
    return launch<true, float>(src, h_idx, h_w, w_idx, w_w, fscal, orders, wy, wx, BV, T,
                               H, W, S, out, st);
  if (src_kind == 1 && out_dtype == 1)
    return launch<true, __nv_bfloat16>(src, h_idx, h_w, w_idx, w_w, fscal, orders, wy, wx,
                                       BV, T, H, W, S, out, st);
  if (src_kind == 0 && out_dtype == 0)
    return launch<false, float>(src, h_idx, h_w, w_idx, w_w, fscal, orders, wy, wx, BV, T,
                                S, S, S, out, st);
  if (src_kind == 0 && out_dtype == 1)
    return launch<false, __nv_bfloat16>(src, h_idx, h_w, w_idx, w_w, fscal, orders, wy, wx,
                                        BV, T, S, S, S, out, st);
  return cudaErrorInvalidValue;
}

const char* vrl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

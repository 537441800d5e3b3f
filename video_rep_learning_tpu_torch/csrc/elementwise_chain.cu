// A photometric-shaped elementwise chain for Hopper (sm_90a), REPS times
// over every element:
//   v = clip(v * one + eps, 0, 1);  v = where(v > thr, v * down, v * up)
// with fp32 storage and math, bf16 storage and bf16 math, or bf16 storage
// and fp32 math; the output takes the input's type.
//
// Replaces the TPU kernel `_chain_kernel` (tools/bench_vpu_bf16.py:42,
// `chain` :53), which asks whether bf16 elementwise math runs above the fp32
// rate: its time at two REPS counts differs by the chain's own cost.
//
// The constants come from the caller already rounded to the math type, as
// JAX's weak types round them (in bf16, 1.0001, 0.999 and 1.001 are all 1
// and 1e-4 is 1.0014e-4). The kernel stays generic in them: no branch on
// their values, no multiply skipped because a constant is 1. Every op rounds
// once, as the plain version's torch ops do: __fmul_rn / __fadd_rn in fp32
// (nvcc would otherwise contract v * one + eps into one FMA),
// __hmul2_rn / __hadd2_rn in bf16. The clip keeps NaN, as jnp.clip and
// torch.clamp do: max.NaN / min.NaN (fminf / fmaxf and the .sat forms turn
// NaN into a bound). ±inf clips to 1 or 0.
//
// A rep, as ptxas issues it (SASS read with tools/sass_loops.py):
//   fp32, one value: FMUL, FADD, FMNMX.NAN x 2, FSETP, FSEL, FMUL (7). The
//     select picks the constant before one multiply, v * (v > thr ? down :
//     up), which equals the two-product form bit for bit: each arm is one
//     rounded product of v.
//   bf16, two values in one __nv_bfloat162: HMUL2, HFMA2.RELU (the add of
//     eps and the max with 0 fused: ReLU keeps NaN), HMNMX2.NAN, HSET2 (a
//     0xffff-a-half mask), one LOP3 picking down or up a half, and HMUL2 (or
//     HFMA2.MMA, the same product on the MMA pipe): 6 for two values; no
//     half is unpacked.
//   bf16 storage with fp32 math: the fp32 rep on both halves, converted in
//     and out once.
// A thread holds 8 values in registers for the whole chain (one 16-byte load
// and store in bf16, two in fp32); the reps loop runs its 8 values side by
// side and is unrolled by 4, with the remainder after it.
//
// What bounds it on the H100: operations once REPS is more than a few
// (`ops/bounds.py` counts 8 a rep at 67 TFLOP/s fp32 and 133.8 TFLOP/s for
// the packed bf16 units). The CUDA programming guide rates compare, min and
// max at 64 results an SM a clock against 128 for fp32 multiply and add:
// the fp32 rep's FMNMX x 2, FSETP and FSEL issue at that half rate, which
// sets its pace (about 16 value-reps an SM a clock).
//
// x and out (n,) contiguous and 16-byte aligned. No allocation; launches on
// the caller's stream and returns cudaGetLastError().

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;
constexpr int kVec = 8;     // elements a thread
constexpr int kUnroll = 4;  // reps a trip of the unrolled loop

struct Consts {
  float one, eps, thr, down, up;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float rep(float v, const Consts& c) {
  v = min_nan(max_nan(__fadd_rn(__fmul_rn(v, c.one), c.eps), 0.f), 1.f);
  return __fmul_rn(v, v > c.thr ? c.down : c.up);
}

// The constants as bf16 pairs, down and up also as raw bits for the select.
struct Consts2 {
  bf162 one, eps, zero, unit, thr;
  unsigned down, up;
};

__device__ __forceinline__ unsigned bits(bf162 v) { return *reinterpret_cast<unsigned*>(&v); }

__device__ __forceinline__ Consts2 pack(const Consts& c) {
  Consts2 p;
  p.one = __float2bfloat162_rn(c.one);
  p.eps = __float2bfloat162_rn(c.eps);
  p.zero = __float2bfloat162_rn(0.f);
  p.unit = __float2bfloat162_rn(1.f);
  p.thr = __float2bfloat162_rn(c.thr);
  p.down = bits(__float2bfloat162_rn(c.down));
  p.up = bits(__float2bfloat162_rn(c.up));
  return p;
}

__device__ __forceinline__ bf162 rep(bf162 v, const Consts2& c) {
  v = __hmin2_nan(__hmax2_nan(__hadd2_rn(__hmul2_rn(v, c.one), c.eps), c.zero), c.unit);
  const unsigned m = __hgt2_mask(v, c.thr);  // 0xffff in each half where v > thr
  unsigned f = (m & c.down) | (~m & c.up);
  return __hmul2_rn(v, *reinterpret_cast<bf162*>(&f));
}

// `reps` reps over N values side by side, unrolled by kUnroll.
template <typename V, typename C, int N>
__device__ __forceinline__ void run(V (&v)[N], int reps, const C& c) {
  int r = 0;
  for (; r + kUnroll <= reps; r += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = rep(v[i], c);
    }
  }
  for (; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = rep(v[i], c);
  }
}

// mode 0: fp32 storage and math; 1: bf16 storage and math; 2: bf16 storage,
// fp32 math
template <int MODE>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const void* __restrict__ x, void* __restrict__ out, long long n, int reps,
             Consts c) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (i0 >= n) return;
  const int m = n - i0 < kVec ? (int)(n - i0) : kVec;  // values of this thread
  if constexpr (MODE == 0) {
    const float* xs = static_cast<const float*>(x) + i0;
    float* os = static_cast<float*>(out) + i0;
    float v[kVec];
    if (m == kVec) {
      const float4 a = reinterpret_cast<const float4*>(xs)[0];
      const float4 b = reinterpret_cast<const float4*>(xs)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = i < m ? xs[i] : 0.f;
    }
    run(v, reps, c);
    if (m == kVec) {
      reinterpret_cast<float4*>(os)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(os)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (i < m) os[i] = v[i];
    }
    return;
  }
  const bf16* xs = static_cast<const bf16*>(x) + i0;
  bf16* os = static_cast<bf16*>(out) + i0;
  bf162 v[kVec / 2];
  if (m == kVec) {
    uint4 raw = *reinterpret_cast<const uint4*>(xs);
    const bf162* p = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) v[k] = p[k];
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k)
      v[k] = __halves2bfloat162(2 * k < m ? xs[2 * k] : zero,
                                2 * k + 1 < m ? xs[2 * k + 1] : zero);
  }
  if constexpr (MODE == 1) {
    run(v, reps, pack(c));
  } else {
    float f[kVec];
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      const float2 t = __bfloat1622float2(v[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
    run(f, reps, c);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) v[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  }
  if (m == kVec) {
    uint4 raw;
    bf162* p = reinterpret_cast<bf162*>(&raw);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) p[k] = v[k];
    *reinterpret_cast<uint4*>(os) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      if (2 * k < m) os[2 * k] = __low2bfloat16(v[k]);
      if (2 * k + 1 < m) os[2 * k + 1] = __high2bfloat16(v[k]);
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a mode or
// size the kernel does not take.
int vrl_elementwise_chain(const void* x, void* out, long long n, int reps, int mode,
                          float one, float eps, float thr, float down, float up,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || reps < 0) return cudaErrorInvalidValue;
  const long long blocks = (n + (long long)kThreads * kVec - 1) / ((long long)kThreads * kVec);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const Consts c{one, eps, thr, down, up};
  if (mode == 0) chain_kernel<0><<<(unsigned)blocks, kThreads, 0, s>>>(x, out, n, reps, c);
  else if (mode == 1) chain_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(x, out, n, reps, c);
  else if (mode == 2) chain_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(x, out, n, reps, c);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"

VRL_ERROR_STRING_EXPORT

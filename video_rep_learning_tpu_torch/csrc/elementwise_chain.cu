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
// and 1e-4 is 1.0014e-4). Every op rounds once, as the plain version's torch
// ops do: __fmul_rn / __fadd_rn in fp32 (nvcc would otherwise contract
// v * one + eps into one FMA), the packed bf16x2 intrinsics in bf16 (each an
// fma.rn with a zero or unit operand, correctly rounded).
//
// What bounds it on the H100: operations once REPS is more than a few (8 a
// rep: multiply, add, two clip bounds, compare, two multiplies, select; fp32
// at 67 TFLOP/s, bf16 at the 133.8 TFLOP/s of the packed non-tensor units).
// A thread holds 8 elements in registers for the whole chain: one 16-byte
// load and store (two in fp32), nothing in shared memory.
//
// x and out (n,) contiguous and 16-byte aligned. No allocation; launches on
// the caller's stream and returns cudaGetLastError().

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread

struct Consts {
  float one, eps, thr, down, up;
};

__device__ __forceinline__ float step(float v, const Consts& c, int reps) {
  for (int r = 0; r < reps; ++r) {
    v = fminf(fmaxf(__fadd_rn(__fmul_rn(v, c.one), c.eps), 0.f), 1.f);
    v = v > c.thr ? __fmul_rn(v, c.down) : __fmul_rn(v, c.up);
  }
  return v;
}

__device__ __forceinline__ bf162 step2(bf162 v, const Consts& c, int reps) {
  const bf162 one = __float2bfloat162_rn(c.one), eps = __float2bfloat162_rn(c.eps);
  const bf162 lo = __float2bfloat162_rn(0.f), hi = __float2bfloat162_rn(1.f);
  const bf16 thr = __float2bfloat16(c.thr), down = __float2bfloat16(c.down),
             up = __float2bfloat16(c.up);
  for (int r = 0; r < reps; ++r) {
    v = __hmin2(__hmax2(__hadd2(__hmul2(v, one), eps), lo), hi);
    v.x = __hgt(v.x, thr) ? __hmul(v.x, down) : __hmul(v.x, up);
    v.y = __hgt(v.y, thr) ? __hmul(v.y, down) : __hmul(v.y, up);
  }
  return v;
}

// mode 0: fp32 storage and math; 1: bf16 storage and math; 2: bf16 storage,
// fp32 math
template <int MODE>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const void* __restrict__ x, void* __restrict__ out, long long n, int reps,
             Consts c) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (i0 >= n) return;
  if (MODE == 0) {
    const float* xs = static_cast<const float*>(x) + i0;
    float* os = static_cast<float*>(out) + i0;
    if (i0 + kVec <= n) {
      float4 a = reinterpret_cast<const float4*>(xs)[0];
      float4 b = reinterpret_cast<const float4*>(xs)[1];
      a = make_float4(step(a.x, c, reps), step(a.y, c, reps), step(a.z, c, reps),
                      step(a.w, c, reps));
      b = make_float4(step(b.x, c, reps), step(b.y, c, reps), step(b.z, c, reps),
                      step(b.w, c, reps));
      reinterpret_cast<float4*>(os)[0] = a;
      reinterpret_cast<float4*>(os)[1] = b;
    } else {
      for (long long i = 0; i < n - i0; ++i) os[i] = step(xs[i], c, reps);
    }
    return;
  }
  const bf16* xs = static_cast<const bf16*>(x) + i0;
  bf16* os = static_cast<bf16*>(out) + i0;
  if (i0 + kVec <= n) {
    uint4 raw = *reinterpret_cast<const uint4*>(xs);
    bf162* v = reinterpret_cast<bf162*>(&raw);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      if (MODE == 1) {
        v[k] = step2(v[k], c, reps);
      } else {
        v[k] = __floats2bfloat162_rn(step(__low2float(v[k]), c, reps),
                                     step(__high2float(v[k]), c, reps));
      }
    }
    *reinterpret_cast<uint4*>(os) = raw;
  } else {
    for (long long i = 0; i < n - i0; ++i) {
      if (MODE == 1) {
        os[i] = __low2bfloat16(step2(__bfloat162bfloat162(xs[i]), c, reps));
      } else {
        os[i] = __float2bfloat16(step(__bfloat162float(xs[i]), c, reps));
      }
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

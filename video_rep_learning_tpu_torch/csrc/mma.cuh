// Warp-level tensor-core products (mma.sync) and cp.async copies, shared by
// the flash-attention forward (#1) and backward (#3) and the fused SCL passes
// (#10).
//
// fp32 operands run as 3xTF32 m16n8k8: each value is split into a tf32 hi
// and lo (cvt.rna), and lo*hi' + hi*lo' + hi*hi' is summed in fp32, which
// keeps about fp32's accuracy where one TF32 product keeps ~3 decimal
// digits. bf16 operands run as m16n8k16 with fp32 sums. wgmma takes tf32
// operands K-major only, and the products that read an operand down its
// rows (P V, p^T dO, G e) are not, hence mma.sync.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vrl {

// --- cp.async -------------------------------------------------------------

// 16 (or 4) bytes from global to shared memory; zeros where `in` is false
// (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + R) of a row-major (n, D) tensor into shared rows of kLd
// elements, 16 bytes a copy spread over kThreads threads; zeros past n.
template <int D, int R, int kLd, int kThreads, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0, int n) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = D / kChunk;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
    const bool in = r0 + r < n;
    cp_async16(dst + r * kLd + c, in ? src + (size_t)(r0 + r) * D + c : src, in);
  }
}

// --- the tensor-core products ---------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One warp's fragments of a 16 x kK A, a kK x 8 B and the 16 x 8 fp32
// accumulator (c[0], c[1]: row g, columns 2t, 2t + 1; c[2], c[3]: row g + 8),
// g = lane / 4, t = lane % 4. A product's k order is free as long as A and B
// follow the same one: `rows_a` / `rows_b` read k along a shared-memory row
// in the natural order; `acc_a` takes an accumulator tile as A, and
// `cols_b` reads B down the rows in that tile's order.
template <typename T>
struct Mma;

template <>
struct Mma<float> {  // 3xTF32, m16n8k8
  static constexpr int kK = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  // A[m][k] = s[(r0 + m) * ld + k0 + k]
  static __device__ __forceinline__ A rows_a(const float* s, int ld, int r0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* p = s + (r0 + g) * ld + k0 + t;
    A a;
    split(p[0], a.hi[0], a.lo[0]);
    split(p[8 * ld], a.hi[1], a.lo[1]);
    split(p[4], a.hi[2], a.lo[2]);
    split(p[8 * ld + 4], a.hi[3], a.lo[3]);
    return a;
  }
  // B[k][n] = s[(n0 + n) * ld + k0 + k]
  static __device__ __forceinline__ B rows_b(const float* s, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* p = s + (n0 + g) * ld + k0 + t;
    B b;
    split(p[0], b.hi[0], b.lo[0]);
    split(p[4], b.hi[1], b.lo[1]);
    return b;
  }
  // B[k][n] = s[(k0 + k) * ld + n0 + n], k in `acc_a`'s order: position t
  // is row 2t, position t + 4 row 2t + 1
  static __device__ __forceinline__ B cols_b(const float* s, int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* p = s + (k0 + 2 * t) * ld + n0 + g;
    B b;
    split(p[0], b.hi[0], b.lo[0]);
    split(p[ld], b.hi[1], b.lo[1]);
    return b;
  }
  // A = accumulator tile kk (16 x 8): k position t is its column 2t, t + 4
  // its column 2t + 1
  static __device__ __forceinline__ A acc_a(const float (*c)[4], int kk) {
    A a;
    split(c[kk][0], a.hi[0], a.lo[0]);
    split(c[kk][2], a.hi[1], a.lo[1]);
    split(c[kk][1], a.hi[2], a.lo[2]);
    split(c[kk][3], a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a, const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

template <>
struct Mma<__nv_bfloat16> {  // m16n8k16
  using bf16 = __nv_bfloat16;
  static constexpr int kK = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ uint32_t u32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ A rows_a(const bf16* s, int ld, int r0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bf16* p = s + (r0 + g) * ld + k0 + 2 * t;
    return A{{u32(p), u32(p + 8 * ld), u32(p + 8), u32(p + 8 * ld + 8)}};
  }
  static __device__ __forceinline__ B rows_b(const bf16* s, int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
    return B{{u32(p), u32(p + 8)}};
  }
  static __device__ __forceinline__ B cols_b(const bf16* s, int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bf16* p = s + (k0 + 2 * t) * ld + n0 + g;
    return B{{pack_raw(p[0], p[ld]), pack_raw(p[8 * ld], p[9 * ld])}};
  }
  // accumulator tiles 2kk, 2kk + 1 rounded to bf16 (the TPU kernels' cast of
  // p and ds to the input type before their products)
  static __device__ __forceinline__ A acc_a(const float (*c)[4], int kk) {
    const float* x = c[2 * kk];
    const float* y = c[2 * kk + 1];
    return A{{pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(y[0], y[1]),
              pack_bf16(y[2], y[3])}};
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a, const B& b) {
    mma_bf16(c, a.r, b.r);
  }
};

// The max and the sum over the four lanes of a quad: the lanes that hold one
// row of an accumulator tile.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// An accumulator's two neighbouring columns (c[0], c[1] or c[2], c[3]) to
// global memory in the output type.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace vrl

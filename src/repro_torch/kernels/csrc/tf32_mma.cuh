// Split-TF32 products on Hopper's tensor cores, and cp.async copies into
// shared memory: the helpers the tensor-core kernels share
// (mlstm_scan.cu, flash_attention.cu).
//
// A float32 product runs as mma.sync.aligned.m16n8k8 TF32 with each operand
// split into a TF32 hi and lo: float32 accuracy (the dropped lo.lo term is
// below 2^-22 of the product) at a third of the TF32 rate.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace libra {

// ---- split-TF32 products on the tensor cores --------------------------------
// x = hi + lo + r with hi = tf32(x), lo = tf32(x - hi), both rounded to
// nearest (ties away) to a 10-bit mantissa as cvt.rna.tf32.f32 rounds, and
// |r| <= 2^-22 |x|. A product is taken as lo.hi + hi.lo + hi.hi (lo.lo,
// below 2^-22 of it, is dropped): three mma.sync per 16 x 8 x 8 step.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  // cvt.rna.tf32.f32's rounding for finite x in two integer operations;
  // cvt itself compiles to a longer sequence that also guards Inf and NaN
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// D (16 x 8) += A (16 x 8) B (8 x 8) where p (warp-uniform); lane = 4 g + t
// holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k = t, n = g),
// (t + 4, g); D (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// Predicated: a skipped product is not computed, though ptxas still puts a
// branch and a WARPSYNC around it (mma_tf32_u below has neither).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], bool p) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "@p mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"((int)p));
}

struct FragA {  // a split A fragment
  uint32_t hi[4], lo[4];
};
struct FragB {  // a split B fragment
  uint32_t hi[2], lo[2];
};

// d += a b (if p): three TF32 products, float32 accumulation in the
// tensor core
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b, bool p = true) {
  mma_tf32(d, a.lo, b.hi, p);
  mma_tf32(d, a.hi, b.lo, p);
  mma_tf32(d, a.hi, b.hi, p);
}

// The same, unpredicated ("u"): ptxas is free to interleave the products
// of independent accumulators, which the branch around each predicated
// group prevents
__device__ __forceinline__ void mma_tf32_u(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma3_u(float (&d)[4], const FragA& a,
                                       const FragB& b) {
  mma_tf32_u(d, a.lo, b.hi);
  mma_tf32_u(d, a.hi, b.lo);
  mma_tf32_u(d, a.hi, b.hi);
}

// The lane's A fragment at (m0, k0) of a tile stored [m][k] (row stride
// ld = 4 mod 32 floats: the 32 lanes hit 32 banks) ...
__device__ __forceinline__ void load_a(FragA& f, const float* p, int ld,
                                       int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* r0 = p + (m0 + g) * ld + k0 + t;
  const float* r1 = r0 + 8 * ld;
  const float x[4] = {r0[0], r1[0], r0[4], r1[4]};
  split_tf32(x, f.hi, f.lo);
}

// ... and of a tile stored transposed, [k][m] (ld = 8 mod 32)
__device__ __forceinline__ void load_at(FragA& f, const float* p, int ld,
                                        int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* c0 = p + (k0 + t) * ld + m0 + g;
  const float* c1 = c0 + 4 * ld;
  const float x[4] = {c0[0], c0[8], c1[0], c1[8]};
  split_tf32(x, f.hi, f.lo);
}

// The lane's B fragment at (k0, n0) of a tile stored [k][n] (ld = 8 mod
// 32) ...
__device__ __forceinline__ void load_b(FragB& f, const float* p, int ld,
                                       int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* c = p + (k0 + t) * ld + n0 + g;
  const float x[2] = {c[0], c[4 * ld]};
  split_tf32(x, f.hi, f.lo);
}

// ... and of a tile stored transposed, [n][k] (ld = 4 mod 32)
__device__ __forceinline__ void load_bt(FragB& f, const float* p, int ld,
                                        int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* r = p + (n0 + g) * ld + k0 + t;
  const float x[2] = {r[0], r[4]};
  split_tf32(x, f.hi, f.lo);
}

// ---- cp.async: copies into shared memory that do not hold the thread; a
// copy with full = false writes zeros (rows past the sequence) ---------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace libra

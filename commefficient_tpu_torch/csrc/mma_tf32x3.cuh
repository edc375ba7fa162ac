// Float32 products on Hopper's tensor cores in "3xTF32", and the async
// tile copies that feed them. Shared by the flash attention kernels.
//
// A TF32 operand keeps 10 of float32's 23 mantissa bits; mma.sync ignores
// the low 13 bits of each operand register. Split each float x into big =
// tf32(x) (rounded as cvt.rna rounds: to nearest, ties away from zero)
// and small = x - big, exact in float32, which the tensor cores take
// truncated to TF32; big + small holds x to about 21 bits. A product a.b
// is then taken as small_a.big_b + big_a.small_b + big_a.big_b, each
// product of two TF32 values exact in the float32 accumulator, the two
// small terms first (CUTLASS's OpMultiplyAddFastF32 order); only
// small_a.small_b (2^-22 relative) is dropped. One TF32 product alone
// errs by about 1e-3 relative, far outside the float32 limits the port
// holds the flash kernels to; three keep float32's accuracy at up to 165
// TFLOP/s effective (495 / 3, less through mma.sync) against the CUDA
// cores' 67.
//
// For bfloat16 inputs every value is exact in TF32, so the small parts
// are zero and `mma` issues the big.big product alone (kThree = false).
//
// Fragments are those of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, with
// g = lane / 4 and q = lane % 4:
//   A (16 x 8, rows x k): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4),
//                         a3 (g + 8, q + 4)
//   B (8 x 8, k x n):     b0 (q, g), b1 (q + 4, g)
//   C (16 x 8):           c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q),
//                         c3 (g + 8, 2q + 1)
// A C fragment is an A fragment of the next product without shuffles if
// the next product's k index q stands for column 2q and q + 4 for 2q + 1:
// a = {c0, c2, c1, c3}, with the B operand's rows read in that order.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (the magnitude to 10
// mantissa bits, half away from zero), in two integer operations: cvt is
// a conversion, which issues at an eighth of the float32 rate
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// one operand element as the tensor cores take it
template <bool kThree>
struct Op {
  uint32_t big, small;
  __device__ __forceinline__ void set(float x) {
    if (kThree) {
      big = tf32(x);
      small = __float_as_uint(x - __uint_as_float(big));   // mma truncates
    } else {
      big = __float_as_uint(x);   // exact in TF32 already
    }
  }
};

template <bool kThree>
struct FragA {
  Op<kThree> x[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    x[0].set(a0);
    x[1].set(a1);
    x[2].set(a2);
    x[3].set(a3);
  }
};

template <bool kThree>
struct FragB {
  Op<kThree> x[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    x[0].set(b0);
    x[1].set(b1);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a.b: small.big, then big.small, then big.big (kThree), or big.big
template <bool kThree>
__device__ __forceinline__ void mma(float (&c)[4], const FragA<kThree>& a,
                                    const FragB<kThree>& b) {
  if (kThree) {
    mma_tf32(c, a.x[0].small, a.x[1].small, a.x[2].small, a.x[3].small,
             b.x[0].big, b.x[1].big);
    mma_tf32(c, a.x[0].big, a.x[1].big, a.x[2].big, a.x[3].big,
             b.x[0].small, b.x[1].small);
  }
  mma_tf32(c, a.x[0].big, a.x[1].big, a.x[2].big, a.x[3].big, b.x[0].big,
           b.x[1].big);
}

// as mma, but the three products go into a fresh fragment that is then
// added to c in float32, rounding to nearest: the tensor cores round their
// accumulator toward zero, and a long chain of such roundings in one
// accumulator drifts (for bfloat16, the one product goes into c)
template <bool kThree>
__device__ __forceinline__ void mma_rn(float (&c)[4], const FragA<kThree>& a,
                                       const FragB<kThree>& b) {
  if (!kThree) {
    mma(c, a, b);
    return;
  }
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !valid (then nothing is read)
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, as cp16
__device__ __forceinline__ void cp4(void* dst, const void* src,
                                    bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a row-major (t, d) matrix of T into a
// shared tile of ROWS x LD elements (LD = DP + one 16-byte chunk, DP the
// head dim padded to a multiple of 32), by 16-byte async copies of all
// NT threads. Rows >= t and columns in [d, DP) are zero. d must be a
// multiple of 8 and src 16-byte aligned.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int row0, int t, int d) {
  constexpr int kE = 16 / sizeof(T);   // elements per chunk
  constexpr int kC = DP / kE;          // chunks per padded row
  constexpr int kLd = DP + kE;
  static_assert(ROWS * kC % NT == 0, "every thread copies as many chunks");
#pragma unroll
  for (int it = 0; it < ROWS * kC / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    const int r = idx / kC, c = idx - r * kC;
    const int row = row0 + r;
    const bool ok = row < t && c * kE < d;
    cp16(dst + r * kLd + c * kE, ok ? src + (size_t)row * d + c * kE : src,
         ok);
  }
}

}  // namespace tc

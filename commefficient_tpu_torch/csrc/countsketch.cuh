// Tiled CountSketch hashing and XLA-exact float min/max, shared by the
// sketch and unsketch kernels. Bit for bit the reference's
// commefficient_tpu/ops/countsketch.py (_mix, _row_signs, _block_hashes,
// _median_small) in uint32 arithmetic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cs {

constexpr int kLanes = 128;

// murmur3-style avalanche finalizer
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

struct RowCoeffs {
  uint32_t h1, h2, h3, h4, h5, h6;
};

__device__ __forceinline__ RowCoeffs load_coeffs(const uint32_t* coeffs,
                                                 int row) {
  const uint32_t* c = coeffs + 6 * row;
  return RowCoeffs{c[0], c[1], c[2], c[3], c[4], c[5]};
}

// +-1 from the low bit of the mixed cubic polynomial of the coordinate id
__device__ __forceinline__ float sign_of(const RowCoeffs& h, uint32_t idx) {
  uint32_t acc = h.h1 * idx + h.h2;
  acc = acc * idx + h.h3;
  acc = acc * idx + h.h4;
  return (mix(acc) & 1u) ? -1.0f : 1.0f;
}

// the block's mixed hash; its window is mb % nwindows
__device__ __forceinline__ uint32_t block_mix(const RowCoeffs& h,
                                              uint32_t blk) {
  return mix(h.h6 * blk + h.h5);
}

__device__ __forceinline__ uint32_t lane_mask(const RowCoeffs& h,
                                              uint32_t mb) {
  return mix(mb ^ h.h5) & (kLanes - 1);
}

__device__ __forceinline__ float canonical_nan() {
  return __int_as_float(0x7fc00000);
}

// XLA's min/max: NaN-propagating, and -0.0 ordered below +0.0
__device__ __forceinline__ float xla_min(float a, float b) {
  if (isnan(a) || isnan(b)) return canonical_nan();
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}

__device__ __forceinline__ float xla_max(float a, float b) {
  if (isnan(a) || isnan(b)) return canonical_nan();
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

// the reference's median networks, in its operand order
template <int R>
__device__ __forceinline__ float median(const float* v);

template <>
__device__ __forceinline__ float median<1>(const float* v) {
  return v[0];
}

template <>
__device__ __forceinline__ float median<3>(const float* v) {
  return xla_max(xla_min(v[0], v[1]), xla_min(xla_max(v[0], v[1]), v[2]));
}

template <>
__device__ __forceinline__ float median<5>(const float* v) {
  float f = xla_min(v[0], v[1]), g = xla_max(v[0], v[1]);
  float h = xla_min(v[2], v[3]), i = xla_max(v[2], v[3]);
  float j = xla_max(f, h);
  float k = xla_min(g, i);
  return xla_max(xla_min(j, k), xla_min(xla_max(j, k), v[4]));
}

}  // namespace cs

// Tiled CountSketch hashing, XLA-exact float min/max and the per-tile
// estimate, shared by the sketch, estimates and unsketch kernels. Bit for
// bit the reference's commefficient_tpu/ops/countsketch.py (_mix,
// _row_signs, _block_hashes, _median_small) in uint32 arithmetic.
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

// --- per-tile estimates (the estimates kernel and the "est" top-k source)
// A tile is 64 blocks of 128 coordinates (8,192, the TPU tiling).
constexpr int kTileBlocks = 64;
constexpr int kTileN = kTileBlocks * kLanes;
constexpr int kMaxRows = 5;

// per-(row, block) window offset and lane mask of one tile, in shared memory
struct TileHashes {
  uint32_t col[kMaxRows][kTileBlocks];   // window base * 128
  uint32_t mask[kMaxRows][kTileBlocks];
};

// all threads of the CTA fill s; a __syncthreads must follow
template <int R>
__device__ __forceinline__ void load_tile_hashes(TileHashes& s,
                                                 const uint32_t* coeffs,
                                                 int nwindows, int tile) {
  for (int t = threadIdx.x; t < R * kTileBlocks; t += blockDim.x) {
    const int row = t / kTileBlocks, bl = t % kTileBlocks;
    const RowCoeffs h = load_coeffs(coeffs, row);
    const uint32_t mb = block_mix(h, (uint32_t)tile * kTileBlocks + (uint32_t)bl);
    s.col[row][bl] = (mb % (uint32_t)nwindows) * kLanes;
    s.mask[row][bl] = lane_mask(h, mb);
  }
}

template <int R>
struct Coeffs {
  RowCoeffs h[R];
};

template <int R>
__device__ __forceinline__ Coeffs<R> load_row_coeffs(const uint32_t* coeffs) {
  Coeffs<R> c;
#pragma unroll
  for (int row = 0; row < R; ++row) c.h[row] = load_coeffs(coeffs, row);
  return c;
}

// estimate of coordinate e (0..8191) of the tile: r window reads, the XOR
// un-permute, the sign, and the reference's median network
template <int R>
__device__ __forceinline__ float estimate(const float* table,
                                          size_t row_stride,
                                          const TileHashes& s,
                                          const Coeffs<R>& c, int tile,
                                          int e) {
  const int bl = e / kLanes;
  const uint32_t l = (uint32_t)(e % kLanes);
  const uint32_t idx = (uint32_t)tile * kTileN + (uint32_t)e;
  float v[R];
#pragma unroll
  for (int row = 0; row < R; ++row) {
    v[row] = __ldg(table + row * row_stride + s.col[row][bl]
                   + (l ^ s.mask[row][bl]))
             * sign_of(c.h[row], idx);
  }
  return median<R>(v);
}

}  // namespace cs

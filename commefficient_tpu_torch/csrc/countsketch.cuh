// Tiled CountSketch hashing, the median of r estimates and the per-tile
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

// the sign of coordinate idx as a float's sign bit (0 for +1, 1 << 31 for
// -1): the low bit of the mixed cubic polynomial of idx
__device__ __forceinline__ uint32_t sign_bit(const RowCoeffs& h,
                                             uint32_t idx) {
  uint32_t acc = h.h1 * idx + h.h2;
  acc = acc * idx + h.h3;
  acc = acc * idx + h.h4;
  return mix(acc) << 31;
}

// +-1.0f
__device__ __forceinline__ float sign_of(const RowCoeffs& h, uint32_t idx) {
  return __uint_as_float(0x3F800000u | sign_bit(h, idx));
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

// --- the median of r values, XLA's min/max network ---------------------
// On the order-preserving integer key of a float (its bits with the low
// 31 flipped where the sign is set; the map is its own inverse) signed
// integer min/max order every non-NaN value as XLA's float min/max do,
// -0.0 (key -1) below +0.0 (key 0), and return one of their operands, so
// the network on keys is bitwise the network on floats. For r = 3 and 5
// every input reaches the output through NaN-propagating nodes, so one
// test stands for all of them: any NaN input gives XLA's canonical NaN.
__device__ __forceinline__ int key_of(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ float canonical_nan() {
  return __int_as_float(0x7fc00000);
}

template <int R>
__device__ __forceinline__ bool any_nan(const float* v) {
  bool nan = false;
#pragma unroll
  for (int i = 0; i < R; ++i) nan |= isnan(v[i]);
  return nan;
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
  const int a = key_of(v[0]), b = key_of(v[1]), c = key_of(v[2]);
  const int m = max(min(a, b), min(max(a, b), c));
  return any_nan<3>(v) ? canonical_nan() : from_key(m);
}

template <>
__device__ __forceinline__ float median<5>(const float* v) {
  const int a = key_of(v[0]), b = key_of(v[1]), c = key_of(v[2]);
  const int d = key_of(v[3]), e = key_of(v[4]);
  const int j = max(min(a, b), min(c, d));   // drop the smaller of the mins
  const int k = min(max(a, b), max(c, d));   // drop the larger of the maxs
  const int m = max(min(j, k), min(max(j, k), e));
  return any_nan<5>(v) ? canonical_nan() : from_key(m);
}

// --- per-tile estimates (the estimates kernel and the "est" top-k source)
// A tile is 64 blocks of 128 coordinates (8,192, the TPU tiling).
constexpr int kTileBlocks = 64;
constexpr int kTileN = kTileBlocks * kLanes;
constexpr int kMaxRows = 5;

// per (row, block) of one tile, in shared memory: the window base * 128
// with the 7-bit lane mask in its low bits, so that coordinate lane l of
// the block reads table column win ^ l = base * 128 + (l ^ mask)
struct TileHashes {
  uint32_t win[kMaxRows][kTileBlocks];
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
    s.win[row][bl] = (mb % (uint32_t)nwindows) * kLanes | lane_mask(h, mb);
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

// estimate of coordinate e (0..8191) of the tile: the r window reads, the
// XOR un-permute folded into the column, the signs (FMUL by +-1: a NaN
// read comes out as the card's canonical NaN, as in the plain version on
// the card) and the median
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
  for (int row = 0; row < R; ++row)
    v[row] = __ldg(table + row * row_stride + (s.win[row][bl] ^ l))
             * sign_of(c.h[row], idx);
  return median<R>(v);
}

}  // namespace cs

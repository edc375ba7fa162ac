// Hardware-RNG dropout for Hopper (sm_90a).
//
// Replaces commefficient_tpu/ops/dropout.py::_hw_kernel (via _hw_apply and
// hw_dropout): out = bits >= threshold ? f32(x) * inv_keep : 0, in x's
// dtype, over the reference's (rows, 1024) view of x in (256, 1024)
// blocks. The TPU core's PRNG cannot be reproduced; the bits here are the
// reference's counter hash (counter_hash.cuh) of each element's (row
// within its block, lane) under the block's seed words (s0 + block *
// 0x9E3779B9, s1), the stream _hw_kernel seeds per grid block. So the bits
// are a function of the logical block alone, whatever this kernel's grid,
// and the forward and backward (the same launch on the cotangent) draw the
// same mask. There are no sums and one float multiply an element, so the
// output is bitwise its plain version, ops/dropout.py::hw_dropout_plain.
//
// Bound: bytes, x read once and the output written once (8 bytes an f32
// element), against ~20 integer operations of hashing. A grid-stride loop
// of 256-thread CTAs, each thread on 4 consecutive elements with one
// 16-byte (f32) or 8-byte (bf16) load and store; the wrapper passes
// contiguous 16-byte-aligned tensors whose length is a multiple of 1024.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCtas = 132 * 16;

__device__ __forceinline__ bool keep(long long i, uint32_t s0, uint32_t s1,
                                     uint32_t threshold) {
  const long long row = i >> 10;                     // 1024 lanes a row
  const uint32_t blk = (uint32_t)(row >> 8);         // 256 rows a block
  const uint32_t s0_b = s0 + blk * 0x9E3779B9u;
  return drop::counter_hash((uint32_t)(row & 255), (uint32_t)(i & 1023),
                            s0_b, s1) >= threshold;
}

__device__ __forceinline__ void load4(const float* x, long long v,
                                      float* a) {
  const float4 q = reinterpret_cast<const float4*>(x)[v];
  a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
}

__device__ __forceinline__ void store4(float* y, long long v,
                                       const float* a) {
  reinterpret_cast<float4*>(y)[v] = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* x, long long v,
                                      float* a) {
  const uint2 q = reinterpret_cast<const uint2*>(x)[v];
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* y, long long v,
                                       const float* a) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&lo);
  q.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(y)[v] = q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hw_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n4,
                  uint32_t s0, uint32_t s1, uint32_t threshold,
                  float inv_keep) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < n4;
       v += stride) {
    float a[4];
    load4(x, v, a);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[j] = keep(4 * v + j, s0, s1, threshold) ? a[j] * inv_keep : 0.0f;
    store4(y, v, a);
  }
}

template <typename T>
void launch(const void* x, void* y, long long n, uint32_t s0, uint32_t s1,
            uint32_t threshold, float inv_keep, cudaStream_t stream) {
  const long long n4 = n / 4;
  const long long want = (n4 + kThreads - 1) / kThreads;
  const int ctas = (int)(want < kMaxCtas ? want : kMaxCtas);
  hw_dropout_kernel<T><<<ctas, kThreads, 0, stream>>>(
      (const T*)x, (T*)y, n4, s0, s1, threshold, inv_keep);
}

}  // namespace

// x, y: n contiguous elements, n a multiple of 1024; dtype 0 float32,
// 1 bfloat16
extern "C" int hw_dropout_launch(const void* x, void* y, long long n,
                                 int dtype, unsigned s0, unsigned s1,
                                 unsigned threshold, float inv_keep,
                                 void* stream) {
  if (n <= 0 || n % 1024) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: launch<float>(x, y, n, s0, s1, threshold, inv_keep, st); break;
    case 1:
      launch<__nv_bfloat16>(x, y, n, s0, s1, threshold, inv_keep, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Dense CountSketch scatter for Hopper (sm_90a).
//
// Replaces commefficient_tpu/ops/sketch_kernels.py::_sketch_kernel. One
// 128-thread CTA per (row, window): lane l sums, from 0.0 and in
// ascending block order, x[b*128 + (l ^ m_b)] * sign(b*128 + (l ^ m_b))
// over the window's blocks b, read from a per-row CSR built on the host
// (CountSketch.kernel_tables). That is the order the TPU kernel's
// sequential grid adds them in, with no atomics, so the table is
// bit-identical to the reference and the same from run to run. Each
// table cell is written once. Blocks outside [block_offset,
// block_offset + ceil(n/128)) and coordinates at or past n add nothing
// (the reference adds +-0.0 there, which leaves every sum unchanged).
//
// Bound: bytes (the vector read once, the table written once), with
// ~18 integer and float operations of hashing per (row, coordinate).
#include "countsketch.cuh"

namespace {

__global__ void __launch_bounds__(cs::kLanes)
sketch_kernel(const float* __restrict__ x, long long n,
              long long block_offset, const int* __restrict__ win_ptr,
              const int* __restrict__ win_blocks,
              const uint32_t* __restrict__ coeffs, int nwindows,
              int nblocks, float* __restrict__ out) {
  const int w = blockIdx.x;
  const int row = blockIdx.y;
  const uint32_t l = threadIdx.x;
  const cs::RowCoeffs h = cs::load_coeffs(coeffs, row);
  const int* ptr = win_ptr + (size_t)row * (nwindows + 1);
  const int* blocks = win_blocks + (size_t)row * nblocks;
  const long long nb_chunk = (n + cs::kLanes - 1) / cs::kLanes;
  float acc = 0.0f;
  const int end = ptr[w + 1];
  for (int j = ptr[w]; j < end; ++j) {
    const uint32_t b = (uint32_t)blocks[j];
    const long long lb = (long long)b - block_offset;
    if (lb < 0 || lb >= nb_chunk) continue;
    const uint32_t src = l ^ cs::lane_mask(h, cs::block_mix(h, b));
    const long long i = lb * cs::kLanes + src;
    if (i >= n) continue;
    acc += x[i] * cs::sign_of(h, b * (uint32_t)cs::kLanes + src);
  }
  out[((size_t)row * nwindows + w) * cs::kLanes + l] = acc;
}

}  // namespace

extern "C" int sketch_launch(const void* x, long long n,
                             long long block_offset, const void* win_ptr,
                             const void* win_blocks, const void* coeffs,
                             int r, int nwindows, int nblocks, void* out,
                             void* stream) {
  dim3 grid(nwindows, r);
  sketch_kernel<<<grid, cs::kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, block_offset, (const int*)win_ptr,
      (const int*)win_blocks, (const uint32_t*)coeffs, nwindows, nblocks,
      (float*)out);
  return (int)cudaGetLastError();
}

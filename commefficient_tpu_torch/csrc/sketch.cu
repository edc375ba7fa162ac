// Dense CountSketch scatter for Hopper (sm_90a), unbatched and batched.
//
// Replaces commefficient_tpu/ops/sketch_kernels.py::_sketch_kernel, both
// its 1-D grid and its batched 2-D grid (batch, n_tiles), through one
// entry, sketch_launch: one batch row takes the BT = 1 instance, more take
// BT = kBatchTile. One 128-thread CTA per (window, row, tile of up to BT
// batch rows): lane l sums, from 0.0 and in ascending block order,
// x_b[j*128 + (l ^ m_b)] * sign(b*128 + (l ^ m_b)) over the window's
// blocks b (j = b - block_offset), read from a per-row CSR built
// on the host (CountSketch.kernel_tables). That is the order the TPU
// kernel's sequential grid adds them in, with no atomics, so each batch
// row's table is bit-identical to the reference's and to the unbatched
// kernel's, and the same from run to run. Each table cell is written
// once. Blocks outside [block_offset, block_offset + ceil(n/128)) and
// coordinates at or past n add nothing (the reference adds +-0.0 there,
// which leaves every sum unchanged).
//
// Bound: bytes (each vector read once, each table written once), with
// ~18 integer and float operations of hashing per (row, coordinate). The
// batched kernel hashes each block once per CTA and applies the lane
// permutation and sign to all of its batch rows, each in its own register
// accumulator: per batch row it adds one load and one add per (row,
// coordinate), so the hashing does not scale with B. Hashing once per
// batch row would make it operations-bound at GPT2's d.
#include "countsketch.cuh"

namespace {

constexpr int kBatchTile = 8;

template <int BT>
__global__ void __launch_bounds__(cs::kLanes)
sketch_kernel(const float* __restrict__ x, int nrows, long long n,
              long long block_offset, const int* __restrict__ win_ptr,
              const int* __restrict__ win_blocks,
              const uint32_t* __restrict__ coeffs, int nwindows,
              int nblocks, float* __restrict__ out) {
  const int w = blockIdx.x;
  const int row = blockIdx.y;
  const int r = gridDim.y;
  // BT = 1 runs only for a single batch row: its bounds are constants
  const int b0 = BT == 1 ? 0 : blockIdx.z * BT;
  const int nb = BT == 1 ? 1 : min(BT, nrows - b0);
  const uint32_t l = threadIdx.x;
  const cs::RowCoeffs h = cs::load_coeffs(coeffs, row);
  const int* ptr = win_ptr + (size_t)row * (nwindows + 1);
  const int* blocks = win_blocks + (size_t)row * nblocks;
  const long long nb_chunk = (n + cs::kLanes - 1) / cs::kLanes;
  const float* xb = x + (size_t)b0 * n;
  float acc[BT];
#pragma unroll
  for (int t = 0; t < BT; ++t) acc[t] = 0.0f;
  const int end = ptr[w + 1];
  for (int j = ptr[w]; j < end; ++j) {
    const uint32_t b = (uint32_t)blocks[j];
    const long long lb = (long long)b - block_offset;
    if (lb < 0 || lb >= nb_chunk) continue;
    const uint32_t src = l ^ cs::lane_mask(h, cs::block_mix(h, b));
    const long long i = lb * cs::kLanes + src;
    if (i >= n) continue;
    const float s = cs::sign_of(h, b * (uint32_t)cs::kLanes + src);
#pragma unroll
    for (int t = 0; t < BT; ++t)
      if (t < nb) acc[t] += xb[(size_t)t * n + i] * s;
  }
#pragma unroll
  for (int t = 0; t < BT; ++t)
    if (t < nb)
      out[(((size_t)(b0 + t) * r + row) * nwindows + w) * cs::kLanes + l] =
          acc[t];
}

}  // namespace

// x: (nrows, n) row-major; out: (nrows, r, nwindows * 128)
extern "C" int sketch_launch(const void* x, int nrows, long long n,
                             long long block_offset, const void* win_ptr,
                             const void* win_blocks, const void* coeffs,
                             int r, int nwindows, int nblocks, void* out,
                             void* stream) {
  const auto* xf = (const float*)x;
  const auto* wp = (const int*)win_ptr;
  const auto* wb = (const int*)win_blocks;
  const auto* co = (const uint32_t*)coeffs;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  if (nrows == 1) {
    dim3 grid(nwindows, r, 1);
    sketch_kernel<1><<<grid, cs::kLanes, 0, s>>>(
        xf, 1, n, block_offset, wp, wb, co, nwindows, nblocks, o);
  } else {
    dim3 grid(nwindows, r, (nrows + kBatchTile - 1) / kBatchTile);
    sketch_kernel<kBatchTile><<<grid, cs::kLanes, 0, s>>>(
        xf, nrows, n, block_offset, wp, wb, co, nwindows, nblocks, o);
  }
  return (int)cudaGetLastError();
}

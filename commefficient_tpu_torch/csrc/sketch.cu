// Dense CountSketch scatter for Hopper (sm_90a), unbatched and batched.
//
// Replaces commefficient_tpu/ops/sketch_kernels.py::_sketch_kernel, both
// its 1-D grid and its batched 2-D grid (batch, n_tiles), through one
// entry, sketch_launch. Each table cell (row, window w, lane l) is the sum,
// from 0.0 and in ascending block order, of x_b[j*128 + (l ^ m_b)] *
// sign(b*128 + (l ^ m_b)) over the blocks b the row hashes to w (j = b -
// block_offset). That is the order the TPU kernel's sequential grid adds
// them in, with no atomics, so each table is bit-identical to the
// reference's and the same from run to run.
//
// The per-row window lists come from the host (CountSketch.kernel_tables):
// each entry packs a block id and its 7-bit lane mask, (b << 7) | m_b,
// which is also the coordinate of the block's lane 0 with the mask in its
// low bits, so lane l's coordinate is entry ^ l and no block hash is
// computed here. One warp owns a (row, window) of one batch row; lane j
// holds the cells j + 32 q (q < 4), reads 32 entries at a time with one
// coalesced load and takes them from the warp by shuffles, and per step
// issues the x loads of kUnroll blocks (4 kUnroll a lane, each warp load
// one 128-byte segment) and their sign hashes before the adds, which keep
// the ascending order. A masked entry adds 0.0: no sum here is ever -0.0,
// so that leaves it unchanged, as the reference's padding leaves it. A
// batch runs as one launch per row from the C entry (one grid over all
// rows, with the row offset in the kernel, took 16 more registers and ran
// slower), each row's table bitwise the unbatched kernel's.
//
// Bound: operations at GPT2's d, bytes at ResNet9's: each (row,
// coordinate) costs a cubic, a finalizer and the signed add (about 16
// integer and float operations), against x read once and the table written
// once. The r rows' warps each sweep x, so x comes from device memory up
// to r times (less where the L2 keeps it: all of it at ResNet9's d).
// Walking x in L2-sized chunks, one launch a chunk, to read it once was
// slower (PERF.md).
#include "countsketch.cuh"

namespace {

constexpr int kWarps = 8;                  // (row, window)s of a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kCells = cs::kLanes / 32;    // table cells of a lane
constexpr int kUnroll = 4;                 // blocks in flight a step
constexpr uint32_t kNoEntry = 0xFFFFFFFFu;  // decodes past every x

__global__ void __launch_bounds__(kThreads)
sketch_kernel(const float* __restrict__ x, uint32_t n, uint32_t origin,
              const int* __restrict__ win_ptr,
              const uint32_t* __restrict__ packed,
              const uint32_t* __restrict__ coeffs, int r, int nwindows,
              int nblocks, float* __restrict__ out) {
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= r * nwindows) return;
  const int row = item / nwindows;
  const int w = item - row * nwindows;
  const uint32_t lane = threadIdx.x & 31;
  const int* ptr = win_ptr + (size_t)row * (nwindows + 1) + w;
  const int start = ptr[0];
  const int end = ptr[1];
  const uint32_t* list = packed + (size_t)row * nblocks;
  const cs::RowCoeffs h = cs::load_coeffs(coeffs, row);
  float* o = out + (size_t)item * cs::kLanes + lane;
  float acc[kCells] = {};
  for (int base = start; base < end; base += 32) {
    const int j = base + (int)lane;
    const uint32_t mine = j < end ? __ldg(list + j) : kNoEntry;
    const int cnt = min(32, end - base);
    for (int k = 0; k < cnt; k += kUnroll) {
      float v[kUnroll][kCells];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t p = __shfl_sync(0xffffffffu, mine, k + u);
#pragma unroll
        for (int q = 0; q < kCells; ++q) {
          // the coordinate, and its offset in x: past n for a block
          // outside [origin, origin + n) and for kNoEntry (d <= 2^32 - 128)
          const uint32_t idx = p ^ (lane + 32 * q);
          const uint32_t i = idx - origin;
          const float xv = i < n ? __ldg(x + i) : 0.0f;
          v[u][q] = __uint_as_float(__float_as_uint(xv) ^ cs::sign_bit(h, idx));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int q = 0; q < kCells; ++q) acc[q] += v[u][q];
    }
  }
#pragma unroll
  for (int q = 0; q < kCells; ++q) o[32 * q] = acc[q];
}

}  // namespace

// x: (nrows, n) row-major, its coordinates starting at block block_offset;
// win_ptr: (r, nwindows + 1) offsets of the window lists in packed (r,
// nblocks); out: (nrows, r, nwindows * 128)
extern "C" int sketch_launch(const void* x, int nrows, long long n,
                             long long block_offset, const void* win_ptr,
                             const void* packed, const void* coeffs, int r,
                             int nwindows, int nblocks, void* out,
                             void* stream) {
  if (nrows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int grid = (r * nwindows + kWarps - 1) / kWarps;
  const size_t table = (size_t)r * nwindows * cs::kLanes;
  for (int b = 0; b < nrows; ++b)
    sketch_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x + (size_t)b * n, (uint32_t)n,
        (uint32_t)(block_offset * cs::kLanes), (const int*)win_ptr,
        (const uint32_t*)packed, (const uint32_t*)coeffs, r, nwindows,
        nblocks, (float*)out + b * table);
  return (int)cudaGetLastError();
}

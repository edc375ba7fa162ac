// CountSketch estimates of every coordinate for Hopper (sm_90a), of one
// table or of a batch of tables.
//
// Replaces commefficient_tpu/ops/sketch_kernels.py::_estimates_kernel, both
// its unbatched grid (via estimates_pallas) and its batched 2-D grid
// (batch, n_tiles) (batched_call), through one entry, estimates_launch: one
// table takes the BT = 1 instance, more take BT = kBatchTile. A CTA of 256
// threads owns a tile of 8,192 coordinates and a tile of up to BT tables:
// it hashes the tile's 64 blocks per row into shared memory once, then
// each thread computes, for 32 coordinates (a warp on 32 consecutive
// ones), the r window offsets and signs once and, for each of its tables,
// the r window reads, the XOR un-permute, the sign and the reference's
// median network, and writes them. There are no sums, so every table's
// estimates are bitwise the plain version's and the BT = 1 instance's by
// construction. BT = 1 is today's loop over cs::estimate, unchanged.
//
// Bound: bytes and operations about alike at d = 6.57M, r = 5, B = 1: each
// table read once (10 MB, L2-resident) and each (d,) output written once,
// against r sign hashes, r gathers and the median per coordinate. For
// B > 1 the hashing is paid once per coordinate for all BT tables, and
// bytes bound: B (4 r c_eff + 4 d).
#include "countsketch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatchTile = 8;

template <int R, int BT>
__global__ void __launch_bounds__(kThreads)
estimates_kernel(const float* __restrict__ table, int B, long long d,
                 int nwindows, const uint32_t* __restrict__ coeffs,
                 float* __restrict__ out) {
  __shared__ cs::TileHashes s;
  const int tile = blockIdx.x;
  cs::load_tile_hashes<R>(s, coeffs, nwindows, tile);
  const cs::Coeffs<R> c = cs::load_row_coeffs<R>(coeffs);
  __syncthreads();
  const size_t row_stride = (size_t)nwindows * cs::kLanes;
  if constexpr (BT == 1) {
    for (int e = threadIdx.x; e < cs::kTileN; e += kThreads) {
      const long long i = (long long)tile * cs::kTileN + e;
      if (i >= d) break;
      out[i] = cs::estimate<R>(table, row_stride, s, c, tile, e);
    }
  } else {
    const int b0 = blockIdx.y * BT;
    const int nb = min(BT, B - b0);
    const size_t tab_stride = (size_t)R * row_stride;
    const float* tab = table + (size_t)b0 * tab_stride;
    float* o = out + (size_t)b0 * d;
    for (int e = threadIdx.x; e < cs::kTileN; e += kThreads) {
      const long long i = (long long)tile * cs::kTileN + e;
      if (i >= d) break;
      const int bl = e / cs::kLanes;
      const uint32_t l = (uint32_t)(e % cs::kLanes);
      const uint32_t idx = (uint32_t)tile * cs::kTileN + (uint32_t)e;
      size_t off[R];
      float sg[R];
#pragma unroll
      for (int row = 0; row < R; ++row) {
        off[row] = row * row_stride + s.col[row][bl] + (l ^ s.mask[row][bl]);
        sg[row] = cs::sign_of(c.h[row], idx);
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        if (t < nb) {
          float v[R];
#pragma unroll
          for (int row = 0; row < R; ++row)
            v[row] = __ldg(tab + t * tab_stride + off[row]) * sg[row];
          o[(size_t)t * d + i] = cs::median<R>(v);
        }
      }
    }
  }
}

template <int R>
void launch(const float* table, int B, long long d, int nwindows,
            const uint32_t* coeffs, float* out, cudaStream_t stream) {
  const int n_tiles = (int)((d + cs::kTileN - 1) / cs::kTileN);
  if (B == 1) {
    estimates_kernel<R, 1><<<n_tiles, kThreads, 0, stream>>>(
        table, 1, d, nwindows, coeffs, out);
  } else {
    dim3 grid(n_tiles, (B + kBatchTile - 1) / kBatchTile);
    estimates_kernel<R, kBatchTile><<<grid, kThreads, 0, stream>>>(
        table, B, d, nwindows, coeffs, out);
  }
}

}  // namespace

// table: (B, r, nwindows * 128) row-major; out: (B, d)
extern "C" int estimates_launch(const void* table, int B, long long d, int r,
                                int nwindows, const void* coeffs, void* out,
                                void* stream) {
  const float* tab = (const float*)table;
  const uint32_t* co = (const uint32_t*)coeffs;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1) return (int)cudaErrorInvalidValue;
  switch (r) {
    case 1: launch<1>(tab, B, d, nwindows, co, o, st); break;
    case 3: launch<3>(tab, B, d, nwindows, co, o, st); break;
    case 5: launch<5>(tab, B, d, nwindows, co, o, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

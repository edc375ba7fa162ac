// CountSketch estimates of every coordinate for Hopper (sm_90a).
//
// Replaces commefficient_tpu/ops/sketch_kernels.py::_estimates_kernel (the
// unbatched grid, via estimates_pallas). A CTA of 256 threads owns a tile
// of 8,192 coordinates: it hashes the tile's 64 blocks per row into shared
// memory once, then each thread computes cs::estimate (r window reads, the
// XOR un-permute, the sign and the reference's median network) for 32
// coordinates, a warp on 32 consecutive ones, and writes it. There are no
// sums, so the output is bitwise the plain version's by construction.
//
// Bound: bytes and operations about alike at d = 6.57M, r = 5: the table
// read once (10 MB, L2-resident) and the (d,) output written once, against
// r sign hashes, r gathers and the median per coordinate.
#include "countsketch.cuh"

namespace {

constexpr int kThreads = 256;

template <int R>
__global__ void __launch_bounds__(kThreads)
estimates_kernel(const float* __restrict__ table, long long d, int nwindows,
                 const uint32_t* __restrict__ coeffs,
                 float* __restrict__ out) {
  __shared__ cs::TileHashes s;
  const int tile = blockIdx.x;
  cs::load_tile_hashes<R>(s, coeffs, nwindows, tile);
  const cs::Coeffs<R> c = cs::load_row_coeffs<R>(coeffs);
  __syncthreads();
  const size_t row_stride = (size_t)nwindows * cs::kLanes;
  for (int e = threadIdx.x; e < cs::kTileN; e += kThreads) {
    const long long i = (long long)tile * cs::kTileN + e;
    if (i >= d) break;
    out[i] = cs::estimate<R>(table, row_stride, s, c, tile, e);
  }
}

template <int R>
void launch(const float* table, long long d, int nwindows,
            const uint32_t* coeffs, float* out, cudaStream_t stream) {
  const int n_tiles = (int)((d + cs::kTileN - 1) / cs::kTileN);
  estimates_kernel<R><<<n_tiles, kThreads, 0, stream>>>(table, d, nwindows,
                                                        coeffs, out);
}

}  // namespace

extern "C" int estimates_launch(const void* table, long long d, int r,
                                int nwindows, const void* coeffs, void* out,
                                void* stream) {
  const float* tab = (const float*)table;
  const uint32_t* co = (const uint32_t*)coeffs;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1: launch<1>(tab, d, nwindows, co, o, st); break;
    case 3: launch<3>(tab, d, nwindows, co, o, st); break;
    case 5: launch<5>(tab, d, nwindows, co, o, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

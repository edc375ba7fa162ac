// Fused CountSketch unsketch + exact radix top-k for Hopper (sm_90a).
//
// Replaces commefficient_tpu/ops/topk_kernels.py::_count_kernel and
// ::_select_kernel in their "est" source: the streaming top-k of
// topk_stream.cuh over a value source that computes each coordinate's
// estimate in registers: r window reads from the table (L2-resident at
// 10 MB), the XOR un-permute, the sign, and the reference's median network
// (cs::estimate). A warp holds 32 consecutive coordinates in flat order.
// The select's epilogue writes the masked estimate and the int32 mask.
//
// Bound: operations. Every launch recomputes r sign hashes, r gathers and
// the median for each coordinate, against one 10 MB read of the table.
#include "countsketch.cuh"
#include "topk_stream.cuh"

namespace {

template <int R>
struct EstSource {
  const float* table;
  size_t row_stride;
  int nwindows;
  const uint32_t* coeffs;
  float* masked;
  int* mask;

  using Shared = cs::TileHashes;
  using Local = cs::Coeffs<R>;

  __device__ __forceinline__ void load(Shared& s, int, int tile) const {
    cs::load_tile_hashes<R>(s, coeffs, nwindows, tile);
  }
  __device__ __forceinline__ Local local() const {
    return cs::load_row_coeffs<R>(coeffs);
  }
  __device__ __forceinline__ float value(const Shared& s, const Local& c,
                                         int, int tile, int e) const {
    return cs::estimate<R>(table, row_stride, s, c, tile, e);
  }
  __device__ __forceinline__ void emit(int, long long i, float x,
                                       bool sel) const {
    masked[i] = sel ? x : 0.0f;
    mask[i] = sel ? 1 : 0;
  }
};

template <int R>
EstSource<R> est_source(const void* table, int nwindows, const void* coeffs,
                        void* masked, void* mask) {
  return EstSource<R>{(const float*)table, (size_t)nwindows * cs::kLanes,
                      nwindows, (const uint32_t*)coeffs, (float*)masked,
                      (int*)mask};
}

}  // namespace

extern "C" int count_launch(const void* table, long long d, int r,
                            int nwindows, const void* coeffs,
                            const void* cands, void* counts, void* stream) {
  const int* ca = (const int*)cands;
  int* out = (int*)counts;
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1:
      topk::launch_count(est_source<1>(table, nwindows, coeffs, 0, 0), d, 1,
                         ca, out, st);
      break;
    case 3:
      topk::launch_count(est_source<3>(table, nwindows, coeffs, 0, 0), d, 1,
                         ca, out, st);
      break;
    case 5:
      topk::launch_count(est_source<5>(table, nwindows, coeffs, 0, 0), d, 1,
                         ca, out, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int select_launch(const void* table, long long d, int r,
                             int nwindows, const void* coeffs, const void* t,
                             const void* n_take, void* ties, void* offsets,
                             void* masked, void* mask, void* stream) {
  const int* tt = (const int*)t;
  const long long* nt = (const long long*)n_take;
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1:
      topk::launch_select(est_source<1>(table, nwindows, coeffs, masked, mask),
                          d, 1, tt, nt, (int*)ties, (int*)offsets, st);
      break;
    case 3:
      topk::launch_select(est_source<3>(table, nwindows, coeffs, masked, mask),
                          d, 1, tt, nt, (int*)ties, (int*)offsets, st);
      break;
    case 5:
      topk::launch_select(est_source<5>(table, nwindows, coeffs, masked, mask),
                          d, 1, tt, nt, (int*)ties, (int*)offsets, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

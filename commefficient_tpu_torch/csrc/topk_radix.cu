// Exact radix top-k over dense f32 streams for Hopper (sm_90a): a per-row
// histogram radix.
//
// Replaces commefficient_tpu/ops/topk_kernels.py::_count_kernel and
// ::_select_kernel in their "plain" source (topk_select_pallas, with its
// batched per-row-k grid) and "resid" source (fused_true_topk_pallas). The
// TPU kernels find the threshold by eight 4-bit rounds of 16 compares and a
// ninth count, each a full read of the stream. Here the stream is B rows of
// n floats, (B, n) row-major, each row with its own k (a device int64
// tensor), and grid (tiles, B) keeps one row per CTA:
//
// 1. rows_hist_kernel, three passes (radix.cuh's digits 30..20, 19..9,
//    8..0): each counts the digit of the row's keys whose higher digits
//    equal the row's prefix into a shared histogram, flushes it into the
//    row's global histogram with integer atomics, and the row's last CTA
//    picks the digit. The last pick leaves the row's t and n_take in its
//    workspace: nothing comes to the host. The shared adds are one plain
//    atomicAdd a lane: on an H100 the warp aggregation of the est source's
//    hist_add (__match_any_sync) made pass 0, where every lane adds,
//    several times slower than the other passes (PERF.md), and even an
//    all-zero stream, every lane on one bin, runs no slower without it.
// 2. rows_count_kernel: each tile's count of bits == t; the exclusive scan
//    of topk_stream.cuh turns them into each tile's first tie rank.
// 3. rows_select_kernel: keeps bits > t plus the first n_take ties in index
//    order (a block scan ranks the ties inside a tile) and hands each value
//    and its selection to the source's epilogue: plain writes where(sel, x,
//    0) and, when asked, the int32 mask; resid streams v beside err and
//    writes upd = where(sel, err, 0), and both residuals masked on supp =
//    sel & (upd != 0), so a selected 0.0 or -0.0 keeps its residual, as in
//    the reference. The momentum read g + rho*vv and err = ve + v stay
//    outside the kernels.
//
// Rows need not be 16-byte aligned (row r starts at 4*r*n bytes): with VEC a
// thread's four coordinates load and store as one float4 where they lie
// inside the row; without it (the wrapper's choice, for unaligned rows), as
// four scalars. Either way thread order is index order, which the tie rank
// needs.
//
// Bound: bytes. The design reads the stream five times (three digit passes,
// the tie count, the select) and writes the outputs once; per coordinate a
// square, a clamp, a shift, a compare and a shared add.
#include <type_traits>

#include "radix.cuh"
#include "topk_stream.cuh"

namespace {

using namespace radix;

// the four coordinates j..j+3 of a row of n; those at or past n read 0
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ row,
                                      long long j, long long n, float xs[4]) {
  if (VEC && j + 3 < n) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + j));
    xs[0] = v.x;
    xs[1] = v.y;
    xs[2] = v.z;
    xs[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) xs[q] = j + q < n ? __ldg(row + j + q) : 0.0f;
  }
}

template <bool VEC, class T>
__device__ __forceinline__ void store4(T* __restrict__ row, long long j,
                                       long long n, const T v[4]) {
  using T4 = typename std::conditional<std::is_same<T, float>::value, float4,
                                       int4>::type;
  if (VEC && j + 3 < n) {
    T4 w;
    w.x = v[0];
    w.y = v[1];
    w.z = v[2];
    w.w = v[3];
    *reinterpret_cast<T4*>(row + j) = w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j + q < n) row[j + q] = v[q];
  }
}

// digit pass PASS (shift SHIFT, WIDTH bits) of every row; ws: (rows,
// kCounts) int32, zeroed before pass 0; kk: (rows,) int64
template <int SHIFT, int WIDTH, int PASS, int HIST, bool LAST, bool VEC>
__global__ void __launch_bounds__(kThreads)
rows_hist_kernel(const float* __restrict__ x, long long n,
                 const long long* __restrict__ kk, int* __restrict__ ws_all) {
  __shared__ int s_hist[1 << WIDTH];
  __shared__ int s_warp[kWarps];
  __shared__ int s_last;
  const int row = blockIdx.y;
  int* ws = ws_all + (size_t)row * kCounts;
  const float* xr = x + (size_t)row * n;
  const unsigned prefix = (unsigned)ws[kCtrl + kPrefix];  // 0 in pass 0
  for (int b = threadIdx.x; b < (1 << WIDTH); b += kThreads) s_hist[b] = 0;
  __syncthreads();

  const long long base = (long long)blockIdx.x * kTileN;
  for (int step = 0; step < kVecSteps; ++step) {
    const long long j = base + step * 4 * kThreads + 4 * threadIdx.x;
    float xs[4];
    load4<VEC>(xr, j, n, xs);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned key = radix_key(topk::score_bits(xs[q]));
      if (j + q < n && (key >> (SHIFT + WIDTH)) == prefix)
        atomicAdd(s_hist + ((key >> SHIFT) & ((1u << WIDTH) - 1u)), 1);
    }
  }
  __syncthreads();
  flush_and_pick<WIDTH>(s_hist, ws, HIST, PASS, kk[row], LAST, s_warp,
                        &s_last);
}

// ties[row][tile] = the tile's count of bits == t[row]
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
rows_count_kernel(const float* __restrict__ x, long long n,
                  const int* __restrict__ ws_all, int* __restrict__ ties) {
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int t = ws_all[(size_t)row * kCounts + kCtrl + kT];
  const float* xr = x + (size_t)row * n;
  const long long base = (long long)tile * kTileN;
  int local = 0;
  for (int step = 0; step < kVecSteps; ++step) {
    const long long j = base + step * 4 * kThreads + 4 * threadIdx.x;
    float xs[4];
    load4<VEC>(xr, j, n, xs);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      local += j + q < n && topk::score_bits(xs[q]) == t;
  }
  const int total = topk::block_sum(local, s_warp);
  if (threadIdx.x == 0) ties[(size_t)row * gridDim.x + tile] = total;
}

struct PlainEpilogue {
  float* masked;
  int* mask;   // may be null: no mask output

  template <bool VEC>
  __device__ __forceinline__ void emit(int row, long long n, long long j,
                                       const float xs[4],
                                       const bool sel[4]) const {
    const size_t at = (size_t)row * n;
    float out[4];
    int m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[q] = sel[q] ? xs[q] : 0.0f;
      m[q] = sel[q];
    }
    store4<VEC>(masked + at, j, n, out);
    if (mask) store4<VEC>(mask + at, j, n, m);
  }
};

struct ResidEpilogue {   // one row: (err, v) -> (upd, new_v, new_err)
  const float* v;
  float* upd;
  float* new_v;
  float* new_err;

  template <bool VEC>
  __device__ __forceinline__ void emit(int, long long n, long long j,
                                       const float es[4],
                                       const bool sel[4]) const {
    float vs[4], u[4], nv[4], ne[4];
    load4<VEC>(v, j, n, vs);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u[q] = sel[q] ? es[q] : 0.0f;
      const bool supp = sel[q] && u[q] != 0.0f;
      nv[q] = supp ? 0.0f : vs[q];
      ne[q] = supp ? 0.0f : es[q];
    }
    store4<VEC>(upd, j, n, u);
    store4<VEC>(new_v, j, n, nv);
    store4<VEC>(new_err, j, n, ne);
  }
};

// bits > t plus the first n_take ties of the row in index order; offsets:
// (rows, n_tiles) exclusive scan of the tie counts
template <bool VEC, class Epi>
__global__ void __launch_bounds__(kThreads)
rows_select_kernel(const float* __restrict__ x, long long n,
                   const int* __restrict__ ws_all,
                   const int* __restrict__ offsets, Epi epi) {
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x, row = blockIdx.y;
  const int* ws = ws_all + (size_t)row * kCounts;
  const int t = ws[kCtrl + kT];
  const long long n_take =
      *reinterpret_cast<const long long*>(ws + kCtrl + kNTake);
  long long ties_before = offsets[(size_t)row * gridDim.x + tile];
  const float* xr = x + (size_t)row * n;
  const long long base = (long long)tile * kTileN;
  for (int step = 0; step < kVecSteps; ++step) {
    const long long j = base + step * 4 * kThreads + 4 * threadIdx.x;
    float xs[4];
    load4<VEC>(xr, j, n, xs);
    bool gt[4], eq[4];
    int n_eq = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int bits = topk::score_bits(xs[q]);
      const bool valid = j + q < n;
      gt[q] = valid && bits > t;
      eq[q] = valid && bits == t;
      n_eq += eq[q];
    }
    int total;
    long long e = ties_before + block_excl_scan(n_eq, s_warp, total);
    bool sel[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sel[q] = gt[q] || (eq[q] && e < n_take);
      e += eq[q];
    }
    epi.template emit<VEC>(row, n, j, xs, sel);
    ties_before += total;
  }
}

template <int SHIFT, int WIDTH, int PASS, int HIST, bool LAST>
void launch_hist(dim3 grid, cudaStream_t st, bool vec, const float* x,
                 long long n, const long long* kk, int* ws) {
  if (vec)
    rows_hist_kernel<SHIFT, WIDTH, PASS, HIST, LAST, true>
        <<<grid, kThreads, 0, st>>>(x, n, kk, ws);
  else
    rows_hist_kernel<SHIFT, WIDTH, PASS, HIST, LAST, false>
        <<<grid, kThreads, 0, st>>>(x, n, kk, ws);
}

// the tie counts, their scan and the select; ties: (2, rows, n_tiles) int32
// scratch (counts, then their exclusive scan)
template <bool VEC, class Epi>
void launch_select(const float* x, long long n, int rows, const int* ws,
                   int* ties, const Epi& epi, cudaStream_t st) {
  const int n_tiles = topk::num_tiles(n);
  const dim3 grid(n_tiles, rows);
  int* offsets = ties + (size_t)rows * n_tiles;
  rows_count_kernel<VEC><<<grid, kThreads, 0, st>>>(x, n, ws, ties);
  topk::exclusive_scan_kernel<<<rows, 1024, 0, st>>>(ties, offsets, n_tiles);
  rows_select_kernel<VEC, Epi><<<grid, kThreads, 0, st>>>(x, n, ws, offsets,
                                                          epi);
}

}  // namespace

// one digit pass over x (rows, n); ws: (rows, kCounts) int32, zeroed before
// pass 0; kk: (rows,) int64 per-row k; vec: every row is 16-byte aligned
extern "C" int rows_hist_launch(const void* x, long long n, int rows,
                                int pass, const void* kk, void* ws, int vec,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(topk::num_tiles(n), rows);
  const float* xs = (const float*)x;
  const long long* k = (const long long*)kk;
  int* w = (int*)ws;
  switch (pass) {
    case 0: launch_hist<20, 11, 0, kHist0, false>(grid, st, vec, xs, n, k, w);
      break;
    case 1: launch_hist<9, 11, 1, kHist1, false>(grid, st, vec, xs, n, k, w);
      break;
    case 2: launch_hist<0, 9, 2, kHist2, true>(grid, st, vec, xs, n, k, w);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// plain select after the three passes: masked (rows, n) f32 and, unless
// null, mask (rows, n) int32
extern "C" int rows_select_launch(const void* x, long long n, int rows,
                                  const void* ws, void* ties, void* masked,
                                  void* mask, int vec, void* stream) {
  const PlainEpilogue epi{(float*)masked, (int*)mask};
  if (vec)
    launch_select<true>((const float*)x, n, rows, (const int*)ws,
                        (int*)ties, epi, (cudaStream_t)stream);
  else
    launch_select<false>((const float*)x, n, rows, (const int*)ws,
                         (int*)ties, epi, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// resid select after the three passes over err (one row of n): update,
// new velocity and new error, each (n,) f32
extern "C" int rows_resid_launch(const void* err, const void* v, long long n,
                                 const void* ws, void* ties, void* upd,
                                 void* new_v, void* new_err, int vec,
                                 void* stream) {
  const ResidEpilogue epi{(const float*)v, (float*)upd, (float*)new_v,
                          (float*)new_err};
  if (vec)
    launch_select<true>((const float*)err, n, 1, (const int*)ws, (int*)ties,
                        epi, (cudaStream_t)stream);
  else
    launch_select<false>((const float*)err, n, 1, (const int*)ws,
                         (int*)ties, epi, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

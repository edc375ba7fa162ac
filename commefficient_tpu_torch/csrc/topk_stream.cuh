// Streaming exact radix top-k over 8,192-coordinate tiles, one design for
// every value source (est, plain, resid). The TPU kernels
// (commefficient_tpu/ops/topk_kernels.py::_count_kernel, ::_select_kernel)
// walk a sequential grid and carry counts and the tie rank across its
// steps. On Hopper the blocks run in no order, so:
//
// count: a CTA of 256 threads owns one tile of one row (grid (tiles, B))
//   and counts score bits >= each of the row's 16 candidates; a CTA
//   reduction and one integer atomicAdd per counter (exact in any order).
// select: pass A writes each tile's count of ties at the row's threshold
//   t, a one-block-per-row kernel scans them into exclusive offsets, and
//   pass B ranks the ties within the tile by warp ballots in flat order,
//   keeping bits > t plus the first n_take ties, and hands each value and
//   its selection to the source's epilogue.
//
// A score is the bits of x*x read as int32 (non-negative floats order like
// their bits). Coordinates at or past n neither count nor select.
//
// A Source provides:
//   struct Shared;  per-CTA state     struct Local;  per-thread state
//   void load(Shared&, int row, int tile) const   (every thread, before a
//                                                  __syncthreads)
//   Local local() const
//   float value(const Shared&, const Local&, int row, int tile, int e) const
//   void emit(int row, long long i, float x, bool sel) const
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kTileN = 8192;
constexpr int kSteps = kTileN / kThreads;  // 32
constexpr int kWarps = kThreads / 32;
constexpr int kNibbles = 16;

__device__ __forceinline__ int score_bits(float x) {
  return __float_as_int(x * x);
}

__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  return total;
}

// counts[row][c] += #{coordinates of the tile with bits >= cands[row][c]}
template <class Src>
__global__ void __launch_bounds__(kThreads)
count_kernel(Src src, long long n, const int* __restrict__ cands,
             int* __restrict__ counts) {
  __shared__ typename Src::Shared s;
  __shared__ int s_cand[kNibbles];
  __shared__ int s_red[kWarps][kNibbles];
  const int tile = blockIdx.x, row = blockIdx.y;
  src.load(s, row, tile);
  if (threadIdx.x < kNibbles)
    s_cand[threadIdx.x] = cands[row * kNibbles + threadIdx.x];
  const typename Src::Local l = src.local();
  __syncthreads();

  int local[kNibbles];
#pragma unroll
  for (int c = 0; c < kNibbles; ++c) local[c] = 0;
  for (int step = 0; step < kSteps; ++step) {
    const int e = step * kThreads + threadIdx.x;
    if ((long long)tile * kTileN + e >= n) break;
    const int bits = score_bits(src.value(s, l, row, tile, e));
#pragma unroll
    for (int c = 0; c < kNibbles; ++c) local[c] += bits >= s_cand[c];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kNibbles; ++c) {
    int v = local[c];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < kNibbles) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_red[w][threadIdx.x];
    atomicAdd(&counts[row * kNibbles + threadIdx.x], total);
  }
}

// pass A: ties[row][tile] = number of the tile's scores equal to t[row]
template <class Src>
__global__ void __launch_bounds__(kThreads)
tie_count_kernel(Src src, long long n, const int* __restrict__ t_ptr,
                 int* __restrict__ ties) {
  __shared__ typename Src::Shared s;
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x, row = blockIdx.y;
  src.load(s, row, tile);
  const typename Src::Local l = src.local();
  const int t = t_ptr[row];
  __syncthreads();

  int local = 0;
  for (int step = 0; step < kSteps; ++step) {
    const int e = step * kThreads + threadIdx.x;
    if ((long long)tile * kTileN + e >= n) break;
    local += score_bits(src.value(s, l, row, tile, e)) == t;
  }
  const int total = block_sum(local, s_warp);
  if (threadIdx.x == 0) ties[(size_t)row * gridDim.x + tile] = total;
}

// exclusive prefix sum of each row's n ints: one block of 1024 threads per
// row (blockIdx.x), so no sum crosses a row boundary
__global__ void __launch_bounds__(1024)
exclusive_scan_kernel(const int* __restrict__ in, int* __restrict__ out,
                      int n) {
  __shared__ int s_warp[32];
  __shared__ int s_carry;
  in += (size_t)blockIdx.x * n;
  out += (size_t)blockIdx.x * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? in[i] : 0;
    int x = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const int before = s_carry + (warp > 0 ? s_warp[warp - 1] : 0);
    if (i < n) out[i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) s_carry = before + x;
    __syncthreads();
  }
}

// pass B: bits > t plus the first n_take ties in flat-index order, each
// coordinate's value and selection handed to the source's epilogue
template <class Src>
__global__ void __launch_bounds__(kThreads)
select_kernel(Src src, long long n, const int* __restrict__ t_ptr,
              const long long* __restrict__ n_take_ptr,
              const int* __restrict__ tie_offsets) {
  __shared__ typename Src::Shared s;
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x, row = blockIdx.y;
  src.load(s, row, tile);
  const typename Src::Local l = src.local();
  const int t = t_ptr[row];
  const long long n_take = n_take_ptr[row];
  long long carry = tie_offsets[(size_t)row * gridDim.x + tile];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int step = 0; step < kSteps; ++step) {
    const int e = step * kThreads + threadIdx.x;
    const long long i = (long long)tile * kTileN + e;
    const bool valid = i < n;
    float x = 0.0f;
    int bits = INT_MIN;
    if (valid) {
      x = src.value(s, l, row, tile, e);
      bits = score_bits(x);
    }
    const bool eq = valid && bits == t;
    const unsigned ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, step_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      step_total += s_warp[w];
    }
    const long long rank =
        carry + before + __popc(ballot & ((1u << lane) - 1u));
    const bool sel = (valid && bits > t) || (eq && rank < n_take);
    if (valid) src.emit(row, i, x, sel);
    carry += step_total;
    __syncthreads();
  }
}

inline int num_tiles(long long n) { return (int)((n + kTileN - 1) / kTileN); }

template <class Src>
void launch_count(const Src& src, long long n, int rows, const int* cands,
                  int* counts, cudaStream_t stream) {
  const dim3 grid(num_tiles(n), rows);
  count_kernel<Src><<<grid, kThreads, 0, stream>>>(src, n, cands, counts);
}

// ties and offsets are (rows, num_tiles(n)) int32 scratch
template <class Src>
void launch_select(const Src& src, long long n, int rows, const int* t,
                   const long long* n_take, int* ties, int* offsets,
                   cudaStream_t stream) {
  const int n_tiles = num_tiles(n);
  const dim3 grid(n_tiles, rows);
  tie_count_kernel<Src><<<grid, kThreads, 0, stream>>>(src, n, t, ties);
  exclusive_scan_kernel<<<rows, 1024, 0, stream>>>(ties, offsets, n_tiles);
  select_kernel<Src><<<grid, kThreads, 0, stream>>>(src, n, t, n_take,
                                                    offsets);
}

}  // namespace topk

// Fused CountSketch unsketch + exact radix top-k for Hopper (sm_90a).
//
// Replaces commefficient_tpu/ops/topk_kernels.py::_count_kernel and
// ::_select_kernel in their "est" source. A CTA of 256 threads owns a
// tile of 8,192 coordinates (64 blocks of 128, the TPU tiling) and walks
// it in 32 steps of 256 consecutive coordinates, so a warp holds 32
// consecutive coordinates in flat order. Each coordinate's estimate is
// computed in registers: r window reads from the table (L2-resident at
// 10 MB), the XOR un-permute, the sign, and the reference's median
// network. Its score bits are float_as_int(e*e). Coordinates at or past
// d neither count nor select.
//
// count: 16 comparisons per coordinate, a CTA reduction, and one integer
//   atomicAdd per counter and CTA (exact in any order).
// select: the TPU kernel carries the tie count across its sequential
//   grid; here pass A writes each tile's tie count, a one-block kernel
//   scans them into exclusive offsets, and pass B ranks the ties within
//   the tile by warp ballots in flat order, keeping bits > t plus the
//   first n_take ties, and writes the masked estimate and the mask.
//
// Bound: operations. Every launch recomputes r sign hashes, r gathers and
// the median for each coordinate, against one 10 MB read of the table.
#include <climits>

#include "countsketch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileBlocks = 64;
constexpr int kTileN = kTileBlocks * cs::kLanes;  // 8,192
constexpr int kSteps = kTileN / kThreads;         // 32
constexpr int kWarps = kThreads / 32;
constexpr int kNibbles = 16;
constexpr int kMaxRows = 5;

// per-(row, block) window offset and lane mask of one tile, in shared memory
struct TileHashes {
  uint32_t col[kMaxRows][kTileBlocks];   // window base * 128
  uint32_t mask[kMaxRows][kTileBlocks];
};

template <int R>
__device__ __forceinline__ void load_tile_hashes(TileHashes& s,
                                                 const uint32_t* coeffs,
                                                 int nwindows, int tile) {
  for (int t = threadIdx.x; t < R * kTileBlocks; t += kThreads) {
    const int row = t / kTileBlocks, bl = t % kTileBlocks;
    const cs::RowCoeffs h = cs::load_coeffs(coeffs, row);
    const uint32_t mb =
        cs::block_mix(h, (uint32_t)tile * kTileBlocks + (uint32_t)bl);
    s.col[row][bl] = (mb % (uint32_t)nwindows) * cs::kLanes;
    s.mask[row][bl] = cs::lane_mask(h, mb);
  }
}

// estimate of coordinate e (0..8191) of the tile
template <int R>
__device__ __forceinline__ float estimate(const float* __restrict__ table,
                                          size_t row_stride,
                                          const TileHashes& s,
                                          const cs::RowCoeffs* h, int tile,
                                          int e) {
  const int bl = e / cs::kLanes;
  const uint32_t l = (uint32_t)(e % cs::kLanes);
  const uint32_t idx = (uint32_t)tile * kTileN + (uint32_t)e;
  float v[R];
#pragma unroll
  for (int row = 0; row < R; ++row) {
    v[row] = table[row * row_stride + s.col[row][bl] + (l ^ s.mask[row][bl])]
             * cs::sign_of(h[row], idx);
  }
  return cs::median<R>(v);
}

template <int R>
__device__ __forceinline__ void load_row_coeffs(cs::RowCoeffs* h,
                                                const uint32_t* coeffs) {
#pragma unroll
  for (int row = 0; row < R; ++row) h[row] = cs::load_coeffs(coeffs, row);
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

template <int R>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ table, long long d, int nwindows,
             const uint32_t* __restrict__ coeffs,
             const int* __restrict__ cands, int* __restrict__ counts) {
  __shared__ TileHashes s;
  __shared__ int s_cand[kNibbles];
  __shared__ int s_red[kWarps][kNibbles];
  const int tile = blockIdx.x;
  load_tile_hashes<R>(s, coeffs, nwindows, tile);
  if (threadIdx.x < kNibbles) s_cand[threadIdx.x] = cands[threadIdx.x];
  cs::RowCoeffs h[R];
  load_row_coeffs<R>(h, coeffs);
  __syncthreads();

  const size_t row_stride = (size_t)nwindows * cs::kLanes;
  int local[kNibbles];
#pragma unroll
  for (int c = 0; c < kNibbles; ++c) local[c] = 0;
  for (int step = 0; step < kSteps; ++step) {
    const int e = step * kThreads + threadIdx.x;
    if ((long long)tile * kTileN + e >= d) break;
    const float est = estimate<R>(table, row_stride, s, h, tile, e);
    const int bits = __float_as_int(est * est);
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
    atomicAdd(&counts[threadIdx.x], total);
  }
}

// pass A: number of coordinates of each tile whose score bits equal t
template <int R>
__global__ void __launch_bounds__(kThreads)
tie_count_kernel(const float* __restrict__ table, long long d, int nwindows,
                 const uint32_t* __restrict__ coeffs,
                 const int* __restrict__ t_ptr, int* __restrict__ ties) {
  __shared__ TileHashes s;
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x;
  load_tile_hashes<R>(s, coeffs, nwindows, tile);
  cs::RowCoeffs h[R];
  load_row_coeffs<R>(h, coeffs);
  const int t = *t_ptr;
  __syncthreads();

  const size_t row_stride = (size_t)nwindows * cs::kLanes;
  int local = 0;
  for (int step = 0; step < kSteps; ++step) {
    const int e = step * kThreads + threadIdx.x;
    if ((long long)tile * kTileN + e >= d) break;
    const float est = estimate<R>(table, row_stride, s, h, tile, e);
    local += __float_as_int(est * est) == t;
  }
  const int total = block_sum(local, s_warp);
  if (threadIdx.x == 0) ties[tile] = total;
}

// exclusive prefix sum of n ints, one block of 1024 threads
__global__ void __launch_bounds__(1024)
exclusive_scan_kernel(const int* __restrict__ in, int* __restrict__ out,
                      int n) {
  __shared__ int s_warp[32];
  __shared__ int s_carry;
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

// pass B: bits > t plus the first n_take ties in flat-index order
template <int R>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ table, long long d, int nwindows,
              const uint32_t* __restrict__ coeffs,
              const int* __restrict__ t_ptr,
              const long long* __restrict__ n_take_ptr,
              const int* __restrict__ tie_offsets,
              float* __restrict__ masked, int* __restrict__ mask) {
  __shared__ TileHashes s;
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x;
  load_tile_hashes<R>(s, coeffs, nwindows, tile);
  cs::RowCoeffs h[R];
  load_row_coeffs<R>(h, coeffs);
  const int t = *t_ptr;
  const long long n_take = *n_take_ptr;
  long long carry = tie_offsets[tile];
  __syncthreads();

  const size_t row_stride = (size_t)nwindows * cs::kLanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int step = 0; step < kSteps; ++step) {
    const int e = step * kThreads + threadIdx.x;
    const long long i = (long long)tile * kTileN + e;
    const bool valid = i < d;
    float est = 0.0f;
    int bits = INT_MIN;
    if (valid) {
      est = estimate<R>(table, row_stride, s, h, tile, e);
      bits = __float_as_int(est * est);
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
    if (valid) {
      masked[i] = sel ? est : 0.0f;
      mask[i] = sel ? 1 : 0;
    }
    carry += step_total;
    __syncthreads();
  }
}

template <int R>
void launch_count(const float* table, long long d, int nwindows,
                  const uint32_t* coeffs, const int* cands, int* counts,
                  cudaStream_t stream) {
  const int n_tiles = (int)((d + kTileN - 1) / kTileN);
  count_kernel<R><<<n_tiles, kThreads, 0, stream>>>(table, d, nwindows,
                                                    coeffs, cands, counts);
}

template <int R>
void launch_select(const float* table, long long d, int nwindows,
                   const uint32_t* coeffs, const int* t,
                   const long long* n_take, int* ties, int* offsets,
                   float* masked, int* mask, cudaStream_t stream) {
  const int n_tiles = (int)((d + kTileN - 1) / kTileN);
  tie_count_kernel<R><<<n_tiles, kThreads, 0, stream>>>(table, d, nwindows,
                                                        coeffs, t, ties);
  exclusive_scan_kernel<<<1, 1024, 0, stream>>>(ties, offsets, n_tiles);
  select_kernel<R><<<n_tiles, kThreads, 0, stream>>>(
      table, d, nwindows, coeffs, t, n_take, offsets, masked, mask);
}

}  // namespace

extern "C" int count_launch(const void* table, long long d, int r,
                            int nwindows, const void* coeffs,
                            const void* cands, void* counts, void* stream) {
  const float* tab = (const float*)table;
  const uint32_t* co = (const uint32_t*)coeffs;
  const int* ca = (const int*)cands;
  int* out = (int*)counts;
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1: launch_count<1>(tab, d, nwindows, co, ca, out, st); break;
    case 3: launch_count<3>(tab, d, nwindows, co, ca, out, st); break;
    case 5: launch_count<5>(tab, d, nwindows, co, ca, out, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int select_launch(const void* table, long long d, int r,
                             int nwindows, const void* coeffs, const void* t,
                             const void* n_take, void* ties, void* offsets,
                             void* masked, void* mask, void* stream) {
  const float* tab = (const float*)table;
  const uint32_t* co = (const uint32_t*)coeffs;
  const int* tt = (const int*)t;
  const long long* nt = (const long long*)n_take;
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1:
      launch_select<1>(tab, d, nwindows, co, tt, nt, (int*)ties,
                       (int*)offsets, (float*)masked, (int*)mask, st);
      break;
    case 3:
      launch_select<3>(tab, d, nwindows, co, tt, nt, (int*)ties,
                       (int*)offsets, (float*)masked, (int*)mask, st);
      break;
    case 5:
      launch_select<5>(tab, d, nwindows, co, tt, nt, (int*)ties,
                       (int*)offsets, (float*)masked, (int*)mask, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

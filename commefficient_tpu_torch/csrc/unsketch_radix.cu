// Fused CountSketch unsketch + exact top-k for Hopper (sm_90a): the
// estimates computed once, then a histogram radix over them.
//
// Replaces commefficient_tpu/ops/topk_kernels.py::_count_kernel and
// ::_select_kernel in their "est" source (unsketch_select_pallas). The TPU
// kernels recompute every coordinate's estimate in each of eight 4-bit radix
// rounds, a ninth count and the select. On an H100 the estimate is bound by
// integer operations (r sign hashes, r gathers, the XOR un-permute and the
// median network, cs::estimate), so this design computes it once:
//
// 1. est_hist_kernel: one CTA per 8,192-coordinate tile computes each
//    estimate, stores it to a (d,) f32 scratch, and builds the histogram of
//    the first digit of its radix key in shared memory (warp-aggregated
//    adds), flushed into a global histogram with integer atomics, which are
//    exact in any order. The last CTA to finish picks the digit (pick).
// 2. digit_hist_kernel, twice: the same over the stored estimates, counting
//    only the keys whose higher digits equal the picked prefix. The last
//    pick leaves t and n_take in the workspace: nothing comes to the host.
// 3. radix_count_kernel, the exclusive scan of topk_stream.cuh and
//    radix_select_kernel: per-tile counts of bits > t and of bits == t, their
//    exclusive scans (each tile's output offset and tie rank), then a pass
//    that keeps bits > t plus the first n_take ties in flat-index order and
//    writes either the dense (masked, mask) or the compacted (values,
//    indices) of the survivors in ascending index order.
//
// The radix itself (key, digits, pick, workspace) is radix.cuh's.
//
// Bound: the estimate pass by operations (the hashes); the other passes by
// bytes: the scratch is written once and read twice by the digit passes and
// twice by the select. At ResNet9's d (26 MB) it stays in the 50 MB L2.
#include <cstdint>

#include "countsketch.cuh"
#include "radix.cuh"
#include "topk_stream.cuh"

namespace {

using namespace radix;
constexpr int kSteps = kTileN / kThreads;          // 32 scalar steps

// s_hist[bin] += 1 for every active lane, one shared atomic per distinct bin
// of the warp (ties would otherwise serialise on one address). Every lane of
// the warp must call it.
__device__ __forceinline__ void hist_add(int* s_hist, unsigned bin,
                                         bool active) {
  const unsigned lanes = __ballot_sync(0xffffffffu, active);
  if (active) {
    const unsigned peers = __match_any_sync(lanes, bin);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(s_hist + bin, __popc(peers));
  }
}

// pass 0: every estimate computed once, stored, and its first digit counted
template <int R>
__global__ void __launch_bounds__(kThreads)
est_hist_kernel(const float* __restrict__ table, size_t row_stride,
                int nwindows, const uint32_t* __restrict__ coeffs,
                long long n, long long k, float* __restrict__ est,
                int* __restrict__ ws) {
  __shared__ cs::TileHashes s;
  __shared__ int s_hist[1 << 11];
  __shared__ int s_warp[kWarps];
  __shared__ int s_last;
  const int tile = blockIdx.x;
  cs::load_tile_hashes<R>(s, coeffs, nwindows, tile);
  for (int b = threadIdx.x; b < (1 << 11); b += kThreads) s_hist[b] = 0;
  const cs::Coeffs<R> c = cs::load_row_coeffs<R>(coeffs);
  __syncthreads();

  for (int step = 0; step < kSteps; ++step) {
    const int e = step * kThreads + threadIdx.x;
    const long long i = (long long)tile * kTileN + e;
    const bool valid = i < n;
    unsigned bin = 0;
    if (valid) {
      const float x = cs::estimate<R>(table, row_stride, s, c, tile, e);
      est[i] = x;
      bin = radix_key(topk::score_bits(x)) >> 20;
    }
    hist_add(s_hist, bin, valid);
  }
  __syncthreads();
  flush_and_pick<11>(s_hist, ws, kHist0, 0, k, false, s_warp, &s_last);
}

// passes 1 and 2: the digit at SHIFT of the stored estimates whose key
// agrees with the prefix picked so far. The scratch is padded to whole
// tiles, so the float4 loads stay inside it.
template <int SHIFT, int WIDTH, int PASS, int HIST, bool LAST>
__global__ void __launch_bounds__(kThreads)
digit_hist_kernel(const float* __restrict__ est, long long n, long long k,
                  int* __restrict__ ws) {
  __shared__ int s_hist[1 << WIDTH];
  __shared__ int s_warp[kWarps];
  __shared__ int s_last;
  const unsigned prefix = (unsigned)ws[kCtrl + kPrefix];
  for (int b = threadIdx.x; b < (1 << WIDTH); b += kThreads) s_hist[b] = 0;
  __syncthreads();

  const long long base = (long long)blockIdx.x * kTileN;
  for (int step = 0; step < kVecSteps; ++step) {
    const long long j = base + step * 4 * kThreads + 4 * threadIdx.x;
    const float4 v = *reinterpret_cast<const float4*>(est + j);
    const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned key = radix_key(topk::score_bits(xs[q]));
      const bool active = j + q < n && (key >> (SHIFT + WIDTH)) == prefix;
      hist_add(s_hist, (key >> SHIFT) & ((1u << WIDTH) - 1u), active);
    }
  }
  __syncthreads();
  flush_and_pick<WIDTH>(s_hist, ws, HIST, PASS, k, LAST, s_warp, &s_last);
}

// the select's counts: (bits > t, bits == t) of each tile, into counts[0]
// and counts[1]
__global__ void __launch_bounds__(kThreads)
radix_count_kernel(const float* __restrict__ est, long long n,
                   const int* __restrict__ ws, int* __restrict__ counts,
                   int n_tiles) {
  __shared__ int s_warp[kWarps];
  const int t = ws[kCtrl + kT];
  const long long base = (long long)blockIdx.x * kTileN;
  int packed = 0;  // bits > t in the low half, bits == t in the high half
  for (int step = 0; step < kVecSteps; ++step) {
    const long long j = base + step * 4 * kThreads + 4 * threadIdx.x;
    const float4 v = *reinterpret_cast<const float4*>(est + j);
    const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int bits = topk::score_bits(xs[q]);
      if (j + q < n) packed += (bits > t) + ((bits == t) << 16);
    }
  }
  const int total = topk::block_sum(packed, s_warp);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = total & 0xffff;
    counts[n_tiles + blockIdx.x] = total >> 16;
  }
}

// bits > t plus the first n_take ties in flat-index order. DENSE writes
// (where(sel, x, 0), sel) for every coordinate; otherwise the survivors go
// to values/indices at their rank in index order, and tile 0 fills the
// slots past the last survivor with (masked[0], 0), as the reference's
// compaction leaves them.
template <bool DENSE>
__global__ void __launch_bounds__(kThreads)
radix_select_kernel(const float* __restrict__ est, long long n, long long k,
                    const int* __restrict__ ws, const int* __restrict__ counts,
                    const int* __restrict__ offsets, int n_tiles,
                    float* __restrict__ masked, int* __restrict__ mask,
                    float* __restrict__ values,
                    long long* __restrict__ indices) {
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x;
  const int t = ws[kCtrl + kT];
  const long long n_take =
      *reinterpret_cast<const long long*>(ws + kCtrl + kNTake);
  const long long take = n_take > 0 ? n_take : 0;
  const long long gt_base = offsets[tile], eq_base = offsets[n_tiles + tile];
  long long gt_tile = 0, eq_tile = 0;  // the tile's counts before this step
  const long long base = (long long)tile * kTileN;
  for (int step = 0; step < kVecSteps; ++step) {
    const long long j = base + step * 4 * kThreads + 4 * threadIdx.x;
    const float4 v = *reinterpret_cast<const float4*>(est + j);
    const float xs[4] = {v.x, v.y, v.z, v.w};
    bool gt[4], eq[4];
    int packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int bits = topk::score_bits(xs[q]);
      const bool valid = j + q < n;
      gt[q] = valid && bits > t;
      eq[q] = valid && bits == t;
      packed += gt[q] + (eq[q] << 16);
    }
    int total;
    const int before = block_excl_scan(packed, s_warp, total);
    // coordinates above t and ties at t before this thread's first one
    long long g = gt_base + gt_tile + (before & 0xffff);
    long long e = eq_base + eq_tile + (before >> 16);
    bool sel[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sel[q] = gt[q] || (eq[q] && e < n_take);
      if (!DENSE && sel[q]) {
        const long long pos = g + (e < take ? e : take);
        if (pos < k) {
          values[pos] = xs[q];
          indices[pos] = j + q;
        }
      }
      g += gt[q];
      e += eq[q];
    }
    if (DENSE) {
      if (j + 3 < n) {
        *reinterpret_cast<float4*>(masked + j) =
            make_float4(sel[0] ? xs[0] : 0.0f, sel[1] ? xs[1] : 0.0f,
                        sel[2] ? xs[2] : 0.0f, sel[3] ? xs[3] : 0.0f);
        *reinterpret_cast<int4*>(mask + j) =
            make_int4(sel[0], sel[1], sel[2], sel[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q < n) {
            masked[j + q] = sel[q] ? xs[q] : 0.0f;
            mask[j + q] = sel[q];
          }
        }
      }
    }
    gt_tile += total & 0xffff;
    eq_tile += total >> 16;
  }
  if (!DENSE && tile == 0) {
    const int last = n_tiles - 1;
    const long long gt_all = (long long)offsets[last] + counts[last];
    const long long eq_all =
        (long long)offsets[n_tiles + last] + counts[n_tiles + last];
    const long long n_sel = gt_all + (eq_all < take ? eq_all : take);
    const float x0 = est[0];
    const int bits0 = topk::score_bits(x0);
    const float v0 = (bits0 > t || (bits0 == t && n_take > 0)) ? x0 : 0.0f;
    for (long long p = n_sel + threadIdx.x; p < k; p += kThreads) {
      values[p] = v0;
      indices[p] = 0;
    }
  }
}

template <int R>
void launch_est_hist(const void* table, long long d, int nwindows,
                     const void* coeffs, long long k, void* est, void* ws,
                     cudaStream_t st) {
  est_hist_kernel<R><<<topk::num_tiles(d), kThreads, 0, st>>>(
      (const float*)table, (size_t)nwindows * cs::kLanes, nwindows,
      (const uint32_t*)coeffs, d, k, (float*)est, (int*)ws);
}

}  // namespace

// est: (num_tiles(d) * 8192,) f32 scratch; ws: the int32 workspace, zeroed
extern "C" int est_hist_launch(const void* table, long long d, int r,
                               int nwindows, const void* coeffs, long long k,
                               void* est, void* ws, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1: launch_est_hist<1>(table, d, nwindows, coeffs, k, est, ws, st);
      break;
    case 3: launch_est_hist<3>(table, d, nwindows, coeffs, k, est, ws, st);
      break;
    case 5: launch_est_hist<5>(table, d, nwindows, coeffs, k, est, ws, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int digit_hist_launch(const void* est, long long d, int pass,
                                 long long k, void* ws, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = topk::num_tiles(d);
  switch (pass) {
    case 1:
      digit_hist_kernel<9, 11, 1, kHist1, false><<<n_tiles, kThreads, 0, st>>>(
          (const float*)est, d, k, (int*)ws);
      break;
    case 2:
      digit_hist_kernel<0, 9, 2, kHist2, true><<<n_tiles, kThreads, 0, st>>>(
          (const float*)est, d, k, (int*)ws);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the select after the three passes: dense when masked is given (masked,
// mask: (d,)), else compact (values (k,) f32, indices (k,) int64)
extern "C" int radix_select_launch(const void* est, long long d, long long k,
                                   void* ws, void* masked, void* mask,
                                   void* values, void* indices, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = topk::num_tiles(d);
  int* w = (int*)ws;
  int* counts = w + kCounts;
  int* offsets = counts + 2 * n_tiles;
  radix_count_kernel<<<n_tiles, kThreads, 0, st>>>((const float*)est, d, w,
                                                   counts, n_tiles);
  topk::exclusive_scan_kernel<<<2, 1024, 0, st>>>(counts, offsets, n_tiles);
  if (masked)
    radix_select_kernel<true><<<n_tiles, kThreads, 0, st>>>(
        (const float*)est, d, k, w, counts, offsets, n_tiles, (float*)masked,
        (int*)mask, nullptr, nullptr);
  else
    radix_select_kernel<false><<<n_tiles, kThreads, 0, st>>>(
        (const float*)est, d, k, w, counts, offsets, n_tiles, nullptr,
        nullptr, (float*)values, (long long*)indices);
  return (int)cudaGetLastError();
}

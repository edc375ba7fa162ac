// The histogram radix select shared by the est source (unsketch_radix.cu)
// and the dense streams (topk_radix.cu): three digit passes over a 31-bit
// key, each building its histogram in shared memory (each source its own
// way), flushed into a global one with integer atomics (exact in any
// order); the last CTA of a pass picks the digit on the device, so the
// threshold never comes to the host.
//
// The score bits are those of x*x read as int32; the radix key clamps them
// at 0 (31 bits). The reference's radix never goes below 0 (its first round
// skips the negative candidates), so its threshold is t = max{v in
// [0, 2^31 - 1] : #(bits >= v) >= k}, or 0 if there is none, and n_take =
// k - #(bits >= t + 1), with t + 1 saturating at INT_MAX; the pick takes the
// largest bin whose count at or above it reaches the k left, or bin 0 if
// none does, which gives exactly that. Digits: key bits 30..20, 19..9, 8..0.
//
// The workspace of one selection (one row) is int32, mirrored in
// ops/topk_kernels.py (_WS_*): three histograms, then the control words.
// A grid of several rows passes each row's own block; the done counters
// count the CTAs of one row (gridDim.x).
#pragma once

#include <climits>

#include "topk_stream.cuh"

namespace radix {

constexpr int kThreads = topk::kThreads;           // 256
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = topk::kTileN;               // 8,192
constexpr int kVecSteps = kTileN / (4 * kThreads); // 8 steps of 4 a thread

constexpr int kHist0 = 0, kHist1 = 2048, kHist2 = 4096;
constexpr int kCtrl = 4608;
constexpr int kDone = 0;     // + pass: CTAs finished
constexpr int kPrefix = 3;   // key digits picked so far
constexpr int kKrem = 4;     // k less the keys above the prefix
constexpr int kAbove = 5;    // keys above the prefix
constexpr int kT = 6;        // the threshold bits
constexpr int kNTake = 8;    // int64: ties at t to keep
constexpr int kCounts = kCtrl + 16;

__device__ __forceinline__ unsigned radix_key(int bits) {
  return bits < 0 ? 0u : (unsigned)bits;
}

// exclusive prefix sum over the CTA's threads in thread order; total gets
// the sum of all
__device__ __forceinline__ int block_excl_scan(int v, int* s_warp,
                                               int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = s_warp[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();
  return before + x - v;
}

// The digit pick, run by the last CTA of a histogram pass: the largest bin b
// with #(keys in bins >= b) >= k_rem (bin 0 if none), then the prefix, the k
// left and the count above are updated; the last pass writes t and n_take.
template <int WIDTH>
__device__ void pick(int* ws, int hist, int pass, long long k, bool last,
                     int* s_warp) {
  constexpr int kBins = 1 << WIDTH, kPer = kBins / kThreads;
  int* ctrl = ws + kCtrl;
  // thread i holds the kPer bins just below kBins - i * kPer, so the bins
  // above a thread's are those of the threads before it
  const int hi = kBins - (int)threadIdx.x * kPer;
  int h[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    h[j] = __ldcg(ws + hist + hi - 1 - j);
    sum += h[j];
  }
  int total;
  long long acc = block_excl_scan(sum, s_warp, total);
  const long long k_rem = pass == 0 ? k : ctrl[kKrem];
  int found = -1, found_h = 0;
  long long above_b = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = hi - 1 - j;
    if (acc + h[j] >= k_rem && (b == kBins - 1 || acc < k_rem)) {
      found = b;
      found_h = h[j];
      above_b = acc;
    }
    acc += h[j];
  }
  if (threadIdx.x == kThreads - 1 && total < k_rem) {  // fewer keys than k
    found = 0;
    found_h = h[kPer - 1];
    above_b = total - (long long)found_h;
  }
  if (found < 0) return;
  const int prefix = pass == 0 ? 0 : ctrl[kPrefix];
  const int next = (prefix << WIDTH) | found;
  const long long above = (pass == 0 ? 0 : ctrl[kAbove]) + above_b;
  ctrl[kPrefix] = next;
  ctrl[kKrem] = (int)(k_rem - above_b);
  ctrl[kAbove] = (int)above;
  if (last) {
    ctrl[kT] = next;
    *reinterpret_cast<long long*>(ctrl + kNTake) =
        k - above - (next == INT_MAX ? found_h : 0);
  }
}

// flush the CTA's histogram into the pass's global one; the last CTA to
// finish then picks the digit
template <int WIDTH>
__device__ __forceinline__ void flush_and_pick(const int* s_hist, int* ws,
                                               int hist, int pass,
                                               long long k, bool last,
                                               int* s_warp, int* s_last) {
  for (int b = threadIdx.x; b < (1 << WIDTH); b += kThreads) {
    const int c = s_hist[b];
    if (c) atomicAdd(ws + hist + b, c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(ws + kCtrl + kDone + pass, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  pick<WIDTH>(ws, hist, pass, k, last, s_warp);
}

}  // namespace radix

// Deterministic segmented sum for the sparse re-sketch
// (CountSketch.sketch_sparse). Not a port of a TPU kernel: the reference
// sums the k survivors into their buckets with XLA's segment_sum, which on
// the CPU adds each bucket's updates in the order the indices list them.
// The caller sorts the flat (row, bucket) keys stably, so each run of equal
// keys holds its updates in that order; the thread at the first element of
// a run adds them one by one to out[key]. No atomics: the result is the
// same in every run, and bitwise index_add_ on the CPU.
#include <cuda_runtime.h>

namespace {

__global__ void segment_sum_kernel(const long long* __restrict__ keys,
                                   const float* __restrict__ vals,
                                   long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long key = keys[i];
  if (i > 0 && keys[i - 1] == key) return;
  float acc = out[key];
  for (long long j = i; j < n && keys[j] == key; ++j) acc += vals[j];
  out[key] = acc;
}

}  // namespace

// keys: (n,) int64 sorted, vals: (n,) f32 in the same order, out: f32
extern "C" int segment_sum_launch(const void* keys, const void* vals,
                                  long long n, void* out, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  segment_sum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const float*)vals, n, (float*)out);
  return (int)cudaGetLastError();
}

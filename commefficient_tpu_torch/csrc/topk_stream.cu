// Exact radix top-k over dense f32 streams for Hopper (sm_90a).
//
// Replaces commefficient_tpu/ops/topk_kernels.py::_count_kernel and
// ::_select_kernel in their "plain" and "resid" sources, and their batched
// per-row-k grid: the streaming top-k of topk_stream.cuh with the values
// read straight from device memory. A plain stream is B rows of n floats,
// (B, n) row-major; each row has its own candidates, threshold and tie
// quota, and grid (tiles, B) keeps one row per CTA.
//
// plain select writes where(sel, x, 0) and, when asked, the int32 mask.
// resid select is the true_topk server epilogue over (err, v): upd =
// where(sel, err, 0), and both residuals masked on supp = sel & (upd != 0),
// so a selected 0.0 or -0.0 keeps its residual as in the reference. The
// momentum read g + rho*vv and err = ve + v stay outside the kernel.
//
// Bound: bytes. The count reads the stream once (4 B per element) for 16
// integer compares; the select reads it twice and writes its outputs once.
#include "topk_stream.cuh"

namespace {

struct Empty {};

struct PlainSource {
  const float* x;
  long long n;
  float* masked;
  int* mask;   // may be null: no mask output

  using Shared = Empty;
  using Local = Empty;

  __device__ __forceinline__ void load(Shared&, int, int) const {}
  __device__ __forceinline__ Local local() const { return Local{}; }
  __device__ __forceinline__ float value(const Shared&, const Local&,
                                         int row, int tile, int e) const {
    return __ldg(x + (size_t)row * n + (size_t)tile * topk::kTileN + e);
  }
  __device__ __forceinline__ void emit(int row, long long i, float v,
                                       bool sel) const {
    const size_t at = (size_t)row * n + i;
    masked[at] = sel ? v : 0.0f;
    if (mask) mask[at] = sel ? 1 : 0;
  }
};

struct ResidSource {
  const float* err;
  const float* v;
  float* upd;
  float* new_v;
  float* new_err;

  using Shared = Empty;
  using Local = Empty;

  __device__ __forceinline__ void load(Shared&, int, int) const {}
  __device__ __forceinline__ Local local() const { return Local{}; }
  __device__ __forceinline__ float value(const Shared&, const Local&, int,
                                         int tile, int e) const {
    return __ldg(err + (size_t)tile * topk::kTileN + e);
  }
  __device__ __forceinline__ void emit(int, long long i, float e,
                                       bool sel) const {
    const float u = sel ? e : 0.0f;
    const bool supp = sel && u != 0.0f;
    upd[i] = u;
    new_v[i] = supp ? 0.0f : __ldg(v + i);
    new_err[i] = supp ? 0.0f : e;
  }
};

}  // namespace

extern "C" int count_plain_launch(const void* x, long long n, int rows,
                                  const void* cands, void* counts,
                                  void* stream) {
  const PlainSource src{(const float*)x, n, nullptr, nullptr};
  topk::launch_count(src, n, rows, (const int*)cands, (int*)counts,
                     (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int select_plain_launch(const void* x, long long n, int rows,
                                   const void* t, const void* n_take,
                                   void* ties, void* offsets, void* masked,
                                   void* mask, void* stream) {
  const PlainSource src{(const float*)x, n, (float*)masked, (int*)mask};
  topk::launch_select(src, n, rows, (const int*)t, (const long long*)n_take,
                      (int*)ties, (int*)offsets, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int select_resid_launch(const void* err, const void* v,
                                   long long n, const void* t,
                                   const void* n_take, void* ties,
                                   void* offsets, void* upd, void* new_v,
                                   void* new_err, void* stream) {
  const ResidSource src{(const float*)err, (const float*)v, (float*)upd,
                        (float*)new_v, (float*)new_err};
  topk::launch_select(src, n, 1, (const int*)t, (const long long*)n_take,
                      (int*)ties, (int*)offsets, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

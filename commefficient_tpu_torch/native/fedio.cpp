// fedio: native (C++) host data plane for the federated input pipeline
// (the PyTorch port's copy of commefficient_tpu/native/fedio.cpp: the same
// three entry points, the same arithmetic, ABI 1).
//
// Fused augment+normalize batch kernels, threaded across images, callable
// from Python via ctypes with the GIL released, so the host feed costs
// the dispatching thread one call a batch instead of the numpy stages'
// per-image loops.
//
// Every kernel is a pure function: (uint8 source batch, per-image integer
// params sampled in Python) -> float32 model-ready batch. Randomness stays
// in Python (numpy RandomState) so the numpy and native pipelines consume
// identical random sequences and can be cross-checked exactly.
//
// Bilinear sampling matches data/transforms.py::_bilinear_resize
// (half-pixel centers, edge clamp) so the two paths agree to float
// rounding.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread, at first use, by
// native/__init__.py. No external deps.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Persistent worker pool: spawning+joining fresh threads per kernel call
// costs ~50us/thread, which at batch rates eats into the fusion win. One
// generation-counted pool; workers pull indices from an atomic counter
// (images are uniform work, so this is near-perfect load balance).
class Pool {
 public:
  static Pool& get(int nthreads) {
    static Pool* pool = nullptr;
    static pid_t owner = 0;
    static std::mutex create_m;
    std::lock_guard<std::mutex> lk(create_m);
    // threads do not survive fork (torch-style worker processes): detect
    // and rebuild in the child. Grow if a later caller asks for more
    // threads than the pool was built with. In both cases the old object
    // is leaked deliberately: after fork its threads don't exist and its
    // mutexes may be poisoned; on grow its idle threads still park on its
    // condition_variable, so its storage must outlive them.
    if (pool == nullptr || owner != getpid() ||
        nthreads > static_cast<int>(pool->workers_.size()) + 1) {
      pool = new Pool(nthreads);
      owner = getpid();
    }
    return *pool;
  }

  void run(int64_t n, int nthreads, void (*fn)(int64_t, void*), void* ctx) {
    if (nthreads <= 1 || n <= 1 || workers_.empty()) {
      for (int64_t i = 0; i < n; ++i) fn(i, ctx);
      return;
    }
    // one job at a time: concurrent Python callers (e.g. a prefetch
    // thread racing the main thread) queue here instead of corrupting
    // the shared job slot
    std::lock_guard<std::mutex> job_lk(job_m_);
    {
      std::lock_guard<std::mutex> lk(m_);
      fn_ = fn;
      ctx_ = ctx;
      n_ = n;
      next_.store(0);
      // every worker wakes on the generation bump and decrements pending_
      // (those that find no indices left just pass through)
      pending_ = static_cast<int>(workers_.size());
      ++gen_;
    }
    cv_.notify_all();
    drain();  // the caller participates too (one fewer idle core)
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [&] { return pending_ == 0; });
  }

 private:
  explicit Pool(int nthreads) {
    int t = std::max(1, nthreads) - 1;  // caller thread is worker #0
    for (int k = 0; k < t; ++k)
      workers_.emplace_back([this] { loop(); });
  }

  void drain() {
    for (;;) {
      int64_t i = next_.fetch_add(1);
      if (i >= n_) return;
      fn_(i, ctx_);
    }
  }

  void loop() {
    uint64_t seen = 0;
    for (;;) {
      std::unique_lock<std::mutex> lk(m_);
      cv_.wait(lk, [&] { return gen_ != seen; });
      seen = gen_;
      lk.unlock();
      drain();
      lk.lock();
      if (--pending_ == 0) done_cv_.notify_all();
    }
  }

  std::vector<std::thread> workers_;
  std::mutex m_, job_m_;
  std::condition_variable cv_, done_cv_;
  uint64_t gen_ = 0;
  int pending_ = 0;
  std::atomic<int64_t> next_{0};
  void (*fn_)(int64_t, void*) = nullptr;
  void* ctx_ = nullptr;
  int64_t n_ = 0;
};

void parallel_for(int64_t n, int nthreads, void (*fn)(int64_t, void*),
                  void* ctx) {
  Pool::get(nthreads).run(n, nthreads, fn, ctx);
}

struct RrcCtx {
  const uint8_t* src;
  int64_t H, W, C;
  const int32_t* params;  // B x 5: top, left, crop_h, crop_w, flip
  float* out;
  int64_t S;
  const float* scale;  // per-channel 1 / (255 * std)
  const float* bias;   // per-channel -mean / std
};

// One image: crop (top, left, ch, cw) -> bilinear resize to S x S ->
// optional horizontal flip -> out = v * scale[c] + bias[c]
// (== ((v / 255) - mean) / std).
void rrc_one(int64_t b, void* vctx) {
  const RrcCtx& c = *static_cast<RrcCtx*>(vctx);
  const int64_t H = c.H, W = c.W, C = c.C, S = c.S;
  const uint8_t* img = c.src + b * H * W * C;
  const int32_t* p = c.params + b * 5;
  const int top = p[0], left = p[1], ch = p[2], cw = p[3], flip = p[4];
  float* out = c.out + b * S * S * C;

  // Precompute x-axis source columns and weights once per image.
  std::vector<int> x0v(S), x1v(S);
  std::vector<float> wxv(S);
  for (int64_t j = 0; j < S; ++j) {
    float x = (static_cast<float>(j) + 0.5f) * cw / S - 0.5f;
    int x0 = clampi(static_cast<int>(std::floor(x)), 0, cw - 1);
    int x1 = std::min(x0 + 1, cw - 1);
    float wx = x - static_cast<float>(x0);
    wx = wx < 0.f ? 0.f : (wx > 1.f ? 1.f : wx);
    x0v[j] = left + x0;
    x1v[j] = left + x1;
    wxv[j] = wx;
  }
  for (int64_t i = 0; i < S; ++i) {
    float y = (static_cast<float>(i) + 0.5f) * ch / S - 0.5f;
    int y0 = clampi(static_cast<int>(std::floor(y)), 0, ch - 1);
    int y1 = std::min(y0 + 1, ch - 1);
    float wy = y - static_cast<float>(y0);
    wy = wy < 0.f ? 0.f : (wy > 1.f ? 1.f : wy);
    const uint8_t* r0 = img + static_cast<int64_t>(top + y0) * W * C;
    const uint8_t* r1 = img + static_cast<int64_t>(top + y1) * W * C;
    float* orow = out + i * S * C;
    for (int64_t j = 0; j < S; ++j) {
      const int64_t oj = flip ? (S - 1 - j) : j;
      const float wx = wxv[j];
      const uint8_t* p00 = r0 + static_cast<int64_t>(x0v[j]) * C;
      const uint8_t* p01 = r0 + static_cast<int64_t>(x1v[j]) * C;
      const uint8_t* p10 = r1 + static_cast<int64_t>(x0v[j]) * C;
      const uint8_t* p11 = r1 + static_cast<int64_t>(x1v[j]) * C;
      for (int64_t k = 0; k < C; ++k) {
        float topv = p00[k] * (1.f - wx) + p01[k] * wx;
        float botv = p10[k] * (1.f - wx) + p11[k] * wx;
        float v = topv * (1.f - wy) + botv * wy;
        orow[oj * C + k] = v * c.scale[k] + c.bias[k];
      }
    }
  }
}

struct PadCropCtx {
  const float* src;  // B x H x W x C, already float (CIFAR normalizes first)
  int64_t H, W, C;
  const int32_t* params;  // B x 3: y, x, flip  (offsets into padded image)
  float* out;             // B x H x W x C
  int pad;
  int reflect;  // 1 = reflect padding, 0 = constant fill
  float fill;
};

// One image: virtual pad by `pad` (reflect or constant), crop H x W at
// (y, x), optional hflip. Matches transforms.py random_crop + random_hflip
// applied to an already-normalized float image.
void pad_crop_one(int64_t b, void* vctx) {
  const PadCropCtx& c = *static_cast<PadCropCtx*>(vctx);
  const int64_t H = c.H, W = c.W, C = c.C;
  const int pad = c.pad;
  const float* img = c.src + b * H * W * C;
  const int32_t* p = c.params + b * 3;
  const int oy = p[0], ox = p[1], flip = p[2];
  float* out = c.out + b * H * W * C;
  for (int64_t i = 0; i < H; ++i) {
    int sy = static_cast<int>(i) + oy - pad;  // source row in unpadded image
    bool yin = sy >= 0 && sy < H;
    if (!yin && c.reflect)
      sy = sy < 0 ? -sy : static_cast<int>(2 * H - 2) - sy;
    float* orow = out + i * W * C;
    for (int64_t j = 0; j < W; ++j) {
      int sx = static_cast<int>(j) + ox - pad;
      bool xin = sx >= 0 && sx < W;
      if (!xin && c.reflect)
        sx = sx < 0 ? -sx : static_cast<int>(2 * W - 2) - sx;
      const int64_t oj = flip ? (W - 1 - j) : j;
      if (c.reflect || (yin && xin)) {
        const float* s = img + (static_cast<int64_t>(sy) * W +
                                static_cast<int64_t>(sx)) * C;
        for (int64_t k = 0; k < C; ++k) orow[oj * C + k] = s[k];
      } else {
        for (int64_t k = 0; k < C; ++k) orow[oj * C + k] = c.fill;
      }
    }
  }
}

struct GatherCtx {
  const uint8_t* src;
  const int64_t* idx;
  uint8_t* out;
  int64_t row_bytes;
};

void gather_one(int64_t i, void* vctx) {
  const GatherCtx& c = *static_cast<GatherCtx*>(vctx);
  std::memcpy(c.out + i * c.row_bytes, c.src + c.idx[i] * c.row_bytes,
              static_cast<size_t>(c.row_bytes));
}

}  // namespace

extern "C" {

// Fused RandomResizedCrop(+flip)+normalize over a uint8 NHWC batch.
// params: int32 B x 5 (top, left, crop_h, crop_w, flip).
// scale/bias: per-channel affine applied to raw uint8 values
// (scale = 1/(255*std), bias = -mean/std reproduces torchvision
// ToTensor+Normalize; scale = 1/255, bias = 0 gives plain [0,1] floats).
void fedio_rrc_batch(const uint8_t* src, int64_t B, int64_t H, int64_t W,
                     int64_t C, const int32_t* params, float* out, int64_t S,
                     const float* scale, const float* bias, int nthreads) {
  RrcCtx ctx{src, H, W, C, params, out, S, scale, bias};
  parallel_for(B, nthreads, rrc_one, &ctx);
}

// Fused pad+crop(+flip) over an already-float NHWC batch (CIFAR/EMNIST
// style: normalize happens before the geometric aug there).
// params: int32 B x 3 (y, x, flip), y/x in [0, 2*pad].
void fedio_pad_crop_batch(const float* src, int64_t B, int64_t H, int64_t W,
                          int64_t C, const int32_t* params, float* out,
                          int pad, int reflect, float fill, int nthreads) {
  PadCropCtx ctx{src, H, W, C, params, out, pad, reflect, fill};
  parallel_for(B, nthreads, pad_crop_one, &ctx);
}

// Threaded row gather: out[i] = src[idx[i]] for fixed-size rows. Used to
// assemble padded round batches from per-client mmap'd arrays without
// holding the GIL.
void fedio_gather_rows(const uint8_t* src, const int64_t* idx, int64_t n,
                       int64_t row_bytes, uint8_t* out, int nthreads) {
  GatherCtx ctx{src, idx, out, row_bytes};
  parallel_for(n, nthreads, gather_one, &ctx);
}

int fedio_abi_version() { return 1; }

}  // extern "C"

// Causal flash attention for Hopper (sm_90a): the forward and the two
// backward kernels of the FlashAttention-2 scheme, with dropout on the
// attention probabilities.
//
// Replaces commefficient_tpu/ops/flash_attention.py::_fwd_kernel,
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel. Inputs are (BH, T, D) row-major,
// float32 or bfloat16, D a multiple of 8 up to 128; all arithmetic is
// float32 on the CUDA cores (D is a runtime width, templated by the number
// of 32-lane column groups DL = ceil(D / 32)).
//
// * fwd: one 256-thread CTA per (bh, 64-row query tile). K/V tiles of 64
//   keys go through shared memory up to the diagonal; each warp owns 8
//   query rows and keeps their running max, denominator and accumulator
//   in registers. Keys above the diagonal or >= T score -1e30; the
//   denominator sums the UNDROPPED p, then p is scaled by keep / (1 - rate)
//   before p.V (normalize-then-drop, the reference's softmax -> dropout ->
//   @V order). Writes O in the input dtype and lse = m + log(max(l, 1e-30))
//   in float32 (-1e30 on a fully masked row).
// * dq: one CTA per (bh, query tile) over the key tiles up to the
//   diagonal; P is recomputed from q, k and lse, dP = dO.V^T goes through
//   the same keep mask, dS = P * (dP - delta), dq = scale * dS.K.
// * dkv: one CTA per (bh, key tile) over the query tiles from the diagonal
//   on; dv = (P * keep / (1 - rate))^T.dO and dk = scale * dS^T.Q.
//
// Every output element is summed by one thread in a fixed order and
// written once: no atomics, so all three are deterministic (the reference
// splits the backward into the same two kernels for the same reason).
//
// Dropout bits are a function of the reference's LOGICAL tiling, not of
// this kernel's 64 x 64 tiles: element (bh, i, j) lies in logical tile
// (i / BQ, j / BK) at (i % BQ, j % BK), with (BQ, BK) from the caller's
// _effective_blocks, and its bits are the reference's _hash_bits of that
// position under the tile's seed words, in uint32 wraparound. So the mask
// equals dropout_keep_reference bit for bit whatever tile this kernel uses.
//
// Bound: operations at the path's shape (BH 768, T 256, D 64): the causal
// score and value products are 2 T^2 D BH flops forward (6.4 GFLOP), about
// 1.5x that for dq and 2x for dkv, against a few MB of q, k, v and O. The
// design is a simple one that is right: scalar FMA from shared memory,
// no tensor cores, no TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kBM = 64;               // query rows per tile
constexpr int kBN = 64;               // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRW = kBM / kWarps;     // rows (or keys) per warp
constexpr float kNeg = -1e30f;

struct Drop {
  uint32_t seed0, seed1, threshold;
  float inv;                          // 1 / (1 - rate), rounded to float
  int on;                             // rate > 0
  int bq, bk;                         // the reference's logical tile sizes
};

__device__ __forceinline__ bool keep_bit(const Drop& dr, uint32_t bh, int i,
                                         int j) {
  const uint32_t qb = (uint32_t)(i / dr.bq), r = (uint32_t)(i % dr.bq);
  const uint32_t kb = (uint32_t)(j / dr.bk), c = (uint32_t)(j % dr.bk);
  const uint32_t s0 = dr.seed0 + bh * 0x9E3779B9u + qb * 0x85EBCA77u;
  const uint32_t s1 = dr.seed1 + kb * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
  return drop::counter_hash(r, c, s0, s1) >= dr.threshold;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// a value rounded to the input dtype (the reference casts p and dS to it
// before each product, accumulating in float32)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + 64) of a (t, d) matrix into shared memory with row
// stride ld, as float; rows >= t read as 0
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int t,
                          int d) {
  for (int idx = threadIdx.x; idx < kBM * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int row = row0 + r;
    dst[r * ld + c] = row < t ? to_f(src[(size_t)row * d + c]) : 0.f;
  }
}

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int t, int d, float scale, Drop dr) {
  extern __shared__ float smem[];
  const int ldk = d + 1;                 // odd stride: lanes read rows of K
  float* sQ = smem;                      // kBM x d
  float* sK = sQ + kBM * d;              // kBN x ldk
  float* sV = sK + kBN * ldk;            // kBN x d
  float* sP = sV + kBN * d;              // kBM x kBN
  const int bh = blockIdx.x, q0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)bh * t * d;
  load_tile(sQ, d, q + base, q0, t, d);

  float m[kRW], l[kRW], acc[kRW][DL];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DL; ++jj) acc[rr][jj] = 0.f;
  }
  const int n_kt = blockIdx.y + 1;       // key tiles up to the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();
    load_tile(sK, ldk, k + base, k0, t, d);
    load_tile(sV, d, v + base, k0, t, d);
    __syncthreads();
    float s[kRW][2];
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      const float k0v = sK[lane * ldk + e], k1v = sK[(lane + 32) * ldk + e];
#pragma unroll
      for (int rr = 0; rr < kRW; ++rr) {
        const float qv = sQ[(warp * kRW + rr) * d + e];
        s[rr][0] = fmaf(qv, k0v, s[rr][0]);
        s[rr][1] = fmaf(qv, k1v, s[rr][1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr) {
      const int i = q0 + warp * kRW + rr;
      float mx = kNeg;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int j = k0 + lane + 32 * cc;
        s[rr][cc] = (j <= i && j < t) ? s[rr][cc] * scale : kNeg;
        mx = fmaxf(mx, s[rr][cc]);
      }
      const float m_new = fmaxf(m[rr], warp_max(mx));
      float p[2], psum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        p[cc] = s[rr][cc] <= 0.5f * kNeg
                    ? 0.f
                    : expf(fminf(s[rr][cc] - m_new, 0.f));
        psum += p[cc];
      }
      const float corr = expf(fminf(m[rr] - m_new, 0.f));
      l[rr] = l[rr] * corr + warp_sum(psum);   // the undropped p
      m[rr] = m_new;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float pd = p[cc];
        if (dr.on)
          pd = keep_bit(dr, bh, i, k0 + lane + 32 * cc) ? pd * dr.inv : 0.f;
        sP[(warp * kRW + rr) * kBN + lane + 32 * cc] = rnd<T>(pd);
      }
#pragma unroll
      for (int jj = 0; jj < DL; ++jj) acc[rr][jj] *= corr;
    }
    __syncwarp();
    for (int c = 0; c < kBN; ++c) {
      float vv[DL];
#pragma unroll
      for (int jj = 0; jj < DL; ++jj) {
        const int e = lane + 32 * jj;
        vv[jj] = e < d ? sV[c * d + e] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRW; ++rr) {
        const float p = sP[(warp * kRW + rr) * kBN + c];
#pragma unroll
        for (int jj = 0; jj < DL; ++jj)
          acc[rr][jj] = fmaf(p, vv[jj], acc[rr][jj]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int i = q0 + warp * kRW + rr;
    if (i >= t) continue;
    const float lc = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DL; ++jj) {
      const int e = lane + 32 * jj;
      if (e < d) o[base + (size_t)i * d + e] = from_f<T>(acc[rr][jj] / lc);
    }
    if (lane == 0)
      lse[(size_t)bh * t + i] =
          m[rr] <= 0.5f * kNeg ? kNeg : m[rr] + logf(lc);
  }
}

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int t, int d, float scale, Drop dr) {
  extern __shared__ float smem[];
  const int ldk = d + 1;
  float* sQ = smem;                      // kBM x d
  float* sO = sQ + kBM * d;              // dO, kBM x d
  float* sK = sO + kBM * d;              // kBN x ldk
  float* sV = sK + kBN * ldk;            // kBN x ldk
  float* sS = sV + kBN * ldk;            // dS, kBM x kBN
  const int bh = blockIdx.x, q0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)bh * t * d;
  load_tile(sQ, d, q + base, q0, t, d);
  load_tile(sO, d, dout + base, q0, t, d);

  float lse_r[kRW], dl_r[kRW], acc[kRW][DL];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int i = q0 + warp * kRW + rr;
    lse_r[rr] = i < t ? lse[(size_t)bh * t + i] : 0.f;
    dl_r[rr] = i < t ? delta[(size_t)bh * t + i] : 0.f;
#pragma unroll
    for (int jj = 0; jj < DL; ++jj) acc[rr][jj] = 0.f;
  }
  const int n_kt = blockIdx.y + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();
    load_tile(sK, ldk, k + base, k0, t, d);
    load_tile(sV, ldk, v + base, k0, t, d);
    __syncthreads();
    float s[kRW][2], dp[kRW][2];
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr)
      s[rr][0] = s[rr][1] = dp[rr][0] = dp[rr][1] = 0.f;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      const float k0v = sK[lane * ldk + e], k1v = sK[(lane + 32) * ldk + e];
      const float v0v = sV[lane * ldk + e], v1v = sV[(lane + 32) * ldk + e];
#pragma unroll
      for (int rr = 0; rr < kRW; ++rr) {
        const float qv = sQ[(warp * kRW + rr) * d + e];
        const float gv = sO[(warp * kRW + rr) * d + e];
        s[rr][0] = fmaf(qv, k0v, s[rr][0]);
        s[rr][1] = fmaf(qv, k1v, s[rr][1]);
        dp[rr][0] = fmaf(gv, v0v, dp[rr][0]);
        dp[rr][1] = fmaf(gv, v1v, dp[rr][1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr) {
      const int i = q0 + warp * kRW + rr;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int j = k0 + lane + 32 * cc;
        const float sc = (j <= i && j < t && i < t) ? s[rr][cc] * scale
                                                     : kNeg;
        const float p = sc <= 0.5f * kNeg
                            ? 0.f
                            : expf(fminf(sc - lse_r[rr], 0.f));
        float g = dp[rr][cc];
        if (dr.on) g = keep_bit(dr, bh, i, j) ? g * dr.inv : 0.f;
        sS[(warp * kRW + rr) * kBN + lane + 32 * cc] =
            rnd<T>(p * (g - dl_r[rr]));
      }
    }
    __syncwarp();
    for (int c = 0; c < kBN; ++c) {
      float kk[DL];
#pragma unroll
      for (int jj = 0; jj < DL; ++jj) {
        const int e = lane + 32 * jj;
        kk[jj] = e < d ? sK[c * ldk + e] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRW; ++rr) {
        const float ds = sS[(warp * kRW + rr) * kBN + c];
#pragma unroll
        for (int jj = 0; jj < DL; ++jj)
          acc[rr][jj] = fmaf(ds, kk[jj], acc[rr][jj]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int i = q0 + warp * kRW + rr;
    if (i >= t) continue;
#pragma unroll
    for (int jj = 0; jj < DL; ++jj) {
      const int e = lane + 32 * jj;
      if (e < d) dq[base + (size_t)i * d + e] = from_f<T>(acc[rr][jj] * scale);
    }
  }
}

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int t, int d, float scale,
           Drop dr) {
  extern __shared__ float smem[];
  const int ldq = d + 1;                 // odd stride: lanes read rows of Q
  float* sK = smem;                      // kBN x d
  float* sV = sK + kBN * d;              // kBN x d
  float* sQ = sV + kBN * d;              // kBM x ldq
  float* sO = sQ + kBM * ldq;            // dO, kBM x ldq
  float* sP = sO + kBM * ldq;            // dropped P, kBN x kBM
  float* sS = sP + kBN * kBM;            // dS, kBN x kBM
  float* sL = sS + kBN * kBM;            // lse of the query tile
  float* sD = sL + kBM;                  // delta of the query tile
  const int bh = blockIdx.x, k0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)bh * t * d;
  load_tile(sK, d, k + base, k0, t, d);
  load_tile(sV, d, v + base, k0, t, d);

  float acc_k[kRW][DL], acc_v[kRW][DL];
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr)
#pragma unroll
    for (int jj = 0; jj < DL; ++jj) acc_k[rr][jj] = acc_v[rr][jj] = 0.f;
  const int n_qt = (t + kBM - 1) / kBM;
  for (int qt = blockIdx.y; qt < n_qt; ++qt) {   // from the diagonal on
    const int q0 = qt * kBM;
    __syncthreads();
    load_tile(sQ, ldq, q + base, q0, t, d);
    load_tile(sO, ldq, dout + base, q0, t, d);
    if (threadIdx.x < kBM) {
      const int i = q0 + threadIdx.x;
      sL[threadIdx.x] = i < t ? lse[(size_t)bh * t + i] : 0.f;
      sD[threadIdx.x] = i < t ? delta[(size_t)bh * t + i] : 0.f;
    }
    __syncthreads();
    float s[kRW][2], dp[kRW][2];
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr)
      s[rr][0] = s[rr][1] = dp[rr][0] = dp[rr][1] = 0.f;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      const float q0v = sQ[lane * ldq + e], q1v = sQ[(lane + 32) * ldq + e];
      const float g0v = sO[lane * ldq + e], g1v = sO[(lane + 32) * ldq + e];
#pragma unroll
      for (int rr = 0; rr < kRW; ++rr) {
        const float kv = sK[(warp * kRW + rr) * d + e];
        const float vv = sV[(warp * kRW + rr) * d + e];
        s[rr][0] = fmaf(kv, q0v, s[rr][0]);
        s[rr][1] = fmaf(kv, q1v, s[rr][1]);
        dp[rr][0] = fmaf(vv, g0v, dp[rr][0]);
        dp[rr][1] = fmaf(vv, g1v, dp[rr][1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRW; ++rr) {
      const int j = k0 + warp * kRW + rr;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int ri = lane + 32 * cc, i = q0 + ri;
        const float sc = (j <= i && j < t && i < t) ? s[rr][cc] * scale
                                                     : kNeg;
        const float p = sc <= 0.5f * kNeg
                            ? 0.f
                            : expf(fminf(sc - sL[ri], 0.f));
        float pd = p, g = dp[rr][cc];
        if (dr.on) {
          // one draw serves both terms: dv needs the dropped p, dS the
          // dropped dP
          const bool keep = keep_bit(dr, bh, i, j);
          pd = keep ? p * dr.inv : 0.f;
          g = keep ? g * dr.inv : 0.f;
        }
        sP[(warp * kRW + rr) * kBM + ri] = rnd<T>(pd);
        sS[(warp * kRW + rr) * kBM + ri] = rnd<T>(p * (g - sD[ri]));
      }
    }
    __syncwarp();
    for (int r = 0; r < kBM; ++r) {
      float gv[DL], qv[DL];
#pragma unroll
      for (int jj = 0; jj < DL; ++jj) {
        const int e = lane + 32 * jj;
        gv[jj] = e < d ? sO[r * ldq + e] : 0.f;
        qv[jj] = e < d ? sQ[r * ldq + e] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRW; ++rr) {
        const float pv = sP[(warp * kRW + rr) * kBM + r];
        const float sv = sS[(warp * kRW + rr) * kBM + r];
#pragma unroll
        for (int jj = 0; jj < DL; ++jj) {
          acc_v[rr][jj] = fmaf(pv, gv[jj], acc_v[rr][jj]);
          acc_k[rr][jj] = fmaf(sv, qv[jj], acc_k[rr][jj]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRW; ++rr) {
    const int j = k0 + warp * kRW + rr;
    if (j >= t) continue;
#pragma unroll
    for (int jj = 0; jj < DL; ++jj) {
      const int e = lane + 32 * jj;
      if (e < d) {
        dk[base + (size_t)j * d + e] = from_f<T>(acc_k[rr][jj] * scale);
        dv[base + (size_t)j * d + e] = from_f<T>(acc_v[rr][jj]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *d1, *d2;
  int bh, t, d;
  float scale;
  Drop dr;
  cudaStream_t stream;
};

template <typename T, int DL>
int run(int which, const Args& a) {
  const dim3 grid(a.bh, (a.t + kBM - 1) / kBM);
  const int d = a.d;
  size_t floats;
  cudaError_t err;
  if (which == 0) {
    floats = (size_t)kBM * d + kBN * (d + 1) + kBN * d + kBM * kBN;
    auto kern = fwd_kernel<T, DL>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(floats * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, floats * sizeof(float), a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o,
        (float*)a.lse_out, a.t, d, a.scale, a.dr);
  } else if (which == 1) {
    floats = (size_t)2 * kBM * d + 2 * kBN * (d + 1) + kBM * kBN;
    auto kern = dq_kernel<T, DL>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(floats * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, floats * sizeof(float), a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (T*)a.d1, a.t, d,
        a.scale, a.dr);
  } else {
    floats = (size_t)2 * kBN * d + 2 * kBM * (d + 1) + 2 * kBN * kBM +
             2 * kBM;
    auto kern = dkv_kernel<T, DL>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(floats * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, floats * sizeof(float), a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (T*)a.d1, (T*)a.d2, a.t,
        d, a.scale, a.dr);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_width(int which, const Args& a) {
  switch ((a.d + 31) / 32) {
    case 1: return run<T, 1>(which, a);
    case 2: return run<T, 2>(which, a);
    case 3: return run<T, 3>(which, a);
    case 4: return run<T, 4>(which, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int which, int dtype, const Args& a) {
  if (a.d <= 0 || a.d > 128 || a.d % 8 != 0 || a.t <= 0 || a.bh <= 0 ||
      a.dr.bq <= 0 || a.dr.bk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_width<float>(which, a);
  if (dtype == 1) return dispatch_width<__nv_bfloat16>(which, a);
  return (int)cudaErrorInvalidValue;
}

Args make_args(int bh, int t, int d, float scale, int bq, int bk, int seed0,
               int seed1, unsigned threshold, float inv_keep, int dropout,
               void* stream) {
  Args a = {};
  a.bh = bh;
  a.t = t;
  a.d = d;
  a.scale = scale;
  a.dr.seed0 = (uint32_t)seed0;
  a.dr.seed1 = (uint32_t)seed1;
  a.dr.threshold = threshold;
  a.dr.inv = inv_keep;
  a.dr.on = dropout;
  a.dr.bq = bq;
  a.dr.bk = bk;
  a.stream = (cudaStream_t)stream;
  return a;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Each returns cudaGetLastError() after the
// launch (or the error that refused it).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int t, int d,
                                int dtype, float scale, int bq, int bk,
                                int seed0, int seed1, unsigned threshold,
                                float inv_keep, int dropout, void* stream) {
  Args a = make_args(bh, t, d, scale, bq, bk, seed0, seed1, threshold,
                     inv_keep, dropout, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = lse;
  return dispatch(0, dtype, a);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int bh, int t, int d, int dtype,
                                   float scale, int bq, int bk, int seed0,
                                   int seed1, unsigned threshold,
                                   float inv_keep, int dropout,
                                   void* stream) {
  Args a = make_args(bh, t, d, scale, bq, bk, seed0, seed1, threshold,
                     inv_keep, dropout, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.d1 = dq;
  return dispatch(1, dtype, a);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int bh, int t, int d,
                                    int dtype, float scale, int bq, int bk,
                                    int seed0, int seed1, unsigned threshold,
                                    float inv_keep, int dropout,
                                    void* stream) {
  Args a = make_args(bh, t, d, scale, bq, bk, seed0, seed1, threshold,
                     inv_keep, dropout, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.d1 = dk;
  a.d2 = dv;
  return dispatch(2, dtype, a);
}

// Causal flash attention for Hopper (sm_90a): the forward and the two
// backward kernels of the FlashAttention-2 scheme, with dropout on the
// attention probabilities.
//
// Replaces commefficient_tpu/ops/flash_attention.py::_fwd_kernel,
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel. Inputs are (BH, T, D) row-major,
// float32 or bfloat16, D a multiple of 8 up to 128 (templated by the
// number of 32-wide column groups DL = ceil(D / 32)); softmax and sums in
// float32.
//
// * fwd_kernel (tensor cores): one 128-thread CTA per (bh, 64-row query
//   tile), the tile with the most key tiles launched first. Each of the 4
//   warps owns 16 query rows. Q, and tiles of 64 keys of K and V, arrive
//   in shared memory by 16-byte cp.async copies, staggered in one buffer
//   each: K of tile n + 1 lands during tile n's softmax and P.V, V of
//   tile n + 1 during tile n + 1's S (rows >= T and the columns past D
//   read as 0). That is 52 KB at D 64 in float32, so 3 CTAs share an SM.
//   Each row is padded by one 16-byte chunk so that the fragment reads
//   hit 32 distinct banks. S = Q.K^T and O += P.V go
//   through m16n8k8 TF32 products: "3xTF32" for float32 (mma_tf32x3.cuh:
//   each operand split into a TF32 big part and a remainder, three
//   products, float32's accuracy), one product for bfloat16, whose values
//   TF32 holds exactly. Each k-step's three products go into a fresh
//   fragment added to the sum in float32 (the tensor cores' accumulator
//   rounds toward zero, and a long chain of such roundings into one sum
//   drifts). P's C
//   fragment is the A fragment of P.V without shuffles (V's rows read in
//   the matching order). Keys above the diagonal or >= T score -1e30; the
//   row max and denominator reduce over the quad's 4 lanes; the
//   denominator sums the UNDROPPED p, then p is scaled by keep / (1 -
//   rate) and rounded to the input dtype before P.V (normalize-then-drop,
//   the reference's softmax -> dropout -> @V order). Writes O in the input
//   dtype and lse = m + log(max(l, 1e-30)) in float32 (-1e30 on a fully
//   masked row).
// * dq_kernel (tensor cores): the transpose of dkv_kernel, one 128-thread
//   CTA per (bh, 64-row query tile), the longest rows launched first, each
//   warp owning 16 query rows with their lse and delta in registers. Q and
//   dO stay in shared memory; K and V of each key tile up to the diagonal
//   arrive by cp.async, staggered in one buffer each (V(n + 1) lands during
//   tile n's S, dS and dS.K; K(n + 1) during tile n + 1's dP): 70 KB at D
//   64 in float32, 3 CTAs an SM. dP = dO.V^T and S = Q.K^T through the
//   same 3xTF32 products, one keep draw per element, dS = P * (dP * keep /
//   (1 - rate) - delta) rounded to the input dtype, and dq += dS.K with
//   dS's C fragment as the A fragment (K's rows read in the matching
//   order). Each key tile's dS.K goes into a fresh fragment added to dq in
//   float32; dq is scaled once at the end.
// * dkv_kernel (tensor cores): one 128-thread CTA per (bh, 64-key tile),
//   key tile 0 (the most query tiles) launched first, each warp owning 16
//   keys. It walks the query tiles from the diagonal on with Q, dO, lse
//   and delta double-buffered by cp.async; S^T = K.Q^T and dP^T = V.dO^T
//   go through the same 3xTF32 products, one keep draw serves both, and
//   dv += (P * keep / (1 - rate))^T.dO and dk += dS^T.Q accumulate in
//   register fragments; dk is scaled once at the end.
// * The product loops of all three have no branch: a branch ends the
//   block in which the compiler interleaves independent products, and a
//   warp issues in order, so each product would wait on the one before it.
//   The diagonal tile's masked keys and the head's zero padding (D up to
//   the next multiple of 32) are computed and masked instead of skipped.
// * fwd_v1_kernel, dq_v1_kernel and dkv_v1_kernel: the first port's
//   scalar kernels (256 threads, scalar FMA from shared memory), on no
//   path; kept behind their own entry points to be held against the plain
//   versions and timed beside the tensor-core kernels.
//
// Every output element is summed by one thread in a fixed order and
// written once: no atomics, so all the kernels are deterministic (the
// reference splits the backward into the same two kernels for the same
// reason).
//
// Dropout bits are a function of the reference's LOGICAL tiling, not of
// this kernel's 64 x 64 tiles: element (bh, i, j) lies in logical tile
// (i / BQ, j / BK) at (i % BQ, j % BK), with (BQ, BK) from the caller's
// _effective_blocks, and its bits are the reference's _hash_bits of that
// position under the tile's seed words, in uint32 wraparound. So the mask
// equals dropout_keep_reference bit for bit whatever tile a kernel uses.
//
// Bound at the path's shape (BH 768, T 256, D 64, float32): the causal
// score and value products are 2 T^2 D BH flops forward (6.4 GFLOP), 2x
// that for dk/dv, 1.5x for dq (S, dP and dS.K: 9.7 GFLOP), against 50 MB
// for each of q, k, v, dO and the outputs (dq reads four and writes one:
// 252 MB, 0.076 ms at 3.35 TB/s). On the CUDA cores (67 TFLOP/s) that is
// 0.096 ms forward, 0.14 ms for dq and 0.19 ms for dk/dv;
// in 3xTF32 on the tensor cores (3 products at 495 TFLOP/s) 0.039, 0.059
// and 0.078 ms, so dq and the forward are bound by their bytes. The first
// port's kernels reached 13-19% of the CUDA cores: each FMA waited on
// shared-memory loads (10 loads for 16 FMAs), one float a thread was
// copied at a time with two barriers around each tile, and nothing
// overlapped. The tensor-core kernels read each operand element once per
// warp from shared memory for 8 (fwd, dq) or 16 (dk/dv) multiply-adds of
// a tensor-core product, round to TF32 with integer operations rather
// than cvt (a conversion issues at an eighth of the float32 rate), and
// copy the next tile while the current one computes. mma.sync does not
// reach the 495 TFLOP/s that wgmma does; no TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "counter_hash.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kBM = 64;               // query rows per tile
constexpr int kBN = 64;               // keys per tile
constexpr int kWarps = 8;             // the scalar kernels
constexpr int kThreads = kWarps * 32;
constexpr int kRW = kBM / kWarps;     // rows (or keys) per warp
constexpr float kNeg = -1e30f;

struct Drop {
  uint32_t seed0, seed1, threshold;
  float inv;                          // 1 / (1 - rate), rounded to float
  int on;                             // rate > 0
  int bq, bk;                         // the reference's logical tile sizes
  // the head map of a head-sharded call: local row bh = b * h_loc + h
  // draws the bits of global row b * h_tot + h0 + h (1, 1, 0: bh itself)
  int h_loc, h_tot, h0;
};

// the global (batch, head) row whose dropout bits local row bh draws
__device__ __forceinline__ uint32_t seed_bh(const Drop& dr, int bh) {
  return (uint32_t)((bh / dr.h_loc) * dr.h_tot + dr.h0 + bh % dr.h_loc);
}

__device__ __forceinline__ bool keep_bit(const Drop& dr, int lbh, int i,
                                         int j) {
  const uint32_t bh = seed_bh(dr, lbh);
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
fwd_v1_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
dq_v1_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
dkv_v1_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

// ---- the tensor-core kernels: 3xTF32 for float32, 1xTF32 for bf16 ----

constexpr int kTcWarps = 4;             // 16 rows (or keys) a warp
constexpr int kTcThreads = kTcWarps * 32;
constexpr uint32_t kMixB = 0x9E3779B9u, kMixQB = 0x85EBCA77u,
                   kMixKB = 0xC2B2AE3Du, kMixB2 = 0x27D4EB2Fu;

// the logical dropout tile of positions p0 + o, o in [0, 64): its index
// and the offset in it, stepped from p0's without a branch (tiles are at
// least 16 long, so o crosses at most 4 tile ends)
struct TilePos {
  int blk0, off0;
  __device__ __forceinline__ TilePos(int p0, int b)
      : blk0(p0 / b), off0(p0 - (p0 / b) * b) {}
  __device__ __forceinline__ void at(int o, int b, uint32_t& blk,
                                     uint32_t& off) const {
    int c = off0 + o, k = blk0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const bool over = c >= b;
      c -= over ? b : 0;
      k += over;
    }
    blk = (uint32_t)k;
    off = (uint32_t)c;
  }
};

// a padded tile row of T: one 16-byte chunk more than the padded head dim
template <typename T>
__host__ __device__ constexpr int tc_ld(int dp) {
  return dp + 16 / (int)sizeof(T);
}

template <typename T, int DL>
__global__ void __launch_bounds__(kTcThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int t, int d, float scale, Drop dr) {
  constexpr bool k3 = std::is_same<T, float>::value;
  constexpr int DP = DL * 32, ND = DP / 8;
  constexpr int kLd = tc_ld<T>(DP), kTile = kBM * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);   // 1 tile
  T* sV = sK + kTile;                       // 1 tile
  T* sQ = sV + kTile;                       // 1 tile
  const int bh = blockIdx.x;
  const uint32_t sbh = seed_bh(dr, bh);
  const int qt = gridDim.y - 1 - blockIdx.y;   // the longest rows first
  const int q0 = qt * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, lq = lane & 3;
  const int nd_live = d / 8;
  const size_t base = (size_t)bh * t * d;

  // the groups of copies in flight, in order: {Q, K(0)}, V(0), then K(n)
  // and V(n) for each later tile n, each waited for (wait_group 1) while
  // the next is already in flight
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sQ, q + base, q0, t, d);
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sK, k + base, 0, t, d);
  tc::cp_commit();
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sV, v + base, 0, t, d);
  tc::cp_commit();
  const T* sq = sQ + (warp * 16 + g) * kLd + lq;   // this warp's rows

  int row[2];
  uint32_t rs0[2], rr[2];   // each row's seed word and place in its tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const int qb = row[h] / dr.bq;
    rr[h] = (uint32_t)(row[h] - qb * dr.bq);
    rs0[h] = dr.seed0 + sbh * kMixB + (uint32_t)qb * kMixQB;
  }
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_kt = qt + 1;                   // key tiles up to the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    tc::cp_wait<1>();                        // K(kt) has landed
    __syncthreads();
    // no branch in the product loops: a branch ends the block within
    // which the compiler interleaves independent products, so the
    // diagonal's masked keys and the head's zero padding are computed too
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      tc::FragA<k3> a;
      a.set(to_f(sq[kk * 8]), to_f(sq[8 * kLd + kk * 8]),
            to_f(sq[kk * 8 + 4]), to_f(sq[8 * kLd + kk * 8 + 4]));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const T* kr = sK + (nt * 8 + g) * kLd + kk * 8 + lq;
        tc::FragB<k3> b;
        b.set(to_f(kr[0]), to_f(kr[4]));
        tc::mma_rn(s[nt], a, b);
      }
    }

    __syncthreads();                         // K read by every warp
    if (kt + 1 < n_kt)                       // K(kt + 1), during softmax, P.V
      tc::load_tile_async<T, DP, kBM, kTcThreads>(sK, k + base, k0 + kBN, t,
                                                  d);
    tc::cp_commit();
    // online softmax; a row's 64 keys lie in the quad's 4 lanes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row[h];
      float mx = kNeg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + nt * 8 + 2 * lq + e;
          const float x = (j <= i && j < t) ? s[nt][2 * h + e] * scale : kNeg;
          s[nt][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[nt][2 * h + e];
          const float p =
              x <= 0.5f * kNeg ? 0.f : __expf(fminf(x - m_new, 0.f));
          s[nt][2 * h + e] = p;
          psum += p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float corr = expf(fminf(m[h] - m_new, 0.f));
      l[h] = l[h] * corr + psum;             // the undropped p
      m[h] = m_new;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][2 * h] *= corr;
        acc[nd][2 * h + 1] *= corr;
      }
    }
    if (dr.on) {
      const TilePos cpos(k0, dr.bk);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t kb, c;
          cpos.at(nt * 8 + 2 * lq + e, dr.bk, kb, c);
          const uint32_t s1 = dr.seed1 + kb * kMixKB + sbh * kMixB2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool keep =
                drop::counter_hash(rr[h], c, rs0[h], s1) >= dr.threshold;
            s[nt][2 * h + e] = keep ? s[nt][2 * h + e] * dr.inv : 0.f;
          }
        }
      }
    }

    tc::cp_wait<1>();                        // V(kt) has landed
    __syncthreads();
    // O += P.V: P's C fragment as the A fragment, V's rows 2q and 2q + 1
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      tc::FragA<k3> a;
      a.set(rnd<T>(s[ks][0]), rnd<T>(s[ks][2]), rnd<T>(s[ks][1]),
            rnd<T>(s[ks][3]));
      const T* vr = sV + (ks * 8 + 2 * lq) * kLd + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        tc::FragB<k3> b;
        b.set(to_f(vr[nd * 8]), to_f(vr[kLd + nd * 8]));
        tc::mma_rn(acc[nd], a, b);
      }
    }
    __syncthreads();                         // V read by every warp
    if (kt + 1 < n_kt)                       // V(kt + 1), during the next S
      tc::load_tile_async<T, DP, kBM, kTcThreads>(sV, v + base, k0 + kBN, t,
                                                  d);
    tc::cp_commit();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row[h];
    if (i >= t) continue;
    const float lc = fmaxf(l[h], 1e-30f);
    T* orow = o + base + (size_t)i * d + 2 * lq;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      if (nd >= nd_live) break;
      orow[nd * 8] = from_f<T>(acc[nd][2 * h] / lc);
      orow[nd * 8 + 1] = from_f<T>(acc[nd][2 * h + 1] / lc);
    }
    if (lq == 0)
      lse[(size_t)bh * t + i] = m[h] <= 0.5f * kNeg ? kNeg : m[h] + logf(lc);
  }
}

template <typename T, int DL>
__global__ void __launch_bounds__(kTcThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int t, int d, float scale,
           Drop dr) {
  constexpr bool k3 = std::is_same<T, float>::value;
  constexpr int DP = DL * 32, ND = DP / 8;
  constexpr int kLd = tc_ld<T>(DP), kTile = kBM * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);   // 1 tile
  T* sV = sK + kTile;                       // 1 tile
  T* sQ = sV + kTile;                       // 2 tiles
  T* sO = sQ + 2 * kTile;                   // dO, 2 tiles
  float* sL = reinterpret_cast<float*>(sO + 2 * kTile);   // lse, 2 x kBM
  float* sD = sL + 2 * kBM;                               // delta
  const int bh = blockIdx.x, kt = blockIdx.y, k0 = kt * kBN;
  const uint32_t sbh = seed_bh(dr, bh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, lq = lane & 3;
  const int nd_live = d / 8;
  const size_t base = (size_t)bh * t * d;
  const float* lse_bh = lse + (size_t)bh * t;
  const float* delta_bh = delta + (size_t)bh * t;

  auto load_q = [&](int qt, int buf) {
    const int q0 = qt * kBM;
    tc::load_tile_async<T, DP, kBM, kTcThreads>(sQ + buf * kTile, q + base,
                                                q0, t, d);
    tc::load_tile_async<T, DP, kBM, kTcThreads>(sO + buf * kTile,
                                                dout + base, q0, t, d);
    const int r = threadIdx.x & (kBM - 1), i = q0 + r;
    const bool ok = i < t;
    if (threadIdx.x < kBM)
      tc::cp4(sL + buf * kBM + r, ok ? lse_bh + i : lse_bh, ok);
    else
      tc::cp4(sD + buf * kBM + r, ok ? delta_bh + i : delta_bh, ok);
  };
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sK, k + base, k0, t, d);
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sV, v + base, k0, t, d);
  load_q(kt, 0);
  tc::cp_commit();

  int key[2];
  uint32_t kc[2], ks1[2];   // each key's place in its tile and seed word
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = k0 + warp * 16 + g + 8 * h;
    const int kb = key[h] / dr.bk;
    kc[h] = (uint32_t)(key[h] - kb * dr.bk);
    ks1[h] = dr.seed1 + (uint32_t)kb * kMixKB + sbh * kMixB2;
  }
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.f;
  const T* kr = sK + (warp * 16 + g) * kLd + lq;
  const T* vr = sV + (warp * 16 + g) * kLd + lq;

  const int n_qt = (t + kBM - 1) / kBM;
  for (int qt = kt; qt < n_qt; ++qt) {       // from the diagonal on
    const int buf = (qt - kt) & 1, q0 = qt * kBM;
    if (qt + 1 < n_qt) load_q(qt + 1, buf ^ 1);
    tc::cp_commit();
    tc::cp_wait<1>();                        // tile qt has landed
    __syncthreads();
    const T* cQ = sQ + buf * kTile;
    const T* cO = sO + buf * kTile;
    const float* cL = sL + buf * kBM;
    const float* cD = sD + buf * kBM;
    // no branch in the product loops, as in fwd_kernel
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      tc::FragA<k3> ak, av;
      ak.set(to_f(kr[kk * 8]), to_f(kr[8 * kLd + kk * 8]),
             to_f(kr[kk * 8 + 4]), to_f(kr[8 * kLd + kk * 8 + 4]));
      av.set(to_f(vr[kk * 8]), to_f(vr[8 * kLd + kk * 8]),
             to_f(vr[kk * 8 + 4]), to_f(vr[8 * kLd + kk * 8 + 4]));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const T* qr = cQ + (nt * 8 + g) * kLd + kk * 8 + lq;
        const T* gr = cO + (nt * 8 + g) * kLd + kk * 8 + lq;
        tc::FragB<k3> b;
        b.set(to_f(qr[0]), to_f(qr[4]));
        tc::mma(s[nt], ak, b);               // S^T = K.Q^T
        b.set(to_f(gr[0]), to_f(gr[4]));
        tc::mma(dp[nt], av, b);              // dP^T = V.dO^T
      }
    }

    // P and dS, one keep draw for both
    const TilePos rpos(q0, dr.bq);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ri = nt * 8 + 2 * lq + e, i = q0 + ri;
        const float li = cL[ri], di = cD[ri];
        uint32_t qb, r;
        rpos.at(ri, dr.bq, qb, r);
        const uint32_t s0 = dr.seed0 + sbh * kMixB + qb * kMixQB;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = key[h];
          const float sc =
              (j <= i && i < t && j < t) ? s[nt][2 * h + e] * scale : kNeg;
          const float p =
              sc <= 0.5f * kNeg ? 0.f : __expf(fminf(sc - li, 0.f));
          // without dropout the threshold is 0 and inv 1 (make_args)
          const bool keep =
              drop::counter_hash(r, kc[h], s0, ks1[h]) >= dr.threshold;
          const float pd = keep ? p * dr.inv : 0.f;
          const float gg = keep ? dp[nt][2 * h + e] * dr.inv : 0.f;
          s[nt][2 * h + e] = rnd<T>(pd);
          dp[nt][2 * h + e] = rnd<T>(p * (gg - di));
        }
      }
    }

    // dV += P^T.dO, dK += dS^T.Q: the C fragments as A fragments, the
    // query rows 2q and 2q + 1 of dO and Q
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      tc::FragA<k3> ap, as;
      ap.set(s[ks][0], s[ks][2], s[ks][1], s[ks][3]);
      as.set(dp[ks][0], dp[ks][2], dp[ks][1], dp[ks][3]);
      const T* gr = cO + (ks * 8 + 2 * lq) * kLd + g;
      const T* qr = cQ + (ks * 8 + 2 * lq) * kLd + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        tc::FragB<k3> b;
        b.set(to_f(gr[nd * 8]), to_f(gr[kLd + nd * 8]));
        tc::mma(acc_v[nd], ap, b);
        b.set(to_f(qr[nd * 8]), to_f(qr[kLd + nd * 8]));
        tc::mma(acc_k[nd], as, b);
      }
    }
    __syncthreads();                         // buf is refilled next round
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = key[h];
    if (j >= t) continue;
    T* krow = dk + base + (size_t)j * d + 2 * lq;
    T* vrow = dv + base + (size_t)j * d + 2 * lq;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      if (nd >= nd_live) break;
      krow[nd * 8] = from_f<T>(acc_k[nd][2 * h] * scale);
      krow[nd * 8 + 1] = from_f<T>(acc_k[nd][2 * h + 1] * scale);
      vrow[nd * 8] = from_f<T>(acc_v[nd][2 * h]);
      vrow[nd * 8 + 1] = from_f<T>(acc_v[nd][2 * h + 1]);
    }
  }
}

template <typename T, int DL>
__global__ void __launch_bounds__(kTcThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int t, int d, float scale, Drop dr) {
  constexpr bool k3 = std::is_same<T, float>::value;
  constexpr int DP = DL * 32, ND = DP / 8;
  constexpr int kLd = tc_ld<T>(DP), kTile = kBM * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);   // 1 tile
  T* sV = sK + kTile;                       // 1 tile
  T* sQ = sV + kTile;                       // 1 tile
  T* sO = sQ + kTile;                       // dO, 1 tile
  const int bh = blockIdx.x;
  const uint32_t sbh = seed_bh(dr, bh);
  const int qt = gridDim.y - 1 - blockIdx.y;   // the longest rows first
  const int q0 = qt * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, lq = lane & 3;
  const int nd_live = d / 8;
  const size_t base = (size_t)bh * t * d;

  // the groups of copies in flight, in order: {Q, dO, V(0)}, K(0), then
  // V(n) and K(n) for each later tile n, each waited for (wait_group 1)
  // while the next is already in flight
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sQ, q + base, q0, t, d);
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sO, dout + base, q0, t, d);
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sV, v + base, 0, t, d);
  tc::cp_commit();
  tc::load_tile_async<T, DP, kBM, kTcThreads>(sK, k + base, 0, t, d);
  tc::cp_commit();
  const T* sq = sQ + (warp * 16 + g) * kLd + lq;   // this warp's rows
  const T* so = sO + (warp * 16 + g) * kLd + lq;

  int row[2];
  uint32_t rs0[2], rr[2];   // each row's seed word and place in its tile
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const int qb = row[h] / dr.bq;
    rr[h] = (uint32_t)(row[h] - qb * dr.bq);
    rs0[h] = dr.seed0 + sbh * kMixB + (uint32_t)qb * kMixQB;
    const bool ok = row[h] < t;
    lse_r[h] = ok ? lse[(size_t)bh * t + row[h]] : 0.f;
    dl_r[h] = ok ? delta[(size_t)bh * t + row[h]] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_kt = qt + 1;                   // key tiles up to the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    tc::cp_wait<1>();                        // V(kt) has landed
    __syncthreads();
    // no branch in the product loops, as in fwd_kernel
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {        // dP = dO.V^T
      tc::FragA<k3> a;
      a.set(to_f(so[kk * 8]), to_f(so[8 * kLd + kk * 8]),
            to_f(so[kk * 8 + 4]), to_f(so[8 * kLd + kk * 8 + 4]));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const T* vr = sV + (nt * 8 + g) * kLd + kk * 8 + lq;
        tc::FragB<k3> b;
        b.set(to_f(vr[0]), to_f(vr[4]));
        tc::mma(dp[nt], a, b);
      }
    }
    __syncthreads();                         // V read by every warp
    if (kt + 1 < n_kt)                       // V(kt + 1), during S and dS.K
      tc::load_tile_async<T, DP, kBM, kTcThreads>(sV, v + base, k0 + kBN, t,
                                                  d);
    tc::cp_commit();

    tc::cp_wait<1>();                        // K(kt) has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {        // S = Q.K^T
      tc::FragA<k3> a;
      a.set(to_f(sq[kk * 8]), to_f(sq[8 * kLd + kk * 8]),
            to_f(sq[kk * 8 + 4]), to_f(sq[8 * kLd + kk * 8 + 4]));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const T* kr = sK + (nt * 8 + g) * kLd + kk * 8 + lq;
        tc::FragB<k3> b;
        b.set(to_f(kr[0]), to_f(kr[4]));
        tc::mma(s[nt], a, b);
      }
    }

    // dS = P * (dP * keep / (1 - rate) - delta), into s
    const TilePos cpos(k0, dr.bk);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + nt * 8 + 2 * lq + e;
        uint32_t kb, c;
        cpos.at(nt * 8 + 2 * lq + e, dr.bk, kb, c);
        const uint32_t s1 = dr.seed1 + kb * kMixKB + sbh * kMixB2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = row[h];
          const float sc =
              (j <= i && j < t && i < t) ? s[nt][2 * h + e] * scale : kNeg;
          const float p =
              sc <= 0.5f * kNeg ? 0.f : __expf(fminf(sc - lse_r[h], 0.f));
          // without dropout the threshold is 0 and inv 1 (make_args)
          const bool keep =
              drop::counter_hash(rr[h], c, rs0[h], s1) >= dr.threshold;
          const float gg = keep ? dp[nt][2 * h + e] * dr.inv : 0.f;
          s[nt][2 * h + e] = rnd<T>(p * (gg - dl_r[h]));
        }
      }
    }

    // dq += dS.K: dS's C fragment as the A fragment, K's rows 2q and
    // 2q + 1; the tile's products in a fresh fragment, added in float32
    float part[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      tc::FragA<k3> a;
      a.set(s[ks][0], s[ks][2], s[ks][1], s[ks][3]);
      const T* kr = sK + (ks * 8 + 2 * lq) * kLd + g;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        tc::FragB<k3> b;
        b.set(to_f(kr[nd * 8]), to_f(kr[kLd + nd * 8]));
        tc::mma(part[nd], a, b);
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
    __syncthreads();                         // K read by every warp
    if (kt + 1 < n_kt)                       // K(kt + 1), during the next dP
      tc::load_tile_async<T, DP, kBM, kTcThreads>(sK, k + base, k0 + kBN, t,
                                                  d);
    tc::cp_commit();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row[h];
    if (i >= t) continue;
    T* qrow = dq + base + (size_t)i * d + 2 * lq;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      if (nd >= nd_live) break;
      qrow[nd * 8] = from_f<T>(acc[nd][2 * h] * scale);
      qrow[nd * 8 + 1] = from_f<T>(acc[nd][2 * h + 1] * scale);
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

enum Which { kFwd, kDq, kDkv, kFwdV1, kDqV1, kDkvV1 };

template <typename Kern>
int launch_setup(Kern kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DL>
int run(Which which, const Args& a) {
  const int tiles = (a.t + kBM - 1) / kBM;
  const dim3 grid(a.bh, tiles);
  const int d = a.d;
  // the tensor-core kernels' shared memory: padded tiles of T
  const size_t tile = (size_t)kBM * tc_ld<T>(DL * 32) * sizeof(T);
  size_t bytes;
  int err;
  switch (which) {
    case kFwd: {
      auto kern = fwd_kernel<T, DL>;
      bytes = 3 * tile;                      // Q, K, V
      if ((err = launch_setup(kern, bytes))) return err;
      kern<<<grid, kTcThreads, bytes, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o,
          (float*)a.lse_out, a.t, d, a.scale, a.dr);
      break;
    }
    case kDkv: {
      auto kern = dkv_kernel<T, DL>;
      bytes = 6 * tile + 4 * kBM * sizeof(float);   // K, V; Q, dO x 2
      if ((err = launch_setup(kern, bytes))) return err;
      kern<<<grid, kTcThreads, bytes, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.d1, (T*)a.d2,
          a.t, d, a.scale, a.dr);
      break;
    }
    case kFwdV1: {
      auto kern = fwd_v1_kernel<T, DL>;
      bytes = ((size_t)kBM * d + kBN * (d + 1) + kBN * d + kBM * kBN) *
              sizeof(float);
      if ((err = launch_setup(kern, bytes))) return err;
      kern<<<grid, kThreads, bytes, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o,
          (float*)a.lse_out, a.t, d, a.scale, a.dr);
      break;
    }
    case kDq: {
      auto kern = dq_kernel<T, DL>;
      bytes = 4 * tile;                      // K, V, Q, dO
      if ((err = launch_setup(kern, bytes))) return err;
      kern<<<grid, kTcThreads, bytes, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.d1, a.t, d,
          a.scale, a.dr);
      break;
    }
    case kDqV1: {
      auto kern = dq_v1_kernel<T, DL>;
      bytes = ((size_t)2 * kBM * d + 2 * kBN * (d + 1) + kBM * kBN) *
              sizeof(float);
      if ((err = launch_setup(kern, bytes))) return err;
      kern<<<grid, kThreads, bytes, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.d1, a.t, d,
          a.scale, a.dr);
      break;
    }
    case kDkvV1: {
      auto kern = dkv_v1_kernel<T, DL>;
      bytes = ((size_t)2 * kBN * d + 2 * kBM * (d + 1) + 2 * kBN * kBM +
               2 * kBM) * sizeof(float);
      if ((err = launch_setup(kern, bytes))) return err;
      kern<<<grid, kThreads, bytes, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.d1, (T*)a.d2,
          a.t, d, a.scale, a.dr);
      break;
    }
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_width(Which which, const Args& a) {
  switch ((a.d + 31) / 32) {
    case 1: return run<T, 1>(which, a);
    case 2: return run<T, 2>(which, a);
    case 3: return run<T, 3>(which, a);
    case 4: return run<T, 4>(which, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(Which which, int dtype, const Args& a) {
  if (a.d <= 0 || a.d > 128 || a.d % 8 != 0 || a.t <= 0 || a.bh <= 0 ||
      a.dr.bq <= 0 || a.dr.bk <= 0 || a.dr.h_loc <= 0 ||
      a.dr.h_tot < a.dr.h_loc || a.dr.h0 < 0 ||
      a.dr.h0 + a.dr.h_loc > a.dr.h_tot || a.bh % a.dr.h_loc != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_width<float>(which, a);
  if (dtype == 1) return dispatch_width<__nv_bfloat16>(which, a);
  return (int)cudaErrorInvalidValue;
}

Args make_args(int bh, int t, int d, float scale, int bq, int bk, int seed0,
               int seed1, unsigned threshold, float inv_keep, int dropout,
               const int* heads, void* stream) {
  Args a = {};
  a.bh = bh;
  a.t = t;
  a.d = d;
  a.scale = scale;
  a.dr.seed0 = (uint32_t)seed0;
  a.dr.seed1 = (uint32_t)seed1;
  // without dropout every key is kept and scaled by 1, so a kernel may
  // test the bits without testing `on`
  a.dr.threshold = dropout ? threshold : 0u;
  a.dr.inv = dropout ? inv_keep : 1.f;
  a.dr.on = dropout;
  a.dr.bq = bq;
  a.dr.bk = bk;
  a.dr.h0 = heads[0];
  a.dr.h_loc = heads[1];
  a.dr.h_tot = heads[2];
  a.stream = (cudaStream_t)stream;
  return a;
}

int fwd(Which which, const void* q, const void* k, const void* v, void* o,
        void* lse, int bh, int t, int d, int dtype, float scale, int bq,
        int bk, int seed0, int seed1, unsigned threshold, float inv_keep,
        int dropout, const int* heads, void* stream) {
  Args a = make_args(bh, t, d, scale, bq, bk, seed0, seed1, threshold,
                     inv_keep, dropout, heads, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = lse;
  return dispatch(which, dtype, a);
}

int bwd(Which which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* d1,
        void* d2, int bh, int t, int d, int dtype, float scale, int bq,
        int bk, int seed0, int seed1, unsigned threshold, float inv_keep,
        int dropout, const int* heads, void* stream) {
  Args a = make_args(bh, t, d, scale, bq, bk, seed0, seed1, threshold,
                     inv_keep, dropout, heads, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.d1 = d1;
  a.d2 = d2;
  return dispatch(which, dtype, a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Each returns cudaGetLastError() after the
// launch (or the error that refused it). The tensor-core kernels
// (flash_fwd_launch, flash_bwd_dq_launch, flash_bwd_dkv_launch) need q, k,
// v and dO 16-byte aligned; the _v1 entries run the first port's scalar
// kernels. (head0, heads_local, heads_total) is the head map of a
// head-sharded call (0, 1, 1 for an unsharded one): the rows are
// (batch, local head) pairs, and local head h draws the dropout bits of
// global head head0 + h of heads_total.
#define FLASH_TAIL                                                        \
  int bh, int t, int d, int dtype, float scale, int bq, int bk, int seed0, \
      int seed1, unsigned threshold, float inv_keep, int dropout,          \
      int head0, int heads_local, int heads_total, void* stream
#define FLASH_ARGS                                                        \
  bh, t, d, dtype, scale, bq, bk, seed0, seed1, threshold, inv_keep,      \
      dropout, heads, stream
#define HEADS const int heads[3] = {head0, heads_local, heads_total}

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, FLASH_TAIL) {
  HEADS;
  return fwd(kFwd, q, k, v, o, lse, FLASH_ARGS);
}

extern "C" int flash_fwd_v1_launch(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   FLASH_TAIL) {
  HEADS;
  return fwd(kFwdV1, q, k, v, o, lse, FLASH_ARGS);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, FLASH_TAIL) {
  HEADS;
  return bwd(kDq, q, k, v, dout, lse, delta, dq, nullptr, FLASH_ARGS);
}

extern "C" int flash_bwd_dq_v1_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, FLASH_TAIL) {
  HEADS;
  return bwd(kDqV1, q, k, v, dout, lse, delta, dq, nullptr, FLASH_ARGS);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, FLASH_TAIL) {
  HEADS;
  return bwd(kDkv, q, k, v, dout, lse, delta, dk, dv, FLASH_ARGS);
}

extern "C" int flash_bwd_dkv_v1_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, FLASH_TAIL) {
  HEADS;
  return bwd(kDkvV1, q, k, v, dout, lse, delta, dk, dv, FLASH_ARGS);
}

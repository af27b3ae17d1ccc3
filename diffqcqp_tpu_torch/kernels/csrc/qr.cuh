// Block-cooperative unpivoted Householder-QR solve of a small dense system,
// shared by K5 (the assembled KKT systems, csrc/qr_solve.cu) and K2 / K6
// (the nc x nc Schur system M dgamma = y, csrc/qcqp_bwd.cu).
//
// The augmented matrix [A | b] (m rows, m + 1 columns) sits in shared memory
// column-major with an odd stride ld: column j at sA + j * ld. At every step
// k: alpha = -sign(a_kk) ||A[k:, k]|| (sign(0) = +1), v = A[k:, k] - alpha
// e_k, beta = 2 / ||v||^2, or 0 when ||v||^2 <= 1e-30, A[k:, j] -= beta (v^T
// A[k:, j]) v for every later column j (b included), and the diagonal
// becomes alpha. The entries of column k below the diagonal keep stale
// values where the TPU kernel writes zeros: nothing reads them again. Back
// substitution R x = Q^T b divides by the diagonal, replaced by 1e-30 where
// |d| <= 1e-30.
//
// What bounds it on an H100: not the bytes or the FLOPs (4/3 m^3 per
// problem is ~4 us for 4096 systems of m = 36) but the chain of m dependent
// steps inside each problem, each a pass over column k and over every later
// column, and the shared-memory loads and issue slots those passes take.
//
// qr_solve_lanes (K5 at every m; K2 and K6 above one warp): each reflector
// is computed once, by the G lanes that own column k, inside their update of
// step k - 1, and travels in a slot; every other column takes two passes
// (v^T A_j, the update), split over G lanes per column (rows i = q mod G,
// a butterfly of G - 1 shuffles joins them), one __syncthreads per step; the
// back substitution runs on warp 0 alone with x_k moving by shuffles, no
// barrier. G trades the per-step chain ((m - k) / G loads and FMAs) against
// warps per problem: K5 takes G = 2 from m = 32 to 127 and 1 otherwise, K6
// 4 at n <= 96 and 2 above (timed on an H100). Every lane of a group ends a
// butterfly with the same bits, so no broadcast is needed, and
// kernels/qr_solve_cuda.py::householder_solve(group=G) adds in this order.
// ptxas (sm_90a): K5's instances 30-40 registers, no spill.
//
// qr_solve_warp (K2 and K6 at one warp, nc <= 16): the same arithmetic with
// one lane a column and the columns in registers, so the passes read no
// shared memory and each reflector is published once; no barrier.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "ldl.cuh"

namespace dq {

// Back substitution R x = Q^T b on warp 0 from R (upper triangle) and Q^T b
// (column m) in shared memory: lanes over rows, b_i in registers (m <= 32
// kChunks), x_k moving by __shfl_sync, no barrier. The block's other warps
// wait at the closing __syncthreads. Same operations, in the same order, as
// householder_solve's back substitution.
template <int kChunks>
__device__ void back_substitute_warp(const float* sA, int m, int ld, float* s_x) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float* cb = sA + m * ld;
    float bi[kChunks];
#pragma unroll
    for (int a = 0; a < kChunks; ++a) bi[a] = (lane + 32 * a < m) ? cb[lane + 32 * a] : 0.f;
    for (int kk = m - 1; kk >= 0; --kk) {
      float own = 0.f;
#pragma unroll
      for (int a = 0; a < kChunks; ++a) {
        if ((kk >> 5) == a) own = bi[a];
      }
      const float bk = __shfl_sync(kFullMask, own, kk & 31);
      const float d = sA[kk * ld + kk];
      const float xk = bk / (fabsf(d) > kTiny ? d : kTiny);
      if (lane == 0) s_x[kk] = xk;
#pragma unroll
      for (int a = 0; a < kChunks; ++a) {
        const int i = lane + 32 * a;
        if (i < kk) bi[a] = bi[a] - sA[kk * ld + i] * xk;
      }
    }
  }
  __syncthreads();
}

// The QR of K2 / K6 at one warp, in registers: lane j (j <= m) holds
// column j of [A | b] (m <= MMAX <= 16 rows, read from shared memory,
// column-major stride ld). At step k lane k computes its reflector from its
// registers (the tail ||c[k+1:]||^2 summed serially in row order, then
// alpha, v_k and beta as qr_solve_lanes computes them), keeps alpha as R's
// diagonal and publishes v and beta once (float4 stores into s_pub, 2 x 32
// floats, double-buffered); after one __syncwarp every later column takes
// v^T c_j serially in row order from float4 loads and its update. This is
// qr_solve_lanes's arithmetic with one lane a column, with no shared load
// in the passes and no barrier. R and Q^T b go back to sA for
// back_substitute_warp.
template <int MMAX>
__device__ void qr_solve_warp(float* sA, int m, int ld, float* s_x, float* s_pub) {
  static_assert(MMAX <= 16 && MMAX % 4 == 0, "MMAX: a multiple of 4, at most 16");
  constexpr int kBeta = 31;   // beta's slot in the published buffer
  const int j = threadIdx.x;
  const bool mine = j <= m;
  const float* cs = sA + min(j, m) * ld;
  float c[MMAX];
#pragma unroll
  for (int i = 0; i < MMAX; ++i) c[i] = (mine && i < m) ? cs[i] : 0.f;
#pragma unroll
  for (int K = 0; K < MMAX; ++K) {
    if (K < m) {
      float* pub = s_pub + (K & 1) * 32;
      if (j == K) {
        float tail = 0.f;
#pragma unroll
        for (int i = K + 1; i < MMAX; ++i) tail = tail + c[i] * c[i];   // rows past m hold 0
        const float akk = c[K];
        const float alpha = (akk < 0.f ? 1.f : -1.f) * sqrtf(akk * akk + tail);
        const float vk = akk - alpha;
        const float vsq = vk * vk + tail;
#pragma unroll
        for (int q = K / 4; q < MMAX / 4; ++q) {
          reinterpret_cast<float4*>(pub)[q] =
              make_float4(4 * q == K ? vk : c[4 * q], 4 * q + 1 == K ? vk : c[4 * q + 1],
                          4 * q + 2 == K ? vk : c[4 * q + 2], 4 * q + 3 == K ? vk : c[4 * q + 3]);
        }
        pub[kBeta] = vsq > kTiny ? 2.f / fmaxf(vsq, kTiny) : 0.f;
        c[K] = alpha;
      }
      __syncwarp();
      if (mine && j > K) {
        float v[MMAX];
#pragma unroll
        for (int q = K / 4; q < MMAX / 4; ++q) {
          const float4 v4 = reinterpret_cast<const float4*>(pub)[q];
          v[4 * q] = v4.x;
          v[4 * q + 1] = v4.y;
          v[4 * q + 2] = v4.z;
          v[4 * q + 3] = v4.w;
        }
        float wd = v[K] * c[K];
#pragma unroll
        for (int i = K + 1; i < MMAX; ++i) wd = wd + v[i] * c[i];      // rows past m hold 0
        const float bw = pub[kBeta] * wd;
#pragma unroll
        for (int i = K; i < MMAX; ++i) c[i] = c[i] - bw * v[i];
      }
    }
  }
  if (mine) {
#pragma unroll
    for (int i = 0; i < MMAX; ++i) {
      if (i < m) sA[j * ld + i] = c[i];
    }
  }
  __syncwarp();
  back_substitute_warp<1>(sA, m, ld, s_x);
}

// Sum of p over the G lanes of this thread's group (the lanes of `gmask`)
// by a butterfly, stages G / 2, ..., 1: every lane of the group returns the
// same bits.
template <int G>
__device__ __forceinline__ float group_sum(float p, unsigned gmask) {
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1) p = p + __shfl_xor_sync(gmask, p, s);
  return p;
}

// Step k's reflector from column c (final), its rows spread over a group of
// G lanes, `tail_p` this lane's part of ||c[k+1:]||^2: alpha = -sign(c_k)
// sqrt(c_k^2 + tail), v_k = c_k - alpha, ||v||^2 = v_k^2 + tail; (beta, v_k)
// into `slot` and alpha into R's diagonal c[k], by the group's lane 0.
template <int G>
__device__ __forceinline__ void publish_reflector(float* c, int k, float tail_p, int q,
                                                  unsigned gmask, float* slot) {
  __syncwarp(gmask);                           // c[k] is written by another lane of the group
  const float akk = c[k];
  const float tail = group_sum<G>(tail_p, gmask);
  const float alpha = (akk < 0.f ? 1.f : -1.f) * sqrtf(akk * akk + tail);   // -sign(akk) |col|
  const float vk = akk - alpha;
  const float vsq = vk * vk + tail;
  if (q == 0) {
    slot[0] = vsq > kTiny ? 2.f / fmaxf(vsq, kTiny) : 0.f;
    slot[1] = vk;
    c[k] = alpha;              // nothing reads a_kk again: v_k travels in the slot
  }
}

// The QR of K5 and of K2 / K6 above one warp. A group of G lanes owns column
// j of [A | b] in shared memory, lane q the rows i = q (mod G); block thread
// t is lane t % G of column t / G. Each reflector is computed once: the group
// of column k takes it as soon as that column is final, inside its update of
// step k - 1 (the same pass adds the new entries' squares), and publishes
// beta and v_k in a double-buffered slot of s_ref (4 floats). At step k
// every column j > k takes v^T A_j (each lane adds its rows in order, then
// the group's butterfly) and its update, reading v from column k: one
// __syncthreads per step, and per step a chain of about (m - k) / G
// dependent loads and FMAs per lane instead of four passes of m - k with
// every column computing the reflector itself. kernels/qr_solve_cuda.py::householder_solve(group=G) adds in
// this order. Then back_substitute_warp. The block has at least
// max(G (m + 1), 32) threads and m <= 32 kChunks.
template <int G, int kChunks>
__device__ void qr_solve_lanes(float* sA, int m, int ld, float* s_x, float* s_ref) {
  const int j = threadIdx.x / G, q = threadIdx.x % G;
  const unsigned gmask = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const bool mine = j <= m;
  float* cj = sA + (mine ? j : m) * ld;
  if (j == 0) {
    float tp = 0.f;
    for (int i = q; i < m; i += G) {
      if (i > 0) tp = tp + cj[i] * cj[i];
    }
    publish_reflector<G>(cj, 0, tp, q, gmask, s_ref);
  }
  __syncthreads();
  for (int kk = 0; kk < m; ++kk) {
    if (mine && j > kk) {
      const float* slot = s_ref + 2 * (kk & 1);
      const float beta = slot[0], vk = slot[1];
      const float* ck = sA + kk * ld;
      const int i0 = kk + ((q - kk) & (G - 1));   // this lane's first row >= kk
      const bool has_k = i0 == kk;
      float wd = has_k ? vk * cj[kk] : 0.f;
#pragma unroll 4
      for (int i = has_k ? kk + G : i0; i < m; i += G) wd = wd + ck[i] * cj[i];
      const float bw = beta * group_sum<G>(wd, gmask);
      if (has_k) cj[kk] = cj[kk] - bw * vk;
      float tp = 0.f;                             // the next step's tail, rows > kk + 1
#pragma unroll 4
      for (int i = has_k ? kk + G : i0; i < m; i += G) {
        const float c = cj[i] - bw * ck[i];
        cj[i] = c;
        if (i > kk + 1) tp = tp + c * c;
      }
      if (j == kk + 1 && j < m) publish_reflector<G>(cj, j, tp, q, gmask, s_ref + 2 * (j & 1));
    }
    __syncthreads();
  }
  back_substitute_warp<kChunks>(sA, m, ld, s_x);
}

}  // namespace dq

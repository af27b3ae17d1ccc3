// Block-cooperative dense LDL^T helpers for the fused solver kernels.
//
// Replaces the in-kernel helpers of diffqcqp_tpu/kernels/ldl.py
// (chol_to_unit, ldl_solve, ldl_solve_cm). One thread block holds one small
// problem; thread r owns row r. Matrices sit in shared memory with an ODD
// leading dimension `ld`, so both a column walk (consecutive rows) and a row
// walk (stride ld) touch 32 different banks: the forward and the backward
// sweep are both free of bank conflicts.
//
// The factor is stored column-major: sL[j * ld + r] = L[r][j]. After
// chol_factor it holds the zero-diagonal unit-lower Lh, and each thread keeps
// its own dinv = 1 / L_rr^2 in a register. A solve is then 2n + 1 steps, each
// one broadcast of a finished row value plus one multiply-add per thread
// (see the plain versions in kernels/ldl.py, which repeat this arithmetic).
//
// Broadcasts: with a single warp (n <= 32) a value moves by __shfl_sync and no
// barrier is needed; with more warps it goes through a shared slot and one
// __syncthreads. Every slot is written once per sweep, and consecutive uses of
// a slot are separated by barriers, so no write can overtake a pending read.
#pragma once

#include <cuda_runtime.h>

namespace dq {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kTiny = 1e-30f;   // pivot / norm floor, as in the TPU kernel

struct Blk {
  int r;          // this thread's row
  int n;          // problem size
  int ld;         // odd leading dimension of the shared n x n matrices
  bool one_warp;  // blockDim.x == 32
  bool real;      // r < n (threads past n hold zeros)
};

__device__ __forceinline__ void bsync(const Blk& k) {
  if (k.one_warp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Value of `v` held by thread `src`, returned to every thread of the block.
// `slot` is a shared float used only in the multi-warp case.
__device__ __forceinline__ float bcast(const Blk& k, float v, int src, float* slot) {
  if (k.one_warp) return __shfl_sync(kFullMask, v, src);
  if (k.r == src) *slot = v;
  __syncthreads();
  return *slot;
}

// sL <- zero-diagonal unit-lower LDL^T factor of (P + shift I), P read from
// sP (row-major, stride ld). Left-looking standard Cholesky columns with the
// pivot floored at kTiny, then the in-place conversion Lh[r][j] = L[r][j] /
// L_jj (r > j). Returns this thread's dinv = 1 / L_rr^2.
// `shift` is read only by the thread whose row is the pivot (r == j), so each
// thread may pass its own value: K1 passes one rho + mu for all rows, K2 its
// row's 2 gamma, which factors P + diag(shift_r) with no change here.
// With kMasked (K4) the factor is of fm P fm + diag(shift): `s_fm` holds a
// 0 / 1 mask per row in shared memory and each element of P is masked as it
// is read, so sP keeps the unmasked P for later use.
// Scratch: s_piv[n] (pivot broadcast slots), s_rd[n] (reciprocal diagonal).
template <bool kMasked = false>
__device__ float chol_factor(const Blk& k, const float* sP, float* sL, float shift,
                             float* s_piv, float* s_rd, const float* s_fm = nullptr) {
  const int n = k.n, ld = k.ld, r = k.r;
  for (int j = 0; j < n; ++j) {
    float s = 0.f;
    if (k.real) {
      s = sP[r * ld + j];
      if constexpr (kMasked) s = s * s_fm[r] * s_fm[j];
      if (r == j) s = s + shift;
      for (int c = 0; c < j; ++c) s = s - sL[c * ld + r] * sL[c * ld + j];
    }
    const float d = fmaxf(bcast(k, s, j, &s_piv[j]), kTiny);
    const float col = s * (1.0f / sqrtf(d));
    if (k.real) sL[j * ld + r] = (r >= j) ? col : 0.f;
    bsync(k);
  }
  float rr = 0.f;
  if (k.real) {
    rr = 1.0f / sL[r * ld + r];
    s_rd[r] = rr;
  }
  bsync(k);
  if (k.real) {
    for (int j = 0; j < n; ++j) {
      const float v = sL[j * ld + r];
      sL[j * ld + r] = (r > j) ? v * s_rd[j] : 0.f;
    }
  }
  bsync(k);
  return rr * rr;
}

// x = (L L^T)^{-1} rhs for this thread's row, from the converted factor.
// Rows below `start` of the right-hand side must be zero (the forward sweep
// skips them). Scratch: s_fwd[n], s_bwd[n] (broadcast slots, multi-warp).
__device__ float ldl_solve(const Blk& k, const float* sL, float dinv, float rhs,
                           int start, float* s_fwd, float* s_bwd) {
  const int n = k.n, ld = k.ld, r = k.r;
  float acc = k.real ? rhs : 0.f;
  for (int i = start; i < n; ++i) {
    const float v = bcast(k, acc, i, &s_fwd[i]);
    if (k.real) acc = acc - sL[i * ld + r] * v;      // Lh[r][i]
  }
  acc = acc * dinv;
  for (int i = n - 1; i >= 0; --i) {
    const float v = bcast(k, acc, i, &s_bwd[i]);
    if (k.real) acc = acc - sL[r * ld + i] * v;      // Lh[i][r]
  }
  return acc;
}

}  // namespace dq

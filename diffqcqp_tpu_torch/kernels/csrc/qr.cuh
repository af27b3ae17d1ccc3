// Block-cooperative unpivoted Householder-QR solve of a small dense system,
// shared by K2 / K6 (the nc x nc Schur system M dgamma = y, csrc/qcqp_bwd.cu)
// and K5 (the assembled KKT systems, csrc/qr_solve.cu).
//
// The augmented matrix [A | b] (m rows, m + 1 columns) sits in shared memory
// column-major with an odd stride ld: column j at sA + j * ld. Thread j owns
// column j (j == m is b); threads past m only take part in the barriers.
//
// At step k every thread reads column k (a shared-memory broadcast) and
// computes the reflector itself, in the same order:
//   alpha = -sign(a_kk) ||A[k:, k]||  (sign(0) = +1),
//   v = A[k:, k] - alpha e_k,  beta = 2 / ||v||^2, or 0 when ||v||^2 <= 1e-30,
// so every thread holds bit-identical values and the control flow stays
// uniform with no reduction at all. Each thread j > k then applies the
// reflector to its own column, A[k:, j] -= beta (v^T A[k:, j]) v, and thread
// k sets the diagonal to alpha. The entries of column k below the diagonal
// keep stale values where the TPU kernel writes zeros: nothing reads them
// again. One barrier per step.
//
// Back substitution R x = Q^T b goes column by column: thread k divides by
// the diagonal (replaced by 1e-30 where |d| <= 1e-30), every thread i < k
// updates its own b_i. On return s_x[0..m) holds x, visible to the block.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "ldl.cuh"

namespace dq {

__device__ void qr_solve_cols(const Blk& k, float* sA, int m, int ld, float* s_x) {
  const int r = k.r;
  for (int kk = 0; kk < m; ++kk) {
    const float* ck = sA + kk * ld;
    float nsq = 0.f;
    for (int i = kk; i < m; ++i) nsq = nsq + ck[i] * ck[i];
    const float akk = ck[kk];
    const float alpha = (akk < 0.f ? 1.f : -1.f) * sqrtf(nsq);   // -sign(akk) |col|
    const float vk = akk - alpha;
    float vsq = vk * vk;
    for (int i = kk + 1; i < m; ++i) vsq = vsq + ck[i] * ck[i];
    const float beta = vsq > kTiny ? 2.f / fmaxf(vsq, kTiny) : 0.f;
    if (r > kk && r <= m) {
      float* cj = sA + r * ld;
      float wd = vk * cj[kk];
      for (int i = kk + 1; i < m; ++i) wd = wd + ck[i] * cj[i];
      const float bw = beta * wd;
      cj[kk] = cj[kk] - bw * vk;
      for (int i = kk + 1; i < m; ++i) cj[i] = cj[i] - bw * ck[i];
    }
    bsync(k);
    if (r == kk) sA[kk * ld + kk] = alpha;   // R's diagonal; column kk is read no more this sweep
  }
  bsync(k);

  float bi = (r < m) ? sA[m * ld + r] : 0.f;
  for (int kk = m - 1; kk >= 0; --kk) {
    if (r == kk) {
      const float d = sA[kk * ld + kk];
      s_x[kk] = bi / (fabsf(d) > kTiny ? d : kTiny);
    }
    bsync(k);
    if (r < kk) bi = bi - sA[kk * ld + r] * s_x[kk];
  }
}

}  // namespace dq

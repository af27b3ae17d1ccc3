// Block-cooperative dense LDL^T helpers for the fused solver kernels.
//
// Replaces the in-kernel helpers of diffqcqp_tpu/kernels/ldl.py
// (chol_to_unit, ldl_solve, ldl_solve_cm). One thread block holds one small
// problem. Matrices sit in shared memory with an ODD leading dimension `ld`,
// so both a column walk (consecutive rows) and a row walk (stride ld) touch
// 32 different banks: the forward and the backward sweep are both free of
// bank conflicts. The factor is stored column-major: sL[j * ld + r] =
// L[r][j], and ends as the zero-diagonal unit-lower Lh plus dinv = 1 /
// L_rr^2 per row; a solve is then 2n + 1 steps, each one finished row value
// times a column of Lh subtracted from the rest (see the plain versions in
// kernels/ldl.py, which repeat this arithmetic).
//
// Two forms.
//
// Thread per row (chol_factor, ldl_solve: K1, K4, and K2 / K6 at one warp,
// n <= 32): thread r owns row r, left-looking factor columns, one solve per
// right-hand side. With a single warp a value moves by __shfl_sync and no
// barrier is needed; with more warps it goes through a shared slot and one
// __syncthreads per step, so a solve costs 2n + 1 barriers.
//
// Block-wide (chol_factor_tiles, ldl_solve_tiles: K2 and K6 above one warp,
// 256 threads). There the thread-per-row form paid ~7,400 block-wide
// barriers per problem at n = 96 (49 solves of up to 2n + 1 steps, each a
// barrier, one dependent shared load and one FMA per thread) and a serial
// chain of n^2 / 2 shared loads per thread in the factor. The factor here is
// right-looking and in place, its trailing update spread over a 16 x 16
// grid of register tiles: one barrier per column and ~n^3 / 6 / 256 FMAs per
// thread per problem. The solves are one pair of sweeps for all nc + 1
// right-hand sides together, 2n + 1 barriers in all, each thread holding a
// tile of rows x 8 right-hand sides in registers so that one shared load of
// Lh feeds 8 FMAs. Both give each entry the thread-per-row form's operations
// in its order (fmaf(-L[r][c], L[k][c], a) for c = 0, 1, ...; the sweeps'
// subtractions by i), so the block-wide factor and solves agree with
// kernels/ldl.py as the thread-per-row ones do; the sweeps also take the
// steps ldl_solve's `start` skips, which subtract exact zeros. ptxas: see
// csrc/qcqp_bwd.cu.
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

// ---------------------------------------------------------------------------
// Block-wide forms for K2 and K6 above one warp (n > 32). There a broadcast
// is a __syncthreads, and the thread-per-row helpers above spend one per
// step of every solve; these spread the work of a step over the whole block
// and pay one barrier per step for all right-hand sides together.
// ---------------------------------------------------------------------------

constexpr int kFactorGrid = 16;   // chol_factor_tiles: a 16 x 16 grid of threads

// In-place right-looking LDL^T factor with register tiles; the block has
// kFactorGrid^2 = 256 threads and n <= 16 NF. On entry (after a barrier) sA
// (n x ld, column-major, sA[j * ld + r] = A[r][j]) holds P + diag(shift) in
// its lower triangle; on return (after a barrier) it holds the zero-diagonal
// unit-lower Lh, zeros on and above the diagonal, and s_rd[r] = 1 / L_rr, so
// dinv_r = s_rd[r]^2. Scratch: s_col (2 n floats), s_rs (2 floats).
//
// Thread (rg, cg) = (t % 16, t / 16) holds the entries (rg + 16 a, cg + 16 b)
// in registers. At step j every thread reads the published column j (its
// rows and its columns) and the published rs_j = 1 / sqrt(max(a_jj, 1e-30)),
// forms L[r][j] = a_rj rs_j, and takes a_rk -= L[r][j] L[k][j] on all its
// entries, with no test: an entry above the diagonal or in a finished column
// is dead, so what it receives does not matter (a test that skipped the
// finished columns measured slower on an H100). The owners of column j
// store L[., j]; the owners of column j + 1 publish it (double-buffered) and
// the holder of a_{j+1,j+1} publishes rs_{j+1}. One barrier per column.
// Entry (r, k) meets the same subtractions as chol_factor's left-looking
// loop, in the same order c = 0, 1, ..., k - 1 (fmaf(-L[r][c], L[k][c], a)),
// and the same scaling, so the two give the same bits.
template <int NF>
__device__ void chol_factor_tiles(float* sA, int n, int ld, float* s_rd, float* s_col,
                                  float* s_rs) {
  constexpr int G = kFactorGrid;
  const int rg = threadIdx.x % G, cg = threadIdx.x / G;
  float x[NF][NF];
  int rr[NF], kk[NF];          // this thread's rows and columns, clamped to n - 1
#pragma unroll
  for (int a = 0; a < NF; ++a) {
    rr[a] = min(rg + G * a, n - 1);
    kk[a] = min(cg + G * a, n - 1);
  }
#pragma unroll
  for (int a = 0; a < NF; ++a) {
#pragma unroll
    for (int b = 0; b < NF; ++b) x[a][b] = sA[kk[b] * ld + rr[a]];
  }
  // publish column 0 and rs_0
  if (cg == 0) {
#pragma unroll
    for (int a = 0; a < NF; ++a) {
      if (rg + G * a < n) s_col[rg + G * a] = x[a][0];
    }
    if (rg == 0) s_rs[0] = 1.0f / sqrtf(fmaxf(x[0][0], kTiny));
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const float* col = s_col + (j & 1) * n;
    const float rs = s_rs[j & 1];
    float lr[NF], lk[NF];
#pragma unroll
    for (int a = 0; a < NF; ++a) {
      lr[a] = col[rr[a]] * rs;
      lk[a] = col[kk[a]] * rs;
    }
    if (cg == j % G) {         // column j's owners store L[., j]
#pragma unroll
      for (int a = 0; a < NF; ++a) {
        if (rg + G * a < n) sA[j * ld + rg + G * a] = lr[a];
      }
    }
#pragma unroll
    for (int a = 0; a < NF; ++a) {
#pragma unroll
      for (int b = 0; b < NF; ++b) x[a][b] = fmaf(-lr[a], lk[b], x[a][b]);
    }
    const int j1 = j + 1;
    if (j1 < n && cg == j1 % G) {   // column j + 1 is final: publish it
      float* next = s_col + (j1 & 1) * n;
      const int b1 = j1 / G;
#pragma unroll
      for (int b = 0; b < NF; ++b) {
        if (b == b1) {
#pragma unroll
          for (int a = 0; a < NF; ++a) {
            if (rg + G * a < n) next[rg + G * a] = x[a][b];
          }
          if (rg == j1 % G) {
#pragma unroll
            for (int a = 0; a < NF; ++a) {
              if (a == b1) s_rs[j1 & 1] = 1.0f / sqrtf(fmaxf(x[a][b], kTiny));
            }
          }
        }
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x) s_rd[r] = 1.0f / sA[r * ld + r];
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int j = idx / n, r = idx - j * n;
    const float v = sA[j * ld + r];
    sA[j * ld + r] = (r > j) ? v * s_rd[j] : 0.f;
  }
  __syncthreads();
}

// X <- (L L^T)^{-1} X for ncol right-hand sides at once, from the converted
// factor (chol_factor_tiles). X is n x ncol in shared memory, column-major
// with stride ldx (sX[c * ldx + r]).
//
// Threads hold register tiles: thread t takes the columns cg * kTileCols ..
// + kTileCols - 1 and the rows rg, rg + RG, ..., rg + (NR - 1) RG (rg = t %
// RG, cg = t / RG, RG = blockDim.x / ceil(ncol / kTileCols); the caller
// chooses NR >= ceil(n / RG)). The tile stays in registers for both sweeps;
// at step i the holders of row i publish it to sX, one barrier, and every
// thread updates its rows from one shared load of Lh per row and one of the
// published row per column: kTileCols FMAs per Lh load, with no test, since
// Lh's zeros on and above the diagonal make the other rows' updates exact
// no-ops (skipping them behind a test measured slower on an H100). 2n + 1
// barriers in all. Each entry takes ldl_solve's operations in
// ldl_solve's order (forward i = 0 .. n - 1, times dinv, backward i = n - 1
// .. 0); ldl_solve's `start` skips steps that would subtract a zero, which
// changes nothing but the sign of a zero. On return (after a barrier) sX
// holds the solutions.
constexpr int kTileCols = 8;

__host__ __device__ constexpr int tile_row_groups(int ncol, int threads) {
  return threads / ((ncol + kTileCols - 1) / kTileCols);
}

template <int NR>
__device__ void ldl_solve_tiles(const float* sL, int n, int ld, const float* s_rd, float* sX,
                                int ldx, int ncol) {
  const int RG = tile_row_groups(ncol, blockDim.x);
  const int t = threadIdx.x, rg = t % RG, cg = t / RG;
  int cc_[kTileCols], rr[NR];   // columns and rows, clamped into range for loads
  bool ok[kTileCols];           // a column of X that this thread publishes
#pragma unroll
  for (int cc = 0; cc < kTileCols; ++cc) {
    const int c = cg * kTileCols + cc;
    ok[cc] = c < ncol;
    cc_[cc] = min(c, ncol - 1);
  }
#pragma unroll
  for (int a = 0; a < NR; ++a) rr[a] = min(rg + RG * a, n - 1);
  float x[NR][kTileCols];
#pragma unroll
  for (int a = 0; a < NR; ++a) {
#pragma unroll
    for (int cc = 0; cc < kTileCols; ++cc) x[a][cc] = sX[cc_[cc] * ldx + rr[a]];
  }

  // the holder of row i: rg == i % RG, a == i / RG
  int irg = 0, ia = 0;
  for (int i = 0; i < n; ++i) {
    if (rg == irg) {
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        if (a == ia) {
#pragma unroll
          for (int cc = 0; cc < kTileCols; ++cc) {
            if (ok[cc]) sX[cc_[cc] * ldx + i] = x[a][cc];
          }
        }
      }
    }
    __syncthreads();
    float v[kTileCols];
#pragma unroll
    for (int cc = 0; cc < kTileCols; ++cc) v[cc] = sX[cc_[cc] * ldx + i];
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const float lh = sL[i * ld + rr[a]];          // Lh[r][i], 0 for r <= i
#pragma unroll
      for (int cc = 0; cc < kTileCols; ++cc) x[a][cc] = fmaf(-lh, v[cc], x[a][cc]);
    }
    if (++irg == RG) {
      irg = 0;
      ++ia;
    }
  }
  __syncthreads();   // the last forward row is read before the backward sweep rewrites it

#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const float d = s_rd[rr[a]];
    const float dinv = d * d;
#pragma unroll
    for (int cc = 0; cc < kTileCols; ++cc) x[a][cc] = x[a][cc] * dinv;
  }

  irg = (n - 1) % RG;
  ia = (n - 1) / RG;
  for (int i = n - 1; i >= 0; --i) {
    if (rg == irg) {
#pragma unroll
      for (int a = 0; a < NR; ++a) {
        if (a == ia) {
#pragma unroll
          for (int cc = 0; cc < kTileCols; ++cc) {
            if (ok[cc]) sX[cc_[cc] * ldx + i] = x[a][cc];
          }
        }
      }
    }
    __syncthreads();
    float v[kTileCols];
#pragma unroll
    for (int cc = 0; cc < kTileCols; ++cc) v[cc] = sX[cc_[cc] * ldx + i];
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const float lh = sL[rr[a] * ld + i];          // Lh[i][r], 0 for r >= i
#pragma unroll
      for (int cc = 0; cc < kTileCols; ++cc) x[a][cc] = fmaf(-lh, v[cc], x[a][cc]);
    }
    if (--irg < 0) {
      irg = RG - 1;
      --ia;
    }
  }
  __syncthreads();
}

}  // namespace dq

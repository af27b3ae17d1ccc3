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
// Two forms. Both replace a first design of thread per row (thread r owning
// row r, a left-looking factor and one solve per right-hand side, a value
// moving through a shared slot and a __syncthreads per step; plain versions
// in kernels/ldl.py); K4 above one warp, the last of its users, has left
// it too.
//
// Registers at one warp (chol_factor_warp, ldl_solve_warp: K2 and K6 at n
// <= 32, K4's free block at nf <= 32). The thread-per-row form spent two
// shared loads on every FMA of the factor (a serial left-looking chain per
// column) and one shuffle-then-FMA step per right-hand side and row (K2:
// ~505 dependent steps for its 13 solves at n = 24). Here lane r holds row
// r in registers: the factor is right-looking, the pivot column published
// once a step and read four entries a load; the sweeps take all right-hand
// sides in one pair of 2n + 1 steps, each lane applying NC independent FMAs
// a step from one load of Lh. No barrier: __syncwarp only.
//
// Block-wide (chol_factor_tiles and ldl_solve_tiles: K2 and K6 above one
// warp; chol_factor_tiles and the one-warp ldl_solve_warp_rows: K4's free
// block at nf > 32; 256 threads). There the thread-per-row form paid ~7,400
// block-wide barriers per problem at K2's n = 96 (49 solves of up to 2n + 1
// steps, each a barrier, one dependent shared load and one FMA per thread)
// and a serial chain of n^2 / 2 shared loads per thread in the factor. The
// factor here is right-looking and in place, its trailing update spread
// over a 16 x 16 grid of register tiles: one barrier per column and ~n^3 /
// 6 / 256 FMAs per thread per problem. The solves are one pair of sweeps
// for all nc + 1 right-hand sides together, 2n + 1 barriers in all, each
// thread holding a tile of rows x 8 right-hand sides in registers so that
// one shared load of Lh feeds 8 FMAs; a single right-hand side (K4) takes
// one warp, a shuffle a step, and no barrier.
//
// Both give each entry the same operations in the same order
// (fmaf(-L[r][c], L[k][c], a) for c = 0, 1, ...; the sweeps' subtractions
// by i) as kernels/ldl.py's left-looking factor and sweeps; the sweeps
// also take the steps that kernels/ldl.py's ldl_solve skips by its `start`,
// which subtract exact zeros. ptxas: see csrc/qcqp_bwd.cu and
// csrc/coord_bwd.cu.
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

// ---------------------------------------------------------------------------
// Register forms for one warp (K2 and K6 at n <= 32, K4's free block at nf
// <= 32). Lane r holds row r in registers, so the factor reads no shared memory
// per FMA and every broadcast is one 16-byte load that all lanes share.
// ---------------------------------------------------------------------------

// Published values of one step, double-buffered: 2 x 32 floats, 16-byte
// aligned (the caller's carve places it first in dynamic shared memory).
constexpr int kPubStride = 32;

// In-place right-looking LDL^T factor on one warp. On entry lane r < n holds
// row r of A = P + diag(shift) in a[0 .. n - 1] (only a[0 .. r] are read:
// the lower triangle by rows, as kernels/ldl.py's chol_factor reads it) and
// zeros past n; lanes r >= n hold zeros. At step j the pivot a_jj moves by
// one shuffle,
// every lane forms L[r][j] = a_rj rs_j (rs_j = 1 / sqrt(max(a_jj, 1e-30)))
// and publishes it, and after one __syncwarp takes a_rk -= L[r][j] L[k][j]
// for every k > j from the published column, four entries a load. Entry
// (r, k) meets that chol_factor's subtractions in its order (fmaf(-L[r][c],
// L[k][c], a) for c = 0, 1, ...) and its scaling, so the two give the same
// bits. Writes the zero-diagonal unit-lower Lh (Lh[r][j] = L[r][j] / L_jj
// below the diagonal, zeros on and above it) column-major into sL (sL[j * ld
// + r], rows r < n) and returns this lane's dinv = 1 / L_rr^2. The loops are
// unrolled to NMAX (>= n, a multiple of 4, <= 32) so that a[] stays in
// registers; the steps j >= n are skipped by a warp-uniform test.
template <int NMAX>
__device__ float chol_factor_warp(float (&a)[NMAX], int n, int r, float* sL, int ld,
                                  float* s_pub) {
  static_assert(NMAX % 4 == 0 && NMAX <= kPubStride, "NMAX: a multiple of 4, at most 32");
  float lrr = 1.f;
#pragma unroll
  for (int J = 0; J < NMAX; ++J) {
    if (J < n) {
      const float piv = __shfl_sync(kFullMask, a[J], J);
      const float rs = 1.0f / sqrtf(fmaxf(piv, kTiny));
      const float lr = r >= J ? a[J] * rs : 0.f;       // L[r][J]
      if (r == J) lrr = lr;
      float* col = s_pub + (J & 1) * kPubStride;
      col[r] = lr;
      if (r < n) sL[J * ld + r] = r > J ? lr * (1.0f / (piv * rs)) : 0.f;
      __syncwarp();
#pragma unroll
      for (int K = (J + 1) & ~3; K < NMAX; K += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(col + K);
        if (K > J) a[K] = fmaf(-lr, c4.x, a[K]);
        if (K + 1 > J) a[K + 1] = fmaf(-lr, c4.y, a[K + 1]);
        if (K + 2 > J) a[K + 2] = fmaf(-lr, c4.z, a[K + 2]);
        if (K + 3 > J) a[K + 3] = fmaf(-lr, c4.w, a[K + 3]);
      }
    }
  }
  const float rr = 1.0f / lrr;
  return rr * rr;
}

// One step of ldl_solve_warp: lane `src` publishes its row of the NC
// right-hand sides (float4 stores), one __syncwarp, and every lane takes
// x[c] -= lh v[c] for all c from NC / 4 loads of the published row.
template <int NC>
__device__ __forceinline__ void sweep_step(float* pub, int r, int src, float lh,
                                           float (&x)[NC]) {
  constexpr int NC4 = (NC + 3) / 4;
  if (r == src) {
#pragma unroll
    for (int q = 0; q < NC4; ++q) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = 4 * q + e < NC ? x[4 * q + e] : 0.f;
      reinterpret_cast<float4*>(pub)[q] = make_float4(p[0], p[1], p[2], p[3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < NC4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(pub)[q];
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * q + e < NC) x[4 * q + e] = fmaf(-lh, vv[e], x[4 * q + e]);
    }
  }
}

// x <- (L L^T)^{-1} x for NC right-hand sides at once on one warp, from
// chol_factor_warp's factor: lane r holds row r of all of them in x[]. One
// pair of sweeps, 2n + 1 steps (sweep_step: at step i lane i publishes its
// finished row, and every lane updates all NC entries from one load of
// Lh[r][i], forward, or Lh[i][r], backward). Each entry takes ldl_solve's
// operations in ldl_solve's order; kernels/ldl.py's `start` skips steps that
// subtract exact zeros, which changes nothing but the sign of a zero.
template <int NC>
__device__ void ldl_solve_warp(const float* sL, int n, int ld, int r, float dinv, float (&x)[NC],
                               float* s_pub) {
  static_assert(NC <= kPubStride, "NC: at most 32 right-hand sides");
  const int rr = min(r, n - 1);     // lanes past n read a real row and are ignored
  __syncwarp();                     // the factor's last published column is read
  for (int i = 0; i < n; ++i) {
    sweep_step<NC>(s_pub + (i & 1) * kPubStride, r, i, sL[i * ld + rr], x);   // Lh[r][i]
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) x[c] = x[c] * dinv;
  __syncwarp();                     // the last forward row is read before it is rewritten
  for (int i = n - 1; i >= 0; --i) {
    sweep_step<NC>(s_pub + (i & 1) * kPubStride, r, i, sL[rr * ld + i], x);   // Lh[i][r]
  }
  __syncwarp();                     // every lane has read the last published row
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
// .. 0); kernels/ldl.py's `start` skips steps that would subtract a zero, which
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

// x <- (L L^T)^{-1} x for one right-hand side of size n <= 32 R on one
// warp, from chol_factor_tiles' converted factor (sL column-major, stride
// ld; dinv_r = s_rd[r]^2): lane j holds rows j, j + 32, ..., j + 32 (R - 1)
// in x[0 .. R - 1]. At step i the holder of row i (lane i % 32, slot i /
// 32) broadcasts it by one shuffle and every lane updates its rows: 2n + 1
// steps and no barrier, where ldl_solve_tiles spends a __syncthreads a step
// to share up to 8 right-hand sides among 256 threads (K4's free block
// above nf = 32 has one). Each entry takes ldl_solve_tiles' operations in
// its order; a lane skips the slots whose rows are all on or above the
// step's (forward) or on or below it (backward), where Lh holds zeros, which
// changes nothing but the sign of a zero. Rows past n read row n - 1 and
// end as garbage.
template <int R>
__device__ void ldl_solve_warp_rows(const float* sL, int n, int ld, const float* s_rd, int lane,
                                    float (&x)[R]) {
  int rr[R];
#pragma unroll
  for (int a = 0; a < R; ++a) rr[a] = min(32 * a + lane, n - 1);
#pragma unroll
  for (int c = 0; c < R; ++c) {
    if (32 * c < n) {
      const int jn = min(32, n - 32 * c);
      for (int j = 0; j < jn; ++j) {
        const int i = 32 * c + j;
        const float v = __shfl_sync(kFullMask, x[c], j);
#pragma unroll
        for (int a = c; a < R; ++a) x[a] = fmaf(-sL[i * ld + rr[a]], v, x[a]);   // Lh[r][i]
      }
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const float d = s_rd[rr[a]];
    x[a] = x[a] * (d * d);
  }
#pragma unroll
  for (int c = R - 1; c >= 0; --c) {
    if (32 * c < n) {
      for (int j = min(32, n - 32 * c) - 1; j >= 0; --j) {
        const int i = 32 * c + j;
        const float v = __shfl_sync(kFullMask, x[c], j);
#pragma unroll
        for (int a = 0; a <= c; ++a) x[a] = fmaf(-sL[rr[a] * ld + i], v, x[a]);   // Lh[i][r]
      }
    }
  }
}

}  // namespace dq

// Fused ADMM forward solve, one launch for a whole batch (kernel K1).
//
// Replaces diffqcqp_tpu/kernels/admm_pallas.py::_admm_chol_kernel (wrapper
// admm_solve_pallas). Same constants, update order and stopping rules: power
// iteration for L, rho0 = sqrt(mu L) (L/mu)^0.4 * rho0_scale, tau0 =
// (L/mu)^0.15, then per iteration the solve with P + (rho + mu) I,
// over-relaxation, prox (non-negative, box, signed box, disk), dual update,
// residuals, the stopping rule with its stall floors, and the adaptive rho
// (rho_sync or cpt gating) with a new inverse whenever rho changes.
//
// Design, three paths (dq_admm_plan picks one from n alone):
//   * 129 <= n <= 169, admm_kernel (the two-plane kernel): one thread block
//     per problem, one thread per coordinate row (blockDim = 32 * ceil(n /
//     32)). P and the inverse live in dynamic shared memory (2 n ld floats,
//     ld = n | 1 odd so row and column walks are both bank-conflict free);
//     per-problem scalars (rho, taus, counters, flags) and per-row vectors
//     (l2, u, q_prox) live in registers. The inf-norm, 2-norm and
//     Rayleigh-quotient reductions are warp butterflies (every lane ends
//     with the same value) plus a small shared array across warps. Each
//     block leaves its loop when its own problem converges or at max_iter.
//   * 33 <= n <= 128, admm_kernel_rows<RowK1<kN, ...>>: the same block of
//     kN = 32 ceil(n / 32) threads a problem (kN = 64, 96, 128), its
//     reductions and its exit, with the one-warp path's treatment: every
//     loop over columns unrolled to kN, thread r keeping its row of P in
//     registers through the set-up and then building its row of X in
//     registers (gj_inverse_rows; only the published pivot columns and
//     pivots go through shared memory, in two buffers that the passes take
//     in turn, so a pass needs no barrier of its own). An iteration reads
//     its three published vectors as float4 (X rhs, X res) and double2
//     (P l0) broadcasts; P stays in shared memory (stride kN + 2) for the
//     float64 residual alone, and q, the prox's arguments and the loop
//     state while an inverse is formed sit there too, so that kN = 96 fits
//     the 168 registers of four blocks an SM without spilling. A row of 169
//     floats does not fit a thread's 255 registers: past 128 the two-plane
//     kernel runs. The two block-wide kernels differ only in where the rows
//     live and when the inverse is formed: both take an iteration's step
//     after the solve (the prox, the reduction, the stopping rule, the
//     commit) from admm_step and the rho schedule from adapt_rho.
//   * n <= 32, admm_kernel_warp<WarpK1<kN, kG, ...>>: one warp a block and
//     kG problems a warp (four at n <= 8, two at n <= 16, else one), each on
//     a segment of 32 / kG lanes, lane r owning row r; every loop over
//     columns unrolled to kN (8, 16, 24, 32). Lane r keeps its row of P in
//     registers through the set-up (the power iteration reads only the
//     published vector) and then its row of the inverse X, which
//     gj_inverse_w builds in place: only the published pivot columns go
//     through shared memory. An iteration reads its three published vectors
//     as 16-byte broadcasts (6 loads for 24 entries) and P's row, kept in
//     shared memory (stride kN + 2) for the float64 residual, as float2s.
//     Values read once an iteration or less (q, the prox's arguments, the
//     rho schedule's state, a stopped problem's results) sit in shared
//     memory too, so that the flagship's instance fits 64 registers (32
//     blocks an SM) without spilling. Reductions are butterflies over the
//     segment. A warp runs until all its problems stopped; a problem keeps
//     its results when it stops and is frozen after (it commits nothing),
//     and a new inverse is formed only in the segments whose rho changed.
//
// The linear solve. The TPU kernel factors P + (rho + mu) I as LDL^T and
// solves by two triangular sweeps: 2n + 1 dependent steps, each a broadcast
// then a multiply-add the next step waits on, and past one warp each
// broadcast would be a __syncthreads (193 per iteration at N = 96). Here the
// explicit inverse X = (P + (rho + mu) I)^{-1} is held (in the second plane,
// or a row a thread in registers; gj_inverse: Gauss-Jordan, one barrier per
// column), and an iteration is
// refined_solve: l0 = X rhs, the residual rhs - (P + (rho + mu) I) l0
// accumulated in double, and l = l0 + X res: three row-times-vector
// products, three barriers (__syncwarp at one warp), no dependent chain
// across threads. The refinement is not optional: an explicit float32
// inverse alone is off by ~cond eps, enough to move a trajectory at the
// stall floor onto a different rho schedule, while the double residual
// brings each solve back to about float32 rounding.
//
// What differs from the TPU kernel and why it does not change the result:
//   * the TPU loops a 128-lane tile until every lane converged, freezing the
//     converged lanes; here each problem stops on its own, which leaves the
//     same values (a frozen lane never changes again);
//   * rho_sync gates on the tile's iteration counter; for a problem that is
//     still running that counter equals its own iteration count, so the
//     per-problem counter reproduces the gate exactly (it > 0 excluded);
//   * the TPU refactors the whole tile when any lane's rho changed; here
//     only the problem whose rho changed forms its new inverse. The inverse
//     is a pure function of (P, rho), so the numbers are the same;
//   * the solve is the refined inverse, not the sweeps: the same solution
//     to about float32 rounding;
//   * the friction-cone prox works in reference order (contact c owns rows
//     2c, 2c+1; the partner value comes by a lane shuffle) instead of the
//     TPU's permuted order. That changes float32 rounding only.
//
// Rounding: the plain version (kernels/admm_cuda.py::admm_solve_plain)
// follows this kernel's trajectory operation for operation. This file is
// built with -fmad=false (kernels/_build.py::SOURCE_FLAGS), so a product
// and a sum are rounded on their own as torch's ops round them, and only
// the explicit fmaf / fma calls (the matrix-vector products and the
// Gauss-Jordan passes) are fused (the plain version's _fma); the
// block sums add in the order the plain version's _block_sum repeats, and
// the powers are taken in double. At eps = 1e-5 two float32 trajectories
// that differ in rounding end up to ~1e-4 apart, so nothing less holds the
// kernel to its plain version at phase 2's 2e-5.
//
// What bounds it on this card: not bytes (P is read once, ~9.4 MB at
// B = 4096, N = 24) nor FLOPs (a few MFLOP per problem), but latency inside
// each problem and, past one warp, the shared-memory pipe: an iteration's
// three barriers and three n-long multiply-add chains (four partial sums
// each), and the inverse at each (re)factorisation, about once per problem
// at the benchmark configs. Measured at the flagship on an H100
// (chip_smoke.py k1, device time; PERF.md): with the design before the
// one-warp path, one problem an SM (B = 132) already took 51 % of the time
// of B = 4096, and the set-up (P's load, the power iteration, the first
// inverse) 32 % of it, so each problem's chain set the time more than the
// SM's shared-memory throughput did. The one-warp path shortens that chain:
// registers in place of shared-memory round trips for the rows of P and X
// (the set-up 2.6x shorter), a quarter of the loads for a published vector,
// and at n <= 16 the idle lanes of a warp given to other problems. An
// iteration alone then still takes more than half the time it takes when 31
// problems share an SM: its chain of instructions, most of them the
// stopping rules', the prox's and the residual's bookkeeping, sets it.
// Past one warp every thread reads every published vector, and a 16-byte
// broadcast still costs the SM's shared-memory pipe four cycles (eight
// lanes a cycle): an iteration of the register path moves ~1.9 KB into each
// thread's registers (X rhs and X res 384 B each, P's row 384 B, l0 in
// double 768 B), ~5,800 of the pipe's cycles for the four problems an SM
// at kN = 96, and an inverse pass ~1,150 a problem. At config 6 (B = 2048,
// N = 96; chip_smoke.py k1, PERF.md) the register path took K1 from 1.43 to
// 0.77 ms: the inverse ~0.35, an iteration 0.0105 ms across the batch, the
// rest of the set-up (P's load and the power iteration's in-order chains)
// 0.10. Fewer bytes a multiply-add need more rows a thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ldl.cuh"

// Must match _Params in kernels/admm_cuda.py field for field.
struct AdmmParams {
  float eps, eps_rel, mu_prox, alpha, mu_thresh, damp, rho0_scale;
  float stall_floor;   // float32(stall_tol * float32 eps)
  float v0;            // float32(1 / sqrt(n)): power-iteration start
  int n, max_iter, rho_update_period, power_iters, prox_kind;
  int adaptive_rho, rho_sync, warm_start_dual;
  int primal_test;     // qcqp_stopping or primal_check
  int damp_both, stall_on;
};

namespace {

enum ProxKind { kNonneg = 0, kBox = 1, kSignedBox = 2, kDisk = 3 };

// warps of a block at most (the kernel's __launch_bounds__(256)); the
// reduction slots are 4 per warp. (At N = 96 a block's shared memory then
// fits three blocks on an SM; with 32 slots a warp it was 128 bytes over.)
constexpr int kMaxWarps = 8;

// (max, max, max, sum) over the block; every thread gets the same four.
__device__ __forceinline__ float4 block_reduce(const dq::Blk& k, float4 v, float* s_red) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x = fmaxf(v.x, __shfl_xor_sync(dq::kFullMask, v.x, o));
    v.y = fmaxf(v.y, __shfl_xor_sync(dq::kFullMask, v.y, o));
    v.z = fmaxf(v.z, __shfl_xor_sync(dq::kFullMask, v.z, o));
    v.w += __shfl_xor_sync(dq::kFullMask, v.w, o);
  }
  if (k.one_warp) return v;
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_red[w] = v.x;
    s_red[kMaxWarps + w] = v.y;
    s_red[2 * kMaxWarps + w] = v.z;
    s_red[3 * kMaxWarps + w] = v.w;
  }
  __syncthreads();
  float4 t = make_float4(s_red[0], s_red[kMaxWarps], s_red[2 * kMaxWarps],
                         s_red[3 * kMaxWarps]);
  for (int i = 1; i < nw; ++i) {
    t.x = fmaxf(t.x, s_red[i]);
    t.y = fmaxf(t.y, s_red[kMaxWarps + i]);
    t.z = fmaxf(t.z, s_red[2 * kMaxWarps + i]);
    t.w += s_red[3 * kMaxWarps + i];
  }
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_sum(const dq::Blk& k, float v, float* s_red) {
  return block_reduce(k, make_float4(0.f, 0.f, 0.f, v), s_red).w;
}

// (P x)_r, accumulated over columns in order as the TPU kernel does, in
// fused multiply-adds (kernels/admm_cuda.py::_matvec).
__device__ __forceinline__ float matvec(const dq::Blk& k, const float* sP, float x,
                                        float* s_x) {
  if (k.real) s_x[k.r] = x;
  dq::bsync(k);
  float acc = 0.f;
  if (k.real) {
    const float* row = sP + k.r * k.ld;
    acc = row[0] * s_x[0];
    for (int c = 1; c < k.n; ++c) acc = fmaf(row[c], s_x[c], acc);
  }
  dq::bsync(k);
  return acc;
}

// sX <- (P + shift I)^{-1} by Gauss-Jordan elimination without pivoting (the
// matrix is symmetric positive definite), in place, thread r owning row r;
// the arithmetic of kernels/admm_cuda.py::gj_inverse. Step c needs the pivot
// row c. By symmetry it is column c, with the sign of its finished entries
// (j < c) flipped, so each thread publishes its own column-c entry, w_j =
// -A[j][c] (j < c), A[j][c] (j > c), w_c = 1, and the pivot p = A[c][c].
// Then row c becomes w / p and every other row takes g = A[r][c] / p,
// A[r][c] = 0, A[r][:] -= g w; one loop for both (a = 0, g = -1 / p on row
// c), so no warp runs two loops in turn. The kGJ columns kept in registers
// take fma(a, A[r][j], -(g w_j)), the plain version's two roundings, with
// the product off the chain through A; the pass below rounds once.
//
// A pass over a row in shared memory is a load, a store and a load of w for
// each multiply-add, and at N = 96 those passes, not the arithmetic, set the
// time. So kGJ steps share one pass: each thread keeps its row's entries of
// the kGJ columns c0 .. c0 + kGJ - 1 in registers and applies each step to
// them at once (that is all the next step's publish needs), the kGJ
// published columns sit side by side in one float4 per row (w4[j].t = w_t of
// row j), and then one pass applies the kGJ updates to the rest of the row,
// each entry receiving them in the order of the steps. One barrier per step
// and one per pass. Scratch: s_v, 4 n + 4 floats, 16-byte aligned inside
// s_v (at most 2 floats of padding, s_v being 8-byte aligned): within its
// 5 n floats from n = 6, and below that within the reduction slots after
// it, which no reduction uses while the inverse is formed.
constexpr int kGJ = 4;
static_assert(kGJ == 4, "the pass below applies four steps from one float4");

// One pass: the kGJ updates to every entry of a row, x <- fma(-g_t, w_t, m x)
// (restrict: the row and the published columns never overlap, so the loads
// run ahead of the stores). On the row of this pass's pivot step tp, m = 0
// and g_t = 0 for t < tp: its entries before tp are discarded (row c becomes
// w / p), so the pass starts it from 0; every other row has m = 1. One
// rounding per update here, two in the registers' and the plain version's.
__device__ __forceinline__ void gj_pass(float* __restrict__ row, const float4* __restrict__ w4,
                                        const float* g, float m, int n) {
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float4 w = w4[j];
    float x = row[j] * m;
    x = fmaf(-g[0], w.x, x);
    x = fmaf(-g[1], w.y, x);
    x = fmaf(-g[2], w.z, x);
    x = fmaf(-g[3], w.w, x);
    row[j] = x;
  }
}

__device__ void gj_inverse(const dq::Blk& k, const float* sP, float* sX, float shift,
                           float* s_v) {
  const int n = k.n, ld = k.ld, r = k.r;
  float* row = sX + r * ld;
  float4* w4 = reinterpret_cast<float4*>((reinterpret_cast<uintptr_t>(s_v) + 15) & ~uintptr_t(15));
  float* piv = reinterpret_cast<float*>(w4 + n);
  if (k.real) {
#pragma unroll 8
    for (int j = 0; j < n; ++j) row[j] = sP[r * ld + j] + (j == r ? shift : 0.f);
  }
  for (int c0 = 0; c0 < n; c0 += kGJ) {
    const int kb = min(kGJ, n - c0);
    float v[kGJ], g[kGJ], a[kGJ];
#pragma unroll
    for (int t = 0; t < kGJ; ++t) {
      v[t] = (k.real && t < kb) ? row[c0 + t] : 0.f;
      g[t] = 0.f;
      a[t] = 1.f;
    }
#pragma unroll
    for (int t = 0; t < kGJ; ++t) {
      if (t < kb) {
        const int c = c0 + t;
        if (k.real) {
          reinterpret_cast<float*>(w4 + r)[t] = (r == c) ? 1.f : (r < c ? -v[t] : v[t]);
          if (r == c) piv[t] = v[t];
        }
        dq::bsync(k);
        if (k.real) {
          const float pinv = __frcp_rn(fmaxf(piv[t], dq::kTiny));   // = 1 / p, rounded once
          const bool p = r == c;
          g[t] = p ? -pinv : v[t] * pinv;
          a[t] = p ? 0.f : 1.f;
          if (!p) v[t] = 0.f;
#pragma unroll
          for (int u = 0; u < kGJ; ++u) {
            if (u < kb) {
              v[u] = fmaf(a[t], v[u], -(g[t] * reinterpret_cast<const float*>(w4 + c0 + u)[t]));
            }
          }
        }
      }
    }
    if (k.real) {
      // the pass's pivot row (r = c0 + tp) drops the steps before tp; steps
      // past kb (the last, short pass) have g = 0: no change
      const int tp = r - c0;
      const bool pivot = tp >= 0 && tp < kb;
      float gp[kGJ];
#pragma unroll
      for (int t = 0; t < kGJ; ++t) gp[t] = (pivot && t < tp) ? 0.f : g[t];
      gj_pass(row, w4, gp, pivot ? 0.f : 1.f, n);
      // the kGJ columns themselves took their updates in registers
#pragma unroll
      for (int u = 0; u < kGJ; ++u) {
        if (u < kb) row[c0 + u] = v[u];
      }
    }
    dq::bsync(k);   // w4 is rewritten by the next pass's steps, and s_v is the solve's scratch
  }
}

// (X x)_r, x published in s_x by the caller (after a barrier); 0 past n.
// Four partial sums, column c into sum c % 4, then (s0 + s1) + (s2 + s3),
// as kernels/admm_cuda.py::_matvec4: four chains of n / 4 multiply-adds in
// place of one of n (T float, or double over float rows and a double copy of
// a float vector: products exact in double).
template <typename T, typename X>
__device__ __forceinline__ T row_dot4(const float* __restrict__ row, const X* __restrict__ x,
                                      int n) {
  T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int c = 0;
#pragma unroll 2
  for (; c + 3 < n; c += 4) {
    s0 = fma((T)row[c], (T)x[c], s0);
    s1 = fma((T)row[c + 1], (T)x[c + 1], s1);
    s2 = fma((T)row[c + 2], (T)x[c + 2], s2);
    s3 = fma((T)row[c + 3], (T)x[c + 3], s3);
  }
  if (c < n) s0 = fma((T)row[c], (T)x[c], s0);
  if (c + 1 < n) s1 = fma((T)row[c + 1], (T)x[c + 1], s1);
  if (c + 2 < n) s2 = fma((T)row[c + 2], (T)x[c + 2], s2);
  return (s0 + s1) + (s2 + s3);
}

__device__ __forceinline__ float row_dot(const dq::Blk& k, const float* sX, const float* s_x) {
  return k.real ? row_dot4<float, float>(sX + k.r * k.ld, s_x, k.n) : 0.f;
}

// (P + shift I)^{-1} rhs for this thread's row from the explicit inverse in
// sX, refined once: l0 = X rhs, res = rhs - (P l0 + shift l0) accumulated in
// double (a product of two floats is exact there, so kernels/admm_cuda.py::
// _refined_solve gets the same bits for the same l0), l = l0 + X res. Three
// published vectors in s_v (rhs and res: n floats each; l0 as double, each
// thread converting its own once: 2 n floats from s_v + 2 n, 8-byte aligned
// as s_v is), one barrier each: each is read only before the next barrier
// and rewritten only after the following one, so none needs a second.
__device__ float refined_solve(const dq::Blk& k, const float* sP, const float* sX, float rhs,
                               float shift, float* s_v) {
  float* x0 = s_v;
  float* x2 = s_v + k.n;
  double* x1 = reinterpret_cast<double*>(s_v + 2 * k.n);
  if (k.real) x0[k.r] = rhs;
  dq::bsync(k);
  const float l0 = row_dot(k, sX, x0);
  if (k.real) x1[k.r] = (double)l0;
  dq::bsync(k);
  if (k.real) {
    const double acc =
        row_dot4<double, double>(sP + k.r * k.ld, x1, k.n) + (double)shift * (double)l0;
    x2[k.r] = (float)((double)rhs - acc);
  }
  dq::bsync(k);
  return l0 + row_dot(k, sX, x2);
}

// What an iteration of a block-wide kernel decided: the residuals (with the
// rho they were computed with), whether the problem stops, and whether eps
// certified both residuals.
struct Step {
  float rp, rd;
  bool stop, certified;
};

// The iteration after the linear solve's l, for both block-wide kernels
// (admm_kernel, admm_kernel_rows): the relaxation, the prox, the residuals'
// block reduction and the stopping rule, then the commit of l2, u and qp
// (qpn = q - mu l). arg(i) is this row's prox argument i: lo, hi and v_sign
// for the box kinds, its disk's radius as argument 0.
template <typename Arg>
__device__ __forceinline__ Step admm_step(const dq::Blk& k, const AdmmParams& prm, float l,
                                          float qpn, float rho, Arg arg, float& l2, float& u,
                                          float& qp, float* s_red) {
  const int r = k.r, nc = k.n / 2;
  const float rr = prm.alpha * l + (1.0f - prm.alpha) * l2;
  const float x = rr + u / rho;

  // prox; the disk partner moves by shuffle, so every lane calls it
  const float partner = __shfl_xor_sync(dq::kFullMask, x, 1);
  float l2n = 0.f;
  if (k.real) {
    switch (prm.prox_kind) {
      case kNonneg:
        l2n = fmaxf(x, 0.f);
        break;
      case kBox:
        l2n = fminf(fmaxf(x, arg(0)), arg(1));
        break;
      case kSignedBox: {
        const float vs = arg(2);
        l2n = vs * fminf(vs * fminf(fmaxf(x, arg(0)), arg(1)), 0.f);
        break;
      }
      default: {
        if (r < 2 * nc) {
          const float rad = arg(0);
          const float xa = (r & 1) ? partner : x;
          const float xb = (r & 1) ? x : partner;
          const float nrm = sqrtf(xa * xa + xb * xb);
          const float scale = nrm > rad ? rad / fmaxf(nrm, dq::kTiny) : 1.f;
          l2n = x * scale;
        } else {
          l2n = x;
        }
      }
    }
  }
  const float un = u + rho * (rr - l2n);

  const float4 red = block_reduce(
      k, make_float4(fabsf(l2n - l2), fabsf(l2n - rr), fabsf(l2n), l * l), s_red);
  const float delta = red.x, rp = red.y, l2inf = red.z;
  const float rd = rho * delta;

  const bool eps_ok = rd < prm.eps;
  const float noise = prm.stall_floor * fmaxf(l2inf, 1.f);
  const bool dual_ok = prm.stall_on ? (eps_ok || delta <= noise) : eps_ok;
  bool newly, certified;
  if (prm.primal_test) {
    const float lnorm = sqrtf(red.w);
    const bool prim_eps = rp < prm.eps + prm.eps_rel * lnorm;
    const bool prim_ok = prm.stall_on ? (prim_eps || rp <= noise) : prim_eps;
    newly = prim_ok && dual_ok;
    certified = eps_ok && prim_eps;
  } else {
    newly = dual_ok;
    certified = eps_ok;
  }

  // commit this iteration (the problem was active)
  l2 = l2n;
  u = un;
  qp = qpn;
  return {rp, rd, newly, certified};
}

// The adaptive rho after iteration it, which did not stop: rho_sync's period
// or the per-problem cpt gate, the step damped when its direction flips.
// True where rho changed, so that a new inverse is due.
__device__ __forceinline__ bool adapt_rho(const AdmmParams& prm, int it, const Step& st,
                                          float& rho, float& tau_inc, float& tau_dec,
                                          int& rho_up, int& cpt) {
  if (!prm.adaptive_rho) return false;
  const float rp = st.rp, rd = st.rd;
  const bool inc = rp > prm.mu_thresh * rd;
  const bool dec = !inc && (rd > prm.mu_thresh * rp);
  const bool gate = prm.rho_sync
                        ? (it % prm.rho_update_period == 0 && it > 0)
                        : (cpt % prm.rho_update_period == 0);
  cpt += (inc || dec);
  const bool app_inc = gate && inc, app_dec = gate && dec;
  if (!(app_inc || app_dec)) return false;
  const bool flip_inc = app_inc && rho_up == -1;
  const bool flip_dec = app_dec && rho_up == 1;
  const float damped_inc = 1.f + prm.damp * (tau_inc - 1.f);
  const float damped_dec = 1.f + prm.damp * (tau_dec - 1.f);
  if (prm.damp_both) {
    if (flip_inc || flip_dec) {
      tau_inc = damped_inc;
      tau_dec = damped_dec;
    }
  } else {
    if (flip_inc) tau_inc = damped_inc;
    if (flip_dec) tau_dec = damped_dec;
  }
  rho = app_inc ? rho * tau_inc : rho / tau_dec;
  rho_up = app_inc ? 1 : -1;
  return true;
}

__global__ void __launch_bounds__(256)
admm_kernel(const float* __restrict__ P, const float* __restrict__ q,
            const float* __restrict__ ws, const float* __restrict__ pa,
            const float* __restrict__ pb, const float* __restrict__ pc,
            float* __restrict__ l2_out, int* __restrict__ iters_out,
            float* __restrict__ resp_out, float* __restrict__ resd_out,
            float* __restrict__ rho_out, uint8_t* __restrict__ conv_out,
            uint8_t* __restrict__ stall_out, const AdmmParams prm) {
  extern __shared__ __align__(16) float smem[];   // float4 and double views inside
  const int n = prm.n, ld = n | 1, nc = n / 2;
  float* sP = smem;
  float* sX = sP + n * ld;                // the inverse of P + (rho + mu) I
  // 5 n floats of vector scratch from s_v: refined_solve's three vectors
  // (4 n floats) and gj_inverse's 4 n + 4; matvec publishes in its last n,
  // s_x, only before the first inverse is formed
  float* s_v = sX + n * ld;
  float* s_x = s_v + 4 * n;
  float* s_red = s_x + n;                 // 4 * kMaxWarps

  const int r = threadIdx.x;
  const dq::Blk k{r, n, ld, blockDim.x == 32, r < n};
  const size_t b = blockIdx.x;

  // P into shared memory, coalesced: in float4s where the rows are whole
  // float4s and P is 16-byte aligned (then so is every problem's P, n being
  // a multiple of 4), so that each thread keeps several loads in flight;
  // else row by row, the block's threads across each row
  const float* Pb = P + b * n * n;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0) {
    const int n4 = n >> 2;
    const float4* Pb4 = reinterpret_cast<const float4*>(Pb);
#pragma unroll 4
    for (int idx = r; idx < n * n4; idx += blockDim.x) {
      const int i = idx / n4, j = (idx - i * n4) << 2;
      const float4 v = Pb4[idx];
      float* d = sP + i * ld + j;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      for (int j = r; j < n; j += blockDim.x) sP[i * ld + j] = Pb[i * n + j];
    }
  }
  const size_t vo = b * n + r;
  const float qv = k.real ? q[vo] : 0.f;
  float l2 = k.real ? ws[vo] : 0.f;
  float lo = 0.f, hi = 0.f, vs = 0.f;   // lo is the disk's radius
  if (k.real && (prm.prox_kind == kBox || prm.prox_kind == kSignedBox)) {
    lo = pa[vo];
    hi = pb[vo];
    if (prm.prox_kind == kSignedBox) vs = pc[vo];
  }
  if (prm.prox_kind == kDisk && r < 2 * nc) lo = pa[b * nc + (r >> 1)];
  const auto arg = [&](int i) { return i == 0 ? lo : (i == 1 ? hi : vs); };
  __syncthreads();

  const float mu = prm.mu_prox;

  // power iteration for L (fixed count), then rho0 and tau0
  float v = k.real ? prm.v0 : 0.f;
  for (int it = 0; it < prm.power_iters; ++it) {
    const float av = matvec(k, sP, v, s_x);
    const float nrm = sqrtf(block_sum(k, av * av, s_red));
    v = av / fmaxf(nrm, dq::kTiny);
  }
  const float pv = matvec(k, sP, v, s_x);
  const float L = fmaxf(block_sum(k, v * pv, s_red), mu);
  const float ratio = L / mu;
  // the powers in double, rounded once (powf is not correctly rounded; the
  // plain version rounds the same float64 power)
  float rho = sqrtf(mu * L) * (float)pow((double)ratio, (double)0.4f) * prm.rho0_scale;
  const float tau0 = (float)pow((double)ratio, (double)0.15f);

  // u0 = -(P ws + q) synthesises the dual warm start from the primal one
  float u = 0.f;
  if (prm.warm_start_dual) u = -(matvec(k, sP, l2, s_x) + qv);

  gj_inverse(k, sP, sX, rho + mu, s_v);

  float qp = qv;
  float tau_inc = tau0, tau_dec = tau0;
  int rho_up = 0, cpt = 0, iters = 0;
  bool conv = false, stall = false;
  float resp = INFINITY, resd = INFINITY, rho_rec = rho;

  for (int it = 0; it < prm.max_iter; ++it) {
    const float rhs = rho * l2 - u - qp;
    const float l = refined_solve(k, sP, sX, rhs, rho + mu, s_v);
    const Step st = admm_step(k, prm, l, qv - mu * l, rho, arg, l2, u, qp, s_red);
    // the recorded rho is the one the residuals were computed with, before
    // any update below
    resp = st.rp;
    resd = st.rd;
    rho_rec = rho;
    ++iters;
    if (st.stop) {
      conv = true;
      stall = !st.certified;
      break;
    }
    if (adapt_rho(prm, it, st, rho, tau_inc, tau_dec, rho_up, cpt)) {
      gj_inverse(k, sP, sX, rho + mu, s_v);
    }
  }

  if (k.real) l2_out[vo] = l2;
  if (r == 0) {
    iters_out[b] = iters;
    resp_out[b] = resp;
    resd_out[b] = resd;
    rho_out[b] = rho_rec;
    conv_out[b] = conv;
    stall_out[b] = stall;
  }
}

// Dynamic shared memory one block of the block-wide kernel needs for a
// problem of size n (the wrapper's smem_bytes in kernels/admm_cuda.py
// computes the same).
size_t smem_bytes(int n) {
  const int ld = n | 1;
  return sizeof(float) * (2 * (size_t)n * ld + 5 * (size_t)n + 4 * kMaxWarps);
}

// ---------------------------------------------------------------------------
// One warp, n <= 32 (admm_kernel_warp): kG problems a warp, each on a segment
// of kS = 32 / kG lanes, lane r of a segment owning row r of its problem.
// ---------------------------------------------------------------------------

// The one-warp instances: every loop over columns unrolled to kN (n <= kN),
// so that lane r's rows of P (in the set-up) and of X live in registers,
// indexed only by compile-time indices; kG problems a warp; at least
// kMinBlocks blocks an SM (the register cap of __launch_bounds__).
template <int N, int G, int MinBlocks>
struct WarpK1 {
  static constexpr int kN = N, kG = G, kS = 32 / G, kMinBlocks = MinBlocks;
  // P's row stride: even, its half odd, so that the float2 loads of sixteen
  // lanes' rows (a half-warp) fall in distinct bank pairs
  static constexpr int kLd = N + 2;
  // floats of one segment's scratch: a solve's three published vectors (rhs
  // and res as floats, l0 as doubles: 4 kN), or the Gauss-Jordan steps' kN
  // published float4 columns and four pivots (4 kN + 4)
  static constexpr int kScratch = 4 * N + 4;
  static constexpr int kCold = 12;
  // a segment's floats before P: the scratch; its problem's tau_inc,
  // tau_dec and last rho move, then its results (iterations, residuals,
  // rho, flags), written when it stops and stored after the loop (kCold);
  // the prox's arguments by row (the box's bounds and signs, or the disk's
  // radius) and q: values read once an iteration or less, kept out of
  // registers; and a lane's l2, u, q_prox, rho and stopped flag, parked
  // while an inverse is formed (5 kS)
  static constexpr int kSeg = kScratch + kCold + 4 * N + 5 * (32 / G);
  static constexpr int kPlane = N * kLd;   // P, zero past column n
  static_assert(N % 8 == 0 && 32 % G == 0 && N <= 32 / G, "one segment holds kN rows");
};
// The flagship's and config 5's instances fit 64 registers (32 blocks an
// SM: B = 4096 at N = 24 in one wave); the other two may take 128, which
// they need not to spill (ptxas on sm_90a: 96 and 128 registers, 20 and 16
// blocks an SM).
using WarpQuad = WarpK1<8, 4, 32>;    // n <= 8: four problems a warp
using WarpPair = WarpK1<16, 2, 16>;   // 9 <= n <= 16: two
using Warp24 = WarpK1<24, 1, 32>;     // 17 <= n <= 24: the flagship
using Warp32 = WarpK1<32, 1, 16>;     // 25 <= n <= 32
constexpr int kOneWarpMaxN = 32;

// max and sum over a segment of S lanes (a butterfly, every lane ends with
// the result). The sum adds in _block_sum's order: at n <= S its first
// 32 / S levels add only the zeros of the rows past n, which leave a sum
// unchanged, so the segment's levels alone give its bits.
template <int S>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(dq::kFullMask, v, o));
  return v;
}

template <int S>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) v += __shfl_xor_sync(dq::kFullMask, v, o);
  return v;
}

// x = lane r's row of P from shared memory (8-byte loads), or zeros on a
// lane that holds no row.
template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const float* __restrict__ prow, bool real) {
  const float2* p2 = reinterpret_cast<const float2*>(prow);
#pragma unroll
  for (int c = 0; c < N; c += 2) {
    const float2 p = real ? p2[c >> 1] : make_float2(0.f, 0.f);
    x[c] = p.x;
    x[c + 1] = p.y;
  }
}

// (P v)_r from lane r's row of P in registers (the set-up), v published in
// the segment's scratch and read back as float4 broadcasts: one chain over
// the columns in order, the first a product, as matvec.
template <typename W>
__device__ __forceinline__ float matvec_w(const float (&p)[W::kN], float v, int r, int n,
                                          bool pub, bool real, float* s) {
  if (pub) s[r] = v;
  __syncwarp();
  const float4* v4 = reinterpret_cast<const float4*>(s);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < W::kN; c += 4) {
    if (c < n) {
      const float4 w = v4[c >> 2];
      acc = c == 0 ? p[0] * w.x : fmaf(p[c], w.x, acc);
      if (c + 1 < n) acc = fmaf(p[c + 1], w.y, acc);
      if (c + 2 < n) acc = fmaf(p[c + 2], w.z, acc);
      if (c + 3 < n) acc = fmaf(p[c + 3], w.w, acc);
    }
  }
  __syncwarp();
  return real ? acc : 0.f;
}

// (X v)_r from lane r's row of X in registers and v published in shared
// memory (kN floats, zero past n), read as float4 broadcasts: row_dot4's
// four partial sums, column c into sum c % 4, then (s0 + s1) + (s2 + s3).
// The columns past n add fma(0, 0, s) = s + 0 = s exactly (a partial sum
// that starts at +0 is never -0).
template <int N>
__device__ __forceinline__ float dot_reg(const float (&x)[N], const float* __restrict__ v) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 w = v4[c >> 2];
    s0 = fmaf(x[c], w.x, s0);
    s1 = fmaf(x[c + 1], w.y, s1);
    s2 = fmaf(x[c + 2], w.z, s2);
    s3 = fmaf(x[c + 3], w.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// (P v)_r in double, from lane r's row of P in shared memory (zero past
// n, each entry converted exactly) and v published as doubles:
// row_dot4<double, double>'s partial sums, column c into sum c % 4; a step
// of four columns loads two float2 of P and two double2 of v. Not
// unrolled: one step's registers of loads stay live beside X's row, not
// the whole row's.
template <int N>
__device__ __forceinline__ double dot_p64(const float* __restrict__ prow,
                                          const double* __restrict__ v) {
  const float2* p2 = reinterpret_cast<const float2*>(prow);
  const double2* v2 = reinterpret_cast<const double2*>(v);
  double s0 = 0., s1 = 0., s2 = 0., s3 = 0.;
#pragma unroll 1
  for (int h = 0; h < N / 2; h += 2) {
    const float2 p = p2[h], q = p2[h + 1];
    const double2 a = v2[h], b = v2[h + 1];
    s0 = fma((double)p.x, a.x, s0);
    s1 = fma((double)p.y, a.y, s1);
    s2 = fma((double)q.x, b.x, s2);
    s3 = fma((double)q.y, b.y, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// refined_solve with lane r's row of X in registers: l0 = X rhs, the
// residual rhs - (P l0 + shift l0) in double, l = l0 + X res. The three
// published vectors sit in the segment's scratch (rhs, res, then l0 as
// doubles); lanes r < kN publish, zero on the lanes that hold no row, one
// __syncwarp each. Returns 0 on those lanes.
template <typename W>
__device__ __forceinline__ float refined_solve_w(const float (&x)[W::kN],
                                                 const float* __restrict__ prow, float rhs,
                                                 float shift, int r_in, bool pub, bool real,
                                                 float* s) {
  constexpr int N = W::kN;
  // r through an opaque move: the three slots' addresses are formed here,
  // not kept in registers through the loop (and the inverse's passes)
  int r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(r_in));
  float* x0 = s;
  float* x2 = s + N;
  double* x1 = reinterpret_cast<double*>(s + 2 * N);
  if (pub) x0[r] = real ? rhs : 0.f;
  __syncwarp();
  const float l0 = dot_reg<N>(x, x0);
  if (pub) x1[r] = real ? (double)l0 : 0.;
  __syncwarp();
  const double acc = dot_p64<N>(prow, x1) + (double)shift * (double)l0;
  if (pub) x2[r] = real ? (float)((double)rhs - acc) : 0.f;
  __syncwarp();
  return real ? l0 + dot_reg<N>(x, x2) : 0.f;
}

// gj_inverse with lane r's row in registers: in the segments with seg_upd
// (those whose rho changed), x <- row r of (P + shift I)^{-1} on the lanes
// that hold a row (real), P's row read from shared memory. The steps,
// their passes of kGJ and every rounding are gj_inverse's; the published
// columns (w4) and pivots go through the segment's scratch, and a pass
// updates the row in registers. The lanes past n publish zero columns, so
// a pass runs over all kN entries (x stays 0 past n). Every lane takes
// every __syncwarp; the others keep their x.
template <typename W>
__device__ __forceinline__ void gj_inverse_w(float (&x)[W::kN], const float* __restrict__ prow,
                                             float shift, int r_in, int n, bool seg_upd,
                                             bool real, float* s) {
  constexpr int N = W::kN;
  // r through an opaque move: what depends on r and a column (the pivot
  // tests, the signs) stays inside the solve loop, not hoisted out of it
  // as kN loop invariants that would take registers all along
  int r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(r_in));
  const bool upd = seg_upd && real;
  float4* w4 = reinterpret_cast<float4*>(s);
  float* piv = s + 4 * N;
  if (upd) {
    const float2* p2 = reinterpret_cast<const float2*>(prow);
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 p = p2[c >> 1];
      x[c] = p.x + (c == r ? shift : 0.f);
      x[c + 1] = p.y + (c + 1 == r ? shift : 0.f);
    }
  }
  __syncwarp();   // the scratch held a solve's published vectors
  if (seg_upd && !real && r < N) w4[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c0 = 0; c0 < N; c0 += kGJ) {
    if (c0 < n) {
      const int kb = min(kGJ, n - c0);
      float v[kGJ], g[kGJ];
#pragma unroll
      for (int t = 0; t < kGJ; ++t) {
        v[t] = x[c0 + t];
        g[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kGJ; ++t) {
        if (t < kb) {
          const int c = c0 + t;
          if (upd) {
            reinterpret_cast<float*>(w4 + r)[t] = (r == c) ? 1.f : (r < c ? -v[t] : v[t]);
            if (r == c) piv[t] = v[t];
          }
          __syncwarp();
          if (upd) {
            const float pinv = __frcp_rn(fmaxf(piv[t], dq::kTiny));   // = 1 / p, rounded once
            const bool p = r == c;
            g[t] = p ? -pinv : v[t] * pinv;
            const float a = p ? 0.f : 1.f;
            if (!p) v[t] = 0.f;
#pragma unroll
            for (int u = 0; u < kGJ; ++u) {
              if (u < kb) {
                v[u] = fmaf(a, v[u], -(g[t] * reinterpret_cast<const float*>(w4 + c0 + u)[t]));
              }
            }
          }
        }
      }
      if (upd) {
        // the pass's pivot row (r = c0 + tp) drops the steps before tp; the
        // pass's own columns took their updates in v
        const int tp = r - c0;
        const bool pivot = tp >= 0 && tp < kb;
#pragma unroll
        for (int t = 0; t < kGJ; ++t) {
          if (pivot && t < tp) g[t] = 0.f;
        }
        const float m = pivot ? 0.f : 1.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float4 w = w4[j];
          float y = x[j] * m;
          y = fmaf(-g[0], w.x, y);
          y = fmaf(-g[1], w.y, y);
          y = fmaf(-g[2], w.z, y);
          y = fmaf(-g[3], w.w, y);
          x[j] = y;
        }
#pragma unroll
        for (int u = 0; u < kGJ; ++u) {
          if (u < kb) x[c0 + u] = v[u];
        }
      }
      __syncwarp();   // w4 and piv are rewritten by the next pass's steps
    }
  }
}

// K1 at n <= 32: admm_kernel's algorithm, stopping rules and rounding, with
// kG problems a warp. A problem that stops writes its results then and its
// segment is frozen (it computes on, commits nothing), as a TPU tile freezes
// its converged lanes; the warp leaves the loop when all its problems have
// stopped. Segments past B (a ragged last warp) load and write nothing.
template <typename W>
__global__ void __launch_bounds__(32, W::kMinBlocks)
admm_kernel_warp(const float* __restrict__ P, const float* __restrict__ q,
                 const float* __restrict__ ws, const float* __restrict__ pa,
                 const float* __restrict__ pb, const float* __restrict__ pc,
                 float* __restrict__ l2_out, int* __restrict__ iters_out,
                 float* __restrict__ resp_out, float* __restrict__ resd_out,
                 float* __restrict__ rho_out, uint8_t* __restrict__ conv_out,
                 uint8_t* __restrict__ stall_out, const int B, const AdmmParams prm) {
  constexpr int N = W::kN, S = W::kS, G = W::kG, LD = W::kLd;
  extern __shared__ __align__(16) float smem[];   // float4 and double views inside
  const int n = prm.n, nc = n / 2;
  const int lane = threadIdx.x, seg = lane / S, r = lane % S;
  const int b0 = blockIdx.x * G, b = b0 + seg;
  const bool live = b < B;             // a problem, not a ragged warp's padding
  const bool real = live && r < n;     // a row of it
  const bool pub = r < N;              // writes slot r of its segment's vectors
  float* s = smem + seg * W::kSeg;
  // tau_inc, tau_dec, the last rho move (-1, 0, 1) and cpt (with a second
  // slot at cold + 10); from cold + 4 the results: iterations, res_prim,
  // res_dual, rho, converged, stalled
  float* cold = s + W::kScratch;
  float* pargs = cold + W::kCold;      // lo, hi, v_sign, q by row; lo is the disk's radius
  // the lane's loop state while an inverse is formed: volatile, so that it
  // is stored and loaded, and not live in registers through the inverse's
  // passes (they need them for X's row and their loads)
  volatile float* park = pargs + 4 * N;
  float* planes = smem + G * W::kSeg;
  const float* prow = planes + seg * W::kPlane + min(r, N - 1) * LD;

  // the block's P into shared memory, coalesced (in float4s where the rows
  // are whole float4s and P is 16-byte aligned), zero past column n
  {
    if (n < N) {
      for (int i = lane; i < G * W::kPlane; i += 32) planes[i] = 0.f;
      __syncwarp();
    }
    const int gl = min(G, B - b0);
    const float* Pb = P + (size_t)b0 * n * n;
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0) {
      const int n4 = n >> 2, per = n * n4;
      const float4* Pb4 = reinterpret_cast<const float4*>(Pb);
#pragma unroll 4
      for (int idx = lane; idx < gl * per; idx += 32) {
        const int g = idx / per, e = idx - g * per, i = e / n4, j = (e - i * n4) << 2;
        const float4 v = Pb4[idx];
        float2* d = reinterpret_cast<float2*>(planes + g * W::kPlane + i * LD + j);
        d[0] = make_float2(v.x, v.y);
        d[1] = make_float2(v.z, v.w);
      }
    } else {
      const int per = n * n;
#pragma unroll 4
      for (int idx = lane; idx < gl * per; idx += 32) {
        const int g = idx / per, e = idx - g * per, i = e / n, j = e - i * n;
        planes[g * W::kPlane + i * LD + j] = Pb[idx];
      }
    }
  }
  const size_t vo = (size_t)b * n + r;
  const float qv = real ? q[vo] : 0.f;
  float l2 = real ? ws[vo] : 0.f;
  if (real) pargs[3 * N + r] = qv;
  if (real && (prm.prox_kind == kBox || prm.prox_kind == kSignedBox)) {
    pargs[r] = pa[vo];
    pargs[N + r] = pb[vo];
    if (prm.prox_kind == kSignedBox) pargs[2 * N + r] = pc[vo];
  }
  if (prm.prox_kind == kDisk && live && r < 2 * nc) pargs[r] = pa[(size_t)b * nc + (r >> 1)];
  __syncwarp();

  const float mu = prm.mu_prox;
  float x[N];           // P's row for the set-up, then X's
  load_row<N>(x, prow, real);

  // power iteration for L (fixed count), then rho0 and tau0
  float v = real ? prm.v0 : 0.f;
  for (int it = 0; it < prm.power_iters; ++it) {
    const float av = matvec_w<W>(x, v, r, n, pub, real, s);
    const float nrm = sqrtf(seg_sum<S>(av * av));
    v = av / fmaxf(nrm, dq::kTiny);
  }
  const float pv = matvec_w<W>(x, v, r, n, pub, real, s);
  const float L = fmaxf(seg_sum<S>(v * pv), mu);
  const float ratio = L / mu;
  float rho = sqrtf(mu * L) * (float)pow((double)ratio, (double)0.4f) * prm.rho0_scale;
  const float tau0 = (float)pow((double)ratio, (double)0.15f);

  // u0 = -(P ws + q) synthesises the dual warm start from the primal one
  float u = 0.f;
  if (prm.warm_start_dual) u = -(matvec_w<W>(x, l2, r, n, pub, real, s) + qv);

  float qp = qv;
  if (r == 0) {
    cold[0] = tau0;
    cold[1] = tau0;
    cold[2] = 0.f;
    cold[3] = 0.f;      // cpt, read at even iterations (cold[10] at odd ones)
    // the results of a problem that never iterates (max_iter = 0)
    cold[4] = 0.f;
    cold[5] = INFINITY;
    cold[6] = INFINITY;
    cold[7] = rho;
    cold[8] = 0.f;
    cold[9] = 0.f;
  }
  bool done = !live;
  bool need = live;      // an inverse to form, at the top of the next iteration
  // the segment's lanes, for the __syncwarp inside its own rho update
  const unsigned seg_mask = S == 32 ? dq::kFullMask : ((1u << S) - 1u) << (seg * S);

  for (int it = 0; it < prm.max_iter; ++it) {
    // the first inverse, and a new one in the segments whose rho changed
    if (__any_sync(dq::kFullMask, need)) {
      const float shift = rho + mu;
      park[r] = l2;
      park[S + r] = u;
      park[2 * S + r] = qp;
      park[3 * S + r] = rho;
      park[4 * S + r] = done ? 1.f : 0.f;
      gj_inverse_w<W>(x, prow, shift, r, n, need, real, s);
      l2 = park[r];
      u = park[S + r];
      qp = park[2 * S + r];
      rho = park[3 * S + r];
      done = park[4 * S + r] != 0.f;
    }
    need = false;
    const float rhs = rho * l2 - u - qp;
    const float l = refined_solve_w<W>(x, prow, rhs, rho + mu, r, pub, real, s);
    const float qpn = (real ? pargs[3 * N + r] : 0.f) - mu * l;
    const float rr = prm.alpha * l + (1.0f - prm.alpha) * l2;
    const float xv = rr + u / rho;

    // prox; the disk partner moves by shuffle inside the segment
    const float partner = __shfl_xor_sync(dq::kFullMask, xv, 1);
    float l2n = 0.f;
    if (real) {
      switch (prm.prox_kind) {
        case kNonneg:
          l2n = fmaxf(xv, 0.f);
          break;
        case kBox:
          l2n = fminf(fmaxf(xv, pargs[r]), pargs[N + r]);
          break;
        case kSignedBox: {
          const float vs = pargs[2 * N + r];
          l2n = vs * fminf(vs * fminf(fmaxf(xv, pargs[r]), pargs[N + r]), 0.f);
          break;
        }
        default: {
          if (r < 2 * nc) {
            const float rad = pargs[r];
            const float xa = (r & 1) ? partner : xv;
            const float xb = (r & 1) ? xv : partner;
            const float nrm = sqrtf(xa * xa + xb * xb);
            const float scale = nrm > rad ? rad / fmaxf(nrm, dq::kTiny) : 1.f;
            l2n = xv * scale;
          } else {
            l2n = xv;
          }
        }
      }
    }
    const float un = u + rho * (rr - l2n);

    const float delta = seg_max<S>(fabsf(l2n - l2));
    const float rp = seg_max<S>(fabsf(l2n - rr));
    const float rd = rho * delta;
    const bool eps_ok = rd < prm.eps;
    bool dual_ok = eps_ok;
    float noise = 0.f;
    if (prm.stall_on) {
      noise = prm.stall_floor * fmaxf(seg_max<S>(fabsf(l2n)), 1.f);
      dual_ok = eps_ok || delta <= noise;
    }
    bool newly, certified;
    if (prm.primal_test) {
      const float lnorm = sqrtf(seg_sum<S>(l * l));
      const bool prim_eps = rp < prm.eps + prm.eps_rel * lnorm;
      const bool prim_ok = prm.stall_on ? (prim_eps || rp <= noise) : prim_eps;
      newly = prim_ok && dual_ok;
      certified = eps_ok && prim_eps;
    } else {
      newly = dual_ok;
      certified = eps_ok;
    }

    // commit this iteration where the problem is still running; the
    // recorded rho is the one the residuals were computed with. A problem
    // that stops (or reaches max_iter) keeps its results from now on.
    if (!done) {
      l2 = l2n;
      u = un;
      qp = qpn;
      if (newly || it + 1 == prm.max_iter) {
        if (r == 0) {
          cold[4] = (float)(it + 1);
          cold[5] = rp;
          cold[6] = rd;
          cold[7] = rho;
          cold[8] = newly ? 1.f : 0.f;
          cold[9] = (newly && !certified) ? 1.f : 0.f;
        }
        done = true;
      } else if (prm.adaptive_rho) {
        const bool inc = rp > prm.mu_thresh * rd;
        const bool dec = !inc && (rd > prm.mu_thresh * rp);
        // cpt (the per-problem gate's count, unused under rho_sync): read
        // from this iteration's slot, the next one's written by lane 0, so
        // that no lane reads a slot lane 0 writes in the same iteration
        int cpt = 0;
        if (!prm.rho_sync) {
          cpt = (int)cold[(it & 1) ? 10 : 3];
          if (r == 0) cold[(it & 1) ? 3 : 10] = (float)(cpt + (inc || dec));
        }
        const bool gate = prm.rho_sync
                              ? (it % prm.rho_update_period == 0 && it > 0)
                              : (cpt % prm.rho_update_period == 0);
        const bool app_inc = gate && inc, app_dec = gate && dec;
        if (app_inc || app_dec) {
          float tau_inc = cold[0], tau_dec = cold[1];
          const float rho_up = cold[2];
          __syncwarp(seg_mask);   // every lane of the segment read them before lane 0 writes
          const bool flip_inc = app_inc && rho_up == -1.f;
          const bool flip_dec = app_dec && rho_up == 1.f;
          const float damped_inc = 1.f + prm.damp * (tau_inc - 1.f);
          const float damped_dec = 1.f + prm.damp * (tau_dec - 1.f);
          if (prm.damp_both) {
            if (flip_inc || flip_dec) {
              tau_inc = damped_inc;
              tau_dec = damped_dec;
            }
          } else {
            if (flip_inc) tau_inc = damped_inc;
            if (flip_dec) tau_dec = damped_dec;
          }
          rho = app_inc ? rho * tau_inc : rho / tau_dec;
          if (r == 0) {
            cold[0] = tau_inc;
            cold[1] = tau_dec;
            cold[2] = app_inc ? 1.f : -1.f;
          }
          need = true;
        }
      }
    }
    if (__all_sync(dq::kFullMask, done)) break;
  }

  if (real) l2_out[(size_t)b * n + r] = l2;
  if (live && r == 0) {
    iters_out[b] = (int)cold[4];
    resp_out[b] = cold[5];
    resd_out[b] = cold[6];
    rho_out[b] = cold[7];
    conv_out[b] = cold[8] != 0.f;
    stall_out[b] = cold[9] != 0.f;
  }
}

// f(the one-warp instance that takes size n, its WarpK1); n <= 32.
template <typename F>
int with_warp_kernel(int n, F f) {
  if (n <= WarpQuad::kN) return f(admm_kernel_warp<WarpQuad>, WarpQuad{});
  if (n <= WarpPair::kN) return f(admm_kernel_warp<WarpPair>, WarpPair{});
  if (n <= Warp24::kN) return f(admm_kernel_warp<Warp24>, Warp24{});
  return f(admm_kernel_warp<Warp32>, Warp32{});
}

// ---------------------------------------------------------------------------
// Past one warp with X's row in registers (admm_kernel_rows): one problem a
// block of kN threads, thread r owning row r of it.
// ---------------------------------------------------------------------------

// The block-wide register instances: kN = 32 ceil(n / 32) threads, every loop
// over columns unrolled to kN (n <= kN), at least kMinBlocks blocks an SM
// (the register cap of __launch_bounds__).
template <int N, int MinBlocks>
struct RowK1 {
  static constexpr int kN = N, kMinBlocks = MinBlocks;
  static constexpr int kLd = N + 2;          // P's row stride, as WarpK1's
  // floats of scratch: a solve's three published vectors (4 kN), or two
  // buffers of the Gauss-Jordan steps' kN published float4 columns and four
  // pivots, taken by the passes in turn (2 (4 kN + 4))
  static constexpr int kScratch = 8 * N + 8;
  // floats before P: the scratch, block_reduce's slots, the prox's arguments
  // and q by row (4 kN: values read once an iteration or less, kept out of
  // registers) and a thread's l2, u, q_prox and rho, parked while an
  // inverse is formed (4 kN); P's plane after them starts on 16 bytes
  static constexpr int kHead = kScratch + 4 * kMaxWarps + 8 * N;
  static constexpr int kPlane = N * kLd;   // P, zero past row and column n
  static_assert(N % 32 == 0 && N > 32 && N <= 32 * kMaxWarps, "whole warps, past one");
};
using Rows64 = RowK1<64, 8>;     // 33 <= n <= 64
using Rows96 = RowK1<96, 4>;     // 65 <= n <= 96: config 6
using Rows128 = RowK1<128, 2>;   // 97 <= n <= 128
constexpr int kRowsMaxN = 128;   // above, the two-plane admm_kernel

// (P v)_r from thread r's row of P in registers (the set-up), v published in
// the scratch and read back as float4 broadcasts: matvec's one chain over
// the columns in order, the first a product.
template <int N>
__device__ __forceinline__ float matvec_rows(const float (&p)[N], float v, int r, int n_in,
                                             bool real, float* s) {
  int n;   // opaque: the column tests are made here, not kept through the power iteration
  asm volatile("mov.b32 %0, %1;" : "=r"(n) : "r"(n_in));
  s[r] = v;
  __syncthreads();
  const float4* v4 = reinterpret_cast<const float4*>(s);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    if (c < n) {
      const float4 w = v4[c >> 2];
      acc = c == 0 ? p[0] * w.x : fmaf(p[c], w.x, acc);
      if (c + 1 < n) acc = fmaf(p[c + 1], w.y, acc);
      if (c + 2 < n) acc = fmaf(p[c + 2], w.z, acc);
      if (c + 3 < n) acc = fmaf(p[c + 3], w.w, acc);
    }
  }
  __syncthreads();
  return real ? acc : 0.f;
}

// refined_solve with thread r's row of X in registers (refined_solve_w's
// arithmetic): the three published vectors in the scratch, zero past n,
// read as float4 (X rhs, X res) and double2 (P l0) broadcasts, one barrier
// each. Returns 0 past n.
template <int N>
__device__ __forceinline__ float refined_solve_rows(const float (&x)[N],
                                                    const float* __restrict__ prow, float rhs,
                                                    float shift, int r_in, bool real, float* s) {
  int r;   // opaque, as in refined_solve_w
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(r_in));
  float* x0 = s;
  float* x2 = s + N;
  double* x1 = reinterpret_cast<double*>(s + 2 * N);
  x0[r] = real ? rhs : 0.f;
  __syncthreads();
  const float l0 = dot_reg<N>(x, x0);
  x1[r] = real ? (double)l0 : 0.;
  __syncthreads();
  const double acc = dot_p64<N>(prow, x1) + (double)shift * (double)l0;
  x2[r] = real ? (float)((double)rhs - acc) : 0.f;
  __syncthreads();
  return real ? l0 + dot_reg<N>(x, x2) : 0.f;
}

// gj_inverse with thread r's row in registers (gj_inverse_w's steps, passes
// and roundings for a whole block): x <- row r of (P + shift I)^{-1} on the
// threads that hold a row. Only the published columns (w4) and pivots go
// through the scratch; a pass is kN float4 broadcasts and 4 kN multiply-adds
// a thread, with no load or store of the row. The threads past n publish
// zero columns and keep their x (zero), so a pass runs over all kN entries.
// The passes take the scratch's two buffers in turn, so that a pass needs no
// barrier of its own: the next pass writes the other buffer, and the one
// after it this buffer only once every thread has passed the next pass's
// first step. The passes are a loop, not unrolled: unrolled at kN = 96 they
// are ~200 KB of code, which blocks at different stages evict from the
// instruction cache, and the iteration spills around the inverse's calls (a
// jump on the pass index in place of the selects below spills as well). So
// a pass's four columns are read out of the row by a select on the pass
// index, and written back by a select in its loop.
template <int N>
__device__ __forceinline__ void gj_inverse_rows(float (&x)[N], const float* __restrict__ prow,
                                                float shift, int r_in, int n, float* s) {
  int r;   // opaque, as in gj_inverse_w
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(r_in));
  const bool real = r < n;
  if (real) {
    const float2* p2 = reinterpret_cast<const float2*>(prow);
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 p = p2[c >> 1];
      x[c] = p.x + (c == r ? shift : 0.f);
      x[c + 1] = p.y + (c + 1 == r ? shift : 0.f);
    }
  }
  __syncthreads();   // the scratch held a solve's published vectors
  constexpr int kBuf = 4 * N + 4;   // floats of one buffer: N float4 columns, then the pivots
  if (!real) {
    reinterpret_cast<float4*>(s)[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(s + kBuf)[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 1
  for (int c0 = 0; c0 < n; c0 += kGJ) {
    float4* w4 = reinterpret_cast<float4*>(s + ((c0 / kGJ) & 1) * kBuf);
    float* piv = reinterpret_cast<float*>(w4 + N);
    const int kb = min(kGJ, n - c0);
    float v[kGJ], g[kGJ];
#pragma unroll
    for (int t = 0; t < kGJ; ++t) {
      v[t] = x[t];
      g[t] = 0.f;
    }
#pragma unroll
    for (int j = kGJ; j < N; j += kGJ) {
      if (j == c0) {
#pragma unroll
        for (int t = 0; t < kGJ; ++t) v[t] = x[j + t];
      }
    }
#pragma unroll
    for (int t = 0; t < kGJ; ++t) {
      if (t < kb) {
        const int c = c0 + t;
        if (real) {
          reinterpret_cast<float*>(w4 + r)[t] = (r == c) ? 1.f : (r < c ? -v[t] : v[t]);
          if (r == c) piv[t] = v[t];
        }
        __syncthreads();
        if (real) {
          const float pinv = __frcp_rn(fmaxf(piv[t], dq::kTiny));   // = 1 / p, rounded once
          const bool p = r == c;
          g[t] = p ? -pinv : v[t] * pinv;
          const float a = p ? 0.f : 1.f;
          if (!p) v[t] = 0.f;
#pragma unroll
          for (int u = 0; u < kGJ; ++u) {
            if (u < kb) {
              v[u] = fmaf(a, v[u], -(g[t] * reinterpret_cast<const float*>(w4 + c0 + u)[t]));
            }
          }
        }
      }
    }
    if (real) {
      // the pass's pivot row (r = c0 + tp) drops the steps before tp; the
      // pass's own columns took their updates in v
      const int tp = r - c0;
      const bool pivot = tp >= 0 && tp < kb;
#pragma unroll
      for (int t = 0; t < kGJ; ++t) {
        if (pivot && t < tp) g[t] = 0.f;
      }
      const float m = pivot ? 0.f : 1.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float4 w = w4[j];
        float y = x[j] * m;
        y = fmaf(-g[0], w.x, y);
        y = fmaf(-g[1], w.y, y);
        y = fmaf(-g[2], w.z, y);
        y = fmaf(-g[3], w.w, y);
        x[j] = (j - (j & 3)) == c0 && (j & 3) < kb ? v[j & 3] : y;
      }
    }
  }
  __syncthreads();   // the scratch is the next solve's
}

// K1 at 33 <= n <= kRowsMaxN: admm_kernel's algorithm, stopping rules and
// rounding, with the rows of P (in the set-up) and of X in registers. The
// block leaves its loop when its problem stops, and thread 0 writes the
// results then.
template <typename W>
__global__ void __launch_bounds__(W::kN, W::kMinBlocks)
admm_kernel_rows(const float* __restrict__ P, const float* __restrict__ q,
                 const float* __restrict__ ws, const float* __restrict__ pa,
                 const float* __restrict__ pb, const float* __restrict__ pc,
                 float* __restrict__ l2_out, int* __restrict__ iters_out,
                 float* __restrict__ resp_out, float* __restrict__ resd_out,
                 float* __restrict__ rho_out, uint8_t* __restrict__ conv_out,
                 uint8_t* __restrict__ stall_out, const AdmmParams prm) {
  constexpr int N = W::kN, LD = W::kLd;
  extern __shared__ __align__(16) float smem[];   // float4 and double views inside
  const int n = prm.n, nc = n / 2;
  const int r = threadIdx.x;
  const bool real = r < n;
  const dq::Blk k{r, n, LD, false, real};
  const size_t b = blockIdx.x;
  float* s = smem;                         // the scratch
  float* s_red = s + W::kScratch;          // 4 * kMaxWarps
  float* pargs = s_red + 4 * kMaxWarps;    // lo, hi, v_sign, q by row; lo is the disk's radius
  const auto arg = [&](int i) { return pargs[i * N + r]; };
  // the thread's loop state while an inverse is formed: volatile, so that it
  // is stored and loaded, and not live in registers through the passes
  volatile float* park = pargs + 4 * N;
  float* plane = smem + W::kHead;
  const float* prow = plane + r * LD;

  // P into shared memory, coalesced (in float4s where the rows are whole
  // float4s and P is 16-byte aligned), zero past row and column n
  {
    if (n < N) {
      for (int i = r; i < W::kPlane; i += N) plane[i] = 0.f;
      __syncthreads();
    }
    const float* Pb = P + b * n * n;
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0) {
      const int n4 = n >> 2;
      const float4* Pb4 = reinterpret_cast<const float4*>(Pb);
#pragma unroll 4
      for (int idx = r; idx < n * n4; idx += N) {
        const int i = idx / n4, j = (idx - i * n4) << 2;
        const float4 v = Pb4[idx];
        float2* d = reinterpret_cast<float2*>(plane + i * LD + j);
        d[0] = make_float2(v.x, v.y);
        d[1] = make_float2(v.z, v.w);
      }
    } else {
#pragma unroll 4
      for (int idx = r; idx < n * n; idx += N) {
        const int i = idx / n, j = idx - i * n;
        plane[i * LD + j] = Pb[idx];
      }
    }
  }
  const size_t vo = b * n + r;
  const float qv = real ? q[vo] : 0.f;
  float l2 = real ? ws[vo] : 0.f;
  if (real) pargs[3 * N + r] = qv;
  if (real && (prm.prox_kind == kBox || prm.prox_kind == kSignedBox)) {
    pargs[r] = pa[vo];
    pargs[N + r] = pb[vo];
    if (prm.prox_kind == kSignedBox) pargs[2 * N + r] = pc[vo];
  }
  if (prm.prox_kind == kDisk && r < 2 * nc) pargs[r] = pa[b * nc + (r >> 1)];
  __syncthreads();

  const float mu = prm.mu_prox;
  float x[N];           // P's row for the set-up, then X's
  load_row<N>(x, prow, real);

  // power iteration for L (fixed count), then rho0 and tau0
  float v = real ? prm.v0 : 0.f;
  for (int it = 0; it < prm.power_iters; ++it) {
    const float av = matvec_rows<N>(x, v, r, n, real, s);
    const float nrm = sqrtf(block_sum(k, av * av, s_red));
    v = av / fmaxf(nrm, dq::kTiny);
  }
  const float pv = matvec_rows<N>(x, v, r, n, real, s);
  const float L = fmaxf(block_sum(k, v * pv, s_red), mu);
  const float ratio = L / mu;
  float rho = sqrtf(mu * L) * (float)pow((double)ratio, (double)0.4f) * prm.rho0_scale;
  const float tau0 = (float)pow((double)ratio, (double)0.15f);

  // u0 = -(P ws + q) synthesises the dual warm start from the primal one
  float u = 0.f;
  if (prm.warm_start_dual) u = -(matvec_rows<N>(x, l2, r, n, real, s) + qv);

  if (prm.max_iter <= 0 && r == 0) {   // the results of a problem that never iterates
    iters_out[b] = 0;
    resp_out[b] = INFINITY;
    resd_out[b] = INFINITY;
    rho_out[b] = rho;
    conv_out[b] = 0;
    stall_out[b] = 0;
  }
  float qp = qv;
  float tau_inc = tau0, tau_dec = tau0;
  int rho_up = 0, cpt = 0;
  bool need = true;      // an inverse to form, at the top of the next iteration

  for (int it = 0; it < prm.max_iter; ++it) {
    // the first inverse, and a new one whenever rho changed: one call site,
    // so the unrolled passes are compiled once
    if (need) {
      park[r] = l2;
      park[N + r] = u;
      park[2 * N + r] = qp;
      park[3 * N + r] = rho;
      gj_inverse_rows<N>(x, prow, rho + mu, r, n, s);
      l2 = park[r];
      u = park[N + r];
      qp = park[2 * N + r];
      rho = park[3 * N + r];
      need = false;
    }
    const float rhs = rho * l2 - u - qp;
    const float l = refined_solve_rows<N>(x, prow, rhs, rho + mu, r, real, s);
    const Step st = admm_step(k, prm, l, (real ? pargs[3 * N + r] : 0.f) - mu * l, rho, arg,
                              l2, u, qp, s_red);
    // a problem that stops (or reaches max_iter) writes its results, with
    // the rho the residuals were computed with
    if (st.stop || it + 1 == prm.max_iter) {
      if (r == 0) {
        iters_out[b] = it + 1;
        resp_out[b] = st.rp;
        resd_out[b] = st.rd;
        rho_out[b] = rho;
        conv_out[b] = st.stop;
        stall_out[b] = st.stop && !st.certified;
      }
      break;
    }
    need = adapt_rho(prm, it, st, rho, tau_inc, tau_dec, rho_up, cpt);
  }

  if (real) l2_out[vo] = l2;
}

// f(the register instance that takes size n, its RowK1); 33 <= n <= kRowsMaxN.
template <typename F>
int with_rows_kernel(int n, F f) {
  if (n <= Rows64::kN) return f(admm_kernel_rows<Rows64>, Rows64{});
  if (n <= Rows96::kN) return f(admm_kernel_rows<Rows96>, Rows96{});
  return f(admm_kernel_rows<Rows128>, Rows128{});
}

// Opt a block-wide kernel into smem bytes of dynamic shared memory where that
// is above the default 48 KB; a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// f(the kernel that takes size n) for a size past one warp.
template <typename F>
int with_block_kernel(int n, F f) {
  if (n <= kRowsMaxN) return with_rows_kernel(n, [&](auto kernel, auto) { return f(kernel); });
  return f(admm_kernel);
}

}  // namespace

extern "C" {

// The launch at size n: the instance (the kN of its one-warp or register
// instance; 0 for the two-plane block-wide kernel), the problems a block,
// threads a block and dynamic shared memory a block
// (kernels/admm_cuda.py::launch_plan computes the same). Returns 0, or 1
// where n < 1.
int dq_admm_plan(int n, int* instance, int* problems, int* threads, long long* smem) {
  if (n <= kOneWarpMaxN) {
    with_warp_kernel(n, [&](auto, auto w) {
      using W = decltype(w);
      *instance = W::kN;
      *problems = W::kG;
      *threads = 32;
      *smem = (long long)(sizeof(float) * W::kG * (W::kSeg + W::kPlane));
      return 0;
    });
  } else if (n <= kRowsMaxN) {
    with_rows_kernel(n, [&](auto, auto w) {
      using W = decltype(w);
      *instance = W::kN;
      *problems = 1;
      *threads = W::kN;
      *smem = (long long)(sizeof(float) * (W::kHead + W::kPlane));
      return 0;
    });
  } else {
    *instance = 0;
    *problems = 1;
    *threads = 32 * ((n + 31) / 32);
    *smem = (long long)smem_bytes(n);
  }
  return n < 1 ? 1 : 0;
}

// Blocks of K1 that one SM holds at size n (of its one-warp instance at n <=
// 32: each holds the plan's problems), from the occupancy calculator after
// the launch's shared-memory attribute is set; a negated CUDA error code on
// failure.
int dq_admm_blocks_per_sm(int n) {
  int instance, problems, threads;
  long long smem;
  dq_admm_plan(n, &instance, &problems, &threads, &smem);
  int blocks = 0;
  auto occupancy = [&](auto kernel) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                              (size_t)smem);
  };
  int e;
  if (n <= kOneWarpMaxN) {
    e = with_warp_kernel(n, [&](auto kernel, auto) { return occupancy(kernel); });
  } else {
    e = with_block_kernel(n, [&](auto kernel) {
      const int a = allow_smem(kernel, (size_t)smem);
      return a != 0 ? a : occupancy(kernel);
    });
  }
  return e != 0 ? -e : blocks;
}

// Launch K1 on `stream` for B problems of size prm->n: ceil(B / kG) blocks
// of the one-warp instance at n <= 32, else B blocks of the block-wide
// kernel that takes n. All pointers are device pointers to contiguous
// float32 (uint8 for the two flags, int32 for the iteration counts)
// allocated by the caller. Returns cudaGetLastError().
int dq_admm_solve_f32(const float* P, const float* q, const float* ws,
                      const float* pa, const float* pb, const float* pc,
                      float* l2_out, int* iters_out, float* resp_out,
                      float* resd_out, float* rho_out, uint8_t* conv_out,
                      uint8_t* stall_out, int B, const AdmmParams* prm,
                      void* stream) {
  const int n = prm->n;
  int instance, problems, threads;
  long long smem;
  dq_admm_plan(n, &instance, &problems, &threads, &smem);
  if (n <= kOneWarpMaxN) {
    if (B > 0) {
      with_warp_kernel(n, [&](auto kernel, auto) {
        kernel<<<(B + problems - 1) / problems, threads, (size_t)smem, (cudaStream_t)stream>>>(
            P, q, ws, pa, pb, pc, l2_out, iters_out, resp_out, resd_out, rho_out, conv_out,
            stall_out, B, *prm);
        return 0;
      });
    }
    return (int)cudaGetLastError();
  }
  const int a = with_block_kernel(n, [&](auto kernel) {
    const int e = allow_smem(kernel, (size_t)smem);
    if (e == 0 && B > 0) {
      kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
          P, q, ws, pa, pb, pc, l2_out, iters_out, resp_out, resd_out, rho_out, conv_out,
          stall_out, *prm);
    }
    return e;
  });
  if (a != 0) return a;
  return (int)cudaGetLastError();
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

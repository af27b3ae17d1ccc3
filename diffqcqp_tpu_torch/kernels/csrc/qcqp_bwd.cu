// QCQP backward kernels, one launch for a whole batch: K2 (fused, with the
// dual recovery) and K6 (the Schur adjoint with the duals given).
//
// K2 replaces diffqcqp_tpu/kernels/qcqp_bwd_pallas.py::_qcqp_bwd_fused_kernel
// with its core _schur_core (wrapper qcqp_kkt_bwd_fused). Per problem, with
// contact c owning rows 2c and 2c+1 (reference order) and radius r_c:
//   1. Pl + q;
//   2. the duals in closed form: gamma_c = act * max(-2 <l_c, (Pl+q)_c>, 0) /
//      max(4 |l_c|^2, 1e-30), act = (r - |l_c| <= eps) & (r >= eps);
//   3. the strict mask am = (s > -s_tol) & (r > act_eps) & (gamma > act_eps),
//      s = |l_c|^2 - r^2, s_tol = max(act_eps, stall_ulps (|l_c|^2 + r^2));
//   4. the LDL^T factor of D = P + blockdiag(2 gamma_c I_2), with the RAW
//      gamma (only the recovery mask), as the TPU kernel builds it;
//   5. W = D^{-1} [g | C], column c of C = 2 l_c * am_c on contact c's rows,
//      its forward sweep starting at row 2c (its first non-zero);
//   6. M = Sigma - C^T W_C diag(gamma am), Sigma = s am + (1 - am), and
//      y = -C^T W_g;
//   7. M dgamma = y by unpivoted Householder QR, then dgamma *= am;
//   8. dl = W_g - W_C (gamma am dgamma).
// Outputs dgamma (B, nc), dl (B, n) and the raw gamma (B, nc).
//
// K6 replaces qcqp_bwd_pallas.py::_qcqp_bwd_kernel -> _schur_core (wrapper
// qcqp_kkt_bwd_pallas): steps 4-8 alone, with the raw gamma, the squared
// slacks s and the strict mask am (0 or 1) loaded from the caller in place
// of steps 1-3. It is diff/kkt.py::_qcqp_schur_vjp's solve. Outputs dgamma
// (B, nc) and dl (B, n). Both kernels call one __device__ function for steps
// 4-8 (schur_core below, or schur_core_mw above one warp), so they share
// every operation of the solve.
//
// Two paths, split at n = 32 (one warp):
//
// One warp, n <= 32 (the flagship N = 24): one 32-thread block per
// problem, lane r owning coordinate row r; a contact's two rows sit on
// neighbouring lanes, so every per-contact quantity (the duals, the mask,
// C^T z) is one __shfl_xor with the partner lane. What bounds it: not the
// bytes (~11.6 MB at B = 4096, ~3.5 us at 3.35 TB/s) or the FLOPs (~19
// kFLOP per problem) but each problem's dependent chain and the issue slots
// of its loads, with one warp a problem and so few warps an SM to hide
// either. The first design held P and its factor in two shared
// planes and W in a third (7,348 B: 27 blocks an SM, two waves at B =
// 4096), read two shared words per FMA of its left-looking factor and ran
// the nc + 1 solves one after another (~505 dependent shuffle steps at n =
// 24). Now (ldl.cuh's register forms):
//   * each lane loads its row of P into registers (through the shared
//     plane, coalesced) and the factor of D runs right-looking on them, the
//     pivot column published once a step and read four entries a load; the
//     factor Lh is written in place into the same plane (P is dead once P l
//     + q is taken);
//   * W = D^{-1} [g | C] is one pair of sweeps for all nc + 1 right-hand
//     sides, 2n + 1 steps, each lane's row of W staying in registers (steps
//     6 and 8 read only their own row), so no W plane;
//   * the QR is qr.cuh's qr_solve_warp: lane j holds column j of [M | y]
//     in registers, each reflector is computed once by its lane and
//     published once;
//   * 3,604 B of shared memory at n = 24 and __launch_bounds__(32, 32): 32
//     blocks an SM, B = 4096 in one wave on 132 SMs.
// Two instances unroll the register loops to n <= 24 and n <= 32.
//
// Block-wide, n > 32 (K6's N = 96): 256 threads per problem. There the
// thread-per-row design ran on barriers (every broadcast of its 49 solves a
// __syncthreads, ~7,400 per problem) and on too little memory (P and its
// factor in two planes, ~105 KB: two blocks, six warps an SM). Now:
//   * P is factored in place, one n x (n | 1) plane (P is dead after K2's
//     P l + q): ~67 KB at N = 96, so three blocks and 24 warps share an SM;
//   * the factor is ldl.cuh's chol_factor_tiles, right-looking over a 16 x
//     16 grid of register tiles, one barrier per column;
//   * W = D^-1 [g | C] is one pair of sweeps over all nc + 1 right-hand
//     sides (ldl.cuh's ldl_solve_tiles), 2n + 1 barriers, 8 FMAs per shared
//     load of the factor;
//   * steps 6 and 8 spread over the block's threads;
//   * the QR is qr.cuh's qr_solve_lanes, 4 lanes per column (2 above n =
//     96), each reflector computed once.
// Two instances, picked by n: up to n = 96 (three blocks an SM) and up to
// n = 150 (larger tiles, one block an SM); dq_qcqp_bwd_plan gives each
// launch's geometry. At N = 96 the operations lead the bytes (~1.1 MFLOP
// per problem, ~0.03 ms for B = 2048 against ~0.02 ms of bytes); what
// bounds the kernel is still the ~4n + nc steps per problem, each behind a
// barrier, and the issue slots of the tiles' loads and FMAs.
//
// What differs from the TPU kernels and why it does not change the result:
// the TPU permutes coordinates (contact c on rows c, nc + c) so a contact's
// rows are sublane slices, and starts column c's sweep at row c; here the
// reference order keeps a contact on two neighbouring rows and its sweep
// starts at row 0, subtracting exact zeros before 2c. The TPU's QR takes
// column dot products over the rows of M (thread-per-row reductions); here
// a group of lanes sums a column. These change the order of float32
// operations only.
//
// ptxas (sm_90a): one warp, K2 and K6 64 registers each (the 32-blocks
// bound; 48 and 47 in the first design), 12 bytes of spill each at n <= 24,
// 24 and 84 bytes at n <= 32; block-wide, n <= 96, 80 registers (the
// three-blocks bound), one of the two with 20 bytes of spill; n <= 150,
// 187-190 registers, no spill.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ldl.cuh"
#include "qr.cuh"

namespace {

// ---------------------------------------------------------------------------
// One warp, n <= 32: one problem per 32-thread block, lane r owning row r.
// ---------------------------------------------------------------------------

// The one-warp path's two instances: loops unrolled to kN rows (n <= kN)
// and kNC = kN / 2 + 1 right-hand sides.
template <int N>
struct Warp {
  static constexpr int kN = N, kNC = N / 2 + 1;
};
using WarpSmall = Warp<24>;   // n <= 24, the flagship
using WarpLarge = Warp<32>;   // n <= 32

// One problem's dynamic shared memory at one warp, laid out the same for K2
// and K6; s_pub and s_x first, so that both are 16-byte aligned.
struct SmemW {
  float* s_pub;  // 2 x 32: what a step of the factor, the sweeps or the QR publishes
  float* s_x;    // 32: l, broadcast for P l (K2)
  float* sA;     // n x ld: P row-major, then the factor Lh column-major, in place
  float* sM;     // (nc + 1) columns of ldm: [M | y]
  float* s_gam;  // nc: gamma * am
  float* s_am;   // nc: am as 0 / 1
  float* s_dg;   // nc: dgamma before the mask
};

__device__ SmemW carve_w(float* smem, int n) {
  const int ld = n | 1, nc = n / 2, ldm = nc | 1;
  SmemW s;
  s.s_pub = smem;
  s.s_x = s.s_pub + 2 * dq::kPubStride;
  s.sA = s.s_x + 32;
  s.sM = s.sA + n * ld;
  s.s_gam = s.sM + (nc + 1) * ldm;
  s.s_am = s.s_gam + nc;
  s.s_dg = s.s_am + nc;
  return s;
}

// Problem b's P through sA (coalesced loads) into lane r's registers: a[k] =
// P[r][k] for r, k < n, zeros elsewhere. sA is free again on return.
template <int N>
__device__ void load_row(const SmemW& sm, int n, int r, const float* __restrict__ P, size_t b,
                         float (&a)[N]) {
  const int ld = n | 1;
  const float* Pb = P + b * n * n;
  if (r < n) {
    for (int i = 0; i < n; ++i) sm.sA[i * ld + r] = Pb[i * n + r];   // row i, coalesced
  }
  __syncwarp();
  const float* row = sm.sA + min(r, n - 1) * ld;
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = (r < n && k < n) ? row[k] : 0.f;
  __syncwarp();
}

// Steps 4-8 for lane r (contact r >> 1). On entry a[] holds row r of P and
// sm.s_gam / sm.s_am hold gamma am and am per contact (the factor's first
// __syncwarp publishes them). Per lane: gam_raw, the raw gamma of its
// contact (D's shift), its l and g, and its contact's am and sigma = s am +
// (1 - am). Writes dl_b[r] (r < n) and dgamma_b[c] (c < nc), problem b's
// rows of the outputs.
template <typename T>
__device__ void schur_core_w(const SmemW& sm, int n, int r, float (&a)[T::kN], float gam_raw,
                             float lv, float gv, float amf, float sigma, float* __restrict__ dl_b,
                             float* __restrict__ dgamma_b) {
  const int ld = n | 1, nc = n / 2, ldm = nc | 1;
  const int cown = r >> 1;
  const bool odd = r & 1, real = r < n;

  // 4. D = P + diag(2 gamma_raw), factored in place in sA
#pragma unroll
  for (int k = 0; k < T::kN; ++k) {
    if (k == r) a[k] = a[k] + 2.f * gam_raw;
  }
  const float dinv = dq::chol_factor_warp<T::kN>(a, n, r, sm.sA, ld, sm.s_pub);

  // 5. W = D^{-1} [g | C], all nc + 1 columns in one pair of sweeps; lane r
  // keeps its row of W in x[]
  float x[T::kNC];
  x[0] = real ? gv : 0.f;
#pragma unroll
  for (int c = 0; c + 1 < T::kNC; ++c) x[c + 1] = (real && cown == c) ? 2.f * lv * amf : 0.f;
  dq::ldl_solve_warp<T::kNC>(sm.sA, n, ld, r, dinv, x, sm.s_pub);

  // 6. column c < nc of M from W's column c + 1, column nc (= y) from W_g;
  // (C^T z)_i = 2 (l_2i z_2i + l_2i+1 z_2i+1) am_i, summed by the lane pair
#pragma unroll
  for (int c = 0; c < T::kNC; ++c) {
    if (c <= nc) {
      const float wv = c == nc ? x[0] : x[c + 1 < T::kNC ? c + 1 : 0];
      const float t = real ? lv * wv : 0.f;
      const float tp = __shfl_xor_sync(dq::kFullMask, t, 1);
      const float ct = 2.f * (odd ? tp + t : t + tp) * amf;
      if (real && !odd) {
        sm.sM[c * ldm + cown] =
            (c == nc) ? -ct : ((cown == c) ? sigma : 0.f) - ct * sm.s_gam[c < nc ? c : 0];
      }
    }
  }
  __syncwarp();

  // 7. Householder QR of M applied to y in registers, lane j owning column j
  dq::qr_solve_warp<T::kN / 2>(sm.sM, nc, ldm, sm.s_dg, sm.s_pub);

  // 8. dl = W_g - W_C (gamma am dgamma am)
  if (real) {
    float dl = x[0];
#pragma unroll
    for (int c = 0; c + 1 < T::kNC; ++c) {
      if (c < nc) dl = dl - x[c + 1] * (sm.s_gam[c] * (sm.s_dg[c] * sm.s_am[c]));
    }
    dl_b[r] = dl;
  }
  if (r < nc) dgamma_b[r] = sm.s_dg[r] * sm.s_am[r];
}

// 32 blocks (one warp each) an SM: at most 64 registers a thread
template <typename T>
__global__ void __launch_bounds__(32, 32)
qcqp_bwd_kernel(const float* __restrict__ P, const float* __restrict__ q,
                const float* __restrict__ l, const float* __restrict__ g,
                const float* __restrict__ radius, float* __restrict__ dgamma_out,
                float* __restrict__ dl_out, float* __restrict__ gamma_out, int n,
                float eps, float act_eps, float stall_ulps) {
  extern __shared__ float4 smem_w[];
  const int nc = n / 2;
  const SmemW sm = carve_w(reinterpret_cast<float*>(smem_w), n);
  const int r = threadIdx.x;
  const bool real = r < n;
  const size_t b = blockIdx.x;

  const size_t vo = b * n + r;
  const int cown = r >> 1;                // this row's contact
  const bool odd = r & 1;
  const float lv = real ? l[vo] : 0.f;
  const float gv = real ? g[vo] : 0.f;
  const float rad = real ? radius[b * nc + cown] : 0.f;
  sm.s_x[r] = lv;
  float a[T::kN];
  load_row<T::kN>(sm, n, r, P, b, a);     // its __syncwarp publishes s_x too

  // 1. P l + q, accumulated from q over the columns in order
  float plq = real ? q[vo] : 0.f;
#pragma unroll
  for (int k = 0; k < T::kN; k += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(sm.s_x + k);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e < n) plq = __fadd_rn(plq, __fmul_rn(a[k + e], xv[e]));
    }
  }

  // 2-3. per-contact duals and mask; (la, lb) are the even and odd rows'
  // values on both lanes of the pair, so both compute the same bits. Steps
  // 1-3 round each product and sum on its own (__fmul_rn / __fadd_rn: no
  // fused multiply-add), as the plain version's torch ops do, so the two
  // classify the contacts alike: a binding contact's slack r - |l_c| sits
  // within an ulp of the activity eps, where one rounding decides
  const float lp = __shfl_xor_sync(dq::kFullMask, lv, 1);
  const float pp = __shfl_xor_sync(dq::kFullMask, plq, 1);
  const float la = odd ? lp : lv, lb = odd ? lv : lp;
  const float pa = odd ? pp : plq, pb = odd ? plq : pp;
  const float sq = __fadd_rn(__fmul_rn(la, la), __fmul_rn(lb, lb));
  const bool act = (rad - sqrtf(sq) <= eps) && (rad >= eps);
  const float num = fmaxf(-2.f * __fadd_rn(__fmul_rn(la, pa), __fmul_rn(lb, pb)), 0.f);
  const float gam_raw = act ? num / fmaxf(4.f * sq, dq::kTiny) : 0.f;
  const float rr = rad * rad;
  const float s = sq - rr;
  const float s_tol = fmaxf(act_eps, stall_ulps * (sq + rr));
  const bool am = real && (s > -s_tol) && (rad > act_eps) && (gam_raw > act_eps);
  const float amf = am ? 1.f : 0.f;
  const float sigma = am ? s : 1.f;       // s am + (1 - am)
  if (real && !odd) {
    sm.s_gam[cown] = gam_raw * amf;
    sm.s_am[cown] = amf;
    gamma_out[b * nc + cown] = gam_raw;
  }

  // 4-8.
  schur_core_w<T>(sm, n, r, a, gam_raw, lv, gv, amf, sigma, dl_out + b * n, dgamma_out + b * nc);
}

template <typename T>
__global__ void __launch_bounds__(32, 32)
qcqp_schur_kernel(const float* __restrict__ P, const float* __restrict__ l,
                  const float* __restrict__ g, const float* __restrict__ gamma,
                  const float* __restrict__ s, const float* __restrict__ am,
                  float* __restrict__ dgamma_out, float* __restrict__ dl_out, int n) {
  extern __shared__ float4 smem_w[];
  const int nc = n / 2;
  const SmemW sm = carve_w(reinterpret_cast<float*>(smem_w), n);
  const int r = threadIdx.x;
  const bool real = r < n;
  const size_t b = blockIdx.x;

  const size_t vo = b * n + r;
  const size_t co = b * nc + (r >> 1);    // this row's contact
  const float lv = real ? l[vo] : 0.f;
  const float gv = real ? g[vo] : 0.f;
  const float gam_raw = real ? gamma[co] : 0.f;
  const float amf = real ? am[co] : 0.f;
  const float sigma = (real ? s[co] : 0.f) * amf + (1.f - amf);
  if (real && !(r & 1)) {
    sm.s_gam[r >> 1] = gam_raw * amf;
    sm.s_am[r >> 1] = amf;
  }
  float a[T::kN];
  load_row<T::kN>(sm, n, r, P, b, a);

  schur_core_w<T>(sm, n, r, a, gam_raw, lv, gv, amf, sigma, dl_out + b * n, dgamma_out + b * nc);
}

// ---------------------------------------------------------------------------
// Above one warp (n > 32): the block-wide path, 256 threads per problem.
// ---------------------------------------------------------------------------

constexpr int kOneWarpMaxN = 32;   // n <= 32: one warp, the kernels above
constexpr int kMwThreads = 256;    // n > 32: eight warps per problem
constexpr int kMwMaxN = 150;       // the largest n the block-wide path's register tiles take

// The block-wide path's two instances: register tile rows of the sweeps
// (NR), row and column blocks of the factor (NF: n <= 16 NF), the QR's
// lanes per column (QG: QG (nc + 1) <= 256) and row chunks of 32 of its back
// substitution (QC: nc <= 32 QC). Small: n <= 96, three blocks an SM;
// large: n <= 150, one.
template <int NR, int NF, int QG, int QC>
struct Tiles {
  static constexpr int kNR = NR, kNF = NF, kQG = QG, kQC = QC;
  static constexpr int kMinBlocks = NR <= 3 ? 3 : 1;
};
using SmallTiles = Tiles<3, 6, 4, 2>;
using LargeTiles = Tiles<6, 10, 2, 3>;

// One problem's dynamic shared memory on the block-wide path.
struct SmemMW {
  float* sA;     // n x ld, column-major: P, then D, then Lh in place
  float* sX;     // (nc + 1) columns of ldx = n + 1: [g | C], then W = D^-1 [g | C]
  float* sM;     // (nc + 1) columns of ldm: [M | y]
  float* s_x;    // n: l
  float* s_rd;   // n: 1 / L_rr
  float* s_gam;  // nc: gamma * am
  float* s_am;   // nc: am as 0 / 1
  float* s_sig;  // nc: sigma = s am + (1 - am)
  float* s_dg;   // nc: beta per QR step, then dgamma before the mask
  float* s_col;  // 2 n: the factor's published columns
  float* s_rs;   // 2: the factor's published 1 / sqrt(pivot)
  float* s_ref;  // 4: the QR's (beta, v_k) slots
};

__device__ SmemMW carve_mw(float* smem, int n) {
  const int ld = n | 1, nc = n / 2, ldm = nc | 1;
  SmemMW s;
  s.sA = smem;
  s.sX = s.sA + n * ld;
  s.sM = s.sX + (nc + 1) * (n + 1);
  s.s_x = s.sM + (nc + 1) * ldm;
  s.s_rd = s.s_x + n;
  s.s_gam = s.s_rd + n;
  s.s_am = s.s_gam + nc;
  s.s_sig = s.s_am + nc;
  s.s_dg = s.s_sig + nc;
  s.s_col = s.s_dg + nc;
  s.s_rs = s.s_col + 2 * n;
  s.s_ref = s.s_rs + 2;
  return s;
}

// Problem b's P (transposed into column-major sA), l (into s_x) and g (into
// column 0 of sX); the columns of C zeroed, for the caller to fill after the
// next barrier.
__device__ void load_mw(const SmemMW& sm, int n, const float* __restrict__ P,
                        const float* __restrict__ l, const float* __restrict__ g, size_t b) {
  const int ld = n | 1, ldx = n + 1, nc = n / 2;
  const float* Pb = P + b * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    sm.sA[(idx - i * n) * ld + i] = Pb[idx];   // P[i][j] into column j
  }
  for (int idx = ldx + threadIdx.x; idx < (nc + 1) * ldx; idx += blockDim.x) sm.sX[idx] = 0.f;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    sm.s_x[r] = l[b * n + r];
    sm.sX[r] = g[b * n + r];
  }
}

// Steps 4-8 with the whole block: on entry (after a barrier) sm.sA holds D
// = P + diag(2 gamma_raw) in its lower triangle, sX holds [g | C] and the
// per-contact slots are filled. Writes dl_b (n) and dgamma_b (nc).
template <typename T>
__device__ void schur_core_mw(const SmemMW& sm, int n, float* __restrict__ dl_b,
                              float* __restrict__ dgamma_b) {
  const int ld = n | 1, ldx = n + 1, nc = n / 2, ldm = nc | 1;
  const int t = threadIdx.x;

  // 4. the factor, in place; 5. W = D^{-1} [g | C], all columns at once
  dq::chol_factor_tiles<T::kNF>(sm.sA, n, ld, sm.s_rd, sm.s_col, sm.s_rs);
  dq::ldl_solve_tiles<T::kNR>(sm.sA, n, ld, sm.s_rd, sm.sX, ldx, nc + 1);

  // 6. M[i][c] = Sigma_ic - (C^T W_c+1)_i gamma_c am_c, y = -(C^T W_g);
  // (C^T z)_i = 2 (l_2i z_2i + l_2i+1 z_2i+1) am_i
  for (int idx = t; idx < nc * (nc + 1); idx += blockDim.x) {
    const int c = idx / nc, i = idx - c * nc;
    const float* wc = sm.sX + ((c == nc) ? 0 : c + 1) * ldx;
    const float t0 = sm.s_x[2 * i] * wc[2 * i];
    const float t1 = sm.s_x[2 * i + 1] * wc[2 * i + 1];
    const float ct = 2.f * (t0 + t1) * sm.s_am[i];
    sm.sM[c * ldm + i] =
        (c == nc) ? -ct : ((i == c) ? sm.s_sig[i] : 0.f) - ct * sm.s_gam[c];
  }
  __syncthreads();

  // 7. Householder QR of M applied to y, a thread per column, each
  // reflector computed once
  dq::qr_solve_lanes<T::kQG, T::kQC>(sm.sM, nc, ldm, sm.s_dg, sm.s_ref);

  // 8. dl = W_g - W_C (gamma am dgamma am)
  for (int r = t; r < n; r += blockDim.x) {
    float dl = sm.sX[r];
    for (int c = 0; c < nc; ++c) {
      dl = dl - sm.sX[(c + 1) * ldx + r] * (sm.s_gam[c] * (sm.s_dg[c] * sm.s_am[c]));
    }
    dl_b[r] = dl;
  }
  for (int c = t; c < nc; c += blockDim.x) dgamma_b[c] = sm.s_dg[c] * sm.s_am[c];
}

template <typename T>
__global__ void __launch_bounds__(kMwThreads, T::kMinBlocks)
qcqp_bwd_kernel_mw(const float* __restrict__ P, const float* __restrict__ q,
                   const float* __restrict__ l, const float* __restrict__ g,
                   const float* __restrict__ radius, float* __restrict__ dgamma_out,
                   float* __restrict__ dl_out, float* __restrict__ gamma_out, int n,
                   float eps, float act_eps, float stall_ulps) {
  extern __shared__ float smem[];
  const int ld = n | 1, ldx = n + 1, nc = n / 2;
  const SmemMW sm = carve_mw(smem, n);
  const int r = threadIdx.x;
  const bool real = r < n;
  const size_t b = blockIdx.x;

  load_mw(sm, n, P, l, g, b);
  const int cown = r >> 1;
  const bool odd = r & 1;
  const float rad = real ? radius[b * nc + cown] : 0.f;
  __syncthreads();

  // 1. P l + q, accumulated from q over the columns in order (row r of P is
  // column r of sA)
  const float lv = real ? sm.s_x[r] : 0.f;
  float plq = real ? q[b * n + r] : 0.f;
  if (real) {
    for (int c = 0; c < n; ++c) plq = __fadd_rn(plq, __fmul_rn(sm.sA[c * ld + r], sm.s_x[c]));
  }

  // 2-3. per-contact duals and mask, as the one-warp kernel computes them
  const float lp = __shfl_xor_sync(dq::kFullMask, lv, 1);
  const float pp = __shfl_xor_sync(dq::kFullMask, plq, 1);
  const float la = odd ? lp : lv, lb = odd ? lv : lp;
  const float pa = odd ? pp : plq, pb = odd ? plq : pp;
  const float sq = __fadd_rn(__fmul_rn(la, la), __fmul_rn(lb, lb));
  const bool act = (rad - sqrtf(sq) <= eps) && (rad >= eps);
  const float num = fmaxf(-2.f * __fadd_rn(__fmul_rn(la, pa), __fmul_rn(lb, pb)), 0.f);
  const float gam_raw = act ? num / fmaxf(4.f * sq, dq::kTiny) : 0.f;
  const float rr = rad * rad;
  const float s = sq - rr;
  const float s_tol = fmaxf(act_eps, stall_ulps * (sq + rr));
  const bool am = real && (s > -s_tol) && (rad > act_eps) && (gam_raw > act_eps);
  const float amf = am ? 1.f : 0.f;
  if (real) {
    sm.sA[r * ld + r] = sm.sA[r * ld + r] + 2.f * gam_raw;  // only this thread read P_rr
    sm.sX[(cown + 1) * ldx + r] = 2.f * lv * amf;
    if (!odd) {
      sm.s_gam[cown] = gam_raw * amf;
      sm.s_am[cown] = amf;
      sm.s_sig[cown] = am ? s : 1.f;
      gamma_out[b * nc + cown] = gam_raw;
    }
  }
  __syncthreads();

  schur_core_mw<T>(sm, n, dl_out + b * n, dgamma_out + b * nc);
}

template <typename T>
__global__ void __launch_bounds__(kMwThreads, T::kMinBlocks)
qcqp_schur_kernel_mw(const float* __restrict__ P, const float* __restrict__ l,
                     const float* __restrict__ g, const float* __restrict__ gamma,
                     const float* __restrict__ s, const float* __restrict__ am,
                     float* __restrict__ dgamma_out, float* __restrict__ dl_out, int n) {
  extern __shared__ float smem[];
  const int ld = n | 1, ldx = n + 1, nc = n / 2;
  const SmemMW sm = carve_mw(smem, n);
  const int r = threadIdx.x;
  const size_t b = blockIdx.x;

  load_mw(sm, n, P, l, g, b);
  __syncthreads();
  if (r < n) {
    const size_t co = b * nc + (r >> 1);    // this row's contact
    const float gam_raw = gamma[co];
    const float amf = am[co];
    sm.sA[r * ld + r] = sm.sA[r * ld + r] + 2.f * gam_raw;
    sm.sX[((r >> 1) + 1) * ldx + r] = 2.f * sm.s_x[r] * amf;
    if (!(r & 1)) {
      sm.s_gam[r >> 1] = gam_raw * amf;
      sm.s_am[r >> 1] = amf;
      sm.s_sig[r >> 1] = s[co] * amf + (1.f - amf);
    }
  }
  __syncthreads();

  schur_core_mw<T>(sm, n, dl_out + b * n, dgamma_out + b * nc);
}

// Dynamic shared memory one block needs for a problem of size n, for either
// kernel (the wrapper's launch_plan in kernels/qcqp_bwd_cuda.py computes the
// same): at n <= 32 the two 32-float publish slots and l (96 floats), P and
// its factor in one n x (n|1) plane, [M | y] and three nc-vectors; above, P and its factor in one plane, W with stride n + 1, [M | y],
// four n-vectors (two of them the factor's column buffers), four nc-vectors
// and six slots.
size_t smem_bytes(int n) {
  const size_t ld = n | 1, nc = n / 2, ldm = nc | 1;
  if (n <= kOneWarpMaxN) {
    return sizeof(float) * (3 * 32 + n * ld + (nc + 1) * ldm + 3 * nc);
  }
  return sizeof(float) * (n * ld + (nc + 1) * (n + 1) + (nc + 1) * ldm + 4 * n + 4 * nc + 6);
}

// Opt the kernel into smem bytes of dynamic shared memory where that is
// above the default 48 KB; returns a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem);
  if (e != 0) return e;
  // the whole of the SM's unified memory as shared memory, for blocks per SM
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

// Launch `kernel` on B blocks of `threads` with smem bytes; a CUDA error code.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int threads, size_t smem, void* stream, Args... args) {
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  if (B > 0) kernel<<<B, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// f(the instance of K6 (kSchur) or K2 that takes size n); n within the plan.
template <bool kSchur, typename F>
int with_kernel(int n, F f) {
  if constexpr (kSchur) {
    if (n <= WarpSmall::kN) return f(qcqp_schur_kernel<WarpSmall>);
    if (n <= kOneWarpMaxN) return f(qcqp_schur_kernel<WarpLarge>);
    if (n <= 96) return f(qcqp_schur_kernel_mw<SmallTiles>);
    return f(qcqp_schur_kernel_mw<LargeTiles>);
  } else {
    if (n <= WarpSmall::kN) return f(qcqp_bwd_kernel<WarpSmall>);
    if (n <= kOneWarpMaxN) return f(qcqp_bwd_kernel<WarpLarge>);
    if (n <= 96) return f(qcqp_bwd_kernel_mw<SmallTiles>);
    return f(qcqp_bwd_kernel_mw<LargeTiles>);
  }
}

}  // namespace

extern "C" {

// The launch of a problem of size n: threads per block, dynamic shared
// memory per block, the kernel's __launch_bounds__ and, above one warp, the
// register tile rows of its sweeps (0 at n <= 32; 3: SmallTiles, 6:
// LargeTiles). Returns 0, or 1 where n is past what the kernels take (an
// odd n, or n > kMwMaxN).
int dq_qcqp_bwd_plan(int n, int* threads, long long* smem, int* bound, int* rows) {
  *smem = (long long)smem_bytes(n);
  if (n <= kOneWarpMaxN) {
    *threads = 32;
    *bound = 32;
    *rows = 0;
  } else {
    *threads = kMwThreads;
    *bound = kMwThreads;
    *rows = n <= 96 ? SmallTiles::kNR : LargeTiles::kNR;
  }
  return (n < 2 || n % 2 || n > kMwMaxN) ? 1 : 0;
}

// Blocks of K6 (schur = 1) or K2 (schur = 0) that one SM holds at size n,
// from the occupancy calculator after the launch's attributes are set; -1
// where n is past the plan, or a negated CUDA error code.
int dq_qcqp_bwd_blocks_per_sm(int n, int schur) {
  int threads, bound, rows;
  long long smem;
  if (dq_qcqp_bwd_plan(n, &threads, &smem, &bound, &rows)) return -1;
  auto occ = [&](auto kernel) {
    const int e = allow_smem(kernel, smem);
    if (e != 0) return -e;
    int blocks = 0;
    const int e2 =
        (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    return e2 != 0 ? -e2 : blocks;
  };
  return schur ? with_kernel<true>(n, occ) : with_kernel<false>(n, occ);
}

// Launch K2 on `stream` for B problems of size n = 2 nc. All pointers are
// device pointers to contiguous float32 allocated by the caller. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an n past the plan.
int dq_qcqp_bwd_f32(const float* P, const float* q, const float* l, const float* g,
                    const float* radius, float* dgamma_out, float* dl_out,
                    float* gamma_out, int B, int n, float eps, float act_eps,
                    float stall_ulps, void* stream) {
  int threads, bound, rows;
  long long smem;
  if (dq_qcqp_bwd_plan(n, &threads, &smem, &bound, &rows)) return (int)cudaErrorInvalidValue;
  return with_kernel<false>(n, [&](auto kernel) {
    return launch(kernel, B, threads, smem, stream, P, q, l, g, radius, dgamma_out, dl_out,
                  gamma_out, n, eps, act_eps, stall_ulps);
  });
}

// Launch K6 on `stream` for B problems of size n = 2 nc: gamma, s and am are
// (B, nc), am holding 0 or 1. Same conventions as dq_qcqp_bwd_f32.
int dq_qcqp_schur_f32(const float* P, const float* l, const float* g, const float* gamma,
                      const float* s, const float* am, float* dgamma_out, float* dl_out,
                      int B, int n, void* stream) {
  int threads, bound, rows;
  long long smem;
  if (dq_qcqp_bwd_plan(n, &threads, &smem, &bound, &rows)) return (int)cudaErrorInvalidValue;
  return with_kernel<true>(n, [&](auto kernel) {
    return launch(kernel, B, threads, smem, stream, P, l, g, gamma, s, am, dgamma_out, dl_out, n);
  });
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

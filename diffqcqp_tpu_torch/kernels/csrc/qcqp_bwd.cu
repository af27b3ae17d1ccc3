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
// 4-8 (schur_core below), so they share every operation of the solve.
//
// Design: one thread block per problem, one thread per coordinate row, as in
// K1 (one warp at the flagship N = 24). P, the factor, W and [M | y] live in
// dynamic shared memory; the factor and the nc + 1 solves are the ldl.cuh
// helpers. A contact's two rows sit on neighbouring lanes, so every
// per-contact quantity (the duals, the mask, C^T z) is one __shfl_xor with
// the partner lane, and both lanes hold the same value.
//
// The QR is qr.cuh's qr_solve_cols on [M | y] stored column-major (odd
// stride ldm = nc | 1) with thread j owning column j, not row j: every
// thread computes each reflector itself, in the same order, so the control
// flow stays uniform with no reduction at all (see qr.cuh; K5 shares it).
//
// What differs from the TPU kernels and why it does not change the result:
// the TPU permutes coordinates (contact c on rows c, nc + c) so a contact's
// rows are sublane slices, and starts column c's sweep at row c; here the
// reference order keeps a contact on two neighbouring lanes and its sweep
// starts at row 2c. The TPU's QR takes column dot products over the rows of
// M (thread-per-row reductions); here each thread sums one column. These
// change the order of float32 operations only.
//
// What bounds it on this card: at B = 4096, N = 24 the bytes (P, q, l, g,
// radius in; dl, dgamma, gamma out: ~11.6 MB, ~3.5 us at 3.35 TB/s) and the
// operations (~19 kFLOP per problem, ~1.2 us at 67 TFLOP/s) are both small;
// what bounds a simple kernel is the dependent chain inside each problem:
// n Cholesky columns, nc + 1 solves of up to 2n + 1 broadcast-then-FMA steps
// each, and nc QR steps. As in K1 the design answers with occupancy (one warp
// and ~7 KB of shared memory per problem) rather than with parallelism
// inside a problem. At K6's N = 96 (B = 2048) the operations lead (~1.3
// MFLOP per problem, ~0.04 ms for the batch against ~0.02 ms of bytes), and
// the chain is longer: three warps, whose broadcasts each cost a barrier,
// and ~105 KB of shared memory, so two blocks share an SM.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ldl.cuh"
#include "qr.cuh"

namespace {

// One problem's dynamic shared memory, laid out the same for K2 and K6.
struct Smem {
  float* sP;     // n x ld, row-major
  float* sL;     // factor, column-major
  float* sW;     // (nc + 1) columns of n: W = D^-1 [g | C]
  float* sM;     // (nc + 1) columns of ldm: [M | y]
  float* s_x;    // n: l, broadcast for P l (K2)
  float* s_fwd;  // n: broadcast slots of the solves
  float* s_bwd;  // n
  float* s_piv;  // n: pivot broadcast slots of the factor
  float* s_rd;   // n: reciprocal diagonal
  float* s_gam;  // nc: gamma * am
  float* s_am;   // nc: am as 0 / 1
  float* s_dg;   // nc: dgamma before the mask
};

__device__ Smem carve(float* smem, int n) {
  const int ld = n | 1, nc = n / 2, ldm = nc | 1;
  Smem s;
  s.sP = smem;
  s.sL = s.sP + n * ld;
  s.sW = s.sL + n * ld;
  s.sM = s.sW + (nc + 1) * n;
  s.s_x = s.sM + (nc + 1) * ldm;
  s.s_fwd = s.s_x + n;
  s.s_bwd = s.s_fwd + n;
  s.s_piv = s.s_bwd + n;
  s.s_rd = s.s_piv + n;
  s.s_gam = s.s_rd + n;
  s.s_am = s.s_gam + nc;
  s.s_dg = s.s_am + nc;
  return s;
}

// Problem b's P from global memory into sm.sP (row-major, stride ld).
__device__ void load_P(const dq::Blk& k, const Smem& sm, const float* __restrict__ P,
                       size_t b) {
  const int n = k.n, ld = k.ld;
  const float* Pb = P + b * n * n;
  for (int idx = k.r; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    sm.sP[i * ld + (idx - i * n)] = Pb[idx];
  }
}

// Steps 4-8 for this thread's row r (contact r >> 1). On entry sm.sP holds
// P, and sm.s_gam / sm.s_am hold gamma am and am per contact (the factor's
// first barrier publishes them). Per thread: gam_raw, the raw gamma of its
// contact (D's shift), its l and g, and its contact's am and
// sigma = s am + (1 - am). Writes dl_b[r] (r < n) and dgamma_b[c] (c < nc),
// problem b's rows of the outputs.
__device__ void schur_core(const dq::Blk& k, const Smem& sm, float gam_raw, float lv,
                           float gv, float amf, float sigma, float* __restrict__ dl_b,
                           float* __restrict__ dgamma_b) {
  const int r = k.r, n = k.n, nc = n / 2, ldm = nc | 1;
  const int cown = r >> 1;
  const bool odd = r & 1;

  // 4. D = P + diag(2 gamma_raw): each thread passes its own row's shift
  const float dinv = dq::chol_factor(k, sm.sP, sm.sL, 2.f * gam_raw, sm.s_piv, sm.s_rd);

  // 5. W = D^{-1} [g | C]; only this thread reads its row of W again
  float w = dq::ldl_solve(k, sm.sL, dinv, gv, 0, sm.s_fwd, sm.s_bwd);
  if (k.real) sm.sW[r] = w;
  for (int c = 0; c < nc; ++c) {
    const float rhs = (cown == c) ? 2.f * lv * amf : 0.f;
    w = dq::ldl_solve(k, sm.sL, dinv, rhs, 2 * c, sm.s_fwd, sm.s_bwd);
    if (k.real) sm.sW[(c + 1) * n + r] = w;
  }

  // 6. column c < nc of M from W's column c + 1, column nc (= y) from W_g;
  // (C^T z)_i = 2 (l_2i z_2i + l_2i+1 z_2i+1) am_i, summed by the lane pair
  for (int c = 0; c <= nc; ++c) {
    const int wc = (c == nc) ? 0 : c + 1;
    const float t = k.real ? lv * sm.sW[wc * n + r] : 0.f;
    const float tp = __shfl_xor_sync(dq::kFullMask, t, 1);
    const float ct = 2.f * (odd ? tp + t : t + tp) * amf;
    if (k.real && !odd) {
      sm.sM[c * ldm + cown] =
          (c == nc) ? -ct : ((cown == c) ? sigma : 0.f) - ct * sm.s_gam[c];
    }
  }
  dq::bsync(k);

  // 7. Householder QR of M applied to y; thread j <= nc owns column j
  dq::qr_solve_cols(k, sm.sM, nc, ldm, sm.s_dg);

  // 8. dl = W_g - W_C (gamma am dgamma am)
  if (k.real) {
    float dl = sm.sW[r];
    for (int c = 0; c < nc; ++c) {
      dl = dl - sm.sW[(c + 1) * n + r] * (sm.s_gam[c] * (sm.s_dg[c] * sm.s_am[c]));
    }
    dl_b[r] = dl;
  }
  if (r < nc) dgamma_b[r] = sm.s_dg[r] * sm.s_am[r];
}

__global__ void __launch_bounds__(256)
qcqp_bwd_kernel(const float* __restrict__ P, const float* __restrict__ q,
                const float* __restrict__ l, const float* __restrict__ g,
                const float* __restrict__ radius, float* __restrict__ dgamma_out,
                float* __restrict__ dl_out, float* __restrict__ gamma_out, int n,
                float eps, float act_eps, float stall_ulps) {
  extern __shared__ float smem[];
  const int ld = n | 1, nc = n / 2;
  const Smem sm = carve(smem, n);

  const int r = threadIdx.x;
  const dq::Blk k{r, n, ld, blockDim.x == 32, r < n};
  const size_t b = blockIdx.x;

  load_P(k, sm, P, b);
  const size_t vo = b * n + r;
  const int cown = r >> 1;                // this row's contact
  const bool odd = r & 1;
  const float lv = k.real ? l[vo] : 0.f;
  const float gv = k.real ? g[vo] : 0.f;
  const float rad = k.real ? radius[b * nc + cown] : 0.f;
  if (k.real) sm.s_x[r] = lv;
  __syncthreads();

  // 1. P l + q, accumulated from q over the columns in order
  float plq = k.real ? q[vo] : 0.f;
  if (k.real) {
    const float* row = sm.sP + r * ld;
    for (int c = 0; c < n; ++c) plq = plq + row[c] * sm.s_x[c];
  }

  // 2-3. per-contact duals and mask; (la, lb) are the even and odd rows'
  // values on both lanes of the pair, so both compute the same bits
  const float lp = __shfl_xor_sync(dq::kFullMask, lv, 1);
  const float pp = __shfl_xor_sync(dq::kFullMask, plq, 1);
  const float la = odd ? lp : lv, lb = odd ? lv : lp;
  const float pa = odd ? pp : plq, pb = odd ? plq : pp;
  const float sq = la * la + lb * lb;
  const bool act = (rad - sqrtf(sq) <= eps) && (rad >= eps);
  const float num = fmaxf(-2.f * (la * pa + lb * pb), 0.f);
  const float gam_raw = act ? num / fmaxf(4.f * sq, dq::kTiny) : 0.f;
  const float rr = rad * rad;
  const float s = sq - rr;
  const float s_tol = fmaxf(act_eps, stall_ulps * (sq + rr));
  const bool am = k.real && (s > -s_tol) && (rad > act_eps) && (gam_raw > act_eps);
  const float amf = am ? 1.f : 0.f;
  const float sigma = am ? s : 1.f;       // s am + (1 - am)
  if (k.real && !odd) {
    sm.s_gam[cown] = gam_raw * amf;
    sm.s_am[cown] = amf;
  }

  // 4-8.
  schur_core(k, sm, gam_raw, lv, gv, amf, sigma, dl_out + b * n, dgamma_out + b * nc);
  if (k.real && !odd) gamma_out[b * nc + cown] = gam_raw;
}

__global__ void __launch_bounds__(256)
qcqp_schur_kernel(const float* __restrict__ P, const float* __restrict__ l,
                  const float* __restrict__ g, const float* __restrict__ gamma,
                  const float* __restrict__ s, const float* __restrict__ am,
                  float* __restrict__ dgamma_out, float* __restrict__ dl_out, int n) {
  extern __shared__ float smem[];
  const int ld = n | 1, nc = n / 2;
  const Smem sm = carve(smem, n);

  const int r = threadIdx.x;
  const dq::Blk k{r, n, ld, blockDim.x == 32, r < n};
  const size_t b = blockIdx.x;

  load_P(k, sm, P, b);
  const size_t vo = b * n + r;
  const size_t co = b * nc + (r >> 1);    // this row's contact
  const float lv = k.real ? l[vo] : 0.f;
  const float gv = k.real ? g[vo] : 0.f;
  const float gam_raw = k.real ? gamma[co] : 0.f;
  const float amf = k.real ? am[co] : 0.f;
  const float sigma = (k.real ? s[co] : 0.f) * amf + (1.f - amf);
  if (k.real && !(r & 1)) {
    sm.s_gam[r >> 1] = gam_raw * amf;
    sm.s_am[r >> 1] = amf;
  }
  __syncthreads();

  schur_core(k, sm, gam_raw, lv, gv, amf, sigma, dl_out + b * n, dgamma_out + b * nc);
}

// Dynamic shared memory one block needs for a problem of size n, for either
// kernel (the wrapper's smem_bytes in kernels/qcqp_bwd_cuda.py computes the
// same).
size_t smem_bytes(int n) {
  const size_t ld = n | 1, nc = n / 2, ldm = nc | 1;
  return sizeof(float) * (2 * n * ld + (nc + 1) * n + (nc + 1) * ldm + 5 * n + 3 * nc);
}

// Opt the kernel into smem bytes of dynamic shared memory where that is
// above the default 48 KB; returns a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// Launch K2 on `stream` for B problems of size n = 2 nc. All pointers are
// device pointers to contiguous float32 allocated by the caller. Returns
// cudaGetLastError().
int dq_qcqp_bwd_f32(const float* P, const float* q, const float* l, const float* g,
                    const float* radius, float* dgamma_out, float* dl_out,
                    float* gamma_out, int B, int n, float eps, float act_eps,
                    float stall_ulps, void* stream) {
  const int threads = 32 * ((n + 31) / 32);
  const size_t smem = smem_bytes(n);
  const int e = allow_smem(qcqp_bwd_kernel, smem);
  if (e != 0) return e;
  if (B > 0) {
    qcqp_bwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        P, q, l, g, radius, dgamma_out, dl_out, gamma_out, n, eps, act_eps,
        stall_ulps);
  }
  return (int)cudaGetLastError();
}

// Launch K6 on `stream` for B problems of size n = 2 nc: gamma, s and am are
// (B, nc), am holding 0 or 1. Same conventions as dq_qcqp_bwd_f32.
int dq_qcqp_schur_f32(const float* P, const float* l, const float* g, const float* gamma,
                      const float* s, const float* am, float* dgamma_out, float* dl_out,
                      int B, int n, void* stream) {
  const int threads = 32 * ((n + 31) / 32);
  const size_t smem = smem_bytes(n);
  const int e = allow_smem(qcqp_schur_kernel, smem);
  if (e != 0) return e;
  if (B > 0) {
    qcqp_schur_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        P, l, g, gamma, s, am, dgamma_out, dl_out, n);
  }
  return (int)cudaGetLastError();
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Fused QCQP backward, one launch for a whole batch (kernel K2).
//
// Replaces diffqcqp_tpu/kernels/qcqp_bwd_pallas.py::_qcqp_bwd_fused_kernel
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
// Design: one thread block per problem, one thread per coordinate row, as in
// K1 (one warp at the flagship N = 24). P, the factor, W and [M | y] live in
// dynamic shared memory; the factor and the nc + 1 solves are the ldl.cuh
// helpers. A contact's two rows sit on neighbouring lanes, so every
// per-contact quantity (the duals, the mask, C^T z) is one __shfl_xor with
// the partner lane, and both lanes hold the same value.
//
// The QR runs on [M | y] stored column-major (odd stride ldm = nc | 1) with
// thread j owning column j, not row j: at step k every thread reads column k
// (a shared-memory broadcast) and computes the reflector's norm, alpha and
// beta itself, in the same order, so every thread holds bit-identical values
// and the control flow stays uniform with no reduction at all; then each
// thread j > k applies the reflector to its own column. One barrier per step.
// The back substitution goes column by column: thread k divides, every
// thread i < k updates its own b_i.
//
// What differs from the TPU kernel and why it does not change the result:
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
// inside a problem.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ldl.cuh"

namespace {

__global__ void __launch_bounds__(256)
qcqp_bwd_kernel(const float* __restrict__ P, const float* __restrict__ q,
                const float* __restrict__ l, const float* __restrict__ g,
                const float* __restrict__ radius, float* __restrict__ dgamma_out,
                float* __restrict__ dl_out, float* __restrict__ gamma_out, int n,
                float eps, float act_eps, float stall_ulps) {
  extern __shared__ float smem[];
  const int ld = n | 1, nc = n / 2, ldm = nc | 1;
  float* sP = smem;                       // n x ld, row-major
  float* sL = sP + n * ld;                // factor, column-major
  float* sW = sL + n * ld;                // (nc + 1) columns of n: W = D^-1 [g | C]
  float* sM = sW + (nc + 1) * n;          // (nc + 1) columns of ldm: [M | y]
  float* s_x = sM + (nc + 1) * ldm;       // l, broadcast for P l
  float* s_fwd = s_x + n;
  float* s_bwd = s_fwd + n;
  float* s_piv = s_bwd + n;
  float* s_rd = s_piv + n;
  float* s_gam = s_rd + n;                // nc: gamma * am
  float* s_am = s_gam + nc;               // nc: am as 0 / 1
  float* s_dg = s_am + nc;                // nc: dgamma before the mask

  const int r = threadIdx.x;
  const dq::Blk k{r, n, ld, blockDim.x == 32, r < n};
  const size_t b = blockIdx.x;

  const float* Pb = P + b * n * n;
  for (int idx = r; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    sP[i * ld + (idx - i * n)] = Pb[idx];
  }
  const size_t vo = b * n + r;
  const int cown = r >> 1;                // this row's contact
  const bool odd = r & 1;
  const float lv = k.real ? l[vo] : 0.f;
  const float gv = k.real ? g[vo] : 0.f;
  const float rad = k.real ? radius[b * nc + cown] : 0.f;
  if (k.real) s_x[r] = lv;
  __syncthreads();

  // 1. P l + q, accumulated from q over the columns in order
  float plq = k.real ? q[vo] : 0.f;
  if (k.real) {
    const float* row = sP + r * ld;
    for (int c = 0; c < n; ++c) plq = plq + row[c] * s_x[c];
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
    s_gam[cown] = gam_raw * amf;
    s_am[cown] = amf;
  }

  // 4. D = P + diag(2 gamma_raw): each thread passes its own row's shift
  const float dinv = dq::chol_factor(k, sP, sL, 2.f * gam_raw, s_piv, s_rd);

  // 5. W = D^{-1} [g | C]; only this thread reads its row of W again
  float w = dq::ldl_solve(k, sL, dinv, gv, 0, s_fwd, s_bwd);
  if (k.real) sW[r] = w;
  for (int c = 0; c < nc; ++c) {
    const float rhs = (cown == c) ? 2.f * lv * amf : 0.f;
    w = dq::ldl_solve(k, sL, dinv, rhs, 2 * c, s_fwd, s_bwd);
    if (k.real) sW[(c + 1) * n + r] = w;
  }

  // 6. column c < nc of M from W's column c + 1, column nc (= y) from W_g;
  // (C^T z)_i = 2 (l_2i z_2i + l_2i+1 z_2i+1) am_i, summed by the lane pair
  for (int c = 0; c <= nc; ++c) {
    const int wc = (c == nc) ? 0 : c + 1;
    const float t = k.real ? lv * sW[wc * n + r] : 0.f;
    const float tp = __shfl_xor_sync(dq::kFullMask, t, 1);
    const float ct = 2.f * (odd ? tp + t : t + tp) * amf;
    if (k.real && !odd) {
      sM[c * ldm + cown] =
          (c == nc) ? -ct : ((cown == c) ? sigma : 0.f) - ct * s_gam[c];
    }
  }
  dq::bsync(k);

  // 7. Householder QR of M applied to y; thread j <= nc owns column j
  for (int kk = 0; kk < nc; ++kk) {
    const float* ck = sM + kk * ldm;
    float nsq = 0.f;
    for (int i = kk; i < nc; ++i) nsq = nsq + ck[i] * ck[i];
    const float akk = ck[kk];
    const float alpha = (akk < 0.f ? 1.f : -1.f) * sqrtf(nsq);   // -sign(akk) |col|
    const float vk = akk - alpha;
    float vsq = vk * vk;
    for (int i = kk + 1; i < nc; ++i) vsq = vsq + ck[i] * ck[i];
    const float beta = vsq > dq::kTiny ? 2.f / fmaxf(vsq, dq::kTiny) : 0.f;
    if (r > kk && r <= nc) {
      float* cj = sM + r * ldm;
      float wd = vk * cj[kk];
      for (int i = kk + 1; i < nc; ++i) wd = wd + ck[i] * cj[i];
      const float bw = beta * wd;
      cj[kk] = cj[kk] - bw * vk;
      for (int i = kk + 1; i < nc; ++i) cj[i] = cj[i] - bw * ck[i];
    }
    dq::bsync(k);
    if (r == kk) sM[kk * ldm + kk] = alpha;   // R's diagonal; column kk is read no more this sweep
  }
  dq::bsync(k);

  // back substitution R x = Q^T y; thread i < nc holds b_i
  float bi = (r < nc) ? sM[nc * ldm + r] : 0.f;
  for (int kk = nc - 1; kk >= 0; --kk) {
    if (r == kk) {
      const float d = sM[kk * ldm + kk];
      s_dg[kk] = bi / (fabsf(d) > dq::kTiny ? d : dq::kTiny);
    }
    dq::bsync(k);
    if (r < kk) bi = bi - sM[kk * ldm + r] * s_dg[kk];
  }

  // 8. dl = W_g - W_C (gamma am dgamma am)
  if (k.real) {
    float dl = sW[r];
    for (int c = 0; c < nc; ++c) dl = dl - sW[(c + 1) * n + r] * (s_gam[c] * (s_dg[c] * s_am[c]));
    dl_out[vo] = dl;
    if (!odd) gamma_out[b * nc + cown] = gam_raw;
  }
  if (r < nc) dgamma_out[b * nc + r] = s_dg[r] * s_am[r];
}

// Dynamic shared memory one block needs for a problem of size n (the
// wrapper's smem_bytes in kernels/qcqp_bwd_cuda.py computes the same).
size_t smem_bytes(int n) {
  const size_t ld = n | 1, nc = n / 2, ldm = nc | 1;
  return sizeof(float) * (2 * n * ld + (nc + 1) * n + (nc + 1) * ldm + 5 * n + 3 * nc);
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
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qcqp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0) {
    qcqp_bwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        P, q, l, g, radius, dgamma_out, dl_out, gamma_out, n, eps, act_eps,
        stall_ulps);
  }
  return (int)cudaGetLastError();
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

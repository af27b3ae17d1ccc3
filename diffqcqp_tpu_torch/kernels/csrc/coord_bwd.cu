// Fused QP-family backward, one launch for a whole batch (kernel K4).
//
// Replaces diffqcqp_tpu/kernels/coord_bwd_pallas.py::_coord_bwd_kernel
// (wrapper coord_kkt_bwd_fused) for the three kinds QP (l >= 0), BOX
// (l_min <= l <= l_max) and SIGNED_BOX (the box plus sign(v) l <= 0). Every
// constraint touches one coordinate, so the differentiated KKT system
// decouples: a strictly active coordinate pins dl_r = 0, the free ones solve
// an SPD system, and each active slot's dgamma is closed form. Per problem,
// with thread r owning coordinate r:
//   1. P l + q;
//   2. the duals in closed form and the strict mask am_r:
//      QP: am = (l <= eps) & (Pl+q > act_eps);
//      box kinds: the slots active on coordinate r (lo: l - l_min <= eps,
//      hi: l - l_max >= -eps, sg: v l >= -eps, times v^2 so a zero sign is
//      a no-op) share rhs = -(Pl+q) at minimal norm, gamma_slot = coef rhs /
//      max(sum of the activities, 1) with coef -1 | +1 | v; a slot is strict
//      if active with gamma_slot > act_eps, and am_r = 1 if any slot of r is;
//   3. the LDL^T factor of K = fm P fm + diag(am), fm = 1 - am;
//   4. dl = K^{-1}(g fm) fm;
//   5. box kinds: resid = (g - P dl) am, split over r's strict slots by their
//      coefficients c (-gamma_lo | gamma_hi | v gamma_sg):
//      dgamma_slot = c_slot resid / max(sum c^2, 1e-30).
// Outputs dl (B, n) and, for the box kinds, dgamma and gamma (B, 2n or 3n)
// in blocks [lo | hi | sg].
//
// Design: one thread block per problem, one thread per coordinate row, as in
// K1 and K2 (one warp at N = 24); the kind is a template parameter. Steps 1,
// 2 and 5 are per-thread: every constraint touches one coordinate, so there
// is no shuffle and no reduction. The masked factor is ldl.cuh's
// chol_factor<true>, which applies the mask as it reads P (fm_r fm_j from a
// shared array of fm; diag(am) is each thread's own shift) and writes the
// factor to a second shared matrix, so sP keeps the unmasked P that step 5's
// P dl reads.
//
// What differs from the TPU kernel and why it does not change the result:
// the TPU pads n to a multiple of 8 with unit-diagonal rows (a layout
// detail), and accumulates P l from its first column before adding q; here
// threads past n hold zeros and sit out, and P l + q accumulates from q as in
// K2. These change the order of float32 operations only. The factor and the
// solve (ldl.cuh) fuse multiply-adds; the two matrix-vector products and the
// sum of squares do not, so that the duals match the plain version's bits.
//
// What bounds it on this card: at B = 4096, N = 24 the bytes (P, q, l, g in,
// dl out: ~11 MB, ~3.3 us at 3.35 TB/s) are far above the operations
// (~7 kFLOP per problem, ~0.4 us at 67 TFLOP/s); what bounds a simple kernel
// is the dependent chain inside each problem: n Cholesky columns and one
// solve of 2n + 1 broadcast-then-FMA steps. As in K1 and K2 the design
// answers with occupancy (one warp and ~5 KB of shared memory per problem).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ldl.cuh"

namespace {

// the wrapper's KIND_QP, KIND_BOX, KIND_SIGNED_BOX (kernels/coord_bwd_cuda.py)
constexpr int kQP = 0, kBox = 1, kSignedBox = 2;

template <int kKind>
__global__ void __launch_bounds__(256)
coord_bwd_kernel(const float* __restrict__ P, const float* __restrict__ q,
                 const float* __restrict__ l, const float* __restrict__ g,
                 const float* __restrict__ l_min, const float* __restrict__ l_max,
                 const float* __restrict__ v_sign, float* __restrict__ dl_out,
                 float* __restrict__ dgamma_out, float* __restrict__ gamma_out, int n,
                 float eps, float act_eps) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  float* sP = smem;                // n x ld, row-major, unmasked
  float* sL = sP + n * ld;         // factor of K, column-major
  float* s_x = sL + n * ld;        // l, later dl: broadcast for P x
  float* s_fm = s_x + n;           // fm as 0 / 1
  float* s_fwd = s_fm + n;
  float* s_bwd = s_fwd + n;
  float* s_piv = s_bwd + n;
  float* s_rd = s_piv + n;

  const int r = threadIdx.x;
  const dq::Blk k{r, n, ld, blockDim.x == 32, r < n};
  const size_t b = blockIdx.x;

  const float* Pb = P + b * n * n;
  for (int idx = r; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    sP[i * ld + (idx - i * n)] = Pb[idx];
  }
  const size_t vo = b * n + r;
  const float lv = k.real ? l[vo] : 0.f;
  const float gv = k.real ? g[vo] : 0.f;
  if (k.real) s_x[r] = lv;
  __syncthreads();

  // 1. P l + q, accumulated from q over the columns in order, each product
  // and sum rounded on its own (no FMA), as the plain version computes it:
  // a dual gamma = -(Pl+q) near zero is all cancellation, and the dgamma of
  // its slot is 1/gamma-sized, so a changed rounding here moves dgamma far
  // more than anything else the kernel rounds
  float plq = k.real ? q[vo] : 0.f;
  if (k.real) {
    const float* row = sP + r * ld;
    for (int c = 0; c < n; ++c) plq = __fadd_rn(plq, __fmul_rn(row[c], s_x[c]));
  }

  // 2. this coordinate's duals, slot coefficients and strict mask
  float am = 0.f;
  float g_lo = 0.f, g_hi = 0.f, g_sg = 0.f, c_lo = 0.f, c_hi = 0.f, c_sg = 0.f;
  if constexpr (kKind == kQP) {
    am = (lv <= eps && plq > act_eps) ? 1.f : 0.f;
  } else {
    const float lo = k.real ? l_min[vo] : 0.f;
    const float hi = k.real ? l_max[vo] : 0.f;
    const float a_lo = (lv - lo <= eps) ? 1.f : 0.f;
    const float a_hi = (lv - hi >= -eps) ? 1.f : 0.f;
    const float rhs = -plq;
    float vs = 0.f, a_sg = 0.f;
    if constexpr (kKind == kSignedBox) {
      vs = k.real ? v_sign[vo] : 0.f;
      a_sg = (vs * lv >= -eps) ? vs * vs : 0.f;
    }
    const float denom = fmaxf(a_lo + a_hi + a_sg, 1.f);
    g_lo = -a_lo * rhs / denom;
    g_hi = a_hi * rhs / denom;
    const float m_lo = (g_lo > act_eps) ? a_lo : 0.f;
    const float m_hi = (g_hi > act_eps) ? a_hi : 0.f;
    c_lo = -g_lo * m_lo;
    c_hi = g_hi * m_hi;
    float m_sg = 0.f;
    if constexpr (kKind == kSignedBox) {
      g_sg = a_sg * vs * rhs / denom;
      m_sg = (g_sg > act_eps) ? a_sg : 0.f;
      c_sg = vs * g_sg * m_sg;
    }
    am = fminf(m_lo + m_hi + m_sg, 1.f);
  }
  const float fm = 1.f - am;
  if (k.real) s_fm[r] = fm;
  dq::bsync(k);

  // 3. K = fm P fm + diag(am): the mask is applied as P is read, and each
  // thread passes its own am as its row's shift
  const float dinv = dq::chol_factor<true>(k, sP, sL, am, s_piv, s_rd, s_fm);

  // 4. dl = K^{-1} (g fm) fm
  const float dl = dq::ldl_solve(k, sL, dinv, gv * fm, 0, s_fwd, s_bwd) * fm;
  if (k.real) dl_out[vo] = dl;

  if constexpr (kKind != kQP) {
    // 5. resid = (g - P dl) am, split over the strict slots (P dl
    // accumulated from its first column, as the TPU kernel does, and like
    // the sum of squares rounded as the plain version rounds it)
    if (k.real) s_x[r] = dl;
    dq::bsync(k);
    float pdl = 0.f;
    if (k.real) {
      const float* row = sP + r * ld;
      for (int c = 0; c < n; ++c) pdl = __fadd_rn(pdl, __fmul_rn(row[c], s_x[c]));
    }
    const float resid = (gv - pdl) * am;
    float den = __fadd_rn(__fmul_rn(c_lo, c_lo), __fmul_rn(c_hi, c_hi));
    if constexpr (kKind == kSignedBox) den = __fadd_rn(den, __fmul_rn(c_sg, c_sg));
    den = fmaxf(den, dq::kTiny);
    if (k.real) {
      const size_t kn = (kKind == kBox ? 2 : 3) * (size_t)n;
      float* dg = dgamma_out + b * kn + r;
      float* ga = gamma_out + b * kn + r;
      dg[0] = c_lo * resid / den;
      dg[n] = c_hi * resid / den;
      ga[0] = g_lo;
      ga[n] = g_hi;
      if constexpr (kKind == kSignedBox) {
        dg[2 * n] = c_sg * resid / den;
        ga[2 * n] = g_sg;
      }
    }
  }
}

// Dynamic shared memory one block needs for a problem of size n (the
// wrapper's smem_bytes in kernels/coord_bwd_cuda.py computes the same).
size_t smem_bytes(int n) {
  const size_t ld = n | 1;
  return sizeof(float) * (2 * n * ld + 6 * n);
}

template <int kKind>
int launch(const float* P, const float* q, const float* l, const float* g,
           const float* l_min, const float* l_max, const float* v_sign, float* dl_out,
           float* dgamma_out, float* gamma_out, int B, int n, float eps, float act_eps,
           cudaStream_t stream) {
  const int threads = 32 * ((n + 31) / 32);
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        coord_bwd_kernel<kKind>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0) {
    coord_bwd_kernel<kKind><<<B, threads, smem, stream>>>(
        P, q, l, g, l_min, l_max, v_sign, dl_out, dgamma_out, gamma_out, n, eps, act_eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K4 of `kind` (0 QP, 1 box, 2 signed box) on `stream` for B problems
// of size n. All pointers are device pointers to contiguous float32 allocated
// by the caller; l_min and l_max are read by the box kinds only, v_sign by the
// signed box only, and dgamma_out / gamma_out ((B, 2n) or (B, 3n)) written by
// the box kinds only (pass null where unused). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown kind.
int dq_coord_bwd_f32(const float* P, const float* q, const float* l, const float* g,
                     const float* l_min, const float* l_max, const float* v_sign,
                     float* dl_out, float* dgamma_out, float* gamma_out, int B, int n,
                     int kind, float eps, float act_eps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kQP:
      return launch<kQP>(P, q, l, g, l_min, l_max, v_sign, dl_out, dgamma_out, gamma_out,
                         B, n, eps, act_eps, s);
    case kBox:
      return launch<kBox>(P, q, l, g, l_min, l_max, v_sign, dl_out, dgamma_out, gamma_out,
                          B, n, eps, act_eps, s);
    case kSignedBox:
      return launch<kSignedBox>(P, q, l, g, l_min, l_max, v_sign, dl_out, dgamma_out,
                                gamma_out, B, n, eps, act_eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Fused ADMM forward solve, one launch for a whole batch (kernel K1).
//
// Replaces diffqcqp_tpu/kernels/admm_pallas.py::_admm_chol_kernel (wrapper
// admm_solve_pallas). Same constants, update order and stopping rules: power
// iteration for L, rho0 = sqrt(mu L) (L/mu)^0.4 * rho0_scale, tau0 =
// (L/mu)^0.15, an LDL^T factor of P + (rho + mu) I, then per iteration the
// solve, over-relaxation, prox (non-negative, box, signed box, disk), dual
// update, residuals, the stopping rule with its stall floors, and the
// adaptive rho (rho_sync or cpt gating) with a refactorisation whenever rho
// changes.
//
// Design: one thread block per problem, one thread per coordinate row
// (blockDim = 32 * ceil(n / 32): one warp at the flagship N = 24). P and the
// factor live in dynamic shared memory (2 n ld floats, ld = n | 1 odd so row
// and column walks are both bank-conflict free); per-problem scalars (rho,
// taus, counters, flags) and per-row vectors (l2, u, q_prox) live in
// registers. The inf-norm, 2-norm and Rayleigh-quotient reductions are warp
// butterflies (every lane ends with the same value) plus a small shared array
// across warps. Each block leaves its loop when its own problem converges or
// at max_iter.
//
// What differs from the TPU kernel and why it does not change the result:
//   * the TPU loops a 128-lane tile until every lane converged, freezing the
//     converged lanes; here each problem stops on its own, which leaves the
//     same values (a frozen lane never changes again);
//   * rho_sync gates on the tile's iteration counter; for a problem that is
//     still running that counter equals its own iteration count, so the
//     per-problem counter reproduces the gate exactly (it > 0 excluded);
//   * the TPU refactors the whole tile when any lane's rho changed; here
//     only the problem whose rho changed refactors. The factor is a pure
//     function of (P, rho), so the numbers are the same;
//   * the friction-cone prox works in reference order (contact c owns rows
//     2c, 2c+1; the partner value comes by a lane shuffle) instead of the
//     TPU's permuted order. That changes float32 rounding only.
//
// What bounds it on this card: not bytes (P is read once, ~9.4 MB at
// B = 4096, N = 24) nor FLOPs (a few MFLOP per problem), but the latency of
// the dependent chain inside each problem: a triangular sweep is 2n + 1
// steps, each a broadcast then a multiply-add that the next step waits on.
// The design answers with occupancy rather than parallelism inside a
// problem: a block is one warp with ~5 KB of shared memory, so up to 32
// problems are resident per SM and the schedulers interleave their chains.
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

constexpr int kMaxWarps = 32;

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

// (P x)_r, accumulated over columns in order as the TPU kernel does.
__device__ __forceinline__ float matvec(const dq::Blk& k, const float* sP, float x,
                                        float* s_x) {
  if (k.real) s_x[k.r] = x;
  dq::bsync(k);
  float acc = 0.f;
  if (k.real) {
    const float* row = sP + k.r * k.ld;
    acc = row[0] * s_x[0];
    for (int c = 1; c < k.n; ++c) acc = acc + row[c] * s_x[c];
  }
  dq::bsync(k);
  return acc;
}

__global__ void __launch_bounds__(256)
admm_kernel(const float* __restrict__ P, const float* __restrict__ q,
            const float* __restrict__ ws, const float* __restrict__ pa,
            const float* __restrict__ pb, const float* __restrict__ pc,
            float* __restrict__ l2_out, int* __restrict__ iters_out,
            float* __restrict__ resp_out, float* __restrict__ resd_out,
            float* __restrict__ rho_out, uint8_t* __restrict__ conv_out,
            uint8_t* __restrict__ stall_out, const AdmmParams prm) {
  extern __shared__ float smem[];
  const int n = prm.n, ld = n | 1, nc = n / 2;
  float* sP = smem;
  float* sL = sP + n * ld;
  float* s_fwd = sL + n * ld;
  float* s_bwd = s_fwd + n;
  float* s_piv = s_bwd + n;
  float* s_rd = s_piv + n;
  float* s_x = s_rd + n;
  float* s_red = s_x + n;                 // 4 * kMaxWarps

  const int r = threadIdx.x;
  const dq::Blk k{r, n, ld, blockDim.x == 32, r < n};
  const size_t b = blockIdx.x;

  const float* Pb = P + b * n * n;
  for (int idx = r; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    sP[i * ld + (idx - i * n)] = Pb[idx];
  }
  const size_t vo = b * n + r;
  const float qv = k.real ? q[vo] : 0.f;
  float l2 = k.real ? ws[vo] : 0.f;
  float lo = 0.f, hi = 0.f, vs = 0.f, rad = 0.f;
  if (k.real && (prm.prox_kind == kBox || prm.prox_kind == kSignedBox)) {
    lo = pa[vo];
    hi = pb[vo];
    if (prm.prox_kind == kSignedBox) vs = pc[vo];
  }
  if (prm.prox_kind == kDisk && r < 2 * nc) rad = pa[b * nc + (r >> 1)];
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
  float rho = sqrtf(mu * L) * powf(ratio, 0.4f) * prm.rho0_scale;
  const float tau0 = powf(ratio, 0.15f);

  float dinv = dq::chol_factor(k, sP, sL, rho + mu, s_piv, s_rd);

  // u0 = -(P ws + q) synthesises the dual warm start from the primal one
  float u = 0.f;
  if (prm.warm_start_dual) u = -(matvec(k, sP, l2, s_x) + qv);

  float qp = qv;
  float tau_inc = tau0, tau_dec = tau0;
  int rho_up = 0, cpt = 0, iters = 0;
  bool conv = false, stall = false;
  float resp = INFINITY, resd = INFINITY, rho_rec = rho;

  for (int it = 0; it < prm.max_iter; ++it) {
    const float l = dq::ldl_solve(k, sL, dinv, rho * l2 - u - qp, 0, s_fwd, s_bwd);
    const float qpn = qv - mu * l;
    const float rr = prm.alpha * l + (1.0f - prm.alpha) * l2;
    const float x = rr + u / rho;

    // prox; the disk partner moves by shuffle, so every lane calls it
    const float partner = __shfl_xor_sync(dq::kFullMask, x, 1);
    float l2n;
    switch (prm.prox_kind) {
      case kNonneg:
        l2n = fmaxf(x, 0.f);
        break;
      case kBox:
        l2n = fminf(fmaxf(x, lo), hi);
        break;
      case kSignedBox:
        l2n = vs * fminf(vs * fminf(fmaxf(x, lo), hi), 0.f);
        break;
      default: {
        if (r < 2 * nc) {
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
    if (!k.real) l2n = 0.f;
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

    // commit this iteration (the problem was active); the recorded rho is
    // the one the residuals were computed with, before any update below
    l2 = l2n;
    u = un;
    qp = qpn;
    resp = rp;
    resd = rd;
    rho_rec = rho;
    ++iters;
    if (newly) {
      conv = true;
      stall = !certified;
      break;
    }

    if (prm.adaptive_rho) {
      const bool inc = rp > prm.mu_thresh * rd;
      const bool dec = !inc && (rd > prm.mu_thresh * rp);
      const bool gate = prm.rho_sync
                            ? (it % prm.rho_update_period == 0 && it > 0)
                            : (cpt % prm.rho_update_period == 0);
      cpt += (inc || dec);
      const bool app_inc = gate && inc, app_dec = gate && dec;
      if (app_inc || app_dec) {
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
        dinv = dq::chol_factor(k, sP, sL, rho + mu, s_piv, s_rd);
      }
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

// Dynamic shared memory one block needs for a problem of size n (the
// wrapper's smem_bytes in kernels/admm_cuda.py computes the same).
size_t smem_bytes(int n) {
  const int ld = n | 1;
  return sizeof(float) * (2 * (size_t)n * ld + 5 * (size_t)n + 4 * kMaxWarps);
}

}  // namespace

extern "C" {

// Launch K1 on `stream` for B problems of size prm->n. All pointers are
// device pointers to contiguous float32 (uint8 for the two flags, int32 for
// the iteration counts) allocated by the caller. Returns cudaGetLastError().
int dq_admm_solve_f32(const float* P, const float* q, const float* ws,
                      const float* pa, const float* pb, const float* pc,
                      float* l2_out, int* iters_out, float* resp_out,
                      float* resd_out, float* rho_out, uint8_t* conv_out,
                      uint8_t* stall_out, int B, const AdmmParams* prm,
                      void* stream) {
  const int n = prm->n;
  const int threads = 32 * ((n + 31) / 32);
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0) {
    admm_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        P, q, ws, pa, pb, pc, l2_out, iters_out, resp_out, resd_out, rho_out,
        conv_out, stall_out, *prm);
  }
  return (int)cudaGetLastError();
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

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
// Design: one thread block per problem, one thread per coordinate row; the
// kind is a template parameter. Steps 1, 2 and 5 are per-thread: every
// constraint touches one coordinate, so there is no shuffle and no
// reduction.
//
// One warp, n <= 32 (the main path's N = 24), the free block alone: a
// strictly active coordinate's row and column of K are unit vectors, so
// every operation the full factor, the sweeps and P dl spend on them
// subtracts or adds an exact zero (half the coordinates at the QP point,
// a third or a quarter at the box points). The warp compacts its free
// coordinates (fm = 1) with one __ballot_sync; __popc of the lanes below
// gives each free lane its index f, and s_map[f] its row. Lane f < nf loads
// row f of the free block of P (= K there) into registers, which ldl.cuh's
// chol_factor_warp factors right-looking (nf steps, the pivot column
// published once a step and read four entries a load) and ldl_solve_warp
// solves (2 nf + 1 steps); the strictly active rows get dl = 0, and P dl
// (box kinds) runs over the free columns only. Each free entry keeps the
// full factor's operations in their order, so dl, dgamma and gamma keep the
// masked factor's bits apart from the sign of zeros, and the plain version
// is unchanged (tests/test_torch_coord_bwd.py emulates the compaction).
// 5,312 B of shared memory at n = 24 and __launch_bounds__(32, 32): 32
// blocks an SM, one wave at B = 4096. Two instances unroll the register
// loops to n <= 24 and n <= 32.
//
// Above one warp, 32 < n <= 168 (the JAX package's config 6 is N = 96):
// 256 threads a problem. The first design ran a thread per row over all n
// coordinates: the masked n x n K factored left-looking (each thread a
// dependent chain of up to n^2 / 2 shared loads) and solved with a barrier
// at each of 2n + 1 steps, in blocks of n / 32 warps (nine warps an SM at n
// = 96). Now:
//   * the free coordinates are compacted block-wide, one __ballot_sync a
//     warp and a prefix over the eight warps' counts, and only the nf x nf
//     free block of P is factored and solved: each free entry keeps the
//     masked factor's operations in their order, so the bits are the plain
//     version's bar the sign of zeros, as at one warp, and P dl (box kinds)
//     runs over the free columns only;
//   * P comes in by asynchronous copies (cp.async), all of a thread's in
//     flight at once, where a load then a store keeps one in flight: with
//     three blocks an SM there are few warps to hide its latency;
//   * nf > 32 (most QP problems at N = 96, nf ~ n / 2): the free block,
//     gathered column-major into a second plane, is factored by ldl.cuh's
//     chol_factor_tiles (right-looking over a 16 x 16 grid of register
//     tiles, one barrier a column, the smallest tile that holds nf) and
//     solved by warp 0 alone, ldl_solve_warp_rows (one shuffle a step, no
//     barrier, where ldl_solve_tiles spends one on each of 2 nf + 1 steps);
//   * nf <= 32 (most box-kind problems at N = 96): warp 0 factors and solves
//     it in registers, chol_factor_warp and ldl_solve_warp as at one warp,
//     with no block-wide barrier;
//   * eight warps a block: the shared memory, P and the factor's plane
//     (2 n (n|1) + 6 n words, as before, which sets the dispatch bound n <=
//     168), still holds three blocks an SM at n = 96, now 24 warps an SM.
// Three instances: n <= 64 (register tiles to 4 x 4, __launch_bounds__(256,
// 4): four blocks an SM, where three, at the 80 registers of the next
// instance, measured slower than the first design at n = 33 on an H100),
// n <= 96 (to 6 x 6, (256, 3)) and n <= 168 (to 11 x 11; one block an SM,
// as the shared memory allows). Two warps a problem up to n = 96 (an 8 x 8
// factor grid, no register bound) measured slower for all three kinds.
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
// (~7 kFLOP per problem, ~0.4 us at 67 TFLOP/s); at B = 2048, N = 96 (78.6
// MB, 23.5 us, against ~10 us of operations) too. What bounds the kernel is
// the dependent chain inside each problem: nf factor steps (each behind a
// barrier above nf = 32), 2 nf + 1 sweep steps and P l + q's n rounded
// adds, with three problems an SM at n = 96.
//
// ptxas (sm_90a): one warp, n <= 24: QP 56 registers, box 62, signed box 64
// with 4 bytes of spill; n <= 32: 64 registers, 4-8 bytes of spill; block-
// wide, n <= 64: 63 / 64 / 64 registers (the four-blocks bound), 0 / 68 / 72
// bytes of spill; n <= 96: 80 (the three-blocks bound), 12 / 28 / 28 bytes;
// n <= 168: 254 / 255 / 255, no spill (the first design above one warp: 32 /
// 40 / 40).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ldl.cuh"

namespace {

// the wrapper's KIND_QP, KIND_BOX, KIND_SIGNED_BOX (kernels/coord_bwd_cuda.py)
constexpr int kQP = 0, kBox = 1, kSignedBox = 2;

// Step 2 for this thread's coordinate: its strict mask am (the return
// value) and, for the box kinds, its slots' duals g_* and coefficients c_*.
struct Duals {
  float g_lo = 0.f, g_hi = 0.f, g_sg = 0.f, c_lo = 0.f, c_hi = 0.f, c_sg = 0.f;
};

template <int kKind>
__device__ float coord_duals(bool real, size_t vo, float lv, float plq,
                             const float* __restrict__ l_min, const float* __restrict__ l_max,
                             const float* __restrict__ v_sign, float eps, float act_eps,
                             Duals& d) {
  if constexpr (kKind == kQP) {
    return (lv <= eps && plq > act_eps) ? 1.f : 0.f;
  } else {
    const float lo = real ? l_min[vo] : 0.f;
    const float hi = real ? l_max[vo] : 0.f;
    const float a_lo = (lv - lo <= eps) ? 1.f : 0.f;
    const float a_hi = (lv - hi >= -eps) ? 1.f : 0.f;
    const float rhs = -plq;
    float vs = 0.f, a_sg = 0.f;
    if constexpr (kKind == kSignedBox) {
      vs = real ? v_sign[vo] : 0.f;
      a_sg = (vs * lv >= -eps) ? vs * vs : 0.f;
    }
    const float denom = fmaxf(a_lo + a_hi + a_sg, 1.f);
    d.g_lo = -a_lo * rhs / denom;
    d.g_hi = a_hi * rhs / denom;
    const float m_lo = (d.g_lo > act_eps) ? a_lo : 0.f;
    const float m_hi = (d.g_hi > act_eps) ? a_hi : 0.f;
    d.c_lo = -d.g_lo * m_lo;
    d.c_hi = d.g_hi * m_hi;
    float m_sg = 0.f;
    if constexpr (kKind == kSignedBox) {
      d.g_sg = a_sg * vs * rhs / denom;
      m_sg = (d.g_sg > act_eps) ? a_sg : 0.f;
      d.c_sg = vs * d.g_sg * m_sg;
    }
    return fminf(m_lo + m_hi + m_sg, 1.f);
  }
}

// Step 5 for the box kinds: resid = (g - P dl) am split over the strict
// slots, written with the duals. `pdl` is (P dl)_r.
template <int kKind>
__device__ void coord_dgamma(int n, size_t b, int r, float gv, float pdl, float am,
                             const Duals& d, float* __restrict__ dgamma_out,
                             float* __restrict__ gamma_out) {
  const float resid = (gv - pdl) * am;
  float den = __fadd_rn(__fmul_rn(d.c_lo, d.c_lo), __fmul_rn(d.c_hi, d.c_hi));
  if constexpr (kKind == kSignedBox) den = __fadd_rn(den, __fmul_rn(d.c_sg, d.c_sg));
  den = fmaxf(den, dq::kTiny);
  const size_t kn = (kKind == kBox ? 2 : 3) * (size_t)n;
  float* dg = dgamma_out + b * kn + r;
  float* ga = gamma_out + b * kn + r;
  dg[0] = d.c_lo * resid / den;
  dg[n] = d.c_hi * resid / den;
  ga[0] = d.g_lo;
  ga[n] = d.g_hi;
  if constexpr (kKind == kSignedBox) {
    dg[2 * n] = d.c_sg * resid / den;
    ga[2 * n] = d.g_sg;
  }
}

// One warp, n <= N (N = 24 or 32, a multiple of 4): the free block alone.
// 32 blocks an SM: at most 64 registers a thread.
template <int kKind, int N>
__global__ void __launch_bounds__(32, 32)
coord_bwd_kernel_w(const float* __restrict__ P, const float* __restrict__ q,
                   const float* __restrict__ l, const float* __restrict__ g,
                   const float* __restrict__ l_min, const float* __restrict__ l_max,
                   const float* __restrict__ v_sign, float* __restrict__ dl_out,
                   float* __restrict__ dgamma_out, float* __restrict__ gamma_out, int n,
                   float eps, float act_eps) {
  extern __shared__ float4 smem_w[];
  const int ld = n | 1;
  float* s_pub = reinterpret_cast<float*>(smem_w);   // 2 x 32: published values
  float* s_x = s_pub + 2 * dq::kPubStride;          // 32: l, later dl
  int* s_map = reinterpret_cast<int*>(s_x + 32);    // 32: row of free coordinate f
  float* sP = reinterpret_cast<float*>(s_map + 32);  // n x ld, row-major, unmasked
  float* sL = sP + n * ld;                          // factor of the free block

  const int r = threadIdx.x;
  const bool real = r < n;
  const size_t b = blockIdx.x;
  const float* Pb = P + b * n * n;
  if (real) {
    for (int i = 0; i < n; ++i) sP[i * ld + r] = Pb[i * n + r];   // row i, coalesced
  }
  const size_t vo = b * n + r;
  const float lv = real ? l[vo] : 0.f;
  const float gv = real ? g[vo] : 0.f;
  s_x[r] = lv;
  __syncwarp();

  // 1. P l + q, each product and sum rounded on its own (see the block-wide
  // kernel below), l read four entries a load
  float plq = real ? q[vo] : 0.f;
  const float* row = sP + min(r, n - 1) * ld;
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(s_x + k);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (real && k + e < n) plq = __fadd_rn(plq, __fmul_rn(row[k + e], xv[e]));
    }
  }

  // 2. this coordinate's duals, slot coefficients and strict mask
  Duals d;
  const float am = coord_duals<kKind>(real, vo, lv, plq, l_min, l_max, v_sign, eps, act_eps, d);

  // 3. compaction: free coordinate f (fm = 1, in increasing row order) is
  // row s_map[f]; lane f < nf takes row f of the free block of P, which is
  // the free block of K (there fm P fm = P and diag(am) = 0)
  const unsigned free_mask = __ballot_sync(dq::kFullMask, real && am == 0.f);
  const int nf = __popc(free_mask);
  const bool is_free = (free_mask >> r) & 1u;
  if (is_free) s_map[__popc(free_mask & ((1u << r) - 1u))] = r;
  __syncwarp();
  const bool lane_f = r < nf;
  const int rf = lane_f ? s_map[r] : 0;
  float a[N];
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = (lane_f && k < nf) ? sP[rf * ld + s_map[k]] : 0.f;
  const float dinv = dq::chol_factor_warp<N>(a, nf, r, sL, ld, s_pub);

  // 4. dl = K^{-1} (g fm) fm: the free rows by one pair of sweeps over the
  // free block (2 nf + 1 steps), the strictly active rows 0
  float x[1] = {lane_f ? g[b * n + rf] : 0.f};
  if (nf > 0) dq::ldl_solve_warp<1>(sL, nf, ld, r, dinv, x, s_pub);
  if (real && !is_free) s_x[r] = 0.f;
  if (lane_f) s_x[rf] = x[0];
  __syncwarp();
  if (real) dl_out[vo] = s_x[r];

  if constexpr (kKind != kQP) {
    // 5. resid = (g - P dl) am, P dl over the free columns in order (dl is
    // an exact 0 on the others), accumulated from its first term
    float pdl = 0.f;
    if (real) {
      for (int f = 0; f < nf; ++f) {
        const int c = s_map[f];
        pdl = __fadd_rn(pdl, __fmul_rn(row[c], s_x[c]));
      }
      coord_dgamma<kKind>(n, b, r, gv, pdl, am, d, dgamma_out, gamma_out);
    }
  }
}

constexpr int kOneWarpMaxN = 32;   // n <= 32: one warp, coord_bwd_kernel_w
constexpr int kBwThreads = 256;    // n > 32: eight warps a problem, coord_bwd_kernel
constexpr int kBwWarps = kBwThreads / 32;

// The block-wide path's three instances: the largest register tile of the
// factor (NFMAX: nf <= 16 NFMAX) and the blocks an SM the launch bound asks
// for. Mid: n <= 64, four blocks an SM; small: n <= 96, three (the shared
// memory's count at n = 96); large: n <= 168, one.
template <int NFMAX, int MINB>
struct BwTiles {
  static constexpr int kNFMax = NFMAX, kMinBlocks = MINB;
};
using BwMid = BwTiles<4, 4>;
using BwSmall = BwTiles<6, 3>;
using BwLarge = BwTiles<11, 1>;
constexpr int kBwMidMaxN = 16 * BwMid::kNFMax;       // 64
constexpr int kBwSmallMaxN = 16 * BwSmall::kNFMax;   // 96

// dst <- *src, 4 bytes from global to shared memory by an asynchronous copy
// (cp.async): a thread keeps all of its copies in flight at once, where a
// load then a store keeps one; cp_async_wait_all waits for this thread's.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;\n" ::: "memory");
}

// ldl.cuh's chol_factor_tiles with the smallest register tile that holds
// nf (33 <= nf <= 16 NFMAX): nf / 16 rounded up, so a step spends
// ceil(nf / 16)^2 FMAs a thread, not NFMAX^2.
template <int NF, int NFMAX>
__device__ void chol_factor_fit(float* sA, int nf, int ld, float* s_rd, float* s_col, float* s_rs) {
  if constexpr (NF < NFMAX) {
    if (nf > 16 * NF) {
      chol_factor_fit<NF + 1, NFMAX>(sA, nf, ld, s_rd, s_col, s_rs);
      return;
    }
  }
  dq::chol_factor_tiles<NF>(sA, nf, ld, s_rd, s_col, s_rs);
}

// Above one warp, 32 < n <= 168: 256 threads a problem, thread t < n owning
// coordinate t for steps 1, 2 and 5; the free block, compacted, factored
// and solved by the whole block (nf > 32) or by warp 0 in registers (nf <=
// 32).
template <int kKind, typename T>
__global__ void __launch_bounds__(kBwThreads, T::kMinBlocks)
coord_bwd_kernel(const float* __restrict__ P, const float* __restrict__ q,
                 const float* __restrict__ l, const float* __restrict__ g,
                 const float* __restrict__ l_min, const float* __restrict__ l_max,
                 const float* __restrict__ v_sign, float* __restrict__ dl_out,
                 float* __restrict__ dgamma_out, float* __restrict__ gamma_out, int n,
                 float eps, float act_eps) {
  extern __shared__ float4 smem_b[];
  const int ld = n | 1;
  float* s_col = reinterpret_cast<float*>(smem_b);  // 2n: the factor's published columns
                                                    // (the register factor's 2 x 32 slots)
  float* s_x = s_col + 2 * n;                       // n: l, then the free block's g and dl
  float* s_rd = s_x + n;                            // n: 1 / L_ff of the tile factor
  int* s_map = reinterpret_cast<int*>(s_rd + n);    // n: row of free coordinate f
  float* s_rs = reinterpret_cast<float*>(s_map + n);  // 2: the factor's published 1 / sqrt(pivot)
  int* s_cnt = reinterpret_cast<int*>(s_rs + 2);    // 8: free coordinates a warp (n >= 10 words)
  float* sP = s_rs + n;                             // n x ld, row-major, unmasked
  float* sA = sP + n * ld;                          // the free block, then its factor

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const bool real = t < n;
  const size_t b = blockIdx.x;
  const float* Pb = P + b * n * n;
  for (int idx = t; idx < n * n; idx += kBwThreads) {
    const int i = idx / n;
    cp_async_f32(sP + i * ld + (idx - i * n), Pb + idx);
  }
  const size_t vo = b * n + t;
  const float lv = real ? l[vo] : 0.f;
  const float gv = real ? g[vo] : 0.f;
  const float qv = real ? q[vo] : 0.f;
  if (real) s_x[t] = lv;
  cp_async_wait_all();
  __syncthreads();

  // 1. P l + q, accumulated from q over the columns in order, each product
  // and sum rounded on its own (no FMA), as the plain version computes it:
  // a dual gamma = -(Pl+q) near zero is all cancellation, and the dgamma of
  // its slot is 1/gamma-sized, so a changed rounding here moves dgamma far
  // more than anything else the kernel rounds
  float plq = qv;
  const float* row = sP + min(t, n - 1) * ld;
  if (real) {
#pragma unroll 4
    for (int c = 0; c < n; ++c) plq = __fadd_rn(plq, __fmul_rn(row[c], s_x[c]));
  }

  // 2. this coordinate's duals, slot coefficients and strict mask
  Duals d;
  const float am = coord_duals<kKind>(real, vo, lv, plq, l_min, l_max, v_sign, eps, act_eps, d);

  // 3. compaction: one ballot a warp, then a prefix over the warps' counts;
  // free coordinate f (fm = 1, in increasing row order) is row s_map[f],
  // and its right-hand side g fm = g goes to s_x[f] (l is read by now)
  const unsigned free_mask = __ballot_sync(dq::kFullMask, real && am == 0.f);
  if (lane == 0) s_cnt[w] = __popc(free_mask);
  __syncthreads();
  int base = 0, nf = 0;
#pragma unroll
  for (int k = 0; k < kBwWarps; ++k) {
    const int c = s_cnt[k];
    base += k < w ? c : 0;
    nf += c;
  }
  const bool is_free = (free_mask >> lane) & 1u;
  const int f = base + __popc(free_mask & ((1u << lane) - 1u));
  if (is_free) {
    s_map[f] = t;
    s_x[f] = gv;
  }
  __syncthreads();

  // 4. dl = K^{-1} (g fm) fm on the free block (there K = P), the strictly
  // active rows 0; s_x[f] ends as the free coordinate f's dl
  const int ldf = nf | 1;
  if (nf > kOneWarpMaxN) {
    // the nf x nf free block of P, column-major in sA (sA[c * ldf + i] =
    // P[s_map[i]][s_map[c]]), factored by register tiles, one barrier a
    // column, and solved by warp 0, one shuffle a step (2 nf + 1 steps)
    for (int idx = t; idx < nf * nf; idx += kBwThreads) {
      const int c = idx / nf, i = idx - c * nf;
      sA[c * ldf + i] = sP[s_map[i] * ld + s_map[c]];
    }
    __syncthreads();
    chol_factor_fit<3, T::kNFMax>(sA, nf, ldf, s_rd, s_col, s_rs);
    if (w == 0) {
      constexpr int R = (16 * T::kNFMax + 31) / 32;   // rows a lane: nf <= 32 R
      float x[R];
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = 32 * a + lane < nf ? s_x[32 * a + lane] : 0.f;
      dq::ldl_solve_warp_rows<R>(sA, nf, ldf, s_rd, lane, x);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        if (32 * a + lane < nf) s_x[32 * a + lane] = x[a];
      }
    }
    __syncthreads();
  } else if (nf > 0) {
    // warp 0 alone, as the one-warp kernel: lane f < nf holds row f of the
    // free block in registers; no barrier until the block's below
    if (w == 0) {
      const bool lane_f = lane < nf;
      const int rf = lane_f ? s_map[lane] : 0;
      float a[kOneWarpMaxN];
#pragma unroll
      for (int k = 0; k < kOneWarpMaxN; ++k) {
        a[k] = (lane_f && k < nf) ? sP[rf * ld + s_map[k]] : 0.f;
      }
      const float dinv = dq::chol_factor_warp<kOneWarpMaxN>(a, nf, lane, sA, ldf, s_col);
      float x[1] = {lane_f ? s_x[lane] : 0.f};
      dq::ldl_solve_warp<1>(sA, nf, ldf, lane, dinv, x, s_col);
      if (lane_f) s_x[lane] = x[0];
    }
    __syncthreads();
  }
  if (real) dl_out[vo] = is_free ? s_x[f] : 0.f;

  if constexpr (kKind != kQP) {
    // 5. resid = (g - P dl) am, P dl over the free columns in order (dl is
    // an exact 0 on the others), accumulated from its first term
    float pdl = 0.f;
    if (real) {
#pragma unroll 4
      for (int k = 0; k < nf; ++k) pdl = __fadd_rn(pdl, __fmul_rn(row[s_map[k]], s_x[k]));
      coord_dgamma<kKind>(n, b, t, gv, pdl, am, d, dgamma_out, gamma_out);
    }
  }
}

// Dynamic shared memory one block needs for a problem of size n (the
// wrapper's smem_bytes in kernels/coord_bwd_cuda.py computes the same): P
// and the free block's factor (n x (n|1) each, the second filled to nf x
// (nf|1)) and, at one warp, the publish slots, l and the map of free
// coordinates (128 words); above it six n-vectors (the factor's columns,
// l and dl, 1 / L_ff, the map, and ten words of slots).
size_t smem_bytes(int n) {
  const size_t ld = n | 1;
  return sizeof(float) * (2 * n * ld + (n <= kOneWarpMaxN ? 128 : 6 * n));
}

// f(K4's instance of kind kKind that takes size n, its threads per block).
template <int kKind, typename F>
int with_kernel(int n, F f) {
  if (n <= 24) return f(coord_bwd_kernel_w<kKind, 24>, 32);
  if (n <= kOneWarpMaxN) return f(coord_bwd_kernel_w<kKind, 32>, 32);
  if (n <= kBwMidMaxN) return f(coord_bwd_kernel<kKind, BwMid>, kBwThreads);
  if (n <= kBwSmallMaxN) return f(coord_bwd_kernel<kKind, BwSmall>, kBwThreads);
  return f(coord_bwd_kernel<kKind, BwLarge>, kBwThreads);
}

// f(K4's instance of `kind` that takes size n, its threads per block), or
// cudaErrorInvalidValue for an unknown kind.
template <typename F>
int with_kind(int kind, int n, F f) {
  switch (kind) {
    case kQP:
      return with_kernel<kQP>(n, f);
    case kBox:
      return with_kernel<kBox>(n, f);
    case kSignedBox:
      return with_kernel<kSignedBox>(n, f);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Opt `kernel` into smem bytes of dynamic shared memory where that is above
// the default 48 KB, with the whole of the SM's unified memory as shared
// memory (three blocks at n = 96); returns a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem);
  if (e != 0) return e;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
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
  const size_t smem = smem_bytes(n);
  return with_kind(kind, n, [&](auto kernel, int threads) {
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    if (B > 0) {
      kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
          P, q, l, g, l_min, l_max, v_sign, dl_out, dgamma_out, gamma_out, n, eps, act_eps);
    }
    return (int)cudaGetLastError();
  });
}

// Blocks of K4 of `kind` that one SM holds at size n, from the occupancy
// calculator after the launch's attributes are set; -1 for an unknown kind,
// or a negated CUDA error code.
int dq_coord_bwd_blocks_per_sm(int n, int kind) {
  if (kind < kQP || kind > kSignedBox) return -1;
  const size_t smem = smem_bytes(n);
  return with_kind(kind, n, [&](auto kernel, int threads) {
    const int e = allow_smem(kernel, smem);
    if (e != 0) return -e;
    int blocks = 0;
    const int e2 =
        (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    return e2 != 0 ? -e2 : blocks;
  });
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Batched symmetric eigendecomposition by two-sided cyclic Jacobi, one launch
// for a whole batch (kernel E1).
//
// Replaces diffqcqp_tpu/ops/linalg.py:63 (factorize's jnp.linalg.eigh, which
// XLA compiles into the jitted program; no Pallas kernel): the spectral
// mode's set-up in the ADMM engine, P = V diag(lam) V^T once, after which
// every rho change is free. torch.linalg.eigh checks its info on the host, so
// a CUDA graph cannot hold it, and cuSOLVER's batched Jacobi stops at n = 32;
// this kernel reads nothing on the host and takes any N.
//
// Per problem (kernels/eigh_cuda.py's plain version does the same steps in
// the same order, and this file is built with -fmad=false, so that the two
// round alike): a sweep is m - 1 rounds of m / 2 disjoint pairs (m = N
// rounded up to even; at odd N index N is a dummy), round r pairing i and j
// where i + j = 2r (mod m - 1), and r with m - 1 (pair_of). A pair (p, q)
// rotates where |a_pq| > u sqrt(|a_pp| |a_qq|), u the unit roundoff, with
// Rutishauser's formulas (theta = (a_qq - a_pp) / (2 a_pq), t = sign(theta) /
// (|theta| + sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c). A round
// applies its rotations to A's rows and V^T's rows, then to A's columns, then
// sets a_pp - t a_pq, a_qq + t a_pq (the round's starting values) and zero
// off the diagonal of each rotated pair. A problem stops after a sweep with
// no rotation or after max_sweeps; then its eigenvalues are sorted by the
// rank #{j: l_j < l_i} + #{j < i: l_j = l_i} and V's columns with them. A P
// with a non-finite entry, or NaN eigenvalues, gives NaN outputs.
//
// What bounds it on this card: neither the operations (at least 12 N flops a
// rotation, rows p and q of A and of V^T; A's columns p and q are those rows
// by symmetry, which this kernel rotates as well, 18 N in all: at B = 4096,
// N = 24 float32 ~1.7 GFLOP, ~26 us at 67 TFLOP/s) nor the bytes (P in, V and
// lam out, ~19 MB, ~6 us at 3.35 TB/s). A round is a dependent step of each
// problem, N - 1 of them a sweep, and every entry of A and of V^T's rotated
// rows goes through shared memory once a round: a 2 x 2 block costs 8
// accesses of A, up to 8 of V^T and 3 (float32) or 5 (float64) shuffles for
// ~36 flops, with no fused multiply-add (-fmad=false). So the SM's
// shared-memory pipe, one 128-byte wavefront a clock (a float64 access of a
// warp takes two), sets the time once enough problems are in flight; the
// block maps keep a warp's accesses to one or two rows at distinct columns,
// so that few of them meet in a bank.
//
// Design:
//   * One fused pass a round over 2 x 2 blocks. The block of A at rows {p, q}
//     of pair k and columns {p', q'} of pair k' is rotated by k from the left
//     and then by k' from the right; both read only its own four entries, so
//     one thread does both, with the plain version's formulas in its order
//     (rows first, then columns), and writes the four entries once. A
//     rotating pair's diagonal block takes the t-formula values directly
//     (the plain version's write-back overwrites all four of them). The same
//     thread rotates rows p and q of V^T at columns p', q'. At odd N the
//     dummy's blocks are one wide. A round is the pair parameters, then the
//     fused pass: two synchronisation points, and no trip through shared
//     memory between the row and the column rotation.
//   * N <= 32: one warp a problem, several problems a block (sized from the
//     SM's shared memory and registers: plan_of). Lane k computes pair k's
//     parameters (and the lanes k + half, ... a copy) and keeps them in
//     registers. Lane l works on column pair l mod half and row pairs
//     l / half + (32 / half) j, taking each row pair's (c, s, p, q, rotates)
//     from its lane by __shfl_sync, so one warp instruction reads a row or
//     two at distinct columns (few bank conflicts). __syncwarp after the
//     fused pass; the sweep's "rotated" flag and the finite test are
//     __any_sync.
//   * N > 32: one block a problem, threads from the pass's work (about four
//     2 x 2 blocks a thread, to 1024); the parameters through shared memory,
//     __syncthreads after them and __syncthreads_or (the sweep's flag) after
//     the pass.
//   * Memory: A and V^T in dynamic shared memory with an odd row stride (a
//     walk down a column is free of bank conflicts), V kept transposed so
//     that its rotations, like A's rows, walk rows. Where both do not fit the
//     227 KB a block may opt into (float32 past N = 169, float64 past 119),
//     only V^T moves to a global workspace: it is rotated in the same pass
//     and never read back by A's chain. Past A's own bound (float32 N = 239,
//     float64 N = 169) both go to the workspace, so every N runs here.
//
// ptxas's registers and spills per kernel: chip_smoke.py phase 1 prints them
// from the build log.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxN = 32;               // one warp a problem to N = 32
constexpr int kWarpBound = 256;             // the warp kernel: at most 8 problems a block,
constexpr int kWarpMinBlocks = 4;           // ... and 4 such blocks an SM: 64 registers
constexpr int kBlockBound = 1024;           // the block-wide kernel, N > 32: 64 registers
constexpr int kBlocksPerThread = 4;         // 2 x 2 blocks a thread a round, block-wide
constexpr long long kSmemOptin = 232448;    // what a Hopper block may opt into
constexpr long long kSmemPerSm = 233472;    // shared memory of a Hopper SM
constexpr long long kSmemReserved = 1024;   // the runtime's share of it per block
constexpr int kRegsPerSm = 65536, kRegsPerThread = 64, kMaxBlocksPerSm = 32,
              kMaxWarpsPerSm = 64;

// Where a block-wide problem keeps A and V^T: the number of them in the
// global workspace
enum Layout { kShared = 0, kVtGlobal = 1, kGlobal = 2 };

template <typename T> struct Roundoff;
template <> struct Roundoff<float> { static constexpr float u = 1.0f / 16777216.0f; };     // 2^-24
template <> struct Roundoff<double> { static constexpr double u = 1.0 / 9007199254740992.0; };  // 2^-53

__device__ inline float qnan(float) { return __int_as_float(0x7fc00000); }
__device__ inline double qnan(double) { return __longlong_as_double(0x7ff8000000000000LL); }

// Pair k of round r at the even size m: (p, q), p < q; q >= N marks the dummy.
__device__ inline void pair_of(int r, int k, int m, int& p, int& q) {
  int a, b;
  if (k == 0) {
    a = r;
    b = m - 1;
  } else {
    a = (r + k) % (m - 1);
    b = (r - k + (m - 1)) % (m - 1);
  }
  p = min(a, b);
  q = max(a, b);
}

// (p, q, rotates) in one int: p and q below 2^15
__device__ inline int pack(int p, int q, bool rot) { return p | (q << 15) | (rot ? 1 << 30 : 0); }
__device__ inline int p_of(int pq) { return pq & 0x7fff; }
__device__ inline int q_of(int pq) { return (pq >> 15) & 0x7fff; }
__device__ inline bool rot_of(int pq) { return (pq >> 30) & 1; }

// Pair (p, q)'s parameters from the round's starting A: whether it rotates,
// c and s, and its diagonal's new values a_pp - t a_pq, a_qq + t a_pq.
template <typename T>
__device__ inline bool pair_params(const T* A, int ld, int n, int p, int q, T& c, T& s, T& npp,
                                   T& nqq) {
  c = T(1);
  s = T(0);
  npp = T(0);
  nqq = T(0);
  if (q >= n) return false;
  const T app = A[p * ld + p], aqq = A[q * ld + q], apq = A[p * ld + q];
  if (!(fabs(apq) > Roundoff<T>::u * sqrt(fabs(app) * fabs(aqq)))) return false;
  const T theta = (aqq - app) / (T(2) * apq);
  const T sgn = theta >= T(0) ? T(1) : T(-1);
  const T t = sgn / (fabs(theta) + sqrt(theta * theta + T(1)));
  c = T(1) / sqrt(t * t + T(1));
  s = t * c;
  npp = app - t * apq;
  nqq = aqq + t * apq;
  return true;
}

// One 2 x 2 block of the fused pass: rows {p, q} of the row pair (rotating
// by cr, sr where rr), columns {p2, q2} of the column pair (by cc, sc where
// rc), the plain version's row rotation first; a q or q2 at n or above is the
// dummy's missing row or column. V^T's rows p and q at the same columns.
template <typename T>
__device__ inline void fused_block(T* A, T* Vt, int ld, int n, int p, int q, bool rr, T cr, T sr,
                                   int p2, int q2, bool rc, T cc, T sc) {
  const bool hq = q < n, hq2 = q2 < n;
  T x00 = A[p * ld + p2];
  T x01 = hq2 ? A[p * ld + q2] : T(0);
  T x10 = hq ? A[q * ld + p2] : T(0);
  T x11 = hq && hq2 ? A[q * ld + q2] : T(0);
  T y;
  if (rr) {
    y = cr * x00 - sr * x10;
    x10 = sr * x00 + cr * x10;
    x00 = y;
    y = cr * x01 - sr * x11;
    x11 = sr * x01 + cr * x11;
    x01 = y;
  }
  if (rc) {
    y = cc * x00 - sc * x01;
    x01 = sc * x00 + cc * x01;
    x00 = y;
    y = cc * x10 - sc * x11;
    x11 = sc * x10 + cc * x11;
    x10 = y;
  }
  A[p * ld + p2] = x00;
  if (hq2) A[p * ld + q2] = x01;
  if (hq) A[q * ld + p2] = x10;
  if (hq && hq2) A[q * ld + q2] = x11;
  if (rr) {                      // rr implies q < n
    T u0 = Vt[p * ld + p2], v0 = Vt[q * ld + p2];
    Vt[p * ld + p2] = cr * u0 - sr * v0;
    Vt[q * ld + p2] = sr * u0 + cr * v0;
    if (hq2) {
      u0 = Vt[p * ld + q2];
      v0 = Vt[q * ld + q2];
      Vt[p * ld + q2] = cr * u0 - sr * v0;
      Vt[q * ld + q2] = sr * u0 + cr * v0;
    }
  }
}

// A rotating pair's diagonal block: the t-formula values, zero off the
// diagonal; V^T's rows p and q at columns p and q.
template <typename T>
__device__ inline void diagonal_block(T* A, T* Vt, int ld, int p, int q, T c, T s, T npp, T nqq) {
  A[p * ld + p] = npp;
  A[q * ld + q] = nqq;
  A[p * ld + q] = T(0);
  A[q * ld + p] = T(0);
  T u0 = Vt[p * ld + p], v0 = Vt[q * ld + p];
  Vt[p * ld + p] = c * u0 - s * v0;
  Vt[q * ld + p] = s * u0 + c * v0;
  u0 = Vt[p * ld + q];
  v0 = Vt[q * ld + q];
  Vt[p * ld + q] = c * u0 - s * v0;
  Vt[q * ld + q] = s * u0 + c * v0;
}

int ld_of(int n) { return n | 1; }

// Bytes of A (or of V^T) of one problem
long long plane_bytes(int n, int item) { return (long long)item * n * ld_of(n); }

// Block-wide scratch: per pair (c, s, new a_pp, new a_qq) in T and the
// packed (p, q, rotates), then the inverse ranks (n ints)
long long scratch_bytes(int n, int item) {
  const long long pairs = (n + 1) / 2;
  return item * 4 * pairs + 4 * (pairs + n);
}

// A and V^T both fit shared memory (the first design's bound, unchanged)
bool in_shared(int n, int item) {
  return 2 * plane_bytes(n, item) + scratch_bytes(n, item) <= kSmemOptin;
}

// A alone fits shared memory
bool a_in_shared(int n, int item) {
  return plane_bytes(n, item) + scratch_bytes(n, item) <= kSmemOptin;
}

// One problem's shared memory in the warp kernel: A, V^T, the inverse ranks,
// rounded up to 16 bytes
long long warp_problem_bytes(int n, int item) {
  return (2 * plane_bytes(n, item) + 4 * n + 15) / 16 * 16;
}

struct Plan {
  int warp, problems, threads, bound, layout;
  long long smem;
};

// Problems an SM holds with `problems` a block of `per` shared bytes each
// (32 threads and 64 registers a problem)
int warp_problems_per_sm(int problems, long long per) {
  const long long by_smem = kSmemPerSm / (problems * per + kSmemReserved);
  const long long by_regs = kRegsPerSm / ((long long)kRegsPerThread * 32 * problems);
  long long blocks = by_smem < by_regs ? by_smem : by_regs;
  if (blocks > kMaxBlocksPerSm) blocks = kMaxBlocksPerSm;
  if (blocks > kMaxWarpsPerSm / problems) blocks = kMaxWarpsPerSm / problems;
  return (int)blocks * problems;
}

Plan plan_of(int n, int item) {
  Plan pl;
  if (n <= kWarpMaxN) {
    // the fewest problems a block that give the most problems an SM
    const long long per = warp_problem_bytes(n, item);
    int best = 1;
    for (int w = 2; w * 32 <= kWarpBound; ++w)
      if (warp_problems_per_sm(w, per) > warp_problems_per_sm(best, per)) best = w;
    pl.warp = 1;
    pl.problems = best;
    pl.threads = 32 * best;
    pl.bound = kWarpBound;
    pl.layout = kShared;
    pl.smem = best * per;
    return pl;
  }
  const long long half = (n + 1) / 2;
  const long long per_warp = 32LL * kBlocksPerThread;
  long long threads = (half * half + per_warp - 1) / per_warp * 32;
  if (threads > kBlockBound) threads = kBlockBound;
  pl.warp = 0;
  pl.problems = 1;
  pl.threads = (int)threads;
  pl.bound = kBlockBound;
  pl.layout = in_shared(n, item) ? kShared : a_in_shared(n, item) ? kVtGlobal : kGlobal;
  pl.smem = scratch_bytes(n, item) + (2 - pl.layout) * plane_bytes(n, item);
  return pl;
}

// ---------------------------------------------------------------------------
// N <= 32: one warp a problem
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kWarpBound, kWarpMinBlocks)
jacobi_eigh_warp_kernel(const T* __restrict__ P, T* __restrict__ w, T* __restrict__ V,
                        int* __restrict__ sweeps, int B, int n, int max_sweeps,
                        long long per_problem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const size_t b = (size_t)blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= (size_t)B) return;                 // the whole warp: no block barrier below
  const int ld = n | 1;
  const int m = n + (n & 1);
  const int half = m / 2;
  T* A = reinterpret_cast<T*>(smem_raw + wid * per_problem);
  T* Vt = A + n * ld;
  int* s_inv = reinterpret_cast<int*>(Vt + n * ld);

  const T* Pb = P + b * n * n;
  bool nonfinite = false;
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, j = idx - i * n;
    const T v = Pb[idx];
    nonfinite |= !isfinite(v);
    A[i * ld + j] = v;
    Vt[i * ld + j] = i == j ? T(1) : T(0);
  }
  const bool bad_input = __any_sync(kFull, nonfinite);
  __syncwarp();

  // the block map: lane l works on column pair kc = l mod half, row pairs
  // grp + g j, grp = l / half (g groups of half lanes; the rest idle), so
  // the lanes of one group read one row at distinct columns (no bank
  // conflict in float32) and every lane computes its column pair's
  // parameters (its group's copy of them, at no extra issue)
  const int g = 32 / half;
  const int kc = lane % half, grp = lane / half;
  const int mine = grp < g ? (half - grp + g - 1) / g : 0;    // blocks of this lane
  const int steps = (half + g - 1) / g;                        // the most any lane has

  int sweep = 0;
  while (!bad_input && sweep < max_sweeps) {
    bool rotated = false;
    for (int r = 0; r < m - 1; ++r) {
      // column pair kc's parameters
      T c = T(1), s = T(0), npp = T(0), nqq = T(0);
      int pq = 0;
      if (grp < g) {
        int p, q;
        pair_of(r, kc, m, p, q);
        const bool rot = pair_params(A, ld, n, p, q, c, s, npp, nqq);
        rotated |= rot;
        pq = pack(p, q, rot);
      }
      const int p2 = p_of(pq), q2 = q_of(pq);
      const bool rc = rot_of(pq);
      for (int j = 0; j < steps; ++j) {
        const int k = grp + g * j;                // the row pair, from lane k
        const int src = j < mine ? k : 0;
        const T cr = __shfl_sync(kFull, c, src), sr = __shfl_sync(kFull, s, src);
        const int pqr = __shfl_sync(kFull, pq, src);
        if (j < mine) {
          const bool rr = rot_of(pqr);
          if (k == kc) {
            if (rc) diagonal_block(A, Vt, ld, p2, q2, c, s, npp, nqq);
          } else if (rr || rc) {
            fused_block(A, Vt, ld, n, p_of(pqr), q_of(pqr), rr, cr, sr, p2, q2, rc, c, s);
          }
        }
      }
      __syncwarp();
    }
    ++sweep;
    if (!__any_sync(kFull, rotated)) break;
  }

  // ascending order by rank, ties by index; NaN outputs for a bad problem
  const T li = lane < n ? A[lane * ld + lane] : T(0);
  const bool bad = bad_input || __any_sync(kFull, lane < n && isnan(li));
  int rank = lane;
  if (!bad) {
    rank = 0;
    for (int j = 0; j < n; ++j) {
      const T lj = __shfl_sync(kFull, li, j);
      rank += (lj < li) || (lj == li && j < lane);
    }
  }
  if (lane < n) s_inv[rank] = lane;
  __syncwarp();
  const T nan = qnan(T(0));
  if (lane < n) w[b * n + lane] = bad ? nan : A[s_inv[lane] * ld + s_inv[lane]];
  T* Vb = V + b * n * n;
  for (int idx = lane; idx < n * n; idx += 32) {
    const int row = idx / n, col = idx - row * n;
    Vb[idx] = bad ? nan : Vt[s_inv[col] * ld + row];
  }
  if (lane == 0) sweeps[b] = bad_input ? 0 : sweep;
}

// ---------------------------------------------------------------------------
// N > 32: one block a problem
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kBlockBound)
jacobi_eigh_block_kernel(const T* __restrict__ P, T* __restrict__ w, T* __restrict__ V,
                         int* __restrict__ sweeps, T* work, int n, int max_sweeps, int layout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n | 1;
  const int m = n + (n & 1);
  const int half = m / 2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t b = blockIdx.x;
  T* base = reinterpret_cast<T*>(smem_raw);
  T *A, *Vt, *scratch;
  if (layout == kShared) {
    A = base;
    Vt = A + n * ld;
    scratch = Vt + n * ld;
  } else if (layout == kVtGlobal) {
    A = base;
    Vt = work + b * n * ld;
    scratch = A + n * ld;
  } else {
    A = work + b * 2 * n * ld;
    Vt = A + n * ld;
    scratch = base;
  }
  T* s_c = scratch;
  T* s_s = s_c + half;
  T* s_npp = s_s + half;
  T* s_nqq = s_npp + half;
  int* s_pq = reinterpret_cast<int*>(s_nqq + half);
  int* s_inv = s_pq + half;

  const T* Pb = P + b * n * n;
  bool nonfinite = false;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - i * n;
    const T v = Pb[idx];
    nonfinite |= !isfinite(v);
    A[i * ld + j] = v;
    Vt[i * ld + j] = i == j ? T(1) : T(0);
  }
  const bool bad_input = __syncthreads_or(nonfinite);

  // the block map: block idx holds row pair idx / half and column pair
  // idx mod half, so neighbouring threads read one row at distinct columns;
  // a thread steps idx by nt
  const int dkc = nt % half, dk = nt / half;
  const int k0 = tid / half, kc0 = tid % half;

  int sweep = 0;
  while (!bad_input && sweep < max_sweeps) {
    bool rotated = false, any = false;
    for (int r = 0; r < m - 1; ++r) {
      for (int k = tid; k < half; k += nt) {
        int p, q;
        pair_of(r, k, m, p, q);
        T c, s, npp, nqq;
        const bool rot = pair_params(A, ld, n, p, q, c, s, npp, nqq);
        rotated |= rot;
        s_c[k] = c;
        s_s[k] = s;
        s_npp[k] = npp;
        s_nqq[k] = nqq;
        s_pq[k] = pack(p, q, rot);
      }
      __syncthreads();
      int k = k0, kc = kc0;
      while (k < half) {
        const int pqr = s_pq[k], pqc = s_pq[kc];
        const bool rr = rot_of(pqr), rc = rot_of(pqc);
        if (kc == k) {
          if (rr)
            diagonal_block(A, Vt, ld, p_of(pqr), q_of(pqr), s_c[k], s_s[k], s_npp[k], s_nqq[k]);
        } else if (rr || rc) {
          fused_block(A, Vt, ld, n, p_of(pqr), q_of(pqr), rr, s_c[k], s_s[k], p_of(pqc),
                      q_of(pqc), rc, s_c[kc], s_s[kc]);
        }
        k += dk;
        kc += dkc;
        if (kc >= half) {
          kc -= half;
          ++k;
        }
      }
      any = __syncthreads_or(rotated);
    }
    ++sweep;
    if (!any) break;
  }

  // ascending order by rank, ties by index; NaN outputs for a bad problem
  bool nan_here = false;
  for (int i = tid; i < n; i += nt) nan_here |= isnan(A[i * ld + i]);
  const bool bad = bad_input || __syncthreads_or(nan_here);
  for (int i = tid; i < n; i += nt) {
    int rank = i;
    if (!bad) {
      const T li = A[i * ld + i];
      rank = 0;
      for (int j = 0; j < n; ++j) {
        const T lj = A[j * ld + j];
        rank += (lj < li) || (lj == li && j < i);
      }
    }
    s_inv[rank] = i;
  }
  __syncthreads();
  const T nan = qnan(T(0));
  for (int c = tid; c < n; c += nt) {
    const int i = s_inv[c];
    w[b * n + c] = bad ? nan : A[i * ld + i];
  }
  T* Vb = V + b * n * n;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int row = idx / n, c = idx - row * n;
    Vb[idx] = bad ? nan : Vt[s_inv[c] * ld + row];
  }
  if (tid == 0) sweeps[b] = bad_input ? 0 : sweep;
}

// Opt the kernel into smem bytes of dynamic shared memory and the SM's
// largest shared-memory carveout; a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, long long smem) {
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)smem);
    if (e != 0) return e;
  }
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const T* P, T* w, T* V, int* sweeps, T* work, int B, int n, int max_sweeps,
           void* stream) {
  const Plan pl = plan_of(n, sizeof(T));
  const int grid = (B + pl.problems - 1) / pl.problems;
  if (pl.warp) {
    const int e = allow_smem(jacobi_eigh_warp_kernel<T>, pl.smem);
    if (e != 0) return e;
    if (B > 0)
      jacobi_eigh_warp_kernel<T><<<grid, pl.threads, (size_t)pl.smem, (cudaStream_t)stream>>>(
          P, w, V, sweeps, B, n, max_sweeps, pl.smem / pl.problems);
  } else {
    const int e = allow_smem(jacobi_eigh_block_kernel<T>, pl.smem);
    if (e != 0) return e;
    if (B > 0)
      jacobi_eigh_block_kernel<T><<<grid, pl.threads, (size_t)pl.smem, (cudaStream_t)stream>>>(
          P, w, V, sweeps, work, n, max_sweeps, pl.layout);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int n) {
  const Plan pl = plan_of(n, sizeof(T));
  int blocks = 0, e;
  if (pl.warp) {
    e = allow_smem(jacobi_eigh_warp_kernel<T>, pl.smem);
    if (e == 0)
      e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, jacobi_eigh_warp_kernel<T>, pl.threads, (size_t)pl.smem);
  } else {
    e = allow_smem(jacobi_eigh_block_kernel<T>, pl.smem);
    if (e == 0)
      e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, jacobi_eigh_block_kernel<T>, pl.threads, (size_t)pl.smem);
  }
  return e != 0 ? -e : blocks;
}

}  // namespace

extern "C" {

// The launch at size n for items of `item` bytes (4 or 8): whether one warp
// works on a problem, problems a block, threads a block, dynamic shared
// memory a block, the kernel's __launch_bounds__ and where A and V^T sit
// (0 shared memory, 1 V^T in the workspace, 2 both there).
void dq_jacobi_eigh_plan(int n, int item, int* warp, int* problems, int* threads,
                         long long* smem, int* bound, int* layout) {
  const Plan pl = plan_of(n, item);
  *warp = pl.warp;
  *problems = pl.problems;
  *threads = pl.threads;
  *smem = pl.smem;
  *bound = pl.bound;
  *layout = pl.layout;
}

// Blocks of the plan at size n that one SM of the current card holds, from
// the occupancy calculator after the launch's attributes are set; a negated
// CUDA error code on failure.
int dq_jacobi_eigh_blocks_per_sm(int n, int item) {
  return item == 8 ? blocks_per_sm<double>(n) : blocks_per_sm<float>(n);
}

// Launch E1 on `stream` for B problems of size n: P and V (B, n, n)
// row-major, w (B, n), sweeps (B,) int32; `work` is null where the plan keeps
// A and V^T in shared memory, else a (B, e) workspace, e = n (n | 1) where
// only V^T is there and 2 n (n | 1) where both are. All device pointers to
// contiguous memory allocated by the caller. Returns cudaGetLastError().
int dq_jacobi_eigh_f32(const float* P, float* w, float* V, int* sweeps, float* work, int B,
                       int n, int max_sweeps, void* stream) {
  return launch<float>(P, w, V, sweeps, work, B, n, max_sweeps, stream);
}

int dq_jacobi_eigh_f64(const double* P, double* w, double* V, int* sweeps, double* work, int B,
                       int n, int max_sweeps, void* stream) {
  return launch<double>(P, w, V, sweeps, work, B, n, max_sweeps, stream);
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

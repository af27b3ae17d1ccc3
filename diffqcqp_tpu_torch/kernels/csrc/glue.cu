// The QP family's P-sized passes around the solve, one pass each (kernels
// G1 and G2).
//
// Replaces no TPU kernel: the JAX package leaves both to XLA, which fuses
// them into the jitted step. In the port they were plain PyTorch ops, each
// writing a B x N x N tensor: P's symmetrisation 0.5 (P + P^T) in
// utils/shapes.py::canon_problem (an add with a transposed, strided read,
// then a scale), autograd's adjoint of it (a scale, then the gradient plus
// its transpose) and api.py::_grad_P, -(dl l^T + l dl^T) / 2 (two outer
// products, an add and a scale). At config 6's size (B = 2048, N = 96,
// float32) one B x N x N pass is 75.5 MB, ~0.0225 ms at 3.35 TB/s.
//
// What bounds them on this card: the bytes alone. Each does O(1) flops an
// element. G1 reads every element once and writes every element once; G2
// reads only dl and l (B x N) and writes every element once. So the design
// reads and writes each element once, 16 bytes a thread in long contiguous
// runs wherever the layout allows, and keeps 64-bit integer division (a
// long subroutine on the card) off the per-element path.
//
//   * G1, symmetrize_runs (a matrix within 48 KB: float32 N <= 110,
//     float64 N <= 78; rows one aligned run, N a multiple of 16 bytes'
//     worth): a block takes one whole matrix, or several up to kWholeElems
//     elements at small N, stages it in shared memory with rows of N | 1
//     and writes it out. Both passes walk the block's matrices as one flat
//     run, 16 bytes a thread; an output run's mirror entries are read down
//     columns of the staged copy. On an H100 (CUDA graphs of 20 calls,
//     profiler device time a call; chip_smoke.py glue): at config 6's size
//     (B = 2048, N = 96) 0.0539 ms, a plain copy of P 0.0516, PyTorch's
//     two ops 0.1516; at B = 4096, N = 24 0.0056 against 0.0123. Forms
//     tried before it: mirrored 32 x 32 tile pairs 0.0719 ms at N = 96
//     (short rows scattered over the matrix); whole matrices written a warp
//     a row 0.0547 at N = 96 but 0.0123 at N = 24 (idle lanes, rows
//     chained).
//   * G1, symmetrize_tiles (every other input: larger or odd N, a
//     transposed view, a batch-broadcast P at small N): a block takes a
//     pair of mirrored 32 x 32 tiles (I, J) and (J, I), I < J, stages both
//     in shared memory (rows padded to 33) and writes both from there; a
//     diagonal tile (I, I) is taken alone. Rows and columns at N and beyond
//     are masked.
//   * G1 reads P through its strides (batch, row, column), so a P shared by
//     a batch (batch stride 0) is read once a problem without a copy; its
//     output is contiguous.
//   * G2, grad_p_kernel: a block takes kRuns passes of its threads over
//     rows of the (B N, N) output. A thread writes one run of a row a pass:
//     16 bytes where N is a multiple of the run's length and the pointers
//     are 16-byte aligned (its columns' dl and l one 16-byte load each),
//     else one element. dl and l are read through L1 (__ldg), where one
//     matrix's N values serve its N rows; nothing is staged, so no size
//     bounds the launch. Rows and matrices advance by additions, not
//     divisions. Its 75.5 MB of writes at config 6's size take 0.0225 ms
//     at 3.35 TB/s; PyTorch's four ops took 0.2278 (chip_smoke.py glue).
//
// The arithmetic is the plain versions' (kernels/glue_cuda.py), in their
// order, and this file is built with -fmad=false (_build.SOURCE_FLAGS) so
// that no product is fused into a sum; both kernels give their plain
// versions' bits:
//   * G1 forward: (a + b) * 0.5, a = P_ij, b = P_ji (PyTorch's
//     0.5 * (P + P^T)); G1 adjoint: 0.5 a + 0.5 b (autograd's adjoint of
//     that expression: the gradient scaled by 0.5, then added to its
//     transpose). Both are symmetric in a and b, so the output is exactly
//     symmetric;
//   * G2: -0.5 * (dl_i l_j + l_i dl_j), the two products rounded before the
//     sum. Products and the sum commute, so the output is exactly
//     symmetric; a fused multiply-add would break that.
//
// ptxas's registers and spills per kernel: chip_smoke.py phase 1 prints them
// from the build log.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;                   // G1's tile edge (one warp a tile row)
constexpr int kTileRows = 8;                // G1's block: kTile x kTileRows threads
constexpr int kThreads = kTile * kTileRows;
constexpr size_t kWholeBytes = 48 * 1024;   // G1 takes whole matrices a block to this size
constexpr int kWholeElems = 4096;           // ... and several, up to this many elements, below
constexpr int kRuns = 4;                    // G2: passes of the block's threads over its rows

template <bool kAdjoint, typename T>
__device__ __forceinline__ T sym(T a, T b) {
  if (kAdjoint) return T(0.5) * a + T(0.5) * b;
  return (a + b) * T(0.5);
}

// a / b for a >= 0, in 32-bit arithmetic where a fits (a 64-bit division is
// a long subroutine on the card)
__device__ __forceinline__ long long div_ll(long long a, int b) {
  return a <= 0x7fffffffLL ? (long long)((int)a / b) : a / b;
}

template <bool kAdjoint, typename T>
__global__ void __launch_bounds__(kThreads)
symmetrize_tiles(const T* __restrict__ x, T* __restrict__ y, long long B, int n, long long sb,
                 long long sr, long long sc, int tiles) {
  __shared__ T a[kTile][kTile + 1];
  __shared__ T b[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int pairs = tiles * (tiles + 1) / 2;
  const long long work = B * pairs;
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const long long p = div_ll(w, pairs);
    int k = (int)(w - p * pairs);
    int I = 0;                                // pair k -> (I, J), I <= J, row by row
    while (k >= tiles - I) {
      k -= tiles - I;
      ++I;
    }
    const int J = I + k;
    const int i0 = I * kTile, j0 = J * kTile;
    const T* xp = x + p * sb;
    T* yp = y + p * (long long)n * n;
    for (int r = ty; r < kTile; r += kTileRows) {
      if (i0 + r < n && j0 + tx < n) a[r][tx] = xp[(i0 + r) * sr + (j0 + tx) * sc];
      if (I != J && j0 + r < n && i0 + tx < n) b[r][tx] = xp[(j0 + r) * sr + (i0 + tx) * sc];
    }
    __syncthreads();
    for (int r = ty; r < kTile; r += kTileRows) {
      if (I == J) {
        if (i0 + r < n && i0 + tx < n)
          yp[(long long)(i0 + r) * n + i0 + tx] = sym<kAdjoint>(a[r][tx], a[tx][r]);
      } else {
        if (i0 + r < n && j0 + tx < n)
          yp[(long long)(i0 + r) * n + j0 + tx] = sym<kAdjoint>(a[r][tx], b[tx][r]);
        if (j0 + r < n && i0 + tx < n)
          yp[(long long)(j0 + r) * n + i0 + tx] = sym<kAdjoint>(b[r][tx], a[tx][r]);
      }
    }
    __syncthreads();
  }
}

// 16 bytes of T
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int kLen = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int kLen = 2; };

// G1 with whole matrices a block, 16 bytes a thread: `per` matrices staged
// in shared memory with rows of n | 1, then written out, both passes over
// the block's matrices as one flat run of 16-byte runs (q), each run within
// a row since n is a multiple of L = 16 / sizeof(T). The input's matrices
// are one aligned run of x each, one after the other where per > 1 (sb =
// n n). An output run's mirror entries are read down columns of the staged
// copy.
template <bool kAdjoint, typename T>
__global__ void __launch_bounds__(kThreads)
symmetrize_runs(const T* __restrict__ x, T* __restrict__ y, long long B, int n, long long sb,
                int per) {
  using V = typename Vec<T>::type;
  constexpr int L = Vec<T>::kLen;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ld = n | 1, nn = n * n;
  for (long long p0 = (long long)blockIdx.x * per; p0 < B;
       p0 += (long long)gridDim.x * per) {
    const int runs = (int)(B - p0 < per ? B - p0 : per) * nn / L;
    const V* xv = reinterpret_cast<const V*>(x + p0 * sb);
#pragma unroll 4
    for (int q = threadIdx.x; q < runs; q += kThreads) {
      const V v = xv[q];
      const int e = q * L, R = e / n, c = e - R * n;     // row R of the block's rows, column c
      const T* pv = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < L; ++k) s[R * ld + c + k] = pv[k];
    }
    __syncthreads();
    V* yv = reinterpret_cast<V*>(y + p0 * nn);
#pragma unroll 4
    for (int q = threadIdx.x; q < runs; q += kThreads) {
      const int e = q * L, R = e / n, c = e - R * n, m = R / n, r = R - m * n;
      const T* row = s + R * ld + c;                    // entries (r, c + k) of matrix m ...
      const T* col = s + (m * n + c) * ld + r;          // ... and their mirrors (c + k, r)
      V out;
      T* po = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < L; ++k) po[k] = sym<kAdjoint>(row[k], col[k * ld]);
      yv[q] = out;
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ T grad_entry(T dli, T li, T dlj, T lj) {
  const T a = dli * lj, b = li * dlj;
  return T(-0.5) * (a + b);
}

__device__ __forceinline__ float4 ldg16(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ double2 ldg16(const double* p) {
  return __ldg(reinterpret_cast<const double2*>(p));
}

// G2 over rows of the output (B n rows of n): a block takes kRuns passes of
// rpp rows, thread t run t mod rpr of row t / rpr of each pass, a run L
// elements (16 bytes where L > 1). Row g of the output is row i = g mod n
// of matrix g / n, so its dl_i and l_i are dl[g] and l[g], and its columns'
// dl_j and l_j the matrix's run dl[g - i + j]; all are read through L1,
// where a matrix's n values serve its n rows.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
grad_p_kernel(const T* __restrict__ dl, const T* __restrict__ l, T* __restrict__ out,
              long long rows_total, int n, int rpr, int rpp) {
  const int rr = rpr <= kThreads ? threadIdx.x / rpr : 0;        // this thread's row of a pass
  const int ci0 = rpr <= kThreads ? threadIdx.x - rr * rpr : threadIdx.x;
  const int cstride = rpr <= kThreads ? rpr : kThreads;
  if (rr >= rpp) return;
  const int rpb = rpp * kRuns, step_i = rpp % n, step_mo = rpp / n * n;
  for (long long g0 = (long long)blockIdx.x * rpb; g0 < rows_total;
       g0 += (long long)gridDim.x * rpb) {
    const long long g_end = g0 + rpb < rows_total ? g0 + rpb : rows_total;
    long long g = g0 + rr;
    long long mo = div_ll(g, n) * n;                     // row g: row i of the matrix at mo
    int i = (int)(g - mo);
    for (; g < g_end; g += rpp) {
      const T dli = __ldg(dl + g), li = __ldg(l + g);
      T* orow = out + g * n;
      for (int ci = ci0; ci < rpr; ci += cstride) {
        const int c = ci * L;
        if (L > 1) {
          using V = typename Vec<T>::type;
          const V dlj = ldg16(dl + mo + c), lj = ldg16(l + mo + c);
          const T* pdl = reinterpret_cast<const T*>(&dlj);
          const T* pl = reinterpret_cast<const T*>(&lj);
          V run;
          T* v = reinterpret_cast<T*>(&run);
#pragma unroll
          for (int k = 0; k < L; ++k) v[k] = grad_entry(dli, li, pdl[k], pl[k]);
          *reinterpret_cast<V*>(orow + c) = run;
        } else {
          orow[c] = grad_entry(dli, li, __ldg(dl + mo + c), __ldg(l + mo + c));
        }
      }
      i += step_i;
      mo += step_mo;
      if (i >= n) {
        i -= n;
        mo += n;
      }
    }
  }
}

// Blocks a grid-stride launch takes: the work, capped where one block a
// unit of work would pass CUDA's grid limit.
unsigned grid_of(long long units) {
  const long long cap = 1LL << 30;
  return (unsigned)(units < cap ? units : cap);
}

// G1's launch: symmetrize_runs where a matrix fits kWholeBytes, its rows
// are one aligned run of x, n is a multiple of 16 bytes' worth and the
// block's matrices follow one another (or it takes one); else
// symmetrize_tiles, through the strides.
template <bool kAdjoint, typename T>
int symmetrize_launch(const T* x, T* y, long long B, int n, long long sb, long long sr,
                      long long sc, cudaStream_t stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  constexpr int L = Vec<T>::kLen;
  const int ld = n | 1;
  const int per = kWholeElems / (n * ld) > 1 ? kWholeElems / (n * ld) : 1;
  if ((size_t)n * ld * sizeof(T) <= kWholeBytes && sr == n && sc == 1 && n % L == 0 &&
      (per == 1 ? sb % L == 0 : sb == (long long)n * n) &&
      reinterpret_cast<size_t>(x) % 16 == 0) {
    symmetrize_runs<kAdjoint, T><<<grid_of((B + per - 1) / per), kThreads,
                                   sizeof(T) * per * n * ld, stream>>>(x, y, B, n, sb, per);
  } else {
    const int tiles = (n + kTile - 1) / kTile;
    symmetrize_tiles<kAdjoint, T><<<grid_of(B * (tiles * (tiles + 1) / 2)),
                                    dim3(kTile, kTileRows), 0, stream>>>(x, y, B, n, sb, sr, sc,
                                                                         tiles);
  }
  return (int)cudaGetLastError();
}

// G2's launch: runs of 16 bytes where n is a multiple of them and dl, l
// and out are 16-byte aligned, else of one element; rows a pass of the
// block's threads as many as whole rows of runs fit.
template <typename T>
int grad_p_launch(const T* dl, const T* l, T* out, long long B, int n, cudaStream_t stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  constexpr int L = Vec<T>::kLen;
  const bool runs = n % L == 0 &&
      (reinterpret_cast<size_t>(dl) | reinterpret_cast<size_t>(l) |
       reinterpret_cast<size_t>(out)) % 16 == 0;
  const int rpr = runs ? n / L : n;                         // runs a row
  const int rpp = rpr <= kThreads ? kThreads / rpr : 1;     // rows a pass
  const long long rows = B * n;
  const unsigned grid = grid_of((rows + rpp * kRuns - 1) / (rpp * kRuns));
  if (runs)
    grad_p_kernel<T, L><<<grid, kThreads, 0, stream>>>(dl, l, out, rows, n, rpr, rpp);
  else
    grad_p_kernel<T, 1><<<grid, kThreads, 0, stream>>>(dl, l, out, rows, n, rpr, rpp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// G1 on `stream`: y (B, n, n) contiguous = 0.5 (x + x^T) (adjoint = 0:
// (a + b) * 0.5) or 0.5 x + 0.5 x^T (adjoint = 1), x read at element
// strides (sb, sr, sc). `bytes` is the element size: 4 (float32) or 8
// (float64). Returns cudaGetLastError().
int dq_symmetrize(const void* x, void* y, long long B, int n, long long sb, long long sr,
                  long long sc, int bytes, int adjoint, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes == 8) {
    const double* xd = (const double*)x;
    double* yd = (double*)y;
    return adjoint ? symmetrize_launch<true>(xd, yd, B, n, sb, sr, sc, s)
                   : symmetrize_launch<false>(xd, yd, B, n, sb, sr, sc, s);
  }
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  return adjoint ? symmetrize_launch<true>(xf, yf, B, n, sb, sr, sc, s)
                 : symmetrize_launch<false>(xf, yf, B, n, sb, sr, sc, s);
}

// G2 on `stream`: out (B, n, n) = -0.5 (dl l^T + l dl^T) from dl, l (B, n),
// all contiguous, of `bytes` a element (4 or 8). Returns
// cudaGetLastError().
int dq_grad_p(const void* dl, const void* l, void* out, long long B, int n, int bytes,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes == 8)
    return grad_p_launch((const double*)dl, (const double*)l, (double*)out, B, n, s);
  return grad_p_launch((const float*)dl, (const float*)l, (float*)out, B, n, s);
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

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
// What bounds it on this card: the operations, at least 12 N flops a
// rotation (rows p and q of A and of V^T; A's columns p and q are those rows
// by symmetry, which this kernel rotates as well, 18 N in all), about 6 N^3
// a sweep, 7-10 sweeps at N = 24; the bytes are P in, V and lam out. At B =
// 4096, N = 24 in float32 the rotations applied come to ~1.7 GFLOP, ~26 us
// at 67 TFLOP/s, against ~19 MB, ~6 us at 3.35 TB/s. Neither is near (~1.2
// ms on an H100): a round is four dependent passes over shared memory, one
// __syncthreads each, N - 1 rounds a sweep, so the chain of barriers sets
// the time, as the chain of steps does in K5.
//
// Design: one block a problem (64 threads to N = 16, 128 to N = 48, 256
// above), A and V^T in dynamic shared memory with an odd row stride, so a
// walk down a column is free of bank conflicts; V is kept transposed so that
// its rotations, like A's row rotations, walk rows. Where A and V^T do not
// fit the 227 KB a block may opt into (float32 past N = 169, float64 past N =
// 119) the same kernel works on a global-memory workspace the wrapper
// allocates, so every N runs here. A round's pairs are computed by one thread
// each; the rows and columns by one thread an element pair. The stopping flag
// and the ranks live in shared memory; nothing is read on the host.
//
// ptxas (sm_90a): 48 registers in float64, 32 and a 12-byte spill in float32
// (chip_smoke.py phase 1 prints them from the build log).
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBound = 256;                       // the largest block, N > 48
constexpr long long kSmemOptin = 232448;          // what a Hopper block may opt into

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

int ld_of(int n) { return n | 1; }

int threads_of(int n) { return n <= 16 ? 64 : n <= 48 ? 128 : 256; }

// Shared memory of a block: per pair (c, s, t, a_pp, a_qq, a_pq) in T, then
// (p, q) in int, the inverse ranks (n ints) and four flags; A and V^T in
// front of them where `in_shared`.
long long scratch_bytes(int n, int item) {
  const long long pairs = (n + 1) / 2;
  return item * 6 * pairs + 4 * (2 * pairs + n + 4);
}

long long data_bytes(int n, int item) { return (long long)item * 2 * n * ld_of(n); }

bool in_shared(int n, int item) { return data_bytes(n, item) + scratch_bytes(n, item) <= kSmemOptin; }

template <typename T>
__global__ void __launch_bounds__(kBound)
jacobi_eigh_kernel(const T* __restrict__ P, T* __restrict__ w, T* __restrict__ V,
                   int* __restrict__ sweeps, T* __restrict__ work, int n, int max_sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n | 1;
  const int m = n + (n & 1);
  const int half = m / 2;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  T* A;
  T* scratch;
  if (work == nullptr) {
    A = reinterpret_cast<T*>(smem_raw);
    scratch = A + 2 * n * ld;
  } else {
    A = work + b * 2 * n * ld;
    scratch = reinterpret_cast<T*>(smem_raw);
  }
  T* Vt = A + n * ld;
  T* s_c = scratch;
  T* s_s = s_c + half;
  T* s_t = s_s + half;
  T* s_app = s_t + half;
  T* s_aqq = s_app + half;
  T* s_apq = s_aqq + half;
  int* s_p = reinterpret_cast<int*>(s_apq + half);
  int* s_q = s_p + half;         // -1 where the pair does not rotate this round
  int* s_inv = s_q + half;       // the eigen index of each rank
  int* s_flag = s_inv + n;       // [0] a pair rotated this sweep, [1] P not finite,
                                 // [2] an eigenvalue is NaN
  const T u = Roundoff<T>::u;

  if (tid < 4) s_flag[tid] = 0;
  __syncthreads();
  const T* Pb = P + b * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    const T v = Pb[idx];
    if (!isfinite(v)) s_flag[1] = 1;
    A[i * ld + j] = v;
    Vt[i * ld + j] = i == j ? T(1) : T(0);
  }
  __syncthreads();
  const bool bad_input = s_flag[1] != 0;

  int sweep = 0;
  while (!bad_input && sweep < max_sweeps) {
    if (tid == 0) s_flag[0] = 0;
    __syncthreads();
    for (int r = 0; r < m - 1; ++r) {
      // the round's rotations, one thread a pair
      for (int k = tid; k < half; k += blockDim.x) {
        int p, q;
        pair_of(r, k, m, p, q);
        int rot_q = -1;
        if (q < n) {
          const T app = A[p * ld + p], aqq = A[q * ld + q], apq = A[p * ld + q];
          if (fabs(apq) > u * sqrt(fabs(app) * fabs(aqq))) {
            const T theta = (aqq - app) / (T(2) * apq);
            const T sgn = theta >= T(0) ? T(1) : T(-1);
            const T t = sgn / (fabs(theta) + sqrt(theta * theta + T(1)));
            const T c = T(1) / sqrt(t * t + T(1));
            s_c[k] = c;
            s_s[k] = t * c;
            s_t[k] = t;
            s_app[k] = app;
            s_aqq[k] = aqq;
            s_apq[k] = apq;
            rot_q = q;
            s_flag[0] = 1;
          }
        }
        s_p[k] = p;
        s_q[k] = rot_q;
      }
      __syncthreads();
      // rows p and q of A and of V^T
      for (int idx = tid; idx < half * n; idx += blockDim.x) {
        const int k = idx / n, j = idx - k * n;
        const int q = s_q[k];
        if (q < 0) continue;
        const int p = s_p[k];
        const T c = s_c[k], s = s_s[k];
        T x = A[p * ld + j], y = A[q * ld + j];
        A[p * ld + j] = c * x - s * y;
        A[q * ld + j] = s * x + c * y;
        x = Vt[p * ld + j];
        y = Vt[q * ld + j];
        Vt[p * ld + j] = c * x - s * y;
        Vt[q * ld + j] = s * x + c * y;
      }
      __syncthreads();
      // columns p and q of A
      for (int idx = tid; idx < n * half; idx += blockDim.x) {
        const int i = idx / half, k = idx - i * half;
        const int q = s_q[k];
        if (q < 0) continue;
        const int p = s_p[k];
        const T c = s_c[k], s = s_s[k];
        const T x = A[i * ld + p], y = A[i * ld + q];
        A[i * ld + p] = c * x - s * y;
        A[i * ld + q] = s * x + c * y;
      }
      __syncthreads();
      // the rotated pairs' 2 x 2 blocks: diagonal by the t-formula, zero off it
      for (int k = tid; k < half; k += blockDim.x) {
        const int q = s_q[k];
        if (q < 0) continue;
        const int p = s_p[k];
        const T t = s_t[k], apq = s_apq[k];
        A[p * ld + p] = s_app[k] - t * apq;
        A[q * ld + q] = s_aqq[k] + t * apq;
        A[p * ld + q] = T(0);
        A[q * ld + p] = T(0);
      }
      __syncthreads();
    }
    ++sweep;
    const bool rotated = s_flag[0] != 0;
    __syncthreads();             // every thread has read the flag before it is reset
    if (!rotated) break;
  }

  // ascending order by rank, ties by index; NaN outputs for a bad problem
  for (int i = tid; i < n; i += blockDim.x)
    if (isnan(A[i * ld + i])) s_flag[2] = 1;
  __syncthreads();
  const bool bad = bad_input || s_flag[2] != 0;
  for (int i = tid; i < n; i += blockDim.x) {
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
  for (int c = tid; c < n; c += blockDim.x) {
    const int i = s_inv[c];
    w[b * n + c] = bad ? nan : A[i * ld + i];
  }
  T* Vb = V + b * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int row = idx / n, c = idx - row * n;
    Vb[idx] = bad ? nan : Vt[s_inv[c] * ld + row];
  }
  if (tid == 0) sweeps[b] = bad_input ? 0 : sweep;
}

template <typename T>
int launch(const T* P, T* w, T* V, int* sweeps, T* work, int B, int n, int max_sweeps,
           void* stream) {
  const int item = sizeof(T);
  const long long smem = scratch_bytes(n, item) + (work == nullptr ? data_bytes(n, item) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jacobi_eigh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0)
    jacobi_eigh_kernel<T><<<B, threads_of(n), (size_t)smem, (cudaStream_t)stream>>>(
        P, w, V, sweeps, work, n, max_sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch at size n for items of `item` bytes (4 or 8): threads per
// block, dynamic shared memory per block (A and V^T included where they fit
// the opt-in), the kernel's __launch_bounds__.
void dq_jacobi_eigh_plan(int n, int item, int* threads, long long* smem, int* bound) {
  *threads = threads_of(n);
  *smem = scratch_bytes(n, item) + (in_shared(n, item) ? data_bytes(n, item) : 0);
  *bound = kBound;
}

// Launch E1 on `stream` for B problems of size n: P and V (B, n, n)
// row-major, w (B, n), sweeps (B,) int32; `work` is null where A and V^T fit
// shared memory (in_shared), else a (B, 2 n (n | 1)) workspace. All device
// pointers to contiguous memory allocated by the caller. Returns
// cudaGetLastError().
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

// Batched dense solve A x = b by unpivoted Householder QR, one launch for a
// whole batch (kernel K5).
//
// Replaces diffqcqp_tpu/kernels/qr_solve_pallas.py::_qr_solve_kernel
// (wrapper qr_solve_pallas). Its callers are the generic KKT adjoints of
// diff/kkt.py::_solve_direct: the assembled, transposed, masked systems of
// the four classes, whose inactive slots are unit rows and columns. Per
// problem, on [A | b]: for k = 0 .. m - 1, alpha = -sign(a_kk) ||A[k:, k]||
// with sign(0) = +1, v = A[k:, k] - alpha e_k, beta = 2 / ||v||^2 or 0 when
// ||v||^2 <= 1e-30 (a column already zero below the diagonal, as a unit
// inactive column is), column k becomes alpha e_k and every later column,
// b included, takes A_j -= beta (v^T A_j) v; then back substitution with the
// diagonal replaced by 1e-30 where |d| <= 1e-30. QR needs no pivoting for
// backward stability, so the schedule is fixed and the same for every
// problem. float32 throughout.
//
// Design: one thread block per problem. [A | b] sits in dynamic shared
// memory column-major with an odd stride ld = m | 1, so a column walk and a
// walk across threads' columns are both free of bank conflicts; A arrives
// row-major from global memory and is transposed as it is stored. Thread j
// owns column j (thread m owns b) and runs qr.cuh's qr_solve_cols, as K2's
// Schur system does: every thread computes each reflector from a broadcast
// of column k itself, in the same order, so there is no reduction and the
// control flow is uniform; one barrier per step. At m = 88, the largest
// system the route sends here, that is 89 threads (three warps) and ~32 KB
// of shared memory, so seven blocks share an SM.
//
// What differs from the TPU kernel and why it does not change the result:
// the TPU pads m to a multiple of 8 with unit rows and B to its lane tile,
// takes its column dot products over the rows of a (m, m, lanes) block,
// writes exact zeros below the diagonal of column k and back-substitutes row
// by row. Here nothing is padded (threads past m sit out), each thread sums
// its own column in order, the stale entries below column k's diagonal are
// never read again, and the back substitution goes column by column. These
// change the order of float32 operations only.
//
// What bounds it on this card: at B = 4096, m = 36 the bytes (A and b in, x
// out: ~22 MB, ~6.7 us at 3.35 TB/s) lead the operations (4/3 m^3 per
// problem, ~3.8 us at 67 TFLOP/s); at B = 2048, m = 72 the operations lead
// (~15 us against ~13 us). What bounds a simple kernel is the chain inside
// each problem: m dependent steps, each a pass over m - k rows of column k
// and of the thread's own column; the design answers with occupancy.
#include <cuda_runtime.h>
#include <stddef.h>

#include "ldl.cuh"
#include "qr.cuh"

namespace {

__global__ void __launch_bounds__(256)
qr_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                float* __restrict__ x, int m) {
  extern __shared__ float smem[];
  const int ld = m | 1;
  float* sA = smem;                       // m + 1 columns of ld: [A | b]
  float* s_x = sA + (m + 1) * ld;         // m: the solution

  const int r = threadIdx.x;
  const dq::Blk k{r, m, ld, blockDim.x == 32, r < m};
  const size_t p = blockIdx.x;

  const float* Ap = A + p * m * m;
  for (int idx = r; idx < m * m; idx += blockDim.x) {
    const int i = idx / m;
    sA[(idx - i * m) * ld + i] = Ap[idx];  // A[i][j] into column j
  }
  if (r < m) sA[m * ld + r] = b[p * m + r];
  __syncthreads();

  dq::qr_solve_cols(k, sA, m, ld, s_x);
  if (r < m) x[p * m + r] = s_x[r];
}

// Dynamic shared memory one block needs for an m x m system (the wrapper's
// smem_bytes in kernels/qr_solve_cuda.py computes the same).
size_t smem_bytes(int m) {
  const size_t ld = m | 1;
  return sizeof(float) * ((m + 1) * ld + m);
}

}  // namespace

extern "C" {

// Launch K5 on `stream` for B systems of size m: A (B, m, m) row-major,
// b and x (B, m). All pointers are device pointers to contiguous float32
// allocated by the caller. Returns cudaGetLastError().
int dq_qr_solve_f32(const float* A, const float* b, float* x, int B, int m, void* stream) {
  const int threads = 32 * ((m + 1 + 31) / 32);
  const size_t smem = smem_bytes(m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qr_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0) {
    qr_solve_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(A, b, x, m);
  }
  return (int)cudaGetLastError();
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

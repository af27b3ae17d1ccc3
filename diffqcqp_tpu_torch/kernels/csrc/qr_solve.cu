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
// What bounds it on this card: at B = 4096, m = 36 the bytes (A and b in, x
// out: ~22 MB, ~6.7 us at 3.35 TB/s) lead the operations (4/3 m^3 per
// problem, ~3.8 us at 67 TFLOP/s); at B = 2048, m = 72 the operations lead
// (~15 us against ~13 us). Neither is near: what bounds the kernel is the
// chain of m dependent steps inside each problem and the shared-memory
// passes of each step. The first form (one thread per column, every thread
// recomputing each reflector) ran each step as four passes of m - k
// dependent shared loads on every thread, two of them the same on all
// threads.
//
// Design: one thread block per problem, qr.cuh's qr_solve_lanes: G lanes
// per column of [A | b] (qr_group: 2 from m = 32 to 127, else 1), each
// reflector computed once by the owners of its column and passed in a slot,
// two passes per column and step, one __syncthreads per step, the back
// substitution on one warp without barriers. [A | b] sits in dynamic shared
// memory column-major with an odd stride ld = m | 1, so a column walk is
// free of bank conflicts; A arrives row-major from global memory and is
// transposed as it is stored. At m = 36: 96 threads and ~5.6 KB a problem;
// at m = 72: 160 threads and ~21 KB, ten blocks an SM. G was chosen by
// timing G = 1, 2 and 4 on an H100 at the phase-2d shapes: a longer chain
// per lane costs most at m = 36, more warps per problem cost most at m = 24,
// and at m = 72 and 87 the three tie, the SM's issue slots and not the chain
// setting the time there.
//
// What differs from the TPU kernel and why it does not change the result:
// the TPU pads m to a multiple of 8 with unit rows and B to its lane tile,
// takes its column dot products over the rows of a (m, m, lanes) block,
// writes exact zeros below the diagonal of column k and back-substitutes row
// by row. Here nothing is padded, the sums run in the lanes' order, the
// stale entries below column k's diagonal are never read again, and the back
// substitution goes column by column. These change the order of float32
// operations only; the plain version (kernels/qr_solve_cuda.py) adds in the
// kernel's order.
//
// ptxas (sm_90a): 30-40 registers an instance, no spill (chip_smoke.py
// phase 1 prints them from the build log).
#include <cuda_runtime.h>
#include <stddef.h>

#include "ldl.cuh"
#include "qr.cuh"

namespace {

constexpr int kBound = 256;   // qr_group(m) (m + 1) <= 256 threads

// [A | b] of problem blockIdx.x into shared memory, column-major (stride ld).
__device__ void load_system(float* sA, const float* __restrict__ A, const float* __restrict__ b,
                            int m, int ld) {
  const size_t p = blockIdx.x;
  const float* Ap = A + p * m * m;
  for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x) {
    const int i = idx / m;
    sA[(idx - i * m) * ld + i] = Ap[idx];  // A[i][j] into column j
  }
  for (int r = threadIdx.x; r < m; r += blockDim.x) sA[m * ld + r] = b[p * m + r];
  __syncthreads();
}

// qr.cuh's qr_solve_lanes with G lanes per column; kChunks = ceil(m / 32),
// the rows each lane of the back substitution holds.
template <int G, int kChunks>
__global__ void __launch_bounds__(kBound)
qr_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                float* __restrict__ x, int m) {
  extern __shared__ float smem[];
  const int ld = m | 1;
  float* sA = smem;                       // m + 1 columns of ld: [A | b]
  float* s_x = sA + (m + 1) * ld;         // m: the solution
  float* s_ref = s_x + m;                 // 4: two (beta, v_k) slots
  load_system(sA, A, b, m, ld);
  dq::qr_solve_lanes<G, kChunks>(sA, m, ld, s_x, s_ref);
  for (int r = threadIdx.x; r < m; r += blockDim.x) x[(size_t)blockIdx.x * m + r] = s_x[r];
}

// Lanes per column for an m x m system: 2 from m = 32 to 127, else 1
// (kernels/qr_solve_cuda.py's qr_group computes the same).
int qr_group(int m) { return (m < 32 || m >= 128) ? 1 : 2; }

// Dynamic shared memory one block needs for an m x m system.
size_t smem_bytes(int m) {
  const size_t ld = m | 1;
  return sizeof(float) * ((m + 1) * ld + m + 4);
}

template <typename Kernel>
int launch(Kernel kernel, int B, int threads, size_t smem, void* stream, const float* A,
           const float* b, float* x, int m) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0) kernel<<<B, threads, smem, (cudaStream_t)stream>>>(A, b, x, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch of an m x m system: threads per block (qr_group(m) lanes per
// column of [A | b], whole warps), dynamic shared memory per block, the
// kernel's __launch_bounds__ and the lanes per column.
void dq_qr_solve_plan(int m, int* threads, long long* smem, int* bound, int* group) {
  *group = qr_group(m);
  *threads = 32 * ((*group * (m + 1) + 31) / 32);
  *smem = (long long)smem_bytes(m);
  *bound = kBound;
}

// Launch K5 on `stream` for B systems of size m: A (B, m, m) row-major,
// b and x (B, m). All pointers are device pointers to contiguous float32
// allocated by the caller. Returns cudaGetLastError().
int dq_qr_solve_f32(const float* A, const float* b, float* x, int B, int m, void* stream) {
  const int g = qr_group(m);
  const int threads = 32 * ((g * (m + 1) + 31) / 32);
  const size_t smem = smem_bytes(m);
  if (g == 2) {
    if (m <= 64) return launch(qr_solve_kernel<2, 2>, B, threads, smem, stream, A, b, x, m);
    if (m <= 96) return launch(qr_solve_kernel<2, 3>, B, threads, smem, stream, A, b, x, m);
    return launch(qr_solve_kernel<2, 4>, B, threads, smem, stream, A, b, x, m);
  }
  if (m <= 32) return launch(qr_solve_kernel<1, 1>, B, threads, smem, stream, A, b, x, m);
  return launch(qr_solve_kernel<1, 8>, B, threads, smem, stream, A, b, x, m);
}

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

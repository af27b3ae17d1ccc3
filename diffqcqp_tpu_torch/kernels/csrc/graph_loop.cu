// Conditional nodes of a CUDA graph opened under stream capture: the device
// side of utils/control.py's while_loop and cond, the counterparts of the JAX
// package's lax.while_loop and lax.cond (diffqcqp_tpu/solvers/admm.py:248 and
// :391, diffqcqp_tpu/ops/linalg.py:234).
//
// This is control, not a port of a TPU kernel: under XLA a while loop stays
// on the device by construction; under PyTorch a loop is Python and reads
// its predicate on the host every iteration, which a CUDA graph capture
// forbids. A conditional node (CUDA 12.4+ runtime and driver) moves the
// decision onto the card: its body is a graph of its own, run while (WHILE)
// or once if (IF) a handle's value is nonzero, and a kernel sets that value
// from a predicate in device memory with cudaGraphSetConditional.
//
// dq_cond_begin, on a stream that is capturing (the outer graph or the body
// of an enclosing node):
//   1. cudaStreamGetCaptureInfo gives the graph being captured;
//   2. cudaGraphConditionalHandleCreate makes the node's handle on it;
//   3. a one-thread kernel, recorded on the stream, sets the handle from the
//      predicate (the first test of a WHILE, the test of an IF);
//   4. cudaGraphAddNode adds the conditional node after the stream's current
//      dependencies (the kernel of step 3 among them), and
//      cudaStreamUpdateCaptureDependencies makes the node the stream's only
//      dependency, so what the stream records next runs after the loop;
//   5. cudaStreamBeginCaptureToGraph starts capturing the body into the
//      node's graph on a second stream, which the caller makes current.
// dq_cond_end records, for a WHILE, the same kernel on the body stream (the
// test after each iteration) and ends the body's capture.
//
// What bounds it: nothing of the arithmetic. The kernel reads one byte; a
// node adds the launch of its body graph per iteration (a few microseconds
// on an H100), in place of a host round trip per iteration.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred,
                                       int negate) {
  cudaGraphSetConditional(handle, (*pred != negate) ? 1u : 0u);
}

}  // namespace

extern "C" {

const char* dq_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The CUDA runtime this library was built against and the driver's version
// (e.g. 12090 and 13000); conditional WHILE nodes need both >= 12040.
int dq_graph_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDriverGetVersion(driver);
}

// The id of the capture `stream` takes part in, or 0 where it captures
// nothing: the key that finds a capture's state from any thread (autograd
// runs a backward on a thread of its own, on the forward's stream).
int dq_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status;
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id, nullptr, nullptr,
                                           nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) *id = 0;
  return 0;
}

// How many nodes the graph that `stream` captures holds so far (0 where it
// captures nothing): the mark utils/tracing.py takes at each span boundary
// of a capture, which places the graph's nodes under the program's layers.
int dq_capture_nodes(void* stream, size_t* count) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  *count = 0;
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr, &graph, nullptr,
                                           nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return 0;
  return (int)cudaGraphGetNodes(graph, nullptr, count);
}

// A non-blocking stream of the library's own, never one of PyTorch's pool
// (whose streams are handed out round robin and could be the capture's).
int dq_stream_create(void** stream) {
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)stream, cudaStreamNonBlocking);
}

// kind: 0 IF, 1 WHILE. pred: a device bool; the node runs (again) while
// *pred != negate. Returns a CUDA error code; *handle the node's handle.
int dq_cond_begin(void* stream, int kind, const void* pred, int negate, void* body_stream,
                  unsigned long long* handle) {
  (void)cudaGetLastError();  // a failed call of this library's runtime before is reported already
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_conditional_kernel<<<1, 1, 0, s>>>(h, (const bool*)pred, negate != 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, params.conditional.phGraph_out[0],
                                    nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  *handle = (unsigned long long)h;
  return 0;
}

// Close the body opened by dq_cond_begin: for a WHILE (pred not null) the
// kernel that sets the handle from *pred again, then the end of the body's
// capture. The capture is ended whatever the first step returned.
int dq_cond_end(void* body_stream, unsigned long long handle, const void* pred) {
  cudaStream_t b = (cudaStream_t)body_stream;
  cudaError_t e = cudaSuccess;
  if (pred != nullptr) {
    set_conditional_kernel<<<1, 1, 0, b>>>((cudaGraphConditionalHandle)handle,
                                           (const bool*)pred, 0);
    e = cudaGetLastError();
  }
  cudaGraph_t body;
  cudaError_t e2 = cudaStreamEndCapture(b, &body);
  return (int)(e != cudaSuccess ? e : e2);
}

}  // extern "C"

// graph_while_cuda — a conditional WHILE node of the CUDA graph being
// captured: the port of the exit of the JAX tracker's per-level
// `lax.while_loop` (gps_slam_tpu/slam/tracker.py:225-233), whose test
// `(it < n_iters) & (step > CONVERGED_STEP**2)` stays on the device.
//
// Replaces no TPU kernel: the JAX package runs its loop inside one XLA
// program; a CUDA graph has no loop unless a conditional node holds one.
// PyTorch's own helper for conditional nodes (IF nodes only) is missing
// from the builds this port runs on, so the node is made here through the
// CUDA runtime (12.4 or later):
//
//   graph_while_begin  on the capturing stream: a handle of the graph
//                      being captured, one kernel that sets it from a
//                      0-d bool on the device, the WHILE node after that
//                      kernel (the stream's capture continues from the
//                      node), and the capture of `body_stream` into the
//                      node's body graph;
//   graph_while_end    at the end of the body: the same kernel, which sets
//                      the handle again from the flag the body rewrote
//                      (the node runs its body again while it is non-zero),
//                      then the end of the body's capture.
//
// The kernel reads one byte and writes the handle: its cost is a launch
// inside the graph, once before the loop and once per iteration.  The
// other entries make the bodies' stream (loading the kernel first, so
// that no capture loads it) and report the CUDA runtime's and CUDA
// driver's versions; each returns a cudaError_t.  `graph_while_error`
// and `graph_while_failed_call` name the last error and the runtime call
// that gave it.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// the runtime call that gave the last error, for the caller's message
const char* failed_call = "";

#define TRY(call)                          \
  do {                                     \
    cudaError_t e_ = (call);               \
    if (e_ != cudaSuccess) {               \
      failed_call = #call;                 \
      return (int)e_;                      \
    }                                      \
  } while (0)

}  // namespace

extern "C" int graph_while_begin(cudaStream_t stream, cudaStream_t body_stream,
                                 const bool* flag, unsigned long long* handle_out) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  TRY(cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps));
  if (status != cudaStreamCaptureStatusActive) {
    failed_call = "cudaStreamGetCaptureInfo: the stream is not capturing";
    return (int)cudaErrorStreamCaptureUnsupported;
  }
  cudaGraphConditionalHandle handle;
  TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault));
  set_condition<<<1, 1, 0, stream>>>(handle, flag);
  TRY(cudaGetLastError());
  // the node depends on what the stream's capture reached: the kernel
  TRY(cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  TRY(cudaGraphAddNode(&node, graph, deps, n_deps, &params));
  TRY(cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                          cudaStreamSetCaptureDependencies));
  TRY(cudaStreamBeginCaptureToGraph(body_stream, params.conditional.phGraph_out[0],
                                    nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal));
  *handle_out = handle;
  return 0;
}

extern "C" int graph_while_end(cudaStream_t body_stream, unsigned long long handle,
                               const bool* flag, size_t* body_nodes) {
  set_condition<<<1, 1, 0, body_stream>>>(handle, flag);
  cudaError_t launch = cudaGetLastError();
  cudaGraph_t body;
  // ends the capture whatever the launch gave, so the stream is free again
  TRY(cudaStreamEndCapture(body_stream, &body));
  TRY(launch);
  *body_nodes = 0;
  TRY(cudaGraphGetNodes(body, nullptr, body_nodes));
  return 0;
}

extern "C" int graph_while_stream(cudaStream_t* stream_out) {
  // load the kernel now: a first launch inside a capture would load it there
  cudaFuncAttributes attr;
  TRY(cudaFuncGetAttributes(&attr, set_condition));
  TRY(cudaStreamCreateWithFlags(stream_out, cudaStreamNonBlocking));
  return 0;
}

extern "C" int graph_while_versions(int* runtime, int* cuda_driver) {
  TRY(cudaRuntimeGetVersion(runtime));
  TRY(cudaDriverGetVersion(cuda_driver));
  return 0;
}

extern "C" const char* graph_while_error(int err) {
  return cudaGetErrorName((cudaError_t)err);
}

extern "C" const char* graph_while_failed_call() { return failed_call; }

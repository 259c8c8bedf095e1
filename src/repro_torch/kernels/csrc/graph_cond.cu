// Conditional nodes for the stream server's captured round.
//
// The reference gates two rare, costly steps of a serving round with
// lax.cond: the window mode's refactorization of the slots whose downdate
// tripped the guard, and the adaptive mode's anneal of the slots whose
// drift detector fired.  A CUDA graph has the same construct, a conditional
// node (CUDA 12.4 and later): its body graph runs at a replay only when a
// device flag is set, so the flag never travels to the host.  PyTorch does
// not expose it in every release, so runtime/graphs.py builds one here:
//
//   dfr_graph_if_begin: on a stream that is capturing, a one-thread kernel
//     copies the flag into a new conditional handle, an IF node joins the
//     captured graph after it (the stream's later work depends on the
//     node), and `body_stream` starts capturing into the node's body graph;
//   dfr_graph_if_end: ends the body's capture.
//
// Between the two, the caller issues the body's work on `body_stream`.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" int dfr_graph_if_begin(void* capture_stream, const bool* flag,
                                  void* body_stream, int mode) {
  cudaStream_t cs = static_cast<cudaStream_t>(capture_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err =
      cudaStreamGetCaptureInfo(cs, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition<<<1, 1, 0, cs>>>(handle, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamGetCaptureInfo(cs, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(cs, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode)));
}

extern "C" int dfr_graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}

extern "C" const char* dfr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Conditional execution inside a captured CUDA graph: the port's
// counterpart of the lax.cond with which gs2d_tpu's scanned fit keeps the
// lazy-rebinning choice on the device (gs2d_tpu/train/loop.py,
// _fused_step_body's one_step_cached), used by train/graphs.py.
//
// gs2d_graph_if, called while a stream is being captured, appends to the
// graph under capture a one-thread kernel that reads a device int and an
// "if" conditional node (CUDA 12.4 or later) whose body is a copy of an
// already captured graph, and makes that node the stream's only capture
// dependency: what the stream captures next runs after the body has run,
// or after it was skipped. On a replay the body runs only when the int is
// not 0, so a step whose cached binning holds launches none of the binning's
// kernels. No kernel here computes anything of the fit.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const int* __restrict__ flag) {
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  nullptr, n_deps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  n_deps);
#endif
}

}  // namespace

extern "C" {

// flag: a device int (the rebin predicate, written earlier in the same
// capture); body: the cudaGraph_t to run when it is not 0 (copied into the
// conditional node as a child graph); stream: the capturing stream.
// Returns cudaErrorStreamCaptureImplicit when the stream is not capturing,
// else the first CUDA error met.
int gs2d_graph_if(const int* flag, void* body, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(stream, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, stream>>>(handle, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The dependencies now end at the kernel just captured.
  err = capture_info(stream, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0, static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      stream, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                             cudaStreamSetCaptureDependencies);
#endif
}

// The CUDA runtime version the library was built against (CUDART_VERSION)
// and the one it runs on.
int gs2d_cudart_build_version() { return CUDART_VERSION; }

int gs2d_cudart_version() {
  int v = 0;
  return cudaRuntimeGetVersion(&v) == cudaSuccess ? v : -1;
}

}  // extern "C"

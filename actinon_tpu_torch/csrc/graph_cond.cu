// Conditional nodes of CUDA graphs (CUDA 12.4 or later): the device-side
// `lax.cond` and `lax.while_loop` of the port's captured paths
// (render/cond.py).
//
// During a stream capture, actinon_cond_begin appends to the capturing
// graph a kernel that copies a device boolean into a new conditional
// handle, then an IF or WHILE conditional node on that handle, and starts
// capturing a second stream into the node's body graph; actinon_cond_end
// ends that capture.  The work after the node waits on the node as a
// whole.  An IF body runs once at a replay when the boolean held; a WHILE
// body runs while the handle is nonzero, tested before each pass, so the
// body ends with actinon_cond_set, which sets the handle from the
// boolean that the body computed last.
//
// Plain C interface (ctypes); every function returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void cond_set_kernel(cudaGraphConditionalHandle handle,
                                const bool* value) {
  cudaGraphSetConditional(handle, *value ? 1u : 0u);
}

}  // namespace

extern "C" {

// The driver's and the runtime's CUDA versions (1000 * major + 10 * minor).
int actinon_cond_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err != cudaSuccess) return err;
  return cudaRuntimeGetVersion(runtime);
}

// On `stream`, a kernel that sets `handle` from *value.
int actinon_cond_set(void* stream, unsigned long long handle,
                     const bool* value) {
  cond_set_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), value);
  return cudaGetLastError();
}

// `stream` is capturing: append the handle's set kernel (from *value) and
// a conditional node (kind 0: IF, 1: WHILE) to its graph, make the node the
// stream's only dependency, and start capturing `body_stream` into the
// node's body.  *handle_out receives the handle (for actinon_cond_set).
int actinon_cond_begin(int kind, void* stream, void* body_stream,
                       const bool* value, unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  cond_set_kernel<<<1, 1, 0, s>>>(handle, value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *handle_out = static_cast<unsigned long long>(handle);
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

// End the capture of a body begun by actinon_cond_begin.
int actinon_cond_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

}  // extern "C"

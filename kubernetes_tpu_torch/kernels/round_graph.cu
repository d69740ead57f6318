// The CUDA graph a plain speculative batch runs in: the counterpart of the
// JAX package's models/speculative.py `_impl` (:614), its lax.while_loop
// over the rounds (:625) and its lax.cond around the exact redo (:681).
//
//   [init]  the WHILE node's condition := any pod active
//   WHILE   body: K11, K12, K15, K1, [K3], K14 (K14's last block sets the
//           condition to "any pod still active")
//   [flag]  redo := inv | any(valid & hosts < 0); the IF node's condition
//   IF      body: the static pass (K11, K12) and K13, writing the engine's
//           outputs over the rounds' carry
//
// The host builds it by stream capture (CUDA 12.4+ conditional nodes): it
// captures the init kernel on the engine's stream, adds a conditional node
// to the capturing graph (graph_cond_begin), captures the body on a second
// stream into the node's body graph, and so on; graph_end instantiates.
// Every kernel of the bodies is queued by its Python wrapper with buffers
// allocated before the capture began.  Nothing here replaces a TPU kernel
// by itself: the two small kernels set the conditions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// any(flag[0:b]) as 0/1 over one block
__device__ int block_any(const uint8_t* flag, const int* hosts, int b) {
  int any = 0;
  for (int i = threadIdx.x; i < b; i += kThreads)
    any |= hosts ? (flag[i] && hosts[i] < 0) : flag[i] != 0;
  return __syncthreads_or(any);
}

__global__ void graph_init_kernel(uint64_t handle, const uint8_t* active,
                                  int b) {
  const int any = block_any(active, nullptr, b);
#if CUDART_VERSION >= 12040
  if (threadIdx.x == 0)
    cudaGraphSetConditional((cudaGraphConditionalHandle)handle, any ? 1u : 0u);
#endif
}

__global__ void graph_flag_kernel(uint64_t handle, const uint8_t* inv,
                                  const uint8_t* valid, const int* hosts,
                                  int b, int* redo) {
  const int lost = block_any(valid, hosts, b);
  if (threadIdx.x == 0) {
    const bool r = lost || *inv;
    *redo = r;
#if CUDART_VERSION >= 12040
    cudaGraphSetConditional((cudaGraphConditionalHandle)handle, r ? 1u : 0u);
#endif
  }
}

// The probe's kernels: the WHILE condition := *counter > 0, then a body
// that counts down and keeps the condition while the counter is above 0.
__global__ void graph_probe_init(uint64_t handle, const int* counter) {
#if CUDART_VERSION >= 12040
  cudaGraphSetConditional((cudaGraphConditionalHandle)handle,
                          *counter > 0 ? 1u : 0u);
#endif
}

__global__ void graph_probe_step(uint64_t handle, int* counter, int* steps) {
  const int left = --*counter;
  ++*steps;
#if CUDART_VERSION >= 12040
  cudaGraphSetConditional((cudaGraphConditionalHandle)handle,
                          left > 0 ? 1u : 0u);
#endif
}

}  // namespace

#if CUDART_VERSION >= 12040

// The capturing graph of `stream`, or null.
static cudaGraph_t capturing_graph(cudaStream_t stream,
                                   const cudaGraphNode_t** deps,
                                   size_t* ndeps) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  if (cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, deps,
                               ndeps) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return nullptr;
  return graph;
}

#endif

extern "C" {

// The driver's and the runtime's CUDA versions (e.g. 12040 for 12.4).
int graph_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err == cudaSuccess) err = cudaRuntimeGetVersion(runtime);
  return (int)err;
}

// Begin capturing the engine's graph on `stream` (relaxed mode: the
// wrappers' host calls in between are no stream work).
int graph_begin(cudaStream_t stream) {
  return (int)cudaStreamBeginCapture(stream, cudaStreamCaptureModeRelaxed);
}

// A conditional handle of the graph capturing on `stream`; *handle = 0
// when conditional nodes are not built by this runtime.
int graph_handle(cudaStream_t stream, uint64_t* handle) {
  *handle = 0;
#if CUDART_VERSION >= 12040
  cudaGraph_t graph = capturing_graph(stream, nullptr, nullptr);
  if (!graph) return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle h;
  // reset to 0 at each launch; a kernel sets it before its node runs
  const cudaError_t err = cudaGraphConditionalHandleCreate(
      &h, graph, 0, cudaGraphCondAssignDefault);
  if (err == cudaSuccess) *handle = (uint64_t)h;
  return (int)err;
#else
  return (int)cudaErrorNotSupported;
#endif
}

// Queue the kernel that sets a WHILE handle to any(active[0:b]).
int graph_init_launch(uint64_t handle, const uint8_t* active, int b,
                      cudaStream_t stream) {
  graph_init_kernel<<<1, kThreads, 0, stream>>>(handle, active, b);
  return (int)cudaGetLastError();
}

// Queue the kernel that sets redo := inv | any(valid & hosts < 0) and an
// IF handle to it.
int graph_flag_launch(uint64_t handle, const uint8_t* inv,
                      const uint8_t* valid, const int* hosts, int b,
                      int* redo, cudaStream_t stream) {
  graph_flag_kernel<<<1, kThreads, 0, stream>>>(handle, inv, valid, hosts, b,
                                                redo);
  return (int)cudaGetLastError();
}

// Add a conditional node (is_while: WHILE, else IF) on `handle` after
// what `stream` captured so far, and begin capturing its body on
// `body_stream`.
int graph_cond_begin(cudaStream_t stream, cudaStream_t body_stream,
                     uint64_t handle, int is_while) {
#if CUDART_VERSION >= 12040
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaGraph_t graph = capturing_graph(stream, &deps, &ndeps);
  if (!graph) return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      body_stream, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed);
#else
  return (int)cudaErrorNotSupported;
#endif
}

// End the capture of a conditional node's body.
int graph_cond_end(cudaStream_t body_stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture(body_stream, &body);
}

// End the capture on `stream` and instantiate the graph into *exec (the
// graph itself is destroyed; the instance keeps what it needs).
int graph_end(cudaStream_t stream, void** exec) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture(stream, &graph);
  if (err != cudaSuccess) return (int)err;
  cudaGraphExec_t ge = nullptr;
  err = cudaGraphInstantiate(&ge, graph, 0ULL);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) return (int)err;
  *exec = (void*)ge;
  return 0;
}

int graph_launch(void* exec, cudaStream_t stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, stream);
}

int graph_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

// Abandon the captures on `stream` and `body_stream` after an error, so
// neither stays in capture mode.
int graph_abort(cudaStream_t stream, cudaStream_t body_stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t g = nullptr;
  if (cudaStreamIsCapturing(body_stream, &status) == cudaSuccess &&
      status != cudaStreamCaptureStatusNone &&
      cudaStreamEndCapture(body_stream, &g) == cudaSuccess && g)
    cudaGraphDestroy(g);
  g = nullptr;
  if (cudaStreamIsCapturing(stream, &status) == cudaSuccess &&
      status != cudaStreamCaptureStatusNone &&
      cudaStreamEndCapture(stream, &g) == cudaSuccess && g)
    cudaGraphDestroy(g);
  cudaGetLastError();
  return 0;
}

// Build a toy graph by capture on `stream` (not the legacy default
// stream, which cannot capture) and run it there: a WHILE node whose body
// counts *counter (device int) down to 0, one step a pass.  *steps
// (device int, zeroed by the caller) gets the passes.  Synchronizes the
// stream.
int graph_probe(int* counter, int* steps, cudaStream_t stream,
                cudaStream_t body_stream) {
  int err = graph_begin(stream);
  if (err) return err;
  uint64_t handle = 0;
  err = graph_handle(stream, &handle);
  if (!err) {
    graph_probe_init<<<1, 1, 0, stream>>>(handle, counter);
    err = (int)cudaGetLastError();
  }
  if (!err) err = graph_cond_begin(stream, body_stream, handle, 1);
  if (!err) {
    graph_probe_step<<<1, 1, 0, body_stream>>>(handle, counter, steps);
    err = (int)cudaGetLastError();
  }
  if (!err) err = graph_cond_end(body_stream);
  void* exec = nullptr;
  if (!err) err = graph_end(stream, &exec);
  if (err) {
    graph_abort(stream, body_stream);
    return err;
  }
  err = graph_launch(exec, stream);
  if (!err) err = (int)cudaStreamSynchronize(stream);
  graph_destroy(exec);
  return err;
}

}  // extern "C"

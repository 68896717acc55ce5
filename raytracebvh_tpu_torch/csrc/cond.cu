// Conditional CUDA-graph nodes: the device side of graphs.while_loop, the
// port's counterpart of the while loop that XLA compiles lax.map into,
// inside a compiled program.
//
// The JAX package's chunk loop is a lax.map over ray chunks, culled ones
// under lax.cond(any hit, shade, background) (raytracebvh_tpu/pipeline.py,
// shade_rays); under jit it is one while loop on the device with one body.
// The port's culled loop runs over the hit chunks alone (chunk_order).
// CUDA 12.4 added the counterpart to CUDA graphs: a WHILE node, a
// conditional node whose body graph runs again and again while the node's
// handle is non-zero, checked before each trip (a kernel in the body sets
// it for the next).
//
// rtbvh_while_begin adds one WHILE node to the graph that `stream` is
// capturing: a one-thread kernel sets the trip counter (an int in device
// memory) to 0 and a new conditional handle to count > 0 (count an int in
// device memory, read at each launch of the graph), the WHILE node follows
// it, and the node becomes the stream's only capture dependency, so the
// rest of the capture runs after the node.  Then `body` (a stream no one
// else uses) starts capturing into the node's body graph.  The caller
// launches the body's work on `body`, then rtbvh_while_end ends the body
// with a one-thread kernel that adds one to the counter and sets the
// handle to counter < count, and ends the body's capture.  The counter
// outlives the launch: after it, it holds the trips run.

#include <cuda_runtime.h>

namespace {

// before a WHILE node: the first trip runs where count > 0
__global__ void while_start_kernel(cudaGraphConditionalHandle handle,
                                   const int* count, int* trip) {
  *trip = 0;
  cudaGraphSetConditional(handle, *count > 0 ? 1u : 0u);
}

// the last kernel of a WHILE node's body: another trip while trip < count
__global__ void while_next_kernel(cudaGraphConditionalHandle handle,
                                  const int* count, int* trip) {
  int j = *trip + 1;
  *trip = j;
  cudaGraphSetConditional(handle, j < *count ? 1u : 0u);
}

// the capture's graph and its current dependencies (their edge data,
// which CUDA 12.3 added, is left out: the node takes default edges)
cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, ndeps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    err = cudaErrorStreamCaptureUnmatched;
  return err;
}

// a new conditional handle of the graph that `s` is capturing
cudaError_t new_handle(cudaStream_t s, cudaGraphConditionalHandle* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  return cudaGraphConditionalHandleCreate(handle, graph, 0, 0);
}

// after the kernel that sets `handle` (launched on `s`): a WHILE node on
// it, made `s`'s only capture dependency, and `body` capturing into the
// node's body graph
cudaError_t add_node(cudaStream_t s, cudaGraphConditionalHandle handle,
                     cudaStream_t body) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  if ((err = capture_info(s, &graph, &deps, &ndeps)) != cudaSuccess)
    return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(
        s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(
        s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal);
}

}  // namespace

extern "C" int rtbvh_while_begin(const void* count, void* trip, void* stream,
                                 void* body, unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraphConditionalHandle handle;
  cudaError_t err = new_handle(s, &handle);
  if (err != cudaSuccess) return err;
  while_start_kernel<<<1, 1, 0, s>>>(handle, static_cast<const int*>(count),
                                     static_cast<int*>(trip));
  *handle_out = handle;
  return add_node(s, handle, static_cast<cudaStream_t>(body));
}

extern "C" int rtbvh_while_end(unsigned long long handle, const void* count,
                               void* trip, void* body) {
  cudaStream_t b = static_cast<cudaStream_t>(body);
  while_next_kernel<<<1, 1, 0, b>>>(handle, static_cast<const int*>(count),
                                    static_cast<int*>(trip));
  cudaError_t err = cudaGetLastError();
  cudaGraph_t graph;
  cudaError_t end = cudaStreamEndCapture(b, &graph);
  return err != cudaSuccess ? err : end;
}

// A stream of its own for the conditional nodes' bodies (torch's streams
// come from a shared pool, where a body could meet the stream that
// captures it).
extern "C" int rtbvh_stream_create(void** stream) {
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(stream),
                                   cudaStreamNonBlocking);
}

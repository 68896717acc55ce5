// Conditional CUDA-graph nodes: the device side of graphs.cond, the
// port's counterpart of jax.lax.cond inside a compiled program.
//
// The JAX package's culled chunk loop is a lax.map of lax.cond(any hit,
// shade, background) (raytracebvh_tpu/pipeline.py, shade_rays); under jit
// it is a branch on the device.  CUDA 12.4 added its counterpart to CUDA
// graphs: an IF node, whose body graph runs at a launch only where a
// kernel earlier in the graph set the node's handle to a non-zero value.
//
// rtbvh_if_begin adds one IF node to the graph that `stream` is capturing:
// a one-thread kernel copies the predicate (a bool in device memory, read
// at each launch of the graph) into a new conditional handle, the IF node
// follows it, and the node becomes the stream's only capture dependency,
// so the rest of the capture runs after the node.  Then `body` (a stream
// no one else uses) starts capturing into the node's body graph, until
// rtbvh_if_end.  The caller launches the body's work on `body` in
// between.  This is what torch's CUDAGraph.begin_capture_to_if_node does
// in the torch releases that have it.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
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

}  // namespace

extern "C" int rtbvh_if_begin(const void* pred, void* stream, void* body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, s>>>(handle,
                                       static_cast<const bool*>(pred));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = capture_info(s, &graph, &deps, &ndeps)) != cudaSuccess)
    return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
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
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int rtbvh_if_end(void* body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

// A stream of its own for the IF nodes' bodies (torch's streams come from
// a shared pool, where a body could meet the stream that captures it).
extern "C" int rtbvh_stream_create(void** stream) {
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(stream),
                                   cudaStreamNonBlocking);
}

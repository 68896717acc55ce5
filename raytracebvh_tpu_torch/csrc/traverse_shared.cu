// K5: nearest-hit BVH traversal, and K6: any-hit (occlusion) traversal,
// with the tree's internal nodes in shared memory.  One thread per ray;
// both are one kernel, a template on AnyHit, as K1/K4 are.
//
// K5 replaces the JAX package's whole-tree-in-VMEM traversal
// (raytracebvh_tpu/ops/traverse_pallas.py, _traverse_kernel, launched by
// traverse_pallas); K6 its any-hit twin (_traverse_any_kernel, through
// traverse_any_pallas).  Contracts: K1's and K4's -- equal to the plain
// raytracebvh_tpu_torch/ops/traverse.py traverse and traverse_any on every
// ray.  The walk is walk.cuh's, the same code as K1/K4, so the kernels
// agree with K1/K4 and with the plain version bit for bit.
//
// What bounds them on an H100: latency, as for K1/K4.  A step of a walk
// is a dependent chain: load the node, test its box, take the next node
// from the links just loaded.  K1 waits on the L2 for each node; here the
// internal nodes (ids n .. 2n-2, 32 bytes each, K1's node record) sit in
// shared memory, whose latency is a fraction of L2's, so a walk's inner
// steps are short.  Leaf boxes and triangles are read from global memory
// through L2, as K1 reads them: a leaf step pays the L2 round trip once.
// The tables are K1's (ops/traverse_cuda.pack_tables), packed once per
// build for either kernel.
//
// Capacity: (n - 1) * 32 bytes must fit the block's opt-in shared memory
// (232 448 bytes on an H100: up to 7 265 leaves).  The wrapper checks it
// (ops/traverse_shared_cuda.fits), and the pipeline's 'auto' takes K1/K4
// above it, as the JAX 'auto' takes the HBM kernel above its VMEM cap.
//
// The grid is persistent: at most as many blocks as the SMs hold at once,
// each striding over the rays, so each block stages the table once per
// launch.  No thread leaves before the staging barrier.  The TPU kernel's
// mechanics (tile-predicated column gathers, lane representatives, u16
// link packing, 1 024-ray tiles with a per-tile step cap) answered the
// TPU's lack of a per-lane gather; a GPU thread loads its own node, so
// none of it is carried over.  The step cap is per ray, as K1's: the JAX
// kernel's per-tile cap is the same for every live ray.

#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

constexpr int kBlock = 512;

// Internal nodes from shared memory (staged[2 * (node - n)]), leaves'
// boxes from global memory.
struct StagedNodes {
  const float4* staged;
  const float4* __restrict__ nodes;
  int n_leaves;
  __device__ __forceinline__ void load(int node, float4& a, float4& b) const {
    if (node >= n_leaves) {
      a = staged[2 * (node - n_leaves)];
      b = staged[2 * (node - n_leaves) + 1];
    } else {
      a = __ldg(&nodes[2 * node]);
      b = __ldg(&nodes[2 * node + 1]);
    }
  }
};

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock, 2)
traverse_shared_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ max_t,
                       const float4* __restrict__ nodes,
                       const float4* __restrict__ leaves, int nrays,
                       int n_leaves, float eps, int max_steps,
                       unsigned char* __restrict__ hit_out,
                       float* __restrict__ dist_out, int* __restrict__ leaf_out,
                       int* __restrict__ steps_out, int* __restrict__ truncated) {
  extern __shared__ float4 staged[];
  const float4* internal = nodes + 2 * n_leaves;
  for (int i = threadIdx.x; i < 2 * (n_leaves - 1); i += blockDim.x) {
    staged[i] = __ldg(&internal[i]);
  }
  __syncthreads();
  const StagedNodes src{staged, nodes, n_leaves};
  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < nrays; r += stride) {
    rtbvh::walk_ray<AnyHit>(src, leaves, r, origin, direction, max_t,
                            n_leaves, eps, max_steps, hit_out, dist_out,
                            leaf_out, steps_out, truncated);
  }
}

template <bool AnyHit>
int launch(const float* origin, const float* direction, const float* max_t,
           const void* nodes, const void* leaves, int nrays, int n_leaves,
           float eps, int max_steps, unsigned char* hit, float* dist, int* leaf,
           int* steps, int* truncated, void* stream) {
  if (nrays <= 0) return static_cast<int>(cudaGetLastError());
  if (n_leaves < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_leaves - 1) * 2 * sizeof(float4);
  auto kernel = traverse_shared_kernel<AnyHit>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kBlock, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int want = (nrays + kBlock - 1) / kBlock;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, max_t, static_cast<const float4*>(nodes),
      static_cast<const float4*>(leaves), nrays, n_leaves, eps, max_steps, hit,
      dist, leaf, steps, truncated);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtbvh_traverse_shared(const float* origin, const float* direction,
                                     const void* nodes, const void* leaves,
                                     int nrays, int n_leaves, float eps,
                                     int max_steps, unsigned char* hit,
                                     float* dist, int* leaf, int* steps,
                                     int* truncated, void* stream) {
  return launch<false>(origin, direction, nullptr, nodes, leaves, nrays,
                       n_leaves, eps, max_steps, hit, dist, leaf, steps,
                       truncated, stream);
}

extern "C" int rtbvh_traverse_any_shared(const float* origin,
                                         const float* direction,
                                         const float* max_t, const void* nodes,
                                         const void* leaves, int nrays,
                                         int n_leaves, float eps, int max_steps,
                                         unsigned char* occluded, int* steps,
                                         int* truncated, void* stream) {
  return launch<true>(origin, direction, max_t, nodes, leaves, nrays, n_leaves,
                      eps, max_steps, occluded, nullptr, nullptr, steps,
                      truncated, stream);
}

// The opt-in shared memory a block of `device` may use, in bytes.
extern "C" int rtbvh_shared_mem_per_block(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// K5: nearest-hit BVH traversal, and K6: any-hit (occlusion) traversal,
// with the tree's node records in shared memory.  One thread per ray;
// both are one kernel, a template on AnyHit, as K1/K4 are.
//
// K5 replaces the JAX package's whole-tree-in-VMEM traversal
// (raytracebvh_tpu/ops/traverse_pallas.py, _traverse_kernel, launched by
// traverse_pallas); K6 its any-hit twin (_traverse_any_kernel, through
// traverse_any_pallas).  Contracts: K1's and K4's -- equal to the plain
// raytracebvh_tpu_torch/ops/traverse.py traverse and traverse_any on every
// ray.  The walk is walk.cuh's, the same code as K1/K4, so the kernels
// agree with K1/K4 and with the plain version bit for bit; only where a
// node record is read from, and the launch, differ.
//
// What bounds them on an H100: the walk's issue slots (traverse.cu counts
// them for K1/K4) and, with fewer warps, latency.  A step of a walk is a
// dependent chain: load the node, test its box, take the next node
// from the links just loaded.  Here the node records (K1's 32-byte record,
// ops/traverse_cuda.pack_tables) of nodes `first` .. 2n-2 sit in shared
// memory, whose latency is below an L1 hit's and far below L2's; the rest
// (leaf boxes when only the internal nodes are staged, and every leaf's
// triangle) come from global memory through L1/L2:
//  * every node record (first = 0) where all 2n - 1 fit a block (up to
//    3 632 leaves on an H100; the dense scene's 3 072 take 196 576 bytes);
//  * else the internal nodes only (first = n).
// One block of 1 024 threads an SM stages one copy.  What hides the
// latency is warps, and K1 keeps 48 an SM to these 32; two blocks of 768
// an SM (48 warps, the internal nodes twice) measured no faster.
// The carveout asks the SM for no more shared memory than the block
// stages, so L1 keeps the rest for the leaf records.  Staging is cp.async
// (16 bytes a copy, all in flight at once, no registers), paid once per
// block per launch.  The grid is as many blocks as the SMs hold (fewer for
// < 32 rays a block).  The rays go out in batches of 32 through a work
// queue: a first round dealt warp by warp across the blocks, so that a
// launch this round covers (a sparse frame's 25 600-ray chunk: 800
// batches, about 6 warps on each of 132 SMs) runs on every SM with no
// atomic; after it each warp takes the next batch by an atomic on a
// counter zeroed before the launch, so a large launch ends with every SM
// busy, as K1's many small blocks do, where rays dealt out round by round
// (2 073 600 rays make 15.3 rounds of 132 x 1 024) leave the last round's
// blocks alone on the card.
//
// Capacity: the internal nodes, (n - 1) * 32 bytes, must fit the block's
// opt-in shared memory (232 448 bytes on an H100: up to 7 265 leaves);
// the wrapper checks it (ops/traverse_shared_cuda.fits), and the
// pipeline's 'auto' takes K1/K4 above it, as the JAX 'auto' takes the HBM
// kernel above its VMEM cap.  The TPU kernel's mechanics (tile-predicated
// column gathers, lane representatives, u16 link packing, 1 024-ray tiles
// with a per-tile step cap) answered the TPU's lack of a per-lane gather;
// a GPU thread loads its own node, so none of it is carried over.  The
// step cap is per ray, as K1's: the JAX kernel's per-tile cap is the same
// for every live ray.

#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kRecordBytes = 32;

// Nodes first .. 2n-2 from shared memory (staged[2 * (node - first)]), the
// nodes below `first` (leaves, when only the internal nodes are staged)
// from global memory.
struct StagedNodes {
  const float4* staged;
  const float4* __restrict__ nodes;
  int first;
  __device__ __forceinline__ void load(int node, float4& a, float4& b) const {
    if (node >= first) {
      a = staged[2 * (node - first)];
      b = staged[2 * (node - first) + 1];
    } else {
      a = __ldg(&nodes[2 * node]);
      b = __ldg(&nodes[2 * node + 1]);
    }
  }
};

// count float4s from global src to shared dst by cp.async, then a barrier.
__device__ __forceinline__ void stage(float4* dst, const float4* src,
                                      int count) {
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16u * static_cast<unsigned>(i)),
                 "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

template <bool AnyHit>
__global__ void __launch_bounds__(kBlock, 1)
traverse_shared_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ max_t,
                       const float4* __restrict__ nodes,
                       const float4* __restrict__ leaves, int nrays,
                       int n_leaves, int first, int* __restrict__ work,
                       float eps, int max_steps,
                       unsigned char* __restrict__ hit_out,
                       float* __restrict__ dist_out, int* __restrict__ leaf_out,
                       int* __restrict__ steps_out, int* __restrict__ truncated) {
  extern __shared__ __align__(16) float4 staged[];
  stage(staged, nodes + 2 * first, 2 * (2 * n_leaves - 1 - first));
  const StagedNodes src{staged, nodes, first};
  // Warp w of block b walks batch w * gridDim.x + b first (spread over the
  // blocks); where batches are left after that round, each warp then
  // takes the next from *work (zero at the launch) until none are left,
  // asking for it before it walks the current one, so that the atomic's
  // latency hides behind the walk.
  const int lane = threadIdx.x & 31;
  const int batches = (nrays + 31) / 32;
  const int warps = gridDim.x * (kBlock / 32);
  int next = (threadIdx.x / 32) * gridDim.x + blockIdx.x;
  while (next < batches) {
    const int r = next * 32 + lane;
    if (lane == 0) {
      next = batches > warps ? warps + atomicAdd(work, 1) : batches;
    }
    if (r < nrays) {
      rtbvh::walk_ray<AnyHit>(src, leaves, r, origin, direction, max_t,
                              n_leaves, eps, max_steps, hit_out, dist_out,
                              leaf_out, steps_out, truncated);
    }
    next = __shfl_sync(0xffffffffu, next, 0);
  }
}

template <bool AnyHit>
int launch(const float* origin, const float* direction, const float* max_t,
           const void* nodes, const void* leaves, int nrays, int n_leaves,
           float eps, int max_steps, unsigned char* hit, float* dist, int* leaf,
           int* steps, int* truncated, int first, int grid, int* work,
           void* stream) {
  if (nrays <= 0) return static_cast<int>(cudaGetLastError());
  const bool queue = (nrays + 31) / 32 > grid * (kBlock / 32);
  if (n_leaves < 2 || first < 0 || first > 2 * n_leaves - 1 || grid < 1 ||
      (queue && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = (2 * n_leaves - 1 - first) * kRecordBytes;
  auto kernel = traverse_shared_kernel<AnyHit>;
  int device = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  // the share of the SM's shared memory to carve out of L1: what the
  // block stages, with the 1 KB the system reserves a block
  int carveout = static_cast<int>(
      (100LL * (smem + 1024) + per_sm - 1) / per_sm);
  if (carveout > 100) carveout = 100;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
           carveout)) != cudaSuccess ||
      (queue &&
       (err = cudaMemsetAsync(work, 0, sizeof(int), s)) != cudaSuccess)) {
    return static_cast<int>(err);
  }
  kernel<<<grid, kBlock, smem, s>>>(
      origin, direction, max_t, static_cast<const float4*>(nodes),
      static_cast<const float4*>(leaves), nrays, n_leaves, first, work, eps,
      max_steps, hit, dist, leaf, steps, truncated);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtbvh_traverse_shared(const float* origin, const float* direction,
                                     const void* nodes, const void* leaves,
                                     int nrays, int n_leaves, float eps,
                                     int max_steps, unsigned char* hit,
                                     float* dist, int* leaf, int* steps,
                                     int* truncated, int first, int grid,
                                     int* work, void* stream) {
  return launch<false>(origin, direction, nullptr, nodes, leaves, nrays,
                       n_leaves, eps, max_steps, hit, dist, leaf, steps,
                       truncated, first, grid, work, stream);
}

extern "C" int rtbvh_traverse_any_shared(
    const float* origin, const float* direction, const float* max_t,
    const void* nodes, const void* leaves, int nrays, int n_leaves, float eps,
    int max_steps, unsigned char* occluded, int* steps, int* truncated,
    int first, int grid, int* work, void* stream) {
  return launch<true>(origin, direction, max_t, nodes, leaves, nrays, n_leaves,
                      eps, max_steps, occluded, nullptr, nullptr, steps,
                      truncated, first, grid, work, stream);
}

// The opt-in shared memory a block of `device` may use, in bytes.
extern "C" int rtbvh_shared_mem_per_block(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

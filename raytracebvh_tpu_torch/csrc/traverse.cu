// K1: nearest-hit BVH traversal, and K4: any-hit (occlusion) traversal.
// One thread per ray; both are one walk, a template on AnyHit.
//
// K1 replaces the JAX package's HBM refill traversal
// (raytracebvh_tpu/ops/traverse_hbm.py, _make_refill_kernel(any_hit=False),
// launched by _run_refill through traverse_hbm_pallas).  Contract: equal to
// the plain raytracebvh_tpu_torch/ops/traverse.py traverse -- the same hit,
// leaf (0 where there is no hit) and distance for every ray.
//
// K4 replaces the same kernel built with any_hit=True
// (_make_refill_kernel(any_hit=True), through traverse_any_hbm_pallas): the
// shadow rays.  Contract: equal to the plain traverse_any -- occluded where
// any triangle meets the ray at t in (eps, max_t[r]).  It differs from K1
// in three places: a box is pruned unless tmin <= max_t, a triangle counts
// only when t < max_t, and a ray leaves the walk on its first occluder.
// max_t is computed by the caller (dist * (1 - 1e-4) in PyTorch) and
// compared here as the same float32 value the plain version compares.
//
// What bounds them on an H100: issue slots, not latency.  A thread walks
// one ray, 48 warps an SM (38-39 registers, blocks of 128), and rays in
// launch order keep a warp's walks of nearly equal length (lane
// efficiency 0.95-0.97 on the 1080p primary and shadow rays, 0.91 on the
// bounce rays), so a warp-iteration is one node step for 32 lanes.  On
// the dense 1080p frame K1's walk spends ~60 issue slots a warp-iteration
// (device time less that of rays that all miss the root, at 1.755-1.98
// GHz over the SM's four schedulers), and the loop needs ~45 of them:
// the schedulers are 75-85% busy, and more warps in flight could buy at
// most the rest.  So the design counts instructions.  In SASS a node step
// (box test, link choice, loop control) is 41 instructions: two 16-byte
// loads of the 32-byte node record (one wide multiply for its address),
// six subtractions and six multiplies, ten min/max as single FMNMX.NAN
// (walk.cuh; the compare-and-select form took 27 instructions), four
// compares and one select for the next link, the same in K1 and K4.  The
// Moeller-Trumbore test (~80 instructions, three loads of the leaf table,
// the division's slow path called out of the loop) runs in 5-12% of
// warp-iterations, so it stays a branch of the step.  What is not here:
// a stack (the skip links need none, so registers stay few), a work
// queue or lane refill (worth at most 1 - lane efficiency), staging the
// tree in shared memory (K5/K6), and two rays a thread (the slots, not
// the latency, bound the loop).  K4's walks are shorter than K1's: no
// nearest-hit pruning, but an occluded ray stops at its first occluder
// (set inside the leaf test, so the link choice is one select), and a
// dead shadow ray (origin 1e30) misses the root on step one.  The TPU
// kernel's rank-space windows, refill slots, pump and wsweep answered
// VMEM capacity and lock-step lanes; a GPU warp diverges instead, so none
// of it is carried over, for either kernel.
//
// Parity with the plain PyTorch version: the walk is walk.cuh's, which
// says how it rounds as the plain version does.

#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

template <bool AnyHit>
__global__ void traverse_kernel(const float* __restrict__ origin,
                                const float* __restrict__ direction,
                                const float* __restrict__ max_t,
                                const float4* __restrict__ nodes,
                                const float4* __restrict__ leaves,
                                int nrays, int n_leaves, float eps,
                                int max_steps, unsigned char* __restrict__ hit_out,
                                float* __restrict__ dist_out,
                                int* __restrict__ leaf_out,
                                int* __restrict__ steps_out,
                                int* __restrict__ truncated) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrays) return;
  rtbvh::walk_ray<AnyHit>(rtbvh::GlobalNodes{nodes}, leaves, r, origin,
                          direction, max_t, n_leaves, eps, max_steps, hit_out,
                          dist_out, leaf_out, steps_out, truncated);
}

template <bool AnyHit>
int launch(const float* origin, const float* direction, const float* max_t,
           const void* nodes, const void* leaves, int nrays, int n_leaves,
           float eps, int max_steps, unsigned char* hit, float* dist, int* leaf,
           int* steps, int* truncated, void* stream) {
  const int block = 128;
  const int grid = (nrays + block - 1) / block;
  if (grid > 0) {
    traverse_kernel<AnyHit><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        origin, direction, max_t, static_cast<const float4*>(nodes),
        static_cast<const float4*>(leaves), nrays, n_leaves, eps, max_steps,
        hit, dist, leaf, steps, truncated);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtbvh_traverse(const float* origin, const float* direction,
                              const void* nodes, const void* leaves, int nrays,
                              int n_leaves, float eps, int max_steps,
                              unsigned char* hit, float* dist, int* leaf,
                              int* steps, int* truncated, void* stream) {
  return launch<false>(origin, direction, nullptr, nodes, leaves, nrays,
                       n_leaves, eps, max_steps, hit, dist, leaf, steps,
                       truncated, stream);
}

extern "C" int rtbvh_traverse_any(const float* origin, const float* direction,
                                  const float* max_t, const void* nodes,
                                  const void* leaves, int nrays, int n_leaves,
                                  float eps, int max_steps,
                                  unsigned char* occluded, int* steps,
                                  int* truncated, void* stream) {
  return launch<true>(origin, direction, max_t, nodes, leaves, nrays, n_leaves,
                      eps, max_steps, occluded, nullptr, nullptr, steps,
                      truncated, stream);
}

extern "C" const char* rtbvh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: nearest-hit BVH traversal, one thread per ray.
//
// Replaces the JAX package's HBM refill traversal
// (raytracebvh_tpu/ops/traverse_hbm.py, _make_refill_kernel(any_hit=False),
// launched by _run_refill through traverse_hbm_pallas).  Contract: equal to
// the plain raytracebvh_tpu_torch/ops/traverse.py traverse -- the same hit,
// leaf (0 where there is no hit) and distance for every ray.
//
// What bounds it on an H100: latency.  Each step of a walk is a dependent
// chain -- load the node, test its box, pick the next node from the links
// just loaded -- so a thread waits on one global load per step (two more
// at a leaf), and the SM hides that only with many warps in flight.  The
// design answers it simply: a stackless skip-link walk needs no stack in
// local memory, so a thread needs few registers and an SM keeps many warps
// resident; a node is one 32-byte load (two float4), a leaf triangle three
// float4 with the edges precomputed once per build; the tables stay in
// global memory, and the 50 MB L2 holds them whole (0.34 MB for 3 072
// triangles, 11.5 MB for 102 400).  The TPU kernel's rank-space windows,
// refill slots, pump and wsweep answered VMEM capacity and lock-step
// lanes; a GPU warp diverges instead, so none of it is carried over.
//
// Parity with the plain PyTorch version (built with -fmad=false, IEEE
// division):
//  * Slab test NaNs.  A ray with direction (0, 0, 1) has 1/d = inf on x
//    and y; an origin exactly on a box plane gives 0 * inf = NaN.
//    torch.minimum/maximum propagate NaN, so that box is missed; fminf and
//    fmaxf would drop the NaN and hit it.  min_nan/max_nan propagate it.
//  * Every a*b + c*d rounds each product and each sum (no FMA), evaluated
//    left to right as the torch expression is.
//  * Dead rays (origin 1e30) and padding leaves (empty boxes, bbmin.x >
//    bbmax.x) fall out of the same arithmetic as in the plain version.
//  * The step cap is per ray; a ray that reaches it keeps its best hit so
//    far and adds one to *truncated, so a caller can see the cut.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// nodes: [2n] x (float4 bbmin.xyz|bbmax.x, float4 bbmax.yz|entry|skip)
// leaves: [n] x (float4 v0.xyz|e1.x, float4 e1.yz|e2.xy, float4 e2.z|pad)
__global__ void traverse_kernel(const float* __restrict__ origin,
                                const float* __restrict__ direction,
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
  const float ox = origin[3 * r], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
  const float dx = direction[3 * r], dy = direction[3 * r + 1],
              dz = direction[3 * r + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  int node = n_leaves;  // root
  bool hit = false;
  float dist = 0.0f;
  int leaf = 0;
  int it = 0;
  for (; node >= 0 && it < max_steps; ++it) {
    const float4 a = __ldg(&nodes[2 * node]);
    const float4 b = __ldg(&nodes[2 * node + 1]);
    const float t0x = (a.x - ox) * ix, t1x = (a.w - ox) * ix;
    const float t0y = (a.y - oy) * iy, t1y = (b.x - oy) * iy;
    const float t0z = (a.z - oz) * iz, t1z = (b.y - oz) * iz;
    const float tmin = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                               min_nan(t0z, t1z));
    const float tmax = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                               max_nan(t0z, t1z));
    const bool nonempty = a.x <= a.w;
    const bool bhit = (0.0f <= tmax) && (tmin <= tmax) && nonempty &&
                      (!hit || tmin <= dist);
    const bool is_leaf = node < n_leaves;
    if (bhit && is_leaf) {  // Moeller-Trumbore against the leaf triangle
      const float4 l0 = __ldg(&leaves[3 * node]);
      const float4 l1 = __ldg(&leaves[3 * node + 1]);
      const float4 l2 = __ldg(&leaves[3 * node + 2]);
      const float v0x = l0.x, v0y = l0.y, v0z = l0.z;
      const float e1x = l0.w, e1y = l1.x, e1z = l1.y;
      const float e2x = l1.z, e2y = l1.w, e2z = l2.x;
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool det_ok = fabsf(det) >= eps;
      const float inv_det = det_ok ? 1.0f / det : 0.0f;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool tri_ok = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                          u + v <= 1.0f && t > eps;
      if (tri_ok && (!hit || t < dist)) {
        dist = t;
        leaf = node;
        hit = true;
      }
    }
    node = (bhit && !is_leaf) ? __float_as_int(b.z) : __float_as_int(b.w);
  }
  if (node >= 0) atomicAdd(truncated, 1);
  hit_out[r] = hit ? 1 : 0;
  dist_out[r] = dist;
  leaf_out[r] = leaf;
  if (steps_out != nullptr) steps_out[r] = it;
}

}  // namespace

extern "C" int rtbvh_traverse(const float* origin, const float* direction,
                              const void* nodes, const void* leaves, int nrays,
                              int n_leaves, float eps, int max_steps,
                              unsigned char* hit, float* dist, int* leaf,
                              int* steps, int* truncated, void* stream) {
  const int block = 128;
  const int grid = (nrays + block - 1) / block;
  if (grid > 0) {
    traverse_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        origin, direction, static_cast<const float4*>(nodes),
        static_cast<const float4*>(leaves), nrays, n_leaves, eps, max_steps,
        hit, dist, leaf, steps, truncated);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtbvh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

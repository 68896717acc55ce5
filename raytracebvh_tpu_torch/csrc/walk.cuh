// The skip-link walk of one ray, shared by K1/K4 (traverse.cu) and K5/K6
// (traverse_shared.cu): one copy of the arithmetic, so the kernels agree
// with each other and with the plain PyTorch walk bit for bit.  The two
// differ only in where a node's record is read from (the Nodes policy).
//
// Parity with the plain PyTorch version (built with -fmad=false, IEEE
// division):
//  * Slab test NaNs.  A ray with direction (0, 0, 1) has 1/d = inf on x
//    and y; an origin exactly on a box plane gives 0 * inf = NaN.
//    torch.minimum/maximum propagate NaN, so that box is missed; fminf and
//    fmaxf would drop the NaN and hit it.  min_nan/max_nan propagate it,
//    each one instruction (PTX min.NaN / max.NaN, SASS FMNMX.NAN).  They
//    may differ from torch.minimum/maximum only in the sign of a zero
//    result (min of -0 and +0) and in a NaN's payload; tmin and tmax, their
//    only users, enter nothing but the comparisons below, where -0 == +0
//    and every NaN compares false, so hits, leaves, distances and step
//    counts are the same.
//  * Every a*b + c*d rounds each product and each sum (no FMA), evaluated
//    left to right as the torch expression is.
//  * Dead rays (origin 1e30) and padding leaves (empty boxes, bbmin.x >
//    bbmax.x) fall out of the same arithmetic as in the plain version.
//  * The step cap is per ray; a ray that reaches it keeps its result so
//    far (best hit, or not occluded) and adds one to *truncated, so a
//    caller can see the cut.
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace rtbvh {

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Node records: [2n] x (float4 bbmin.xyz|bbmax.x, float4 bbmax.yz|entry|skip)
// read from global memory through the read-only cache.
struct GlobalNodes {
  const float4* __restrict__ nodes;
  __device__ __forceinline__ void load(int node, float4& a, float4& b) const {
    const float4* rec = nodes + 2 * static_cast<ptrdiff_t>(node);  // 32 bytes
    a = __ldg(rec);
    b = __ldg(rec + 1);
  }
};

// leaves: [n] x (float4 v0.xyz|e1.x, float4 e1.yz|e2.xy, float4 e2.z|pad).
// AnyHit: reads max_t, writes hit_out (occluded); dist_out and leaf_out
// are unused.  Otherwise max_t is unused.
template <bool AnyHit, class Nodes>
__device__ __forceinline__ void walk_ray(
    const Nodes& nodes, const float4* __restrict__ leaves, int r,
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ max_t, int n_leaves, float eps, int max_steps,
    unsigned char* __restrict__ hit_out, float* __restrict__ dist_out,
    int* __restrict__ leaf_out, int* __restrict__ steps_out,
    int* __restrict__ truncated) {
  const float ox = origin[3 * r], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
  const float dx = direction[3 * r], dy = direction[3 * r + 1],
              dz = direction[3 * r + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const float ray_max = AnyHit ? max_t[r] : 0.0f;

  int node = n_leaves;  // root
  bool hit = false;
  // the nearest hit so far, +inf before the first: tmin <= dist then
  // prunes as !hit || tmin <= dist does (a NaN tmin misses the box anyway)
  float dist = __int_as_float(0x7f800000);
  int leaf = 0;
  int it = 0;
  for (; node >= 0 && it < max_steps; ++it) {
    float4 a, b;
    nodes.load(node, a, b);
    const float t0x = (a.x - ox) * ix, t1x = (a.w - ox) * ix;
    const float t0y = (a.y - oy) * iy, t1y = (b.x - oy) * iy;
    const float t0z = (a.z - oz) * iz, t1z = (b.y - oz) * iz;
    const float tmin = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                               min_nan(t0z, t1z));
    const float tmax = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                               max_nan(t0z, t1z));
    const bool nonempty = a.x <= a.w;
    const bool prune_ok = tmin <= (AnyHit ? ray_max : dist);
    const bool bhit = (0.0f <= tmax) && (tmin <= tmax) && nonempty && prune_ok;
    const bool is_leaf = node < n_leaves;
    int next = (bhit && !is_leaf) ? __float_as_int(b.z) : __float_as_int(b.w);
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
      if (AnyHit) {
        if (tri_ok && t < ray_max) {  // the any-hit early out
          hit = true;
          next = -1;
        }
      } else if (tri_ok && (!hit || t < dist)) {
        dist = t;
        leaf = node;
        hit = true;
      }
    }
    node = next;
  }
  if (node >= 0) atomicAdd(truncated, 1);
  hit_out[r] = hit ? 1 : 0;
  if (!AnyHit) {
    dist_out[r] = hit ? dist : 0.0f;
    leaf_out[r] = leaf;
  }
  if (steps_out != nullptr) steps_out[r] = it;
}

}  // namespace rtbvh

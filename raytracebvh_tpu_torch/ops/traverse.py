"""Batched stackless BVH traversal with Moeller-Trumbore intersection:
the plain PyTorch versions (the JAX package's ``ops/traverse.py``
``traverse`` and ``traverse_any``, op for op).

All rays advance in lock-step through the precomputed skip links:

    box hit & internal  -> entry_link (descend left-first)
    box hit & leaf      -> Moeller-Trumbore against the leaf triangle,
                           then skip_link
    box miss            -> skip_link (prune the subtree)

Rays finish when they walk off the root's skip link (-1); an any-hit ray
also finishes on its first occluder.  This is the CPU path and the plain
version that kernels K1 and K4 (``ops.traverse_cuda``) are held against.
"""

from __future__ import annotations

import torch

from ..core.types import BVH, HitRecord, Rays


class _Walk:
    """The ray and tree columns both walks read, and the two tests they
    share: the slab test of a node's box and Moeller-Trumbore against a
    leaf's triangle."""

    def __init__(self, bvh: BVH, rays: Rays):
        self.o = tuple(rays.origin[:, k] for k in range(3))
        self.d = tuple(rays.direction[:, k] for k in range(3))
        inv = rays.inv_direction
        self.inv = tuple(inv[:, k] for k in range(3))
        self.bmin = tuple(bvh.bbmin[:, k] for k in range(3))
        self.bmax = tuple(bvh.bbmax[:, k] for k in range(3))
        tv = bvh.tri_verts  # [n, 3, 3]
        self.v0 = tuple(tv[:, 0, k] for k in range(3))
        self.e1 = tuple(tv[:, 1, k] - tv[:, 0, k] for k in range(3))
        self.e2 = tuple(tv[:, 2, k] - tv[:, 0, k] for k in range(3))

    def box(self, nid):
        """(tmin, tmax, nonempty) of node ``nid``'s box; empty padding
        boxes (bbmin > bbmax) are flagged, and an origin on a box plane
        of an axis-parallel ray gives 0 * inf = NaN, which min/max
        propagate so the box is missed."""
        (ox, oy, oz), (ix, iy, iz) = self.o, self.inv
        (bminx, bminy, bminz), (bmaxx, bmaxy, bmaxz) = self.bmin, self.bmax
        t0x = (bminx[nid] - ox) * ix
        t1x = (bmaxx[nid] - ox) * ix
        t0y = (bminy[nid] - oy) * iy
        t1y = (bmaxy[nid] - oy) * iy
        t0z = (bminz[nid] - oz) * iz
        t1z = (bmaxz[nid] - oz) * iz
        tmin = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.minimum(t0z, t1z))
        tmax = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.maximum(t0z, t1z))
        return tmin, tmax, bminx[nid] <= bmaxx[nid]

    def triangle(self, lid, epsilon):
        """(t, tri_ok): the ray's hit distance on leaf ``lid``'s triangle
        and whether it is a hit beyond ``epsilon``."""
        (ox, oy, oz), (dx, dy, dz) = self.o, self.d
        g_v0x, g_v0y, g_v0z = (c[lid] for c in self.v0)
        g_e1x, g_e1y, g_e1z = (c[lid] for c in self.e1)
        g_e2x, g_e2y, g_e2z = (c[lid] for c in self.e2)
        px = dy * g_e2z - dz * g_e2y
        py = dz * g_e2x - dx * g_e2z
        pz = dx * g_e2y - dy * g_e2x
        det = g_e1x * px + g_e1y * py + g_e1z * pz
        det_ok = torch.abs(det) >= epsilon
        inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
        tvx, tvy, tvz = ox - g_v0x, oy - g_v0y, oz - g_v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * g_e1z - tvz * g_e1y
        qy = tvz * g_e1x - tvx * g_e1z
        qz = tvx * g_e1y - tvy * g_e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (g_e2x * qx + g_e2y * qy + g_e2z * qz) * inv_det
        tri_ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > epsilon))
        return t, tri_ok


def traverse(bvh: BVH, rays: Rays, epsilon: float, max_steps: int = 0,
             return_steps: bool = False):
    """Nearest-hit traversal for a batch of [R] rays.

    Args:
      epsilon: Moeller-Trumbore determinant cutoff and min distance.
      max_steps: per-ray step cap (0 = 4n, an upper bound on a skip-link
        walk).
      return_steps: also return the [R] int32 per-ray step counts.

    Returns HitRecord (leaf ids into the BVH's leaf arrays; leaf 0 and
    distance 0 where there is no hit), and the steps when asked.
    """
    n = bvh.n_leaves
    nrays = rays.origin.shape[0]
    dev = rays.origin.device
    if max_steps <= 0:
        max_steps = 4 * n
    walk = _Walk(bvh, rays)

    node = torch.full((nrays,), n, dtype=torch.int32, device=dev)
    hit = torch.zeros(nrays, dtype=torch.bool, device=dev)
    dist = torch.zeros(nrays, dtype=rays.origin.dtype, device=dev)
    leaf = torch.zeros(nrays, dtype=torch.int32, device=dev)
    steps = torch.zeros(nrays, dtype=torch.int32, device=dev)
    for _ in range(max_steps):
        live = node >= 0
        if not bool(live.any()):
            break
        steps += live.to(torch.int32)
        nid = torch.clamp(node, min=0)

        tmin, tmax, nonempty = walk.box(nid)
        bhit = (0.0 <= tmax) & (tmin <= tmax) & nonempty
        bhit = bhit & (~hit | (tmin <= dist)) & live

        # leaf triangle test (masked: lanes at internal nodes read leaf 0)
        is_leaf = nid < n
        t, tri_ok = walk.triangle(torch.where(is_leaf, nid, 0), epsilon)

        upd = live & is_leaf & bhit & tri_ok & (~hit | (t < dist))
        dist = torch.where(upd, t, dist)
        leaf = torch.where(upd, nid, leaf)
        hit = hit | upd

        descend = bhit & ~is_leaf
        nxt = torch.where(descend, bvh.entry_link[nid], bvh.skip_link[nid])
        node = torch.where(live, nxt, node)
    rec = HitRecord(hit=hit, distance=dist, leaf=leaf)
    return (rec, steps) if return_steps else rec


def traverse_any(bvh: BVH, rays: Rays, epsilon: float, max_t,
                 max_steps: int = 0, return_steps: bool = False):
    """Any-hit (occlusion) traversal: True where any triangle meets the
    ray at a distance in (epsilon, max_t).

    Differs from ``traverse`` in three places: a box is pruned unless
    ``tmin <= max_t``; a triangle counts only when ``t < max_t``; a ray
    leaves the walk on its first occluder.

    Args:
      max_t: [R] per-ray maximum distance (e.g. the distance to the light).
      max_steps: per-ray step cap (0 = 4n); a capped ray that found no
        occluder yet reads False.
      return_steps: also return the [R] int32 per-ray step counts.
    """
    n = bvh.n_leaves
    nrays = rays.origin.shape[0]
    dev = rays.origin.device
    if max_steps <= 0:
        max_steps = 4 * n
    walk = _Walk(bvh, rays)

    node = torch.full((nrays,), n, dtype=torch.int32, device=dev)
    occ = torch.zeros(nrays, dtype=torch.bool, device=dev)
    steps = torch.zeros(nrays, dtype=torch.int32, device=dev)
    for _ in range(max_steps):
        live = node >= 0
        if not bool(live.any()):
            break
        steps += live.to(torch.int32)
        nid = torch.clamp(node, min=0)

        tmin, tmax, nonempty = walk.box(nid)
        # prune boxes entirely beyond max_t
        bhit = ((0.0 <= tmax) & (tmin <= tmax) & nonempty & (tmin <= max_t)
                & live)

        is_leaf = nid < n
        t, tri_ok = walk.triangle(torch.where(is_leaf, nid, 0), epsilon)

        found = live & is_leaf & bhit & tri_ok & (t < max_t)
        occ = occ | found

        descend = bhit & ~is_leaf
        nxt = torch.where(descend, bvh.entry_link[nid], bvh.skip_link[nid])
        # an occluded ray leaves the walk at once (the any-hit early out)
        node = torch.where(live & ~found, nxt, -1)
    return (occ, steps) if return_steps else occ

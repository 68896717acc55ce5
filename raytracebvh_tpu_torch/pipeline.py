"""The frame pipeline: transform -> morton -> sort -> build -> trace -> shade
(the JAX package's ``pipeline.py``, forward rendering, in torch).

Traversal returns discrete hit ids behind a ``.detach()`` boundary; hit
distances, positions, normals, uv and colours are recomputed from those
ids by plain tensor code, as in the JAX package.  On CUDA tensors the
traversal is kernel K5 with the tree in shared memory
(``ops.traverse_shared_cuda``) where the tree fits, else K1
(``ops.traverse_cuda``); the leaf-attribute gather is kernel K2
(``ops.gather_cuda``) or, for ``shade_gather_backend='shared'``, K7 on the
channel-major table (``ops.gather_cols_cuda``); the texture-quad gather
is K2; the build's sort is K8 (``ops.sort_cuda``) for
``sort_backend`` ``bitonic`` or ``auto``.  A build that needs no gradient,
on the card and in float32, packs its leaf rows and K1's tables in one
hand-written kernel (``ops.pack_cuda``).  A shading pass that needs no
gradient, on the card, in float32 and on a kernel gather, runs its
arithmetic as two hand-written kernels around the texture gather
(``ops.shade_cuda``); the plain tensor code is the reference and the
differentiable path.  The ``*_backend`` fields of
the config pick them (see ``config.py``).  Shadow rays
(``enable_shadows``) go through the any-hit traversal, kernel K6 or K4 on
CUDA tensors; occlusion is discrete and computed under ``.detach()``,
like the hit ids.  ``enable_refraction`` adds the
refraction chain and blends it over the reflection result.
"""

from __future__ import annotations

import dataclasses

import torch

from .camera import (
    camera_matrices,
    check_tile_order,
    perspective_rays,
    permute_rays,
    reference_rays,
    structured_tile_shape,
    tile_permutation,
    tile_rays,
    transform_normals,
    transform_points,
    untile_flat,
)
from . import graphs
from .config import RenderConfig, resolve_backend, resolve_sort_backend
from .core.types import BVH, Camera, HitRecord, Rays, Scene
from .ops import bvh as bvh_ops
from .ops import gather_cols_cuda, gather_cuda
from .ops.ieee import div, sqrt
from .ops import morton as morton_ops
from .ops import shade as shade_ops
from .ops import sort as sort_ops
from .ops import (pack_cuda, shade_cuda, sort_cuda, traverse_cuda,
                  traverse_shared_cuda)
from .utils import profiling

I32 = torch.int32


def _pad_count(nf: int, multiple: int) -> int:
    """Padded leaf count (the reference's 256 * ceil(nf / 256) sizing)."""
    return max(multiple, ((nf + multiple - 1) // multiple) * multiple)


def build_bvh(scene: Scene, wvp, wv, cfg: RenderConfig) -> BVH:
    """Per-frame LBVH rebuild in ray space (the span ``build``, its stages
    ``morton`` ... ``links`` inside it)."""
    dtype = cfg.torch_dtype
    with profiling.span("build", scene.verts):
        with profiling.span("morton", scene.verts):
            verts_t = transform_points(scene.verts.to(dtype), wvp.to(dtype))
            normals_t = transform_normals(scene.normals.to(dtype),
                                          wv.to(dtype))
            smin, smax = morton_ops.scene_aabb(verts_t)
            codes, lmin, lmax, _ = morton_ops.triangle_leaves(
                verts_t, scene.indices, smin, smax)
        return assemble_bvh(scene, verts_t, normals_t, codes, lmin, lmax,
                            cfg)


def sort_codes(codes, sort_backend: str):
    """The build's stable sort of the int32 codes -> (sorted codes, order):
    K8 for ``bitonic``, the plain radix sort for ``radix``, else
    ``torch.sort`` (``lax``)."""
    if sort_backend == "bitonic":
        return sort_cuda.bitonic_sort_by_code(codes)
    if sort_backend == "radix":
        return sort_ops.radix_sort_by_code(codes)
    return sort_ops.sort_by_code(codes)


def assemble_bvh(scene: Scene, verts_t, normals_t, codes, lmin, lmax,
                 cfg: RenderConfig) -> BVH:
    """Sort + Karras + AABB fit + links + leaf-attribute pack from per-face
    leaf data in face-id order: the spans ``sort``, ``topology``, ``fit``,
    ``links`` and ``pack`` (inside the caller's ``build``).  The pack is
    one kernel (``ops.pack_cuda``) where ``pack_cuda.engages`` holds, and
    then also writes K1's tables (``node_table``, ``leaf_table``); else
    the plain pack (``_pack_leaves``), and the tables are packed later
    (``shade_setup``)."""
    dtype = cfg.torch_dtype
    dev = verts_t.device
    sort_backend = resolve_sort_backend(cfg, dev)
    nf = scene.num_faces
    n = _pad_count(nf, cfg.leaf_pad_multiple)

    # pad to the leaf count with sentinel codes + empty boxes
    pad = n - nf
    codes = torch.cat([codes.to(I32), torch.full(
        (pad,), morton_ops.SENTINEL_CODE, dtype=I32, device=dev)])
    lmin = torch.cat([lmin, torch.full((pad, 3), bvh_ops.BIG, dtype=dtype,
                                       device=dev)])
    lmax = torch.cat([lmax, torch.full((pad, 3), -bvh_ops.BIG, dtype=dtype,
                                       device=dev)])
    prim = torch.cat([torch.arange(nf, dtype=I32, device=dev),
                      torch.full((pad,), -1, dtype=I32, device=dev)])

    with profiling.span("sort", codes):
        sorted_codes, order = sort_codes(codes, sort_backend)
    order = order.long()
    prim, lmin, lmax = prim[order], lmin[order], lmax[order]

    with profiling.span("topology", codes):
        topo = bvh_ops.build_topology(sorted_codes)
    with profiling.span("fit", codes):
        bbmin, bbmax = bvh_ops.fit_aabbs(topo.node_lo, topo.node_hi, lmin,
                                         lmax)
    with profiling.span("links", codes):
        entry, skip = bvh_ops.compute_links(topo, n)

    tensors = pack_cuda.inputs(scene, verts_t, normals_t, prim, bbmin, bbmax,
                               entry, skip)
    with profiling.span("pack", codes):
        if pack_cuda.engages(cfg, tensors):
            leaves = pack_cuda.pack(tensors)
        else:
            leaves = _pack_leaves(scene, verts_t, normals_t, prim, dtype)

    return BVH(
        codes=sorted_codes,
        prim=prim,
        bbmin=bbmin,
        bbmax=bbmax,
        child_l=topo.child_l,
        child_r=topo.child_r,
        parent=topo.parent,
        entry_link=entry,
        skip_link=skip,
        **leaves,
    )


def _pack_leaves(scene: Scene, verts_t, normals_t, prim, dtype) -> dict:
    """The plain leaf pack: the leaf triangle data in morton order
    (``prim``; a padding leaf takes face 0's), gathered once per build ->
    the BVH's ``tri_verts``, ``tri_normals``, ``tri_uv``, ``tri_mat`` and
    ``leaf_attrs``.  The reference for ``ops.pack_cuda`` and the
    differentiable path."""
    safe_prim = torch.clamp(prim, min=0).long()
    corner = scene.indices.reshape(-1, 3)[safe_prim].long()  # [n, 3]
    vrow8 = torch.cat([verts_t, normals_t, scene.uv.to(dtype)], dim=1)
    A = [vrow8[corner[:, v]] for v in range(3)]  # 3 x [n, 8]
    tri_mat = scene.mat_index[safe_prim]

    mats = scene.materials
    mrow16 = torch.cat([
        mats.ambient.to(dtype), mats.diffuse.to(dtype),
        mats.specular.to(dtype), mats.shininess.to(dtype)[:, None],
        mats.optical_density.to(dtype)[:, None], mats.alpha.to(dtype)[:, None],
        mats.tex_id.to(dtype)[:, None],  # integer-valued float
    ], dim=1)  # [nmat, 16]
    leaf_attrs = torch.cat(
        [A[0][:, 0:3], A[1][:, 0:3], A[2][:, 0:3],
         A[0][:, 3:6], A[1][:, 3:6], A[2][:, 3:6],
         A[0][:, 6:8], A[1][:, 6:8], A[2][:, 6:8], mrow16[tri_mat.long()]],
        dim=-1)  # [n, 40]
    return dict(
        tri_verts=torch.stack([a[:, 0:3] for a in A], dim=1),
        tri_normals=torch.stack([a[:, 3:6] for a in A], dim=1),
        tri_uv=torch.stack([a[:, 6:8] for a in A], dim=1),
        tri_mat=tri_mat,
        leaf_attrs=leaf_attrs,
    )


def resolve_traversal_backend(cfg: RenderConfig, n_leaves: int,
                              device: torch.device) -> str:
    """'torch' (the plain walk), 'cuda' (K1/K4's wrapper) or 'shared'
    (K5/K6's) for a tree of ``n_leaves`` leaves on ``device``, the
    counterpart of the JAX package's: ``auto`` and ``shared`` take K5/K6
    where the tree fits a block's shared memory
    (``traverse_shared_cuda.fits``) and K1/K4 above, as the JAX ``auto``
    and ``pallas`` take the HBM kernel above the VMEM kernel's cap.  On
    the CPU only the JAX cap applies: both wrappers run the plain walk
    there."""
    backend = resolve_backend(cfg, "traversal_backend")
    if backend == "shared":
        if not traverse_shared_cuda.fits(
                n_leaves, traverse_shared_cuda.smem_per_block(device)):
            backend = "cuda"
    return backend


def _walks(bvh: BVH, cfg: RenderConfig):
    """(the backend cfg resolves to for ``bvh``, its nearest-hit walk, its
    any-hit walk)."""
    backend = resolve_traversal_backend(cfg, bvh.n_leaves, bvh.prim.device)
    if backend == "shared":
        return (backend, traverse_shared_cuda.traverse,
                traverse_shared_cuda.traverse_any)
    return (backend, traverse_cuda.traverse_for(backend),
            traverse_cuda.traverse_any_for(backend))


def _counted(walk: str, traverse, *args):
    """``traverse(*args)``, a nearest-hit or any-hit walk; while spans are
    on, with its per-ray node steps, whose sum is counted as the walk span
    ``walk``'s (``profiling.count``).  With spans off, the call alone."""
    if profiling.active is None:
        return traverse(*args)
    out, steps = traverse(*args, return_steps=True)
    profiling.count(walk, steps)
    return out


def _traverse_ids(bvh: BVH, rays: Rays, cfg: RenderConfig,
                  walk: str = "walk.primary") -> HitRecord:
    """Traversal behind a detach boundary (the span ``walk``, a primary or
    a bounce pass's walk): the ids are discrete.  The plain
    lock-step walk ('torch') runs in sequential chunks of
    ``cfg.traversal_chunk`` rays, which must divide the ray count, as the
    JAX package's ``jnp`` walk does: a chunk bounds the lock-step penalty
    and the walk's live state.  A kernel walk ('cuda', 'shared') takes
    every ray in one call and ignores ``traversal_chunk``, as the JAX
    package's Pallas walks do: its rays are independent.  While spans are
    on, each walk's node steps are counted (``_counted``)."""
    with profiling.span(walk, rays.origin):
        bvh = bvh.detach()
        rays = Rays(origin=rays.origin.detach().contiguous(),
                    direction=rays.direction.detach().contiguous())
        backend, traverse, _ = _walks(bvh, cfg)
        nrays = rays.origin.shape[0]
        chunk = cfg.traversal_chunk
        if backend == "torch" and chunk > 0 and nrays > chunk:
            if nrays % chunk:
                raise ValueError(
                    f"traversal_chunk {chunk} must divide ray count {nrays}")
            recs = [_counted(walk, traverse, bvh,
                             Rays(rays.origin[s:s + chunk],
                                  rays.direction[s:s + chunk]),
                             cfg.epsilon, cfg.max_traversal_steps)
                    for s in range(0, nrays, chunk)]
            return HitRecord(hit=torch.cat([r.hit for r in recs]),
                             distance=torch.cat([r.distance for r in recs]),
                             leaf=torch.cat([r.leaf for r in recs]))
        return _counted(walk, traverse, bvh, rays, cfg.epsilon,
                        cfg.max_traversal_steps)


def light_in_ray_space(cfg: RenderConfig, wvp, dtype):
    """``cfg.light_pos`` (world) -> tuple of 3 scalar tensors in tracing
    space: 'reference' mode traces WVP-transformed geometry with no
    w-divide, so the light rides the same transform; 'perspective' mode
    traces in world space.  On ``wvp``'s device."""
    light = torch.stack([wvp.new_full((), x, dtype=dtype)
                         for x in cfg.light_pos])
    if cfg.camera_mode == "reference":
        light = transform_points(light[None], wvp.to(dtype))[0]
    return (light[0], light[1], light[2])


def _shadow_vis(bvh: BVH, o3, d3, rec: HitRecord, light3, cfg: RenderConfig):
    """Per-ray visibility factor from one any-hit shadow ray toward the
    light: ``cfg.shadow_factor`` where a primary hit is occluded, else 1.
    Discrete, and computed under ``.detach()``, like the hit ids (the span
    ``walk.shadow``: the shadow rays made and walked, the walk's node steps
    counted while spans are on)."""
    with profiling.span("walk.shadow", rec.distance):
        t = rec.distance.detach()
        o3 = tuple(o.detach() for o in o3)
        d3 = tuple(d.detach() for d in d3)
        light3 = tuple(x.detach() for x in light3)
        hx = tuple(o3[i] + d3[i] * t for i in range(3))
        L = tuple(light3[i] - hx[i] for i in range(3))
        dist = sqrt(shade_ops.dot3(L, L))
        invd = 1.0 / torch.clamp(dist, min=1e-30)
        dirn = tuple(L[i] * invd for i in range(3))
        # offset along the shadow direction; stop just short of the light
        so = tuple(hx[i] + dirn[i] * cfg.ray_offset for i in range(3))
        max_t = dist * (1.0 - 1e-4)
        # dead lanes (primary misses) start far outside every box
        so = tuple(torch.where(rec.hit, so[i], 1.0e30) for i in range(3))
        traverse_any = _walks(bvh, cfg)[2]
        occ = _counted("walk.shadow", traverse_any, bvh.detach(),
                       _rays_of(so, dirn), cfg.epsilon, max_t.contiguous(),
                       cfg.max_traversal_steps)
        occ = occ & rec.hit
        return torch.where(occ, t.new_full((), cfg.shadow_factor), 1.0)


def _leaf_block(bvh: BVH, rec: HitRecord, cfg: RenderConfig):
    """The [40, R] leaf-attribute block of the hits: one [40]-channel
    gather per ray fetches everything, a row gather from the
    leaf-attribute table (K2 on CUDA), or for 'shared' a column gather
    from its channel-major transpose (K7 on CUDA), as the JAX 'pallas'
    gathers from ``leaf_attrs.T``: the span ``gather``."""
    backend = resolve_backend(cfg, "shade_gather_backend")
    with profiling.span("gather", rec.leaf):
        if backend == "shared":
            return gather_cols_cuda.gather_cols(
                bvh.leaf_attrs.t().contiguous(), rec.leaf)
        return gather_cuda.gather_for(backend)(bvh.leaf_attrs, rec.leaf)


def _shade_hit_soa(scene: Scene, bvh: BVH, o3, d3, rec: HitRecord,
                   tex_quads, cfg: RenderConfig, vis=None):
    """Re-evaluation of a hit from its leaf id, in plain PyTorch:
    position, normal, surface colour (renderPixel * specular, the diffuse
    term scaled by the shadow factor ``vis`` when given), shininess,
    alpha and optical density, from the leaf block (``_leaf_block``) and
    a texture sample (its gather the span ``gather`` too)."""
    A = _leaf_block(bvh, rec, cfg)
    # the rows as one unbind: its backward stacks the rows' gradients
    # once, where a select a row would fill and add a whole [40, R]
    # gradient for each
    a = A.unbind(0)
    t0 = (a[0], a[1], a[2])
    t1 = (a[3], a[4], a[5])
    t2 = (a[6], a[7], a[8])

    # the hit distance, recomputed op for op as Moeller-Trumbore
    e1 = shade_ops.sub3(t1, t0)
    e2 = shade_ops.sub3(t2, t0)
    p = shade_ops.cross3(d3, e2)
    det = shade_ops.dot3(e1, p)
    det_ok = torch.abs(det) >= 1e-12
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tv = shade_ops.sub3(o3, t0)
    u = shade_ops.dot3(tv, p) * inv_det
    q = shade_ops.cross3(tv, e1)
    v = shade_ops.dot3(d3, q) * inv_det
    t = shade_ops.dot3(e2, q) * inv_det
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 1e-12))
    t = torch.where(ok, t, -1.0)
    t = torch.where(rec.hit, t, 0.0)
    hit_loc = tuple(o3[i] + d3[i] * t for i in range(3))

    w0, w1, w2 = shade_ops.barycentric_weights3(t0, t1, t2, hit_loc)
    n0 = (a[9], a[10], a[11])
    n1 = (a[12], a[13], a[14])
    n2 = (a[15], a[16], a[17])
    normal = tuple(n0[i] * w0 + n1[i] * w1 + n2[i] * w2 for i in range(3))
    uvu = a[18] * w0 + a[20] * w1 + a[22] * w2
    uvv = a[19] * w0 + a[21] * w1 + a[23] * w2

    # texture sample; miss lanes are pinned to texel (0, 0) so they do not
    # gather random rows of the quad table
    tex_id = a[39].to(I32)
    hmax, wmax = scene.textures.shape[1], scene.textures.shape[2]
    uvu = torch.where(rec.hit, uvu, 0.0)
    uvv = torch.where(rec.hit, uvv, 0.0)
    tex = shade_ops.sample_texture_quads(
        tex_quads, scene.tex_hw, tex_id, uvu, uvv, hmax, wmax,
        backend=resolve_backend(cfg, "texture_gather_backend"))
    # saturate(ambient + vis * diffuse * tex) * specular
    diffuse = [a[28 + c] if vis is None else vis * a[28 + c] for c in range(4)]
    color = tuple(
        torch.clamp(a[24 + c] + diffuse[c] * tex[c], 0.0, 1.0) * a[32 + c]
        for c in range(4))
    return hit_loc, normal, color, a[36], a[38], a[37]


def _launch_soa(scene: Scene, bvh: BVH, o3, d3, cfg: RenderConfig,
                tex_quads, light3=None, rec=None):
    """Primary-ray pass: (color4, (refl_o3, refl_d3), refl_intensity,
    (refr_o3, refr_d3), refr_intensity).  Shadow rays are fired when
    ``cfg.enable_shadows`` and ``light3`` is given.  The spans
    ``walk.primary`` (where ``rec`` is not given), ``walk.shadow``, then
    ``shade.primary``: the shading kernels where ``shade_cuda.engages``
    (the frames on the card), else plain PyTorch."""
    if rec is None:
        rec = _traverse_ids(bvh, _rays_of(o3, d3), cfg)
    vis = None
    if cfg.enable_shadows and light3 is not None:
        vis = _shadow_vis(bvh, o3, d3, rec, light3, cfg)
    with profiling.span("shade.primary", o3[0]):
        if shade_cuda.engages(cfg, (bvh.leaf_attrs, tex_quads, *o3, *d3,
                                    vis)):
            return shade_cuda.launch(_leaf_block(bvh, rec, cfg), rec.hit, o3,
                                     d3, scene, tex_quads, cfg, vis)
        hit_loc, normal, hit_color, shininess, alpha, optical = _shade_hit_soa(
            scene, bvh, o3, d3, rec, tex_quads, cfg, vis)
        hit = rec.hit
        bg = cfg.background
        color = tuple(torch.where(hit, hit_color[c], bg[c]) for c in range(4))

        # reflection spawn
        intensity = torch.where(
            hit, div(shininess, 1000.0) * cfg.reflection_decay, 0.0)
        refl_dir = shade_ops.normalize3(shade_ops.reflect3(d3, normal))
        refl_o = tuple(torch.where(hit, hit_loc[i]
                                   + normal[i] * cfg.ray_offset, o3[i])
                       for i in range(3))
        refl_d = tuple(torch.where(hit, refl_dir[i], d3[i]) for i in range(3))

        # refraction spawn: into the surface; total internal reflection
        # spawns nothing
        refr_dir, tir = _refracted(d3, normal, optical)
        live_q = hit & ~tir
        refr_intensity = torch.where(
            live_q, (1.0 - alpha) * cfg.refraction_decay, 0.0)
        refr_o = tuple(torch.where(hit, hit_loc[i]
                                   - normal[i] * cfg.ray_offset, o3[i])
                       for i in range(3))
        refr_d = tuple(torch.where(live_q, refr_dir[i], d3[i])
                       for i in range(3))
        return (color, (refl_o, refl_d), intensity, (refr_o, refr_d),
                refr_intensity)


def _bounce_soa(scene: Scene, bvh: BVH, color, o3, d3, intensity,
                cfg: RenderConfig, tex_quads):
    """One reflection pass: live rays (intensity > intensity_min)
    re-trace; hits lerp the carried colour toward the new surface colour
    and respawn; misses lerp toward the background and die.  The spans
    ``walk.bounce`` and ``shade.bounce`` (its shading as
    ``_launch_soa``'s)."""
    live = intensity > cfg.intensity_min
    # dead rays start far outside every box: their walk ends on step one
    o3m = tuple(torch.where(live, o3[i], 1.0e30) for i in range(3))
    rec = _traverse_ids(bvh, _rays_of(o3m, d3), cfg, "walk.bounce")
    with profiling.span("shade.bounce", intensity):
        if shade_cuda.engages(cfg, (bvh.leaf_attrs, tex_quads, *o3, *d3,
                                    *color, intensity)):
            return shade_cuda.bounce(_leaf_block(bvh, rec, cfg), rec.hit, o3,
                                     d3, color, intensity, scene, tex_quads,
                                     cfg)
        hit_loc, normal, hit_color, shininess, _, _ = _shade_hit_soa(
            scene, bvh, o3, d3, rec, tex_quads, cfg)
        hit = rec.hit & live
        new_color = _lerp_color(color, intensity, live, hit, hit_color, cfg)
        upd = live & hit
        new_intensity = torch.where(
            upd, div(intensity * shininess, 1000.0) * cfg.reflection_decay,
            0.0)
        new_dir = shade_ops.normalize3(shade_ops.reflect3(d3, normal))
        new_o = tuple(torch.where(upd, hit_loc[i] + normal[i]
                                  * cfg.bounce_ray_offset, o3[i])
                      for i in range(3))
        new_d = tuple(torch.where(upd, new_dir[i], d3[i]) for i in range(3))
        return new_color, new_o, new_d, new_intensity


def _bounce_refract_soa(scene: Scene, bvh: BVH, color, o3, d3, intensity,
                        cfg: RenderConfig, tex_quads):
    """One refraction (transmission) pass: as ``_bounce_soa`` but through
    the surface.  The same colour lerp; the intensity decays by the hit
    material's transparency (1 - alpha); the respawn is offset into the
    surface with a refracted direction; total internal reflection kills
    the ray.  The spans ``walk.bounce`` and ``shade.bounce``."""
    live = intensity > cfg.intensity_min
    o3m = tuple(torch.where(live, o3[i], 1.0e30) for i in range(3))
    rec = _traverse_ids(bvh, _rays_of(o3m, d3), cfg, "walk.bounce")
    with profiling.span("shade.bounce", intensity):
        if shade_cuda.engages(cfg, (bvh.leaf_attrs, tex_quads, *o3, *d3,
                                    *color, intensity)):
            return shade_cuda.bounce_refract(
                _leaf_block(bvh, rec, cfg), rec.hit, o3, d3, color,
                intensity, scene, tex_quads, cfg)
        hit_loc, normal, hit_color, _, alpha, optical = _shade_hit_soa(
            scene, bvh, o3, d3, rec, tex_quads, cfg)
        hit = rec.hit & live
        new_color = _lerp_color(color, intensity, live, hit, hit_color, cfg)

        new_dir, tir = _refracted(d3, normal, optical)
        upd = live & hit & ~tir
        new_intensity = torch.where(
            upd, intensity * (1.0 - alpha) * cfg.refraction_decay, 0.0)
        new_o = tuple(torch.where(upd, hit_loc[i] - normal[i]
                                  * cfg.bounce_ray_offset, o3[i])
                      for i in range(3))
        new_d = tuple(torch.where(upd, new_dir[i], d3[i]) for i in range(3))
        return new_color, new_o, new_d, new_intensity


def _refracted(d3, normal, eta):
    """(unit refracted direction, total internal reflection mask): HLSL
    refract gives the zero vector where it reflects totally."""
    raw = shade_ops.refract3(d3, normal, eta)
    return shade_ops.normalize3(raw), shade_ops.dot3(raw, raw) == 0.0


def _lerp_color(color, intensity, live, hit, hit_color, cfg: RenderConfig):
    """A bounce's colour: live rays lerp toward the surface they hit, or
    toward the background on a miss; dead rays keep their colour."""
    bg = cfg.background
    return tuple(
        torch.where(live, color[c] + intensity
                    * (torch.where(hit, hit_color[c], bg[c]) - color[c]),
                    color[c])
        for c in range(4))


def _rays_of(o3, d3):
    return Rays(origin=torch.stack(o3, dim=-1),
                direction=torch.stack(d3, dim=-1))


def _split_rays(rays: Rays):
    o, d = rays.origin, rays.direction
    return tuple(o[:, k] for k in range(3)), tuple(d[:, k] for k in range(3))


def make_rays(camera: Camera, cfg: RenderConfig) -> Rays:
    if cfg.camera_mode == "reference":
        return reference_rays(cfg.width, cfg.height, cfg.ortho_scale,
                              cfg.torch_dtype, camera.eye.device)
    return perspective_rays(camera, cfg.width, cfg.height, cfg.torch_dtype)


def _frame_tex_quads(scene: Scene, cfg: RenderConfig):
    """One row-major quad table per frame, shared by every pass and every
    ray chunk; UNORM8 when ``cfg.texture_dtype == 'uint8'``."""
    resolve_backend(cfg, "texture_gather_backend")  # validate
    tex_quads = shade_ops.pack_texture_quads(scene.textures, scene.tex_hw)
    if cfg.texture_dtype == "uint8":
        tex_quads = shade_ops.quantize_quads_u8(tex_quads.detach())
    elif cfg.texture_dtype != "float32":
        raise ValueError(f"unknown texture_dtype {cfg.texture_dtype!r}; "
                         "expected float32 or uint8")
    return tex_quads


def _shade_rays_one(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig,
                    tex_quads, light3=None, rec=None):
    """Launch + bounce chain (+ the refraction chain) for one batch of
    rays -> [R, 4] colour.  Shadow rays apply to primary hits; the
    bounces keep the unshadowed lerp chain.  Each pass after the primary
    one is the span ``bounce``, its index the trip."""
    o3, d3 = _split_rays(rays)
    color, (ro, rd), intensity, (qo, qd), refr_int = _launch_soa(
        scene, bvh, o3, d3, cfg, tex_quads, light3, rec)
    for k in range(cfg.bounces):
        with profiling.span("bounce", intensity, k):
            color, ro, rd, intensity = _bounce_soa(
                scene, bvh, color, ro, rd, intensity, cfg, tex_quads)
    if cfg.enable_refraction:
        # the chain carries "the colour seen through the surface": it
        # starts white at intensity 1 (the spawn's transparency is applied
        # once, in the blend), and deeper transparent hits recurse with
        # their own (1 - alpha)
        chain_int = torch.where(refr_int > 0.0, torch.ones_like(refr_int),
                                0.0)
        rcolor = tuple(torch.ones_like(color[c]) for c in range(4))
        for k in range(cfg.bounces):
            with profiling.span("bounce", chain_int, cfg.bounces + k):
                rcolor, qo, qd, chain_int = _bounce_refract_soa(
                    scene, bvh, rcolor, qo, qd, chain_int, cfg, tex_quads)
        # present: blend it over the reflection result by the primary
        # transparency
        color = tuple(color[c] + refr_int * (rcolor[c] - color[c])
                      for c in range(4))
    return torch.stack(color, dim=-1)


def shade_setup(scene: Scene, bvh: BVH, cfg: RenderConfig):
    """(bvh with the walks' tables, the frame's texture quad table): what
    every pass and every ray chunk of a frame shares."""
    if resolve_backend(cfg, "traversal_backend") != "torch":
        # pack K1's tables once per build: every traversal reuses them,
        # K5/K6's too
        bvh = traverse_cuda.with_tables(bvh)
    return bvh, _frame_tex_quads(scene, cfg)


def culls_chunks(cfg: RenderConfig, nrays: int) -> bool:
    """Whether ``shade_rays`` runs ``nrays`` rays as ray chunks with empty
    chunks culled (the chunk loop visits the hit chunks alone); raises
    where ``cfg.ray_chunk`` does not divide ``nrays``."""
    chunk = cfg.ray_chunk
    if not (chunk > 0 and nrays > chunk):
        return False
    if nrays % chunk:
        raise ValueError(f"ray_chunk {chunk} must divide ray count {nrays}")
    return cfg.cull_empty_chunks


def chunk_rays(rays: Rays, i: int, chunk: int) -> Rays:
    """The ``i``-th ray chunk of ``chunk`` rays."""
    s = i * chunk
    return Rays(rays.origin[s:s + chunk], rays.direction[s:s + chunk])


def trace_chunks(bvh: BVH, rays: Rays, cfg: RenderConfig):
    """Every ray chunk's primary traversal -> (the chunks' hit records as
    [chunks, ray_chunk] tensors, [chunks] bool device tensor: whether any
    of the chunk's rays hits).  A kernel walk's rays are independent, so
    on a kernel route one launch walks every chunk (the JAX package walks
    a chunk in its ``lax.map`` body, which on the TPU also holds the
    ``lax.cond``); the plain lock-step walk keeps a walk a chunk, which
    bounds what the chunks bound."""
    chunk = cfg.ray_chunk
    nchunks = rays.origin.shape[0] // chunk
    if _walks(bvh, cfg)[0] == "torch":
        recs = [_traverse_ids(bvh, chunk_rays(rays, i, chunk), cfg)
                for i in range(nchunks)]
        rec = HitRecord(*(torch.stack([getattr(r, f) for r in recs])
                          for f in ("hit", "distance", "leaf")))
    else:
        whole = _traverse_ids(bvh, rays, cfg)
        rec = HitRecord(*(getattr(whole, f).reshape(nchunks, chunk)
                          for f in ("hit", "distance", "leaf")))
    return rec, rec.hit.any(-1)


def chunk_order(flags: torch.Tensor, cull: bool):
    """(order, count): the chunks the loop visits, their indices on the
    device in visiting order, and the trip count.  Culled, the hit chunks
    (``flags``) first, in chunk order (a stable sort of the misses'
    flags), and their number as a 0-d int32 device tensor; else every
    chunk in order, and their number as an int.  Nothing is read on the
    host."""
    if not cull:
        return (torch.arange(flags.shape[0], device=flags.device),
                flags.shape[0])
    order = torch.sort((~flags).to(torch.uint8), stable=True).indices
    return order, flags.sum(dtype=torch.int32)


def chunk_background(cfg: RenderConfig, tex_quads, device) -> torch.Tensor:
    """[ray_chunk, 4] background of a culled chunk, in the shaded chunks'
    dtype: a float quad table promotes the colour
    (ops/shade.sample_texture_quads)."""
    dtype = cfg.torch_dtype
    if tex_quads.dtype != torch.uint8:
        dtype = torch.promote_types(dtype, tex_quads.dtype)
    return torch.stack([torch.full((cfg.ray_chunk,), b, dtype=dtype,
                                   device=device)
                        for b in cfg.background], dim=-1)


@dataclasses.dataclass
class _ChunkLoop:
    """The chunk loop of ``shade_rays``: ``shade(leaf_attrs, rays,
    tex_quads, rec)`` (one chunk's colours) over the chunks
    ``order[:count]`` (``chunk_order``), each from its record in ``recs``
    (``trace_chunks``), into an image of the background ``bg``
    ([ray_chunk, 4])."""

    shade: object
    recs: HitRecord
    order: torch.Tensor
    count: object
    bg: torch.Tensor

    def rows(self, j):
        """(chunk ``order[j]`` as a [1] index, its rays' rows) for the trip
        number ``j``, a 0-d device tensor: on the device, so that a
        captured body holds no trip's offset."""
        c = self.order.index_select(0, j.reshape(1))
        chunk = self.bg.shape[0]
        return c, c * chunk + torch.arange(chunk, device=c.device)

    def record(self, c) -> HitRecord:
        return HitRecord(*(x.index_select(0, c).reshape(-1) for x in (
            self.recs.hit, self.recs.distance, self.recs.leaf)))

    def loop(self, trip) -> None:
        """``trip(j)`` for every trip (``graphs.while_loop``): the span
        ``chunks``, whose end records the trips run, and a ``chunk`` a
        trip, which records its trip number."""
        def body(j):
            with profiling.span("chunk", self.order, j):
                trip(j)

        profiling.mark("chunks", self.order, False)
        trips = graphs.while_loop(self.count, body, self.order.device)
        profiling.mark("chunks", self.order, True, trips)

    def run(self, leaf_attrs, origin, direction, tex_quads):
        """The colours of every ray: each trip shades its chunk and writes
        it into the chunk's rows."""
        out = self.bg.repeat(self.order.shape[0], 1)

        def trip(j):
            c, rows = self.rows(j)
            rays = Rays(origin.index_select(0, rows),
                        direction.index_select(0, rows))
            out.index_copy_(0, rows, self.shade(leaf_attrs, rays, tex_quads,
                                                self.record(c)))

        self.loop(trip)
        return out

    def vjp(self, needs, grad, leaf_attrs, origin, direction, tex_quads):
        """The gradients of ``run``'s colours against ``grad`` with respect
        to the inputs ``needs`` names (None for the rest): each trip
        recomputes its chunk's shading with autograd and takes its
        vector-Jacobian product; the tables' gradients add in trip order
        (a culled chunk adds nothing), the rays' go into their rows."""
        ins = (leaf_attrs, origin, direction, tex_quads)
        out = [torch.zeros_like(x) if n else None for x, n in zip(ins, needs)]

        def trip(j):
            c, rows = self.rows(j)
            with torch.enable_grad():
                fresh = [leaf_attrs.detach(),
                         origin.detach().index_select(0, rows),
                         direction.detach().index_select(0, rows),
                         tex_quads.detach()]
                fresh = [x.requires_grad_(n) for x, n in zip(fresh, needs)]
                color = self.shade(fresh[0], Rays(fresh[1], fresh[2]),
                                   fresh[3], self.record(c))
                wrt = [x for x in fresh if x.requires_grad]
                got = iter(torch.autograd.grad(
                    color, wrt, grad.index_select(0, rows),
                    allow_unused=True))
            for k, x in enumerate(fresh):
                g = next(got) if x.requires_grad else None
                if g is None:
                    continue
                if k in (1, 2):
                    out[k].index_copy_(0, rows, g)
                else:
                    out[k].add_(g)

        self.loop(trip)
        return tuple(out)


class _ChunkMap(torch.autograd.Function):
    """``_ChunkLoop.run`` under autograd, eager and captured alike: the
    forward keeps no residual but its inputs, and the backward is a second
    loop over the same chunks (``_ChunkLoop.vjp``), so the memory the
    shading's autograd holds is one chunk's, as the JAX docstring of
    ``lax.map``'s chunks intends."""

    @staticmethod
    def forward(ctx, loop, leaf_attrs, origin, direction, tex_quads):
        ctx.loop = loop
        ctx.save_for_backward(leaf_attrs, origin, direction, tex_quads)
        return loop.run(leaf_attrs, origin, direction, tex_quads)

    @staticmethod
    def backward(ctx, grad):
        return (None,) + ctx.loop.vjp(ctx.needs_input_grad[1:], grad,
                                      *ctx.saved_tensors)


def _shade_chunk(scene: Scene, flat: BVH, cfg: RenderConfig, light3):
    """One chunk's shading as a function of its differentiable inputs (the
    leaf-attribute table, the chunk's rays, the quad table) and its
    primary hit record, on ``flat``, the detached tree: its other fields
    reach the shading only through the walks, behind their detach
    boundary."""
    def shade(leaf_attrs, rays, tex_quads, rec):
        return _shade_rays_one(scene, flat.replace(leaf_attrs=leaf_attrs),
                               rays, cfg, tex_quads, light3, rec)
    return shade


def shade_rays(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig,
               light3=None):
    """The whole per-ray pipeline, optionally in sequential chunks of
    ``cfg.ray_chunk`` rays, as the JAX package's ``lax.map`` over them:
    every chunk's primary traversal (``trace_chunks``), then one loop body
    (``graphs.while_loop``: in a CUDA graph one WHILE node) that shades a
    chunk from its record a trip.  With ``cull_empty_chunks`` the loop
    visits the hit chunks alone (``chunk_order``): a chunk whose primary
    rays all miss is pure background (its spawns carry zero intensity),
    so the image is the same, as under the JAX package's ``lax.cond``.
    Eagerly the culled loop reads its trip count on the host once; in a
    graph the device reads it.  ``light3`` (``light_in_ray_space``) is
    needed for shadows."""
    bvh, tex_quads = shade_setup(scene, bvh, cfg)
    nrays = rays.origin.shape[0]
    chunk = cfg.ray_chunk
    cull = culls_chunks(cfg, nrays)
    if not (chunk > 0 and nrays > chunk):
        return _shade_rays_one(scene, bvh, rays, cfg, tex_quads, light3)
    recs, any_hit = trace_chunks(bvh, rays, cfg)
    order, count = chunk_order(any_hit, cull)
    loop = _ChunkLoop(_shade_chunk(scene, bvh.detach(), cfg, light3), recs,
                      order, count,
                      chunk_background(cfg, tex_quads, rays.origin.device))
    return _ChunkMap.apply(loop, bvh.leaf_attrs, rays.origin, rays.direction,
                           tex_quads)


def build_transforms(camera: Camera, cfg: RenderConfig):
    """(wvp, m, mv): the camera's world-view-projection, and the point and
    normal transforms of the frame's build.  'reference' mode builds in
    WVP-transformed space (m, mv = wvp, wv); 'perspective' mode traces in
    world space (m = mv = identity)."""
    wvp, wv = camera_matrices(camera, cfg.width, cfg.height)
    if cfg.camera_mode == "reference":
        return wvp, wvp, wv
    if cfg.camera_mode == "perspective":
        eye4 = torch.eye(4, dtype=cfg.torch_dtype, device=camera.eye.device)
        return wvp, eye4, eye4
    raise ValueError(f"unknown camera_mode {cfg.camera_mode!r}")


def frame_inputs(scene: Scene, camera: Camera, cfg: RenderConfig):
    """(bvh, rays, light3) of one frame: the rebuilt LBVH, the primary
    rays in row-major order, and the light in ray space (None without
    shadows)."""
    if cfg.ray_tile > 0:
        check_tile_order(cfg.ray_tile_order)
    wvp, m, mv = build_transforms(camera, cfg)
    bvh = build_bvh(scene, m, mv, cfg)
    light3 = None
    if cfg.enable_shadows:
        light3 = light_in_ray_space(cfg, wvp, cfg.torch_dtype)
    return bvh, make_rays(camera, cfg), light3


def _tile_shape(cfg: RenderConfig, width: int, height: int):
    if cfg.ray_tile > 0:
        return structured_tile_shape(width, height, cfg.ray_tile)
    return None


def tile_frame_rays(rays: Rays, cfg: RenderConfig, width: int,
                    height: int) -> Rays:
    """A ``width`` x ``height`` block of row-major rays in
    ``cfg.ray_tile`` order (as they are when ``cfg.ray_tile`` is 0)."""
    st = _tile_shape(cfg, width, height)
    if st is not None:
        return tile_rays(rays, width, height, *st, cfg.ray_tile_order)
    if cfg.ray_tile > 0:
        perm, _ = tile_permutation(width, height, cfg.ray_tile,
                                   rays.origin.device)
        return permute_rays(rays, perm)
    return rays


def untile_frame_color(color, cfg: RenderConfig, width: int, height: int):
    """``tile_frame_rays``' inverse on the [rays, 4] colours."""
    st = _tile_shape(cfg, width, height)
    if st is not None:
        return torch.stack(
            [untile_flat(color[:, c], width, height, *st, cfg.ray_tile_order)
             for c in range(4)], dim=-1)
    if cfg.ray_tile > 0:
        _, inv = tile_permutation(width, height, cfg.ray_tile, color.device)
        return color[inv]
    return color


def shade_tiled(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig,
                light3, width: int, height: int):
    """``shade_rays`` over a ``width`` x ``height`` block of row-major
    rays, traced in ``cfg.ray_tile`` order -> [height * width, 4]
    row-major.  A ray's colour does not depend on its order, so the tile
    order changes only the memory access pattern."""
    rays = tile_frame_rays(rays, cfg, width, height)
    color = shade_rays(scene, bvh, rays, cfg, light3)
    return untile_frame_color(color, cfg, width, height)


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig):
    """One full frame -> [height, width, 4] float image: rebuild the
    LBVH, launch primary rays (with shadow rays when
    ``cfg.enable_shadows``), run ``cfg.bounces`` reflection passes (and
    refraction passes when ``cfg.enable_refraction``), present.
    ``scene`` and ``camera`` must be on the same device; the frame is
    rendered there.  The span ``frame``."""
    with profiling.span("frame", scene.verts):
        bvh, rays, light3 = frame_inputs(scene, camera, cfg)
        color = shade_tiled(scene, bvh, rays, cfg, light3, cfg.width,
                            cfg.height)
        return color.reshape(cfg.height, cfg.width, 4)


# render_frame_jit's captures, by signature (graphs.Cache)
FRAME_GRAPHS = graphs.Cache(name="frame")


def render_frame_jit(scene: Scene, camera: Camera, cfg: RenderConfig):
    """``render_frame`` compiled once a signature, the counterpart of the
    JAX package's ``render_frame_jit``: on CUDA tensors the whole frame
    (build, sort, every traversal and gather, K1-K8 as the config routes
    them, the chunk loop's WHILE node) is one CUDA graph captured at
    the first call of its signature (``graphs.signature``: cfg and the
    inputs' shapes, dtypes and device) and replayed with the caller's
    scene and camera copied in.  It returns a new image, the eager
    frame's bits.  On CPU tensors it is ``render_frame``.  It does not
    differentiate: with grad mode on, an input that requires grad
    raises.  While ``profiling.spans()`` is open the call is one call id,
    its key a spans-on graph's."""
    graphs.check_no_grad((scene, camera), "render_frame_jit")
    if scene.device.type != "cuda":
        return render_frame(scene, camera, cfg)
    with profiling.call(scene.verts):
        return FRAME_GRAPHS.call(graphs.signature(cfg, scene, camera),
                                 lambda s, c: render_frame(s, c, cfg),
                                 (scene, camera))

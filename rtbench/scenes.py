"""The benchmark's inputs, made on the device from the seed: the scene of a
configuration, the poses and camera positions of the frame loop, and the
program's types built from them.

A scene here is a plain dict of tensors (the fields of the program's
``Scene``), so that the reference reads the very inputs the program gets.
The sphere grid is the program's ``models.procedural.sphere_grid`` (the
same corners, uvs, normals and materials by sphere), made with torch on the
device; the diffuse colours come from the seed.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the stream ``what`` of run seed ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def checker_texture(size: int, square: int, device):
    """[1, size, size, 4] checkerboard in ``square``-texel squares: (c,
    1 - c, c / 2, 1)."""
    yy, xx = torch.meshgrid(torch.arange(size, device=device),
                            torch.arange(size, device=device), indexing="ij")
    c = ((xx // square + yy // square) % 2).to(torch.float32)
    return torch.stack([c, 1 - c, c * 0.5, torch.ones_like(c)], -1)[None]


def sphere_grid(nx: int, ny: int, subdiv: int, spacing: float, radius: float,
                device):
    """Corners of a grid of UV spheres, two triangles a quad, every corner
    its own vertex: (verts, normals, uv, sphere index of each vertex,
    material index of each face), with sphere (gy, gx) of material
    (gx + gy) % 3."""
    f64 = torch.float64
    i = torch.arange(subdiv, device=device, dtype=f64)[:, None, None]
    j = torch.arange(subdiv * 2, device=device, dtype=f64)[None, :, None]
    di = torch.tensor([0, 1, 1, 0], device=device, dtype=f64)[None, None, :]
    dj = torch.tensor([0, 0, 1, 1], device=device, dtype=f64)[None, None, :]
    theta = math.pi * (i + di) / subdiv
    phi = 2 * math.pi * (j + dj) / (subdiv * 2)
    theta, phi = torch.broadcast_tensors(theta, phi)
    p = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                     torch.sin(theta) * torch.sin(phi)], -1)
    uv4 = torch.stack([phi / (2 * math.pi), theta / math.pi], -1)
    tri_k = torch.tensor([0, 1, 2, 0, 2, 3], device=device)
    p6 = p[:, :, tri_k, :].reshape(-1, 3)
    uv6 = uv4[:, :, tri_k, :].reshape(-1, 2)
    cx = (torch.arange(nx, device=device, dtype=f64) - (nx - 1) / 2) * spacing
    cy = (torch.arange(ny, device=device, dtype=f64) - (ny - 1) / 2) * spacing
    gy, gx = torch.meshgrid(torch.arange(ny, device=device),
                            torch.arange(nx, device=device), indexing="ij")
    centers = torch.stack([cx[gx.reshape(-1)], cy[gy.reshape(-1)],
                           torch.zeros(nx * ny, device=device, dtype=f64)], -1)
    nsph, per = centers.shape[0], p6.shape[0]
    verts = (p6[None] * radius + centers[:, None, :]).reshape(-1, 3)
    normals = p6[None].expand(nsph, per, 3).reshape(-1, 3)
    uvs = uv6[None].expand(nsph, per, 2).reshape(-1, 2)
    sphere = torch.arange(nsph, device=device).repeat_interleave(per)
    mat_sphere = (gx + gy).reshape(-1) % 3
    mat_index = mat_sphere.repeat_interleave(per // 3).to(torch.int32)
    return (verts.float(), normals.float(), uvs.float(), sphere, mat_index)


def uv_sphere(stacks: int, slices: int, radius: float, center, device):
    """One smooth UV sphere as a modeller exports it: ``stacks`` rings of
    ``slices`` faces, a triangle fan at each pole and two triangles a quad
    between, vertices shared by the faces that meet at them (a seam column
    at u = 1 and one pole vertex a slice, for their own uvs) -> (verts,
    normals, uv, indices, sphere index of each vertex (all 0), material
    index of each face (all 0)).  2 * slices * (stacks - 1) faces on
    2 + slices * (stacks - 1) distinct positions."""
    f64 = torch.float64
    rows = stacks - 1  # rings of vertices between the poles
    i = torch.arange(1, stacks, device=device, dtype=f64)[:, None]
    j = torch.arange(slices + 1, device=device, dtype=f64)[None, :]
    theta = (math.pi * i / stacks).expand(rows, slices + 1)
    phi = (2 * math.pi * j / slices).expand(rows, slices + 1)
    ring = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                        torch.sin(theta) * torch.sin(phi)], -1).reshape(-1, 3)
    ring_uv = torch.stack([phi / (2 * math.pi), theta / math.pi],
                          -1).reshape(-1, 2)
    jp = torch.arange(slices, device=device, dtype=f64)
    pole_u = (jp + 0.5) / slices
    top = torch.tensor([0.0, 1.0, 0.0], device=device, dtype=f64)
    p = torch.cat([top.expand(slices, 3), ring, -top.expand(slices, 3)])
    uv = torch.cat([torch.stack([pole_u, torch.zeros_like(pole_u)], -1),
                    ring_uv,
                    torch.stack([pole_u, torch.ones_like(pole_u)], -1)])
    w = slices + 1
    at = lambda r, c: slices + r * w + c  # vertex of ring r, column c
    c = torch.arange(slices, device=device)
    faces = [torch.stack([c, at(0, c), at(0, c + 1)], -1)]  # top fan
    for r in range(rows - 1):
        a, b = at(r, c), at(r + 1, c)
        faces += [torch.stack([a, b, b + 1], -1),
                  torch.stack([a, b + 1, a + 1], -1)]
    bottom = slices + rows * w + c
    faces.append(torch.stack([at(rows - 1, c), bottom,
                              at(rows - 1, c + 1)], -1))  # bottom fan
    indices = torch.stack(faces, 1).reshape(-1).to(torch.int32)
    centre = torch.tensor(center, device=device, dtype=f64)
    verts = p * radius + centre
    nf = indices.numel() // 3
    return (verts.float(), p.float(), uv.float(), indices,
            torch.zeros(verts.shape[0], dtype=torch.int64, device=device),
            torch.zeros(nf, dtype=torch.int32, device=device))


def make_scene(config: dict, seed: int, device) -> dict:
    """The configuration's scene from ``seed``: a dict of the program's
    ``Scene`` fields (``materials`` a dict of the ``Materials`` fields),
    plus ``sphere`` (each vertex's sphere)."""
    sc = config["scene"]
    if sc["kind"] == "sphere_grid":
        verts, normals, uv, sphere, mat_index = sphere_grid(
            sc["nx"], sc["ny"], sc["subdiv"], sc["spacing"], sc["radius"],
            device)
        indices = torch.arange(verts.shape[0], dtype=torch.int32,
                               device=device)
    elif sc["kind"] == "uv_sphere":
        verts, normals, uv, indices, sphere, mat_index = uv_sphere(
            sc["stacks"], sc["slices"], sc["radius"], sc["center"], device)
    else:
        raise ValueError(f"unknown scene kind {sc['kind']!r}")
    nmat = sc["materials"]
    lo, hi = sc["diffuse_range"]
    gen = generator(seed, "materials", device)
    diffuse = torch.empty((nmat, 4), device=device).uniform_(lo, hi,
                                                            generator=gen)
    diffuse[:, 3] = 1.0
    full = lambda v: torch.full((nmat,), v, device=device)
    tex = sc["texture"]
    materials = dict(
        ambient=torch.tensor([sc["ambient"]] * 3 + [1.0],
                             device=device).repeat(nmat, 1),
        diffuse=diffuse,
        specular=torch.ones((nmat, 4), device=device),
        shininess=full(sc["shininess"]),
        optical_density=full(0.0),
        alpha=full(1.0),
        tex_id=torch.zeros(nmat, dtype=torch.int32, device=device),
    )
    return dict(
        verts=verts, normals=normals, uv=uv, indices=indices,
        mat_index=mat_index, materials=materials,
        textures=checker_texture(tex["size"], tex["square"], device),
        tex_hw=torch.tensor([[tex["size"], tex["size"]]], dtype=torch.int32,
                            device=device),
        sphere=sphere)


def camera(config: dict, device) -> dict:
    cam = config["camera"]
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return dict(eye=t(cam["eye"]), at=t(cam["at"]), up=t(cam["up"]),
                fov=t(cam["fov"]), near=t(cam["near"]), far=t(cam["far"]))


def orbit_eyes(cam: dict, yaw: float, count: int):
    """[count, 3] eye positions of frames 0 .. count - 1 of an orbit about
    ``at`` by ``yaw`` radians a frame (a row-vector rotation about y, as
    the render CLI's orbit), each worked out from the first in float64."""
    a = torch.arange(count, device=cam["eye"].device,
                     dtype=torch.float64) * yaw
    rel = (cam["eye"] - cam["at"]).double()
    c, s = torch.cos(a), torch.sin(a)
    eyes = torch.stack([rel[0] * c + rel[2] * s,
                        rel[1].expand_as(a),
                        -rel[0] * s + rel[2] * c], -1)
    return (eyes + cam["at"].double()).float()


def pose_ring(scene: dict, count: int, jitter: float, seed: int):
    """[count, nv, 3] vertex buffers: in each, every sphere moved rigidly
    from its rest position by a seeded offset drawn uniformly from the
    ball of radius ``jitter``."""
    dev = scene["verts"].device
    nsph = int(scene["sphere"].max()) + 1
    gen = generator(seed, "poses", dev)
    d = torch.randn((count, nsph, 3), device=dev, generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    r = torch.rand((count, nsph, 1), device=dev, generator=gen) ** (1 / 3)
    offsets = d * r * jitter
    return scene["verts"][None] + offsets[:, scene["sphere"]]


def perturbed(scene: dict, spec: dict, seed: int):
    """The target's parameters: every sphere moved rigidly by a seeded
    normal offset of ``offset_sigma`` a coordinate, and each material's
    diffuse colour (rgb) scaled by a seeded factor in ``color_scale``."""
    dev = scene["verts"].device
    gen = generator(seed, "target", dev)
    nsph = int(scene["sphere"].max()) + 1
    shift = torch.randn((nsph, 3), device=dev, generator=gen)
    offsets = (shift * spec["offset_sigma"])[scene["sphere"]]
    lo, hi = spec["color_scale"]
    diffuse = scene["materials"]["diffuse"].clone()
    k = torch.empty((diffuse.shape[0], 3), device=dev).uniform_(
        lo, hi, generator=gen)
    diffuse[:, :3] = torch.clamp(diffuse[:, :3] * k, 0.0, 1.0)
    return dict(vert_offsets=offsets, diffuse=diffuse,
                specular=scene["materials"]["specular"].clone())


def port_scene(scene: dict, verts=None):
    """The program's ``Scene`` of ``scene`` (its tensors, not copies)."""
    from raytracebvh_tpu_torch.core.types import Materials, Scene

    return Scene(verts=scene["verts"] if verts is None else verts,
                 normals=scene["normals"], uv=scene["uv"],
                 indices=scene["indices"], mat_index=scene["mat_index"],
                 materials=Materials(**scene["materials"]),
                 textures=scene["textures"], tex_hw=scene["tex_hw"])


def port_camera(cam: dict, eye=None):
    from raytracebvh_tpu_torch.core.types import Camera

    return Camera(**{**cam, **({} if eye is None else {"eye": eye})})

"""Scenes of Eric Haines' Standard Procedural Databases (SPD: "A Proposal
for Standard Graphics Environments", IEEE CG&A 7(11), 1987;
github.com/erich666/StandardProceduralDatabases), made with torch on the
device from the seed, in the dict ``scenes.make_scene`` returns.

``tetra`` is the Sierpinski tetrahedron: one regular tetrahedron, each
level replacing every tetrahedron by the four of half its edge at its
corners, 4^SF tetrahedra at size factor SF.  Here each is four outward
triangles whose corners are their own vertices (flat face normals, uvs
(0, 0), (1, 0), (0, 1) on every face), of one material with the checker
texture of the other configurations.  The object of a vertex (the
scene's ``sphere`` field, which ``scenes.pose_ring`` moves rigidly) is its
sub-tetrahedron of level ``object_level``.
"""

from __future__ import annotations

import torch

from rtbench import scenes

# the level-0 tetrahedron's corners, in units of its radius
CORNERS = ((1.0, 1.0, 1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
           (1.0, -1.0, -1.0))


def _faces(corners):
    """[4, 3] corner indices of the tetrahedron's faces, each face
    opposite one corner and wound so that (c1 - c0) x (c2 - c0) points
    away from that corner."""
    out = []
    for far in range(4):
        a, b, c = [k for k in range(4) if k != far]
        n = torch.linalg.cross(corners[b] - corners[a],
                               corners[c] - corners[a])
        if torch.dot(n, corners[a] - corners[far]) < 0:
            b, c = c, b
        out.append([a, b, c])
    return torch.tensor(out, device=corners.device)


def sierpinski_tetra(size_factor: int, radius: float, object_level: int,
                     device):
    """The Sierpinski tetrahedron of ``size_factor`` levels about the origin,
    corners ``radius`` * ``CORNERS`` at level 0 -> (verts, normals, uv,
    object index of each vertex, material index of each face (all 0)):
    3 * 4^(SF + 1) vertices, 4^(SF + 1) faces, tetrahedron t's four faces
    at faces 4t .. 4t + 3.  Tetrahedron t's base-4 digits, most significant
    first, pick its corner at levels 0 .. SF - 1, so the 4^L objects of
    ``object_level`` L are runs of 4^(SF - L) tetrahedra."""
    if not 0 <= object_level <= size_factor:
        raise ValueError(f"object_level {object_level} outside "
                         f"[0, {size_factor}]")
    f64 = torch.float64
    base = torch.tensor(CORNERS, dtype=f64, device=device) * radius
    origin = torch.zeros((1, 3), dtype=f64, device=device)
    for level in range(size_factor):
        step = base * 2.0 ** -(level + 1)
        origin = (origin[:, None, :] + step[None]).reshape(-1, 3)
    small = base * 2.0 ** -size_factor  # [4, 3]
    faces = _faces(base)
    tri = small[faces]  # [4 faces, 3 corners, 3]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    count = origin.shape[0]
    verts = (origin[:, None, None, :] + tri[None]).reshape(-1, 3)
    normals = n[None, :, None, :].expand(count, 4, 3, 3).reshape(-1, 3)
    uv = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], device=device)
    uvs = uv.repeat(4 * count, 1)
    per = 4 ** (size_factor - object_level)
    obj = (torch.arange(count, device=device) // per).repeat_interleave(12)
    mat_index = torch.zeros(4 * count, dtype=torch.int32, device=device)
    return verts.float(), normals.float(), uvs, obj, mat_index


def make_scene(config: dict, seed: int, device) -> dict:
    """The configuration's SPD scene from ``seed``, in the dict of
    ``scenes.make_scene`` (its materials and texture made as there)."""
    sc = config["scene"]
    if sc["kind"] != "sierpinski_tetra":
        raise ValueError(f"unknown SPD scene kind {sc['kind']!r}")
    verts, normals, uv, obj, mat_index = sierpinski_tetra(
        sc["size_factor"], sc["radius"], sc["object_level"], device)
    nmat = sc["materials"]
    lo, hi = sc["diffuse_range"]
    gen = scenes.generator(seed, "materials", device)
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
        verts=verts, normals=normals, uv=uv,
        indices=torch.arange(verts.shape[0], dtype=torch.int32,
                             device=device),
        mat_index=mat_index, materials=materials,
        textures=scenes.checker_texture(tex["size"], tex["square"], device),
        tex_hw=torch.tensor([[tex["size"], tex["size"]]], dtype=torch.int32,
                            device=device),
        sphere=obj)

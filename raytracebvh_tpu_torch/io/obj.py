"""Wavefront OBJ + MTL loader.

Same capabilities as the reference's ObjLoader (reference:
ObjectFileLoader.cpp:212-468 ``Load_Geometry``, :77-210 ``Material_File``):
triangulated ``f v/t/n`` faces, per-face material indices, MTL fields
Ka/Kd/Ks/Ns/Ni/d/Tr/map_Kd, vertex deduplication, and the same default
material (Base_Mat, ObjectFileLoader.cpp:66-75).

Differences (deliberate):
  * Dedup is by the full (position, normal, uv) triple.  The reference
    dedups by position and then compares normal/uv with an operator== whose
    z-compare is a typo (``a.z == a.z``, Helper.h:13,18) — we do not
    replicate the bug (SURVEY.md Q8).
  * The v texture coordinate is flipped (1 - v) on import so sampling uses
    DirectX top-left texture space (see ops/shade.py).
  * Parsed by the native loader (``native.py``) or in pure Python into
    numpy arrays; the Scene's tensors are made on the device asked for,
    the CUDA device by default.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..core.types import Scene, scene_from_numpy, stack_textures
from .image import load_texture


class _Material:
    def __init__(self, name: str):
        # Base_Mat defaults (reference: ObjectFileLoader.cpp:66-75)
        self.name = name
        self.ambient = np.array([0.2, 0.2, 0.2, 1.0], np.float32)
        self.diffuse = np.array([0.8, 0.8, 0.8, 1.0], np.float32)
        self.specular = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self.shininess = 0.0
        self.optical_density = 0.0
        self.alpha = 1.0
        self.texture_path: Optional[str] = None


def _parse_mtl(path: str, materials: List[_Material]) -> None:
    if not os.path.isfile(path):
        # reference prints and continues (ObjectFileLoader.cpp:208)
        print(f"warning: cannot find material file {path}")
        return
    cur: Optional[_Material] = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.strip().split(None, 1)
            if not tok:
                continue
            key = tok[0]
            rest = tok[1] if len(tok) > 1 else ""
            if key == "newmtl":
                cur = _Material(rest.strip())
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Ka":
                cur.ambient[:3] = [float(x) for x in rest.split()[:3]]
            elif key == "Kd":
                cur.diffuse[:3] = [float(x) for x in rest.split()[:3]]
            elif key == "Ks":
                cur.specular[:3] = [float(x) for x in rest.split()[:3]]
            elif key == "Ns":
                cur.shininess = float(rest.split()[0])
            elif key == "Ni":
                cur.optical_density = float(rest.split()[0])
            elif key in ("d", "Tr"):
                cur.alpha = float(rest.split()[0])
            elif key == "map_Kd":
                cur.texture_path = os.path.join(os.path.dirname(path), rest.strip())


def _parse_face_vertex(s: str):
    """'v/t/n' -> (v, t, n) 1-based ints; the reference requires all three
    (sscanf %i/%i/%i, ObjectFileLoader.cpp:341-351)."""
    parts = s.split("/")
    v = int(parts[0])
    t = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return v, t, n


def _resolve_index(i: int, count: int, what: str, path: str) -> int:
    """1-based OBJ index -> 0-based, supporting the spec's negative
    (relative) indices; raises on out-of-range instead of silently
    wrapping (Python list negative indexing would)."""
    j = i - 1 if i > 0 else count + i
    if not 0 <= j < count:
        raise ValueError(
            f"{path}: {what} index {i} out of range (have {count})"
        )
    return j


def load_obj(path: str, load_textures: bool = True, backend: str = "auto",
             device="cuda") -> Scene:
    """Parse an OBJ file into the port's Scene on ``device`` (the CUDA
    device unless the caller asks for another; without a card the default
    raises).

    backend: 'auto' uses the native C++ loader (``native.py`` over
    native/rtbvh_native.cpp) when its library builds, else the
    pure-Python parser; 'native' requires it; 'python' forces the parser.
    Both give the same bits on a file both take, as in the JAX package
    (``io/obj.py``).  The native parser refuses some files the Python one
    takes (relative, negative face indices): where it raises, 'auto'
    parses the file in Python, which reads it or raises its own error.
    """
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend {backend!r}; expected auto, "
                         "native or python")
    arrays = None
    if backend in ("auto", "native"):
        from .. import native

        try:
            arrays = native.load_obj_native(path, load_textures)
        except OSError:
            if backend == "native":
                raise
        if arrays is None and backend == "native":
            raise RuntimeError("native loader unavailable (g++ missing?)")
    if arrays is None:
        arrays = _load_obj_python(path, load_textures)
    return scene_from_numpy(arrays, device=device)


def _load_obj_python(path: str, load_textures: bool = True) -> dict:
    """The pure-Python parser: the scene as a dict of numpy arrays."""
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    uvs: List[List[float]] = []
    materials: List[_Material] = []
    face_mat: List[int] = []
    indices: List[int] = []

    dedup: Dict[tuple, int] = {}
    out_pos: List[List[float]] = []
    out_nrm: List[List[float]] = []
    out_uv: List[List[float]] = []

    cur_mat = 0
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.strip().split()
            if not tok:
                continue
            key = tok[0]
            if key == "mtllib":
                _parse_mtl(
                    os.path.join(os.path.dirname(path), " ".join(tok[1:])),
                    materials,
                )
            elif key == "v":
                positions.append([float(x) for x in tok[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in tok[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in tok[1:3]])
            elif key == "usemtl":
                name = " ".join(tok[1:])
                for i, m in enumerate(materials):
                    if m.name == name:
                        cur_mat = i
                        break
            elif key == "f":
                corners = tok[1:]
                if len(corners) != 3:
                    # reference only supports triangulated meshes
                    # (ObjectFileLoader.cpp:341 parses exactly 3 corners)
                    raise ValueError(
                        f"{path}: non-triangle face with {len(corners)} verts"
                    )
                for c in corners:
                    vi, ti, ni = _parse_face_vertex(c)
                    pos = tuple(
                        positions[_resolve_index(vi, len(positions), "vertex", path)]
                    )
                    nrm = (
                        tuple(normals[_resolve_index(ni, len(normals), "normal", path)])
                        if ni
                        else (0.0, 0.0, 0.0)
                    )
                    # flip v into DirectX texture space
                    if ti:
                        tuvi = uvs[_resolve_index(ti, len(uvs), "uv", path)]
                        uv = (tuvi[0], 1.0 - tuvi[1])
                    else:
                        uv = (0.0, 0.0)
                    k = (pos, nrm, uv)
                    idx = dedup.get(k)
                    if idx is None:
                        idx = len(out_pos)
                        dedup[k] = idx
                        out_pos.append(list(pos))
                        out_nrm.append(list(nrm))
                        out_uv.append(list(uv))
                    indices.append(idx)
                face_mat.append(cur_mat)

    if not indices:
        raise ValueError(f"{path}: no faces (empty or non-mesh OBJ)")
    verts_arr = np.asarray(out_pos, np.float32)
    if not np.isfinite(verts_arr).all():
        bad = int((~np.isfinite(verts_arr)).any(axis=-1).sum())
        raise ValueError(f"{path}: {bad} vertices with non-finite coordinates")

    if not materials:
        materials.append(_Material("Base_Mat"))

    textures: List[np.ndarray] = []
    tex_ids = []
    for m in materials:
        if load_textures and m.texture_path and os.path.isfile(m.texture_path):
            tex_ids.append(len(textures))
            textures.append(load_texture(m.texture_path))
        else:
            if load_textures and m.texture_path:
                print(f"warning: cannot load texture {m.texture_path}")
            tex_ids.append(-1)

    tex_stack, tex_hw = stack_textures(textures)
    mats = dict(
        ambient=np.stack([m.ambient for m in materials]),
        diffuse=np.stack([m.diffuse for m in materials]),
        specular=np.stack([m.specular for m in materials]),
        shininess=np.array([m.shininess for m in materials], np.float32),
        optical_density=np.array(
            [m.optical_density for m in materials], np.float32
        ),
        alpha=np.array([m.alpha for m in materials], np.float32),
        tex_id=np.array(tex_ids, np.int32),
    )
    return dict(
        verts=verts_arr,
        normals=np.asarray(out_nrm, np.float32),
        uv=np.asarray(out_uv, np.float32),
        indices=np.asarray(indices, np.int32),
        mat_index=np.asarray(face_mat, np.int32),
        materials=mats,
        textures=tex_stack,
        tex_hw=tex_hw,
    )


def write_obj(scene: Scene, directory: str, name: str = "scene") -> str:
    """Write ``scene`` as ``{name}.obj`` + ``{name}.mtl`` (+ ``{name}.bmp``,
    texture 0, where a material is textured) into ``directory``; returns
    the OBJ's path.  One MTL material a scene material, each with texture
    0 where the scene has one; every vertex carries its own v/vt/vn, so
    ``load_obj`` reads the scene's vertices back as they are."""
    from .bmp import write_bmp

    verts = scene.verts.cpu().numpy()
    normals = scene.normals.cpu().numpy()
    uv = scene.uv.cpu().numpy()
    faces = scene.indices.cpu().numpy().reshape(-1, 3) + 1
    mat = scene.mat_index.cpu().numpy()
    m = scene.materials
    textured = bool((m.tex_id >= 0).any())
    if textured:
        h, w = scene.tex_hw[0].tolist()
        write_bmp(os.path.join(directory, f"{name}.bmp"),
                  scene.textures[0, :h, :w, :3].cpu().numpy())
    with open(os.path.join(directory, f"{name}.mtl"), "w") as f:
        for k in range(m.count):
            f.write(f"newmtl m{k}\n")
            for key, arr in (("Ka", m.ambient), ("Kd", m.diffuse),
                             ("Ks", m.specular)):
                f.write(f"{key} " + " ".join(
                    repr(float(x)) for x in arr[k, :3]) + "\n")
            f.write(f"Ns {float(m.shininess[k])!r}\n"
                    f"Ni {float(m.optical_density[k])!r}\n"
                    f"d {float(m.alpha[k])!r}\n")
            if textured:
                f.write(f"map_Kd {name}.bmp\n")
    lines = [f"mtllib {name}.mtl"]
    lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in verts.tolist()]
    lines += [f"vt {u!r} {1.0 - v!r}" for u, v in uv.tolist()]
    lines += [f"vn {x!r} {y!r} {z!r}" for x, y, z in normals.tolist()]
    cur = None
    for f_, k in zip(faces.tolist(), mat.tolist()):
        if k != cur:
            lines.append(f"usemtl m{k}")
            cur = k
        lines.append("f " + " ".join(f"{i}/{i}/{i}" for i in f_))
    path = os.path.join(directory, f"{name}.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path

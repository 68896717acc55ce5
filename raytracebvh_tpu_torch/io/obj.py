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
  * Pure numpy; ``Scene.to(device)`` uploads the result.
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


def load_obj(path: str, load_textures: bool = True) -> Scene:
    """Parse an OBJ file into the port's host Scene (CPU tensors); the
    pure-Python parser of the JAX package (``io/obj.py:_load_obj_python``),
    which its native loader matches bit for bit."""
    return _load_obj_python(path, load_textures)


def _load_obj_python(path: str, load_textures: bool = True) -> Scene:
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
    return scene_from_numpy(dict(
        verts=verts_arr,
        normals=np.asarray(out_nrm, np.float32),
        uv=np.asarray(out_uv, np.float32),
        indices=np.asarray(indices, np.int32),
        mat_index=np.asarray(face_mat, np.int32),
        materials=mats,
        textures=tex_stack,
        tex_hw=tex_hw,
    ))

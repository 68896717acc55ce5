"""ctypes bindings for the native asset-IO runtime (``native/rtbvh_native.cpp``
at the root of the checkout), as the JAX package's ``native.py`` binds it.

The port builds its own copy of the library with ``g++`` at first use,
into ``build/raytracebvh_tpu_torch/`` (beside the CUDA kernels' library,
``_kernels.py``), named by a hash of the source and the flags, so an edit
rebuilds and a rerun reuses; it never writes into ``native/``.  It binds
the OBJ loader, whose pure-Python counterpart (``io/obj.py``) gives the
same bits: ``get_lib`` returns None where the source or ``g++`` is
missing or the build fails.  BMPs are written in numpy only
(``io/bmp.py``).  This is host file I/O only; no device path goes
through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ._kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "rtbvh_native.cpp"
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-fvisibility=hidden", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librtbvh_native_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library for this source, compiled unless it exists; None when
    the source or g++ is missing or the build fails."""
    if not SOURCE.is_file():
        return None
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent build never loads half
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.rtbvh_last_error.restype = c.c_char_p
    lib.rtbvh_last_error.argtypes = []
    lib.rtbvh_obj_load.restype = c.c_void_p
    lib.rtbvh_obj_load.argtypes = [c.c_char_p]
    lib.rtbvh_obj_free.restype = None
    lib.rtbvh_obj_free.argtypes = [c.c_void_p]
    for name in ("num_verts", "num_indices", "num_faces", "num_materials"):
        fn = getattr(lib, f"rtbvh_obj_{name}")
        fn.restype = c.c_int32
        fn.argtypes = [c.c_void_p]
    for name in ("positions", "normals", "uv", "materials"):
        fn = getattr(lib, f"rtbvh_obj_{name}")
        fn.restype = c.POINTER(c.c_float)
        fn.argtypes = [c.c_void_p]
    for name in ("indices", "mat_index"):
        fn = getattr(lib, f"rtbvh_obj_{name}")
        fn.restype = c.POINTER(c.c_int32)
        fn.argtypes = [c.c_void_p]
    for name in ("material_name", "texture_path"):
        fn = getattr(lib, f"rtbvh_obj_{name}")
        fn.restype = c.c_char_p
        fn.argtypes = [c.c_void_p, c.c_int32]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first call; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build()
        try:
            _lib = _bind(ctypes.CDLL(str(path))) if path else None
        except OSError:
            _lib = None
        _lib_failed = _lib is None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _copy(ptr, n, dtype):
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def load_obj_native(path: str, load_textures: bool = True) -> Optional[dict]:
    """Native OBJ+MTL load -> the scene as a dict of numpy arrays (the
    form ``core.types.scene_from_numpy`` takes).  Raises on parse errors;
    returns None only if the native library is unavailable (the caller
    falls back to the Python parser)."""
    lib = get_lib()
    if lib is None:
        return None
    from .core.types import stack_textures
    from .io.image import load_texture

    h = lib.rtbvh_obj_load(path.encode())
    if not h:
        raise IOError(lib.rtbvh_last_error().decode())
    try:
        nv = lib.rtbvh_obj_num_verts(h)
        ni = lib.rtbvh_obj_num_indices(h)
        nf = lib.rtbvh_obj_num_faces(h)
        nm = lib.rtbvh_obj_num_materials(h)
        verts = _copy(lib.rtbvh_obj_positions(h), nv * 3, np.float32).reshape(nv, 3)
        normals = _copy(lib.rtbvh_obj_normals(h), nv * 3, np.float32).reshape(nv, 3)
        uv = _copy(lib.rtbvh_obj_uv(h), nv * 2, np.float32).reshape(nv, 2)
        indices = _copy(lib.rtbvh_obj_indices(h), ni, np.int32)
        mat_index = _copy(lib.rtbvh_obj_mat_index(h), nf, np.int32)
        flat = _copy(lib.rtbvh_obj_materials(h), nm * 15, np.float32).reshape(nm, 15)
        tex_paths = [
            lib.rtbvh_obj_texture_path(h, i).decode() for i in range(nm)
        ]
    finally:
        lib.rtbvh_obj_free(h)

    textures, tex_ids = [], []
    for p in tex_paths:
        if load_textures and p and os.path.isfile(p):
            tex_ids.append(len(textures))
            textures.append(load_texture(p))
        else:
            if load_textures and p:
                print(f"warning: cannot load texture {p}")
            tex_ids.append(-1)
    tex_stack, tex_hw = stack_textures(textures)
    mats = dict(
        ambient=flat[:, 0:4].copy(),
        diffuse=flat[:, 4:8].copy(),
        specular=flat[:, 8:12].copy(),
        shininess=flat[:, 12].copy(),
        optical_density=flat[:, 13].copy(),
        alpha=flat[:, 14].copy(),
        tex_id=np.array(tex_ids, np.int32),
    )
    return dict(
        verts=verts, normals=normals, uv=uv, indices=indices,
        mat_index=mat_index, materials=mats,
        textures=tex_stack, tex_hw=tex_hw,
    )


"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``csrc/`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, under
``build/raytracebvh_tpu_torch/`` at the root of the checkout, named by a
hash of the sources, the headers they include (``csrc/*.cuh``) and the
flags (so an edit rebuilds and a rerun reuses).
``ctypes`` loads it; every pointer and the stream are passed as
``c_void_p``.  Nothing here runs at import time, and nothing links
against PyTorch (a source that includes PyTorch's headers takes minutes
to build; these take seconds).

``-fmad=false`` keeps ``a*b + c`` as two roundings, as PyTorch's
elementwise ops compute it: contracted FMAs in the Moeller-Trumbore cross
products flip hits at triangle edges.  Division and square root stay
IEEE (``-prec-div=true -prec-sqrt=true``; no ``--use_fast_math``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "raytracebvh_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: argument types (every one returns a cudaError_t as int)
_SIGNATURES = {
    # origin, direction, nodes, leaves, nrays, n_leaves, eps, max_steps,
    # hit, dist, leaf, steps (nullable), truncated, stream
    "rtbvh_traverse": [_P, _P, _P, _P, _I, _I, _F, _I,
                       _P, _P, _P, _P, _P, _P],
    # origin, direction, max_t, nodes, leaves, nrays, n_leaves, eps,
    # max_steps, occluded, steps (nullable), truncated, stream
    "rtbvh_traverse_any": [_P, _P, _P, _P, _P, _I, _I, _F, _I,
                           _P, _P, _P, _P],
    # K5 and K6: K1's and K4's arguments, then first staged node, grid,
    # work counter, before the stream
    "rtbvh_traverse_shared": [_P, _P, _P, _P, _I, _I, _F, _I,
                              _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "rtbvh_traverse_any_shared": [_P, _P, _P, _P, _P, _I, _I, _F, _I,
                                  _P, _P, _P, _I, _I, _P, _P],
    # device, bytes (int32 out)
    "rtbvh_shared_mem_per_block": [_I, _P],
    # table, rows, channels, idx, nrays, out, stream
    "rtbvh_gather_f32": [_P, _I, _I, _P, _I, _P, _P],
    "rtbvh_gather_u8": [_P, _I, _I, _P, _I, _P, _P],
    # g, idx, nrays, rows, channels, scratch, scratch bytes, out, stream
    "rtbvh_scatter_add_f32": [_P, _P, _I, _I, _I, _P, _L, _P, _P],
    # rays a block, rows a block keeps partials of (int32 outs)
    "rtbvh_scatter_blocking": [_P, _P],
    # table, channels, width, idx, nrays, out, stream
    "rtbvh_gather_cols_f32": [_P, _I, _I, _P, _I, _P, _P],
    # codes, n, sorted, order, scratch (nullable), stream
    "rtbvh_sort_by_code": [_P, _I, _P, _P, _P, _P],
    # count (int32), trip counter (int32), capturing stream, body stream,
    # the node's handle (out)
    "rtbvh_while_begin": [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_ulonglong)],
    # the node's handle, count, trip counter, body stream
    "rtbvh_while_end": [ctypes.c_ulonglong, _P, _P, _P],
    # the new stream (out)
    "rtbvh_stream_create": [ctypes.POINTER(_P)],
    # record buffer, span code, trip counter (int32, nullable), index,
    # stream
    "rtbvh_mark": [_P, _I, _P, _I, _P],
    # record buffer, call id, stream
    "rtbvh_mark_call": [_P, _L, _P],
    # leaf block, origin x y z + stride, direction x y z + stride, hit,
    # tex_hw, textures, hmax, wmax, nrays, pos, normal, quad row, fractions,
    # stream
    "rtbvh_shade_surface": [_P, _P, _P, _P, _L, _P, _P, _P, _L, _P, _P, _I,
                            _I, _I, _I, _P, _P, _P, _P, _P],
    # kind, leaf block, quad block, pos, normal, fractions, origin x y z +
    # stride, direction x y z + stride, hit, vis (nullable), colour 4 and
    # intensity (nullable), nrays, background 4, reflection and refraction
    # decay, ray offset, intensity_min, colour, origin, direction,
    # intensity, refraction origin, direction, intensity (nullable), stream
    "rtbvh_shade_finish": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _P,
                           _P, _L, _P, _P, _P, _P, _P, _P, _P, _I,
                           _F, _F, _F, _F, _F, _F, _F, _F,
                           _P, _P, _P, _P, _P, _P, _P, _P],
    # prim, indices, verts, normals, uv, mat_index, ambient, diffuse,
    # specular, shininess, optical density, alpha, tex_id, bbmin, bbmax,
    # entry, skip, n, leaf_attrs, tri_mat, node table, leaf table, stream
    "rtbvh_leaf_pack": [_P] * 17 + [_I] + [_P] * 5,
}

_lib = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from raytracebvh_tpu_torch/csrc at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources() + headers():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librtbvh_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    ``nvcc -c`` per source, all started together, then one link.  nvcc's
    output (with ptxas' register and spill report) is kept beside the
    library as ``<library>.log``.  Raises with nvcc's stderr on failure."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    nvcc = nvcc_path()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
    try:
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed with exit code {proc.returncode}:\n"
                f"{' '.join(link)}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        # nrays, rows, channels -> K3's scratch bytes
        lib.rtbvh_scatter_scratch_bytes.argtypes = [_I, _I, _I]
        lib.rtbvh_scatter_scratch_bytes.restype = _L
        lib.rtbvh_error_string.argtypes = [ctypes.c_int]
        lib.rtbvh_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().rtbvh_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

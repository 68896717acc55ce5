"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``csrc/`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, under
``build/raytracebvh_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags (so an edit rebuilds and a rerun reuses).
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types (every one returns a cudaError_t as int)
_SIGNATURES = {
    # origin, direction, nodes, leaves, nrays, n_leaves, eps, max_steps,
    # hit, dist, leaf, steps (nullable), truncated, stream
    "rtbvh_traverse": [_P, _P, _P, _P, _I, _I, _F, _I,
                       _P, _P, _P, _P, _P, _P],
    # table, rows, channels, idx, nrays, out, stream
    "rtbvh_gather_f32": [_P, _I, _I, _P, _I, _P, _P],
    "rtbvh_gather_u8": [_P, _I, _I, _P, _I, _P, _P],
}

_lib = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


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
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librtbvh_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists;
    nvcc's output (with ptxas' register and spill report) is kept beside
    it as ``<library>.log``.  Raises with nvcc's stderr on failure."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
        lib.rtbvh_error_string.argtypes = [ctypes.c_int]
        lib.rtbvh_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().rtbvh_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

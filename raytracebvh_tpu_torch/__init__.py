"""raytracebvh_tpu_torch: the PyTorch + CUDA port of raytracebvh_tpu.

A second package beside the JAX one, with the same module names: the
per-frame LBVH build (30-bit morton codes, stable sort, Karras emit,
AABB fit, skip links), stackless nearest-hit traversal with
Moeller-Trumbore intersection, and textured shading with reflection
bounces.  On an NVIDIA Hopper GPU the traversal (K1) and the shading row
gathers (K2) run as hand-written CUDA kernels (``csrc/``, built with
nvcc at first use); on the CPU every step is plain PyTorch.  It imports
neither JAX nor the JAX package.
"""

from .config import RenderConfig
from .core.types import BVH, Camera, HitRecord, Materials, Rays, Scene
from .pipeline import build_bvh, render_frame

__all__ = [
    "RenderConfig",
    "BVH",
    "Camera",
    "HitRecord",
    "Materials",
    "Rays",
    "Scene",
    "build_bvh",
    "render_frame",
]

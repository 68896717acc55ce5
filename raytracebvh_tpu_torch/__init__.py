"""raytracebvh_tpu_torch: the PyTorch + CUDA port of raytracebvh_tpu.

A second package beside the JAX one, with the same module names: the
per-frame LBVH build (30-bit morton codes, stable sort, Karras emit,
AABB fit, skip links), stackless nearest-hit and any-hit traversal with
Moeller-Trumbore intersection, textured shading with reflection bounces,
shadow rays and refraction, and the inverse-rendering training step.  On
an NVIDIA Hopper GPU every TPU kernel of the JAX package runs as a
hand-written CUDA kernel (``csrc/``, built with nvcc at first use):

  K1/K4  nearest-hit / any-hit traversal (``ops/traverse_cuda``)
  K2     row gather of leaf attributes and texture quads (``ops/gather_cuda``)
  K3     K2's and K7's backward, a deterministic scatter-add
  K5/K6  K1/K4 with the tree in shared memory (``ops/traverse_shared_cuda``):
         ``traversal_backend`` ``shared``, and ``auto`` where the tree fits
  K7     column gather from the channel-major leaf table
         (``ops/gather_cols_cuda``): ``shade_gather_backend='shared'``
  K8     bitonic sort of the build's codes (``ops/sort_cuda``):
         ``sort_backend`` ``bitonic``, and ``auto`` on CUDA tensors

``render_frame_jit`` (and ``models.inverse.train_step_jit``) replay the
frame (and the training step) as CUDA graphs on the card, where the JAX
package runs ``jax.jit``-compiled programs (``graphs``).

On the CPU every step is plain PyTorch (``pytest tests/ -k torch``); on
the GPU ``python3 chip_smoke.py`` and ``pytest --noconftest -m gpu
tests/test_torch_cuda.py`` hold each kernel to its plain version.  It
imports neither JAX nor the JAX package.
"""

from .config import RenderConfig
from .core.types import BVH, Camera, HitRecord, Materials, Rays, Scene
from .pipeline import build_bvh, render_frame, render_frame_jit

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
    "render_frame_jit",
]

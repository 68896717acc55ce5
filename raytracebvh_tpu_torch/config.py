"""Render / build configuration.

The same frozen dataclass as the JAX package's ``raytracebvh_tpu.config``:
same fields, same defaults.  What differs is the set of backend strings.
``traversal_backend``, ``shade_gather_backend`` and
``texture_gather_backend`` take ``auto | torch | cuda``: ``torch`` is the
plain PyTorch version on any device; ``cuda`` and ``auto`` are the
hand-written kernel's wrapper, which launches the kernel on CUDA tensors
and runs the plain version on CPU tensors (so ``auto`` is the kernel on
CUDA and plain PyTorch on the CPU).  Every other string raises, the TPU
ones (``jnp``, ``pallas``, ``hbm``, ``sweep``, ``windowed``, ``xla``)
included.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

BACKENDS = ("auto", "torch", "cuda")
SORT_BACKENDS = ("lax",)  # alias of torch.sort(stable=True)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs of the renderer (field docs: the JAX package's
    ``RenderConfig``; only the backend fields differ, see module doc).

    ``max_traversal_steps`` is a per-ray cap (0 = 4 * n_leaves, an upper
    bound on a skip-link walk).  The CUDA traversal counts the rays that
    reach it (``ops.traverse_cuda.truncated_rays``).
    """

    width: int = 800
    height: int = 800
    bounces: int = 3
    enable_refraction: bool = False
    enable_shadows: bool = False
    light_pos: Tuple[float, float, float] = (0.0, 60.0, -60.0)
    shadow_factor: float = 0.35
    epsilon: float = 0.01
    ray_offset: float = 0.001
    bounce_ray_offset: float = 0.0001
    reflection_decay: float = 1.0
    refraction_decay: float = 1.0
    intensity_min: float = 0.0
    background: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)
    leaf_pad_multiple: int = 256
    ortho_scale: float = 4.0
    camera_mode: str = "reference"
    traversal_backend: str = "auto"
    sort_backend: str = "lax"
    shade_gather_backend: str = "auto"
    texture_gather_backend: str = "auto"
    texture_dtype: str = "float32"
    max_traversal_steps: int = 0
    ray_tile: int = 0
    ray_tile_order: str = "row"
    traversal_chunk: int = 0
    ray_chunk: int = 0
    cull_empty_chunks: bool = True
    dtype: str = "float32"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def resolve_backend(cfg: RenderConfig, field: str) -> str:
    """'torch' (the plain version) or 'cuda' (the kernel's wrapper, which
    alone looks at the tensors' device) for the backend field ``field`` of
    ``cfg``; raises on any other string."""
    value = getattr(cfg, field)
    if value not in BACKENDS:
        raise ValueError(
            f"unknown {field} {value!r}; expected one of {BACKENDS}"
        )
    return "torch" if value == "torch" else "cuda"

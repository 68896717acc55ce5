"""Render / build configuration.

The same frozen dataclass as the JAX package's ``raytracebvh_tpu.config``:
same fields, same defaults.  What differs is the set of backend strings.
``traversal_backend``, ``shade_gather_backend`` and
``texture_gather_backend`` take ``auto | torch | cuda``, and the first two
also ``shared``: ``torch`` is the plain PyTorch version on any device;
``cuda`` is the hand-written kernel's wrapper (K1/K4, K2), which launches
the kernel on CUDA tensors and runs the plain version on CPU tensors;
``shared`` is the on-chip kernels' wrapper (the traversal K5/K6 with the
tree in shared memory, the channel-major gather K7), the port's name for
the JAX package's ``pallas``.  ``auto`` is the JAX package's ``auto`` on
a TPU: the traversal takes ``shared`` where the tree fits a block's
shared memory and ``cuda`` above (``pipeline.resolve_traversal_backend``),
the gathers take ``cuda``.  Every other string raises, the TPU ones
(``jnp``, ``pallas``, ``hbm``, ``sweep``, ``windowed``, ``xla``)
included.

``sort_backend`` takes the JAX package's names: ``lax`` (a stable
``torch.sort``), ``radix`` (the reference's 1-bit LSD radix sort, plain
PyTorch), ``bitonic`` (kernel K8 on CUDA tensors, its plain network on CPU
tensors) and ``auto`` (``bitonic`` on CUDA tensors, ``lax`` on CPU
tensors, as the JAX ``auto`` is ``bitonic`` on a TPU and ``lax``
elsewhere).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

BACKENDS = ("auto", "torch", "cuda")
# the fields that also take the on-chip kernels, 'shared'
_SHARED_FIELDS = ("traversal_backend", "shade_gather_backend")
SORT_BACKENDS = ("lax", "radix", "bitonic", "auto")


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


def traversal_passes(cfg: RenderConfig) -> int:
    """Traversal passes of width x height rays in one frame, as the
    bench counts them: primary, each bounce, the shadow pass, and a
    refraction pass per bounce."""
    return (1 + cfg.bounces + int(cfg.enable_shadows)
            + (cfg.bounces if cfg.enable_refraction else 0))


def resolve_backend(cfg: RenderConfig, field: str) -> str:
    """'torch' (the plain version), 'cuda' (the kernel's wrapper) or
    'shared' (the on-chip kernel's wrapper) for the backend field
    ``field`` of ``cfg``; only a wrapper looks at the tensors' device.
    ``auto`` is 'shared' for the traversal, which
    ``pipeline.resolve_traversal_backend`` narrows to 'cuda' for a tree
    over the on-chip capacity, and 'cuda' for the gathers.  Raises on any
    other string."""
    value = getattr(cfg, field)
    allowed = BACKENDS + (("shared",) if field in _SHARED_FIELDS else ())
    if value not in allowed:
        raise ValueError(
            f"unknown {field} {value!r}; expected one of {allowed}"
        )
    if value == "auto":
        return "shared" if field == "traversal_backend" else "cuda"
    return value


def resolve_sort_backend(cfg: RenderConfig, device: torch.device) -> str:
    """'lax', 'radix' or 'bitonic' for ``cfg.sort_backend`` on codes that
    lie on ``device``; raises on any other string."""
    value = cfg.sort_backend
    if value not in SORT_BACKENDS:
        raise ValueError(f"unknown sort_backend {value!r}; expected one of "
                         f"{SORT_BACKENDS}")
    if value == "auto":
        return "bitonic" if device.type == "cuda" else "lax"
    return value

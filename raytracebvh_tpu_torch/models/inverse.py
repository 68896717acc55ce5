"""Inverse rendering: the training step (the JAX package's
``models/inverse.py``).

Optimizes vertex offsets and the materials' diffuse and specular colours
so that the rendered image matches a target.  The gradient is autograd's
through ``render_frame``: traversal and hit ids are discrete, and the
shading re-evaluates each hit from its leaf-attribute row, whose gather
(kernel K2 on CUDA tensors) has kernel K3 as its backward
(``ops/gather_cuda``).  ``torch.optim.Adam`` with optax's defaults takes
the place of ``optax.adam``: it updates the parameters in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..core.types import Camera, Scene
from ..pipeline import render_frame


class InverseParams(NamedTuple):
    vert_offsets: torch.Tensor  # [nv, 3]
    diffuse: torch.Tensor  # [k, 4]
    specular: torch.Tensor  # [k, 4]


def _leaf(x) -> torch.Tensor:
    return x.detach().clone().requires_grad_(True)


def init_params(scene: Scene) -> InverseParams:
    """Zero offsets and the scene's own colours, as leaf tensors that
    require grad, on the scene's device."""
    return InverseParams(
        vert_offsets=_leaf(torch.zeros_like(scene.verts)),
        diffuse=_leaf(scene.materials.diffuse),
        specular=_leaf(scene.materials.specular),
    )


def params_from_numpy(p, device="cuda") -> InverseParams:
    """The port's parameters from any ``InverseParams`` (the JAX
    package's, or one of numpy arrays): leaf tensors that require grad, on
    ``device``."""
    return InverseParams(*(
        _leaf(torch.as_tensor(np.array(getattr(p, f)), device=device))
        for f in InverseParams._fields))


def apply_params(params: InverseParams, scene: Scene) -> Scene:
    return scene.replace(
        verts=scene.verts + params.vert_offsets,
        materials=scene.materials.replace(
            diffuse=params.diffuse, specular=params.specular),
    )


def loss_fn(params: InverseParams, scene: Scene, camera: Camera, target,
            cfg: RenderConfig):
    """Mean squared difference between the rendered image and
    ``target`` ([height, width, 4])."""
    img = render_frame(apply_params(params, scene), camera, cfg)
    return torch.mean((img - target) ** 2)


def make_optimizer(params: InverseParams, lr: float = 1e-2):
    """Adam over the three parameter tensors, with ``optax.adam``'s
    defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(list(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(params: InverseParams, optimizer, scene: Scene,
               camera: Camera, target, cfg: RenderConfig):
    """One step: the loss, its gradient, one optimizer update of
    ``params`` in place.  Returns the loss (before the update), detached."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, scene, camera, target, cfg)
    loss.backward()
    optimizer.step()
    return loss.detach()

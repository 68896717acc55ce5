"""Inverse rendering: the training step (the JAX package's
``models/inverse.py``).

Optimizes vertex offsets and the materials' diffuse and specular colours
so that the rendered image matches a target.  The gradient is autograd's
through ``render_frame``: traversal and hit ids are discrete, and the
shading re-evaluates each hit from its leaf-attribute row, whose gather
(kernel K2 on CUDA tensors) has kernel K3 as its backward
(``ops/gather_cuda``).  ``torch.optim.Adam`` with optax's defaults takes
the place of ``optax.adam``: it updates the parameters in place.
``adam_state`` and ``optimizer_from_numpy`` carry its state to and from
optax's layout (``AdamState``), the one checkpoints hold
(``utils/checkpoint.py``).
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


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the two moments."""
    count: object  # int32 scalar
    mu: InverseParams
    nu: InverseParams


def adam_state(optimizer, params: InverseParams):
    """The state of ``optimizer`` (``make_optimizer(params)``) in the
    layout of ``optax.adam``'s state, ``(AdamState(count, mu, nu), ())``:
    ``count`` is ``state['step']`` as an int32 scalar, ``mu`` and ``nu``
    are ``exp_avg`` and ``exp_avg_sq`` (zeros, count 0, before the first
    step).  The empty tuple stands for optax's ``EmptyState``: neither
    holds a leaf."""
    states = [optimizer.state.get(p, {}) for p in params]
    count = np.int32(int(states[0]["step"]) if states[0] else 0)
    mu, nu = (InverseParams(*(s[k].detach().clone() if s
                              else torch.zeros_like(p.detach())
                              for s, p in zip(states, params)))
              for k in ("exp_avg", "exp_avg_sq"))
    return AdamState(count=count, mu=mu, nu=nu), ()


def optimizer_from_numpy(params: InverseParams, opt_state, lr: float = 1e-2,
                         device="cuda"):
    """``make_optimizer(params, lr)`` holding ``opt_state``, an
    ``optax.adam`` state of host arrays (the JAX package's, or one
    restored from a checkpoint): ``count`` becomes each parameter's
    ``step``, ``mu`` its ``exp_avg`` and ``nu`` its ``exp_avg_sq``, made
    on ``device`` (the CUDA device unless the caller asks for another;
    without a card the default raises).  A fresh optimizer takes the
    state through ``load_state_dict``."""
    adam = opt_state[0]
    optimizer = make_optimizer(params, lr)
    step = float(np.asarray(adam.count))
    sd = optimizer.state_dict()
    sd["state"] = {i: {
        "step": torch.tensor(step, dtype=torch.float32),
        "exp_avg": torch.as_tensor(np.array(m), device=device),
        "exp_avg_sq": torch.as_tensor(np.array(v), device=device),
    } for i, (m, v) in enumerate(zip(adam.mu, adam.nu))}
    optimizer.load_state_dict(sd)
    return optimizer


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

"""Inverse rendering: the training step (the JAX package's
``models/inverse.py``).

Optimizes vertex offsets and the materials' diffuse and specular colours
so that the rendered image matches a target.  The gradient is autograd's
through ``render_frame``: traversal and hit ids are discrete, and the
shading re-evaluates each hit from its leaf-attribute row, whose gather
(kernel K2 on CUDA tensors) has kernel K3 as its backward
(``ops/gather_cuda``).  A chunked frame shades its chunks in one loop
(``pipeline._ChunkMap``), whose backward is a second loop over the same
chunks that recomputes each chunk's shading and takes its
vector-Jacobian product: a culled chunk is visited by neither, and adds
nothing, as under JAX's ``lax.cond``.  ``torch.optim.Adam``
with optax's defaults takes the place of ``optax.adam``: it updates the
parameters in place.
``adam_state`` and ``optimizer_from_numpy`` carry its state to and from
optax's layout (``AdamState``), the one checkpoints hold
(``utils/checkpoint.py``).

``train_step_jit`` is the JAX package's jitted ``train_step``: on CUDA
tensors the loss, its backward and the optimizer's update are one CUDA
graph (``graphs.Captured``), replayed a step, with the learning rate a
device tensor that each call sets.  It needs Adam with ``capturable=True``
(``make_optimizer(..., capturable=True)``), whose bias corrections are
computed on the device in float32 where the default Adam computes them
in Python floats: after one step the graphed parameters differ from the
default eager step's by a few ulps of the update, and they part further
from there; with the same capturable Adam the eager ``train_step`` gives
the graphed step's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import graphs
from ..config import RenderConfig
from ..core.types import Camera, Scene
from ..pipeline import render_frame
from ..utils import profiling


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
                         device="cuda", capturable: bool = False):
    """``make_optimizer(params, lr, capturable)`` holding ``opt_state``,
    an ``optax.adam`` state of host arrays (the JAX package's, or one
    restored from a checkpoint): ``count`` becomes each parameter's
    ``step`` (on the parameters' device for a capturable optimizer, as
    ``load_state_dict`` puts it), ``mu`` its ``exp_avg`` and ``nu`` its
    ``exp_avg_sq``, made on ``device`` (the CUDA device unless the caller
    asks for another; without a card the default raises).  A fresh
    optimizer takes the state through ``load_state_dict``."""
    adam = opt_state[0]
    optimizer = make_optimizer(params, lr, capturable)
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


def make_optimizer(params: InverseParams, lr: float = 1e-2,
                   capturable: bool = False):
    """Adam over the three parameter tensors, with ``optax.adam``'s
    defaults (b1 0.9, b2 0.999, eps 1e-8).  ``capturable`` makes the one
    ``train_step_jit`` captures on the card: its step count lives on the
    parameters' device and its learning rate is a float32 device tensor
    there (``torch.optim.Adam`` steps a capturable optimizer on CUDA
    tensors only)."""
    if capturable:
        lr = torch.full((), lr, dtype=torch.float32,
                        device=params[0].device)
    return torch.optim.Adam(list(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, capturable=capturable)


def train_step(params: InverseParams, optimizer, scene: Scene,
               camera: Camera, target, cfg: RenderConfig):
    """One step: the loss, its gradient, one optimizer update of
    ``params`` in place.  Returns the loss (before the update), detached."""
    optimizer.zero_grad(set_to_none=True)
    return _step(params, optimizer, scene, camera, target, cfg)


def _step(params: InverseParams, optimizer, scene: Scene, camera: Camera,
          target, cfg: RenderConfig):
    """The loss, ``backward()`` and the update: the span ``step``, with
    ``forward``, ``backward`` and ``optimizer`` inside it."""
    ref = params.vert_offsets
    with profiling.span("step", ref):
        with profiling.span("forward", ref):
            loss = loss_fn(params, scene, camera, target, cfg)
        with profiling.span("backward", ref):
            loss.backward()
        with profiling.span("optimizer", ref):
            optimizer.step()
        return loss.detach()


def step_graphs(optimizer) -> graphs.Cache:
    """``train_step_jit``'s captures for ``optimizer``, by signature, held by
    the optimizer itself: a captured step closes over its optimizer, so a
    cache held anywhere else would keep the optimizer alive, and with it
    every graph and pool it captured.  Held here they form one cycle with
    it, which the collector frees once the caller drops the optimizer."""
    cache = getattr(optimizer, "_raytracebvh_step_graphs", None)
    if cache is None:
        cache = graphs.Cache(name="step")
        optimizer._raytracebvh_step_graphs = cache
    return cache


class _GraphedStep:
    """``train_step`` on one optimizer's parameters as a CUDA graph.

    The warm-up is a real step (it makes the optimizer's state where
    there is none), so the parameters and the state are put back to their
    values before it; the gradients are set to None before the capture,
    so that backward() writes them, in the graph's memory, rather than
    adding to them.  The parameters and the state are the caller's own
    tensors, updated in place by each replay."""

    def __init__(self, params, optimizer, scene, camera, target,
                 cfg: RenderConfig, stream, **capture):
        self.lr = optimizer.param_groups[0]["lr"]
        params = tuple(params)
        state = [optimizer.state[p] for p in params]
        saved = [(p.detach().clone(), {k: v.clone() for k, v in s.items()})
                 for p, s in zip(params, state)]

        def warmup(s, c, t):
            train_step(InverseParams(*params), optimizer, s, c, t, cfg)

        def step(s, c, t):
            return _step(InverseParams(*params), optimizer, s, c, t, cfg)

        def restore():
            with torch.no_grad():
                for p, (p0, s0), s in zip(params, saved, state):
                    p.copy_(p0)
                    for k, v in s.items():
                        if k in s0:
                            v.copy_(s0[k])
                        else:  # a fresh optimizer: the state Adam starts from
                            v.zero_()

        self.captured = graphs.Captured(
            step, (scene, camera, target), stream, warmup=warmup,
            prepare=lambda: (restore(),
                             optimizer.zero_grad(set_to_none=True)),
            **capture)
        self.grads = [p.grad for p in params]  # the graph writes them

    def __call__(self, scene, camera, target, lr: float):
        self.lr.fill_(lr)
        loss = self.captured(scene, camera, target)
        with profiling.host_span("graphs.copy_out"):
            return loss.clone()


def train_step_jit(params: InverseParams, optimizer, scene: Scene,
                   camera: Camera, target, cfg: RenderConfig,
                   lr: float = 1e-2):
    """``train_step`` compiled, the counterpart of the JAX package's
    jitted ``train_step``: the loss (before the update, detached), with
    ``params`` and the optimizer's state updated in place at learning
    rate ``lr``.  On CUDA tensors the loss, its backward (K3 among its
    kernels) and Adam's update are one CUDA graph, captured at the first
    call of its optimizer and signature and replayed with ``scene``,
    ``camera`` and ``target`` copied in and ``lr`` written into the
    optimizer's device learning rate (no re-capture).  ``optimizer`` must
    be ``make_optimizer(params, lr, capturable=True)`` (or
    ``optimizer_from_numpy(..., capturable=True)``) over ``params``.  A
    chunked frame shades and differentiates its chunks (a culled one its
    hit chunks) in two WHILE nodes of the graph, the forward's and the
    backward's (``graphs.while_loop``).  On CPU tensors it is
    ``train_step`` at learning rate ``lr``.  While ``profiling.spans()``
    is open the call is one call id, its key a spans-on graph's."""
    if params.vert_offsets.device.type != "cuda":
        for group in optimizer.param_groups:
            group["lr"] = lr
        return train_step(params, optimizer, scene, camera, target, cfg)
    group = optimizer.param_groups[0]
    if (len(optimizer.param_groups) != 1 or not group.get("capturable")
            or not isinstance(group["lr"], torch.Tensor)
            or [id(p) for p in group["params"]] != [id(p) for p in params]):
        raise ValueError(
            "train_step_jit: the optimizer must be make_optimizer(params, "
            "lr, capturable=True) over these parameters")
    with profiling.call(params.vert_offsets):
        key = graphs.signature(cfg, scene, camera, target,
                               tuple(p.data_ptr() for p in params))
        cache = step_graphs(optimizer)
        step = cache.get(key, lambda: _GraphedStep(
            params, optimizer, scene, camera, target, cfg,
            cache.stream(params.vert_offsets.device), **cache.options()))
        return step(scene, camera, target, lr)

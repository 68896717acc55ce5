"""The plain reference of the inverse-rendering step: the mean squared
error of the frame against a target, its gradient with respect to the
vertex offsets and the materials' diffuse and specular colours, and Adam
(b1 0.9, b2 0.999, eps 1e-8) on them.  Plain PyTorch on the reference
frame (``render.py``); it imports nothing of the program."""

from __future__ import annotations

import torch

from . import render

LEAVES = ("vert_offsets", "diffuse", "specular")
B1, B2, EPS = 0.9, 0.999, 1e-8


def loss_and_grads(scene: dict, cam: dict, cfg: dict, target, params: dict,
                   stats=None):
    """(loss, {leaf: gradient}) of ``params`` (a dict of ``LEAVES``)."""
    leaves = {k: params[k].detach().clone().requires_grad_(True)
              for k in LEAVES}
    img = render.render_pixels(
        scene, cam, cfg, offsets=leaves["vert_offsets"],
        materials={"diffuse": leaves["diffuse"],
                   "specular": leaves["specular"]}, stats=stats)
    loss = torch.mean((img - target.reshape(-1, 4)) ** 2)
    grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES],
                                allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(leaves[k]) if g is None else g
        for k, g in zip(LEAVES, grads)}


def adam_steps(scene: dict, cam: dict, cfg: dict, target, params: dict,
               lr: float, steps: int):
    """``steps`` steps of Adam from ``params`` with fresh moments ->
    (losses, the first step's gradients, each leaf's change after the
    last step)."""
    p = {k: params[k].detach().clone() for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    losses, first = [], None
    for t in range(1, steps + 1):
        loss, g = loss_and_grads(scene, cam, cfg, target, p)
        losses.append(float(loss))
        if first is None:
            first = g
        for k in LEAVES:
            m[k] = B1 * m[k] + (1 - B1) * g[k]
            v[k] = B2 * v[k] + (1 - B2) * g[k] * g[k]
            mhat = m[k] / (1 - B1 ** t)
            vhat = v[k] / (1 - B2 ** t)
            p[k] = p[k] - lr * mhat / (torch.sqrt(vhat) + EPS)
    return losses, first, {k: p[k] - params[k] for k in LEAVES}

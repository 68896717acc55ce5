"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``reference/``), as numbers that each have a limit
(the traffic file's ``limits``).

Frames: a sample of the pixels of a sample of the window's frames, each
drawn from the seed; ``px_bad_share`` is the share of them whose largest
channel differs from the reference's by more than ``pixel_tol``.

Training: the first three steps, which set-up drives through the window's
own call.  ``loss_gap`` is the relative gap of the first step's loss (the
later steps' losses part by the round-off of Adam's first update, see
PERF.md);
``grad_gap`` the worst leaf's gap between the norms of the first gradient
(read from Adam's first moment after one step) and the reference's;
``change_gap`` the same of the parameters' change after three steps, over
the leaves whose reference gradient is not nought to rounding (a norm at
least a thousandth of the median leaf's).  A leaf's gap is measured
against the larger of its reference norm and the median leaf's.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from rtbench.reference import render as ref_render
from rtbench.reference import train as ref_train

LEAVES = ref_train.LEAVES
# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by round-off alone
NOUGHT = 1e-3


def ref_cfg(cfg) -> dict:
    """The program's config as the reference's dict of fields."""
    return dataclasses.asdict(cfg)


def sample_pixels(gen: torch.Generator, count: int, total: int, device):
    return torch.randperm(total, generator=gen, device="cpu")[:count].to(
        device)


def bad_pixels(image, scene: dict, cam: dict, cfg: dict, pixels,
               tol: float):
    """(pixels of ``image`` [H, W, 4] off the reference by more than
    ``tol`` in some channel, pixels compared)."""
    want = ref_render.render_pixels(scene, cam, cfg, pixels)
    got = image.reshape(-1, 4)[pixels].float()
    err = (got - want).abs().amax(dim=-1)
    return int((~(err <= tol)).sum()), int(pixels.numel())


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(tree[k].double()))
            for k in tree}


def norm_gap(got: dict, want: dict, leaves) -> float:
    """The worst leaf's |norm(got) - norm(want)| over the larger of
    norm(want) and the median leaf's."""
    gn, wn = norms(got), norms(want)
    med = statistics.median(wn[k] for k in LEAVES)
    gaps = [abs(gn[k] - wn[k]) / max(wn[k], med) if max(wn[k], med) > 0
            else float("inf") for k in leaves]
    return max(gaps) if gaps else float("nan")


def moved_leaves(first_grads: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    gn = norms(first_grads)
    med = statistics.median(gn.values())
    return [k for k in LEAVES if gn[k] >= NOUGHT * med]


def train_numbers(got: dict, want: dict) -> dict:
    """``got`` and ``want``: dicts of 'losses' (a float a step), 'grads'
    (the first step's, by leaf) and 'change' (after the last step)."""
    if len(got["losses"]) != len(want["losses"]):
        raise ValueError("the program and the reference ran other steps")
    g, w = got["losses"][0], want["losses"][0]
    return {"loss_gap": abs(g - w) / abs(w),
            "grad_gap": norm_gap(got["grads"], want["grads"], LEAVES),
            "change_gap": norm_gap(got["change"], want["change"],
                                   moved_leaves(want["grads"]))}


def reference_steps(scene: dict, cam: dict, cfg: dict, target, params: dict,
                    lr: float, steps: int) -> dict:
    losses, first, change = ref_train.adam_steps(scene, cam, cfg, target,
                                                 params, lr, steps)
    return {"losses": losses, "grads": first, "change": change}

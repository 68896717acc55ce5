"""The faults the check must catch, planted in the program under the timed
path, and the lower-precision control: each a context manager that patches
the program (or torch) while a run sets up and runs, so that a captured
graph holds the fault.  ``controls.py`` reads them at a cell's own size on
the card; ``tests/test_rtbench_faults.py`` sees each make ``correct``
false at a tiny size on the CPU.

  bf16       the control: the program's own bfloat16 path
             (``RenderConfig.dtype``), one precision below the float32 the
             configurations state
  altered    an answer altered where it is produced: each shaded colour
             one 8-bit step (1/255) off
  half       half of the batch left out: the frame's lower half is not
             shaded (background), a step's loss is the mean over the upper
             half's rays, and a rank of the sharded step traces the first
             half of its rays and takes the mean over them
  unchanged  a step that leaves its state unchanged: the optimizer's
             update does nothing
  exchange   the exchange between chips left out: the all-reduce does
             nothing
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("bf16", "altered", "half", "unchanged", "exchange")
# which faults a cell of each entry can have
OF_ENTRY = {"frame": ("altered", "half"),
            "train": ("altered", "half", "unchanged"),
            "train_sharded": ("altered", "half", "unchanged", "exchange")}


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def bf16_traffic(traffic: dict) -> dict:
    """``traffic`` with the program's bfloat16 path switched on."""
    return dict(traffic, render=dict(traffic["render"], dtype="bfloat16"))


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` (not 'bf16', which is a traffic
    change: ``bf16_traffic``)."""
    from raytracebvh_tpu_torch import pipeline
    from raytracebvh_tpu_torch.models import inverse
    from raytracebvh_tpu_torch.parallel import render as prender

    if name == "altered":
        shade = pipeline._shade_hit_soa

        def altered(*a, **k):
            loc, normal, color, *rest = shade(*a, **k)
            return (loc, normal, tuple(c + 1.0 / 255.0 for c in color),
                    *rest)

        with _patched(pipeline, "_shade_hit_soa", altered):
            yield
    elif name == "half":
        render = pipeline.render_frame

        def half_frame(scene, camera, cfg):
            img = render(scene, camera, cfg)
            # filled on the device: a graph's capture takes no host copy
            bg = torch.stack([torch.full((), v, dtype=img.dtype,
                                         device=img.device)
                              for v in cfg.background])
            top = img[:cfg.height // 2]
            rest = bg.expand(cfg.height - cfg.height // 2, cfg.width, 4)
            return torch.cat([top, rest])

        def half_loss(params, scene, camera, target, cfg):
            img = render(inverse.apply_params(params, scene), camera, cfg)
            h = cfg.height // 2
            return torch.mean((img[:h] - target[:h]) ** 2)

        shard = prender.ray_shard

        def half_shard(x, mesh):
            block = shard(x, mesh)
            return block[:block.shape[0] // 2]

        with _patched(pipeline, "render_frame", half_frame), \
                _patched(inverse, "loss_fn", half_loss), \
                _patched(prender, "ray_shard", half_shard):
            yield
    elif name == "unchanged":
        with _patched(torch.optim.Adam, "step", lambda self, *a, **k: None):
            yield
    elif name == "exchange":
        with _patched(torch.distributed, "all_reduce", _no_exchange):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; expected one of {NAMES}")


class _Done:
    def wait(self):
        return True


def _no_exchange(tensor, *args, async_op=False, **kwargs):
    return _Done() if async_op else None

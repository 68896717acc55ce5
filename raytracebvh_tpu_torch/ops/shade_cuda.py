"""The frames' shading as two hand-written CUDA kernels a pass
(``csrc/shade.cu``), around the pass's texture gather: ``shade_surface``
(the hit position, normal, texel quad row and bilinear fractions from the
gathered ``[40, R]`` leaf block) and ``shade_finish`` (the colour, the
spawned rays and their intensities from K2's ``[16, R]`` quad block).
Each pass function returns what its plain counterpart in ``pipeline``
returns (``_launch_soa``, ``_bounce_soa``, ``_bounce_refract_soa``), bit
for bit on the card.

The kernels have no backward: a pass takes them where ``engages`` holds,
which needs every input on a CUDA device and no input that needs a
gradient.  Everywhere else (the CPU, bfloat16, the plain gathers, the
training step's differentiated passes) the plain PyTorch shading runs;
the two paths share no arithmetic.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..config import RenderConfig, resolve_backend
from ..utils import profiling
from . import gather_cuda

# kernel launches, two a shading pass that took them (chip_smoke.py and
# the gpu tests check the frames reach them); a CUDA graph's capture
# counts, its replays do not (they skip this wrapper)
launches = 0

# shade_finish's pass kinds (csrc/shade.cu Kind)
LAUNCH, BOUNCE, REFRACT = 0, 1, 2
# the leaf gathers' kernel routes (config.resolve_backend)
KERNEL_ROUTES = ("cuda", "shared")
LEAF_CHANNELS = 40


def engages(cfg: RenderConfig, tensors) -> bool:
    """Whether a shading pass of ``cfg`` whose inputs are ``tensors`` (the
    leaf table, the quad table, the rays' components and the carried
    state; None entries skipped) takes the kernels: ``cfg.dtype`` is
    float32, the leaf gather is a kernel route, every input lies on a
    CUDA device and is float32 (the quad table float32 or uint8), and no
    input needs a gradient (``graphs.check_no_grad``'s rule: grad mode on
    and an input that requires grad)."""
    tensors = [t for t in tensors if t is not None]
    return (cfg.dtype == "float32"
            and resolve_backend(cfg, "shade_gather_backend") in KERNEL_ROUTES
            and all(t.device.type == "cuda" for t in tensors)
            and all(t.dtype in (torch.float32, torch.uint8) for t in tensors)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in tensors)))


def _vec(v3, nrays: int, what: str):
    """The 3-tuple ``v3`` of [R] float32 components, made contiguous where
    their strides differ (the kernels take one stride for the three)."""
    for c in v3:
        if c.dtype != torch.float32 or c.shape != (nrays,):
            raise ValueError(f"shade: {what} components must be [{nrays}] "
                             f"float32; got {c.dtype} {tuple(c.shape)}")
    if len({c.stride(0) for c in v3}) != 1:
        v3 = tuple(c.contiguous() for c in v3)
    return v3


def _ptrs(v3) -> list:
    """[x, y, z pointers, element stride] of ``_vec``'s 3-tuple."""
    return [c.data_ptr() for c in v3] + [v3[0].stride(0)]


def _flat(x, nrays: int, dtype, what: str):
    """``x`` as a contiguous [R] tensor of ``dtype``; raises otherwise."""
    if x.dtype != dtype or x.shape != (nrays,):
        raise ValueError(f"shade: {what} must be [{nrays}] {dtype}; got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _pass(kind: int, block, hit, o3, d3, scene, tex_quads,
          cfg: RenderConfig, vis=None, color=None, intensity=None):
    """One pass: shade_surface, the quad gather (the span ``gather``, on
    ``cfg.texture_gather_backend``'s route), shade_finish.  Returns the
    finish kernel's outputs as [R] views: (colour 4, origin 3, direction
    3, intensity[, origin 3, direction 3, intensity of the refraction
    spawn for LAUNCH])."""
    if (block.dtype != torch.float32 or block.dim() != 2
            or block.shape[0] != LEAF_CHANNELS or not block.is_contiguous()):
        raise ValueError("shade: the leaf block must be a contiguous [40, R] "
                         f"float32 tensor; got {block.dtype} "
                         f"{tuple(block.shape)}")
    nrays = block.shape[1]
    dev = block.device
    hit = _flat(hit, nrays, torch.bool, "hit")
    o3, d3 = _vec(o3, nrays, "origin"), _vec(d3, nrays, "direction")
    tex_hw = scene.tex_hw.to(device=dev, dtype=torch.int32).contiguous()
    hmax, wmax = scene.textures.shape[1], scene.textures.shape[2]
    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.empty((3, nrays), **f32)
    normal = torch.empty((3, nrays), **f32)
    flat = torch.empty((nrays,), dtype=torch.int32, device=dev)
    frac = torch.empty((2, nrays), **f32)
    lib = _kernels.load()
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rtbvh_shade_surface(
            block.data_ptr(), *_ptrs(o3), *_ptrs(d3), hit.data_ptr(),
            tex_hw.data_ptr(), tex_hw.shape[0], hmax, wmax, nrays,
            pos.data_ptr(), normal.data_ptr(), flat.data_ptr(),
            frac.data_ptr(), stream)
    _kernels.check(err, "shade_surface launch")
    launches += 1

    with profiling.span("gather", flat):
        quads = gather_cuda.gather_for(
            resolve_backend(cfg, "texture_gather_backend"))(tex_quads, flat)

    vis = None if vis is None else _flat(vis, nrays, torch.float32, "vis")
    ins = [0] * 5  # the carried colour and intensity: a bounce's only
    if kind != LAUNCH:
        color = [_flat(c, nrays, torch.float32, "colour") for c in color]
        intensity = _flat(intensity, nrays, torch.float32, "intensity")
        ins = [c.data_ptr() for c in color] + [intensity.data_ptr()]
    # [colour 4, origin 3, direction 3, intensity] (+ the refraction
    # spawn's [origin 3, direction 3, intensity] for LAUNCH), one block
    nout = 18 if kind == LAUNCH else 11
    out = torch.empty((nout, nrays), **f32)
    ptr = [out[k].data_ptr() for k in (0, 4, 7, 10)]
    ptr += ([out[k].data_ptr() for k in (11, 14, 17)] if kind == LAUNCH
            else [0, 0, 0])
    bg = [float(b) for b in cfg.background]
    offset = cfg.ray_offset if kind == LAUNCH else cfg.bounce_ray_offset
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rtbvh_shade_finish(
            kind, block.data_ptr(), quads.data_ptr(), pos.data_ptr(),
            normal.data_ptr(), frac.data_ptr(), *_ptrs(o3), *_ptrs(d3),
            hit.data_ptr(), 0 if vis is None else vis.data_ptr(), *ins,
            nrays, *bg, float(cfg.reflection_decay),
            float(cfg.refraction_decay), float(offset),
            float(cfg.intensity_min), *ptr, stream)
    _kernels.check(err, "shade_finish launch")
    launches += 1
    return out.unbind(0)


def launch(block, hit, o3, d3, scene, tex_quads, cfg: RenderConfig,
           vis=None):
    """The primary pass's shading: ``pipeline._launch_soa``'s results
    (color4, (refl_o3, refl_d3), refl_intensity, (refr_o3, refr_d3),
    refr_intensity) from the gathered leaf block ``block`` [40, R], the
    hit flags ``hit``, the rays ``o3``, ``d3`` and the shadow factor
    ``vis`` (None: unshadowed)."""
    x = _pass(LAUNCH, block, hit, o3, d3, scene, tex_quads, cfg, vis=vis)
    return (x[0:4], (x[4:7], x[7:10]), x[10], (x[11:14], x[14:17]), x[17])


def bounce(block, hit, o3, d3, color, intensity, scene, tex_quads,
           cfg: RenderConfig):
    """A reflection pass's shading: ``pipeline._bounce_soa``'s results
    (new_color, new_o, new_d, new_intensity) from the carried ``color``
    and ``intensity``."""
    x = _pass(BOUNCE, block, hit, o3, d3, scene, tex_quads, cfg,
              color=color, intensity=intensity)
    return x[0:4], x[4:7], x[7:10], x[10]


def bounce_refract(block, hit, o3, d3, color, intensity, scene, tex_quads,
                   cfg: RenderConfig):
    """A transmission pass's shading: ``pipeline._bounce_refract_soa``'s
    results, as ``bounce``'s."""
    x = _pass(REFRACT, block, hit, o3, d3, scene, tex_quads, cfg,
              color=color, intensity=intensity)
    return x[0:4], x[4:7], x[7:10], x[10]

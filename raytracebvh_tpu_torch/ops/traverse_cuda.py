"""Nearest-hit traversal, kernel K1, and any-hit traversal, kernel K4
(both ``csrc/traverse.cu``): they replace the JAX package's HBM refill
traversal (``ops/traverse_hbm.py`` ``_make_refill_kernel``, with
``any_hit=False`` and ``any_hit=True``).  Same contracts as the plain
``ops.traverse.traverse`` and ``traverse_any``, which run instead for CPU
tensors.

The kernel reads two tables, packed once per build (``pack_tables``, or
the build's kernel pack ``ops.pack_cuda``, which writes the same bits):
a node table [2n, 8] float32 (bbmin xyz, bbmax xyz, and the entry and
skip links as int32 bits: one 32-byte load per node) and a leaf table
[n, 12] float32 (v0, e1 = v1 - v0, e2 = v2 - v0, padding), with the
edges computed as the plain version computes them.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..core.types import BVH, HitRecord, Rays
from . import traverse as traverse_plain

# launches of K1 and K4 (chip_smoke.py checks the main path reaches them);
# a CUDA graph's capture counts, its replays do not (they skip the wrappers)
launches = 0
any_launches = 0
# per device: int32[1] count of rays that reached max_steps before the end
# of their walk (their record is the result so far), K1 and K4 alike
_truncated: dict = {}


def truncated_rays() -> int:
    """Rays cut off by the step cap since the last reset_truncated()."""
    return sum(int(t.item()) for t in _truncated.values())


def reset_truncated() -> None:
    for t in _truncated.values():
        t.zero_()


def pack_tables(bvh: BVH):
    """(node_table [2n, 8], leaf_table [n, 12]) float32 (module doc)."""
    bvh = bvh.detach()
    f32 = torch.float32
    links = torch.stack([bvh.entry_link, bvh.skip_link], -1).to(torch.int32)
    nodes = torch.cat([bvh.bbmin.to(f32), bvh.bbmax.to(f32),
                       links.view(f32)], dim=1)
    tv = bvh.tri_verts.to(f32)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    leaves = torch.cat([v0, e1, e2, torch.zeros_like(v0)], dim=1)
    return nodes.contiguous(), leaves.contiguous()


def with_tables(bvh: BVH) -> BVH:
    """``bvh`` with its K1/K4 tables packed (a no-op when they are, and on
    the CPU, where the plain walk needs none)."""
    if bvh.node_table is not None or bvh.prim.device.type == "cpu":
        return bvh
    nodes, leaves = pack_tables(bvh)
    return bvh.replace(node_table=nodes, leaf_table=leaves)


def as_float32(t: torch.Tensor, what: str, name: str) -> torch.Tensor:
    """``t`` in float32, the kernels' type: float32 as it is, bfloat16 and
    float16 cast exactly, as the JAX kernels cast their rays and max_t
    (``traverse_hbm.py:604-608``, ``traverse_pallas.py:345-353``).  Any
    other dtype raises."""
    if t.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: {name} must be float32 (or bfloat16 / "
                         f"float16, cast to it); got {t.dtype}")
    return t.to(torch.float32)


def float32_walk(walk):
    """The plain walk ``walk`` (``ops.traverse.traverse`` or
    ``traverse_any``) given the casts the kernels' wrappers make: rays,
    max_t and the tree's boxes and triangles in float32, as ``as_float32``
    and ``pack_tables`` give them.  What a kernel's result on bfloat16
    rays is held to."""
    f32 = torch.float32

    def run(bvh, rays, epsilon, *args, **kw):
        bvh = bvh.replace(bbmin=bvh.bbmin.to(f32), bbmax=bvh.bbmax.to(f32),
                          tri_verts=bvh.tri_verts.to(f32))
        rays = Rays(rays.origin.to(f32), rays.direction.to(f32))
        args = tuple(a.to(f32) if isinstance(a, torch.Tensor) else a
                     for a in args)
        return walk(bvh, rays, epsilon, *args, **kw)
    return run


def _prepare(bvh: BVH, rays: Rays, what: str, max_steps: int):
    """Check the rays and tables a launch reads; (float32 rays, bvh with
    its tables, per-ray step cap, truncation counter)."""
    dev = rays.origin.device
    if dev.type != "cuda" or rays.direction.device != dev:
        raise ValueError(f"{what}: rays on {rays.origin.device} and "
                         f"{rays.direction.device}")
    rays = Rays(origin=as_float32(rays.origin, what, "origin"),
                direction=as_float32(rays.direction, what, "direction"))
    for name, t in (("origin", rays.origin), ("direction", rays.direction)):
        if t.dim() != 2 or t.shape[1] != 3 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous [R, 3] "
                             f"tensor; got {tuple(t.shape)}")
    if rays.origin.shape != rays.direction.shape:
        raise ValueError(f"{what}: origin and direction shapes differ")
    bvh = with_tables(bvh)
    n = bvh.n_leaves
    for name, t, shape in (("node_table", bvh.node_table, (2 * n, 8)),
                           ("leaf_table", bvh.leaf_table, (n, 12))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"{what}: {name} must be a 16-byte aligned contiguous "
                f"{shape} float32 tensor on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if dev not in _truncated:
        # a normal tensor even under inference_mode, so a reset outside it
        # may zero it in place
        with torch.inference_mode(False):
            _truncated[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return rays, bvh, (max_steps if max_steps > 0 else 4 * n), _truncated[dev]


def launch_nearest(c_fn: str, what: str, bvh: BVH, rays: Rays,
                   epsilon: float, max_steps: int, return_steps: bool,
                   extra=()):
    """Launch a nearest-hit walk kernel (``c_fn``: K1's, or K5's with the
    same arguments and ``extra`` before the stream) on CUDA rays:
    (the wrapper's result, whether a kernel was launched)."""
    rays, bvh, max_steps, truncated = _prepare(bvh, rays, what, max_steps)
    origin, direction = rays.origin, rays.direction
    dev = origin.device
    nrays = origin.shape[0]
    hit = torch.empty(nrays, dtype=torch.bool, device=dev)
    dist = torch.empty(nrays, dtype=torch.float32, device=dev)
    leaf = torch.empty(nrays, dtype=torch.int32, device=dev)
    steps = torch.empty(nrays, dtype=torch.int32, device=dev)
    rec = HitRecord(hit=hit, distance=dist, leaf=leaf)
    out = (rec, steps) if return_steps else rec
    if nrays == 0:
        return out, False
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_kernels.load(), c_fn)(
            origin.data_ptr(), direction.data_ptr(), bvh.node_table.data_ptr(),
            bvh.leaf_table.data_ptr(), nrays, bvh.n_leaves, epsilon,
            max_steps, hit.data_ptr(), dist.data_ptr(), leaf.data_ptr(),
            steps.data_ptr() if return_steps else None,
            truncated.data_ptr(), *extra, stream)
    _kernels.check(err, f"{what} launch")
    return out, True


def launch_any(c_fn: str, what: str, bvh: BVH, rays: Rays, epsilon: float,
               max_t, max_steps: int, return_steps: bool, extra=()):
    """Launch an any-hit walk kernel (``c_fn``: K4's, or K6's with the same
    arguments and ``extra`` before the stream) on CUDA rays: (the
    wrapper's result, whether a kernel was launched)."""
    rays, bvh, max_steps, truncated = _prepare(bvh, rays, what, max_steps)
    origin = rays.origin
    dev = origin.device
    nrays = origin.shape[0]
    if (not isinstance(max_t, torch.Tensor) or max_t.device != dev
            or tuple(max_t.shape) != (nrays,) or not max_t.is_contiguous()):
        raise ValueError(
            f"{what}: max_t must be a contiguous [{nrays}] float32 tensor "
            f"on {dev}")
    max_t = as_float32(max_t, what, "max_t")
    occ = torch.empty(nrays, dtype=torch.bool, device=dev)
    steps = torch.empty(nrays, dtype=torch.int32, device=dev)
    out = (occ, steps) if return_steps else occ
    if nrays == 0:
        return out, False
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_kernels.load(), c_fn)(
            origin.data_ptr(), rays.direction.data_ptr(), max_t.data_ptr(),
            bvh.node_table.data_ptr(), bvh.leaf_table.data_ptr(), nrays,
            bvh.n_leaves, epsilon, max_steps, occ.data_ptr(),
            steps.data_ptr() if return_steps else None,
            truncated.data_ptr(), *extra, stream)
    _kernels.check(err, f"{what} launch")
    return out, True


def traverse(bvh: BVH, rays: Rays, epsilon: float, max_steps: int = 0,
             return_steps: bool = False):
    """K1 for CUDA tensors, ``ops.traverse.traverse`` for CPU tensors.
    On CUDA, bfloat16 or float16 rays are cast to float32 (``as_float32``)
    and the distances come back in float32, as from the JAX kernel.

    ``max_steps`` caps each ray's walk (0 = 4n); a ray that reaches the
    cap keeps its best hit so far and adds one to ``truncated_rays()``.
    ``return_steps`` also returns the [R] int32 per-ray step counts."""
    if rays.origin.device.type == "cpu":
        return traverse_plain.traverse(bvh, rays, epsilon, max_steps,
                                       return_steps)
    out, launched = launch_nearest("rtbvh_traverse", "K1 traverse", bvh,
                                   rays, epsilon, max_steps, return_steps)
    global launches
    launches += launched
    return out


def traverse_any(bvh: BVH, rays: Rays, epsilon: float, max_t,
                 max_steps: int = 0, return_steps: bool = False):
    """K4 for CUDA tensors, ``ops.traverse.traverse_any`` for CPU tensors:
    [R] bool, occluded where a triangle meets the ray at t in
    (epsilon, max_t).  ``max_t`` is a contiguous [R] float32 tensor; on
    CUDA, bfloat16 or float16 rays and ``max_t`` are cast to float32.

    ``max_steps`` caps each ray's walk (0 = 4n); a ray that reaches the
    cap without an occluder reads False and adds one to
    ``truncated_rays()``.  ``return_steps`` also returns the [R] int32
    per-ray step counts."""
    if rays.origin.device.type == "cpu":
        return traverse_plain.traverse_any(bvh, rays, epsilon, max_t,
                                           max_steps, return_steps)
    out, launched = launch_any("rtbvh_traverse_any", "K4 traverse_any", bvh,
                               rays, epsilon, max_t, max_steps, return_steps)
    global any_launches
    any_launches += launched
    return out


def traverse_for(backend: str):
    """The traversal a resolved backend names (``config.resolve_backend``):
    'cuda' -> ``traverse``, 'torch' -> ``ops.traverse.traverse``."""
    return traverse if backend == "cuda" else traverse_plain.traverse


def traverse_any_for(backend: str):
    """The any-hit traversal a resolved backend names: 'cuda' ->
    ``traverse_any``, 'torch' -> ``ops.traverse.traverse_any``."""
    return traverse_any if backend == "cuda" else traverse_plain.traverse_any

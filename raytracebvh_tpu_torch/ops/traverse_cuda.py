"""Nearest-hit traversal, kernel K1 (``csrc/traverse.cu``): replaces the
JAX package's HBM refill traversal (``ops/traverse_hbm.py``
``_make_refill_kernel(any_hit=False)``).  Same contract as the plain
``ops.traverse.traverse``, which runs instead for CPU tensors.

The kernel reads two tables, packed once per build (``pack_tables``):
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

launches = 0  # K1 launches (chip_smoke.py checks the main path reaches it)
# per device: int32[1] count of rays that reached max_steps before the end
# of their walk (their record is the best hit so far)
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
    """``bvh`` with its K1 tables packed (a no-op when they are, and on
    the CPU, where the plain walk needs none)."""
    if bvh.node_table is not None or bvh.prim.device.type == "cpu":
        return bvh
    nodes, leaves = pack_tables(bvh)
    return bvh.replace(node_table=nodes, leaf_table=leaves)


def traverse(bvh: BVH, rays: Rays, epsilon: float, max_steps: int = 0,
             return_steps: bool = False):
    """K1 for CUDA tensors, ``ops.traverse.traverse`` for CPU tensors.

    ``max_steps`` caps each ray's walk (0 = 4n); a ray that reaches the
    cap keeps its best hit so far and adds one to ``truncated_rays()``.
    ``return_steps`` also returns the [R] int32 per-ray step counts."""
    origin, direction = rays.origin, rays.direction
    if origin.device.type == "cpu":
        return traverse_plain.traverse(bvh, rays, epsilon, max_steps,
                                       return_steps)
    dev = origin.device
    if dev.type != "cuda" or direction.device != dev:
        raise ValueError(f"traverse: rays on {origin.device} and "
                         f"{direction.device}")
    for name, t in (("origin", origin), ("direction", direction)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3
                or not t.is_contiguous()):
            raise ValueError(f"traverse: {name} must be a contiguous [R, 3] "
                             f"float32 tensor; got {t.dtype} {tuple(t.shape)}")
    if origin.shape != direction.shape:
        raise ValueError("traverse: origin and direction shapes differ")
    bvh = with_tables(bvh)
    n = bvh.n_leaves
    nodes, leaves = bvh.node_table, bvh.leaf_table
    for name, t, shape in (("node_table", nodes, (2 * n, 8)),
                           ("leaf_table", leaves, (n, 12))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"traverse: {name} must be a 16-byte aligned contiguous "
                f"{shape} float32 tensor on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if max_steps <= 0:
        max_steps = 4 * n

    nrays = origin.shape[0]
    hit = torch.empty(nrays, dtype=torch.bool, device=dev)
    dist = torch.empty(nrays, dtype=torch.float32, device=dev)
    leaf = torch.empty(nrays, dtype=torch.int32, device=dev)
    steps = torch.empty(nrays, dtype=torch.int32, device=dev)
    rec = HitRecord(hit=hit, distance=dist, leaf=leaf)
    if nrays == 0:
        return (rec, steps) if return_steps else rec
    if dev not in _truncated:
        # a normal tensor even under inference_mode, so a reset outside it
        # may zero it in place
        with torch.inference_mode(False):
            _truncated[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.load().rtbvh_traverse(
            origin.data_ptr(), direction.data_ptr(), nodes.data_ptr(),
            leaves.data_ptr(), nrays, n, epsilon, max_steps,
            hit.data_ptr(), dist.data_ptr(), leaf.data_ptr(),
            steps.data_ptr() if return_steps else None,
            _truncated[dev].data_ptr(), stream)
    _kernels.check(err, "K1 traverse launch")
    launches += 1
    return (rec, steps) if return_steps else rec


def traverse_for(backend: str):
    """The traversal a resolved backend names (``config.resolve_backend``):
    'cuda' -> ``traverse``, 'torch' -> ``ops.traverse.traverse``."""
    return traverse if backend == "cuda" else traverse_plain.traverse

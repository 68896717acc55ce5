"""Nearest-hit traversal, kernel K5, and any-hit traversal, kernel K6
(both ``csrc/traverse_shared.cu``), with the tree's node records in
shared memory: they replace the JAX package's whole-tree-in-VMEM
traversal (``ops/traverse_pallas.py`` ``traverse_pallas`` and
``traverse_any_pallas``).  Same contracts and signatures as K1/K4
(``ops.traverse_cuda``) and the plain ``ops.traverse.traverse`` and
``traverse_any``, which run instead for CPU tensors; they read K1's
tables (``traverse_cuda.pack_tables``) and share K1's truncation counter.

A tree fits when its n - 1 internal nodes, 32 bytes each, fit one
block's opt-in shared memory (232 448 bytes on an H100: up to 7 265
leaves) and n is within the JAX kernel's u16 link cap (2n < 0xFFFF).
``fits`` is that rule as a pure function; the pipeline's ``auto`` takes
K1/K4 for a tree that does not fit, and these wrappers raise on one.
What a launch stages (``staged_first``: every node record where all
2n - 1 fit a block, else the internal nodes) and its grid
(``launch_geometry``: one 1 024-thread block an SM, fewer for a few rays)
are chosen here from n, the device's limit and the ray count; the kernel
shares the rays out 32 at a time, a first round dealt warp by warp over
the blocks, then from a work queue.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from ..core.types import BVH, Rays
from . import traverse as traverse_plain
from . import traverse_cuda

NODE_BYTES = 32  # one node record: bbmin, bbmax, entry, skip
LINK_CAP = 0xFFFF  # the JAX kernel's u16 links: 2 * n_leaves < LINK_CAP
BLOCK = 1024  # threads of a K5/K6 block, one an SM (csrc/traverse_shared.cu)

# launches of K5 and K6 (chip_smoke.py checks the main path reaches them);
# a CUDA graph's capture counts, its replays do not (they skip the wrappers)
launches = 0
any_launches = 0
_smem: dict = {}  # device index -> opt-in shared memory a block may use


def shared_bytes(n_leaves: int) -> int:
    """Shared memory of a tree's internal nodes: what K5/K6 must stage."""
    return (n_leaves - 1) * NODE_BYTES


def fits(n_leaves: int, smem_per_block) -> bool:
    """Whether K5/K6 take a tree of ``n_leaves`` leaves on a device whose
    blocks may use ``smem_per_block`` bytes of shared memory (None: no
    shared-memory limit, as for the plain walk on the CPU)."""
    if n_leaves < 2 or 2 * n_leaves >= LINK_CAP:
        return False
    return smem_per_block is None or shared_bytes(n_leaves) <= smem_per_block


def smem_per_block(device: torch.device):
    """The opt-in shared memory a block may use on ``device`` in bytes, or
    None for the CPU."""
    if device.type != "cuda":
        return None
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _smem:
        out = ctypes.c_int(0)
        _kernels.check(_kernels.load().rtbvh_shared_mem_per_block(
            index, ctypes.addressof(out)), "shared memory query")
        _smem[index] = out.value
    return _smem[index]


def _check_fits(bvh: BVH, device: torch.device, what: str) -> None:
    n = bvh.n_leaves
    smem = smem_per_block(device)
    if not fits(n, smem):
        raise ValueError(
            f"{what}: a tree of {n} leaves does not fit K5/K6 "
            f"({shared_bytes(n)} bytes of shared memory of {smem} a block, "
            f"2n < {LINK_CAP}); use K1/K4 (ops.traverse_cuda)")


def staged_first(n_leaves: int, smem_per_block: int) -> int:
    """The first node whose record K5/K6 stage: 0 (every record, leaves'
    boxes included) where the 2n - 1 records fit ``smem_per_block`` bytes,
    else n (the internal nodes only)."""
    return 0 if (2 * n_leaves - 1) * NODE_BYTES <= smem_per_block else n_leaves


def launch_geometry(nrays: int, sms: int) -> int:
    """The grid of a K5/K6 launch on ``nrays`` rays: a BLOCK-thread block
    an SM, fewer where there are fewer than 32 rays a block, so that a
    small launch spreads over every SM and no block is without rays."""
    return max(1, min(sms, -(-nrays // 32)))


def launch_walk(any_hit: bool, bvh: BVH, rays: Rays, epsilon: float,
                max_t=None, max_steps: int = 0, return_steps: bool = False):
    """K5 (or K6 for ``any_hit``) on CUDA rays, counted, staging
    ``staged_first``'s records on ``launch_geometry``'s grid: the result
    of ``traverse`` or ``traverse_any``."""
    global launches, any_launches
    dev = rays.origin.device
    what = "K6 traverse_any_shared" if any_hit else "K5 traverse_shared"
    _check_fits(bvh, dev, what)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the work-queue counter, zeroed by the launch on its stream: a
    # launch's own, so that no two streams share one (a graph's
    # conditional nodes capture on a stream of their own) and none is made
    # in a capture to be kept
    work = torch.empty(1, dtype=torch.int32, device=dev)
    extra = (staged_first(bvh.n_leaves, smem_per_block(dev)),
             launch_geometry(rays.origin.shape[0], sms), work.data_ptr())
    if any_hit:
        out, launched = traverse_cuda.launch_any(
            "rtbvh_traverse_any_shared", what, bvh, rays, epsilon, max_t,
            max_steps, return_steps, extra)
        any_launches += launched
    else:
        out, launched = traverse_cuda.launch_nearest(
            "rtbvh_traverse_shared", what, bvh, rays, epsilon, max_steps,
            return_steps, extra)
        launches += launched
    return out


def traverse(bvh: BVH, rays: Rays, epsilon: float, max_steps: int = 0,
             return_steps: bool = False):
    """K5 for CUDA tensors, ``ops.traverse.traverse`` for CPU tensors;
    the arguments and results of ``traverse_cuda.traverse`` (K1)."""
    if rays.origin.device.type == "cpu":
        return traverse_plain.traverse(bvh, rays, epsilon, max_steps,
                                       return_steps)
    return launch_walk(False, bvh, rays, epsilon, max_steps=max_steps,
                       return_steps=return_steps)


def traverse_any(bvh: BVH, rays: Rays, epsilon: float, max_t,
                 max_steps: int = 0, return_steps: bool = False):
    """K6 for CUDA tensors, ``ops.traverse.traverse_any`` for CPU tensors;
    the arguments and results of ``traverse_cuda.traverse_any`` (K4)."""
    if rays.origin.device.type == "cpu":
        return traverse_plain.traverse_any(bvh, rays, epsilon, max_t,
                                           max_steps, return_steps)
    return launch_walk(True, bvh, rays, epsilon, max_t, max_steps,
                       return_steps)

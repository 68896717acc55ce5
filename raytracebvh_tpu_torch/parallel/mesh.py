"""Process groups, device meshes and sharding (the JAX package's
``parallel/mesh.py`` on ``torch.distributed``).

One process drives one device.  The mesh's two data-parallel axes are
the JAX package's:

  * ``rays``: every rank traces its block of image rows;
  * ``geo``: geometry sharding; vertex and face arrays are split over it
    and all-gathered before the build.

``make_host_mesh`` adds ``dcn`` outside them: the host boundary, which
only the cross-host stage of the gradient average crosses.

Start one process a card with ``torchrun --nproc_per_node=<cards>
<script>`` and call ``initialize_distributed()`` in each (``make_mesh``
calls it when no process group exists); a plain ``python <script>`` runs
at world size 1, and end with ``destroy_distributed()``.  The process
group is NCCL's on the card and Gloo's on the CPU (``device="cpu"``, as
the CPU tests run it).  Making a process
group or a mesh is collective: every rank of the world makes the same
calls in the same order, or they wait for each other until the group's
timeout.
"""

from __future__ import annotations

import datetime
import os
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import graphs
from ..core.types import map_tensors

RAYS_AXIS = "rays"
GEO_AXIS = "geo"
DCN_AXIS = "dcn"  # host boundary: collectives crossing it leave NVLink


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None else int(value)


def initialize_distributed(device="cuda", init_method: Optional[str] = None,
                           timeout_s: float = 300.0) -> None:
    """Start this process's default process group (no-op when one exists).

    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` are read as ``torchrun``
    sets them; without them the process runs alone at world size 1 on an
    in-process store (no file, no port).  ``init_method`` (``file://...``
    or ``tcp://host:port``) overrides the rendezvous.  The backend is
    NCCL for ``device`` 'cuda' and Gloo for 'cpu'.  On 'cuda' it selects
    card ``LOCAL_RANK`` before the first collective, and raises without a
    card or without NCCL: there is no fallback to the CPU."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed: device 'cuda' but no CUDA device "
                "is visible (pass device='cpu' for Gloo on the CPU)")
        torch.cuda.set_device(_env_int("LOCAL_RANK", 0))
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("initialize_distributed: this PyTorch has no NCCL")
    rank, world = _env_int("RANK", 0), _env_int("WORLD_SIZE", 1)
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        kw["init_method"] = init_method
    elif world == 1 and "MASTER_ADDR" not in os.environ:
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(**kw)


def _world(device) -> int:
    initialize_distributed(device=device)
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, geo: int = 1,
              device="cuda") -> DeviceMesh:
    """A ('rays', 'geo') mesh over ranks ``0 .. n_devices - 1`` (all of
    them by default): rank r sits at (r // geo, r % geo).  ``geo`` ranks
    shard geometry; the remaining factor shards rays.  Every rank of the
    world calls it, also one outside the mesh."""
    world = _world(device)
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    if n % geo:
        raise ValueError(f"{n} ranks not divisible by geo={geo}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(n // geo, geo),
                      mesh_dim_names=(RAYS_AXIS, GEO_AXIS))


def host_mesh_shape(world: int, local: int, geo: int) -> tuple:
    """(dcn, rays, geo) sizes for ``world`` ranks, ``local`` a host."""
    if world % local:
        raise ValueError(f"{world} ranks not divisible by {local} a host")
    if local % geo:
        raise ValueError(
            f"{local} local devices not divisible by geo={geo}")
    return world // local, local // geo, geo


def make_host_mesh(geo: int = 1, device="cuda") -> DeviceMesh:
    """A ('dcn', 'rays', 'geo') mesh: the outer axis is the host boundary
    (``WORLD_SIZE // LOCAL_WORLD_SIZE`` hosts), the inner axes each
    host's local ranks, which talk over NVLink.  So the geometry
    all-gather and the first stages of the gradient average stay inside
    a host, and only the averaged values cross ``dcn``.  Rays shard over
    ('dcn', 'rays') together.  torchrun numbers ranks host by host, so
    rank r sits at its row-major coordinate."""
    world = _world(device)
    shape = host_mesh_shape(world, _env_int("LOCAL_WORLD_SIZE", world), geo)
    return DeviceMesh(torch.device(device).type,
                      torch.arange(world).reshape(shape),
                      mesh_dim_names=(DCN_AXIS, RAYS_AXIS, GEO_AXIS))


# every mesh's graphs (mesh_graphs), which destroy_distributed drops
_MESH_GRAPHS = weakref.WeakSet()


def mesh_graphs(mesh: DeviceMesh) -> graphs.Cache:
    """The CUDA graphs captured over ``mesh`` (``parallel.render``'s entry
    points on the card), held by the mesh itself: a graph replays the
    mesh's communicators, so the graphs go with the mesh (or with
    ``destroy_distributed``), and another mesh captures its own.  They
    capture in ``capture_error_mode="thread_local"``: the process group's
    watchdog thread queries CUDA events, which the default "global" mode
    forbids while any thread captures."""
    cache = getattr(mesh, "_raytracebvh_graphs", None)
    if cache is None:
        cache = graphs.Cache(capture_error_mode="thread_local")
        mesh._raytracebvh_graphs = cache
        _MESH_GRAPHS.add(cache)
    return cache


def destroy_distributed() -> None:
    """Ends this process's process group (no-op when there is none): drops
    every mesh's CUDA graphs (``mesh_graphs``), then calls
    ``destroy_process_group()``.  A graph that captured an NCCL collective
    holds its communicator, and NCCL does not finalize a communicator
    while such a graph lives, so ``destroy_process_group()`` with the
    graphs alive does not return (seen at 2 ranks on H100s).  End with
    this, not with ``destroy_process_group()``."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for cache in list(_MESH_GRAPHS):
        cache.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def ray_axes(mesh: DeviceMesh):
    """The mesh axes the ray (data-parallel) dimension shards over:
    ('dcn', 'rays') on a host mesh, 'rays' on a flat mesh."""
    if DCN_AXIS in mesh.mesh_dim_names:
        return (DCN_AXIS, RAYS_AXIS)
    return RAYS_AXIS


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis ``name`` (1 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def _coordinate(mesh: DeviceMesh):
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in {mesh}")
    return coord


def _shard(x, mesh: DeviceMesh, names, what: str):
    """This rank's contiguous block of ``x``'s leading axis, split over
    the mesh axes ``names`` (outer first)."""
    coord = dict(zip(mesh.mesh_dim_names, _coordinate(mesh)))
    index, count = 0, 1
    for name in names:
        index = index * axis_size(mesh, name) + coord[name]
        count *= axis_size(mesh, name)
    n = x.shape[0]
    if n % count:
        raise ValueError(f"{what}: leading axis {n} does not divide into "
                         f"{count} shards (pad it: pad_to_multiple)")
    block = n // count
    return x[index * block:(index + 1) * block]


def ray_shard(x, mesh: DeviceMesh):
    """This rank's contiguous block of ``x``'s leading axis over
    ``ray_axes(mesh)``."""
    axes = ray_axes(mesh)
    return _shard(x, mesh, axes if isinstance(axes, tuple) else (axes,),
                  "ray_shard")


def geo_shard(x, mesh: DeviceMesh):
    """This rank's contiguous block of ``x``'s leading axis over 'geo'."""
    return _shard(x, mesh, (GEO_AXIS,), "geo_shard")


def replicated(tree, mesh: DeviceMesh):
    """``tree`` (a dataclass of tensors, such as a ``Scene`` or a
    ``Camera``) with every tensor broadcast from the rank at the mesh's
    origin: the counterpart of ``device_put(tree, replicated(mesh))``.
    Broadcasts along each axis in turn; collective over the mesh's ranks.
    The copies carry no gradient."""
    coord = _coordinate(mesh)

    def broadcast(t):
        out = t.detach().clone().contiguous()
        for dim, name in enumerate(mesh.mesh_dim_names):
            origin = list(coord)
            origin[dim] = 0
            dist.broadcast(out, src=int(mesh.mesh[tuple(origin)]),
                           group=mesh.get_group(name))
        return out

    return map_tensors(broadcast, tree)


def pad_to_multiple(x, multiple: int, axis: int = 0, fill=0):
    """Pad a host array so axis length divides ``multiple``."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(x, pad_widths, constant_values=fill), n

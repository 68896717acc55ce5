"""Scaling measurement (the JAX package's ``parallel/scaling.py`` on
``torch.distributed``): a weak-scaling sweep of the sharded training step
over meshes of 1, 2, 4 ... N ranks, analytic bytes a rank moves in each
collective of the step, and a model of multi-host efficiency from them.

  * geometry all-gather over 'geo' (``render_geo_sharded``): the JAX
    package's model, (geo - 1) shares of the vertex, normal, uv, index and
    material-index arrays a rank and step (the port gathers the
    transformed vertices and normals and the leaf data instead, arrays of
    the same order of size);
  * gradient average over the mesh (``train_step_sharded``): a ring
    all-reduce moves 2 (d - 1) / d times the parameter bytes through each
    rank a step.

Weak scaling holds the work a rank constant (rays and triangles grow with
the mesh), so efficiency(d) = t(1) / t(d).  The report names the device
and backend it ran on; it never goes to the JAX package's committed
``SCALING.json``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..core.types import Camera, Scene
from ..models.inverse import apply_params, init_params
from ..models.procedural import random_triangles
from ..utils.checkpoint import tree_leaves
from .mesh import GEO_AXIS, make_mesh, mesh_graphs
from .render import train_step_sharded

ROOT = Path(__file__).resolve().parent.parent.parent
REPORT_PATH = ROOT / "build" / "raytracebvh_tpu_torch" / "scaling_torch.json"
COMMITTED_REPORT = ROOT / "SCALING.json"  # the JAX package's TPU history


def _tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor)))


def _geometry_bytes(scene: Scene) -> int:
    return _tree_bytes((scene.verts, scene.normals, scene.uv, scene.indices,
                        scene.mat_index))


def comm_volume_per_device(scene: Scene, params, mesh) -> Dict[str, float]:
    """Analytic bytes moved per device per step by each collective."""
    d = mesh.size()
    geo = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(GEO_AXIS, 1)
    param_bytes = _tree_bytes(params)
    return {
        "all_gather_bytes": _geometry_bytes(scene) * (geo - 1) / max(1, geo),
        "psum_bytes": 2.0 * param_bytes * (d - 1) / max(1, d),
        "geo_axis": geo,
        "param_bytes": param_bytes,
    }


# Link rates of the predictive model: NVIDIA's nominal figures for the
# NVIDIA H100 80GB HBM3, 700 W (SXM5), not measurements.  NVLink 4 joins
# a host's cards at 900 GB/s a card, 450 GB/s each way; between hosts one
# 400 Gb/s NDR InfiniBand NIC a card, 50 GB/s.
NVLINK_BW = 4.5e11
NIC_BW = 5.0e10


def predict_multihost_efficiency(
    scene: Scene,
    params,
    step_s_one_chip: float,
    hosts: int = 4,
    local_devices: int = 4,
    geo: int = 1,
    ici_bw: float = NVLINK_BW,
    dcn_bw: float = NIC_BW,
) -> Dict[str, float]:
    """Efficiency of the sharded training step on a ('dcn', 'rays', 'geo')
    mesh of ``hosts`` x ``local_devices`` cards, from a measured one-card
    step time and the analytic collective volumes over the link rates
    (``ici_bw`` the links inside a host, NVLink; ``dcn_bw`` between
    hosts, the NIC; the keys keep the JAX package's names).

    Model (weak scaling): per step each card moves (a) the geometry
    all-gather over the inner 'geo' axis and (b) a hierarchical gradient
    all-reduce: ring reduce-scatter + all-gather inside the host
    (2 B (l - 1) / l bytes), then a cross-host combine on the 1/l-sized
    shard (2 (B / l) (h - 1) / h bytes).  Efficiency = t_step / (t_step +
    t_exposed); with the ``grad_chunks`` overlap t_exposed shrinks toward
    max(0, t_comm - t_bwd), taking the backward as 60% of the step: both
    bounds are reported."""
    l, h = local_devices, hosts
    b = _tree_bytes(params)
    ici_bytes = _geometry_bytes(scene) * (geo - 1) / max(1, geo) \
        + 2.0 * b * (l - 1) / l
    dcn_bytes = 2.0 * (b / l) * (h - 1) / h
    t_comm = ici_bytes / ici_bw + dcn_bytes / dcn_bw
    eff_serial = step_s_one_chip / (step_s_one_chip + t_comm)
    t_exposed = max(0.0, t_comm - 0.6 * step_s_one_chip)
    eff_overlap = step_s_one_chip / (step_s_one_chip + t_exposed)
    return {
        "hosts": h,
        "local_devices": l,
        "ici_bytes_per_device": ici_bytes,
        "dcn_bytes_per_device": dcn_bytes,
        "t_comm_ms": t_comm * 1e3,
        "step_ms_one_chip": step_s_one_chip * 1e3,
        "efficiency_serial_bound": eff_serial,
        "efficiency_overlapped_bound": eff_overlap,
        "assumed_ici_bw": ici_bw,
        "assumed_dcn_bw": dcn_bw,
    }


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def weak_scaling_sweep(
    max_devices: Optional[int] = None,
    rows_per_device: int = 8,
    width: int = 16,
    tris_per_geo: int = 8,
    bounces: int = 1,
    iters: int = 3,
    device="cuda",
) -> List[Dict[str, Any]]:
    """Times the sharded train step on meshes of 1, 2, 4, ...,
    ``max_devices`` ranks (the world size by default) with constant work a
    rank; one record a mesh size.  Every rank of the world calls it: mesh
    creation is collective, and ranks outside a mesh wait at a barrier
    while it runs.  Rank 0 takes part in every mesh, so its list is the
    whole sweep; another rank's holds the meshes it was in.  Times are the
    least of ``iters`` host-clock runs after a warm-up, ended by a device
    synchronize.  On the card the step timed is the compiled one
    (``train_step_sharded``'s replayed CUDA graph, captured in the
    warm-up); on the CPU the eager step.  Each mesh's graphs are dropped
    before the next mesh is made."""
    n = dist.get_world_size() if max_devices is None else max_devices
    sizes = []
    d = 1
    while d <= n:
        sizes.append(d)
        d *= 2
    if sizes[-1] != n:
        sizes.append(n)

    cam = Camera.default(device)
    records: List[Dict[str, Any]] = []
    for d in sizes:
        geo = 2 if d % 2 == 0 else 1
        mesh = make_mesh(d, geo=geo, device=device)
        if mesh.get_coordinate() is None:
            dist.barrier()
            continue
        height = rows_per_device * (d // geo)
        ntris = tris_per_geo * geo
        cfg = RenderConfig(width=width, height=height, bounces=bounces,
                           leaf_pad_multiple=32)
        scene = random_triangles(ntris, seed=0, device=device)
        params = init_params(scene)
        target = torch.zeros((height, width, 4), device=device)

        def timeit(chunks):
            def step():
                train_step_sharded(params, apply_params, scene, cam, target,
                                   cfg, mesh, grad_chunks=chunks)
                _sync(device)

            step()  # warm-up
            best = float("inf")
            for _ in range(iters):
                t0 = time.perf_counter()
                step()
                best = min(best, time.perf_counter() - t0)
            return best

        dt = timeit(1)
        # the overlapped schedule (grad_chunks): its difference from
        # step_ms is the overlap's gain, or the recompute's cost where
        # the mesh has no communication to hide
        dt_ov = timeit(2) if d > 1 else dt
        mesh_graphs(mesh).clear()
        rays = width * height * (1 + bounces)
        records.append({
            "devices": d,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "tris": ntris,
            "rays_per_step": rays,
            "step_ms": dt * 1e3,
            "step_ms_overlapped": dt_ov * 1e3,
            "rays_per_sec": rays / dt,
            **comm_volume_per_device(scene, params, mesh),
        })
        dist.barrier()

    t1 = records[0]["step_ms"] if records and records[0]["devices"] == 1 \
        else None
    for rec in records:
        rec["weak_scaling_efficiency"] = (
            None if t1 is None else t1 / rec["step_ms"])
    return records


def write_scaling_report(records, path=REPORT_PATH, device="cuda") -> Path:
    """Writes the sweep's records with the device, backend and world size
    they came from to ``path`` (by default
    ``build/raytracebvh_tpu_torch/scaling_torch.json``); refuses the
    committed ``SCALING.json``.  Returns the path."""
    path = Path(path).resolve()
    if path == COMMITTED_REPORT.resolve():
        raise ValueError(f"write_scaling_report: {path} is the JAX "
                         "package's committed report; write elsewhere")
    dev = torch.device(device)
    report = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "world_size": dist.get_world_size() if dist.is_initialized() else 1,
        "host_cores": os.cpu_count(),
        "note": ("weak scaling: work a rank constant; efficiency = "
                 "t(1)/t(d), host clock, least of the runs"),
        "records": records,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2))
    return path

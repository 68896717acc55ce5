"""The port imports, renders (shadows and refraction included, and
through the on-chip backends ``shared`` / ``shared`` / ``bitonic``),
takes a training step, runs its compiled entry points (``graphs``,
``render_frame_jit``, ``train_step_jit``: eager on the CPU), and imports
and runs its tools (checkpoints, the
train and profile CLIs, profiling, logging, the depth image, the native
library's build), and imports the multi-device path and renders a
geometry-sharded frame at world size 1 over Gloo, with JAX and flax
blocked: it must run on a machine that has neither."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|raytracebvh_tpu)\b", re.MULTILINE)

SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
import torch
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models.procedural import random_triangles
from raytracebvh_tpu_torch.cli import render
img = T.render_frame(random_triangles(50, seed=2, with_texture=True,
                                      alpha=0.4, optical_density=0.7,
                                      device="cpu"),
                     T.Camera.default("cpu"),
                     T.RenderConfig(width=16, height=16, bounces=1,
                                    ortho_scale=1.0, enable_shadows=True,
                                    enable_refraction=True))
assert img.shape == (16, 16, 4) and bool(torch.isfinite(img).all())
onchip = T.render_frame(random_triangles(50, seed=2, with_texture=True,
                                         device="cpu"),
                        T.Camera.default("cpu"),
                        T.RenderConfig(width=16, height=16, bounces=1,
                                       ortho_scale=1.0, enable_shadows=True,
                                       traversal_backend="shared",
                                       shade_gather_backend="shared",
                                       sort_backend="bitonic"))
assert onchip.shape == (16, 16, 4) and bool(torch.isfinite(onchip).all())
from raytracebvh_tpu_torch.models import inverse
scene = random_triangles(20, seed=3, with_texture=True, device="cpu")
params = inverse.init_params(scene)
loss = inverse.train_step(params, inverse.make_optimizer(params), scene,
                          T.Camera.default("cpu"), torch.zeros(8, 8, 4),
                          T.RenderConfig(width=8, height=8, bounces=1,
                                         ortho_scale=1.0))
assert bool(torch.isfinite(loss))
from raytracebvh_tpu_torch import graphs
opt = inverse.make_optimizer(params)
assert bool(torch.isfinite(inverse.train_step_jit(
    params, opt, scene, T.Camera.default("cpu"), torch.zeros(8, 8, 4),
    T.RenderConfig(width=8, height=8, bounces=1, ortho_scale=1.0), lr=0.01)))
jit_img = T.render_frame_jit(scene, T.Camera.default("cpu"),
                             T.RenderConfig(width=8, height=8))
assert graphs.tensors(jit_img) == [jit_img]
from raytracebvh_tpu_torch import native
from raytracebvh_tpu_torch.cli import profile, train
from raytracebvh_tpu_torch.ref import refimage
from raytracebvh_tpu_torch.utils import checkpoint, logging, profiling
native.available()
state = (params, inverse.adam_state(inverse.make_optimizer(params), params), 0)
assert len(checkpoint.tree_leaves(state)) == 11
depth = refimage.render_depth_bmp(scene, 16, 16)
assert depth.shape == (16, 16, 3)
assert list(profiling.stage_times(scene, T.Camera.default("cpu"),
                                  T.RenderConfig(width=8, height=8), 1)) == [
    "morton", "sort", "topology", "fit", "links", "build_total",
    "trace_shade", "frame_total"]
from raytracebvh_tpu_torch.parallel import mesh, render as prender, scaling
mesh.initialize_distributed(device="cpu")
flat = mesh.make_mesh(device="cpu")
sharded = prender.render_geo_sharded(scene, T.Camera.default("cpu"),
                                     T.RenderConfig(width=8, height=8), flat)
assert torch.equal(sharded, T.render_frame(scene, T.Camera.default("cpu"),
                                           T.RenderConfig(width=8, height=8)))
torch.distributed.destroy_process_group()
assert not any(m in ("jax", "raytracebvh_tpu")
               or m.startswith(("jax.", "flax", "optax", "raytracebvh_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_module_imports_jax():
    pkg = os.path.join(ROOT, "raytracebvh_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not JAX_IMPORT.search(fh.read()), f


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_frames.py",
                                    "walk_sass.py"])
def test_chip_scripts_import_no_jax(script):
    """The scripts run on the GPU machine, which has no JAX."""
    with open(os.path.join(ROOT, script)) as fh:
        assert not JAX_IMPORT.search(fh.read()), script

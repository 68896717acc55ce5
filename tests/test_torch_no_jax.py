"""The port imports and renders with JAX and flax blocked: it must run on
a machine that has neither."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch.models.procedural import random_triangles
from raytracebvh_tpu_torch.cli import render
img = T.render_frame(random_triangles(50, seed=2, with_texture=True),
                     T.Camera.default(),
                     T.RenderConfig(width=16, height=16, bounces=1,
                                    ortho_scale=1.0))
assert img.shape == (16, 16, 4) and bool(torch.isfinite(img).all())
assert not any(m in ("jax", "raytracebvh_tpu")
               or m.startswith(("jax.", "flax", "raytracebvh_tpu."))
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
    bad = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|raytracebvh_tpu)\b",
                     re.MULTILINE)
    pkg = os.path.join(ROOT, "raytracebvh_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not bad.search(fh.read()), f

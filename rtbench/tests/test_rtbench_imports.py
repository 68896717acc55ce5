"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types

from rtbench import harness

PORT = "raytracebvh_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != PORT, (path, name)
    code = ("import sys\n"
            f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
            "import rtbench.reference.render, rtbench.reference.train\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{(PORT,) + harness.FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_guard_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        for name in harness.FORBIDDEN:
            sys.modules.pop(name, None)
        sys.modules["raytracebvh_tpu_torch_probe"] = types.ModuleType("p")
        sys.modules["jaxtyping_probe"] = types.ModuleType("p")
        assert harness.forbidden_modules() == []
        sys.modules["raytracebvh_tpu.ops"] = types.ModuleType("p")
        sys.modules["jax.numpy"] = types.ModuleType("p")
        assert harness.forbidden_modules() == ["jax", "raytracebvh_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_leaves_no_forbidden_module():
    code = ("import sys, json\n"
            f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
            "from rtbench import harness\n"
            "from rtbench.tests import tiny\n"
            "run = tiny.drive('sphere3k-train', 5)\n"
            "print(json.dumps([run.check.correct, "
            "harness.forbidden_modules(), 'raytracebvh_tpu_torch' in "
            "sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, bad, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == [] and port

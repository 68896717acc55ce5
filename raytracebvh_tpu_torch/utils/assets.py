"""Asset resolution.

The reference hardcodes "Obj/Test.obj" (reference: Graphics.cpp:364).  We
resolve the same asset names against RTBVH_OBJ_DIR (point it at the
reference checkout's Obj/ directory), then the repo's assets/ directory,
and callers fall back to procedurally generated scenes otherwise.
"""

from __future__ import annotations

import os

_DEFAULT_DIRS = (
    os.environ.get("RTBVH_OBJ_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets"),
)


def find_asset(name: str) -> str | None:
    for d in _DEFAULT_DIRS:
        if not d:
            continue
        p = os.path.join(d, name)
        if os.path.isfile(p):
            return p
    return None

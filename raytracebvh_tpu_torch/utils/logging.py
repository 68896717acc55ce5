"""Structured logging + metrics (the JAX package's ``utils/logging.py``;
it imports neither JAX nor the JAX package).

The reference's observability is ``printf`` (FPS once a second,
Graphics.cpp:65-92; loader errors to stdout).  Here: a leveled logger
(stdlib logging, namespaced ``rtbvh``) plus a JSONL metrics sink — one
line per event with a wall-clock timestamp, suitable for plotting or
tailing during long renders/training runs.

Usage:
    from raytracebvh_tpu_torch.utils.logging import get_logger, MetricsWriter
    log = get_logger()
    log.info("loaded %s: %d tris", path, scene.num_faces)
    with MetricsWriter("run.jsonl") as mw:
        mw.write("frame", frame=i, ms=dt * 1e3, mrays_per_sec=r)
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import IO, Optional

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"


def get_logger(name: str = "rtbvh", level: Optional[str] = None) -> logging.Logger:
    """Leveled logger; level from arg or RTBVH_LOG_LEVEL (default INFO)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    lvl = level or os.environ.get("RTBVH_LOG_LEVEL", "INFO")
    logger.setLevel(getattr(logging, lvl.upper(), logging.INFO))
    return logger


class MetricsWriter:
    """Append-only JSONL metrics sink: one event per line.

    Each line: {"ts": <unix seconds>, "event": <name>, ...fields}.
    A None path disables writing (all calls become no-ops), so callers
    can thread an optional writer without branching.
    """

    def __init__(self, path: Optional[str]):
        self._path = path
        self._f: Optional[IO[str]] = None

    def __enter__(self) -> "MetricsWriter":
        if self._path:
            self._f = open(self._path, "a")
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def write(self, event: str, **fields) -> None:
        if self._f is None:
            return
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

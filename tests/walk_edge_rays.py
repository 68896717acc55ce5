"""Rays whose slab test meets distances of exactly 0, for the walk tests
on the CPU (``test_torch_traverse.py``) and on the GPU
(``test_torch_cuda.py``).  numpy only: the GPU machine has no JAX."""

import numpy as np


def corner_edge_rays(bbmin, bbmax, nrays, seed, kind):
    """numpy float32 (origin, direction) [nrays, 3] whose slab distances
    are exactly 0 on some planes of the boxes [N, 3] ``bbmin``/``bbmax``:
    origins on a corner of a random non-empty box ('corner': three planes)
    or on one of its edges ('edge': two; the third coordinate inside the
    box).  Directions of both signs on every axis; a third of them in an
    axis plane and a third axis-parallel, their zero components +0 or -0
    (1/d = +inf or -inf, and 0 * inf = NaN on the planes through the
    origin)."""
    rng = np.random.default_rng(seed)
    node = rng.choice(np.flatnonzero(np.all(bbmin <= bbmax, axis=1)), nrays)
    lo, hi = bbmin[node], bbmax[node]
    origin = np.where(rng.integers(0, 2, (nrays, 3)) == 1, hi, lo)
    r = np.arange(nrays)
    if kind == "edge":
        axis = rng.integers(0, 3, nrays)
        u = rng.uniform(0.25, 0.75, nrays).astype(np.float32)
        origin[r, axis] = lo[r, axis] + (hi[r, axis] - lo[r, axis]) * u
    d = rng.normal(size=(nrays, 3)).astype(np.float32)
    axes = rng.permuted(np.tile(np.arange(3), (nrays, 1)), axis=1)
    nzero = r % 3  # zero components: none, one, two
    zero = np.zeros((nrays, 3), bool)
    zero[r, axes[:, 0]] = nzero >= 1
    zero[r, axes[:, 1]] = nzero >= 2
    signed = np.where(rng.integers(0, 2, (nrays, 3)) == 1, np.float32(-0.0),
                      np.float32(0.0))
    d = np.where(zero, signed, d)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return origin.astype(np.float32), d.astype(np.float32)

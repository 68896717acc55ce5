"""LBVH construction: Karras-2012 hierarchy emit + AABB fit + skip links
(the JAX package's ``ops/bvh.py`` in torch).

The Karras emit is the plain exponential + binary search
(``karras_children``), vectorized over all internal nodes; the JAX
package's production ``karras_children_rmq`` gives bit-identical output.
The AABB fit is a sparse-table range-min query over the contiguous leaf
range each internal node covers, and the skip links have a closed form in
range space (see ``compute_links``).

Node ids: leaf k in [0, n), internal node i at id n + i, root = n.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

BIG = 1.0e30  # empty-box sentinel: bbmin = +BIG, bbmax = -BIG
I32 = torch.int32


class Topology(NamedTuple):
    """Tree topology arrays, all sized [2n] (slot 2n-1 unused)."""

    child_l: torch.Tensor  # int32, -1 for leaves
    child_r: torch.Tensor  # int32, -1 for leaves
    parent: torch.Tensor  # int32, -1 at root
    node_lo: torch.Tensor  # int32 first leaf of the node's range
    node_hi: torch.Tensor  # int32 last leaf of the node's range


def _clz32(x):
    """Count of leading zeros of the low 32 bits of an integer tensor
    (32 for 0).  Integer bit-smearing + popcount: a float log2 rounds
    wrongly next to powers of two."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)  # every bit below the highest set bit is now set
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    bits = ((x * 0x01010101) & 0xFFFFFFFF) >> 24  # popcount = bit length
    return (32 - bits).to(I32)


def make_delta(codes):
    """delta(i, j): common-prefix length of codes i and j; equal codes
    break the tie with 32 + clz(i ^ j); out-of-range j gives -1."""
    n = codes.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        x = codes[i] ^ codes[j.clamp(0, n - 1)]
        d = torch.where(x == 0, 32 + _clz32(i ^ j), _clz32(x))
        return torch.where(valid, d, -1)

    return delta


def karras_children(codes):
    """Children and leaf ranges of every internal node (Karras emit).

    Args:
      codes: [n] int32 *sorted* morton codes (duplicates allowed).

    Returns (child_l, child_r, lo, hi): [n-1] int32 each; children are
    node ids, [lo, hi] the sorted-leaf range the node covers.
    """
    n = codes.shape[0]
    assert n >= 2, "karras_children needs at least 2 leaves"
    delta = make_delta(codes)
    i = torch.arange(n - 1, dtype=I32, device=codes.device)

    # direction: -1 iff delta(i, i+1) < delta(i, i-1)
    d = torch.where(delta(i, i + 1) < delta(i, i - 1), -1, 1).to(I32)
    dmin = delta(i, i - d)

    # exponential upper bound: lmax doubles while the prefix grows
    n_double = max(2, int(math.ceil(math.log2(n))) + 2)
    lmax = torch.full((n - 1,), 2, dtype=I32, device=codes.device)
    stopped = torch.zeros(n - 1, dtype=torch.bool, device=codes.device)
    for _ in range(n_double):
        pred = (delta(i, i + lmax * d) > dmin) & ~stopped
        lmax = torch.where(pred, lmax << 1, lmax)
        stopped = stopped | ~pred

    def halving_search(t, threshold):
        """do { t = (t+1) >> 1; if delta(i, i+(s+t)d) > threshold: s += t }
        while (1 < t)"""
        s = torch.zeros_like(t)
        done = torch.zeros_like(stopped)
        for _ in range(n_double + 2):
            t = torch.where(done, t, (t + 1) >> 1)
            pred = (delta(i, i + (s + t) * d) > threshold) & ~done
            s = torch.where(pred, s + t, s)
            done = done | (t <= 1)
        return s

    l = halving_search(lmax, dmin)  # other end of the range
    j = i + l * d
    s = halving_search(l, delta(i, j))  # split position
    gamma = i + s * d + d.clamp(max=0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    child_l = torch.where(lo == gamma, gamma, gamma + n).to(I32)
    child_r = torch.where(hi == gamma + 1, gamma + 1, gamma + 1 + n).to(I32)
    return child_l, child_r, lo, hi


def build_topology(codes) -> Topology:
    """Full tree topology, arrays sized [2n]; parent[root] = -1."""
    n = codes.shape[0]
    dev = codes.device
    cl, cr, lo, hi = karras_children(codes)
    ids = torch.arange(n - 1, dtype=I32, device=dev) + n
    child_l = torch.full((2 * n,), -1, dtype=I32, device=dev)
    child_r = torch.full((2 * n,), -1, dtype=I32, device=dev)
    child_l[n:2 * n - 1] = cl
    child_r[n:2 * n - 1] = cr
    # every node but the root is exactly one child: unique scatter indices
    parent = torch.full((2 * n,), -1, dtype=I32, device=dev)
    parent[cl.long()] = ids
    parent[cr.long()] = ids
    parent[n].fill_(-1)
    leaf_ids = torch.arange(n, dtype=I32, device=dev)
    zero = torch.zeros(1, dtype=I32, device=dev)
    node_lo = torch.cat([leaf_ids, lo, zero])
    node_hi = torch.cat([leaf_ids, hi, zero])
    return Topology(child_l, child_r, parent, node_lo, node_hi)


def fit_aabbs(node_lo, node_hi, leaf_bbmin, leaf_bbmax):
    """AABB fit as range-min queries over the leaf ranges: a sparse
    table of power-of-two block minima (max rides along negated), then
    two row gathers per internal node.

    Returns (bbmin, bbmax): [2n, 3] (slot 2n-1 an empty box)."""
    n = leaf_bbmin.shape[0]
    dt, dev = leaf_bbmin.dtype, leaf_bbmin.device
    levels = max(1, int(math.ceil(math.log2(n))))

    tables = [torch.cat([leaf_bbmin, -leaf_bbmax], dim=1)]  # [n, 6]
    for k in range(1, levels + 1):
        prev = tables[-1]
        s = 1 << (k - 1)
        shifted = torch.cat(
            [prev[s:], torch.full((s, 6), BIG, dtype=dt, device=dev)])
        tables.append(torch.minimum(prev, shifted))
    stacked = torch.cat(tables)  # [(levels+1)*n, 6]

    lo = node_lo[n:-1].long()
    hi = node_hi[n:-1].long()
    k = (31 - _clz32(hi - lo + 1)).long()  # internal ranges have >= 2 leaves
    a = stacked[k * n + lo]
    b = stacked[k * n + hi + 1 - (1 << k)]
    m = torch.minimum(a, b)

    big = torch.full((1, 3), BIG, dtype=dt, device=dev)
    bbmin = torch.cat([leaf_bbmin, m[:, :3], big])
    bbmax = torch.cat([leaf_bbmax, -m[:, 3:], -big])
    return bbmin, bbmax


def compute_links(topo: Topology, n: int):
    """Skip links for stackless traversal, closed form.

    skip(x) is the topmost node whose range starts at hi(x) + 1 (-1 past
    the last leaf); the topmost node starting at any s > 0 is the unique
    right child starting there, so one scatter of the right children by
    range start plus one gather by hi + 1 yields every link.

    Returns (entry_link, skip_link): [2n] int32; entry = left child for
    internal nodes, = skip for leaves."""
    dev = topo.child_l.device
    ids = torch.arange(2 * n, dtype=I32, device=dev)
    cr = topo.child_r[n:-1]
    cr_start = topo.node_lo[cr.long()]
    topmost = torch.arange(n, dtype=I32, device=dev)
    topmost[cr_start.long()] = cr  # starts are unique (see docstring)
    nxt = torch.clamp(topo.node_hi + 1, max=n - 1).long()
    skip = torch.where(topo.node_hi >= n - 1, -1, topmost[nxt]).to(I32)
    entry = torch.where(ids < n, skip, topo.child_l)
    return entry, skip

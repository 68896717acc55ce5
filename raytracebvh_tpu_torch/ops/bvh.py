"""LBVH construction: Karras-2012 hierarchy emit + AABB fit + skip links
(the JAX package's ``ops/bvh.py`` in torch).

The Karras emit is the range-min emit ``karras_children_rmq``, as in the
JAX package's ``build_topology``: one pass of adjacent deltas, a sparse
table of power-of-two block minima, one binary descent for the range end
and one range-min query for the split.  The plain exponential + binary
search (``karras_children``) stays as its parity oracle; both give the
same bits.  The AABB fit is a sparse-table range-min query over the
contiguous leaf range each internal node covers, and the skip links have
a closed form in range space (see ``compute_links``).

Node ids: leaf k in [0, n), internal node i at id n + i, root = n.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

BIG = 1.0e30  # empty-box sentinel: bbmin = +BIG, bbmax = -BIG
I32 = torch.int32
# the index bits of karras_children_rmq's int32 table keys: it takes up to
# 2^24 + 1 leaves, where its table holds 8.4 GB
KEY_BITS = 24


class Topology(NamedTuple):
    """Tree topology arrays, all sized [2n] (slot 2n-1 unused)."""

    child_l: torch.Tensor  # int32, -1 for leaves
    child_r: torch.Tensor  # int32, -1 for leaves
    parent: torch.Tensor  # int32, -1 at root
    node_lo: torch.Tensor  # int32 first leaf of the node's range
    node_hi: torch.Tensor  # int32 last leaf of the node's range


def _clz32(x):
    """Count of leading zeros of the low 32 bits of an integer tensor
    (32 for 0): 32 minus the binary exponent of the value as a float64,
    which holds every 32-bit integer exactly (a rounded float log2 would
    err next to powers of two)."""
    x = (x.to(torch.int64) & 0xFFFFFFFF).to(torch.float64)
    return (32 - torch.frexp(x).exponent).to(I32)


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


def karras_children_rmq(codes):
    """``karras_children`` by range-min queries: the JAX package's
    production emit, the same outputs bit for bit.

    For sorted codes with the index tie-break, delta(i, j) is the least
    adjacent delta ``a[k] = delta(k, k + 1)`` for k in [min(i, j),
    max(i, j)), so each Karras search becomes a first or last "blocker"
    query over ``a``:

      * the range end: the first k >= i (d = +1), or the last k < i
        (d = -1), with a[k] <= delta(i, i - d);
      * the split: the first (d = +1) or last (d = -1) argmin of ``a``
        over the node's range, which is also where delta(i, j) is taken.

    Both read one sparse table of power-of-two blocks of ``a`` (padded
    with -1 to P, a power of two), built with one shifted elementwise min
    a level.  A block's entry is the int32 key ``a * 2^24 + p``
    (``KEY_BITS``; a is at most 63): the min of the keys is the block's
    min with its first argmin, and a second plane keyed by ``P - 1 - p``
    gives the last argmin, so one ``minimum`` a level builds both planes.
    A block that crosses P holds -2 (the JAX function's shifted-in fill),
    which refuses every step into it; each row carries P cells of that
    fill on its left and P / 2 on its right, so no probe needs a clamp or
    a mask: 2 (log2 P + 1) rows of 2.5 P int32 cells in all (47 MB at
    102 400 leaves).  So P is at most 2^24: more leaves raise
    (``build_topology`` then takes the search).

    The descent is one row gather a level (``index_select``) and four
    elementwise ops, from the top level down: ~5 launches a level,
    ~5 (log2 P + 1) in all, where the JAX function packs four levels into
    one [2P, 16]-row gather for the TPU's per-row gather cost.  With the
    adjacent deltas (two ``_clz32``), the table (one op a level) and the
    two-gather query, the whole emit is ~7 log2 P + 40 ops, on the device
    alone (no host read), so it captures into a CUDA graph.
    """
    n = codes.shape[0]
    assert n >= 2, "karras_children_rmq needs at least 2 leaves"
    if n - 1 > 1 << KEY_BITS:
        raise ValueError(f"karras_children_rmq: {n} leaves; its int32 keys "
                         f"hold at most 2^{KEY_BITS} + 1")
    dev = codes.device

    # adjacent deltas, the index tie-break folded in; length n - 1
    k = torch.arange(n - 1, dtype=I32, device=dev)
    x = codes[:-1] ^ codes[1:]
    adelta = torch.where(x == 0, 32 + _clz32(k ^ (k + 1)), _clz32(x))

    P = 1 << max(1, math.ceil(math.log2(max(n - 1, 2))))
    levels = P.bit_length() - 1
    width = P + P + P // 2  # left fill, the P cells, right fill
    tab = torch.full((2, levels + 1, width), -2 << KEY_BITS, dtype=I32,
                     device=dev)
    body = tab[:, :, P:]
    a_pad = torch.full((P,), -1, dtype=I32, device=dev)
    a_pad[:n - 1] = adelta
    p = torch.arange(P, dtype=I32, device=dev)
    torch.add(a_pad << KEY_BITS, torch.stack([p, P - 1 - p]),
              out=body[:, 0, :P])
    for L in range(1, levels + 1):
        s = 1 << (L - 1)
        prev = body[:, L - 1]
        torch.minimum(prev[:, :P], prev[:, s:P + s], out=body[:, L, :P])

    i = k
    dleft = F.pad(adelta[:-1], (1, 0), value=-1)
    neg = adelta < dleft  # d = -1 iff delta(i, i+1) < delta(i, i-1)
    pos_dir = ~neg
    dneg = neg.to(I32)
    d = 1 - 2 * dneg
    # range end: walk away from i while the block's min exceeds
    # delta(i, i - d); key > T * 2^24 + (2^24 - 1) iff key >= (T + 1) * 2^24
    thresh = (torch.where(neg, adelta, dleft) + 1) << KEY_BITS
    pos = i + P - dneg  # a padded row's index of i (d = +1) or i - 1
    rows = tab[0].unbind(0)
    for L in range(levels, -1, -1):
        # the block [pos, pos + 2^L) for d = +1, (pos - 2^L, pos] for -1
        probe = rows[L].index_select(
            0, torch.add(pos, dneg, alpha=1 - (1 << L)))
        pos = torch.add(pos, (probe >= thresh) * d, alpha=1 << L)
    b = pos - P  # the blocker, or -1 / P where the walk left the array
    j = torch.where(neg, torch.clamp(b, min=-1) + 1, torch.clamp(b, max=n - 1))
    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)

    # the split: the direction-sided argmin of a[lo .. hi - 1], from the two
    # blocks of 2^kl that cover it
    kl = torch.frexp((hi - lo).to(torch.float64)).exponent - 1
    row = kl * width + P
    flat = tab.view(2, -1)
    first = flat.index_select(1, row + lo)
    second = flat.index_select(1, row + hi - (1 << kl))
    arg = torch.minimum(first, second) & ((1 << KEY_BITS) - 1)
    gamma = torch.where(pos_dir, arg[0], P - 1 - arg[1]).to(I32)
    gamma = torch.clamp(gamma, lo, hi - 1)

    child_l = torch.where(lo == gamma, gamma, gamma + n).to(I32)
    child_r = torch.where(hi == gamma + 1, gamma + 1, gamma + 1 + n).to(I32)
    return child_l, child_r, lo, hi


def build_topology(codes) -> Topology:
    """Full tree topology, arrays sized [2n]; parent[root] = -1.  The
    range-min emit, or the search past its 2^24 + 1 leaves."""
    n = codes.shape[0]
    dev = codes.device
    emit = (karras_children_rmq if n - 1 <= 1 << KEY_BITS
            else karras_children)
    cl, cr, lo, hi = emit(codes)
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

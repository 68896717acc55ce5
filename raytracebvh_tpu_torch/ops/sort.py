"""Sort leaves by morton code (the JAX package's ``ops/sort.py``):
``sort_by_code`` (``lax.sort`` becomes a stable ``torch.sort``) and
``radix_sort_by_code``, the reference's 1-bit LSD radix sort, pass for
pass (``sort_backend='radix'``; also an oracle of kernel K8,
``ops/sort_cuda``)."""

from __future__ import annotations

import torch


def sort_by_code(codes):
    """Stable-sort ``codes`` ascending; returns (sorted_codes, order),
    both int32.  ``order[k]`` is the pre-sort leaf index at slot ``k``;
    stability keeps equal codes in ascending index order, which the
    Karras build's index tie-break relies on."""
    sorted_codes, order = torch.sort(codes, stable=True)
    return sorted_codes, order.to(torch.int32)


def radix_sort_by_code(codes, bits: int = 30):
    """The reference's 1-bit LSD radix sort of non-negative int32
    ``codes`` (RadixSortP1/P2.hlsl): per pass p, read bit p, exclusive-scan
    the inverted bits, and scatter zeros before ones.  Each pass is
    stable, so the result is ``sort_by_code``'s (sorted_codes, order),
    both int32."""
    n = codes.shape[0]
    dev = codes.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    codes = codes.to(torch.int32)
    if n == 0:
        return codes, order
    for p in range(bits):
        zero = 1 - ((codes >> p) & 1).to(torch.int64)
        zeros_before = torch.cumsum(zero, 0) - zero  # exclusive scan
        net_zeros = zeros_before[-1] + zero[-1]
        dst = torch.where(zero == 1, zeros_before,
                          net_zeros + pos - zeros_before)
        codes = torch.empty_like(codes).index_copy_(0, dst, codes)
        order = torch.empty_like(order).index_copy_(0, dst, order)
    return codes, order

"""Sort leaves by morton code (the JAX package's ``ops/sort.py``
``sort_by_code``; ``lax.sort`` becomes a stable ``torch.sort``)."""

from __future__ import annotations

import torch


def sort_by_code(codes):
    """Stable-sort ``codes`` ascending; returns (sorted_codes, order),
    both int32.  ``order[k]`` is the pre-sort leaf index at slot ``k``;
    stability keeps equal codes in ascending index order, which the
    Karras build's index tie-break relies on."""
    sorted_codes, order = torch.sort(codes, stable=True)
    return sorted_codes, order.to(torch.int32)

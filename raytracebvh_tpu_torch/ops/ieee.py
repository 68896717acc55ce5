"""Arithmetic that rounds the same on the CPU, on CUDA and in the JAX
package: one IEEE operation, correctly rounded."""

from __future__ import annotations

import torch


def sqrt(x):
    """Correctly rounded square root, as JAX's and CUDA's are: PyTorch's
    vectorized float32 sqrt on the CPU is not always (a float64 root
    rounded to float32 is)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def div(x, s: float):
    """``x / s`` for a Python scalar ``s`` as one IEEE division: CUDA
    turns division by a Python scalar into a multiply by its reciprocal,
    which rounds differently unless ``s`` is a power of two."""
    return x / x.new_full((), s)

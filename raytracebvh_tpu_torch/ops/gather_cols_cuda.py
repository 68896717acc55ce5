"""Column gather from a channel-major table, ``out[c, r] = tbl[c, idx[r]]``:
kernel K7 (``csrc/gather_cols.cu``), which replaces the JAX package's
in-VMEM table gather (``ops/gather_pallas.py`` ``gather_rows``, kernel
``_gather_kernel``), and its plain PyTorch version.

It serves the shading pass's leaf-attribute lookup for
``shade_gather_backend='shared'`` (the JAX package's ``'pallas'``) on the
``[40, n]`` transpose of the leaf-attribute table.  An index outside
``[0, width)`` gives 0, as the TPU kernel's zeroed scratch does.  On CUDA
its backward is kernel K3 (``gather_cuda.scatter_add_rows``) on the same
gradient and ids, returned as ``[C, width]``, as the TPU kernel's
custom_vjp takes ``_scatter_add_kernel``.
"""

from __future__ import annotations

import torch

from .. import _kernels
from . import gather_cuda

# K7 launches (chip_smoke.py checks the main path reaches it); a CUDA
# graph's capture counts, its replays do not (they skip this wrapper)
launches = 0


def gather_cols_torch(tbl, idx):
    """The plain version: [C, width] table, [R] int indices -> [C, R] (the
    table's dtype and autograd graph kept)."""
    valid = (idx >= 0) & (idx < tbl.shape[1])
    cols = tbl[:, torch.where(valid, idx, 0).long()]
    return torch.where(valid[None, :], cols, 0.0)


def _launch(tbl, idx):
    if (tbl.dtype != torch.float32 or tbl.dim() != 2
            or not tbl.is_contiguous()):
        raise ValueError("gather_cols: table must be a contiguous [C, width] "
                         f"float32 tensor; got {tbl.dtype} {tuple(tbl.shape)}")
    gather_cuda._check_ids(idx, "gather_cols")
    c, width = tbl.shape
    if c > 65535:
        raise ValueError(f"gather_cols: {c} channels (at most 65 535)")
    nrays = idx.shape[0]
    out = torch.empty((c, nrays), dtype=torch.float32, device=tbl.device)
    if nrays == 0 or c == 0:
        return out
    global launches
    with torch.cuda.device(tbl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.load().rtbvh_gather_cols_f32(
            tbl.data_ptr(), c, width, idx.data_ptr(), nrays, out.data_ptr(),
            stream)
    _kernels.check(err, "K7 gather_cols launch")
    launches += 1
    return out


class _GatherCols(torch.autograd.Function):
    """K7 forward, K3 backward."""

    @staticmethod
    def forward(ctx, tbl, idx):
        ctx.save_for_backward(idx)
        ctx.width = tbl.shape[1]
        return _launch(tbl, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_cuda.scatter_add_rows(g.contiguous(), idx,
                                            ctx.width).t(), None


def gather_cols(tbl, idx):
    """K7: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``tbl`` is a contiguous [C, width] float32 table, ``idx`` a
    contiguous [R] int32 tensor on the same device.  Returns [C, R]
    float32.  On CUDA the table's gradient is kernel K3.  A bfloat16 or
    float16 table goes through the kernel as float32 (an exact cast) and
    returns its own dtype, as ``gather_cuda.gather_rows`` does."""
    if tbl.device.type == "cpu" and idx.device.type == "cpu":
        return gather_cols_torch(tbl, idx)
    if tbl.device.type != "cuda" or idx.device != tbl.device:
        raise ValueError(
            f"gather_cols: table on {tbl.device}, indices on {idx.device}")
    if tbl.dtype in gather_cuda.HALF_FLOATS:
        return _GatherCols.apply(tbl.float(), idx).to(tbl.dtype)
    return _GatherCols.apply(tbl, idx)

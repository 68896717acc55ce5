"""Checkpoint / resume for inverse-rendering training state (the JAX
package's ``utils/checkpoint.py``, file-compatible with it both ways).

A checkpoint is a ``.npz`` of leaves ``leaf_0``, ``leaf_1``, ... in the
order ``jax.tree_util.tree_flatten`` gives the same tree: tuples, lists
and NamedTuples by position, dicts by sorted key, ``None`` as no leaf,
anything else one leaf.  This module flattens the port's trees in that
order itself (numpy only): the training state ``(params, opt_state,
step)``, with ``opt_state`` in optax's Adam layout
(``models.inverse.adam_state``), is the JAX package's 11 leaves.

Leaves are written as numpy arrays (torch tensors copied to the host).
The treedef is not stored; ``restore_checkpoint`` takes a ``like`` tree
of the same structure, as the JAX function does.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, List, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (an iterator) in
    ``tree_leaves``' order."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(tree_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(tree_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        out = {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, tree: Any) -> None:
    """Atomically write ``tree`` (a tree of tensors, arrays and scalars)
    to ``path``: a temporary file in the target directory, then
    ``os.replace``; the temporary file is removed on failure."""
    arrs = {f"leaf_{i}": _host(x) for i, x in enumerate(tree_leaves(tree))}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_checkpoint(path: str, like: Any) -> Optional[Any]:
    """Restore a tree with the structure of ``like`` from ``path``;
    returns None when the file does not exist and raises when the number
    of leaves differs.  Array and tensor leaves come back as numpy arrays
    (``models.inverse.params_from_numpy`` and ``optimizer_from_numpy``
    put them on a device); scalar leaves (Python or numpy scalars) as
    their own type."""
    if not os.path.isfile(path):
        return None
    leaves = tree_leaves(like)
    with np.load(path) as z:
        if len(z.files) != len(leaves):
            raise ValueError(
                f"{path}: {len(z.files)} leaves on disk, "
                f"{len(leaves)} expected"
            )
        new = [z[f"leaf_{i}"] for i in range(len(leaves))]
    out = []
    for old, arr in zip(leaves, new):
        if np.ndim(old) == 0 and not isinstance(old, (np.ndarray,
                                                      torch.Tensor)):
            out.append(type(old)(arr.item()))
        else:
            out.append(arr)
    return tree_unflatten(like, iter(out))

"""Shared primitives of the GAR library (counterpart of
``garfield_tpu/aggregators/_common.py``): stack normalization and the
per-leaf plumbing of the coordinate-wise rules.

A stacked gradient tree is a dict ``name -> tensor`` whose leaves carry a
leading n (worker) axis."""

import torch

__all__ = [
    "as_stack",
    "num_gradients",
    "tree_coordinatewise",
    "coordinate_median",
]


def as_stack(gradients):
    """Normalize input to an (n, d) stacked tensor: a list of tensors is
    flattened and stacked; a tensor must already be 2-D."""
    if isinstance(gradients, (list, tuple)):
        return torch.stack([torch.as_tensor(g).reshape(-1) for g in gradients])
    g = torch.as_tensor(gradients)
    if g.ndim != 2:
        raise ValueError(f"expected (n, d) gradient stack, got shape {tuple(g.shape)}")
    return g


def num_gradients(gradients):
    """Number of gradients n (leading dim or list length)."""
    if isinstance(gradients, (list, tuple)):
        return len(gradients)
    return int(gradients.shape[0])


def tree_coordinatewise(fn, stacked_tree, extra_tree=None):
    """Apply a coordinate-wise reducer per leaf of a stacked tree: each leaf
    is reshaped to (n, size) and ``fn(rows)`` (or ``fn(rows, extra_rows)``
    when ``extra_tree`` holds the matching (size,)-shaped extra row) gives
    its (size,) aggregate. The (n, d) flat stack is never built."""
    out = {}
    for name, leaf in stacked_tree.items():
        rows = leaf.reshape(leaf.shape[0], -1)
        if extra_tree is None:
            agg = fn(rows)
        else:
            agg = fn(rows, extra_tree[name].reshape(1, -1))
        out[name] = agg.reshape(leaf.shape[1:])
    return out


def coordinate_median(g):
    """Lower coordinate-wise median of an (n, d) stack -> (d,): torch's
    ``median(dim=0)`` order statistic with NaN sorted last, so up to
    ceil(n/2)-1 NaNs per coordinate do not reach the result. The CUDA
    kernel on the card, its plain version on the CPU (``ops``)."""
    from .. import ops

    return ops.coordinate_median(g)

"""Coordinate-wise trimmed-mean GAR (counterpart of
``garfield_tpu/aggregators/tmean.py``): per coordinate, drop the f largest
and f smallest values and average the middle n-2f. NaN sorts last, so up to
f NaNs per coordinate land in the trimmed tail."""

import math

from . import register
from ._common import as_stack, num_gradients, tree_coordinatewise


def aggregate(gradients, f, **kwargs):
    """Mean of the middle n-2f values per coordinate."""
    from .. import ops

    return ops.trimmed_mean(as_stack(gradients), f)


def tree_aggregate(stacked_tree, f, **kwargs):
    """Per-leaf trimmed mean of a stacked tree (one kernel launch per leaf)."""
    from .. import ops

    return tree_coordinatewise(lambda g: ops.trimmed_mean(g, f), stacked_tree)


def tree_aggregate_ext(stacked_tree, row_map, row_scale, f, extra=None,
                       **kwargs):
    """Folded-attack form: per-leaf trimmed mean under the static row remap
    (see ``median.tree_aggregate_ext``)."""
    from .. import ops

    def one(rows, extra_rows=None):
        return ops.trimmed_mean(
            rows, f, row_map=row_map, row_scale=row_scale, extra=extra_rows
        )

    return tree_coordinatewise(one, stacked_tree, extra)


def check(gradients, f, **kwargs):
    n = num_gradients(gradients)
    if n < 1:
        return f"expected at least one gradient to aggregate, got {gradients!r}"
    if not isinstance(f, int) or f < 1 or n < 2 * f + 1:
        return (
            f"invalid number of Byzantine gradients to tolerate, got f = {f!r}, "
            f"expected 1 <= f <= {(n - 1) // 2}"
        )
    return None


def upper_bound(n, f, d):
    """Same family bound as the coordinate-wise median, 1/sqrt(n - f)."""
    return 1 / math.sqrt(n - f)


register("tmean", aggregate, check, upper_bound=upper_bound,
         tree_aggregate=tree_aggregate, tree_aggregate_ext=tree_aggregate_ext)

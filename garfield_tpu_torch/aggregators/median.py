"""NaN-resilient coordinate-wise median GAR (counterpart of
``garfield_tpu/aggregators/median.py``): the lower median per coordinate,
upper bound 1/sqrt(n-f)."""

import math

from . import register
from ._common import (
    as_stack, coordinate_median, num_gradients, tree_coordinatewise,
)


def aggregate(gradients, **kwargs):
    """NaN-resilient coordinate-wise (lower) median."""
    return coordinate_median(as_stack(gradients))


def tree_aggregate(stacked_tree, **kwargs):
    """Per-leaf median of a stacked tree: the rule is coordinate-wise, so the
    flat stack is never built (one kernel launch per leaf)."""
    return tree_coordinatewise(coordinate_median, stacked_tree)


def tree_aggregate_ext(stacked_tree, row_map, row_scale, extra=None,
                       **kwargs):
    """Folded-attack form: per-leaf median under the attack's static row
    remap, applied in registers by the kernel; ``extra`` holds the attack's
    shared fake row per leaf, addressed by the remap as row n."""
    from .. import ops

    def one(rows, extra_rows=None):
        return ops.coordinate_median(
            rows, row_map=row_map, row_scale=row_scale, extra=extra_rows
        )

    return tree_coordinatewise(one, stacked_tree, extra)


def check(gradients, **kwargs):
    if num_gradients(gradients) < 1:
        return f"expected at least one gradient to aggregate, got {gradients!r}"
    return None


def upper_bound(n, f, d):
    """Variance/norm ratio bound 1/sqrt(n-f)."""
    return 1 / math.sqrt(n - f)


register("median", aggregate, check, upper_bound=upper_bound,
         tree_aggregate=tree_aggregate, tree_aggregate_ext=tree_aggregate_ext)

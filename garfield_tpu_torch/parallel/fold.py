"""Folded attack+GAR path: the attack as a static row remap, never as rows.

Counterpart of ``garfield_tpu/parallel/fold.py`` for its coordinate-wise
branch. A deterministic attack's poisoned stack is

  poisoned row i == row_scale[i] * extended_stack[row_map[i]]

where ``extended_stack`` is the raw stack plus at most one shared fake row
(lie's mu + z*sigma, empire's -eps*mu). The coordinate-wise rules (median,
tmean) take the remap and the fake row straight into their kernels
(``tree_aggregate_ext``), so neither the poisoned stack nor the (n+1, d)
extended stack is ever written; zero scales (crash) load exact zeros.

The Gram branch (krum, average, Bulyan and cclip's forms) comes with the
next slice of the port.
"""

import numpy as np

from ..attacks import plan_gradient_attack_fold

__all__ = ["plan_for", "folded_tree_aggregate"]

_GRAM_BRANCH = (
    "the Gram branch of the fold (krum/average/bulyan) comes with the next "
    "slice of the port: ROADMAP Queue A item 1"
)


def plan_for(gar, attack, byz_mask, attack_params):
    """Fold eligibility gate: a plan exists iff the rule has the
    coordinate-wise folded form (``tree_aggregate_ext``) and the attack
    folds (with at least one Byzantine slot). ``byz_mask`` must be
    concrete: the plan is static."""
    if gar.tree_aggregate_ext is None:
        return None
    return plan_gradient_attack_fold(
        attack, np.asarray(byz_mask, dtype=bool), **attack_params
    )


def folded_tree_aggregate(gar, plan, stacked_tree, *, f, gar_params=None):
    """Aggregate a stacked gradient tree under a folded attack plan.

    Equal in exact arithmetic to ``gar.tree_aggregate`` of the where-path
    poisoned tree. ``stacked_tree`` is a dict of leaves with a leading n
    axis; returns the dict of aggregated leaves."""
    if gar.tree_aggregate_ext is None:
        raise NotImplementedError(f"{gar.name!r}: {_GRAM_BRANCH}")
    extra = None
    if plan.build_extra is not None:
        extra = plan.build_extra(stacked_tree)
    return gar.tree_aggregate_ext(
        stacked_tree, plan.row_map, plan.row_scale, extra=extra, f=f,
        **dict(gar_params or {}),
    )

"""Robust Gradient Aggregation Rule (GAR) registry.

Counterpart of ``garfield_tpu/aggregators/__init__.py``: ``register`` lets
each rule module self-register, ``gars`` maps names to rules, and each rule
carries ``checked``/``unchecked``, ``check``, ``upper_bound`` and its
tree-mode forms (``tree_aggregate``, ``tree_aggregate_ext``).

Only the coordinate-wise rules of the first slice of the port are
registered: ``median`` and ``tmean``. ``UNPORTED`` names the JAX package's
other rules with the ROADMAP item that brings each.
"""

__all__ = ["GAR", "gars", "register", "UNPORTED"]

# JAX-package rules that the port does not have yet -> the ROADMAP item.
UNPORTED = {
    "average": "ROADMAP Queue A item 1 (krum/average and the Gram fold)",
    "krum": "ROADMAP Queue A item 1 (krum/average and the Gram fold)",
    "brute": "ROADMAP Queue A item 1 (krum/average and the Gram fold)",
    "bulyan": "ROADMAP Queue A item 2 (Bulyan and _avgmed_kernel)",
    "aksel": "ROADMAP Queue A item 5 (the other rules)",
    "cclip": "ROADMAP Queue A item 5 (the other rules)",
    "condense": "ROADMAP Queue A item 5 (the other rules)",
}


class GAR:
    """A registered aggregation rule.

    ``unchecked`` is the raw rule, ``checked`` validates with ``check``
    first; calling the GAR dispatches to ``checked`` under ``__debug__``.
    ``tree_aggregate(stacked_tree, f=...)`` aggregates a dict of stacked
    leaves (leading n axis) per leaf; ``tree_aggregate_ext(stacked_tree,
    row_map, row_scale, extra=..., f=...)`` does so under a folded attack's
    static row remap, the extra (fake) rows passed beside the stack.
    """

    def __init__(self, name, unchecked, check, upper_bound=None,
                 tree_aggregate=None, tree_aggregate_ext=None):
        self.name = name
        self.unchecked = unchecked
        self.check = check
        self.upper_bound = upper_bound
        self.tree_aggregate = tree_aggregate
        self.tree_aggregate_ext = tree_aggregate_ext

        def checked(gradients, *args, **kwargs):
            message = check(gradients, *args, **kwargs)
            if message is not None:
                raise AssertionError(
                    f"aggregation rule {name!r} cannot be used: {message}"
                )
            return unchecked(gradients, *args, **kwargs)

        self.checked = checked
        self._call = checked if __debug__ else unchecked

    def __call__(self, gradients, *args, **kwargs):
        return self._call(gradients, *args, **kwargs)

    def __repr__(self):
        return f"<GAR {self.name}>"


gars = {}


def register(name, unchecked, check, upper_bound=None, tree_aggregate=None,
             tree_aggregate_ext=None):
    """Register an aggregation rule under ``name``."""
    gar = GAR(name, unchecked, check, upper_bound=upper_bound,
              tree_aggregate=tree_aggregate,
              tree_aggregate_ext=tree_aggregate_ext)
    gars[name] = gar
    return gar


def resolve(gar):
    """A GAR from a name or a GAR; a JAX-package rule the port lacks raises
    ``NotImplementedError`` naming the ROADMAP item that brings it."""
    if isinstance(gar, GAR):
        return gar
    if gar in gars:
        return gars[gar]
    if gar in UNPORTED:
        raise NotImplementedError(
            f"GAR {gar!r} is not ported yet: {UNPORTED[gar]}"
        )
    raise ValueError(f"unknown GAR {gar!r}; available: {sorted(gars)}")


from . import median, tmean  # noqa: E402,F401  (self-registering rules)

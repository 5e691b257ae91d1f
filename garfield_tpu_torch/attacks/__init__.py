"""Byzantine gradient attacks as value transforms of the stacked gradients.

Counterpart of ``garfield_tpu/attacks/__init__.py`` for the deterministic
attacks of the first slice: every worker slot computes an honest gradient,
then the rows selected by a boolean ``byz_mask`` are rewritten.

Two application paths, equal in exact arithmetic:

  - the where-path (``apply_gradient_attack_tree``): the poisoned rows are
    written into the stacked tree, leaf by leaf;
  - the folded path (``plan_gradient_attack_fold``): a static row remap and
    scale, plus at most one shared fake row built in f32
    (``_shared_fake_builder``), which the coordinate-wise kernels apply in
    registers (``parallel/fold.py``), so no poisoned row is written.

``random`` and ``drop`` (the randomized attacks) and the adaptive and
targeted families are not ported yet (ROADMAP Queue A item 6).
"""

import numpy as np
import torch

__all__ = [
    "LIE_Z",
    "EMPIRE_EPS",
    "REVERSE_FACTOR",
    "gradient_attacks",
    "apply_gradient_attack_tree",
    "GradientAttackFold",
    "plan_gradient_attack_fold",
]

# Reference attack defaults (byzWorker.py:108-143), shared by the direct
# attack functions AND the folded-plan builder so the two application paths
# cannot drift apart.
LIE_Z = 1.035
EMPIRE_EPS = 10.0
REVERSE_FACTOR = -100.0

_UNPORTED = {
    "random": "ROADMAP Queue A item 6 (randomized attacks)",
    "drop": "ROADMAP Queue A item 6 (randomized attacks)",
    "adaptive-lie": "ROADMAP Queue A item 9 (threat and defense planes)",
    "adaptive-empire": "ROADMAP Queue A item 9 (threat and defense planes)",
    "labelflip": "ROADMAP Queue A item 9 (threat and defense planes)",
    "backdoor": "ROADMAP Queue A item 9 (threat and defense planes)",
}


def _masked_moments(g, mask):
    """Mean and Bessel-corrected std over the rows of ``g`` where ``mask``
    (torch.mean/torch.std over the colluding cohort, byzWorker.py:119-121);
    a cohort of one gives sigma = NaN, as torch does."""
    w = mask.to(g.dtype)[:, None]
    count = w.sum()
    mu = (w * g).sum(0) / count
    var = (w * (g - mu[None, :]) ** 2).sum(0) / (count - 1.0)
    return mu, torch.sqrt(var)


def reverse_attack(g, mask, *, factor=REVERSE_FACTOR, **_):
    """Amplified sign flip: grad * -100 (byzWorker.py:87-94)."""
    return torch.where(mask[:, None], g * factor, g)


def lie_attack(g, mask, *, z=LIE_Z, **_):
    """Little is enough: mu + z*sigma over the colluding cohort's honest
    gradients (byzWorker.py:108-125)."""
    mu, sigma = _masked_moments(g, mask)
    fake = mu + z * sigma
    return torch.where(mask[:, None], fake[None, :], g)


def empire_attack(g, mask, *, eps=EMPIRE_EPS, **_):
    """Fall of empires: -eps * mu over the colluding cohort
    (byzWorker.py:127-143)."""
    mu, _ = _masked_moments(g, mask)
    fake = -eps * mu
    return torch.where(mask[:, None], fake[None, :], g)


def crash_attack(g, mask, **_):
    """Crash fault: the dead slots contribute all-zero gradients."""
    return torch.where(mask[:, None], torch.zeros((), dtype=g.dtype,
                                                  device=g.device), g)


gradient_attacks = {
    "reverse": reverse_attack,
    "lie": lie_attack,
    "empire": empire_attack,
    "crash": crash_attack,
}


def _resolve_gradient_attack(attack):
    if attack in _UNPORTED:
        raise NotImplementedError(
            f"attack {attack!r} is not ported yet: {_UNPORTED[attack]}"
        )
    if attack not in gradient_attacks:
        raise ValueError(
            f"unknown attack {attack!r}; available: {sorted(gradient_attacks)}"
        )
    return gradient_attacks[attack]


def check_attack(attack):
    """Raise unless ``attack`` is None, "none" or a ported attack."""
    if attack is not None and attack != "none":
        _resolve_gradient_attack(attack)


def apply_gradient_attack_tree(attack, grads_tree, byz_mask, **params):
    """Poison the Byzantine rows of a stacked gradient tree leaf by leaf.

    Every ported attack is coordinate-wise given the cohort's per-coordinate
    row statistics, so applying it to each leaf reshaped to (n, size) equals
    applying it to the flat stack. ``params`` are the attack knobs (z, eps,
    factor) with the reference defaults."""
    if attack is None or attack == "none":
        return grads_tree
    fn = _resolve_gradient_attack(attack)
    out = {}
    for name, leaf in grads_tree.items():
        mask = torch.as_tensor(np.asarray(byz_mask, bool), device=leaf.device)
        flat = leaf.reshape(leaf.shape[0], -1)
        out[name] = fn(flat, mask, **params).reshape(leaf.shape)
    return out


class GradientAttackFold:
    """Static plan for applying a gradient attack inside a rule.

    Poisoned row i == ``row_scale[i] * extended[row_map[i]]``, where
    ``extended`` is the raw stack with ``num_extra`` (0 or 1) shared fake
    rows appended. ``build_extra(stacked_tree)`` builds the fake row tree
    (one (size,)-shaped row per leaf, in the leaf dtype) or is None."""

    def __init__(self, row_map, row_scale, build_extra=None):
        self.row_map = np.asarray(row_map, dtype=np.int32)
        self.row_scale = np.asarray(row_scale, dtype=np.float32)
        self.build_extra = build_extra
        self.num_extra = 1 if build_extra is not None else 0


def _shared_fake_builder(byz_idx, count, transform):
    """Per-leaf shared fake row from the Byzantine cohort's honest rows.
    Moments accumulate in f32 (Bessel-corrected); the row is cast to the
    leaf dtype. In f32 this agrees with ``_masked_moments`` to rounding; in
    bf16 it is the better of the two and the paths agree only to bf16
    rounding."""
    idx = torch.as_tensor(np.asarray(byz_idx, np.int64))

    def build_extra(stacked_tree):
        out = {}
        for name, leaf in stacked_tree.items():
            s = leaf.index_select(0, idx.to(leaf.device)).float()
            mu = s.sum(0) / count
            var = ((s - mu[None]) ** 2).sum(0) / (count - 1.0)
            out[name] = transform(mu, torch.sqrt(var)).to(leaf.dtype)
        return out

    return build_extra


def plan_gradient_attack_fold(attack, byz_mask, *, z=LIE_Z, eps=EMPIRE_EPS,
                              factor=REVERSE_FACTOR, **_):
    """The ``GradientAttackFold`` of ``attack``, or None when there is
    nothing to fold (no attack, or no Byzantine slot)."""
    if attack is None or attack == "none":
        return None
    _resolve_gradient_attack(attack)
    mask = np.asarray(byz_mask, dtype=bool)
    n = mask.size
    byz_idx = np.flatnonzero(mask)
    if byz_idx.size == 0:
        return None
    identity = np.arange(n)
    ones = np.ones(n)
    if attack == "lie":
        return GradientAttackFold(
            np.where(mask, n, identity), ones,
            _shared_fake_builder(
                byz_idx, float(byz_idx.size),
                lambda mu, sigma: mu + z * sigma,
            ),
        )
    if attack == "empire":
        return GradientAttackFold(
            np.where(mask, n, identity), ones,
            _shared_fake_builder(
                byz_idx, float(byz_idx.size), lambda mu, sigma: -eps * mu
            ),
        )
    if attack == "reverse":
        return GradientAttackFold(identity, np.where(mask, factor, 1.0))
    return GradientAttackFold(identity, np.where(mask, 0.0, 1.0))  # crash

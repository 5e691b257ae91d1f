"""Loss and optimizer selectors (counterpart of
``garfield_tpu/utils/selectors.py``)."""

import torch
import torch.nn.functional as F

__all__ = ["select_loss", "select_optimizer"]

_LATER = "ROADMAP Queue A item 12 (the rest)"


def select_loss(name):
    """``loss_fn(outputs, labels) -> scalar`` by name: ``nll`` (expects
    log-probabilities) or ``cross-entropy`` / ``crossentropy`` / ``ce``
    (expects raw logits); both average over the batch."""
    name = name.lower()
    if name == "nll":
        def nll(log_probs, labels):
            return F.nll_loss(log_probs, labels.long())
        return nll
    if name in ("cross-entropy", "crossentropy", "ce"):
        def ce(logits, labels):
            return F.cross_entropy(logits, labels.long())
        return ce
    if name in ("bce", "binary-cross-entropy", "bce-logits",
                "bce-with-logits"):
        raise NotImplementedError(f"loss {name!r} is not ported yet: {_LATER}")
    raise ValueError(
        f"unknown loss {name!r}; available: nll, cross-entropy"
    )


def select_optimizer(name, *, lr, momentum=0.0, weight_decay=0.0, **kwargs):
    """A factory ``params -> torch.optim.Optimizer`` by name.

    ``sgd`` only: ``torch.optim.SGD`` with coupled weight decay is the JAX
    package's ``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``
    update (g + wd*p into the momentum trace, then p -= lr * trace)."""
    name = name.lower()
    if name in ("adam", "adamw", "rmsprop", "adagrad"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: {_LATER}"
        )
    if name != "sgd":
        raise ValueError(
            f"unknown optimizer {name!r}; available: sgd, adam, adamw, "
            "rmsprop, adagrad"
        )
    if callable(lr):
        raise NotImplementedError(f"learning-rate schedules: {_LATER}")
    if kwargs:
        raise TypeError(f"sgd takes lr, momentum, weight_decay; got {kwargs}")

    def make(params):
        return torch.optim.SGD(params, lr=float(lr), momentum=momentum,
                               weight_decay=weight_decay)

    return make

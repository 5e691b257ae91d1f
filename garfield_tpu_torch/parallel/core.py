"""Training core of the port (counterpart of ``garfield_tpu/parallel/core.py``).

  - ``TrainState``: the server's state. PyTorch updates in place, so the
    state holds the live tensors: ``params`` and ``model_state`` are the
    module's parameters and BN running statistics by name, ``opt_state``
    the optimizer (its momentum buffers), ``rng`` the generator the
    parameters were drawn from.
  - ``make_worker_fns``: the Worker role on an ``nn.Module``: forward and
    backward on one minibatch, gradients by parameter name, and each BN
    layer's new running statistics from its own copy of the state.
  - ``per_slot_grads``: the logical worker slots as an unroll, one
    forward+backward per slot, the gradients stacked per leaf into (n, ...).
  - ``cast_leaves``/``cast_like``, ``mean_model_state``, ``default_byz_mask``.

A tree is a dict ``name -> tensor``.
"""

import dataclasses

import numpy as np
import torch

from ..models._layers import BatchNorm, init_parameters

__all__ = [
    "TrainState",
    "make_worker_fns",
    "per_slot_grads",
    "cast_leaves",
    "cast_like",
    "mean_model_state",
    "default_byz_mask",
]


@dataclasses.dataclass
class TrainState:
    """Server state; ``step_fn`` advances it in place and returns it."""

    step: int
    params: dict
    model_state: dict
    opt_state: torch.optim.Optimizer
    rng: torch.Generator


def _bn_layers(module):
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, BatchNorm)]


def make_worker_fns(module, loss_fn):
    """``(init_fn, grad_fn, eval_fn)`` for an ``nn.Module``:

      - ``init_fn(generator, device) -> (params, model_state)`` draws the
        parameters from ``generator`` (a CPU generator, so a seed gives the
        same weights on every device) and moves the module to ``device``;
      - ``grad_fn(x, y) -> (grads, (loss, new_ms))`` on one NCHW batch:
        gradients by parameter name, the loss, and the BN layers' new
        running statistics (the module's own are left as they were);
      - ``eval_fn(x) -> logits`` with the running statistics.
    """
    bn_layers = _bn_layers(module)

    def init_fn(generator, device):
        init_parameters(module, generator)
        module.to(device)
        return dict(module.named_parameters()), dict(module.named_buffers())

    def grad_fn(x, y):
        module.train()
        names, params = zip(*module.named_parameters())
        loss = loss_fn(module(x), y)
        grads = torch.autograd.grad(loss, params)
        new_ms = {}
        for prefix, bn in bn_layers:
            mean, var = bn.updated_stats()
            new_ms[f"{prefix}.running_mean"] = mean
            new_ms[f"{prefix}.running_var"] = var
        return dict(zip(names, grads)), (loss.detach(), new_ms)

    @torch.no_grad()
    def eval_fn(x):
        module.eval()
        return module(x)

    return init_fn, grad_fn, eval_fn


def per_slot_grads(grad_fn, x, y):
    """Per-slot gradients over the leading logical-slot axis of ``x``/``y``,
    as an unroll: ``(grads, (losses, stacked_ms))`` with a leading slot axis
    on every leaf, what the JAX package's ``vmap(grad_fn)`` returns."""
    outs = [grad_fn(x[k], y[k]) for k in range(x.shape[0])]
    grads = {name: torch.stack([g[name] for g, _ in outs])
             for name in outs[0][0]}
    losses = torch.stack([loss for _, (loss, _) in outs])
    stacked_ms = {name: torch.stack([ms[name] for _, (_, ms) in outs])
                  for name in outs[0][1][1]}
    return grads, (losses, stacked_ms)


def cast_leaves(tree, dtype):
    """Every leaf cast to ``dtype`` (no-op when dtype is None): the narrow
    aggregation pipeline's cast-in."""
    if dtype is None:
        return tree
    return {name: leaf.to(dtype) for name, leaf in tree.items()}


def cast_like(tree, ref_tree):
    """Every leaf cast to the dtype of the matching ``ref_tree`` leaf: the
    cast back at the optimizer boundary."""
    return {name: leaf.to(ref_tree[name].dtype) for name, leaf in tree.items()}


def mean_model_state(stacked_ms):
    """Average per-worker BN running statistics over the slot axis."""
    return {name: leaf.mean(0) for name, leaf in stacked_ms.items()}


def default_byz_mask(n, f):
    """Boolean (n,) mask with the LAST f slots Byzantine (the reference's
    rank layout: Byzantine workers are the highest ranks)."""
    mask = np.zeros(n, dtype=bool)
    if f:
        mask[n - f:] = True
    return mask

"""AggregaThor topology: one trusted server, n workers, f Byzantine.

Counterpart of ``garfield_tpu/parallel/aggregathor.py``, its tree path on one
device. The round trip of the reference's parameter server is

    grads  = per_slot_grads(worker, batches)     # worker.py:77-96
    grads  = cast(grads, gar_dtype)              # narrow aggregation pipeline
    aggr   = fold(gar, attack plan, grads)       # byzWorker.py + trainer.py:236
    params = optimizer(params, aggr)             # server.py:277-287

Deterministic attacks (lie, empire, reverse, crash) on the coordinate-wise
rules take the folded path (``parallel.fold``): the kernels apply the
attack's row remap in registers. Without a fold plan (no attack, or no
Byzantine slot) the where-path runs: ``apply_gradient_attack_tree``, then
``gar.tree_aggregate``.

Batches keep the JAX package's layout at this boundary: ``x`` is
``(num_workers, batch, H, W, C)`` (NHWC) and is permuted to NCHW inside.
"""

import numpy as np
import torch

from .. import aggregators
from ..attacks import apply_gradient_attack_tree, check_attack
from ..utils.tools import resolve_device
from . import core, fold

__all__ = ["make_trainer"]

# make_trainer arguments of the JAX trainer that the port does not have yet
# -> (the value that leaves them off, the ROADMAP item that brings them).
_UNPORTED_ARGS = {
    "subset": (None, "ROADMAP Queue A item 6 (wait-n-f subset)"),
    "granularity": ("model", "ROADMAP Queue A item 6 (layer granularity)"),
    "tree_path": (True, "ROADMAP Queue A item 6 (the flat path)"),
    "worker_momentum": (None, "ROADMAP Queue A item 6 (worker momentum)"),
    "telemetry": (False, "ROADMAP Queue A item 7 (telemetry taps)"),
    "staleness": (None, "ROADMAP Queue A item 9 (staleness emulation)"),
    "defense": (None, "ROADMAP Queue A item 9 (defenses)"),
    "wire": (None, "ROADMAP Queue A item 9 (wire compression)"),
}


def _check_gar(gar, n, f):
    """The rule's contract, checked once at build time on a dummy stack."""
    message = gar.check(np.zeros((n, 2), dtype=np.float32), f=f)
    if message is not None:
        raise AssertionError(
            f"aggregation rule {gar.name!r} cannot be used: {message}"
        )


def _nchw(x, device):
    """(n, B, H, W, C) NHWC batches -> (n, B, C, H, W) float32 on device."""
    x = torch.as_tensor(x, device=device, dtype=torch.float32)
    return x.permute(0, 1, 4, 2, 3).contiguous()


def make_trainer(module, loss_fn, optimizer, gar, *, num_workers, f=0,
                 attack=None, attack_params=None, byz_mask=None,
                 gar_dtype=None, gar_params=None, device=None, **unported):
    """Build ``(init_fn, step_fn, eval_fn)`` for the AggregaThor topology.

    Args mirror the JAX trainer: ``f`` is the tolerance declared to the GAR;
    ``attack``/``attack_params``/``byz_mask`` the fault injection (default
    mask: the last f slots); ``gar_dtype`` (e.g. ``torch.bfloat16``) casts
    the per-worker gradients to that dtype before the attack and the GAR,
    the aggregate is cast back to the parameters' dtype at the optimizer;
    ``optimizer`` is a ``utils.selectors.select_optimizer`` factory;
    ``device`` defaults to cuda. The JAX trainer's other options raise
    ``NotImplementedError`` naming the ROADMAP item that brings them.

      - ``init_fn(seed) -> TrainState``: parameters drawn from
        ``torch.Generator().manual_seed(seed)``;
      - ``step_fn(state, x, y) -> (state, {"loss": ...})`` with ``x`` of
        shape ``(num_workers, batch, H, W, C)`` and ``y`` of shape
        ``(num_workers, batch)``; the state is updated in place;
      - ``eval_fn(state, x) -> logits`` for an NHWC batch.
    """
    for name, value in unported.items():
        if name not in _UNPORTED_ARGS:
            raise TypeError(f"make_trainer() got an unexpected argument {name!r}")
        off, item = _UNPORTED_ARGS[name]
        if value != off:
            raise NotImplementedError(
                f"make_trainer({name}={value!r}) is not ported yet: {item}"
            )
    device = resolve_device(device)
    gar = aggregators.resolve(gar)
    attack_params = dict(attack_params or {})
    gar_params = dict(gar_params or {})
    check_attack(attack)
    _check_gar(gar, num_workers, f)
    if byz_mask is None:
        byz_mask = core.default_byz_mask(
            num_workers, f if attack not in (None, "none") else 0
        )
    byz_mask = np.asarray(byz_mask, dtype=bool)
    if byz_mask.shape != (num_workers,):
        raise ValueError(
            f"byz_mask must have shape ({num_workers},), got {byz_mask.shape}"
        )
    fold_plan = fold.plan_for(gar, attack, byz_mask, attack_params)
    honest = torch.as_tensor(~byz_mask, dtype=torch.float32, device=device)

    init_worker, grad_fn, eval_apply = core.make_worker_fns(module, loss_fn)

    def init_fn(seed):
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        params, model_state = init_worker(gen, device)
        return core.TrainState(
            step=0, params=params, model_state=model_state,
            opt_state=optimizer(list(params.values())), rng=gen,
        )

    def step_fn(state, x, y):
        x = _nchw(x, device)
        y = torch.as_tensor(y, device=device)
        if x.shape[0] != num_workers or y.shape[:2] != x.shape[:2]:
            raise ValueError(
                f"expected ({num_workers}, batch, H, W, C) images and "
                f"({num_workers}, batch) labels, got {tuple(x.shape)} and "
                f"{tuple(y.shape)}"
            )
        grads, (losses, stacked_ms) = core.per_slot_grads(grad_fn, x, y)
        grads = core.cast_leaves(grads, gar_dtype)
        new_ms = core.mean_model_state(stacked_ms)
        mean_loss = (losses.float() * honest).sum() / honest.sum()
        if fold_plan is not None:
            aggr = fold.folded_tree_aggregate(
                gar, fold_plan, grads, f=f, gar_params=gar_params
            )
        else:
            poisoned = apply_gradient_attack_tree(
                attack, grads, byz_mask, **attack_params
            )
            aggr = gar.tree_aggregate(poisoned, f=f, **gar_params)
        aggr = core.cast_like(aggr, state.params)
        for name, p in state.params.items():
            p.grad = aggr[name]
        state.opt_state.step()
        with torch.no_grad():
            for name, buf in state.model_state.items():
                buf.copy_(new_ms[name])
        state.step += 1
        return state, {"loss": mean_loss}

    def eval_fn(state, x):
        x = torch.as_tensor(x, device=device, dtype=torch.float32)
        return eval_apply(x.permute(0, 3, 1, 2).contiguous())

    return init_fn, step_fn, eval_fn

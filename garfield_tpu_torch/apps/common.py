"""Shared CLI scaffolding and training loop of the port's applications
(counterpart of ``garfield_tpu/apps/common.py``).

``base_parser`` parses the JAX CLI's flags, with the same names, types and
defaults, plus ``--device``. A flag whose feature the port does not have
yet raises (``reject_unported``) instead of being ignored: the port's CLI
runs what it says or refuses.
"""

import argparse
import json
import time

import numpy as np
import torch

from .. import data as data_lib, models as models_lib
from ..utils import selectors, tools

__all__ = ["base_parser", "reject_unported", "build_ingredients", "train",
           "compute_accuracy"]

# Flags of the JAX CLI outside the port's first slice -> the ROADMAP item
# that brings them. Each raises when set to anything but its default.
UNPORTED_FLAGS = {
    "num_ps": "ROADMAP Queue A item 8 (the other topologies)",
    "fps": "ROADMAP Queue A item 8 (the other topologies)",
    "defense": "ROADMAP Queue A item 9 (threat and defense planes)",
    "defense_params": "ROADMAP Queue A item 9 (threat and defense planes)",
    "suspicion_halflife": "ROADMAP Queue A item 7 (telemetry)",
    "subset": "ROADMAP Queue A item 6 (wait-n-f subset)",
    "async_agg": "ROADMAP Queue A item 9 (staleness)",
    "max_staleness": "ROADMAP Queue A item 9 (staleness)",
    "staleness_decay": "ROADMAP Queue A item 9 (staleness)",
    "autoscale": "ROADMAP Queue A item 11 (roles with device work)",
    "target_rate": "ROADMAP Queue A item 11 (roles with device work)",
    "autoscale_min": "ROADMAP Queue A item 11 (roles with device work)",
    "autoscale_max": "ROADMAP Queue A item 11 (roles with device work)",
    "autoscale_window": "ROADMAP Queue A item 11 (roles with device work)",
    "autoscale_cooldown": "ROADMAP Queue A item 11 (roles with device work)",
    "straggler_ms": "ROADMAP Queue A item 11 (roles with device work)",
    "granularity": "ROADMAP Queue A item 6 (layer granularity)",
    "lr_decay": "ROADMAP Queue A item 12 (learning-rate schedules)",
    "lr_decay_epochs": "ROADMAP Queue A item 12 (learning-rate schedules)",
    "train_size": "ROADMAP Queue A item 12 (the other datasets)",
    "worker_momentum": "ROADMAP Queue A item 6 (worker momentum)",
    "fault_crashes": "ROADMAP Queue A item 11 (roles with device work)",
    "fault_hosts": "ROADMAP Queue A item 11 (roles with device work)",
    "chunk_steps": "ROADMAP Queue A item 4 (step chunking)",
    "telemetry": "ROADMAP Queue A item 7 (telemetry)",
    "trace": "ROADMAP Queue A item 7 (telemetry)",
    "checkpoint_dir": "ROADMAP Queue A item 11 (checkpointing)",
    "checkpoint_freq": "ROADMAP Queue A item 11 (checkpointing)",
    "resume": "ROADMAP Queue A item 11 (checkpointing)",
    "profile_dir": "ROADMAP Queue A item 11 (profiling)",
    "mesh": "ROADMAP Queue A item 8 (the other topologies)",
}


def base_parser(description, *, default_model="convnet", default_loss="nll"):
    """The JAX CLI's flags (``garfield_tpu/apps/common.py``) plus
    ``--device``."""
    p = argparse.ArgumentParser(description=description)
    a = p.add_argument
    a("--dataset", type=str, default="mnist")
    a("--batch", type=int, default=32, help="Minibatch size per worker.")
    a("--num_workers", type=int, default=1)
    a("--num_ps", type=int, default=1)
    a("--fw", type=int, default=0, help="Declared Byzantine workers.")
    a("--fps", type=int, default=0)
    a("--model", type=str, default=default_model)
    a("--loss", type=str, default=default_loss)
    a("--optimizer", type=str, default="sgd")
    a("--opt_args", type=json.loads, default={"lr": "0.1"},
      help='Optimizer args as JSON, e.g. \'{"lr":"0.1","momentum":"0.9"}\'')
    a("--num_iter", type=int, default=5000)
    a("--gar", type=str, default="average")
    a("--acc_freq", type=int, default=100,
      help="Iterations between accuracy evaluations (0: only at the end).")
    a("--bench", action="store_true",
      help="Synchronize and print the time of every step.")
    a("--log", action="store_true", help="Print the loss every iteration.")
    a("--attack", type=str, default=None)
    a("--attack_params", type=json.loads, default={})
    a("--defense", type=str, default=None)
    a("--defense_params", type=json.loads, default={})
    a("--suspicion_halflife", type=float, default=None)
    a("--subset", type=int, default=None)
    a("--async", dest="async_agg", action="store_true")
    a("--max_staleness", type=int, default=None)
    a("--staleness_decay", type=float, default=None)
    a("--autoscale", action="store_true")
    a("--target_rate", type=float, default=0.0)
    a("--autoscale_min", type=int, default=1)
    a("--autoscale_max", type=int, default=0)
    a("--autoscale_window", type=int, default=8)
    a("--autoscale_cooldown", type=int, default=8)
    a("--straggler_ms", type=int, default=0)
    a("--granularity", type=str, default="model", choices=["model", "layer"])
    a("--seed", type=int, default=1234, help="Seed of the parameter draw.")
    a("--lr_decay", type=float, default=0.2)
    a("--lr_decay_epochs", type=int, default=0)
    a("--train_size", type=int, default=None)
    a("--dtype", type=str, default="float32",
      choices=["float32", "bfloat16"], help="Model compute dtype.")
    a("--gar_dtype", type=str, default=None,
      choices=["float32", "bfloat16"], help="Aggregation-pipeline dtype.")
    a("--gar_params", type=json.loads, default={})
    a("--worker_momentum", type=float, default=None)
    a("--fault_crashes", type=json.loads, default=None)
    a("--fault_hosts", type=int, default=None)
    a("--chunk_steps", type=int, default=None)
    a("--telemetry", type=str, nargs="?", const="telemetry", default=None)
    a("--trace", action="store_true")
    a("--checkpoint_dir", type=str, default=None)
    a("--checkpoint_freq", type=int, default=1000)
    a("--resume", action="store_true")
    a("--profile_dir", type=str, default=None)
    a("--sync_eval", action="store_true",
      help="Accepted for the JAX CLI's sake: the port always evaluates "
           "inline.")
    a("--mesh", type=str, default=None)
    a("--device", type=str, default="cuda",
      help="cuda (default) or cpu (the kernels' plain PyTorch versions).")
    return p


def reject_unported(parser, args, flags=UNPORTED_FLAGS):
    """Raise ``SystemExit`` naming the first flag in ``flags`` that is set
    to anything but its default."""
    for dest, item in flags.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--async" if dest == "async_agg" else f"--{dest}"
            raise SystemExit(f"{flag} is not ported yet: {item}")


def _coerce_opt_args(opt_args):
    """Reference CLIs pass numbers as strings ('{"lr":"0.2"}'); coerce."""
    out = {}
    for k, v in opt_args.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = v
    return out


def build_ingredients(args):
    """(module, loss_fn, optimizer factory) from the CLI flags."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    module = models_lib.select_model(args.model, args.dataset, dtype=dtype)
    loss_fn = selectors.select_loss(args.loss)
    opt_args = _coerce_opt_args(dict(args.opt_args))
    optimizer = selectors.select_optimizer(
        args.optimizer, lr=opt_args.pop("lr", 0.1),
        momentum=opt_args.pop("momentum", 0.0),
        weight_decay=opt_args.pop("weight_decay", 0.0),
        **opt_args,
    )
    return module, loss_fn, optimizer


def compute_accuracy(state, eval_fn, test_batches):
    """Top-1 accuracy over a list of (x, y) NHWC test batches."""
    correct = total = 0
    for x, y in test_batches:
        logits = eval_fn(state, x)
        y = torch.as_tensor(np.asarray(y).reshape(-1), device=logits.device)
        correct += int((logits.argmax(-1) == y).sum())
        total += y.numel()
    return correct / max(total, 1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args, *, topology, make_trainer_kwargs, num_slots, tag):
    """The reference training loop: batch i of worker w is its partition's
    batch ``i % num_batches``; periodic and final accuracy; a JSON summary
    line. Returns ``(state, summary)``."""
    t_start = time.time()
    device = tools.resolve_device(args.device)
    manager = data_lib.DatasetManager(args.dataset, args.batch, num_slots)
    xs_np, ys_np = manager.sharded_train_batches()
    test_batches = manager.get_test_set()
    num_batches = xs_np.shape[1]
    tools.info(f"[{tag}] One EPOCH consists of {num_batches} iterations")
    module, loss_fn, optimizer = build_ingredients(args)
    kwargs = dict(make_trainer_kwargs)
    if args.gar_dtype:
        kwargs["gar_dtype"] = (
            torch.bfloat16 if args.gar_dtype == "bfloat16" else torch.float32
        )
    if args.gar_params:
        kwargs["gar_params"] = args.gar_params
    init_fn, step_fn, eval_fn = topology.make_trainer(
        module, loss_fn, optimizer, args.gar, device=device, **kwargs
    )
    xs = torch.as_tensor(xs_np, device=device)
    ys = torch.as_tensor(ys_np, device=device)
    state = init_fn(args.seed)

    step_times, metrics = [], {}
    t_train = time.time()
    for i in range(args.num_iter):
        b = i % num_batches
        if args.bench:
            _sync(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, xs[:, b], ys[:, b])
            _sync(device)
            step_times.append(time.perf_counter() - t0)
            print(f"Training step {i} takes {step_times[-1]:.4f} seconds",
                  flush=True)
        else:
            state, metrics = step_fn(state, xs[:, b], ys[:, b])
        if args.log:
            print(f"Loss {i}: {float(metrics['loss']):.6f}", flush=True)
        if args.acc_freq and i % args.acc_freq == 0:
            acc = compute_accuracy(state, eval_fn, test_batches)
            print(f"Epoch: {i / max(num_batches, 1):.2f} Accuracy: "
                  f"{acc:.4f} Time: {time.time() - t_start:.1f}", flush=True)
    _sync(device)
    train_wall = time.time() - t_train
    acc = compute_accuracy(state, eval_fn, test_batches)
    summary = {
        "final_accuracy": acc,
        "final_loss": float(metrics["loss"]) if metrics else None,
        "wall_s": time.time() - t_start,
        "train_wall_s": train_wall,
        "steps_per_sec": args.num_iter / train_wall if train_wall > 0 else None,
        "device": str(device),
    }
    if step_times:
        summary["step_median_s"] = float(np.median(step_times))
    print(json.dumps({"tag": tag, **summary}), flush=True)
    return state, summary

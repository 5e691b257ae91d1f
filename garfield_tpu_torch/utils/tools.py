"""Logging and device helpers (the port's own copy of what it needs from
``garfield_tpu/utils/tools.py``, plus device resolution)."""

import sys
import threading

import torch

__all__ = ["info", "warning", "resolve_device"]

_print_lock = threading.Lock()


def _emit(*args):
    text = " ".join(str(a) for a in args)
    with _print_lock:
        print(text, file=sys.stderr, flush=True)


def info(*args):
    _emit(*args)


def warning(*args):
    _emit("[W]", *args)


def resolve_device(device=None):
    """``torch.device`` for an entry point's ``device=`` argument.

    ``None`` means ``cuda``: the port runs on the card unless the caller
    asks for the CPU. A CUDA device without CUDA raises instead of falling
    back silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: garfield_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run its plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use cuda or cpu")
    return device

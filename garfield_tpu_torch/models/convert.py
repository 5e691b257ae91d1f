"""Carry ResNet weights between the JAX package's flax layout and the port.

``from_flax(params, batch_stats)`` takes the flax variable trees (nested
dicts of numpy arrays, as ``module.init`` returns them) and gives the port's
state: a flat dict ``torch name -> tensor`` for ``load_state_dict``.
``to_flax_layout(tree)`` is the inverse, for leaf-by-leaf comparison of
parameters, gradients or BN statistics: it gives ``{"params": ...,
"batch_stats": ...}`` nested dicts of numpy arrays (collections that the
tree does not touch are left out).

Layouts: flax conv kernels are HWIO and torch's OIHW; a flax Dense kernel is
(in, out) and torch's (out, in); BN ``scale``/``bias``/``mean``/``var`` are
``weight``/``bias``/``running_mean``/``running_var``. Names: flax numbers
submodules per class in creation order (``Conv_0``, ``BatchNorm_1``,
``BasicBlock_3``), the port names them (``conv1``, ``bn2``,
``blocks.3``, ``shortcut_conv``). The leaf ORDER differs too (flax sorts by
name), which is why comparisons go leaf by leaf and never through a flat
concatenation.
"""

import re

import numpy as np
import torch

__all__ = ["from_flax", "to_flax_layout"]

_MAIN_CONVS = {"BasicBlock": 2, "Bottleneck": 3}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
_BN_LEAF_INV = {v: k for k, v in _BN_LEAF.items()}
_STATS = ("running_mean", "running_var")


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _module_name(kind, idx, block_kind=None):
    """Port name of the flax submodule ``{kind}_{idx}`` (inside a block of
    ``block_kind``, or at the top level)."""
    if block_kind is None:
        return {"Conv": "stem_conv", "BatchNorm": "stem_bn",
                "Dense": "fc"}[kind]
    main = _MAIN_CONVS[block_kind]
    prefix = "conv" if kind == "Conv" else "bn"
    if idx < main:
        return f"{prefix}{idx + 1}"
    if idx == main:
        return f"shortcut_{prefix}"
    raise ValueError(f"unexpected {kind}_{idx} in a {block_kind}")


def _port_name(path):
    """flax path (tuple of keys, without the collection) -> port name."""
    *mods, leaf = path
    parts, block_kind = [], None
    for mod in mods:
        kind, idx = re.fullmatch(r"([A-Za-z]+)_(\d+)", mod).groups()
        if kind in _MAIN_CONVS:
            parts.append(f"blocks.{idx}")
            block_kind = kind
        else:
            parts.append(_module_name(kind, int(idx), block_kind))
    mod_kind = re.fullmatch(r"([A-Za-z]+)_\d+", mods[-1]).group(1)
    if mod_kind == "BatchNorm":
        leaf = _BN_LEAF[leaf]
    elif leaf == "kernel":
        leaf = "weight"
    parts.append(leaf)
    return ".".join(parts), mod_kind


def _to_torch_layout(value, mod_kind, leaf):
    value = np.asarray(value)
    if leaf == "kernel" and mod_kind == "Conv":
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and mod_kind == "Dense":
        return value.T
    return value


def from_flax(params, batch_stats=None):
    """The port's state dict from flax ``params`` (and ``batch_stats``)."""
    out = {}
    trees = [params] + ([batch_stats] if batch_stats is not None else [])
    for tree in trees:
        for path, value in _flatten(tree):
            name, mod_kind = _port_name(path)
            out[name] = torch.from_numpy(np.array(
                _to_torch_layout(value, mod_kind, path[-1]), order="C"
            ))
    return out


def _flax_path(name, block_kind):
    """Port name -> (collection, flax path, module kind); ``block_kind`` is
    the flax class name of the ResNet's blocks."""
    parts = name.split(".")
    leaf = parts[-1]
    if parts[0] == "blocks":
        prefix, num = re.fullmatch(r"(?:shortcut_)?(conv|bn)(\d*)",
                                   parts[2]).groups()
        kind = "Conv" if prefix == "conv" else "BatchNorm"
        idx = int(num) - 1 if num else _MAIN_CONVS[block_kind]
        mods = [f"{block_kind}_{parts[1]}", f"{kind}_{idx}"]
    else:
        kind = {"stem_conv": "Conv", "stem_bn": "BatchNorm",
                "fc": "Dense"}[parts[0]]
        mods = [f"{kind}_0"]
    if kind == "BatchNorm":
        flax_leaf = _BN_LEAF_INV[leaf]
    else:
        flax_leaf = "kernel" if leaf == "weight" else leaf
    collection = "batch_stats" if leaf in _STATS else "params"
    return collection, tuple(mods) + (flax_leaf,), kind


def to_flax_layout(tree, *, block_kind="BasicBlock", stacked=False):
    """flax-layout nested dicts (numpy) of a port tree ``name -> tensor``
    (parameters, gradients or BN statistics). ``block_kind`` names the
    ResNet's block class; ``stacked`` keeps a leading (worker) axis."""
    out = {}
    for name, value in tree.items():
        value = value.detach().cpu().float().numpy() \
            if isinstance(value, torch.Tensor) else np.asarray(value)
        collection, path, kind = _flax_path(name, block_kind)
        lead = 1 if stacked else 0
        if path[-1] == "kernel" and kind == "Conv":
            axes = (2, 3, 1, 0)
            value = value.transpose(
                tuple(range(lead)) + tuple(a + lead for a in axes)
            )
        elif path[-1] == "kernel" and kind == "Dense":
            value = np.swapaxes(value, lead, lead + 1)
        node = out.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out

"""Coordinate-wise robust statistics: CUDA kernels and their plain versions.

Counterpart of ``garfield_tpu/ops/coordinate.py``. Two kernels, written by
hand in CUDA C++ for Hopper (``csrc/coordinate.cu``), replace the Pallas TPU
kernels ``_median_kernel`` and ``_tmean_kernel``:

  - ``coordinate_median``: lower coordinate-wise median of an (n, d) stack.
    torch semantics: for even n the lower of the two middle values; NaN
    sorts last, so up to ceil(n/2)-1 NaNs per coordinate do not reach the
    result.
  - ``trimmed_mean``: per coordinate, drop the f smallest and f largest
    values and average the rest: a sequential f32 add chain, then a
    multiply by the f32 reciprocal of n-2f (see ``_reciprocal``).

Both take the folded-attack remap (``row_map``/``row_scale``: logical row i
is ``row_scale[i] * rows[row_map[i]]``) and optional ``extra`` rows that the
remap addresses after the stack's own rows (lie's shared fake row), so the
poisoned stack is never built.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(``coordinate_median_plain`` / ``trimmed_mean_plain``, bitwise the TPU
kernel's semantics, and the oracle the tests and ``chip_smoke.py`` hold the
kernels against). A CUDA tensor with n <= ``MAX_SORT_N`` launches the kernel
or raises. Above ``MAX_SORT_N`` the JAX package's documented design holds:
a once-per-op warning, then the ``torch.sort`` path. Each wrapper counts its
kernel launches in ``launches``.
"""

import ctypes
import warnings

import numpy as np
import torch

from ..utils.tools import resolve_device
from . import _build

__all__ = [
    "MAX_SORT_N",
    "launches",
    "reset_launches",
    "coordinate_median",
    "coordinate_median_plain",
    "trimmed_mean",
    "trimmed_mean_plain",
]

# Largest stack the sorting-network kernels take (the template range of
# csrc/coordinate.cu): O(n^2) register compare-exchanges per coordinate.
MAX_SORT_N = 32

# Kernel launches per wrapper; chip_smoke.py reads them to show that the
# main path went through the kernels.
launches = {"coordinate_median": 0, "trimmed_mean": 0}

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # GTT_F32, GTT_BF16
_SOURCE = "coordinate.cu"

_warned_large_n = set()


def reset_launches():
    """Set every launch count to 0."""
    for op in launches:
        launches[op] = 0


def _warn_large_n(op, n):
    """Once-per-op notice that the kernel path is off for this n."""
    if op not in _warned_large_n:
        _warned_large_n.add(op)
        warnings.warn(
            f"{op}: n={n} exceeds the sorting-network kernel bound "
            f"MAX_SORT_N={MAX_SORT_N}; using the torch.sort path (same "
            "result, not the single-pass kernel)",
            stacklevel=3,
        )


def _prepare(g, extra, device):
    """(g, extra) as 2-D tensors on one device, same width and dtype.
    An array-like ``g`` goes to ``device`` (default cuda)."""
    if not isinstance(g, torch.Tensor):
        g = torch.as_tensor(g, device=resolve_device(device))
    elif device is not None and g.device != resolve_device(device):
        raise ValueError(f"g lies on {g.device}, not on {device}")
    if g.ndim != 2:
        raise ValueError(f"expected an (n, d) stack, got shape {tuple(g.shape)}")
    if not g.is_floating_point():
        raise TypeError(f"expected a floating-point stack, got {g.dtype}")
    if extra is not None:
        extra = torch.as_tensor(extra, device=g.device)
        if extra.ndim == 1:
            extra = extra[None]
        if extra.ndim != 2 or extra.shape[1] != g.shape[1]:
            raise ValueError(
                f"extra rows of shape {tuple(extra.shape)} do not match the "
                f"stack's width {g.shape[1]}"
            )
        if extra.dtype != g.dtype:
            raise TypeError(f"extra is {extra.dtype}, the stack {g.dtype}")
    return g, extra


def _remap_sel(ne, row_map, row_scale):
    """Normalize the folded-attack remap to a list of (row, scale) pairs (or
    None) plus the logical row count; bounds-checked against the ``ne``
    physical rows (the stack's rows, then the extra rows)."""
    if row_map is None and row_scale is None:
        return None, ne
    row_map = (
        np.arange(ne) if row_map is None else np.asarray(row_map, np.int64)
    )
    if row_map.ndim != 1 or row_map.size == 0:
        raise ValueError(f"row_map must be a non-empty vector, got {row_map!r}")
    n = row_map.size
    row_scale = (
        np.ones(n) if row_scale is None else np.asarray(row_scale, np.float64)
    )
    if row_scale.size != n:
        raise ValueError(
            f"row_scale has {row_scale.size} entries for {n} mapped rows"
        )
    if row_map.min() < 0 or row_map.max() >= ne:
        raise ValueError(f"row_map references rows outside the {ne}-row stack")
    return [(int(i), float(s)) for i, s in zip(row_map, row_scale)], n


def _physical_rows(g, extra):
    return g.shape[0] + (0 if extra is None else extra.shape[0])


def _logical_rows_f32(g, extra, sel):
    """The (n, d) f32 stack the kernels see: upcast, remap, scale, with exact
    zeros for zero scales (0 * inf must not leak NaN where the where-path's
    crash attack writes literal zero rows)."""
    x = g if extra is None else torch.cat([g, extra])
    x = x.float()
    if sel is None:
        return x
    idx = torch.tensor([i for i, _ in sel], dtype=torch.long, device=x.device)
    scale_np = np.array([s for _, s in sel], np.float32)
    rows = x.index_select(0, idx) * torch.from_numpy(scale_np).to(x.device)[:, None]
    zero = scale_np == 0.0
    if zero.any():
        rows = torch.where(
            torch.from_numpy(zero).to(x.device)[:, None],
            torch.zeros((), dtype=rows.dtype, device=x.device), rows,
        )
    return rows


def _sorted_rows(x):
    """Rows of ``x`` sorted along dim 0 in the odd-even network's order:
    stable, ascending, -0.0 equal to +0.0, every NaN last.

    Two stable ``torch.sort`` passes, by value (NaN keyed as +inf, -0.0
    as +0.0) and then by NaN-ness. One pass over the raw values is not the
    network's order on the card: there ``torch.sort`` put the NaNs of
    bf16-converted stacks first (measured on an H100)."""
    nan = torch.isnan(x)
    key = torch.where(nan, torch.full_like(x, float("inf")), x) + 0.0
    idx = torch.sort(key, dim=0, stable=True).indices
    last = torch.sort(nan.gather(0, idx).to(torch.uint8), dim=0,
                      stable=True).indices
    return x.gather(0, idx.gather(0, last))


def coordinate_median_plain(g, *, row_map=None, row_scale=None, extra=None):
    """Plain PyTorch version of the median kernel (any device)."""
    g, extra = _prepare(g, extra, None)
    sel, n = _remap_sel(_physical_rows(g, extra), row_map, row_scale)
    x = _logical_rows_f32(g, extra, sel)
    return _sorted_rows(x)[(n - 1) // 2].to(g.dtype)


def trimmed_mean_plain(g, f, *, row_map=None, row_scale=None, extra=None):
    """Plain PyTorch version of the trimmed-mean kernel (any device): the
    same sort, then the explicit f32 add chain over sorted rows f..n-f-1 and
    one multiply by the f32 reciprocal of n-2f."""
    g, extra = _prepare(g, extra, None)
    sel, n = _remap_sel(_physical_rows(g, extra), row_map, row_scale)
    _check_f(n, f)
    s = _sorted_rows(_logical_rows_f32(g, extra, sel))
    acc = s[f]
    for i in range(f + 1, n - f):
        acc = acc + s[i]
    inv = torch.full((), _reciprocal(n - 2 * f), dtype=acc.dtype,
                     device=acc.device)
    return (acc * inv).to(g.dtype)


def _reciprocal(k):
    """f32 1/k, correctly rounded. The TPU kernel's ``acc / (n - 2f)``
    divides by a constant, which XLA compiles to a multiply by this
    reciprocal (measured in interpret mode); the port multiplies explicitly
    so its kernel and plain version are bitwise the JAX kernel."""
    return float(np.float32(1.0) / np.float32(k))


def _check_f(n, f):
    if not (isinstance(f, (int, np.integer)) and 0 <= f and n - 2 * f >= 1):
        raise ValueError(f"need n - 2f >= 1, got n={n}, f={f}")


def _launch(op, g, extra, sel, n, f=None):
    """Launch the CUDA kernel of ``op`` on CUDA tensors; raise on anything
    the kernel does not take."""
    if g.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"{op}: the CUDA kernel takes float32 or bfloat16, got {g.dtype}"
        )
    for t in (g, extra):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{op}: the CUDA kernel takes contiguous rows")
    d = g.shape[1]
    out = torch.empty(d, dtype=g.dtype, device=g.device)
    if d == 0:
        return out
    step = d * g.element_size()
    ptrs = [g.data_ptr() + k * step for k in range(g.shape[0])]
    if extra is not None:
        ptrs += [extra.data_ptr() + k * step for k in range(extra.shape[0])]
    remap = _build.RowRemap()
    for i, (row, scale) in enumerate(sel or [(k, 1.0) for k in range(n)]):
        remap.rows[i] = ptrs[row]
        remap.scale[i] = scale
    lib = _build.load(_SOURCE)
    dev = g.device.index if g.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if op == "coordinate_median":
        rc = lib.gtt_coordinate_median(
            ctypes.byref(remap), n, _KERNEL_DTYPES[g.dtype], out.data_ptr(),
            d, dev, stream,
        )
    else:
        rc = lib.gtt_trimmed_mean(
            ctypes.byref(remap), n, f, _KERNEL_DTYPES[g.dtype],
            out.data_ptr(), d, dev, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{op}: CUDA kernel launch failed ({rc}): "
            f"{lib.gtt_error_string(rc).decode()}"
        )
    launches[op] += 1
    return out


def _use_kernel(g, n, op):
    if g.device.type == "cpu":
        return False
    if g.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {g.device}")
    if n > MAX_SORT_N:
        _warn_large_n(op, n)
        return False
    return True


def coordinate_median(g, *, row_map=None, row_scale=None, extra=None,
                      device=None):
    """Lower coordinate-wise median of an (n, d) stack -> (d,).

    ``row_map``/``row_scale`` (static) apply the folded-attack remap inside
    the kernel: logical row i is ``row_scale[i] * rows[row_map[i]]``, where
    ``rows`` are the stack's rows followed by ``extra`` (an optional (k, d)
    or (d,) tensor). ``device`` places an array-like ``g`` (default cuda)."""
    g, extra = _prepare(g, extra, device)
    sel, n = _remap_sel(_physical_rows(g, extra), row_map, row_scale)
    if not _use_kernel(g, n, "coordinate_median"):
        return coordinate_median_plain(
            g, row_map=row_map, row_scale=row_scale, extra=extra
        )
    return _launch("coordinate_median", g, extra, sel, n)


def trimmed_mean(g, f, *, row_map=None, row_scale=None, extra=None,
                 device=None):
    """Coordinate-wise trimmed mean: the average of sorted rows f..n-f-1 per
    column, fused with the sort in one kernel pass. ``row_map``,
    ``row_scale``, ``extra`` and ``device``: see ``coordinate_median``."""
    g, extra = _prepare(g, extra, device)
    sel, n = _remap_sel(_physical_rows(g, extra), row_map, row_scale)
    _check_f(n, f)
    if not _use_kernel(g, n, "trimmed_mean"):
        return trimmed_mean_plain(
            g, f, row_map=row_map, row_scale=row_scale, extra=extra
        )
    return _launch("trimmed_mean", g, extra, sel, n, f)

"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterpart of ``garfield_tpu/ops``). See ``coordinate.py``."""

from .coordinate import (
    MAX_SORT_N,
    coordinate_median,
    coordinate_median_plain,
    launches,
    reset_launches,
    trimmed_mean,
    trimmed_mean_plain,
)

__all__ = [
    "MAX_SORT_N",
    "coordinate_median",
    "coordinate_median_plain",
    "launches",
    "reset_launches",
    "trimmed_mean",
    "trimmed_mean_plain",
]

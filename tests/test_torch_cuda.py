"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a GPU. The file imports neither
JAX nor the JAX package, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from garfield_tpu_torch import ops
from garfield_tpu_torch.attacks import plan_gradient_attack_fold
from garfield_tpu_torch.ops import coordinate as torch_coord
from garfield_tpu_torch.parallel.core import default_byz_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _stack(n, d, seed, nan_max=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    for j in range(d if nan_max else 0):
        k = int(rng.integers(0, nan_max + 1))
        x[rng.choice(n, size=k, replace=False), j] = np.nan
    return x


def _assert_bitwise(want, got):
    a, b = want.float().cpu().numpy(), got.float().cpu().numpy()
    same = (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))
    assert same.all(), f"{(~same).sum()} of {same.size} differ"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 8, 9, 32])
def test_kernels_bitwise_vs_plain(cuda_device, n, dtype):
    x = torch.from_numpy(
        _stack(n, 1000, seed=n, nan_max=max(0, math.ceil(n / 2) - 1))
    ).to(cuda_device, dtype)
    ops.reset_launches()
    got = ops.coordinate_median(x)
    assert ops.launches["coordinate_median"] == 1
    _assert_bitwise(ops.coordinate_median_plain(x), got)
    if n >= 3:
        x = torch.from_numpy(_stack(n, 1000, seed=n, nan_max=1)).to(
            cuda_device, dtype)
        _assert_bitwise(ops.trimmed_mean_plain(x, 1), ops.trimmed_mean(x, 1))
        assert ops.launches["trimmed_mean"] == 1


@pytest.mark.parametrize("attack", ["lie", "empire", "reverse", "crash"])
def test_folded_remap_on_card(cuda_device, attack):
    mask = default_byz_mask(8, 2)
    x = torch.from_numpy(_stack(8, 777, seed=3)).to(cuda_device)
    if attack == "crash":
        x[6:] = float("inf")
    plan = plan_gradient_attack_fold(attack, mask)
    extra = plan.build_extra({"g": x})["g"] if plan.build_extra else None
    kw = dict(row_map=plan.row_map, row_scale=plan.row_scale, extra=extra)
    _assert_bitwise(ops.coordinate_median_plain(x, **kw),
                    ops.coordinate_median(x, **kw))
    _assert_bitwise(ops.trimmed_mean_plain(x, 2, **kw),
                    ops.trimmed_mean(x, 2, **kw))


def test_large_n_warns_and_does_not_launch(cuda_device, monkeypatch):
    monkeypatch.setattr(torch_coord, "_warned_large_n", set())
    ops.reset_launches()
    x = torch.randn(40, 100, device=cuda_device)
    with pytest.warns(UserWarning, match="MAX_SORT_N"):
        ops.coordinate_median(x)
    assert ops.launches["coordinate_median"] == 0


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.coordinate_median(torch.zeros(4, 8, device=cuda_device,
                                          dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        ops.coordinate_median(torch.zeros(8, 4, device=cuda_device).t())

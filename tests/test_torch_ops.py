"""The port's coordinate-wise kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; they
must be BITWISE equal to the JAX kernels run in interpret mode
(``interpret=True, tile=128``, as tests/test_ops.py runs them): NaN
placement, -0.0/+0.0 ties, bf16, the folded-attack remaps with exact zeros,
and the trimmed mean's add chain. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garfield_tpu.ops import coordinate as jax_coord
from garfield_tpu_torch import ops
from garfield_tpu_torch.attacks import plan_gradient_attack_fold
from garfield_tpu_torch.ops import coordinate as torch_coord
from garfield_tpu_torch.parallel.core import default_byz_mask


def _stack(n, d, seed, *, nan_max=0, signed_zeros=False):
    """f32 (n, d) normals; up to ``nan_max`` NaNs per column; optionally
    columns of mixed -0.0/+0.0 ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if signed_zeros:
        cols = rng.random(d) < 0.3
        zeros = np.where(rng.random((n, d)) < 0.5, -0.0, 0.0).astype(np.float32)
        x = np.where((rng.random((n, d)) < 0.6) & cols[None], zeros, x)
    for j in range(d if nan_max else 0):
        k = int(rng.integers(0, nan_max + 1))
        x[rng.choice(n, size=k, replace=False), j] = np.nan
    return x


def _as(x, dtype):
    """The same values for both packages: (numpy for JAX, tensor for torch)."""
    if dtype == "bf16":
        return x.astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return x, torch.from_numpy(x)


def _assert_bitwise(jax_out, torch_out):
    a = np.asarray(jax_out).astype(np.float32)
    b = torch_out.float().numpy()
    same = (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))
    assert same.all(), (
        f"{(~same).sum()} of {same.size} differ; first at "
        f"{np.flatnonzero(~same)[:5]}: {a[~same][:5]} vs {b[~same][:5]}"
    )


# d = 1000 is not a multiple of the 128-lane tile (nor of the CUDA kernel's
# 256-coordinate block); (9, 1) and (9, 130) add a one-column and a
# one-lane-past-the-tile stack.
_MEDIAN_CASES = [(n, 1000, dt) for n in (1, 2, 3, 8, 9, 15, 32)
                 for dt in ("f32", "bf16")] + [(9, 1, "f32"), (9, 130, "f32")]


@pytest.mark.parametrize("n,d,dtype", _MEDIAN_CASES)
def test_median_bitwise_vs_pallas_interpret(n, d, dtype):
    x = _stack(n, d, seed=n * 1000 + d, nan_max=math.ceil(n / 2) - 1,
               signed_zeros=True)
    xj, xt = _as(x, dtype)
    want = jax_coord.coordinate_median(xj, interpret=True, tile=128)
    got = ops.coordinate_median(xt)
    assert got.dtype == xt.dtype and got.shape == (d,)
    _assert_bitwise(want, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,f", [
    (1, 0), (3, 0), (3, 1), (5, 2), (8, 1), (8, 2), (9, 3), (15, 4),
    (32, 10),
])
def test_tmean_bitwise_vs_pallas_interpret(n, f, dtype):
    x = _stack(n, 1000, seed=n * 100 + f, nan_max=f, signed_zeros=True)
    xj, xt = _as(x, dtype)
    want = jax_coord.trimmed_mean(xj, f, interpret=True, tile=128)
    got = ops.trimmed_mean(xt, f)
    _assert_bitwise(want, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attack", ["lie", "empire", "reverse", "crash"])
@pytest.mark.parametrize("n", [5, 9])
def test_folded_remap_bitwise_vs_pallas_interpret(attack, n, dtype):
    """The folded attack's remap, applied by the wrapper with the fake row
    passed beside the stack, equals the JAX kernel on the concatenated
    stack; crash's zero scale gives exact zeros over non-finite rows."""
    f = 2
    mask = default_byz_mask(n, f)
    x = _stack(n, 257, seed=n * 7 + len(attack), signed_zeros=True)
    if attack == "crash":
        x[mask] = np.inf
        x[mask, ::5] = np.nan
    xj, xt = _as(x, dtype)
    plan = plan_gradient_attack_fold(attack, mask)
    extra = None
    ext_j = xj
    if plan.build_extra is not None:
        extra = plan.build_extra({"g": xt})["g"]
        ext_j = np.concatenate(
            [xj, extra.float().numpy().astype(xj.dtype)[None]]
        )
    kw = dict(row_map=plan.row_map, row_scale=plan.row_scale)
    _assert_bitwise(
        jax_coord.coordinate_median(ext_j, interpret=True, tile=128, **kw),
        ops.coordinate_median(xt, extra=extra, **kw),
    )
    for tf in (1, 2):
        _assert_bitwise(
            jax_coord.trimmed_mean(ext_j, tf, interpret=True, tile=128, **kw),
            ops.trimmed_mean(xt, tf, extra=extra, **kw),
        )
    if attack == "crash":
        assert torch.isfinite(ops.coordinate_median(xt, **kw)).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_nan_sign_and_payload_do_not_change_the_order(dtype):
    """The network sorts every NaN last whatever its sign bit or payload;
    so must the plain version (CUDA's torch.sort alone orders a negative
    NaN first)."""
    x = _stack(9, 300, seed=11, nan_max=4)
    bits = x.view(np.uint32)
    nan = np.isnan(x)
    flip = np.random.default_rng(12).random(x.shape) < 0.5
    bits[nan & flip] = 0xFFC00000  # negative quiet NaN
    bits[nan & ~flip] = 0x7F800001  # positive NaN, other payload
    xj, xt = _as(x, dtype)
    _assert_bitwise(jax_coord.coordinate_median(xj, interpret=True, tile=128),
                    ops.coordinate_median(xt))
    _assert_bitwise(jax_coord.trimmed_mean(xj, 4, interpret=True, tile=128),
                    ops.trimmed_mean(xt, 4))


def test_even_n_takes_lower_median():
    x = torch.tensor([[1.0, 10.0], [2.0, 20.0], [3.0, 30.0], [4.0, 40.0]])
    assert ops.coordinate_median(x).tolist() == [2.0, 20.0]


@pytest.mark.parametrize("op", ["coordinate_median", "trimmed_mean"])
def test_above_max_sort_n_matches_jax(op):
    """n > MAX_SORT_N: the torch.sort path, equal to the JAX package's XLA
    path for the same n (its large-n fallback)."""
    n = ops.MAX_SORT_N + 8
    x = _stack(n, 300, seed=40, nan_max=3)
    if op == "coordinate_median":
        want = jax_coord.coordinate_median(x)
        got = ops.coordinate_median(torch.from_numpy(x))
        _assert_bitwise(want, got)
    else:
        want = jax_coord.trimmed_mean_reference(jnp.asarray(x), 4)
        got = ops.trimmed_mean(torch.from_numpy(x), 4)
        # The JAX fallback averages with a reduction (jnp.mean), the port
        # with the kernel's sequential chain: last-ulp differences only.
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_large_n_warning_once_per_op(monkeypatch):
    monkeypatch.setattr(torch_coord, "_warned_large_n", set())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch_coord._warn_large_n("coordinate_median", 40)
        torch_coord._warn_large_n("coordinate_median", 41)
        torch_coord._warn_large_n("trimmed_mean", 40)
    msgs = [str(w.message) for w in caught]
    assert len(msgs) == 2
    assert "MAX_SORT_N=32" in msgs[0] and "coordinate_median" in msgs[0]
    assert "trimmed_mean" in msgs[1]


def test_cpu_tensor_takes_plain_path_without_launch():
    ops.reset_launches()
    x = torch.from_numpy(_stack(8, 64, seed=1))
    ops.coordinate_median(x)
    ops.trimmed_mean(x, 2)
    assert ops.launches == {"coordinate_median": 0, "trimmed_mean": 0}


def test_array_like_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _stack(4, 16, seed=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.coordinate_median(x)
    out = ops.coordinate_median(x, device="cpu")
    _assert_bitwise(jax_coord.coordinate_median(x, interpret=True, tile=128),
                    out)


@pytest.mark.parametrize("kwargs,err", [
    (dict(row_map=[0, 5]), ValueError),             # row outside the stack
    (dict(row_map=[0, -1]), ValueError),
    (dict(row_map=[0, 1], row_scale=[1.0]), ValueError),
    (dict(extra=torch.zeros(3)), ValueError),       # width mismatch
    (dict(extra=torch.zeros(8, dtype=torch.float64)), TypeError),
])
def test_remap_and_extra_validation(kwargs, err):
    x = torch.zeros(4, 8)
    with pytest.raises(err):
        ops.coordinate_median(x, **kwargs)


@pytest.mark.parametrize("n,f", [(4, 2), (3, -1), (8, 4)])
def test_tmean_rejects_bad_f(n, f):
    with pytest.raises(ValueError, match="n - 2f >= 1"):
        ops.trimmed_mean(torch.zeros(n, 4), f)

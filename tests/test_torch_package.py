"""Rules of the port as a package, its CLI, its data and its model selector.

  - no module of ``garfield_tpu_torch``, and not ``chip_smoke.py``, imports
    JAX (or flax/optax) or anything of the JAX package;
  - the entry points run on CUDA by default and raise without it unless the
    caller passes ``device="cpu"``; ``chip_smoke.py`` fails without a card;
  - the CLI parses the JAX CLI's flags and rejects those of features the
    port does not have yet;
  - the data copy (surrogate, partitioner, batching) equals the JAX
    package's; the loss equals the JAX package's loss.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garfield_tpu import data as jax_data
from garfield_tpu.utils import selectors as jax_selectors
from garfield_tpu_torch import data as torch_data
from garfield_tpu_torch import models, ops
from garfield_tpu_torch.apps import aggregathor as torch_cli
from garfield_tpu_torch.parallel import aggregathor
from garfield_tpu_torch.utils import selectors, tools

REPO = pathlib.Path(__file__).resolve().parents[1]
_PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "garfield_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "garfield_tpu")

_ISSUE_CLI = [
    "--dataset", "cifar10", "--model", "resnet18", "--batch", "25",
    "--num_workers", "8", "--fw", "2", "--gar", "median", "--attack", "lie",
    "--optimizer", "sgd", "--opt_args",
    '{"lr":"0.2","momentum":"0.9","weight_decay":"0.0005"}',
    "--num_iter", "10",
]


def _imported_modules(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in _FORBIDDEN, f"{path} imports {mod}"


def test_port_has_the_slice_modules():
    have = set(_PORT_FILES)
    for rel in ("ops/coordinate.py", "ops/_build.py", "aggregators/median.py",
                "aggregators/tmean.py", "attacks/__init__.py",
                "parallel/fold.py", "parallel/core.py",
                "parallel/aggregathor.py", "models/resnet.py",
                "models/convert.py", "data/__init__.py",
                "apps/aggregathor.py"):
        assert f"garfield_tpu_torch/{rel}" in have
    assert (REPO / "garfield_tpu_torch/ops/csrc/coordinate.cu").exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tools.resolve_device()
    assert tools.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tools.resolve_device("meta")


def test_make_trainer_needs_cuda_unless_cpu(no_cuda):
    def build(**kw):
        return aggregathor.make_trainer(
            models.select_model("resnet18", "cifar10"),
            selectors.select_loss("cross-entropy"),
            selectors.select_optimizer("sgd", lr=0.1), "median",
            num_workers=8, f=2, attack="lie", **kw,
        )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    init_fn, step_fn, eval_fn = build(device="cpu")
    assert callable(init_fn) and callable(step_fn) and callable(eval_fn)


def test_ops_need_cuda_unless_cpu(no_cuda):
    x = np.zeros((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.trimmed_mean(x, 1)
    assert ops.trimmed_mean(x, 1, device="cpu").shape == (8,)


def test_cli_needs_cuda_unless_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(_ISSUE_CLI)


def test_cli_parses_the_bench_command_line():
    args = torch_cli.parse_args(_ISSUE_CLI)
    assert (args.dataset, args.model, args.batch, args.num_workers,
            args.fw, args.gar, args.attack) == (
        "cifar10", "resnet18", 25, 8, 2, "median", "lie")
    assert args.device == "cuda"


@pytest.mark.parametrize("flag", [
    ["--subset", "6"], ["--async"], ["--max_staleness", "2"],
    ["--granularity", "layer"], ["--worker_momentum", "0.9"],
    ["--telemetry"], ["--trace"], ["--chunk_steps", "4"],
    ["--checkpoint_dir", "ckpt"], ["--resume"], ["--profile_dir", "prof"],
    ["--mesh", "workers=8"], ["--defense", "weighted"],
    ["--lr_decay_epochs", "30"], ["--train_size", "100"],
    ["--fault_crashes", '{"0": 3}'], ["--num_ps", "2"], ["--fps", "1"],
    ["--autoscale"], ["--cluster", "cluster.json"], ["--task", "ps:0"],
])
def test_cli_rejects_unported_flags(flag):
    with pytest.raises(SystemExit, match="not ported yet"):
        torch_cli.parse_args(_ISSUE_CLI + flag)


def test_cli_rejects_too_many_byzantine_workers():
    with pytest.raises(SystemExit, match="less than half"):
        torch_cli.parse_args(_ISSUE_CLI + ["--fw", "4"])


@pytest.mark.parametrize("call,match", [
    (lambda: models.select_model("vgg16", "cifar10"), "Queue A item 12"),
    (lambda: models.select_model("resnet18", "pima"), "image datasets"),
    (lambda: selectors.select_optimizer("adam", lr=0.1), "not ported"),
    (lambda: selectors.select_loss("bce"), "not ported"),
    (lambda: torch_data.load_dataset("mnist"), "not ported"),
])
def test_unported_names_raise(call, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        call()


def test_resnet18_has_the_main_path_shapes():
    module = models.select_model("resnet18", "cifar10")
    sizes = [p.numel() for p in module.parameters()]
    assert len(sizes) == 62  # one kernel launch per leaf and step
    assert sum(sizes) == 11_173_962
    assert sum(1 for s in sizes if s <= 512) == 41  # 40 BN vectors, fc bias


@pytest.mark.parametrize("name,classes", [("cifar10", 10), ("cifar100", 100)])
def test_surrogate_equals_the_jax_package(name, classes):
    want = jax_data._synthetic(name, classes, (32, 32, 3), 96, 32)
    got = torch_data._synthetic(name, classes, (32, 32, 3), 96, 32)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_partitioner_and_batches_equal_the_jax_package(monkeypatch):
    small = jax_data._synthetic("cifar10", 10, (32, 32, 3), 240, 30)
    monkeypatch.setattr(jax_data, "load_dataset", lambda *a, **k: small)
    monkeypatch.setattr(torch_data, "load_dataset", lambda *a, **k: small)
    jm = jax_data.DatasetManager("cifar10", 5, 8, 8, 0)
    jm.num_ps = 0
    tm = torch_data.DatasetManager("cifar10", 5, 8)
    for a, b in zip(jm.sharded_train_batches(), tm.sharded_train_batches()):
        np.testing.assert_array_equal(a, b)
    for (xa, ya), (xb, yb) in zip(jm.get_test_set(), tm.get_test_set()):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    for frac_parts in ([0.5, 0.5], [0.25] * 4, [0.3, 0.3, 0.4]):
        jp = jax_data.DataPartitioner(101, frac_parts)
        tp = torch_data.DataPartitioner(101, frac_parts)
        for i in range(len(frac_parts)):
            np.testing.assert_array_equal(jp.use(i), tp.use(i))


@pytest.mark.parametrize("loss", ["cross-entropy", "nll"])
def test_loss_equals_the_jax_package(loss):
    rng = np.random.default_rng(9)
    out = rng.standard_normal((16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    want = jax_selectors.select_loss(loss)(jnp.asarray(out),
                                           jnp.asarray(labels))
    got = selectors.select_loss(loss)(torch.from_numpy(out),
                                      torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout
    # Alone in a directory, without the package beside it, it fails too.
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    run = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout

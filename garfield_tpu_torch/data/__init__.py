"""Deterministic dataset management (the port's own copy of the parts of
``garfield_tpu/data/__init__.py`` that the first slice needs).

  - ``DataPartitioner`` reproduces the reference's seeded equal split
    (datasets.py:121-150, seed 1234);
  - ``DatasetManager`` serves per-worker train partitions, stacked as
    ``(num_workers, num_batches, bsz, ...)`` numpy arrays, and the test set;
  - CIFAR-10/100 come from ``cifar-10-batches-py`` / ``cifar-100-python``
    pickles under ``$GARFIELD_TPU_DATA_DIR`` (default ``~/data``) when
    present, else from the deterministic synthetic surrogate with the same
    shapes, classes and seeds as the JAX package's. Nothing is downloaded.

Images are NHWC float32, labels int32, as in the JAX package.
"""

import os
import pathlib
import pickle
import zlib
from random import Random

import numpy as np

from ..utils import tools

__all__ = ["datasets_list", "DataPartitioner", "DatasetManager"]

datasets_list = ["cifar10", "cifar100"]

_UNPORTED = {
    "mnist": "ROADMAP Queue A item 12 (the rest)",
    "pima": "ROADMAP Queue A item 12 (the rest)",
    "copytask": "ROADMAP Queue A item 12 (the rest)",
}

_CIFAR_MEAN = np.array([0.485, 0.456, 0.406], np.float32)  # datasets.py:198
_CIFAR_STD = np.array([0.229, 0.224, 0.225], np.float32)

_warned_synthetic = set()


def data_dir():
    return pathlib.Path(
        os.environ.get("GARFIELD_TPU_DATA_DIR", str(pathlib.Path.home() / "data"))
    )


def _synthetic(name, num_classes, shape, n_train, n_test, binary=False):
    """Class-conditional Gaussian surrogate, deterministic and not trivially
    separable: unit-norm, spatially smooth class means scaled to
    ``GARFIELD_SURROGATE_MARGIN`` (default 3.5) against unit noise, and
    ``GARFIELD_SURROGATE_LABEL_NOISE`` (default 2%) flipped train labels.
    The same draws as the JAX package's surrogate, seed for seed."""
    if name not in _warned_synthetic:
        tools.warning(
            f"dataset {name!r} not found under {data_dir()} — using the "
            "deterministic synthetic surrogate (same shapes/classes)"
        )
        _warned_synthetic.add(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    dim = int(np.prod(shape))
    margin = float(os.environ.get("GARFIELD_SURROGATE_MARGIN", "3.5"))
    label_noise = float(
        os.environ.get("GARFIELD_SURROGATE_LABEL_NOISE", "0.02")
    )
    if len(shape) == 3:
        h, w, c = shape
        lo = rng.normal(
            0.0, 1.0,
            size=(num_classes, max(h // 4, 1), max(w // 4, 1), c),
        ).astype(np.float32)
        means = np.stack([
            np.repeat(
                np.repeat(m, -(-h // m.shape[0]), axis=0)[:h],
                -(-w // m.shape[1]), axis=1,
            )[:, :w]
            for m in lo
        ]).reshape(num_classes, dim)
    else:
        means = rng.normal(
            0.0, 1.0, size=(num_classes, dim)
        ).astype(np.float32)
    means *= margin / np.linalg.norm(means, axis=1, keepdims=True)

    def make(n, seed, train):
        r = np.random.default_rng(seed)
        y = r.integers(0, num_classes, size=n)
        x = means[y] + r.normal(size=(n, dim)).astype(np.float32)
        x = x.reshape((n,) + shape).astype(np.float32)
        if train and label_noise:
            flip = r.random(n) < label_noise
            y = np.where(
                flip, r.integers(0, num_classes, size=n), y
            )
        if binary:
            return x.reshape(n, -1), y.astype(np.float32).reshape(-1, 1)
        return x, y.astype(np.int32)

    return make(n_train, 1234, True), make(n_test, 4321, False)


def _load_cifar_files(root, name):
    if name == "cifar10":
        d = root / "cifar-10-batches-py"
        train_files = [d / f"data_batch_{i}" for i in range(1, 6)]
        test_files = [d / "test_batch"]
        label_key = b"labels"
    else:
        d = root / "cifar-100-python"
        train_files, test_files = [d / "train"], [d / "test"]
        label_key = b"fine_labels"

    def load(files):
        xs, ys = [], []
        for f in files:
            with open(f, "rb") as fh:
                batch = pickle.load(fh, encoding="bytes")
            xs.append(batch[b"data"])
            ys.extend(batch[label_key])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x, np.asarray(ys, np.int32)

    return load(train_files), load(test_files)


def _augment_once(x, seed):
    """Random crop (pad 4) + horizontal flip, sampled once per sample at load
    time (the reference's materialize-once loader, datasets.py:197-201)."""
    rng = np.random.default_rng(seed)
    n, h, w, c = x.shape
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="constant")
    ys = rng.integers(0, 9, size=n)
    xs = rng.integers(0, 9, size=n)
    flip = rng.random(n) < 0.5
    out = np.empty_like(x)
    for i in range(n):
        crop = padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
        out[i] = crop[:, ::-1] if flip[i] else crop
    return out


def load_cifar(name="cifar10", augment_train=True):
    num_classes = 10 if name == "cifar10" else 100
    try:
        (tx, ty), (vx, vy) = _load_cifar_files(data_dir(), name)
    except (FileNotFoundError, OSError):
        return _synthetic(name, num_classes, (32, 32, 3), 50000, 10000)
    norm = lambda x: (x.astype(np.float32) / 255.0 - _CIFAR_MEAN) / _CIFAR_STD
    tx = norm(tx)
    if augment_train:
        tx = _augment_once(tx, seed=1234)
    return (tx, ty), (norm(vx), vy)


def load_dataset(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet: {_UNPORTED[name]}"
        )
    if name in ("cifar10", "cifar100"):
        return load_cifar(name)
    raise ValueError(f"Existing datasets are: {datasets_list}")


class DataPartitioner:
    """Seeded equal-split partitioner, bit-compatible with the reference
    (datasets.py:121-150): one ``random.Random(seed)`` stream shuffles each
    successive leading slice of the remaining indices."""

    def __init__(self, data_len, sizes, seed=1234):
        self.partitions = []
        rng = Random()
        rng.seed(seed)
        indexes = list(range(data_len))
        for frac in sizes:
            part_len = int(frac * data_len)
            tmp = indexes[0:part_len]
            rng.shuffle(tmp)
            self.partitions.append(tmp)
            indexes = indexes[part_len:]

    def use(self, partition):
        return np.asarray(self.partitions[partition], dtype=np.int64)


def _batchify(x, y, bsz):
    """Full batches only (the tail remainder is dropped, as in the JAX
    package)."""
    n = (len(x) // bsz) * bsz
    xb = x[:n].reshape((-1, bsz) + x.shape[1:])
    yb = y[:n].reshape((-1, bsz) + y.shape[1:])
    return xb, yb


class DatasetManager:
    """Per-worker dataset view: ``minibatch`` is the per-worker batch size;
    worker w holds partition w of ``num_workers`` equal seeded splits."""

    def __init__(self, dataset, minibatch, num_workers):
        if dataset not in datasets_list and dataset not in _UNPORTED:
            raise ValueError(f"Existing datasets are: {datasets_list}")
        self.dataset = dataset
        self.minibatch = int(minibatch)
        self.num_workers = int(num_workers)
        self._train = None
        self._test = None

    def _load(self):
        if self._train is None:
            self._train, self._test = load_dataset(self.dataset)
        return self._train, self._test

    def get_train_set(self, worker):
        """Worker ``worker``'s batches as (num_batches, bsz, ...) arrays;
        batch i of a run is index ``i % num_batches``."""
        (tx, ty), _ = self._load()
        sizes = [1.0 / self.num_workers] * self.num_workers
        idx = DataPartitioner(len(tx), sizes).use(worker)
        return _batchify(tx[idx], ty[idx], self.minibatch)

    def sharded_train_batches(self):
        """All workers' batch streams stacked: (W, B, bsz, ...)."""
        xs, ys = zip(*(self.get_train_set(w) for w in range(self.num_workers)))
        nb = min(x.shape[0] for x in xs)
        return (np.stack([x[:nb] for x in xs]),
                np.stack([y[:nb] for y in ys]))

    def get_test_set(self, batch=100):
        """Global test set as a list of (x, y) batches of ``batch``; the last
        may be smaller."""
        _, (vx, vy) = self._load()
        return [(vx[i : i + batch], vy[i : i + batch])
                for i in range(0, len(vx), batch)]

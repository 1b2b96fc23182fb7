"""CIFAR-10/100 (ref: python/paddle/v2/dataset/cifar.py — 32x32x3, 50k/10k).
Synthetic mode: class-conditional colour/texture blobs.  Real files (the
python-pickle batch format) are used when present under
$PADDLE_TPU_DATA_HOME/cifar/cifar-{10-batches,100}-py/.

The port's copy of ``paddle_tpu/datasets/cifar.py``; numpy only, sample for
sample the JAX package's."""
from __future__ import annotations

import os
import pickle

import numpy as np

from . import common


def _try_real(split, n_classes):
    """Read the standard pickled batches if the extracted archive is cached."""
    if n_classes == 10:
        base = common.cached_path("cifar", "cifar-10-batches-py")
        names = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
                 else ["test_batch"])
        label_key = b"labels"
    else:
        base = common.cached_path("cifar", "cifar-100-python")
        names = ["train" if split == "train" else "test"]
        label_key = b"fine_labels"
    if base is None:
        return None
    imgs, labels = [], []
    for n in names:
        p = os.path.join(base, n)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32))
        labels.extend(d[label_key])
    imgs = np.concatenate(imgs).astype("float32") / 255.0
    return imgs, np.asarray(labels, "int64")


def _synthetic(n, n_classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, n).astype("int64")
    imgs = rng.rand(n, 3, 32, 32).astype("float32") * 0.3
    for i, y in enumerate(labels):
        ch = int(y) % 3
        pos = (int(y) // 3) % 8
        imgs[i, ch, pos * 4: pos * 4 + 4, :] += 0.7
    return imgs, labels


def _reader(n, n_classes, seed, split="train"):
    def reader():
        real = _try_real(split, n_classes)
        imgs, labels = real if real is not None else _synthetic(n, n_classes, seed)
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])

    return reader


def train10(n_synthetic: int = 8192):
    return _reader(n_synthetic, 10, 0, "train")


def test10(n_synthetic: int = 1024):
    return _reader(n_synthetic, 10, 1, "test")


def train100(n_synthetic: int = 8192):
    return _reader(n_synthetic, 100, 2, "train")


def test100(n_synthetic: int = 1024):
    return _reader(n_synthetic, 100, 3, "test")

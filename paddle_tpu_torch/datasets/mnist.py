"""MNIST (ref: python/paddle/v2/dataset/mnist.py — 60k/10k 28x28 grayscale,
labels 0-9, pixel values normalised to [-1, 1] in the reference loader).

Synthetic mode draws class-conditional digit-like blobs so LeNet reaches high
accuracy — enough to drive the book-test convergence pattern hermetically.  Real
files (idx format) are used when present under $PADDLE_TPU_DATA_HOME/mnist.

The port's copy of ``paddle_tpu/datasets/mnist.py``; numpy only, sample for
sample the JAX package's."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

N_CLASSES = 10
IMG_SHAPE = (1, 28, 28)


def _data_home():
    return os.environ.get("PADDLE_TPU_DATA_HOME", os.path.expanduser("~/.cache/paddle_tpu"))


def _try_real(split):
    base = os.path.join(_data_home(), "mnist")
    names = {"train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
             "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")}[split]
    paths = [os.path.join(base, n) for n in names]
    if not all(os.path.exists(p) for p in paths):
        return None

    with gzip.open(paths[0], "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        imgs = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, 1, rows, cols)
    with gzip.open(paths[1], "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    imgs = imgs.astype("float32") / 127.5 - 1.0
    return imgs, labels.astype("int64")


def _synthetic(split, n):
    rng = np.random.RandomState(0 if split == "train" else 1)
    labels = rng.randint(0, N_CLASSES, n).astype("int64")
    imgs = rng.rand(n, 1, 28, 28).astype("float32") * 0.2 - 1.0
    # class-conditional stroke pattern: a bright bar whose position/orientation
    # encodes the digit
    for i, y in enumerate(labels):
        r, c = divmod(int(y), 5)
        imgs[i, 0, 4 + r * 12: 10 + r * 12, 2 + c * 5: 6 + c * 5] = 1.0
    return imgs, labels


def _reader(split, n_synth):
    def reader():
        real = _try_real(split)
        imgs, labels = real if real is not None else _synthetic(split, n_synth)
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])

    return reader


def train(n_synthetic: int = 8192):
    return _reader("train", n_synthetic)


def test(n_synthetic: int = 1024):
    return _reader("test", n_synthetic)

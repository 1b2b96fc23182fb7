"""UCI housing regression (ref: python/paddle/v2/dataset/uci_housing.py — 13
features, 506 rows, feature-normalised, 80/20 train/test split).

Real mode: the official whitespace-separated ``housing.data`` (14 numeric
columns, last = MEDV target) at $PADDLE_TPU_DATA_HOME/uci_housing/ — the
same file the reference downloads; features normalised mean-centred over
the range like the reference's feature_range(): (x - mean)/(max - min).
Synthetic mode: a fixed
linear+noise model over 13 standardised features (fit_a_line converges on
it).

The port's copy of ``paddle_tpu/datasets/uci_housing.py``; numpy only,
sample for sample the JAX package's."""
from __future__ import annotations

import numpy as np

from . import common

FEATURE_DIM = 13
TRAIN_ROWS = 404  # reference's UCI_TRAIN_DATA/UCI_TEST_DATA split boundary
_TRUE_W = np.array([0.8, -1.2, 0.5, 0.0, 2.0, -0.3, 1.1, 0.0, -0.7, 0.4, 0.9, -1.5, 0.2],
                   dtype="float32")


def _load_real():
    path = common.cached_path("uci_housing", "housing.data")
    if path is None:
        raise FileNotFoundError(
            "housing.data not found under $PADDLE_TPU_DATA_HOME/uci_housing")
    table = np.loadtxt(path, dtype="float32")
    if table.ndim != 2 or table.shape[1] != FEATURE_DIM + 1:
        raise ValueError(f"housing.data must have {FEATURE_DIM + 1} columns, "
                         f"got shape {table.shape}")
    x, y = table[:, :FEATURE_DIM], table[:, FEATURE_DIM:]
    # the reference's feature_range normalisation is MEAN-centred:
    # (x - column_mean) / (max - min)
    x = (x - x.mean(axis=0)) / np.maximum(x.max(axis=0) - x.min(axis=0), 1e-8)
    return x.astype("float32"), y.astype("float32")


def _real_reader(split):
    # loaded once here, not per epoch inside reader()
    x, y = _load_real()
    sl = slice(0, TRAIN_ROWS) if split == "train" else slice(TRAIN_ROWS, None)

    def reader():
        for xi, yi in zip(x[sl], y[sl]):
            yield xi, yi

    return reader


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            x = rng.randn(FEATURE_DIM).astype("float32")
            y = float(x @ _TRUE_W + 22.5 + rng.randn() * 0.1)
            yield x, np.array([y], "float32")

    return reader


def train(n_synthetic: int = 404):
    if common.cached_path("uci_housing", "housing.data"):
        return _real_reader("train")
    return _reader(n_synthetic, 0)


def test(n_synthetic: int = 102):
    if common.cached_path("uci_housing", "housing.data"):
        return _real_reader("test")
    return _reader(n_synthetic, 1)

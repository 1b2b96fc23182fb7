"""Criteo-style CTR dataset (ref: BASELINE.json configs[3] 'CTR DeepFM /
wide&deep'; the reference's high-dim sparse path — SparseRemoteParameterUpdater,
SelectedRows — exercised by ad-click models).

Synthetic mode: 13 dense + 26 categorical fields; the click probability is a
ground-truth factorization machine over the category embeddings, so FM-family
models can actually fit it.

Real mode: the Criteo display-ads format at $PADDLE_TPU_DATA_HOME/ctr/
{train,test}.txt — tab-separated ``label \\t I1..I13 \\t C1..C26`` with
empty fields allowed; integer features log-squashed, category hex strings
hashed into each field's vocabulary (the standard hashing-trick
preprocessing for this corpus).

The port's copy of ``paddle_tpu/datasets/ctr.py``, numpy only: the
synthetic and the real-file readers give the JAX package's samples, sample
for sample.
"""
from __future__ import annotations

import numpy as np

from . import common

NUM_DENSE = 13
NUM_SPARSE = 26
# per-field vocabulary sizes: a few large (hashing-trick scale, no learnable
# signal — ids almost never repeat), a band of mid-size fields, and a core of
# small frequently-recurring fields that carry the interaction signal
FIELD_VOCABS = ([100003, 50021, 10007]
                + [997 + 101 * i for i in range(NUM_SPARSE - 11)]
                + [23 + 7 * i for i in range(8)])


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        k = 4
        gt = np.random.RandomState(7)
        dense_w = gt.randn(NUM_DENSE) * 0.6
        # id-level ground-truth factors for the small-vocab fields (ids recur
        # across train/test, so the interaction structure is learnable
        # out-of-sample); the three hashing-scale fields carry no signal —
        # their ids almost never repeat, like real hashed features
        tables = [gt.randn(v, k) * 0.5 if v <= 100 else None
                  for v in FIELD_VOCABS]  # signal lives in the 8 small fields
        for _ in range(n):
            dense = rng.rand(NUM_DENSE).astype("float32")
            ids = np.array([rng.randint(v) for v in FIELD_VOCABS], "int64")
            vecs = np.stack([t[i] for t, i in zip(tables, ids) if t is not None])
            second = 0.5 * (vecs.sum(0) ** 2 - (vecs ** 2).sum(0)).sum()
            logit = float(dense @ dense_w + 1.0 * second - 0.6)
            p = 1.0 / (1.0 + np.exp(-logit))
            yield dense, ids, int(rng.rand() < p)

    return reader


def _real_reader(path):
    import zlib

    def reader():
        n_rows = n_bad = 0
        with open(path) as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) != 1 + NUM_DENSE + NUM_SPARSE:
                    n_bad += 1  # e.g. the unlabeled 39-column Criteo test set
                    continue
                n_rows += 1
                label = int(cols[0])
                dense = np.zeros(NUM_DENSE, "float32")
                for i, v in enumerate(cols[1:1 + NUM_DENSE]):
                    if v:
                        # log-squash the heavy-tailed counts (standard Criteo
                        # preprocessing; negatives clamp to 0)
                        dense[i] = np.log1p(max(int(v), 0))
                ids = np.zeros(NUM_SPARSE, "int64")
                for i, v in enumerate(cols[1 + NUM_DENSE:]):
                    if v:
                        h = zlib.crc32(v.encode()) & 0xFFFFFFFF
                        ids[i] = h % FIELD_VOCABS[i]
                yield dense, ids, label
        if n_rows == 0 and n_bad > 0:
            raise ValueError(
                f"{path}: {n_bad} rows, none in the labeled Criteo format "
                f"(label\\t13 ints\\t26 cats) — wrong file?")

    return reader


def train(n_synthetic: int = 8192):
    p = common.cached_path("ctr", "train.txt")
    if p:
        return _real_reader(p)
    return _reader(n_synthetic, 0)


def test(n_synthetic: int = 1024):
    p = common.cached_path("ctr", "test.txt")
    if p:
        return _real_reader(p)
    return _reader(n_synthetic, 1)

"""Criteo-style CTR dataset, synthetic half (PyTorch port of
``paddle_tpu/datasets/ctr.py``; ref: BASELINE.json configs[3], "CTR
DeepFM / wide&deep").

13 dense and 26 categorical fields (``FIELD_VOCABS``: 185,971 rows
together); the click probability is a ground-truth factorization machine
over the eight small fields' id factors, so FM-family models can fit it.
The draws are numpy ``RandomState`` ones, the JAX package's sample for
sample under the same ``n_synthetic`` and seed (0 for train, 1 for test).
The reader of Criteo's tab-separated files is not ported (ROADMAP A.12
part 4): ``real_reader`` raises."""
from __future__ import annotations

import numpy as np

NUM_DENSE = 13
NUM_SPARSE = 26
# per-field vocabulary sizes: a few large (hashing-trick scale), a band of
# mid-size fields, and a core of small recurring fields carrying the signal
FIELD_VOCABS = ([100003, 50021, 10007]
                + [997 + 101 * i for i in range(NUM_SPARSE - 11)]
                + [23 + 7 * i for i in range(8)])


def real_reader(*_args, **_kwargs):
    raise NotImplementedError(
        "the Criteo file reader of paddle_tpu/datasets/ctr.py is not ported "
        "yet (ROADMAP A.12 part 4); the synthetic train() and test() are")


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        k = 4
        gt = np.random.RandomState(7)
        dense_w = gt.randn(NUM_DENSE) * 0.6
        tables = [gt.randn(v, k) * 0.5 if v <= 100 else None
                  for v in FIELD_VOCABS]
        for _ in range(n):
            dense = rng.rand(NUM_DENSE).astype("float32")
            ids = np.array([rng.randint(v) for v in FIELD_VOCABS], "int64")
            vecs = np.stack([t[i] for t, i in zip(tables, ids)
                             if t is not None])
            second = 0.5 * (vecs.sum(0) ** 2 - (vecs ** 2).sum(0)).sum()
            logit = float(dense @ dense_w + 1.0 * second - 0.6)
            p = 1.0 / (1.0 + np.exp(-logit))
            yield dense, ids, int(rng.rand() < p)

    return reader


def train(n_synthetic: int = 8192):
    """The synthetic training reader: ``n_synthetic`` samples ``(dense
    [13] float32, ids [26] int64, click)``, seed 0."""
    return _reader(n_synthetic, 0)


def test(n_synthetic: int = 1024):
    """The synthetic test reader: ``n_synthetic`` samples, seed 1."""
    return _reader(n_synthetic, 1)

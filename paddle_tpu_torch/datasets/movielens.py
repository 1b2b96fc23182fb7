"""MovieLens-1M, synthetic half (port of
``paddle_tpu/datasets/movielens.py``; ref: python/paddle/v2/dataset/
movielens.py, the recommender book chapter's dataset).

A sample is ``(user id, gender, age bucket, job, movie id, category,
rating [1])`` over ml-1m's table sizes, the rating ``clip(3 + u . m +
N(0, 0.2^2), 1, 5)`` from 8-dimensional latent factors of the user and the
movie, so a model can learn it.  The draws are numpy ``RandomState``
ones, the JAX package's sample for sample under the same ``n_synthetic``
and seed (0 for train, 1 for test).  The reader of ml-1m's ``.dat`` files
is not ported (ROADMAP A.12 part 4): ``real_files`` raises."""
from __future__ import annotations

import numpy as np

N_USERS = 6040
N_MOVIES = 3952
N_AGES = 7
N_JOBS = 21
N_CATEGORIES = 18


def real_files(*_args, **_kwargs):
    raise NotImplementedError(
        "the ml-1m file reader of paddle_tpu/datasets/movielens.py is not "
        "ported yet (ROADMAP A.12 part 4); the synthetic train() and test() "
        "are")


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        uf = rng.randn(N_USERS, 8) * 0.5
        mf = rng.randn(N_MOVIES, 8) * 0.5
        for _ in range(n):
            u = int(rng.randint(N_USERS))
            m = int(rng.randint(N_MOVIES))
            rating = float(np.clip(3.0 + uf[u] @ mf[m] + rng.randn() * 0.2,
                                   1.0, 5.0))
            gender = int(rng.randint(2))
            age = int(rng.randint(N_AGES))
            job = int(rng.randint(N_JOBS))
            category = int(rng.randint(N_CATEGORIES))
            yield (u, gender, age, job, m, category,
                   np.array([rating], "float32"))

    return reader


def train(n_synthetic: int = 16384):
    """The synthetic training reader: ``n_synthetic`` ratings, seed 0."""
    return _reader(n_synthetic, 0)


def test(n_synthetic: int = 2048):
    """The synthetic test reader: ``n_synthetic`` ratings, seed 1."""
    return _reader(n_synthetic, 1)

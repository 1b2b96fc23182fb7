"""MovieLens-1M style (ref: python/paddle/v2/dataset/movielens.py — user/movie
ids + metadata + rating 1..5; drives the recommender book chapter and the
sparse-embedding path).  Synthetic mode: latent-factor ratings.  Real data
(the ml-1m ``::``-separated .dat layout) is used when present under
$PADDLE_TPU_DATA_HOME/movielens/ml-1m.

The port's copy of ``paddle_tpu/datasets/movielens.py``, numpy only: the
synthetic and the real-file readers give the JAX package's samples, sample
for sample.
"""
from __future__ import annotations

import os

import numpy as np

from . import common

N_USERS = 6040
N_MOVIES = 3952
N_AGES = 7
N_JOBS = 21
N_CATEGORIES = 18

_AGE_BUCKETS = {1: 0, 18: 1, 25: 2, 35: 3, 45: 4, 50: 5, 56: 6}
_GENRES = ("Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
           "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
           "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western")


def _try_real(split, test_frac=0.1):
    base = common.cached_path("movielens", "ml-1m")
    if base is None:
        return None
    paths = {n: os.path.join(base, f"{n}.dat") for n in ("users", "movies", "ratings")}
    if not all(os.path.exists(p) for p in paths.values()):
        return None

    users = {}
    with open(paths["users"], encoding="latin1") as f:
        for line in f:
            uid, gender, age, job, _zip = line.strip().split("::")
            users[int(uid)] = (int(gender == "F"), _AGE_BUCKETS.get(int(age), 0),
                               int(job))
    movies = {}
    with open(paths["movies"], encoding="latin1") as f:
        for line in f:
            mid, _title, genres = line.strip().split("::")
            g = genres.split("|")[0]
            movies[int(mid)] = _GENRES.index(g) if g in _GENRES else 0

    rows = []
    with open(paths["ratings"], encoding="latin1") as f:
        for line in f:
            uid, mid, rating, _ts = line.strip().split("::")
            rows.append((int(uid), int(mid), float(rating)))
    # deterministic split by row hash (the reference splits by rand(0,1) < 0.9)
    test = [r for i, r in enumerate(rows) if i % int(1 / test_frac) == 0]
    train = [r for i, r in enumerate(rows) if i % int(1 / test_frac) != 0]
    picked = test if split == "test" else train

    def gen():
        for uid, mid, rating in picked:
            gender, age, job = users.get(uid, (0, 0, 0))
            cat = movies.get(mid, 0)
            yield (uid - 1, gender, age, job, mid - 1, cat,
                   np.array([rating], "float32"))

    return gen


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        uf = rng.randn(N_USERS, 8) * 0.5
        mf = rng.randn(N_MOVIES, 8) * 0.5
        for _ in range(n):
            u = int(rng.randint(N_USERS))
            m = int(rng.randint(N_MOVIES))
            rating = float(np.clip(3.0 + uf[u] @ mf[m] + rng.randn() * 0.2, 1.0, 5.0))
            gender = int(rng.randint(2))
            age = int(rng.randint(N_AGES))
            job = int(rng.randint(N_JOBS))
            category = int(rng.randint(N_CATEGORIES))
            yield u, gender, age, job, m, category, np.array([rating], "float32")

    return reader


def train(n_synthetic: int = 16384):
    return _try_real("train") or _reader(n_synthetic, 0)


def test(n_synthetic: int = 2048):
    return _try_real("test") or _reader(n_synthetic, 1)

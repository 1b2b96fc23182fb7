"""Recommender system, dual-tower rating regression, the book chapter
(PyTorch port of ``paddle_tpu/models/recommender.py``; ref: fluid/tests/
book/test_recommender_system.py, dataset ``datasets/movielens.py``).

User tower: id / gender / age / job embeddings -> fc tanh.  Movie tower:
id / category embeddings -> fc tanh.  Their ``cos_sim`` scaled to [0, 5]
regresses the rating."""
from __future__ import annotations

from .. import layers
from ..datasets import movielens


def build(uid, gender, age, job, mid, category, rating,
          emb_dim: int = 32, fc_size: int = 200, is_sparse: bool = False):
    """Each id: [N, 1] int32; rating: [N, 1] float32.  Returns (avg_cost,
    predict).  ``is_sparse`` routes every lookup through the sparse
    engine's ``sparse_lookup`` (``layers.embedding``)."""
    usr_feats = [
        layers.embedding(uid, [movielens.N_USERS, emb_dim],
                         is_sparse=is_sparse),
        layers.embedding(gender, [2, emb_dim // 2], is_sparse=is_sparse),
        layers.embedding(age, [movielens.N_AGES, emb_dim // 2],
                         is_sparse=is_sparse),
        layers.embedding(job, [movielens.N_JOBS, emb_dim // 2],
                         is_sparse=is_sparse),
    ]
    usr = layers.fc(layers.concat(usr_feats, axis=1), fc_size, act="tanh")

    mov_feats = [
        layers.embedding(mid, [movielens.N_MOVIES, emb_dim],
                         is_sparse=is_sparse),
        layers.embedding(category, [movielens.N_CATEGORIES, emb_dim // 2],
                         is_sparse=is_sparse),
    ]
    mov = layers.fc(layers.concat(mov_feats, axis=1), fc_size, act="tanh")

    sim = layers.cos_sim(usr, mov)                    # [N, 1] in [-1, 1]
    predict = layers.scale(sim, scale=2.5, bias=2.5)  # -> [0, 5]
    cost = layers.mean(layers.square_error_cost(predict, rating))
    return cost, predict

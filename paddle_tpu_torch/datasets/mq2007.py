"""MQ2007 learning-to-rank (ref: python/paddle/v2/dataset/mq2007.py — LETOR
query/doc pairs, 46 features, relevance 0-2; pointwise/pairwise/listwise
modes).  Synthetic mode: relevance is a noisy linear function of the features
so ranking models converge.

Real mode: official LETOR rows at $PADDLE_TPU_DATA_HOME/mq2007/
{train,test}.txt — ``rel qid:N 1:v 2:v ... 46:v #docid = ...`` — grouped by
qid and emitted in the same three formats.

The port's copy of ``paddle_tpu/datasets/mq2007.py``; numpy only, sample for
sample the JAX package's."""
from __future__ import annotations

import numpy as np

from . import common

FEATURE_DIM = 46


def _parse_letor(path):
    """Yield (qid, feats [46] f32, rel) per row; '#' starts a comment."""
    with open(path) as f:
        for line in f:
            row = line.split("#", 1)[0].split()
            if not row:
                continue
            rel = int(row[0])
            qid = row[1].split(":", 1)[1]
            feats = np.zeros(FEATURE_DIM, "float32")
            for tok in row[2:]:
                k, v = tok.split(":", 1)
                feats[int(k) - 1] = float(v)
            yield qid, feats, rel


def _real_queries(path):
    """Group rows by qid preserving file order (LETOR files are contiguous
    per query)."""
    cur, feats, rels = None, [], []
    for qid, f, r in _parse_letor(path):
        if qid != cur and cur is not None:
            yield np.stack(feats), np.array(rels, "int64")
            feats, rels = [], []
        cur = qid
        feats.append(f)
        rels.append(r)
    if feats:
        yield np.stack(feats), np.array(rels, "int64")


def _real_reader(path, format):
    def reader():
        for feats, rel in _real_queries(path):
            n_docs = len(rel)
            if format == "pointwise":
                for i in range(n_docs):
                    yield int(rel[i]), feats[i].tolist()
            elif format == "pairwise":
                for i in range(n_docs):
                    for j in range(n_docs):
                        if rel[i] > rel[j]:
                            yield 1.0, feats[i].tolist(), feats[j].tolist()
            else:  # listwise
                yield rel.tolist(), feats.tolist()

    return reader


def _make_query(rng, w, n_docs):
    feats = rng.rand(n_docs, FEATURE_DIM).astype("float32")
    raw = feats @ w + rng.randn(n_docs) * 0.05
    # quantize to 0/1/2 relevance by within-query terciles
    order = np.argsort(raw)
    rel = np.zeros(n_docs, "int64")
    rel[order[n_docs // 3: 2 * n_docs // 3]] = 1
    rel[order[2 * n_docs // 3:]] = 2
    return feats, rel


def _reader(n_queries, seed, format):
    def reader():
        rng = np.random.RandomState(seed)
        w = np.random.RandomState(42).rand(FEATURE_DIM)
        for qid in range(n_queries):
            n_docs = int(rng.randint(5, 20))
            feats, rel = _make_query(rng, w, n_docs)
            if format == "pointwise":
                for i in range(n_docs):
                    yield int(rel[i]), feats[i].tolist()
            elif format == "pairwise":
                for i in range(n_docs):
                    for j in range(n_docs):
                        if rel[i] > rel[j]:
                            yield 1.0, feats[i].tolist(), feats[j].tolist()
            else:  # listwise
                yield rel.tolist(), feats.tolist()

    return reader


def train(format: str = "pairwise", n_synthetic: int = 120):
    p = common.cached_path("mq2007", "train.txt")
    if p:
        return _real_reader(p, format)
    return _reader(n_synthetic, 0, format)


def test(format: str = "pairwise", n_synthetic: int = 30):
    p = common.cached_path("mq2007", "test.txt")
    if p:
        return _real_reader(p, format)
    return _reader(n_synthetic, 1, format)

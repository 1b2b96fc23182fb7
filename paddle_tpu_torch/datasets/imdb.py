"""IMDB sentiment (ref: python/paddle/v2/dataset/imdb.py — movie reviews,
word-id sequences + binary label; the benchmark rnn config trains on it).
Synthetic mode: two token distributions with sentiment-marker tokens.  Real
data (the extracted aclImdb directory layout: {train,test}/{pos,neg}/*.txt)
is used when present under $PADDLE_TPU_DATA_HOME/imdb/aclImdb.

The port's copy of ``paddle_tpu/datasets/imdb.py``; numpy only, sample for
sample the JAX package's."""
from __future__ import annotations

import glob
import os

import numpy as np

from . import common

VOCAB_SIZE = 5147  # reference's cutoff vocab is data-dependent; fixed here

POS_MARKERS = (11, 23, 37)
NEG_MARKERS = (13, 29, 41)


def _real_files(split, label):
    base = common.cached_path("imdb", "aclImdb", split, label)
    return sorted(glob.glob(os.path.join(base, "*.txt"))) if base else []


def _build_word_dict():
    """Frequency-ranked dict from the train split, truncated to VOCAB_SIZE
    (the reference's build_dict with cutoff, v2/dataset/imdb.py).
    ids 0..9 reserved (padding + markers live below 50 in synthetic mode)."""
    return common.freq_ranked_dict(
        (p for label in ("pos", "neg") for p in _real_files("train", label)),
        first_id=10, max_size=VOCAB_SIZE - 11)


def word_dict():
    if _real_files("train", "pos"):
        return _build_word_dict()
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _real_reader(split, word_idx):
    unk = len(word_idx) + 10

    def reader():
        for y, label in ((1, "pos"), (0, "neg")):
            for p in _real_files(split, label):
                toks = [word_idx.get(w, unk)
                        for w in common.file_tokens(p)]
                if toks:
                    yield toks, y

    return reader


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            y = int(rng.randint(0, 2))
            ln = int(rng.randint(20, 120))
            toks = rng.randint(50, VOCAB_SIZE, ln)
            markers = POS_MARKERS if y else NEG_MARKERS
            idx = rng.choice(ln, size=max(2, ln // 10), replace=False)
            toks[idx] = rng.choice(markers, size=len(idx))
            yield toks.astype("int64").tolist(), y

    return reader


def train(word_idx=None, n_synthetic: int = 4096):
    if _real_files("train", "pos"):
        return _real_reader("train", word_idx or word_dict())
    return _reader(n_synthetic, 0)


def test(word_idx=None, n_synthetic: int = 512):
    if _real_files("test", "pos"):
        return _real_reader("test", word_idx or word_dict())
    return _reader(n_synthetic, 1)

"""Movie-review sentiment (ref: python/paddle/v2/dataset/sentiment.py — NLTK
movie_reviews corpus, word-id sequences + binary polarity label).  Synthetic
mode mirrors imdb's marker-token construction with a smaller vocab.

Real mode: the NLTK movie_reviews directory layout
($PADDLE_TPU_DATA_HOME/sentiment/movie_reviews/{pos,neg}/*.txt); the word
dict is frequency-ranked over the whole corpus like the reference's
get_word_dict, and each polarity's files split 80/20 into train/test.

The port's copy of ``paddle_tpu/datasets/sentiment.py``; numpy only, sample
for sample the JAX package's."""
from __future__ import annotations

import glob
import os

import numpy as np

from . import common

VOCAB_SIZE = 2048

POS_MARKERS = (7, 19, 31)
NEG_MARKERS = (5, 17, 43)

UNK = "<unk>"


def _real_files(label):
    base = common.cached_path("sentiment", "movie_reviews", label)
    return sorted(glob.glob(os.path.join(base, "*.txt"))) if base else []


def _real_ready():
    # BOTH polarities required: a pos-only layout would silently yield a
    # single-class corpus (and 100%-accurate nonsense downstream)
    return _real_files("pos") and _real_files("neg")


def get_word_dict():
    if _real_ready():
        # frequency-ranked ids, most common first (reference get_word_dict);
        # <unk> lives INSIDE the dict so embeddings sized len(dict) always
        # cover every emitted id
        d = common.freq_ranked_dict(
            p for label in ("pos", "neg") for p in _real_files(label))
        d[UNK] = len(d)
        return d
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _real_reader(split, word_idx):
    unk = word_idx.get(UNK, len(word_idx) - 1)

    def reader():
        for y, label in ((1, "pos"), (0, "neg")):
            files = _real_files(label)
            cut = int(len(files) * 0.8)
            chosen = files[:cut] if split == "train" else files[cut:]
            for p in chosen:
                ids = [word_idx.get(w, unk) for w in common.file_tokens(p)]
                if ids:
                    yield ids, y

    return reader


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            y = int(rng.randint(0, 2))
            ln = int(rng.randint(10, 80))
            toks = rng.randint(50, VOCAB_SIZE, ln)
            markers = POS_MARKERS if y else NEG_MARKERS
            idx = rng.choice(ln, size=max(2, ln // 8), replace=False)
            toks[idx] = rng.choice(markers, size=len(idx))
            yield toks.astype("int64").tolist(), y

    return reader


def train(n_synthetic: int = 1600, word_idx=None):
    if _real_ready():
        return _real_reader("train", word_idx or get_word_dict())
    return _reader(n_synthetic, 0)


def test(n_synthetic: int = 400, word_idx=None):
    if _real_ready():
        return _real_reader("test", word_idx or get_word_dict())
    return _reader(n_synthetic, 1)

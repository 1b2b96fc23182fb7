"""PTB/imikolov language-model n-grams (ref: python/paddle/v2/dataset/
imikolov.py — word n-gram windows for the word2vec book chapter).
Synthetic mode: Markov-chain token stream with a fixed transition structure.

Real mode: the official Penn Treebank text files
($PADDLE_TPU_DATA_HOME/imikolov/ptb.{train,valid}.txt — one
space-tokenised sentence per line, the reference's simple-examples
layout).  Semantics match the reference reader exactly: the dict counts
words over train+test with one <s> and one <e> tallied per line, drops
PTB's own <unk>, keeps words with frequency strictly > cutoff ranked by
(-freq, word), and appends <unk> last; each sentence is windowed as
<s> + tokens + <e> and skipped when shorter than n.

The port's copy of ``paddle_tpu/datasets/imikolov.py``, numpy only: the
synthetic and the real-file readers give the JAX package's samples, sample
for sample.
"""
from __future__ import annotations

import numpy as np

from . import common

VOCAB_SIZE = 2074


def _real_path(split):
    name = {"train": "ptb.train.txt", "test": "ptb.valid.txt"}[split]
    return common.cached_path("imikolov", name)


def _real_ready():
    """Both splits must be present: a real train dict with a synthetic test
    stream (or vice versa) would mix incompatible vocabularies."""
    return _real_path("train") and _real_path("test")


def _real_dict(min_word_freq: int = 50):
    from collections import Counter

    # the reference's word_count runs over train AND test, tallying one
    # <s> and one <e> per line, so the sentence markers earn high-frequency
    # ids instead of being appended at the tail
    freq: Counter = Counter()
    for split in ("train", "test"):
        with open(_real_path(split)) as f:
            for line in f:
                freq.update(line.split())
                freq["<s>"] += 1
                freq["<e>"] += 1
    freq.pop("<unk>", None)  # PTB text marks rare words itself; re-reserve
    kept = sorted((w for w, c in freq.items() if c > min_word_freq),
                  key=lambda w: (-freq[w], w))
    d = {w: i for i, w in enumerate(kept)}
    d["<unk>"] = len(d)
    return d


def word_dict(min_word_freq: int = 50):
    if _real_ready():
        return _real_dict(min_word_freq)
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _real_reader(split, word_idx, n):
    unk = word_idx["<unk>"]

    def reader():
        with open(_real_path(split)) as f:
            for line in f:
                toks = ["<s>"] + line.split() + ["<e>"]
                if len(toks) < n:  # reference skips too-short sentences
                    continue
                ids = [word_idx.get(w, unk) for w in toks]
                for i in range(len(ids) - n + 1):
                    yield tuple(ids[i: i + n])

    return reader


def _reader(n, window, seed):
    def reader():
        rng = np.random.RandomState(seed)
        tok = int(rng.randint(VOCAB_SIZE))
        stream = []
        for _ in range(n + window):
            tok = (tok * 31 + int(rng.randint(7))) % VOCAB_SIZE  # learnable chain
            stream.append(tok)
        for i in range(n):
            yield tuple(stream[i: i + window])

    return reader


def train(word_idx=None, n: int = 5, n_synthetic: int = 8192):
    if _real_ready():
        return _real_reader("train", word_idx or word_dict(), n)
    return _reader(n_synthetic, n, 0)


def test(word_idx=None, n: int = 5, n_synthetic: int = 1024):
    if _real_ready():
        return _real_reader("test", word_idx or word_dict(), n)
    return _reader(n_synthetic, n, 1)

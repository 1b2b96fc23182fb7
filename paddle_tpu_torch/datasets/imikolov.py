"""PTB / imikolov n-grams, synthetic half (port of
``paddle_tpu/datasets/imikolov.py``; ref: python/paddle/v2/dataset/
imikolov.py, the word2vec book chapter's dataset).

A sample is a window of ``n`` token ids over a Markov chain on the
reference's vocabulary size, ``tok -> (31 tok + r) mod VOCAB_SIZE`` with r
uniform in [0, 7), so a model can learn the next word from the context.
The draws are numpy ``RandomState`` ones, the JAX package's sample for
sample under the same ``n``, ``n_synthetic`` and seed (0 for train, 1 for
test).  The reader of the Penn Treebank text files is not ported (ROADMAP
A.12 part 4): a word dictionary other than the synthetic one raises."""
from __future__ import annotations

import numpy as np

VOCAB_SIZE = 2074


def word_dict(min_word_freq: int = 50):
    """The synthetic vocabulary ``{"w0": 0, ..., "w2073": 2073}``."""
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _check_dict(word_idx):
    if word_idx is not None and word_idx != word_dict():
        raise NotImplementedError(
            "the Penn Treebank file reader of paddle_tpu/datasets/"
            "imikolov.py is not ported yet (ROADMAP A.12 part 4); the "
            "synthetic train() and test() are")


def _reader(n, window, seed):
    def reader():
        rng = np.random.RandomState(seed)
        tok = int(rng.randint(VOCAB_SIZE))
        stream = []
        for _ in range(n + window):
            tok = (tok * 31 + int(rng.randint(7))) % VOCAB_SIZE
            stream.append(tok)
        for i in range(n):
            yield tuple(stream[i: i + window])

    return reader


def train(word_idx=None, n: int = 5, n_synthetic: int = 8192):
    """The synthetic training reader: ``n_synthetic`` windows of ``n``
    ids, seed 0."""
    _check_dict(word_idx)
    return _reader(n_synthetic, n, 0)


def test(word_idx=None, n: int = 5, n_synthetic: int = 1024):
    """The synthetic test reader: ``n_synthetic`` windows of ``n`` ids,
    seed 1."""
    _check_dict(word_idx)
    return _reader(n_synthetic, n, 1)

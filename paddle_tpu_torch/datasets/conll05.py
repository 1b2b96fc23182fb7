"""CoNLL-2005 semantic role labelling, synthetic half (port of
``paddle_tpu/datasets/conll05.py``; ref: python/paddle/v2/dataset/conll05.py,
the label_semantic_roles book chapter's dataset).

Each sample is nine id lists of one sentence: the words, the five
predicate-context windows (the word at offsets -2..2 from the predicate,
repeated over the sentence), the predicate id, the mark flag and the SRL
tags.  Sentences are drawn over the reference's vocabulary sizes; a tag is
a fixed function of the token's distance to the predicate, so a model can
learn the mapping.  The draws are numpy ``RandomState`` ones, the JAX
package's sample for sample under the same ``n`` and seed.  The reader of
the official column files is not ported (ROADMAP A.12)."""
from __future__ import annotations

import numpy as np

WORD_DICT_LEN = 7477   # reference vocab sizes (conll05.py get_dict)
PRED_DICT_LEN = 3162
LABEL_DICT_LEN = 59    # 2*27 B/I roles + O + ...


def get_dict():
    """(word_dict, verb_dict, label_dict) of the synthetic vocabulary."""
    word_dict = {f"w{i}": i for i in range(WORD_DICT_LEN)}
    verb_dict = {f"v{i}": i for i in range(PRED_DICT_LEN)}
    label_dict = {f"t{i}": i for i in range(LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def get_embedding():  # the reference returns a pretrained embedding's path
    return None


def _tag_for(dist: int) -> int:
    # deterministic distance -> role mapping (keeps the task learnable)
    if dist == 0:
        return 1
    if abs(dist) > 4:
        return 0  # O
    return 2 + (dist + 4) % (LABEL_DICT_LEN - 2)


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            T = int(rng.randint(5, 30))
            words = rng.randint(0, WORD_DICT_LEN, T).astype("int64")
            pv = int(rng.randint(0, T))
            verb = int(rng.randint(0, PRED_DICT_LEN))

            def ctx(off):
                i = min(max(pv + off, 0), T - 1)
                return np.full(T, words[i], "int64")

            mark = np.zeros(T, "int64")
            mark[pv] = 1
            tags = np.array([_tag_for(i - pv) for i in range(T)], "int64")
            yield (words.tolist(), ctx(-2).tolist(), ctx(-1).tolist(),
                   ctx(0).tolist(), ctx(1).tolist(), ctx(2).tolist(),
                   np.full(T, verb, "int64").tolist(), mark.tolist(),
                   tags.tolist())

    return reader


def train(n_synthetic: int = 2048):
    """Reader of ``n_synthetic`` training sentences (seed 0)."""
    return _reader(n_synthetic, 0)


def test(n_synthetic: int = 256):
    """Reader of ``n_synthetic`` test sentences (seed 1)."""
    return _reader(n_synthetic, 1)

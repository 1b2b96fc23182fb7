"""WMT14-style translation pairs (ref: python/paddle/v2/dataset/wmt14.py —
src/tgt id sequences with <s>/<e>/<unk>; drives the machine-translation book
chapter).  Synthetic mode: a deterministic toy 'translation' (token mapping +
reversal) so seq2seq attention genuinely learns structure.

Real mode: parallel text at $PADDLE_TPU_DATA_HOME/wmt14/
{train,test}.src.txt + {train,test}.tgt.txt (one space-tokenised sentence
per line, line-aligned) with optional src.dict / tgt.dict (one token per
line; otherwise built frequency-ranked from the train split).  Ids 0/1/2
stay reserved for <s>/<e>/<unk> exactly as the reference's preprocessed
dictionaries do.

The port's copy of ``paddle_tpu/datasets/wmt_toy.py``; numpy only, sample
for sample the JAX package's."""
from __future__ import annotations

import numpy as np

from . import common

SRC_VOCAB = 300
TGT_VOCAB = 300
BOS, EOS, UNK = 0, 1, 2


def _real_paths(split):
    s = common.cached_path("wmt14", f"{split}.src.txt")
    t = common.cached_path("wmt14", f"{split}.tgt.txt")
    return (s, t) if s and t else None


def _dict_from(side):
    """src.dict/tgt.dict if present; else frequency-ranked over train.
    Ids 0/1/2 reserved for <s>/<e>/<unk> (reference wmt14 dict layout)."""
    path = common.cached_path("wmt14", f"{side}.dict")
    if path:
        with open(path) as f:
            toks = [ln.strip() for ln in f if ln.strip()]
    else:
        from collections import Counter

        freq: Counter = Counter()
        idx = 0 if side == "src" else 1
        with open(_real_paths("train")[idx]) as f:
            for line in f:
                freq.update(line.split())
        toks = [w for w, _ in freq.most_common()]
    d = {"<s>": BOS, "<e>": EOS, "<unk>": UNK}
    for w in toks:
        if w not in d:
            d[w] = len(d)
    return d


def get_dict():
    if _real_paths("train"):
        return _dict_from("src"), _dict_from("tgt")
    return ({f"s{i}": i for i in range(SRC_VOCAB)},
            {f"t{i}": i for i in range(TGT_VOCAB)})


def _real_reader(split, dicts):
    src_d, tgt_d = dicts

    def ids(line, d):
        return [d.get(w, UNK) for w in line.split()]

    def reader():
        sp, tp = _real_paths(split)
        with open(sp) as sf, open(tp) as tf:
            for sline, tline in zip(sf, tf, strict=True):
                src = ids(sline, src_d)
                tgt = ids(tline, tgt_d)
                if src and tgt:
                    yield src, [BOS] + tgt, tgt + [EOS]

    return reader


def _translate(src):
    # toy ground truth: reverse and shift into target id space
    return [(t * 7 + 3) % (TGT_VOCAB - 3) + 3 for t in reversed(src)]


def _reader(n, seed, max_len=16):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ln = int(rng.randint(3, max_len))
            src = rng.randint(3, SRC_VOCAB, ln).astype("int64").tolist()
            tgt = _translate(src)
            # (src, decoder_input=[BOS]+tgt, labels=tgt+[EOS]) like the reference
            yield src, [BOS] + tgt, tgt + [EOS]

    return reader


def train(n_synthetic: int = 4096, max_len: int = 16, dicts=None):
    if _real_paths("train"):
        return _real_reader("train", dicts or get_dict())
    return _reader(n_synthetic, 0, max_len)


def test(n_synthetic: int = 512, max_len: int = 16, dicts=None):
    # gated on the TRAIN pair too: dicts come from train, so a test-only
    # data dir would silently map every token to <unk>
    if _real_paths("test") and _real_paths("train"):
        return _real_reader("test", dicts or get_dict())
    return _reader(n_synthetic, 1, max_len)

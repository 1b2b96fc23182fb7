"""CoNLL-2005 semantic role labeling (ref: python/paddle/v2/dataset/conll05.py —
the label_semantic_roles book chapter's dataset: per-token word ids, five
predicate-context windows, predicate id, mark flag, and B/I/O SRL tags).

Synthetic mode: sentences over a fixed vocab; the SRL tag of each token is a
deterministic function of its distance to the predicate, so a model (and the
book-style convergence test) can actually learn the mapping.

Real mode: official CoNLL-05 column files (words file: one token per line,
blank line between sentences; props file: predicate lemma or '-' in column 0
plus one bracketed-span column per predicate, '(A0*' ... '*)' — the format
the reference untars from test.wsj) placed at
$PADDLE_TPU_DATA_HOME/conll05/{train,test}.{words,props}.txt.  The repo ships
a hand-curated real-English slice in tests/data/conll05/.

The port's copy of ``paddle_tpu/datasets/conll05.py``, numpy only: the
synthetic and the real-file readers give the JAX package's samples, sample
for sample.
"""
from __future__ import annotations

import numpy as np

from . import common

WORD_DICT_LEN = 7477   # reference vocab sizes (conll05.py get_dict)
PRED_DICT_LEN = 3162
LABEL_DICT_LEN = 59    # 2*27 B/I roles + O + ...


# ------------------------------------------------------------- real-data mode


def _real_paths(split):
    w = common.cached_path("conll05", f"{split}.words.txt")
    p = common.cached_path("conll05", f"{split}.props.txt")
    return (w, p) if w and p else None


def _spans_to_bio(col):
    """One predicate's bracketed-span column -> B-/I-/O tags.
    '(A0*' opens a span, '*)' closes it, '(V*)' is a one-token span."""
    bio, cur = [], None
    for c in col:
        if c.startswith("("):
            role = c[1 : c.index("*")]
            bio.append("B-" + role)
            cur = None if c.endswith(")") else role
        else:
            bio.append("I-" + cur if cur is not None else "O")
            if c == "*)":
                cur = None
    return bio


def _real_sentences(split):
    """Yield (tokens, predicate_lemma, bio_tags) — one item per predicate
    column, like the reference's corpus_reader."""
    from itertools import chain

    paths = _real_paths(split)
    if not paths:
        return
    with open(paths[0]) as wf, open(paths[1]) as pf:
        toks, rows = [], []
        # trailing sentinel blank line flushes a file with no final newline;
        # strict zip makes a words/props misalignment a loud error instead of
        # silently dropping or mis-tagging the tail
        for wline, pline in zip(chain(wf, ["\n"]), chain(pf, ["\n"]),
                                strict=True):
            w = wline.strip()
            if not w:  # sentence boundary
                if toks:
                    n_preds = len(rows[0]) - 1
                    lemmas = [r[0] for r in rows if r[0] != "-"]
                    for j in range(n_preds):
                        col = [r[1 + j] for r in rows]
                        yield toks, lemmas[j], _spans_to_bio(col)
                toks, rows = [], []
                continue
            toks.append(w)
            rows.append(pline.strip().split())


UNK = "<unk>"
_dict_cache: dict = {}


def _build_real_dicts():
    key = _real_paths("train")
    if key in _dict_cache:
        return _dict_cache[key]
    words, verbs, labels = set(), set(), set()
    for toks, lemma, bio in _real_sentences("train"):
        words.update(t.lower() for t in toks)
        verbs.add(lemma)
        labels.update(bio)
    # UNK lives INSIDE the dict (reference get_dict ships it), so sizing an
    # embedding with len(word_dict) always covers every emitted id
    word_dict = {w: i for i, w in enumerate(sorted(words))}
    word_dict[UNK] = len(word_dict)
    verb_dict = {v: i for i, v in enumerate(sorted(verbs))}
    # 'O' first so id 0 means outside-any-role, like the synthetic mapping
    label_dict = {t: i for i, t in
                  enumerate(["O"] + sorted(labels - {"O"}))}
    _dict_cache[key] = (word_dict, verb_dict, label_dict)
    return _dict_cache[key]


def _real_reader(split, dicts):
    word_dict, verb_dict, label_dict = dicts
    unk = word_dict.get(UNK, len(word_dict) - 1)

    def reader():
        for toks, lemma, bio in _real_sentences(split):
            T = len(toks)
            ids = [word_dict.get(t.lower(), unk) for t in toks]
            pv = bio.index("B-V")

            def ctx(off):
                return [ids[min(max(pv + off, 0), T - 1)]] * T

            mark = [0] * T
            mark[pv] = 1
            tags = [label_dict.get(t, 0) for t in bio]
            yield (ids, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
                   [verb_dict.get(lemma, 0)] * T, mark, tags)

    return reader


def get_dict():
    if _real_paths("train"):
        return _build_real_dicts()
    word_dict = {f"w{i}": i for i in range(WORD_DICT_LEN)}
    verb_dict = {f"v{i}": i for i in range(PRED_DICT_LEN)}
    label_dict = {f"t{i}": i for i in range(LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def get_embedding():  # reference returns a pretrained emb path; none offline
    return None


def _tag_for(dist: int) -> int:
    # deterministic distance->role mapping (keeps the task learnable)
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


def train(n_synthetic: int = 2048, dicts=None):
    if _real_paths("train"):
        return _real_reader("train", dicts or get_dict())
    return _reader(n_synthetic, 0)


def test(n_synthetic: int = 256, dicts=None):
    # gated on the TRAIN pair too: the dicts come from train, so a test-only
    # data dir would silently map every token/lemma/label to garbage ids
    if _real_paths("test") and _real_paths("train"):
        return _real_reader("test", dicts or get_dict())
    return _reader(n_synthetic, 1)

"""Semantic role labelling: the Paddle book's db_lstm (PyTorch port of
``paddle_tpu/models/srl.py``; ref: fluid/tests/book/
test_label_semantic_roles.py, dataset python/paddle/v2/dataset/conll05.py):
eight input embeddings, stacked LSTMs of alternating direction on the LSTM
kernels, a linear-chain CRF on top, trained by its NLL and decoded by
Viterbi.

Every token slot is a padded [batch, T] id tensor, with one [batch] length
vector (the LoD-to-mask convention of ``layers/sequence.py``)."""
from __future__ import annotations

import numpy as np

from .. import layers
from ..datasets import conll05
from ..param_attr import ParamAttr


def db_lstm(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark,
            length, label=None, word_dict_len=conll05.WORD_DICT_LEN,
            pred_dict_len=conll05.PRED_DICT_LEN,
            label_dict_len=conll05.LABEL_DICT_LEN,
            word_dim: int = 32, mark_dim: int = 5, hidden_dim: int = 64,
            depth: int = 4):
    """Returns (crf_nll_loss, the batch mean of the per-sequence NLL;
    decoded_tags int32 [B, T]; emission [B, T, label_dict_len]); the loss is
    None when ``label`` is None (inference).  The six word slots share one
    table, ``srl_word_emb``; the CRF's training and decoding share
    ``srl_crf_transition``; ``hidden_dim`` is each LSTM's own width."""
    word_slots = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    embs = [layers.embedding(s, [word_dict_len, word_dim],
                             param_attr=ParamAttr(name="srl_word_emb"))
            for s in word_slots]
    embs.append(layers.embedding(predicate, [pred_dict_len, word_dim]))
    embs.append(layers.embedding(mark, [2, mark_dim]))
    x = layers.concat(embs, axis=2)

    h = layers.fc(x, hidden_dim * 4, num_flatten_dims=2, bias_attr=False)
    rev = False
    for _ in range(depth):
        h_lstm, _ = layers.dynamic_lstm(h, length, hidden_dim, is_reverse=rev)
        h = layers.fc(h_lstm, hidden_dim * 4, num_flatten_dims=2,
                      bias_attr=False)
        rev = not rev
    emission = layers.fc(h, label_dict_len, num_flatten_dims=2)

    crf_attr = ParamAttr(name="srl_crf_transition", learning_rate=1.0)
    loss = None
    if label is not None:
        nll = layers.linear_chain_crf(emission, label, length,
                                      param_attr=crf_attr)
        loss = layers.reduce_mean(nll)
    decoded = layers.crf_decoding(emission, length, param_attr=crf_attr)
    return loss, decoded, emission


def batch_from_dataset(samples, max_len: int):
    """Pad a list of conll05 tuples to dense feed arrays: (eight int32 [n,
    max_len] slots, tags int32 [n, max_len], lengths int32 [n]); a
    sentence longer than ``max_len`` is cut."""
    n = len(samples)
    slots = [np.zeros((n, max_len), "int32") for _ in range(8)]
    tags = np.zeros((n, max_len), "int32")
    length = np.zeros((n,), "int32")
    for b, s in enumerate(samples):
        T = min(len(s[0]), max_len)
        length[b] = T
        for k in range(8):
            slots[k][b, :T] = s[k][:T]
        tags[b, :T] = s[8][:T]
    return slots, tags, length

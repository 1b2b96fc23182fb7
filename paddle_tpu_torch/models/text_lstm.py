"""LSTM text classification (PyTorch port of ``paddle_tpu/models/text_lstm.py``;
the reference's ``benchmark/paddle/rnn/rnn.py``: IMDB, 2 x LSTM + fc).

``build`` declares the same layers in the same order as the JAX package, so
the parameters get the same names (``embedding_w_0``, then per LSTM layer
``fc_w_<i>``, ``dynamic_lstm_w_<i>``, ``dynamic_lstm_b_<i>``, then the
classifier's ``fc_w_<n>`` and ``fc_b_0``) and ``load_scope`` carries
weights across unchanged.  ``text_lstm_param_shapes`` lists them and
``init_text_lstm_params`` draws them with numpy from a seed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .. import layers
from ..layers import sequence as seq


def build(words, lengths, label, vocab_size: int, emb_dim: int = 128,
          hidden: int = 512, num_layers: int = 2, class_dim: int = 2):
    """words: [N, T] int ids (padded); lengths: [N]; label: [N, 1] int.
    Returns (loss, accuracy, prediction)."""
    x = layers.embedding(words, [vocab_size, emb_dim])
    for _ in range(num_layers):
        proj = layers.fc(x, 4 * hidden, num_flatten_dims=2, bias_attr=False)
        x, _ = seq.dynamic_lstm(proj, lengths, hidden, use_peepholes=False)
    pooled = seq.sequence_pool(x, lengths, "last")
    prediction = layers.fc(pooled, class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction


def text_lstm_param_shapes(vocab_size: int, emb_dim: int = 128,
                           hidden: int = 512, num_layers: int = 2,
                           class_dim: int = 2) -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> shape of a freshly named ``build`` program."""
    shapes = {"embedding_w_0": (vocab_size, emb_dim)}
    width = emb_dim
    for i in range(num_layers):
        shapes[f"fc_w_{i}"] = (width, 4 * hidden)
        shapes[f"dynamic_lstm_w_{i}"] = (hidden, 4 * hidden)
        shapes[f"dynamic_lstm_b_{i}"] = (4 * hidden,)
        width = hidden
    shapes[f"fc_w_{num_layers}"] = (hidden, class_dim)
    shapes["fc_b_0"] = (class_dim,)
    return shapes


def init_text_lstm_params(seed: int, vocab_size: int, emb_dim: int = 128,
                          hidden: int = 512, num_layers: int = 2,
                          class_dim: int = 2) -> Dict[str, np.ndarray]:
    """float32 weights from ``np.random.RandomState(seed)``: embeddings
    N(0, 1), every weight matrix N(0, 1/fan_in) (so the gate inputs and the
    recurrent products are O(1): gates neither saturate nor vanish), biases
    zero."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in text_lstm_param_shapes(
            vocab_size, emb_dim, hidden, num_layers, class_dim).items():
        if name.startswith("embedding"):
            arr = rng.standard_normal(shape)
        elif len(shape) == 2:
            arr = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            arr = np.zeros(shape)
        out[name] = arr.astype(np.float32)
    return out

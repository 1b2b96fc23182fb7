"""N-gram neural language model, the word2vec book chapter (PyTorch port
of ``paddle_tpu/models/word2vec.py``; ref: fluid/tests/book/
test_word2vec.py, dataset ``datasets/imikolov.py``): four context words
share one embedding table (``word2vec_emb``), then concat -> fc sigmoid ->
softmax over the vocabulary."""
from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr


def build(words, target, vocab_size: int, emb_dim: int = 32,
          hidden: int = 256):
    """words: a list of [N, 1] int Variables (4 in the chapter); target:
    [N, 1] int.  Returns (avg_cost, predict)."""
    embs = [layers.embedding(w, [vocab_size, emb_dim],
                             param_attr=ParamAttr(name="word2vec_emb"))
            for w in words]
    concat = layers.concat(embs, axis=1)
    hidden1 = layers.fc(concat, hidden, act="sigmoid")
    predict = layers.fc(hidden1, vocab_size, act="softmax")
    cost = layers.cross_entropy(predict, target)
    return layers.mean(cost), predict

"""Hierarchical (nested-sequence) document classifier (PyTorch port of
``paddle_tpu/models/hier_text.py``): a word GRU inside each sentence, a
sentence RNN over the document (ref: the hierarchical configs of
gserver/tests/test_RecurrentGradientMachine.cpp, rnn over sub-sequences).

Tokens [B, S, W] with the (n_sub [B], sub_len [B, S]) length pair;
``NestedDynamicRNN`` steps the sentences, ``dynamic_gru`` runs inside each.
The parameters carry the JAX package's names."""
from __future__ import annotations

from .. import layers
from ..layers import nested
from ..layers import sequence as seq


def build(tokens, n_sub, sub_len, label, vocab_size: int, emb_dim: int = 64,
          word_hidden: int = 64, sent_hidden: int = 64, class_dim: int = 2):
    """tokens: [B, S, W] int ids (padded on both axes); n_sub: [B];
    sub_len: [B, S]; label: [B, 1] int.  Returns (loss, acc,
    prediction)."""
    emb = layers.embedding(tokens, [vocab_size, emb_dim])      # [B, S, W, E]

    rnn = nested.NestedDynamicRNN()
    with rnn.step():
        sent = rnn.step_input(emb)                             # [B, W, E]
        slen = rnn.step_sub_len(sub_len)                       # [B]
        proj = layers.fc(sent, 3 * word_hidden, num_flatten_dims=2,
                         bias_attr=False)
        enc, _ = seq.dynamic_gru(proj, slen, word_hidden)      # inner recurrence
        sent_vec = seq.sequence_pool(enc, slen, "last")        # [B, Hw]
        h = rnn.memory(shape=[sent_hidden])
        nh = layers.fc([sent_vec, h], sent_hidden, act="tanh")  # outer recurrence
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    sent_states, = rnn(lengths=n_sub)                          # [B, S, Hs]

    doc = seq.sequence_pool(sent_states, n_sub, "last")        # [B, Hs]
    prediction = layers.fc(doc, class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction

"""OCR line recognizer (PyTorch port of ``paddle_tpu/models/ocr_ctc.py``):
conv features -> im2sequence (the v1 block_expand_layer) -> bidirectional
GRU -> CTC loss (ref: the v1 CTC demo topology, gserver/layers/
CTCLayer.cpp over block-expanded image sequences; Fluid's warpctc +
im2sequence pair).  ``synthetic_lines`` is the JAX package's corpus,
draw for draw."""
from __future__ import annotations

import numpy as np

from .. import layers, nets


def build(img, label, label_len, num_classes: int, hidden: int = 48):
    """img: [N, 1, H, W]; label: [N, L] int (0 is the CTC blank);
    label_len: [N].  Returns (avg_ctc_loss, decoded (ids [N, T], lengths
    [N]), logits)."""
    h = layers.conv2d(img, 16, 3, padding=1, act="relu")
    h = layers.pool2d(h, 2, "max", 2)
    h = layers.conv2d(h, 32, 3, padding=1, act="relu")
    # the whole height folded into the features: one step a column
    seq = layers.im2sequence(h, filter_size=(int(h.shape[2]), 1))  # [N, W, C*H]
    T = int(seq.shape[1])
    lengths = layers.fill_constant_batch_size_like(seq, [-1], "int32", T)
    rnn = nets.bidirectional_gru(seq, lengths, hidden)
    logits = layers.fc(rnn, num_classes, num_flatten_dims=2)
    loss = layers.reduce_mean(
        layers.warpctc(logits, label, lengths, label_len, blank=0))
    decoded = layers.ctc_greedy_decoder(logits, lengths, blank=0)
    return loss, decoded, logits


def synthetic_lines(n, width=32, height=8, n_glyphs=4, seed=0):
    """A small synthetic 'text line' corpus: each glyph id paints its own
    vertical stripe pattern in its slot; the labels are the glyph ids
    (1..3; 0 is the blank).  Returns (images [n, 1, height, width] float32,
    labels [n, n_glyphs] int32, label lengths [n] int32)."""
    rng = np.random.RandomState(seed)
    glyph_w = width // n_glyphs
    imgs = np.zeros((n, 1, height, width), "float32")
    labels = np.zeros((n, n_glyphs), "int32")
    lens = np.full((n,), n_glyphs, "int32")
    for i in range(n):
        for s in range(n_glyphs):
            g = int(rng.randint(1, 4))
            labels[i, s] = g
            x0 = s * glyph_w
            imgs[i, 0, g % height:: 3, x0:x0 + glyph_w] = 1.0
            imgs[i, 0, :, x0 + (g % glyph_w)] = 0.5
    imgs += rng.randn(*imgs.shape).astype("float32") * 0.05
    return imgs, labels, lens

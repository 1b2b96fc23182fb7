"""Fully-convolutional segmentation net (PyTorch port of
``paddle_tpu/models/fcn.py``: the VOC2012 dataset's model family, a conv
encoder, a 1x1 class head, a transposed-conv upsample and a per-pixel
softmax; ref: python/paddle/v2/dataset/voc2012.py, and the decoder op is
the reference's conv2d_transpose, paddle/operators/conv_transpose_op.cc)."""
from __future__ import annotations

from .. import layers


def build(img, label, num_classes: int = 21, base: int = 16):
    """img: [N, 3, S, S]; label: [N, S, S] int pixel classes.
    Returns (avg_pixel_nll, pixel_accuracy, logits [N, C, S, S])."""
    h = layers.conv2d(img, base, 3, padding=1, act="relu")
    h = layers.pool2d(h, 2, "max", 2)
    h = layers.conv2d(h, base * 2, 3, padding=1, act="relu")
    h = layers.pool2d(h, 2, "max", 2)
    h = layers.conv2d(h, base * 4, 3, padding=1, act="relu")
    score = layers.conv2d(h, num_classes, 1)  # 1x1 class head at stride 4
    # learnable x4 upsample back to the input's resolution (FCN's deconv)
    logits = layers.conv2d_transpose(score, num_classes, 4, stride=4)

    # per-pixel CE through the shared library op: class axis last
    nhwc = layers.transpose(logits, [0, 2, 3, 1])
    nll = layers.softmax_with_cross_entropy(nhwc, layers.unsqueeze(label, [3]))
    loss = layers.mean(nll)
    pred = layers.argmax(nhwc, axis=-1)
    acc = layers.mean(layers.cast(layers.equal(pred, label), "float32"))
    return loss, acc, logits

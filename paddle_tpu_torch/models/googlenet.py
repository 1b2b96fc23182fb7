"""GoogLeNet / Inception-v1 (PyTorch port of
``paddle_tpu/models/googlenet.py``; ref: benchmark/paddle/image/
googlenet.py).  Each inception block's four branches meet in a
``concat``; its 3x3 convs are routed onto the conv kernels in a pruned
program (``core/fusion.py``)."""
from __future__ import annotations

from .. import layers


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    b1 = layers.conv2d(x, c1, 1, act="relu")
    b3 = layers.conv2d(x, c3r, 1, act="relu")
    b3 = layers.conv2d(b3, c3, 3, padding=1, act="relu")
    b5 = layers.conv2d(x, c5r, 1, act="relu")
    b5 = layers.conv2d(b5, c5, 5, padding=2, act="relu")
    bp = layers.pool2d(x, 3, "max", 1, pool_padding=1)
    bp = layers.conv2d(bp, proj, 1, act="relu")
    return layers.concat([b1, b3, b5, bp], axis=1)


def build(img, label, class_dim: int = 1000):
    """img: [N, 3, H, W]; label: [N, 1] int.  Returns (avg_loss, accuracy,
    prediction)."""
    x = layers.conv2d(img, 64, 7, stride=2, padding=3, act="relu")
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    x = layers.conv2d(x, 64, 1, act="relu")
    x = layers.conv2d(x, 192, 3, padding=1, act="relu")
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    x = _inception(x, 64, 96, 128, 16, 32, 32)
    x = _inception(x, 128, 128, 192, 32, 96, 64)
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    x = _inception(x, 192, 96, 208, 16, 48, 64)
    x = _inception(x, 160, 112, 224, 24, 64, 64)
    x = _inception(x, 128, 128, 256, 24, 64, 64)
    x = _inception(x, 112, 144, 288, 32, 64, 64)
    x = _inception(x, 256, 160, 320, 32, 128, 128)
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    x = _inception(x, 256, 160, 320, 32, 128, 128)
    x = _inception(x, 384, 192, 384, 48, 128, 128)
    x = layers.pool2d(x, 7, "avg", 1, global_pooling=True)
    x = layers.dropout(x, 0.4)
    flat = layers.reshape(x, [0, -1])
    prediction = layers.fc(flat, class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction

"""AlexNet (PyTorch port of ``paddle_tpu/models/alexnet.py``; ref:
benchmark/paddle/image/alexnet.py), with cross-channel ``lrn`` after the
first two pools.  Its three 3x3 convs are routed onto the conv kernels in
a pruned program (``core/fusion.py``)."""
from __future__ import annotations

from .. import layers


def build(img, label, class_dim: int = 1000):
    """img: [N, 3, 224, 224]; label: [N, 1] int.  Returns (avg_loss,
    accuracy, prediction)."""
    conv1 = layers.conv2d(img, 96, 11, stride=4, padding=1, act="relu")
    pool1 = layers.pool2d(conv1, 3, "max", 2)
    norm1 = layers.lrn(pool1, n=5)
    conv2 = layers.conv2d(norm1, 256, 5, padding=2, groups=1, act="relu")
    pool2 = layers.pool2d(conv2, 3, "max", 2)
    norm2 = layers.lrn(pool2, n=5)
    conv3 = layers.conv2d(norm2, 384, 3, padding=1, act="relu")
    conv4 = layers.conv2d(conv3, 384, 3, padding=1, act="relu")
    conv5 = layers.conv2d(conv4, 256, 3, padding=1, act="relu")
    pool5 = layers.pool2d(conv5, 3, "max", 2)
    flat = layers.reshape(pool5, [0, -1])
    fc6 = layers.fc(flat, 4096, act="relu")
    d6 = layers.dropout(fc6, 0.5)
    fc7 = layers.fc(d6, 4096, act="relu")
    d7 = layers.dropout(fc7, 0.5)
    prediction = layers.fc(d7, class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction

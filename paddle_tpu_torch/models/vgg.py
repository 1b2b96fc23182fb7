"""VGG-16 / VGG-19 (PyTorch port of ``paddle_tpu/models/vgg.py``; ref:
benchmark/paddle/image/vgg.py, ``BASELINE.json`` configs[1]).  Every conv
is 3x3, stride 1, padding 1: in a pruned program each is routed onto the
conv kernels (``core/fusion.py``), fused with its batch norm and ReLU
when ``use_bn``."""
from __future__ import annotations

from .. import layers


def _conv_block(x, num_filters, groups, use_bn=False):
    for _ in range(groups):
        x = layers.conv2d(x, num_filters, 3, padding=1,
                          act=None if use_bn else "relu")
        if use_bn:
            x = layers.batch_norm(x, act="relu")
    return layers.pool2d(x, 2, "max", 2)


def build(img, label, class_dim: int = 1000, depth: int = 16,
          use_bn: bool = False):
    """img: [N, 3, H, W] (224 x 224 for the 7 x 7 x 512 the first fc
    reads); label: [N, 1] int.  Returns (avg_loss, accuracy,
    prediction)."""
    cfg = {16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}[depth]
    x = img
    for filters, groups in zip([64, 128, 256, 512, 512], cfg):
        x = _conv_block(x, filters, groups, use_bn)
    flat = layers.reshape(x, [0, -1])
    fc1 = layers.fc(flat, 4096, act="relu")
    d1 = layers.dropout(fc1, 0.5)
    fc2 = layers.fc(d1, 4096, act="relu")
    d2 = layers.dropout(fc2, 0.5)
    prediction = layers.fc(d2, class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction

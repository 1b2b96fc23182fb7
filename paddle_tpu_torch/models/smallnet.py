"""SmallNet, the cifar-quick convnet of the reference's benchmark suite
(PyTorch port of ``paddle_tpu/models/smallnet.py``; ref:
benchmark/paddle/image/smallnet_mnist_cifar.py).

Topology: conv5x5(32) + maxpool3s2, conv5x5(32) + avgpool3s2, conv3x3(64) +
avgpool3s2, fc(64, relu), fc(classes, softmax)."""
from __future__ import annotations

from .. import layers


def build(img, label, class_dim: int = 10):
    """img: [N, 3, 32, 32]; label: [N, 1] int.  Returns (avg_loss,
    accuracy, prediction)."""
    x = layers.conv2d(img, 32, 5, padding=2, act="relu")
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    x = layers.conv2d(x, 32, 5, padding=2, act="relu")
    x = layers.pool2d(x, 3, "avg", 2, pool_padding=1)
    x = layers.conv2d(x, 64, 3, padding=1, act="relu")
    x = layers.pool2d(x, 3, "avg", 2, pool_padding=1)
    flat = layers.reshape(x, [0, -1])
    h = layers.fc(flat, 64, act="relu")
    prediction = layers.fc(h, class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction

"""LeNet-5 for MNIST (PyTorch port of ``paddle_tpu/models/lenet.py``; ref:
v1_api_demo/mnist, fluid/tests/book/test_recognize_digits_conv.py, the
reference's 'chapter 1' convergence config, ``BASELINE.json``
configs[0])."""
from __future__ import annotations

from .. import layers


def build(img, label):
    """img: [N, 1, 28, 28]; label: [N, 1] int.  Returns (avg_loss,
    accuracy, prediction)."""
    c1 = layers.conv2d(img, num_filters=20, filter_size=5, act="relu")
    p1 = layers.pool2d(c1, 2, "max", 2)
    c2 = layers.conv2d(p1, num_filters=50, filter_size=5, act="relu")
    p2 = layers.pool2d(c2, 2, "max", 2)
    flat = layers.reshape(p2, [0, 50 * 4 * 4])
    prediction = layers.fc(flat, 10, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction

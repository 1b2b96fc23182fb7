"""ResNet (PyTorch port of ``paddle_tpu/models/resnet.py``; the reference's
``benchmark/paddle/image/resnet.py``).  ResNet-50 training images/s at
bs=256 with Momentum(0.1, 0.9) and amp is the repo's headline metric
(``bench.py``).

``build`` and ``build_cifar`` declare the same layers in the same order as
the JAX package, so parameters and running statistics get the same names
(``conv2d_w_<i>``, ``batch_norm_w_<i>`` / ``batch_norm_b_<i>``,
``batch_norm_<2i>.w_mean`` / ``batch_norm_<2i+1>.w_var``, ``fc_w_0``,
``fc_b_0``) and ``load_scope`` carries JAX arrays across unchanged.
``resnet_param_shapes`` lists the parameters, ``init_resnet_params``
draws them with numpy from a seed, and ``init_resnet_stats`` draws running
statistics for the inference (``is_test``) program.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .. import layers


def _conv_bn(x, filters, size, stride=1, padding=0, act="relu"):
    c = layers.conv2d(x, filters, size, stride=stride, padding=padding,
                      bias_attr=False)
    return layers.batch_norm(c, act=act)


def _shortcut(x, filters, stride):
    in_c = x.shape[1]
    if in_c != filters or stride != 1:
        return _conv_bn(x, filters, 1, stride=stride, act=None)
    return x


def _bottleneck(x, filters, stride):
    c = _conv_bn(x, filters, 1, act="relu")
    c = _conv_bn(c, filters, 3, stride=stride, padding=1, act="relu")
    c = _conv_bn(c, filters * 4, 1, act=None)
    short = _shortcut(x, filters * 4, stride)
    return layers.relu(layers.elementwise_add(c, short))


def _basic(x, filters, stride):
    c = _conv_bn(x, filters, 3, stride=stride, padding=1, act="relu")
    c = _conv_bn(c, filters, 3, padding=1, act=None)
    short = _shortcut(x, filters, stride)
    return layers.relu(layers.elementwise_add(c, short))


_DEPTH_CFG = {
    18: (_basic, [2, 2, 2, 2]),
    34: (_basic, [3, 4, 6, 3]),
    50: (_bottleneck, [3, 4, 6, 3]),
    101: (_bottleneck, [3, 4, 23, 3]),
    152: (_bottleneck, [3, 8, 36, 3]),
}


def build(img, label, class_dim: int = 1000, depth: int = 50):
    """ImageNet-shape ResNet.  img: [N, 3, 224, 224]; label: [N, 1] int.
    Returns (loss, accuracy, prediction)."""
    block, counts = _DEPTH_CFG[depth]
    x = _conv_bn(img, 64, 7, stride=2, padding=3, act="relu")
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    for stage, (filters, n) in enumerate(zip([64, 128, 256, 512], counts)):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            x = block(x, filters, stride)
    x = layers.pool2d(x, 7, "avg", 1, global_pooling=True)
    flat = layers.reshape(x, [0, -1])
    prediction = layers.fc(flat, class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction


def build_cifar(img, label, depth: int = 32, class_dim: int = 10):
    """CIFAR ResNet, (depth - 2) / 6 basic blocks a stage.  img: [N, 3, 32,
    32]."""
    n = (depth - 2) // 6
    x = _conv_bn(img, 16, 3, padding=1, act="relu")
    for stage, filters in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            x = _basic(x, filters, stride)
    x = layers.pool2d(x, 8, "avg", 1, global_pooling=True)
    flat = layers.reshape(x, [0, -1])
    prediction = layers.fc(flat, class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(prediction, label))
    acc = layers.accuracy(prediction, label)
    return loss, acc, prediction


def _declared(depth: int, class_dim: int, cifar: bool):
    """A freshly named ``build`` (or, with ``cifar``, ``build_cifar``)
    program, declared on meta tensors in programs and names of its own."""
    from ..core import Program, program_guard, unique_name

    main = Program()
    with unique_name.guard(), program_guard(main, Program()):
        img = layers.data("img", [3, 32, 32] if cifar else [3, 224, 224])
        label = layers.data("label", [1], dtype="int32")
        if cifar:
            build_cifar(img, label, depth=depth, class_dim=class_dim)
        else:
            build(img, label, class_dim=class_dim, depth=depth)
    return main


def resnet_param_shapes(depth: int = 50, class_dim: int = 1000,
                        cifar: bool = False) -> Dict[str, Tuple[int, ...]]:
    """Parameter name -> shape of a freshly named ``build`` (or, with
    ``cifar``, ``build_cifar``) program, in declaration order."""
    main = _declared(depth, class_dim, cifar)
    return {p.name: tuple(p.shape) for p in main.parameters()}


def init_resnet_params(seed: int, depth: int = 50, class_dim: int = 1000,
                       cifar: bool = False) -> Dict[str, np.ndarray]:
    """float32 parameters from ``np.random.RandomState(seed)``, drawn as the
    layers' own initializers draw them: convolution filters N(0, 2 /
    fan_in), batch-norm scales 1 and biases 0, the classifier's weight
    N(0, 1 / fan_in) and bias 0.  The running statistics are not
    parameters: the startup program sets them (zeros, ones), and
    :func:`init_resnet_stats` draws others."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in resnet_param_shapes(depth, class_dim, cifar).items():
        if name.startswith("conv2d_w"):
            fan_in = int(np.prod(shape[1:]))
            arr = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif name.startswith("fc_w"):
            arr = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name.startswith("batch_norm_w"):
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        out[name] = arr.astype(np.float32)
    return out


def init_resnet_stats(seed: int, depth: int = 50, class_dim: int = 1000,
                      cifar: bool = False) -> Dict[str, np.ndarray]:
    """float32 running statistics from ``np.random.RandomState(seed)``, the
    batch norms taken in declaration order: each one's ``<bn>.w_mean`` from
    N(0, 0.1^2), then its ``<bn>.w_var`` from U(0.5, 1.5), per channel.
    The startup program's zeros and ones would fold an inference batch norm
    into nearly the identity; these make its scale and shift matter."""
    rng = np.random.RandomState(seed)
    out = {}
    for v in _declared(depth, class_dim, cifar).persistable_vars():
        if v.name.endswith(".w_mean"):
            arr = rng.normal(0.0, 0.1, tuple(v.shape))
        elif v.name.endswith(".w_var"):
            arr = rng.uniform(0.5, 1.5, tuple(v.shape))
        else:
            continue
        out[v.name] = arr.astype(np.float32)
    return out

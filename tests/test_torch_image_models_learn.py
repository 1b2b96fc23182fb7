"""The learning checks of ``tests/test_models.py`` for the image
classifiers, on paddle_tpu_torch on the CPU with its own startup weights:
LeNet on lit bands (``test_lenet_mnist_learns``), SmallNet on lit
quadrants (``test_smallnet_converges``) and AlexNet at 128 px on lit bands
(the alexnet case of ``test_big_image_models_converge``); each loss must
halve."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run: the suite's workers
    share the host's cores, and torch's thread pool on many small ops
    under that contention runs tens of times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    fluid.reset_default_programs()
    fluid.reset_global_scope()
    yield


def _train(feeds, loss, steps, opt):
    opt.minimize(loss)
    exe = fluid.Executor(CPU)
    exe.run(fluid.default_startup_program())
    losses = [float(exe.run(feed=feeds(i), fetch_list=[loss])[0])
              for i in range(steps)]
    return losses[0], losses[-1]


def test_lenet_mnist_learns():
    """25 Adam(1e-3) steps on 32 images whose class is which of four
    bands is lit."""
    img = fluid.layers.data("img", [1, 28, 28])
    label = fluid.layers.data("label", [1], dtype="int32")
    loss, _, _ = fluid.models.lenet.build(img, label)
    rng = np.random.RandomState(0)

    def feeds(i):
        ys = rng.randint(0, 4, (32, 1)).astype("int32")
        xs = np.zeros((32, 1, 28, 28), "float32")
        for b, y in enumerate(ys[:, 0]):
            xs[b, 0, 7 * y: 7 * y + 7] = 1.0
        return {"img": xs, "label": ys}

    first, last = _train(feeds, loss, 25, fluid.optimizer.Adam(1e-3))
    assert last < first * 0.5, (first, last)


def test_smallnet_converges():
    """40 Momentum(0.05, 0.9) steps on 16 images whose class is the lit
    quadrant."""
    img = fluid.layers.data("img", [3, 32, 32])
    label = fluid.layers.data("label", [1], dtype="int32")
    loss, _, pred = fluid.models.smallnet.build(img, label, class_dim=4)
    rng = np.random.RandomState(0)

    def feeds(i):
        ys = rng.randint(0, 4, (16, 1)).astype("int32")
        xs = rng.rand(16, 3, 32, 32).astype("float32") * 0.1
        for b, y in enumerate(ys[:, 0]):
            xs[b, :, 16 * (y // 2):16 * (y // 2) + 16,
               16 * (y % 2):16 * (y % 2) + 16] += 1.0
        return {"img": xs, "label": ys}

    first, last = _train(feeds, loss, 40,
                         fluid.optimizer.Momentum(0.05, momentum=0.9))
    assert last < first * 0.5, (first, last)
    assert pred.shape[-1] == 4


def test_alexnet_converges():
    """30 Adam(1e-3) steps of AlexNet at 128 px (its stride-4 stem and
    three pools need about 96 px or more) on 16 images whose class is
    which of four bands is lit."""
    size = 128
    img = fluid.layers.data("img", [3, size, size])
    label = fluid.layers.data("label", [1], dtype="int32")
    loss, _, _ = fluid.models.alexnet.build(img, label, class_dim=4)
    rng = np.random.RandomState(0)
    band = size // 4

    def feeds(i):
        ys = rng.randint(0, 4, (16, 1)).astype("int32")
        xs = rng.rand(16, 3, size, size).astype("float32") * 0.1
        for b, y in enumerate(ys[:, 0]):
            xs[b, :, band * y: band * (y + 1)] += 1.0
        return {"img": xs, "label": ys}

    fluid.default_main_program().random_seed = 0
    fluid.default_startup_program().random_seed = 0
    first, last = _train(feeds, loss, 30, fluid.optimizer.Adam(1e-3))
    assert last < first * 0.5, (first, last)

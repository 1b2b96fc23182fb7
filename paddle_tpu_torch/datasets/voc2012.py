"""PASCAL VOC2012 segmentation, synthetic half (port of
``paddle_tpu/datasets/voc2012.py``; ref: python/paddle/v2/dataset/voc2012.py,
images and per-pixel class masks, 21 classes with the background).

Each sample is an image [3, S, S] in [0, 1] and its int64 mask [S, S]: one
to three rectangles of a class on the background, the image brightened in
a colour of the class where the mask holds it.  The draws are numpy
``RandomState`` ones, the JAX package's sample for sample under the same
``n``, seed and size.  The readers of the official VOCdevkit layout
(segmentation and detection) are not ported (ROADMAP A.12 part 4)."""
from __future__ import annotations

import numpy as np

NUM_CLASSES = 21

# the 20 VOC object classes, id 1..20 (0 = background), official ordering
DET_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
               "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
               "tvmonitor")


def _reader(n, seed, size=128):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            img = rng.rand(3, size, size).astype("float32") * 0.1
            mask = np.zeros((size, size), "int64")
            for _ in range(int(rng.randint(1, 4))):
                c = int(rng.randint(1, NUM_CLASSES))
                h, w = rng.randint(size // 8, size // 2, 2)
                y0 = int(rng.randint(0, size - h))
                x0 = int(rng.randint(0, size - w))
                mask[y0:y0 + h, x0:x0 + w] = c
                img[:, y0:y0 + h, x0:x0 + w] += (
                    np.array([c / 21.0, (c % 5) / 5.0, (c % 3) / 3.0],
                             "float32")[:, None, None])
            yield np.clip(img, 0, 1), mask

    return reader


def _real_files(*_args, **_kwargs):
    raise NotImplementedError(
        "the VOCdevkit file readers of paddle_tpu/datasets/voc2012.py are not "
        "ported yet (ROADMAP A.12 part 4); the synthetic train() and test() "
        "are")


detection_train = detection_test = _real_files


def train(n_synthetic: int = 512, size: int = 128):
    """The synthetic training reader: ``n_synthetic`` samples, seed 0."""
    return _reader(n_synthetic, 0, size)


def test(n_synthetic: int = 64, size: int = 128):
    """The synthetic test reader: ``n_synthetic`` samples, seed 1."""
    return _reader(n_synthetic, 1, size)


__all__ = ["DET_CLASSES", "NUM_CLASSES", "test", "train"]

"""Oxford 102 Flowers (ref: python/paddle/v2/dataset/flowers.py — 102-class
jpeg classification, the v2 image-classification demo dataset).  Synthetic
mode: class-conditioned color-field images, 3x224x224 float32 in [0,1].

Real mode: the official corpus layout at $PADDLE_TPU_DATA_HOME/flowers/ —
jpg/image_%05d.jpg (the 102flowers.tgz contents), imagelabels.mat (1-based
labels) and setid.mat (trnid/valid/tstid splits), loaded with scipy.io +
PIL resize to the requested square size.

The port's copy of ``paddle_tpu/datasets/flowers.py``; numpy only, sample
for sample the JAX package's."""
from __future__ import annotations

import os

import numpy as np

from . import common

NUM_CLASSES = 102
IMG_SHAPE = (3, 224, 224)

_SPLIT_KEYS = {"train": "trnid", "valid": "valid", "test": "tstid"}


def _real_ready():
    return (common.cached_path("flowers", "jpg")
            and common.cached_path("flowers", "imagelabels.mat")
            and common.cached_path("flowers", "setid.mat"))


def _real_reader(split, size):
    import scipy.io
    from PIL import Image

    labels = scipy.io.loadmat(
        common.cached_path("flowers", "imagelabels.mat"))["labels"].ravel()
    ids = scipy.io.loadmat(
        common.cached_path("flowers", "setid.mat"))[_SPLIT_KEYS[split]].ravel()
    jpg_dir = common.cached_path("flowers", "jpg")

    def reader():
        for i in ids:
            p = os.path.join(jpg_dir, f"image_{int(i):05d}.jpg")
            with Image.open(p) as im:
                arr = np.asarray(im.convert("RGB").resize((size, size)),
                                 dtype="float32") / 255.0
            # HWC -> CHW; labels are 1-based in the .mat
            yield arr.transpose(2, 0, 1), int(labels[int(i) - 1]) - 1

    return reader


def _reader(n, seed, size=224):
    def reader():
        rng = np.random.RandomState(seed)
        yy, xx = np.mgrid[0:size, 0:size].astype("float32") / size
        for _ in range(n):
            y = int(rng.randint(0, NUM_CLASSES))
            base = np.stack([
                0.5 + 0.5 * np.sin(2 * np.pi * (yy * ((y % 7) + 1))),
                0.5 + 0.5 * np.cos(2 * np.pi * (xx * ((y % 5) + 1))),
                np.full_like(xx, (y % 11) / 10.0),
            ])
            img = np.clip(base + rng.randn(*base.shape).astype("float32") * 0.05, 0, 1)
            yield img.astype("float32"), y

    return reader


def train(n_synthetic: int = 1024, size: int = 224):
    if _real_ready():
        return _real_reader("train", size)
    return _reader(n_synthetic, 0, size)


def test(n_synthetic: int = 128, size: int = 224):
    if _real_ready():
        return _real_reader("test", size)
    return _reader(n_synthetic, 1, size)


def valid(n_synthetic: int = 128, size: int = 224):
    if _real_ready():
        return _real_reader("valid", size)
    return _reader(n_synthetic, 2, size)

"""Real measured corpora that ship with scikit-learn's wheel — available with
zero network egress, unlike the reference's download-at-first-use datasets
(python/paddle/v2/dataset/common.py).  These back the no-skip real-data
convergence tests (tests/test_real_convergence.py): the reference's book
tests train on real downloaded corpora to accuracy thresholds
(e.g. python/paddle/v2/fluid/tests/book/test_recognize_digits_conv.py:60);
in this egress-free environment the genuinely real datasets on disk are
sklearn's bundled tables, so the convergence pillar is proven on these.

- ``digits``: 1,797 real 8x8 grayscale images of handwritten digits
  (UCI Optical Recognition of Handwritten Digits) — the recognize_digits
  chapter's task shape on real scans.
- ``diabetes``: 442 real patient records, 10 physiological features,
  disease-progression target (Efron et al.) — the fit_a_line chapter's
  task shape (UCI-style tabular regression) on real measurements.

The port's copy of ``paddle_tpu/datasets/sk_real.py``; numpy only, sample
for sample the JAX package's."""
from __future__ import annotations

import numpy as np


def _require_sklearn():
    try:
        import sklearn.datasets as skd  # noqa: F401
        return skd
    except ImportError as e:  # pragma: no cover - sklearn is in this image
        raise ImportError(
            "paddle_tpu_torch.datasets.sk_real needs scikit-learn (bundles the "
            "real tables); install it or use the synthetic dataset modules"
        ) from e


def _split(n, train):
    # deterministic 80/20 split by index parity-free prefix (data order is
    # fixed in the sklearn bundle)
    cut = int(n * 0.8)
    return slice(0, cut) if train else slice(cut, None)


def digits(train: bool = True):
    """Reader of (image[1,8,8] float32 in [0,1], label[1] int64) — real
    handwritten digit scans."""
    skd = _require_sklearn()
    d = skd.load_digits()
    imgs = (d.images / 16.0).astype("float32")[:, None, :, :]
    labels = d.target.astype("int64")
    sl = _split(len(labels), train)

    def reader():
        for x, y in zip(imgs[sl], labels[sl]):
            yield x, np.array([y], "int64")

    return reader


def digits28(train: bool = True):
    """Reader of (image[1,28,28] float32 in [0,1], label[1] int64): the SAME
    real handwritten scans as :func:`digits`, bicubically interpolated from
    their native 8x8 to the recognize_digits book chapter's 28x28 geometry
    (test_recognize_digits_conv.py:60 trains LeNet on 28x28 MNIST).

    Honest label: the PIXELS derive from real human handwriting; the
    RESOLUTION is interpolated — this proves the book-geometry conv stack
    (two 5x5 conv+pool pyramids) learns from real scans, not that it matches
    MNIST-scale difficulty.  When a real 28x28 corpus can be materialised,
    ``datasets.mnist``'s official idx-ubyte real branch is the loader."""
    from scipy.ndimage import zoom

    skd = _require_sklearn()
    d = skd.load_digits()
    imgs = (d.images / 16.0).astype("float32")
    big = np.stack([np.clip(zoom(im, 3.5, order=3), 0.0, 1.0) for im in imgs])
    big = big[:, None, :, :]
    labels = d.target.astype("int64")
    sl = _split(len(labels), train)

    def reader():
        for x, y in zip(big[sl], labels[sl]):
            yield x, np.array([y], "int64")

    return reader


def diabetes(train: bool = True):
    """Reader of (features[10] float32 standardised, target[1] float32
    standardised) — real patient measurements."""
    skd = _require_sklearn()
    d = skd.load_diabetes()
    x = d.data.astype("float32")
    x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-8)
    y = d.target.astype("float32")[:, None]
    y = (y - y.mean()) / y.std()
    sl = _split(len(y), train)

    def reader():
        for xi, yi in zip(x[sl], y[sl]):
            yield xi, yi

    return reader

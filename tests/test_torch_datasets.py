"""``paddle_tpu_torch.datasets`` against the JAX package's
``paddle_tpu.datasets`` on the CPU:

* each synthetic reader of the nine datasets this port adds gives the
  reference's samples, value for value and dtype for dtype, for the same
  arguments (``mnist``, ``cifar`` 10 and 100, ``uci_housing``, ``imdb``,
  ``sentiment``, ``mq2007`` in its three formats, ``flowers``,
  ``wmt_toy``), their dictionaries too, and ``sk_real``'s tables (which
  ship with scikit-learn, imported at first use);
* ``common.download`` through a ``file://`` URL: the md5-checked cache and
  the refetch that raises on a mismatch; each real-file reader, on tiny
  files in the official formats under ``$PADDLE_TPU_DATA_HOME``, gives the
  reference's samples (``sentiment`` on ``tests/data/
  sentiment_slice.jsonl``).  Nothing is downloaded."""
import gzip
import json
import os
import pickle
import struct

import numpy as np
import pytest

import paddle_tpu.datasets as J
import paddle_tpu_torch.datasets as T

DATA = os.path.join(os.path.dirname(__file__), "data")


def _same(a, b, what=""):
    """Two samples (nested tuples / lists of arrays and numbers) equal,
    types and dtypes included."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), what
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
    else:
        assert type(a) is type(b) and a == b, what


def _readers(mod, fn, *args, **kw):
    return (getattr(getattr(T, mod), fn)(*args, **kw),
            getattr(getattr(J, mod), fn)(*args, **kw))


SYNTHETIC = [
    ("mnist", "train", (), {"n_synthetic": 24}),
    ("mnist", "test", (), {"n_synthetic": 8}),
    ("cifar", "train10", (), {"n_synthetic": 16}),
    ("cifar", "test10", (), {"n_synthetic": 8}),
    ("cifar", "train100", (), {"n_synthetic": 16}),
    ("cifar", "test100", (), {"n_synthetic": 8}),
    ("uci_housing", "train", (), {}),
    ("uci_housing", "test", (), {}),
    ("imdb", "train", (), {"n_synthetic": 20}),
    ("imdb", "test", (), {"n_synthetic": 10}),
    ("sentiment", "train", (), {"n_synthetic": 20}),
    ("sentiment", "test", (), {"n_synthetic": 10}),
    ("mq2007", "train", (), {"format": "pairwise", "n_synthetic": 4}),
    ("mq2007", "train", (), {"format": "pointwise", "n_synthetic": 4}),
    ("mq2007", "test", (), {"format": "listwise", "n_synthetic": 4}),
    ("flowers", "train", (), {"n_synthetic": 6, "size": 32}),
    ("flowers", "valid", (), {"n_synthetic": 3, "size": 16}),
    ("flowers", "test", (), {"n_synthetic": 3, "size": 16}),
    ("wmt_toy", "train", (), {"n_synthetic": 30}),
    ("wmt_toy", "test", (), {"n_synthetic": 10, "max_len": 8}),
]


@pytest.fixture(autouse=True)
def empty_data_home(tmp_path, monkeypatch):
    """No real files unless a test writes them."""
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path / "home"))


@pytest.mark.parametrize("mod,fn,args,kw", SYNTHETIC,
                         ids=[f"{m}.{f}-{i}" for i, (m, f, _, _)
                              in enumerate(SYNTHETIC)])
def test_synthetic_reader_matches_the_reference(mod, fn, args, kw):
    got, want = _readers(mod, fn, *args, **kw)
    a, b = list(got()), list(want())
    assert len(a) == len(b) > 0
    for i, (x, y) in enumerate(zip(a, b)):
        _same(x, y, f"{mod}.{fn} sample {i}")
    # a second epoch replays the first (fresh seeded draws per call)
    _same(list(got())[:2], a[:2])


def test_dictionaries_and_constants_match():
    assert T.imdb.word_dict() == J.imdb.word_dict()
    assert T.sentiment.get_word_dict() == J.sentiment.get_word_dict()
    assert T.wmt_toy.get_dict() == J.wmt_toy.get_dict()
    for mod, names in (("mnist", ("N_CLASSES", "IMG_SHAPE")),
                       ("uci_housing", ("FEATURE_DIM", "TRAIN_ROWS")),
                       ("imdb", ("VOCAB_SIZE", "POS_MARKERS", "NEG_MARKERS")),
                       ("flowers", ("NUM_CLASSES", "IMG_SHAPE")),
                       ("mq2007", ("FEATURE_DIM",)),
                       ("wmt_toy", ("SRC_VOCAB", "TGT_VOCAB", "BOS", "EOS",
                                    "UNK"))):
        for n in names:
            assert getattr(getattr(T, mod), n) == getattr(getattr(J, mod),
                                                          n), (mod, n)
    np.testing.assert_array_equal(T.uci_housing._TRUE_W,
                                  J.uci_housing._TRUE_W)


@pytest.mark.parametrize("fn,kw", [("digits", {"train": True}),
                                   ("digits", {"train": False}),
                                   ("diabetes", {"train": True}),
                                   ("digits28", {"train": False})])
def test_sk_real_tables_match(fn, kw):
    pytest.importorskip("sklearn")
    got, want = _readers("sk_real", fn, **kw)
    a, b = list(got()), list(want())
    assert len(a) == len(b) > 100
    for x, y in zip(a[::37], b[::37]):
        _same(x, y, fn)


# -------------------------------------------------------------- real files


def test_download_caches_and_verifies_md5(tmp_path):
    src = tmp_path / "blob.bin"
    src.write_bytes(b"paddle-tpu-torch-test-payload")
    url = "file://" + str(src)
    good = T.common.md5file(str(src))
    assert good == J.common.md5file(str(src))
    p1 = T.common.download(url, "blobs", good)
    assert os.path.exists(p1)
    src.write_bytes(b"CHANGED")   # a cache hit reads no source
    p2 = T.common.download(url, "blobs", good)
    assert p1 == p2 and T.common.md5file(p2) == good
    with pytest.raises(IOError, match="md5 mismatch"):
        T.common.download(url, "blobs2", "0" * 32)
    assert T.common.cached_path("blobs", os.path.basename(p1)) == p1
    assert T.common.cached_path("blobs", "missing") is None
    assert T.common.DOWNLOAD_RETRY.max_attempts == \
        J.common.DOWNLOAD_RETRY.max_attempts == 2


def _home():
    return os.environ["PADDLE_TPU_DATA_HOME"]


def _same_stream(mod, fn, *args, **kw):
    got, want = _readers(mod, fn, *args, **kw)
    a, b = list(got()), list(want())
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same(x, y, f"{mod}.{fn}")
    return a


def test_mnist_cifar_uci_real_files():
    home = _home()
    base = os.path.join(home, "mnist")
    os.makedirs(base)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (7, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, 7).astype(np.uint8)
    with gzip.open(os.path.join(base, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, 7, 28, 28) + imgs.tobytes())
    with gzip.open(os.path.join(base, "train-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, 7) + labels.tobytes())
    rows = _same_stream("mnist", "train")
    assert [y for _, y in rows] == labels.tolist()
    d = os.path.join(home, "cifar", "cifar-10-batches-py")
    os.makedirs(d)
    for name, n in [("data_batch_%d" % i, 4) for i in range(1, 6)] + [
            ("test_batch", 3)]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072),
                                              dtype=np.uint8),
                         b"labels": rng.randint(0, 10, n).tolist()}, f)
    assert len(_same_stream("cifar", "train10")) == 20
    assert len(_same_stream("cifar", "test10")) == 3
    d = os.path.join(home, "uci_housing")
    os.makedirs(d)
    table = rng.rand(50, 14) * ([100] * 13 + [50])
    with open(os.path.join(d, "housing.data"), "w") as f:
        for r in table:
            f.write(" ".join(f"{v:.4f}" for v in r) + "\n")
    assert len(_same_stream("uci_housing", "train")) == 50
    assert _same_stream("uci_housing", "test") == []


def test_imdb_sentiment_wmt_mq2007_real_files():
    home = _home()
    for split in ("train", "test"):
        for label, text in (("pos", "a great wonderful movie truly great"),
                            ("neg", "a terrible awful movie truly terrible")):
            d = os.path.join(home, "imdb", "aclImdb", split, label)
            os.makedirs(d)
            for i in range(3):
                with open(os.path.join(d, f"{i}_7.txt"), "w") as f:
                    f.write(text + f" take{i}")
    assert T.imdb.word_dict() == J.imdb.word_dict()
    assert len(_same_stream("imdb", "train")) == 6
    counters = {}
    with open(os.path.join(DATA, "sentiment_slice.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            d = os.path.join(home, "sentiment", "movie_reviews", r["label"])
            os.makedirs(d, exist_ok=True)
            i = counters.setdefault(r["label"], 0)
            with open(os.path.join(d, f"cv{i:03d}.txt"), "w") as g:
                g.write(r["text"])
            counters[r["label"]] = i + 1
    wd = T.sentiment.get_word_dict()
    assert wd == J.sentiment.get_word_dict() and len(wd) > 200
    train = _same_stream("sentiment", "train", word_idx=wd)
    test = _same_stream("sentiment", "test", word_idx=wd)
    assert len(train) + len(test) == sum(counters.values())
    d = os.path.join(home, "wmt14")
    os.makedirs(d)
    for split, src, tgt in (("train", "hello world\ngood day world\n",
                             "bonjour monde\nbonne journee monde\n"),
                            ("test", "hello day\n", "bonjour\n")):
        with open(os.path.join(d, f"{split}.src.txt"), "w") as f:
            f.write(src)
        with open(os.path.join(d, f"{split}.tgt.txt"), "w") as f:
            f.write(tgt)
    assert T.wmt_toy.get_dict() == J.wmt_toy.get_dict()
    assert len(_same_stream("wmt_toy", "train")) == 2
    assert len(_same_stream("wmt_toy", "test")) == 1
    d = os.path.join(home, "mq2007")
    os.makedirs(d)
    rows = []
    for qid, rels in (("10", [2, 0, 1]), ("11", [0, 1])):
        for i, r in enumerate(rels):
            feats = " ".join(f"{k}:{(i + k) % 5 / 4:.2f}" for k in range(1, 47))
            rows.append(f"{r} qid:{qid} {feats} #docid = d{qid}-{i}")
    with open(os.path.join(d, "train.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    for fmt, n in (("listwise", 2), ("pairwise", 4), ("pointwise", 5)):
        assert len(_same_stream("mq2007", "train", format=fmt)) == n


def test_flowers_real_files():
    pytest.importorskip("scipy")
    Image = pytest.importorskip("PIL.Image")
    import scipy.io

    d = os.path.join(_home(), "flowers")
    os.makedirs(os.path.join(d, "jpg"))
    rng = np.random.RandomState(0)
    for i in range(1, 5):
        Image.fromarray(rng.randint(0, 255, (30, 40, 3), dtype=np.uint8)
                        ).save(os.path.join(d, "jpg", f"image_{i:05d}.jpg"))
    scipy.io.savemat(os.path.join(d, "imagelabels.mat"),
                     {"labels": np.array([[5, 9, 5, 102]])})
    scipy.io.savemat(os.path.join(d, "setid.mat"),
                     {"trnid": np.array([[1, 4]]), "valid": np.array([[2]]),
                      "tstid": np.array([[3]])})
    tr = _same_stream("flowers", "train", size=32)
    assert [y for _, y in tr] == [4, 101]
    assert len(_same_stream("flowers", "valid", size=16)) == 1
    assert len(_same_stream("flowers", "test", size=16)) == 1

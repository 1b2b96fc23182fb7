"""The real-file readers of ``paddle_tpu_torch.datasets`` against the JAX
package's on the CPU, sample for sample (bitwise: both are numpy):

* ``conll05`` over the CoNLL-05 slice in ``tests/data/conll05/``: the
  dictionaries, ``train`` and ``test``;
* ``voc2012`` over a VOCdevkit the test writes: segmentation ``train`` /
  ``test`` (palette masks with a void pixel) and ``detection_train`` /
  ``detection_test`` (XML boxes, zero-padded to ``max_boxes``);
* ``imikolov`` over Penn Treebank text the test writes: ``word_dict`` with
  its cutoff, and ``train`` / ``test`` windows with that dictionary;
* ``movielens`` over ml-1m ``.dat`` files the test writes;
* ``ctr`` over Criteo rows the test writes (empty fields, a negative
  count, an unlabelled row skipped), and a file of unlabelled rows
  refused by both packages.

Nothing is downloaded: ``PADDLE_TPU_DATA_HOME`` points at the test's own
files."""
import os
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.datasets import conll05 as jconll
from paddle_tpu.datasets import ctr as jctr
from paddle_tpu.datasets import imikolov as jimk
from paddle_tpu.datasets import movielens as jml
from paddle_tpu.datasets import voc2012 as jvoc
from paddle_tpu_torch.datasets import conll05, ctr, imikolov, movielens, voc2012

DATA = Path(__file__).resolve().parent / "data"


def _same(got, want):
    """Two sample streams equal: element for element, arrays bitwise with
    their dtypes."""
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                assert isinstance(a, np.ndarray) and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b and type(a) is type(b)


def test_conll05_sample_files_match_the_reference(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(DATA))
    dicts = conll05.get_dict()
    assert dicts == jconll.get_dict()
    word_dict, verb_dict, label_dict = dicts
    assert "<unk>" in word_dict and label_dict["O"] == 0
    _same(list(conll05.train()()), list(jconll.train()()))
    _same(list(conll05.test()()), list(jconll.test()()))
    # one sample per predicate column; the mark flags the predicate
    for s in conll05.train()():
        assert sum(s[7]) == 1 and len({len(c) for c in s}) == 1


def _voc_root(tmp_path):
    root = tmp_path / "voc2012" / "VOCdevkit" / "VOC2012"
    for sub in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation",
                "Annotations", "ImageSets/Main"):
        (root / sub).mkdir(parents=True)
    return root


def test_voc2012_segmentation_files_match_the_reference(tmp_path,
                                                        monkeypatch):
    from PIL import Image

    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    root = _voc_root(tmp_path)
    rng = np.random.RandomState(1)
    names = ("2007_000001", "2007_000002", "2007_000003")
    for i, name in enumerate(names):
        Image.fromarray(rng.randint(0, 255, (30, 20, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{name}.jpg")
        mask = np.zeros((30, 20), np.uint8)
        mask[4:12, 3:12] = 7 + i
        mask[0, 0] = 255  # void boundary pixel
        pim = Image.fromarray(mask, mode="P")
        pim.putpalette([v for j in range(256) for v in (j, j, j)])
        pim.save(root / "SegmentationClass" / f"{name}.png")
    (root / "ImageSets" / "Segmentation" / "train.txt").write_text(
        "\n".join(names[:2]) + "\n")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text(
        names[2] + "\n")
    for size in (24, 16):
        _same(list(voc2012.train(size=size)()),
              list(jvoc.train(size=size)()))
        _same(list(voc2012.test(size=size)()), list(jvoc.test(size=size)()))
    img, mask = next(voc2012.train(size=24)())
    assert img.shape == (3, 24, 24) and set(np.unique(mask)) == {0, 7}


def test_voc2012_detection_files_match_the_reference(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    root = _voc_root(tmp_path)
    objs = {"img1": [("dog", (20, 10, 100, 60)), ("person", (150, 50, 200,
                                                             100))],
            "img2": [("cat", (0, 0, 50, 40))],
            "img3": [("car", (5, 6, 7, 8)), ("bus", (10, 10, 190, 90)),
                     ("cow", (1, 2, 3, 4))]}
    for name, boxes in objs.items():
        Image.fromarray(np.full((100, 200, 3), len(boxes) * 40,
                                np.uint8)).save(
            root / "JPEGImages" / f"{name}.jpg")
        xml = "".join(
            f"<object><name>{c}</name><bndbox><xmin>{b[0]}</xmin>"
            f"<ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax>"
            f"</bndbox></object>" for c, b in boxes)
        (root / "Annotations" / f"{name}.xml").write_text(
            "<annotation><size><width>200</width><height>100</height>"
            f"<depth>3</depth></size>{xml}</annotation>")
    (root / "ImageSets" / "Main" / "train.txt").write_text("img1\nimg3\n")
    (root / "ImageSets" / "Main" / "val.txt").write_text("img2 1\n")
    _same(list(voc2012.detection_train(size=32, max_boxes=2)()),
          list(jvoc.detection_train(size=32, max_boxes=2)()))
    _same(list(voc2012.detection_test(size=48, max_boxes=4)()),
          list(jvoc.detection_test(size=48, max_boxes=4)()))
    img, boxes, labels = next(voc2012.detection_train(size=64,
                                                      max_boxes=8)())
    np.testing.assert_allclose(boxes[0], [0.1, 0.1, 0.5, 0.6], atol=1e-6)
    assert labels[0] == voc2012.DET_CLASSES.index("dog") + 1
    assert labels[2] == 0 and np.all(boxes[2:] == 0)


def test_imikolov_ptb_files_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    d = tmp_path / "imikolov"
    d.mkdir()
    (d / "ptb.train.txt").write_text(
        "the cat sat on the mat\nthe dog sat on the <unk> cat\n" * 30
        + "a b\n")
    (d / "ptb.valid.txt").write_text("the cat ran\n\nthe mat sat on\n")
    for cutoff in (10, 0):
        wd = imikolov.word_dict(min_word_freq=cutoff)
        assert wd == jimk.word_dict(min_word_freq=cutoff)
        assert wd["<unk>"] == len(wd) - 1
        for n in (3, 5):
            _same(list(imikolov.train(wd, n=n)()),
                  list(jimk.train(wd, n=n)()))
            _same(list(imikolov.test(wd, n=n)()), list(jimk.test(wd, n=n)()))
    # with no dictionary given, the real one (cutoff 50: only the markers
    # and the most frequent words survive)
    _same(list(imikolov.train(n=2)()), list(jimk.train(n=2)()))


def test_movielens_files_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    d = tmp_path / "movielens" / "ml-1m"
    d.mkdir(parents=True)
    (d / "users.dat").write_text(
        "1::F::1::10::48067\n2::M::56::16::70072\n3::M::25::15::55117\n")
    (d / "movies.dat").write_text(
        "1::Toy Story (1995)::Animation|Children's|Comedy\n"
        "2::Jumanji (1995)::Adventure|Children's|Fantasy\n"
        "3::Unknown Genre (1995)::Nonexistent\n")
    rng = np.random.RandomState(5)
    rows = [f"{rng.randint(1, 5)}::{rng.randint(1, 5)}::{rng.randint(1, 6)}"
            f"::978300760" for _ in range(37)]
    (d / "ratings.dat").write_text("\n".join(rows) + "\n")
    for split in ("train", "test"):
        _same(list(getattr(movielens, split)()()),
              list(getattr(jml, split)()()))
    assert len(list(movielens.train()())) == 33
    assert len(list(movielens.test()())) == 4


def test_ctr_criteo_files_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    d = tmp_path / "ctr"
    d.mkdir()
    rng = np.random.RandomState(2)
    lines = []
    for i in range(12):
        ints = [str(int(v)) if v > -5 else "" for v in
                rng.randint(-6, 1000, 13)]
        cats = [f"{int(v):08x}" if v % 5 else "" for v in
                rng.randint(0, 2 ** 31, 26)]
        lines.append("\t".join([str(i % 2)] + ints + cats))
    lines.insert(5, "\t".join(["1"] * 39))  # unlabelled row: skipped
    (d / "train.txt").write_text("\n".join(lines) + "\n")
    (d / "test.txt").write_text("\n".join(lines[:4]) + "\n")
    got, want = list(ctr.train()()), list(jctr.train()())
    assert len(got) == 12
    _same(got, want)
    _same(list(ctr.test()()), list(jctr.test()()))
    bad = d / "bad.txt"
    bad.write_text("\t".join(["1"] * 39) + "\n")
    for mod in (ctr, jctr):
        with pytest.raises(ValueError, match="labeled Criteo format"):
            list(mod._real_reader(str(bad))())

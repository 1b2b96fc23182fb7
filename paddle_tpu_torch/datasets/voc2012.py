"""PASCAL VOC2012 segmentation (ref: python/paddle/v2/dataset/voc2012.py —
images + per-pixel class masks, 21 classes incl. background).  Synthetic mode:
rectangles of a class color on background, mask matching exactly.

Real mode: the official VOCdevkit layout at
$PADDLE_TPU_DATA_HOME/voc2012/VOCdevkit/VOC2012/ — JPEGImages/*.jpg,
SegmentationClass/*.png (palette PNGs whose pixel values ARE the class ids,
255 = void -> 0), split lists under ImageSets/Segmentation/{train,val}.txt.
Images and masks are resized to the requested square size (masks with
nearest-neighbour so ids stay exact).

The port's copy of ``paddle_tpu/datasets/voc2012.py`` (numpy; PIL for the
image files, imported at first use): the synthetic and the real-file
readers give the JAX package's samples, sample for sample.
"""
from __future__ import annotations

import os

import numpy as np

from . import common

NUM_CLASSES = 21

_SPLIT_FILES = {"train": "train.txt", "test": "val.txt"}


def _voc_root():
    return common.cached_path("voc2012", "VOCdevkit", "VOC2012")


def _seg_ready(split):
    """The SEGMENTATION branch needs its own pieces — a detection-only
    VOCdevkit (Annotations + ImageSets/Main) must not hijack the synthetic
    segmentation loaders."""
    root = _voc_root()
    return (root
            and os.path.exists(os.path.join(root, "SegmentationClass"))
            and os.path.exists(os.path.join(root, "ImageSets", "Segmentation",
                                            _SPLIT_FILES[split])))


def _real_reader(split, size):
    from PIL import Image

    root = _voc_root()
    lst = os.path.join(root, "ImageSets", "Segmentation", _SPLIT_FILES[split])
    with open(lst) as f:
        names = [ln.strip() for ln in f if ln.strip()]

    def reader():
        for name in names:
            ip = os.path.join(root, "JPEGImages", name + ".jpg")
            mp = os.path.join(root, "SegmentationClass", name + ".png")
            with Image.open(ip) as im:
                img = np.asarray(im.convert("RGB").resize((size, size)),
                                 dtype="float32") / 255.0
            with Image.open(mp) as mm:
                # palette PNG pixel values are the class ids; NEAREST keeps
                # them exact under resize; 255 marks void boundaries -> 0
                mask = np.asarray(mm.resize((size, size), Image.NEAREST),
                                  dtype="int64")
            mask = np.where(mask == 255, 0, mask)
            yield img.transpose(2, 0, 1), mask

    return reader


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


# the 20 VOC object classes, id 1..20 (0 = background) — official ordering
DET_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
               "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
               "tvmonitor")


def _real_detection_reader(split, size, max_boxes):
    """Official detection annotations: Annotations/<name>.xml bndbox entries
    -> (img [3,S,S], boxes [max_boxes,4] normalised corners 0-padded,
    labels [max_boxes] int, 0 past the real count) — the ssd.build feed
    convention."""
    import xml.etree.ElementTree as ET

    from PIL import Image

    root = _voc_root()
    if root is None:
        raise FileNotFoundError(
            "VOC detection data not found: expected the official layout at "
            "$PADDLE_TPU_DATA_HOME/voc2012/VOCdevkit/VOC2012 (Annotations/, "
            "JPEGImages/, ImageSets/Main/)")
    lst = os.path.join(root, "ImageSets", "Main",
                       {"train": "train.txt", "test": "val.txt"}[split])
    with open(lst) as f:
        names = [ln.split()[0] for ln in f if ln.strip()]
    cls_id = {c: i + 1 for i, c in enumerate(DET_CLASSES)}

    def reader():
        for name in names:
            xml = ET.parse(os.path.join(root, "Annotations", name + ".xml"))
            sz = xml.find("size")
            W = float(sz.find("width").text)
            H = float(sz.find("height").text)
            boxes = np.zeros((max_boxes, 4), "float32")
            labels = np.zeros((max_boxes,), "int64")
            k = 0
            for obj in xml.iter("object"):
                if k >= max_boxes:
                    break
                cname = obj.find("name").text.strip()
                if cname not in cls_id:
                    continue
                bb = obj.find("bndbox")
                x0 = float(bb.find("xmin").text) / W
                y0 = float(bb.find("ymin").text) / H
                x1 = float(bb.find("xmax").text) / W
                y1 = float(bb.find("ymax").text) / H
                boxes[k] = (x0, y0, x1, y1)
                labels[k] = cls_id[cname]
                k += 1
            if k == 0:
                continue
            with Image.open(os.path.join(root, "JPEGImages",
                                         name + ".jpg")) as im:
                img = np.asarray(im.convert("RGB").resize((size, size)),
                                 dtype="float32") / 255.0
            yield img.transpose(2, 0, 1), boxes, labels

    return reader


def detection_train(size: int = 128, max_boxes: int = 16):
    """Real-format-only: requires the VOCdevkit layout (no synthetic twin —
    the synthetic detection feed lives in tests/test_detection.py)."""
    return _real_detection_reader("train", size, max_boxes)


def detection_test(size: int = 128, max_boxes: int = 16):
    return _real_detection_reader("test", size, max_boxes)


def train(n_synthetic: int = 512, size: int = 128):
    if _seg_ready("train"):
        return _real_reader("train", size)
    return _reader(n_synthetic, 0, size)


def test(n_synthetic: int = 64, size: int = 128):
    if _seg_ready("test"):
        return _real_reader("test", size)
    return _reader(n_synthetic, 1, size)

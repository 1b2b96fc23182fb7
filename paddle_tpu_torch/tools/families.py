"""The book and demo families at their ``build()`` defaults, with their
optimizers and batches, as ``chip_smoke.py``'s families phase trains them
on the card:

* ``word2vec``: the imikolov vocabulary (2074 words), embedding 32,
  hidden 256, 4 context words, batch 256, Adam(1e-3);
* ``recommender``: the full movielens tables, embedding 32, fc 200, batch
  256, Adam(5e-3);
* ``traffic``: 24 past readings, 24 horizons, embedding 16, 4 classes,
  batch 1024, Adam(1e-2), a horizon's class the reading it lags by
  (``tests/test_models.py:447``'s rule);
* ``gan``: image 784, z 100, hidden 256, batch 128, Adam(2e-4, beta1
  0.5), D and G alternating, the real images two prototypes plus noise in
  tanh's range (``tests/test_models.py:285``'s rule);
* ``vae``: 784 / 256 / 32, batch 128, Adam(1e-3), the images four binary
  prototypes (``tests/test_models.py:268``'s rule);
* ``wide_deep`` and ``deepfm`` (``models.ctr`` at its defaults): all 26
  ``FIELD_VOCABS`` (185,971 rows a table set), emb 8, hidden (64, 32),
  batch 256 of ``datasets.ctr``'s synthetic clicks, Adam(5e-3);
  ``is_sparse=True`` routes every lookup through the sparse engine.

Batches are numpy arrays from a seed (the datasets' synthetic readers for
word2vec and the recommender); programs are built in new Programs."""
from __future__ import annotations

import numpy as np

FAMILY_BATCH = {"word2vec": 256, "recommender": 256, "traffic": 1024,
                "gan": 128, "vae": 128, "wide_deep": 256, "deepfm": 256}
CTR_MODELS = ("wide_deep", "deepfm")
W2V_WORDS = ["w0", "w1", "w2", "w3"]
REC_IDS = ["uid", "gender", "age", "job", "mid", "category"]
TRAFFIC_TERM, TRAFFIC_HORIZONS, TRAFFIC_CLASSES = 24, 24, 4
GAN_IMG, GAN_Z = 784, 100
VAE_IMG = 784


def build_family(name: str, is_sparse: bool = False):
    """``name``'s program at its ``build()`` defaults with its optimizer,
    in new Programs: (loss, main, startup) for word2vec, recommender,
    traffic, vae, wide_deep and deepfm (``is_sparse`` for the last two);
    ``models.gan.build()``'s dict for gan."""
    import paddle_tpu_torch as fluid

    if name == "gan":
        return fluid.models.gan.build()
    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers
    with fluid.program_guard(main, startup):
        if name == "word2vec":
            ws = [L.data(n, [1], dtype="int32") for n in W2V_WORDS]
            tgt = L.data("tgt", [1], dtype="int32")
            loss, _ = fluid.models.word2vec.build(
                ws, tgt, fluid.datasets.imikolov.VOCAB_SIZE)
            opt = fluid.optimizer.Adam(1e-3)
        elif name == "recommender":
            ids = [L.data(n, [1], dtype="int32") for n in REC_IDS]
            rating = L.data("rating", [1])
            loss, _ = fluid.models.recommender.build(*ids, rating)
            opt = fluid.optimizer.Adam(5e-3)
        elif name == "traffic":
            enc = L.data("enc", [TRAFFIC_TERM])
            lab = L.data("lab", [TRAFFIC_HORIZONS], dtype="int32")
            loss, _, _ = fluid.models.traffic.build(enc, lab)
            opt = fluid.optimizer.Adam(1e-2)
        elif name == "vae":
            x = L.data("x", [VAE_IMG])
            loss = fluid.models.vae.build(x)[0]
            opt = fluid.optimizer.Adam(1e-3)
        elif name in CTR_MODELS:
            ctr = fluid.datasets.ctr
            dense = L.data("dense", [ctr.NUM_DENSE])
            sparse = L.data("sparse", [ctr.NUM_SPARSE], dtype="int32")
            label = L.data("label", [1], dtype="int32")
            loss = getattr(fluid.models.ctr, name)(dense, sparse, label,
                                                   is_sparse=is_sparse)[0]
            opt = fluid.optimizer.Adam(5e-3)
        else:
            raise ValueError(f"unknown family {name!r}")
        opt.minimize(loss)
    return loss, main, startup


def family_batch(name: str, seed: int, n: int = None) -> dict:
    """A batch of ``n`` examples (the family's batch by default) from
    ``seed``; for gan, D's feed (images and z) and G's (z) as
    ``{"d": ..., "g": ...}``."""
    import paddle_tpu_torch as fluid

    n = n or FAMILY_BATCH[name]
    rng = np.random.RandomState(seed)
    if name == "word2vec":
        grams = np.array(list(fluid.datasets.imikolov.train(
            n=5, n_synthetic=n * (seed + 1))())[-n:], np.int32)
        feed = {w: grams[:, k:k + 1] for k, w in enumerate(W2V_WORDS)}
        feed["tgt"] = grams[:, 4:5]
        return feed
    if name == "recommender":
        data = list(fluid.datasets.movielens.train(n * (seed + 1))())[-n:]
        feed = {k: np.array([[d[i]] for d in data], np.int32)
                for i, k in enumerate(REC_IDS)}
        feed["rating"] = np.stack([d[6] for d in data])
        return feed
    if name in CTR_MODELS:
        data = list(fluid.datasets.ctr.train(n * (seed + 1))())[-n:]
        return {"dense": np.stack([d[0] for d in data]),
                "sparse": np.stack([d[1] for d in data]).astype(np.int32),
                "label": np.array([[d[2]] for d in data], np.int32)}
    if name == "traffic":
        xs = rng.randint(0, TRAFFIC_CLASSES,
                         (n, TRAFFIC_TERM)).astype(np.float32)
        return {"enc": xs / (TRAFFIC_CLASSES - 1.0),
                "lab": xs[:, -TRAFFIC_HORIZONS:].astype(np.int32)}
    if name == "vae":
        protos = (np.random.RandomState(0).rand(4, VAE_IMG) > 0.5).astype(
            np.float32)
        return {"x": protos[rng.randint(0, 4, n)]}
    if name == "gan":
        protos = np.sign(np.random.RandomState(0).randn(
            2, GAN_IMG)).astype(np.float32) * 0.8
        img = np.clip(protos[rng.randint(0, 2, n)]
                      + rng.randn(n, GAN_IMG).astype(np.float32) * 0.05,
                      -1, 1).astype(np.float32)
        return {"d": {"img": img,
                      "z": rng.randn(n, GAN_Z).astype(np.float32)},
                "g": {"z": rng.randn(n, GAN_Z).astype(np.float32)}}
    raise ValueError(f"unknown family {name!r}")

"""The CTR family (``models.ctr``: wide&deep and DeepFM; ``datasets.ctr``)
and the recommender's ``is_sparse`` path, paddle_tpu_torch against the JAX
package on the CPU:

* the synthetic CTR reader sample for sample the reference's;
* both models built in both packages with the same parameter names and
  shapes, and one Adam step of each from the JAX startup's weights loaded
  by name (small vocabularies): the loss within 1e-5 relative, every
  gradient within 1e-4 of its max abs, every parameter after the update
  within 1e-5 of its max abs (the JAX package's 52 s DeepFM AUC test
  stays in its slow lane);
* ``is_sparse=True`` against ``False`` from the same weights and batch:
  the loss and every gradient bitwise equal (no padding id, so both paths
  gather and add the same values);
* ``tests/test_ctr.py::test_wide_deep_converges`` mirrored at its
  threshold, on the port's own initialisation;
* the recommender with ``is_sparse=True`` built with the reference's
  names and trained a few steps."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid

CPU = tfluid.CPUPlace()
VOCABS = [50, 31, 7, 12]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


def test_ctr_reader_matches_the_reference(tmp_path):
    from paddle_tpu.datasets import ctr as jctr
    from paddle_tpu_torch.datasets import ctr

    assert ctr.FIELD_VOCABS == jctr.FIELD_VOCABS
    assert sum(ctr.FIELD_VOCABS) == 185971
    assert (ctr.NUM_DENSE, ctr.NUM_SPARSE) == (13, 26) == (
        jctr.NUM_DENSE, jctr.NUM_SPARSE)
    for got, want in ((ctr.train(64), jctr._reader(64, 0)),
                      (ctr.test(16), jctr._reader(16, 1))):
        a, b = list(got()), list(want())
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
            assert x[2] == y[2]
    # the Criteo file reader: one labelled row with empty fields, the
    # same samples in both packages
    p = tmp_path / "train.txt"
    p.write_text("1\t" + "\t".join(["5", ""] * 6 + ["-3"]) + "\t"
                 + "\t".join(["68fd1e64", ""] * 13) + "\n")
    (x, y), = zip(list(ctr._real_reader(str(p))()),
                  list(jctr._real_reader(str(p))()))
    np.testing.assert_array_equal(x[0], y[0])
    np.testing.assert_array_equal(x[1], y[1])
    assert x[2] == y[2] == 1


def _pack(samples, vocabs=None):
    ids = np.stack([s[1] for s in samples]).astype("int32")
    if vocabs is not None:
        ids = ids[:, :len(vocabs)] % np.array(vocabs)
    return {"dense": np.stack([s[0] for s in samples]),
            "sparse": ids.astype("int32"),
            "label": np.array([[s[2]] for s in samples], "int32")}


def _build(fl, model, vocabs=VOCABS, is_sparse=False, opt=True):
    dense = fl.layers.data("dense", [13])
    sparse = fl.layers.data("sparse", [len(vocabs)], dtype="int32")
    label = fl.layers.data("label", [1], dtype="int32")
    fn = getattr(fl.models.ctr, model)
    loss, prob = fn(dense, sparse, label, vocabs=vocabs, emb_dim=4,
                    hidden=(8,), is_sparse=is_sparse)
    if opt:
        fl.optimizer.Adam(5e-3).minimize(loss)
    return loss


def _batch(n=32, vocabs=VOCABS):
    from paddle_tpu_torch.datasets import ctr

    return _pack(list(ctr.train(n)()), vocabs)


@pytest.mark.parametrize("model", ["wide_deep", "deepfm"])
def test_one_step_matches_jax(model):
    feed = _batch()
    jloss = _build(jfluid, model)
    jmain = jfluid.default_main_program()
    params = [p.name for p in jmain.parameters()]
    shapes = [tuple(p.shape) for p in jmain.parameters()]
    fetch = [jloss.name] + [f"{n}@GRAD" for n in params]
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    weights = {n: np.asarray(jfluid.global_scope().find_var(n))
               for n in params}
    want = [np.asarray(a) for a in jexe.run(feed=feed, fetch_list=fetch)]
    jstate = {n: np.asarray(jfluid.global_scope().find_var(n))
              for n in params}

    tloss = _build(tfluid, model)
    main = tfluid.default_main_program()
    assert [p.name for p in main.parameters()] == params
    assert [tuple(p.shape) for p in main.parameters()] == shapes
    prefix = "wide" if model == "wide_deep" else "fm1"
    assert f"{prefix}_emb_0" in params
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    tfluid.load_scope(weights, main, scope, device="cpu")
    got = exe.run(main, feed=feed, fetch_list=[tloss.name] + fetch[1:],
                  scope=scope)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= 1e-4 * scale, name
    for n, b in jstate.items():
        a = scope.find_var(n).numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), n


@pytest.mark.parametrize("model", ["wide_deep", "deepfm"])
def test_is_sparse_is_bitwise_the_dense_path(model):
    """From the same weights and batch: the loss and every gradient of the
    ``is_sparse=True`` program bitwise the dense program's."""
    feed = _batch(48)
    runs = []
    for sparse in (False, True):
        tfluid.reset_default_programs()
        loss = _build(tfluid, model, is_sparse=sparse)
        main = tfluid.default_main_program()
        names = [p.name for p in main.parameters()]
        if not runs:
            rng = np.random.RandomState(0)
            weights = {p.name: (0.3 * rng.standard_normal(
                tuple(p.shape))).astype(np.float32)
                for p in main.parameters()}
        exe = tfluid.Executor(CPU)
        scope = tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        tfluid.load_scope(weights, main, scope, device="cpu")
        runs.append(exe.run(main, feed=feed, fetch_list=[loss] + [
            f"{n}@GRAD" for n in names], scope=scope))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_wide_deep_converges():
    """``tests/test_ctr.py::test_wide_deep_converges`` mirrored: all 26
    fields, emb 4, hidden (32,), Adam(5e-3), 40 steps of 256; the last loss
    below 0.7 of the first."""
    from paddle_tpu_torch.datasets import ctr as ctr_data

    dense = tfluid.layers.data("dense", [ctr_data.NUM_DENSE])
    sparse = tfluid.layers.data("sparse", [ctr_data.NUM_SPARSE],
                                dtype="int32")
    label = tfluid.layers.data("label", [1], dtype="int32")
    loss, _ = tfluid.models.ctr.wide_deep(dense, sparse, label, emb_dim=4,
                                          hidden=(32,))
    tfluid.optimizer.Adam(5e-3).minimize(loss)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    data = list(ctr_data.train(2048)())
    first = last = None
    for i in range(40):
        batch = [data[(i * 256 + j) % len(data)] for j in range(256)]
        out, = exe.run(feed=_pack(batch), fetch_list=[loss])
        if first is None:
            first = float(out)
        last = float(out)
    assert last < first * 0.7, (first, last)


def test_recommender_is_sparse_builds_and_trains():
    """The recommender with ``is_sparse=True``: the reference's parameter
    names and shapes, and 8 Adam steps on the synthetic ratings that bring
    the loss down."""
    from paddle_tpu_torch.datasets import movielens

    names = ["uid", "gender", "age", "job", "mid", "category"]

    def build(fl):
        ids = [fl.layers.data(n, [1], dtype="int32") for n in names]
        rating = fl.layers.data("rating", [1])
        loss, _ = fl.models.recommender.build(*ids, rating, emb_dim=8,
                                              fc_size=16, is_sparse=True)
        fl.optimizer.Adam(5e-3).minimize(loss)
        return loss

    build(jfluid)
    want = [(p.name, tuple(p.shape))
            for p in jfluid.default_main_program().parameters()]
    loss = build(tfluid)
    main = tfluid.default_main_program()
    assert [(p.name, tuple(p.shape)) for p in main.parameters()] == want
    assert all(op.attrs.get("is_sparse") for op in main.list_ops()
               if op.type == "embedding")
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    data = list(movielens.train(64)())
    feed = {n: np.array([[d[i]] for d in data], "int32")
            for i, n in enumerate(names)}
    feed["rating"] = np.stack([d[6] for d in data])
    losses = [float(exe.run(feed=feed, fetch_list=[loss])[0])
              for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_models_export_ctr_and_its_names():
    import paddle_tpu.models.ctr as jctr
    import paddle_tpu_torch.models.ctr as tctr

    public = {n for n, v in vars(jctr).items()
              if callable(v) and not n.startswith("_")
              and getattr(v, "__module__", None) == jctr.__name__}
    assert public == {"wide_deep", "deepfm", "wide_deep_sparse_table",
                      "wide_deep_sparse_params", "wide_deep_sparse_loss"}
    for n in public:
        assert callable(getattr(tctr, n))
    assert "ctr" in tfluid.models.__all__
    p = tctr.wide_deep_sparse_params(VOCABS, 4, 13, hidden=(8, 4), seed=1)
    q = jctr.wide_deep_sparse_params(VOCABS, 4, 13, hidden=(8, 4), seed=1)
    assert list(p) == list(q)
    for k in p:
        np.testing.assert_array_equal(p[k], q[k])


def test_shard_spec_raises_and_names_a9():
    """``shard_spec`` puts the spec on every field table (the vocab-parallel
    lookup under a Strategy: tests/test_torch_serving_mesh.py, which holds
    both lookups on {dp 2, tp 2} against JAX).  ``is_sparse=True`` on
    such tables, once refused, builds too: without a mesh its step is
    bitwise the dense step from the same weights (loss and every
    gradient)."""
    feed = _batch(24)
    outs = {}
    for is_sparse in (False, True):
        tfluid.reset_default_programs()
        dense = tfluid.layers.data("dense", [13])
        sparse = tfluid.layers.data("sparse", [len(VOCABS)], dtype="int32")
        label = tfluid.layers.data("label", [1], dtype="int32")
        loss, _ = tfluid.models.ctr.wide_deep(
            dense, sparse, label, vocabs=VOCABS,
            shard_spec=tfluid.parallel.P("tp", None), is_sparse=is_sparse)
        main = tfluid.default_main_program()
        tables = [v for v in main.parameters() if "_emb_" in v.name]
        assert len(tables) == 2 * len(VOCABS)
        assert all(tuple(v.sharding) == ("tp", None) for v in tables)
        assert all(op.attrs.get("is_sparse") == is_sparse
                   for op in main.list_ops() if op.type == "embedding")
        tfluid.optimizer.SGD(0.1).minimize(loss)
        exe = tfluid.Executor(CPU)
        scope = tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        if is_sparse:
            tfluid.load_scope(outs["w"], main, scope, device="cpu")
        else:
            outs["w"] = {p.name: scope.find_var(p.name).numpy().copy()
                         for p in main.parameters()}
        names = [loss.name] + [p.name + "@GRAD" for p in main.parameters()]
        outs[is_sparse] = exe.run(main, feed=feed, fetch_list=names,
                                  scope=scope)
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)

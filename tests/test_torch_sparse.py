"""The sparse embedding engine (``paddle_tpu_torch.sparse``, the trainer's
``SparseEmbeddingTrainer``, ``embedding(is_sparse=True)``) on the CPU,
mirroring ``tests/test_sparse.py:24-335`` and ``:412-436`` and held
against the JAX package where a function has a counterpart there: the
bucket ladder, dedup's arrays equal to the reference's, the table's
initial values bit for bit, the lookup, the padding row's gradient exactly
0 under an ``inf`` cotangent, ``segment_rows``, the row-touched apply
bitwise equal to the dense apply (SGD, Adagrad, Adam), the sentinel rows
(a tail slot, ``padding_idx``, an id at or past V and one below 0) pinned
against JAX's clip and drop, the graph path with its one warning, the
``SparseFeeder`` staging, one capture per rung on a zipfian stream, the
trainer bitwise equal to the port's dense arm and within rtol 1e-5 of the
JAX trainer's losses, ``count_dense_materializations`` 0 and > 0, and
``describe()``."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.sparse import (RowTouchedOptimizer,
                                     ShardedEmbeddingTable, SparseFeeder,
                                     bucket_for, bucket_ladder,
                                     count_dense_materializations,
                                     segment_rows, sparse_lookup)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run (the suite's workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_scratch_row(x):
    """``x`` [V, D] with a zero scratch row appended: the ``[V + 1, D]``
    storage layout that ``RowTouchedOptimizer.apply_rows`` updates."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def _table(vocabs=(11, 7), dim=3, **kw):
    kw.setdefault("max_ids_per_batch", 64)
    return ShardedEmbeddingTable(list(vocabs), dim, seed=5, device="cpu",
                                 **kw)


def _jtable(vocabs=(11, 7), dim=3, **kw):
    from paddle_tpu.sparse import ShardedEmbeddingTable as J

    kw.setdefault("max_ids_per_batch", 64)
    return J(list(vocabs), dim, seed=5, **kw)


def test_bucket_ladder_and_bucket_for():
    ladder = bucket_ladder(300, min_bucket=64)
    assert ladder == (64, 128, 256, 512)
    assert bucket_for(1, ladder) == 64
    assert bucket_for(64, ladder) == 64
    assert bucket_for(65, ladder) == 128
    assert bucket_for(512, ladder) == 512
    with pytest.raises(ValueError):
        bucket_for(513, ladder)
    from paddle_tpu.sparse import bucket_ladder as jladder

    for n, mb in ((1, 64), (300, 64), (5000, 16), (7, 3)):
        assert bucket_ladder(n, mb) == jladder(n, mb)


def test_dedup_offsets_mask_and_inverse():
    tab = _table(vocabs=(11, 7), padding_idx=0)
    ids = np.array([[3, 2], [3, 5], [0, 2]], dtype=np.int64)
    db = tab.dedup(ids)
    gids = tab.global_ids(ids)
    assert gids.shape == ids.shape and gids[0, 1] == 2 + 11
    assert np.all(np.where(db.uids[db.inv] == tab.vocab, 0,
                           db.uids[db.inv]) == gids)
    assert db.mask[2, 0] == 0.0 and db.mask.sum() == 5.0
    assert db.bucket in tab.ladder and db.bucket >= db.n_unique
    assert np.all(db.uids[db.n_unique:] == tab.vocab)
    assert not np.any(db.uids == 0)


@pytest.mark.parametrize("pad", [None, 0, 13])
def test_dedup_arrays_and_init_equal_the_reference(pad):
    rng = np.random.RandomState(1)
    tab, jtab = _table(padding_idx=pad), _jtable(padding_idx=pad)
    np.testing.assert_array_equal(tab.value.numpy(), np.asarray(jtab.value))
    for _ in range(3):
        ids = np.stack([rng.randint(0, 11, 20), rng.randint(0, 7, 20)], 1)
        a, b = tab.dedup(ids), jtab.dedup(ids)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype


def test_lookup_matches_dense_masks_padding_and_the_reference():
    tab, jtab = _table(padding_idx=0), _jtable(padding_idx=0)
    ids = np.array([[3, 2], [0, 5]], dtype=np.int64)
    out = tab.lookup(ids).numpy()
    host = tab.value.numpy()
    gids = tab.global_ids(ids)
    assert np.array_equal(out[0, 0], host[3])
    assert np.array_equal(out[1, 1], host[gids[1, 1]])
    assert np.all(out[1, 0] == 0.0)
    np.testing.assert_array_equal(out, np.asarray(jtab.lookup(ids)))


def test_sparse_lookup_grad_drops_padding_row_even_under_inf():
    tab = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ids = torch.tensor([1, 0, 1], dtype=torch.int32)
    t = tab.clone().requires_grad_(True)
    g, = torch.autograd.grad(sparse_lookup(t, ids, 0, 6).sum(), [t])
    assert torch.equal(g[0], torch.zeros(2))
    assert torch.equal(g[1], torch.full((2,), 2.0))
    t = tab.clone().requires_grad_(True)
    out = sparse_lookup(t, ids, 0, 6)
    cot = torch.tensor([[1.0], [float("inf")], [1.0]])
    g, = torch.autograd.grad((out * cot).sum(), [t])
    assert torch.isfinite(g).all() and torch.equal(g[0], torch.zeros(2))


def test_sparse_lookup_against_jax_clip_and_drop():
    """Ids below 0, at or past V, padding and duplicates: the forward is
    JAX's clipped gather (masked at padding), the gradient JAX's dropped
    scatter-add (an id in [-V, 0) wraps once), bitwise."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.sparse import sparse_lookup as jlookup

    rng = np.random.RandomState(2)
    tab = rng.randn(6, 3).astype(np.float32)
    ids = np.array([1, 0, 1, -1, -6, -7, 6, 9, 5], np.int32)
    cot = rng.randn(len(ids), 3).astype(np.float32)
    for pad in (None, 0, 5):
        want, vjp = jax.vjp(lambda t: jlookup(t, jnp.asarray(ids), pad, 6),
                            jnp.asarray(tab))
        wgrad, = vjp(jnp.asarray(cot))
        t = torch.from_numpy(tab).requires_grad_(True)
        got = sparse_lookup(t, torch.from_numpy(ids), pad, 6)
        g, = torch.autograd.grad(got, [t], torch.from_numpy(cot))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(g.numpy(), np.asarray(wgrad), rtol=0,
                                   atol=1e-6)


def test_segment_rows_sums_duplicates():
    cot = np.array([[1.0, 2.0], [10.0, 20.0], [100.0, 200.0]],
                   dtype=np.float32)
    inv = np.array([1, 1, 0], dtype=np.int32)
    seg = segment_rows(torch.from_numpy(cot), torch.from_numpy(inv), 4)
    assert np.array_equal(seg[0], [100.0, 200.0])
    assert np.array_equal(seg[1], [11.0, 22.0])
    assert (seg[2:] == 0.0).all()
    from paddle_tpu.sparse import segment_rows as jseg

    rng = np.random.RandomState(3)
    cot = rng.randn(40, 5).astype(np.float32)
    inv = rng.randint(0, 9, 40).astype(np.int32)
    np.testing.assert_allclose(segment_rows(cot, inv, 16).numpy(),
                               np.asarray(jseg(cot, inv, 16)), rtol=0,
                               atol=1e-6)


OPTS = {"sgd": lambda m: m.SGD(0.1), "adagrad": lambda m: m.Adagrad(0.1),
        "adam": lambda m: m.Adam(0.01)}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_row_touched_apply_bitexact_vs_dense(name):
    """The pin: the touched rows, the optimizer's own ``_update`` on them
    and the scatter back are bitwise the full dense apply on those rows,
    slots too, over 3 steps; every untouched row is bitwise frozen."""
    rng = np.random.RandomState(0)
    V, D = 13, 4
    value = torch.from_numpy(rng.randn(V, D).astype(np.float32))
    touched = torch.tensor([2, 5, 7])
    row_grad = torch.from_numpy(rng.randn(3, D).astype(np.float32))
    dense_grad = torch.zeros(V, D)
    dense_grad[touched] = row_grad
    opt = OPTS[name](topt)
    row_opt = RowTouchedOptimizer(opt)
    storage = with_scratch_row(value)
    slots = {k: torch.zeros(V + 1, D) for k in row_opt.slot_names}
    lr = torch.tensor(float(opt._lr_value(0)))
    t = torch.tensor(1.0)
    untouched = np.setdiff1d(np.arange(V), touched.numpy())
    for _ in range(3):
        dv, dslots = opt._update(storage[:V].clone(), dense_grad,
                                 {k: v[:V].clone() for k, v in slots.items()},
                                 lr, t)
        before = storage[:V].clone()
        row_opt.apply_rows(storage, slots, touched, row_grad, lr, t)
        assert torch.equal(storage[touched], dv[touched])
        assert torch.equal(storage[untouched], before[untouched])
        for k in row_opt.slot_names:
            assert torch.equal(slots[k][touched], dslots[k][touched])
        t = t + 1


@pytest.mark.parametrize("name", sorted(OPTS))
def test_row_touched_apply_against_jax(name):
    """The same apply in the JAX package, over uids holding the sentinel
    (a tail slot), an id past V and ids below 0: the same rows move, the
    same rows stay (JAX drops what the port sends to the scratch row)."""
    import jax.numpy as jnp
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.sparse import RowTouchedOptimizer as JRow

    rng = np.random.RandomState(4)
    V, D = 9, 3
    value = rng.randn(V, D).astype(np.float32)
    uids = np.array([1, 4, -2, -12, 9, 9, 15, 0], np.int32)
    grad = rng.randn(len(uids), D).astype(np.float32)
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    jr, tr = JRow(jo), RowTouchedOptimizer(to)
    jv, js = jr.apply_rows(jnp.asarray(value),
                           {k: jnp.zeros((V, D)) for k in jr.slot_names},
                           jnp.asarray(uids), jnp.asarray(grad),
                           np.float32(jo._lr_value(0)), np.float32(1))
    storage = with_scratch_row(torch.from_numpy(value))
    slots = {k: torch.zeros(V + 1, D) for k in tr.slot_names}
    tr.apply_rows(storage, slots, torch.from_numpy(uids),
                  torch.from_numpy(grad), torch.tensor(float(to._lr_value(0))),
                  torch.tensor(1.0))
    np.testing.assert_allclose(storage[:V].numpy(), np.asarray(jv), rtol=0,
                               atol=1e-6)
    moved = np.flatnonzero((storage[:V].numpy() != value).any(1))
    assert moved.tolist() == [0, 1, 4, 7]        # 0, 1, 4 and -2 -> 7
    for k in tr.slot_names:
        np.testing.assert_allclose(slots[k][:V].numpy(), np.asarray(js[k]),
                                   rtol=0, atol=1e-6)


def test_apply_rows_oob_sentinel_rows_dropped():
    opt = topt.SGD(1.0)
    row_opt = RowTouchedOptimizer(opt)
    value = torch.ones(4, 2)
    storage = with_scratch_row(value)
    uids = torch.tensor([1, 4, 4], dtype=torch.int32)   # 4 == vocab
    row_opt.apply_rows(storage, {}, uids, torch.ones(3, 2),
                       torch.tensor(1.0), torch.tensor(1.0))
    assert torch.equal(storage[1], torch.zeros(2))
    rest = [0, 2, 3]
    assert torch.equal(storage[rest], value[rest])


def test_padding_idx_row_frozen_through_dedup_and_apply():
    """A batch holding ``padding_idx``: its uid is the sentinel, so the
    apply never writes the padding row, as in the JAX package."""
    tab = _table(vocabs=(11, 7), padding_idx=3)
    ids = np.array([[3, 2], [3, 5], [1, 2]], np.int64)
    db = tab.dedup(ids)
    assert 3 not in db.uids.tolist()
    row_opt = RowTouchedOptimizer(topt.SGD(1.0))
    before = tab.value.clone()
    row_opt.apply_rows(tab.storage, {}, torch.from_numpy(db.uids),
                       torch.ones(db.bucket, 3), torch.tensor(1.0),
                       torch.tensor(1.0))
    assert torch.equal(tab.value[3], before[3])
    live = [1, 2 + 11, 5 + 11]
    assert (tab.value[live] != before[live]).all()


def test_embedding_is_sparse_graph_path_matches_dense():
    import paddle_tpu_torch.layers.nn as nn

    nn._sparse_fallback_warned = False
    tfluid.reset_default_programs()
    ids = tfluid.layers.data("ids", [1], dtype="int32")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        emb_s = tfluid.layers.embedding(
            ids, [10, 4], is_sparse=True, padding_idx=0,
            param_attr=tfluid.ParamAttr(name="w_d"))
        tfluid.layers.embedding(ids, [10, 4], is_sparse=True,
                                param_attr=tfluid.ParamAttr(name="w2"))
    assert sum("is_sparse" in str(x.message) for x in w) == 1
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    idv = np.array([[1], [0], [3]], dtype="int32")
    sparse, = exe.run(feed={"ids": idv}, fetch_list=[emb_s], scope=scope)
    table = scope.find_var("w_d").numpy()
    expected = table[[1, 0, 3]].copy()
    expected[1] = 0.0
    np.testing.assert_array_equal(sparse, expected)


def test_embedding_is_sparse_graph_grad_drops_padding_row():
    tfluid.reset_default_programs()
    ids = tfluid.layers.data("ids", [1], dtype="int32")
    emb = tfluid.layers.embedding(ids, [6, 3], is_sparse=True, padding_idx=0,
                                  param_attr=tfluid.ParamAttr(name="w_s"))
    loss = tfluid.layers.mean(emb)
    topt.SGD(1.0).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    before = scope.find_var("w_s").clone()
    exe.run(feed={"ids": np.array([[1], [0], [1]], dtype="int32")},
            fetch_list=[loss], scope=scope)
    after = scope.find_var("w_s")
    assert torch.equal(after[0], before[0])
    assert not torch.equal(after[1], before[1])
    assert torch.equal(after[2:], before[2:])


def test_embedding_is_sparse_against_jax_and_dense():
    """``embedding(is_sparse=True)`` in both packages on the same table and
    ids (a padding id among them): the output and the table's gradient
    within 1e-6 of JAX's; without padding the sparse path's output and
    gradient are bitwise the dense path's."""
    from test_torch_sequence_ops import run_both

    rng = np.random.RandomState(5)
    feeds = {"i": rng.randint(0, 10, (12, 1)).astype(np.int32)}
    for pad in (None, 3):
        want, got, jg, tg, names = run_both(
            lambda fl, v: fl.layers.embedding(
                v["i"], [10, 4], is_sparse=True, padding_idx=pad,
                param_attr=fl.ParamAttr(name="emb")), feeds, seed=1)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(tg[0], jg[0], rtol=0, atol=1e-6)
        if pad is None:
            _, dgot, _, dtg, _ = run_both(
                lambda fl, v: fl.layers.embedding(
                    v["i"], [10, 4], param_attr=fl.ParamAttr(name="emb")),
                feeds, seed=1)
            np.testing.assert_array_equal(got[0], dgot[0])
            np.testing.assert_array_equal(tg[0], dtg[0])


def test_sparse_feeder_stages_dedup_fields():
    tab = _table(vocabs=(11, 7), padding_idx=0)
    feeds = [{"sparse": np.array([[1, 2], [3, 2]], np.int64),
              "dense": np.ones((2, 3), np.float32)} for _ in range(3)]
    feeder = SparseFeeder(lambda: iter(feeds), {"sparse": tab})
    got = list(feeder)
    assert len(got) == 3 and len(feeder.dedup_ms) == 3
    assert len(feeder.stall_ms) == 4             # 3 batches and the end
    f = got[0]
    for suffix in ("__uids", "__inv", "__mask", "__nuniq"):
        assert isinstance(f["sparse" + suffix], torch.Tensor)
    assert int(f["sparse__nuniq"][0]) == 3
    assert f["sparse__uids"].shape[0] in tab.ladder
    assert f["sparse__uids"].device.type == "cpu"
    db = tab.dedup(feeds[0]["sparse"])
    np.testing.assert_array_equal(f["sparse__inv"].numpy(), db.inv)


def test_sparse_feeder_missing_field_raises():
    tab = _table()
    feeder = SparseFeeder(lambda: iter([{"dense": np.ones((1, 2))}]),
                          {"sparse": tab})
    with pytest.raises(KeyError, match="missing sparse field 'sparse'"):
        list(feeder)


def test_device_feeder_stop_intake_and_close():
    """``stop_intake`` drains what is staged; ``close`` abandons the
    stream; an abandoned iterator lets the producer stop."""
    from paddle_tpu_torch import DeviceFeeder

    feeds = [{"x": np.full((2,), i, np.float32)} for i in range(20)]
    feeder = DeviceFeeder(lambda: iter(feeds), depth=2, device="cpu")
    it = iter(feeder)
    first = next(it)
    assert float(first["x"][0]) == 0.0
    feeder.stop_intake()
    rest = list(it)
    assert 1 <= len(rest) <= 3                   # the staged tail only
    assert iter(feeder) is it
    # sharding takes a Strategy (DeviceFeeder(sharding=strategy): a rank
    # uploads its part; tests/test_torch_strategy_reductions.py holds it
    # on {dp 2}); on a one-rank mesh a batch is the whole feed, marked
    with pytest.raises(TypeError, match="parallel.Strategy"):
        DeviceFeeder(lambda: iter(feeds), sharding="fsdp", device="cpu")
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import parallel

    fluid.reset_default_programs()
    fluid.layers.data("x", [])
    strategy = parallel.Strategy(parallel.make_mesh({"dp": 1}))
    staged = list(DeviceFeeder(lambda: iter(feeds[:3]), sharding=strategy,
                               device="cpu"))
    assert [type(b).__name__ for b in staged] == ["LocalFeed"] * 3
    for b, f in zip(staged, feeds):
        assert b.batch == 2 and b.seq_axis is None
        np.testing.assert_array_equal(b["x"].numpy(), f["x"])
    bad = DeviceFeeder(lambda: (1 / 0 for _ in range(1)), device="cpu")
    with pytest.raises(ZeroDivisionError):
        list(bad)



def test_executor_refuses_a_local_feed_of_another_program():
    """A ``LocalFeed`` that is not the run program's part of the batch is
    refused before the step: one staged by a feeder made for another
    program (its feeds were never sliced: global batch 0), and one whose
    rows are not batch / dp."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.core.types import Place
    from paddle_tpu_torch.data_feeder import DeviceFeeder

    feeds = [{"y": np.ones((4, 3), np.float32)}]
    strategy = parallel.Strategy(parallel.make_mesh({"dp": 1}))
    fluid.reset_default_programs()
    fluid.layers.data("x", [3])
    stale = DeviceFeeder(lambda: iter(feeds), sharding=strategy,
                         device="cpu")
    fluid.reset_default_programs()
    y = fluid.layers.data("y", [3])
    out = fluid.layers.scale(y, 2.0)
    exe = fluid.Executor(Place("cpu"), strategy=strategy)
    staged = list(stale)
    assert staged[0].batch == 0
    with pytest.raises(ValueError, match="another program"):
        exe.run(feed=staged[0], fetch_list=[out])
    wrong = parallel.LocalFeed({"y": torch.ones(4, 3)}, batch=8)
    with pytest.raises(ValueError, match="4 rows"):
        exe.run(feed=wrong, fetch_list=[out])
    right = list(DeviceFeeder(lambda: iter(feeds), sharding=strategy,
                              device="cpu"))[0]
    got, = exe.run(feed=right, fetch_list=[out])
    np.testing.assert_array_equal(got, 2 * feeds[0]["y"])

def test_zipfian_stream_never_recompiles_past_ladder():
    tab = ShardedEmbeddingTable([997], 4, seed=1, max_ids_per_batch=512,
                                min_bucket=16, device="cpu")
    rng = np.random.RandomState(7)
    rungs = set()
    for i in range(100):
        hi = [3, 30, 300, 900][i % 4]
        ids = ((rng.zipf(1.4, 256) - 1) % hi).astype(np.int64)
        rungs.add(tab.dedup(ids).bucket)
        tab.lookup(ids)
    assert tab.traces == len(rungs) > 1


def _trainer_feeds():
    vocabs = [97, 53, 29]
    rng = np.random.RandomState(3)
    feeds = []
    for i in range(12):
        hi = [2, 1000][i % 2]
        feeds.append({
            "sparse": np.stack([rng.randint(0, min(v, hi), 64)
                                for v in vocabs], 1).astype(np.int64),
            "dense": rng.rand(64, 3).astype(np.float32),
            "label": rng.randint(0, 2, 64).astype(np.int64)})
    return vocabs, feeds


def test_trainer_equal_step_parity_and_zero_recompile():
    """``tests/test_sparse.py:195`` mirrored: the trainer's losses bitwise
    the port's dense arm's, its touched rows and slots bitwise the dense
    arm's and its untouched rows their initial values; one capture per
    rung with the guard on "raise"; then the JAX trainer on the same
    stream and init within rtol 1e-5, loss for loss."""
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.tools.ctr_sparse import DenseArm, loss_fn

    vocabs, feeds = _trainer_feeds()
    F, emb_dim = len(vocabs), 4
    table = ctr.wide_deep_sparse_table(vocabs, emb_dim, seed=2,
                                       max_ids_per_batch=128, device="cpu")
    init = table.value.clone()
    params = ctr.wide_deep_sparse_params(vocabs, emb_dim, 3, hidden=(8,),
                                         seed=4)
    trainer = tfluid.SparseEmbeddingTrainer(
        table, loss_fn(F, emb_dim), params, topt.Adagrad(0.1),
        recompile_policy="raise")
    losses = trainer.train(lambda: iter(feeds))
    dense = DenseArm(vocabs, emb_dim, params, topt.Adagrad(0.1), 2, "cpu",
                     max_ids_per_batch=128)
    dlosses = [float(dense.step(f)) for f in feeds]
    assert dlosses == losses
    touched = sorted({int(g) for f in feeds
                      for g in table.global_ids(f["sparse"]).reshape(-1)})
    untouched = np.setdiff1d(np.arange(table.vocab), touched)
    assert torch.equal(table.value[touched], dense.value[touched])
    assert torch.equal(trainer.slots["moment"][touched],
                       dense.slots["moment"][touched])
    assert torch.equal(table.value[untouched], init[untouched])
    for k in params:
        assert torch.equal(trainer.params[k], dense.params[k]), k
    rungs = {table.dedup(f["sparse"]).bucket for f in feeds}
    assert len(rungs) > 1 and trainer.traces == len(rungs)

    import jax.numpy as jnp  # noqa: F401  (the JAX package's trainer)
    import paddle_tpu as jfluid
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.models import ctr as jctr

    jtable = jctr.wide_deep_sparse_table(vocabs, emb_dim, seed=2,
                                         max_ids_per_batch=128)
    jtrainer = jfluid.SparseEmbeddingTrainer(
        jtable, lambda r, p, b: jctr.wide_deep_sparse_loss(
            r, p, b, n_fields=F, emb_dim=emb_dim),
        jctr.wide_deep_sparse_params(vocabs, emb_dim, 3, hidden=(8,),
                                     seed=4), jopt.Adagrad(0.1))
    jlosses = jtrainer.train(lambda: iter(feeds))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def test_dense_materializations_zero_for_the_sparse_step():
    """The probe over one step: 0 fresh [V, D] tensors in the sparse
    trainer's step, more than 0 in the dense arm's."""
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.tools.ctr_sparse import DenseArm, loss_fn

    vocabs, feeds = _trainer_feeds()
    F, emb_dim = len(vocabs), 4
    table = ctr.wide_deep_sparse_table(vocabs, emb_dim, seed=2,
                                       max_ids_per_batch=128, device="cpu")
    params = ctr.wide_deep_sparse_params(vocabs, emb_dim, 3, hidden=(8,),
                                         seed=4)
    trainer = tfluid.SparseEmbeddingTrainer(
        table, loss_fn(F, emb_dim), params, topt.Adagrad(0.1))
    db = table.dedup(feeds[0]["sparse"])
    batch = {"dense": torch.from_numpy(feeds[0]["dense"]),
             "label": torch.from_numpy(feeds[0]["label"]),
             "sparse__inv": torch.from_numpy(db.inv),
             "sparse__mask": torch.from_numpy(db.mask)}
    shape = (table.vocab, 1 + emb_dim)
    one, lr = torch.tensor(1.0), torch.tensor(0.1)
    assert count_dense_materializations(
        trainer.step_body, shape, torch.from_numpy(db.uids), lr, one,
        batch) == 0
    dense = DenseArm(vocabs, emb_dim, params, topt.Adagrad(0.1), 2, "cpu")
    gids, dbatch = dense.batch(feeds[0])
    assert count_dense_materializations(dense.step_body, shape, gids,
                                        dbatch, lr, one) > 0


def test_trainer_recompile_guard_raises_on_a_storm():
    """A steady rung that captures again (a new batch shape at a seen
    bucket) is a storm: "raise" raises."""
    from paddle_tpu_torch.compile import RecompileBudgetExceeded
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.tools.ctr_sparse import loss_fn

    vocabs, feeds = _trainer_feeds()
    table = ctr.wide_deep_sparse_table(vocabs, 4, seed=2,
                                       max_ids_per_batch=128, device="cpu")
    trainer = tfluid.SparseEmbeddingTrainer(
        table, loss_fn(3, 4),
        ctr.wide_deep_sparse_params(vocabs, 4, 3, hidden=(8,), seed=4),
        topt.SGD(0.1), recompile_policy="raise")
    f = feeds[0]
    trainer.train(lambda: iter([f]))
    half = {k: v[:32] for k, v in f.items()}
    assert table.dedup(half["sparse"]).bucket == table.dedup(
        f["sparse"]).bucket
    with pytest.raises(RecompileBudgetExceeded):
        trainer.train(lambda: iter([half]))


def test_table_describe_is_the_reference_string():
    tab, jtab = _table(padding_idx=0), _jtable(padding_idx=0)
    assert tab.describe() == jtab.describe()
    import json

    d = json.loads(tab.describe())
    assert d["vocab"] == 18 and tuple(d["ladder"]) == tab.ladder
    # a mesh is a ServingMesh (the sharded table: tests/
    # test_torch_serving_mesh.py); a one-device mesh describes as the
    # reference's one-chip degradation
    with pytest.raises(TypeError, match="ServingMesh"):
        ShardedEmbeddingTable(8, 2, mesh=object(), device="cpu")
    import jax

    from paddle_tpu.serving import make_serving_mesh as jmake
    from paddle_tpu.sparse import ShardedEmbeddingTable as JTable
    from paddle_tpu_torch.serving import make_serving_mesh

    one = ShardedEmbeddingTable(8, 2, mesh=make_serving_mesh("fsdp=2"),
                                device="cpu")
    jone = JTable(8, 2, mesh=jmake("fsdp=2", devices=jax.devices()[:1]))
    assert one.describe() == jone.describe()


def test_sparse_exports_the_reference_all():
    import paddle_tpu.sparse as jsparse
    import paddle_tpu_torch.sparse as tsparse

    assert sorted(tsparse.__all__) == sorted(jsparse.__all__)
    for name in tsparse.__all__:
        assert hasattr(tsparse, name)

"""The port's mesh, collectives and tensor parallelism, held against the JAX
package: ``make_mesh`` grids, ``-1`` and errors on their own; then one gang
of 4 CPU ranks over gloo (the ``gang`` fixture) runs the collectives of
``parallel/comm.py``, the column / row-parallel Megatron block and the
vocab-parallel embedding (against the JAX package's Strategy on the
conftest's 8-device CPU mesh, from the same numpy weights and feeds),
and the Transformer LM's tensor-parallel head and vocab-parallel cross
entropy at tp = 2 and tp = 4 (loss, logits and the ``tok_emb`` gradient
against the JAX package's single-device step); ops along a tp-sharded dim
on {dp 2, tp 2} and on {tp 2} alone, and the LM's next-token accuracy and
``Accuracy`` evaluator over its vocab-sharded head on {dp 2, tp 2}
(exactly JAX's).  Limits: losses and values within rtol 1e-5, weights
within 1e-5 and gradients within 1e-4 of their max abs."""
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
from paddle_tpu import parallel as jpar
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import distributed, parallel as tpar
from paddle_tpu_torch.tools import parallel_cases as pc

RANKS = 4


def jax_run(build, feeds, fetch=(), mesh=None, data_axis="dp", init=None,
            state=(), kw=None, step_counter=None):
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    out = pc.BUILDERS[build](jfluid, jpar, **(kw or {}))
    loss = out[0] if isinstance(out, tuple) else out
    strategy = None
    if mesh is not None:
        n = math.prod(mesh.values())
        strategy = jpar.Strategy(jpar.make_mesh(mesh,
                                                devices=jax.devices()[:n]),
                                 data_axis=data_axis)
    exe = jfluid.Executor(strategy=strategy)
    exe.run(jfluid.default_startup_program())
    scope = jfluid.global_scope()
    if init is None:
        init = {n: np.asarray(v) for n, v in scope.items()}
    else:
        for n, a in init.items():
            scope.set_var(n, jnp.asarray(a))
    if step_counter is not None:
        scope.step_counter = step_counter
    names = [loss.name] + pc.fetch_names(out, fetch)
    steps = [[np.asarray(v) for v in exe.run(feed=f, fetch_list=names)]
             for f in feeds]
    return init, steps, {n: np.asarray(scope.find_var(n)) for n in state}


# ------------------------------------------------------------ the mesh


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": -1}, {"dp": 2, "sp": 2,
                                                        "tp": 2},
                                  {"tp": 8}, {"dp": -1, "tp": 4}])
def test_make_mesh_grid_matches_jax(axes):
    jm = jpar.make_mesh(axes)
    tm = tpar.make_mesh(axes, devices=list(range(8)))
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(tm.devices, ids)
    for a in tm.axis_names:
        assert tpar.mesh_axis_size(tm, a) == jpar.mesh_axis_size(jm, a)
    assert tpar.mesh_axis_size(tm, "missing") == 1
    assert tpar.mesh_axis_size(None, "dp") == 1


@pytest.mark.parametrize("axes,match", [
    ({"dp": -1, "tp": -1}, "only one mesh axis may be -1"),
    ({"dp": 3, "tp": -1}, "not divisible by the product"),
    ({"dp": 4, "tp": 4}, "needs 16 devices but only 8")])
def test_make_mesh_errors_match_jax(axes, match):
    with pytest.raises(ValueError, match=match):
        jpar.make_mesh(axes)
    with pytest.raises(ValueError, match=match):
        tpar.make_mesh(axes, devices=list(range(8)))


def test_sub_mesh_warns_and_leaves_ranks_idle(capfd):
    m = tpar.make_mesh({"dp": 2}, devices=list(range(8)))
    assert "uses 2 of 8 available devices" in capfd.readouterr().err
    assert m.size == 2 and m.in_mesh     # rank 0 of a process alone
    outside = tpar.Mesh(np.arange(2).reshape(2), ("dp",), rank=5)
    assert not outside.in_mesh


def test_tp_helper_does_not_mutate_shared_attr():
    tfluid.reset_default_programs()
    x = tfluid.layers.data("x", [4])
    shared = tfluid.ParamAttr(name="shared_w")
    out = tpar.tp.column_parallel_fc(x, 8, param_attr=shared)
    assert shared.sharding is None
    w = tfluid.default_main_program().global_block.var("shared_w")
    assert tuple(w.sharding) == (None, "tp")
    assert tuple(out.sharding) == (None, "tp")


def test_sharded_attrs_build_without_a_mesh():
    """ParamAttr(sharding=...), build_lm(use_tp, use_sp) and
    Executor(strategy=...) no longer raise; one device runs them plain."""
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    loss, logits = pc.build_lm(tfluid, tpar, use_tp=True, use_sp=True,
                               sp_strategy="ulysses")
    assert tuple(logits.sharding) == (None, "sp", "tp")
    assert isinstance(logits.sharding[1], tpar.SeqAxis)
    emb = tfluid.default_main_program().global_block.var("tok_emb")
    assert tuple(emb.sharding) == ("tp", None)
    rng = np.random.RandomState(0)
    T = pc.TINY_LM["max_len"]
    feed = {"toks": rng.randint(0, 64, (2, T)).astype("int32"),
            "labs": rng.randint(0, 64, (2, T, 1)).astype("int32")}
    startup = tfluid.default_startup_program()
    # a mesh without the tp axis the parameters name is refused
    lacking = tfluid.Executor(tfluid.CPUPlace(), strategy=tpar.Strategy(
        tpar.make_mesh({"dp": 1})))
    with pytest.raises(ValueError, match="lacks"):
        lacking.run(startup)
    mesh = tpar.make_mesh({"dp": 1, "sp": 1, "tp": 1})
    exe = tfluid.Executor(tfluid.CPUPlace(), strategy=tpar.Strategy(mesh))
    exe.run(startup)
    out, = exe.run(feed=feed, fetch_list=[loss])
    assert np.isfinite(out).all()
    with pytest.raises(tfluid.core.graphs.WarmError, match="A.9 part 3"):
        exe.warm(tfluid.default_main_program(),
                 [("toks", (2, T), "int32"), ("labs", (2, T, 1), "int32")],
                 [loss])


@pytest.mark.parametrize("striped", [False, True])
def test_sequence_sharding_rides_the_specs(striped):
    """build_lm(use_sp) marks its feeds with a SeqAxis on dim 1 and every
    activation made from them carries it (through fc, attention, the
    recompute block, the head, the loss's input); a batch-major variable
    that is not made from them is not a sequence slice, even where its
    dim 1 equals T, and a transpose moves the entry with its dim."""
    from paddle_tpu_torch.param_attr import seq_axis_of

    tfluid.reset_default_programs()
    T = pc.TINY_LM["max_len"]
    toks = tfluid.layers.data("toks", [T], dtype="int32")
    labs = tfluid.layers.data("labs", [T, 1], dtype="int32")
    loss, logits = tfluid.models.transformer.build_lm(
        toks, labs, use_tp=True, use_sp=True,
        sp_strategy="ring_striped" if striped else "ring", dropout=0.1,
        remat=True, **pc.TINY_LM)
    block = tfluid.default_main_program().global_block
    rec = [op for op in block.ops if op.type == "recompute"]
    assert rec and all(seq_axis_of(v) is not None for op in rec
                       for v in map(block.var, op.outputs["Out"]))
    inner = [op for r in rec for op in r.sub_block.ops]
    seq = seq_axis_of(toks)
    assert seq == "sp" and seq.striped == striped
    assert seq_axis_of(block.var("labs")) is seq
    assert seq_axis_of(logits) is seq
    for blk in [block] + [r.sub_block for r in rec]:
        for op in blk.ops:
            if op.type in ("attention", "dropout", "layer_norm", "recompute",
                           "elementwise_add", "softmax_with_cross_entropy"):
                for n in op.outputs["Out"]:
                    v = blk.var(n) if blk.has_var(n) else block.var(n)
                    assert seq_axis_of(v) is seq, (op.type, n)
    assert {"attention", "dropout", "layer_norm"} <= {op.type
                                                      for op in inner}
    mean_in = [op for op in block.ops if op.type == "mean"][0]
    assert seq_axis_of(block.var(mean_in.inputs["X"][0])) is seq
    other = tfluid.layers.data("other", [T, T])
    h = tfluid.layers.elementwise_add(other, other)
    assert seq_axis_of(h) is None
    x = tfluid.layers.data("x", [T, 2, 4])
    x.sharding = tpar.P(None, seq)
    y = tfluid.layers.transpose(x, [0, 2, 1, 3])
    assert tuple(y.sharding) == (None, None, "sp", None)
    assert seq_axis_of(y) is None
    assert seq_axis_of(tfluid.layers.transpose(y, [0, 2, 1, 3])) is seq
    # attention refuses a sequence slice it was not told to ring
    with pytest.raises(ValueError, match="use_sp=True"):
        tfluid.models.transformer.attention_core(x, x, x, True, 2, False)
    with pytest.raises(ValueError, match="layout"):
        tfluid.models.transformer.attention_core(
            x, x, x, True, 2, True,
            "ring" if striped else "ring_striped")


def test_distributed_single_process_and_dispatcher():
    assert distributed.init() == (1, 0)
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    mesh = tpar.make_mesh({"dp": 1})
    batch = np.arange(12).reshape(6, 2)
    assert np.array_equal(distributed.global_batch_array(batch, mesh), batch)
    # one process: the dispatcher hands out the whole file list
    q = distributed.make_file_dispatcher(["a", "b"])
    assert sorted(q.payloads()) == ["a", "b"]
    assert q.get() == ("shard-00000", "a")


# ------------------------------------------------------------ the gang


def _lm_feed(seed=3, n=4):
    rng = np.random.RandomState(seed)
    V, T = pc.TINY_LM["vocab_size"], pc.TINY_LM["max_len"]
    return {"toks": rng.randint(0, V, (n, T)).astype(np.int32),
            "labs": rng.randint(0, V, (n, T, 1)).astype(np.int32)}


LM_MESHES = {"lm_tp2": {"dp": 2, "tp": 2}, "lm_tp4": {"tp": 4},
             "lm_tp2_untied": {"dp": 2, "tp": 2}}
# dropout on a tp shard (the one-level counter map under {dp 2, tp 2}, the
# two-level one inside a sequence slice under {sp 2, tp 2}) and the
# soft-label vocab-parallel cross entropy with its softmax
TP_EXTRAS = {"tp_extras_dp2_tp2": {"dp": 2, "tp": 2},
             "tp_extras_sp2_tp2": {"sp": 2, "tp": 2}}
TP_FETCH = ["$1", "$2", "tx.c.w@GRAD", "tx.r.w@GRAD", "tx.o.w@GRAD"]
TM_FETCH = ["$1", "$2", "tm.w@GRAD", "tm.b@GRAD"]
LM_FETCH = ["$1", "$2", "$3", "$4"]


@pytest.fixture(scope="module")
def gang():
    """JAX references and every rank's results (each holds the whole of
    every fetch), by case.  The weights come from the JAX package's
    startup programs first; then the gang runs while this process computes
    the JAX references."""
    specs, jobs = {}, {}
    specs["collectives"] = dict(kind="collectives", mesh={"a": 2, "b": 2})

    rng = np.random.RandomState(1)
    feeds = [{"x": rng.rand(8, 12).astype("float32"),
              "y": rng.randint(0, 4, (8, 1)).astype("int32")}] * 8
    wnames = ["col.w", "col.b", "row.w", "row.b", "out.w", "out.b"]
    init = jax_run("megatron", [])[0]
    specs["megatron"] = dict(kind="program", build="megatron", init=init,
                             feeds=feeds, mesh={"dp": 2, "tp": 2},
                             state=wnames)
    jobs["megatron"] = lambda init=init, feeds=feeds: dict(zip(
        ("steps", "state"), jax_run("megatron", feeds,
                                    mesh={"dp": 2, "tp": 2}, init=init,
                                    state=wnames)[1:]))

    rng = np.random.RandomState(2)
    feeds = [{"ids": rng.randint(0, 64, (8, 1)).astype("int32"),
              "y": rng.randint(0, 4, (8, 1)).astype("int32")}] * 6
    init = jax_run("vocab", [])[0]
    specs["vocab"] = dict(kind="program", build="vocab", init=init,
                          feeds=feeds, mesh={"tp": RANKS}, data_axis=None,
                          state=["table", "head.w"])
    jobs["vocab"] = lambda init=init, feeds=feeds: dict(zip(
        ("steps", "state"), jax_run("vocab", feeds, mesh={"tp": RANKS},
                                    data_axis=None, init=init,
                                    state=["table", "head.w"])[1:]))

    feed = _lm_feed()
    fetch = ["$1", "tok_emb@GRAD", "blk0.q.w@GRAD", "blk1.ff2.w@GRAD"]
    for tied in (True, False):
        kw = {"use_tp": True}
        if not tied:
            kw["cfg"] = dict(pc.TINY_LM, tie_embeddings=False)
        init = jax_run("lm", [], kw=kw)[0]
        for case in LM_MESHES:
            if case.endswith("untied") != (not tied):
                continue
            specs[case] = dict(kind="program", build="lm", kw=kw,
                               init=init, feeds=[feed], fetch=fetch,
                               mesh=LM_MESHES[case])
        jobs["lm_tied" if tied else "lm_untied"] = \
            lambda init=init, kw=kw: {"steps": jax_run(
                "lm", [feed], fetch=fetch, kw=kw, init=init)[1]}

    rng = np.random.RandomState(4)
    feeds = [{"x": rng.randn(4, 8, 12).astype("float32"),
              "soft": rng.rand(4, 8, 8).astype("float32")}] * 2
    init = jax_run("tp_extras", [])[0]
    for case, mesh in TP_EXTRAS.items():
        specs[case] = dict(kind="program", build="tp_extras", init=init,
                           feeds=feeds, fetch=TP_FETCH, mesh=mesh,
                           step_counter=5)
    jobs["tp_extras"] = lambda init=init, feeds=feeds: {"steps": jax_run(
        "tp_extras", feeds, fetch=TP_FETCH, init=init, step_counter=5)[1]}

    rng = np.random.RandomState(5)
    feeds = [{"x": rng.randn(8, 12).astype("float32")}] * 2
    init = jax_run("tp_mixing", [])[0]
    specs["tp_mixing"] = dict(kind="program", build="tp_mixing", init=init,
                              feeds=feeds, fetch=TM_FETCH,
                              mesh={"dp": 2, "tp": 2})
    specs["tp_mixing_tp2"] = dict(specs["tp_mixing"], mesh={"tp": 2})
    jobs["tp_mixing"] = lambda init=init, feeds=feeds: {"steps": jax_run(
        "tp_mixing", feeds, fetch=TM_FETCH, init=init)[1]}

    kw = {"use_tp": True}
    init = jax_run("lm_metrics", [], kw=kw)[0]
    feeds = [_lm_feed(6), _lm_feed(7)]
    specs["lm_metrics_tp"] = dict(kind="program", build="lm_metrics", kw=kw,
                                  init=init, feeds=feeds, fetch=LM_FETCH,
                                  mesh={"dp": 2, "tp": 2})
    jobs["lm_metrics_tp"] = lambda init=init, feeds=feeds: {
        "steps": jax_run("lm_metrics", feeds, fetch=LM_FETCH, kw=kw,
                         init=init)[1]}

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(distributed.spawn, pc.run_cases, RANKS, specs,
                          True, device="cpu", timeout_s=300)
        refs = {case: job() for case, job in jobs.items()}
        got = fut.result()
    for case in LM_MESHES:
        refs[case] = refs["lm_untied" if case.endswith("untied")
                          else "lm_tied"]
    for case in TP_EXTRAS:
        refs[case] = refs["tp_extras"]
    return refs, got


def test_collectives_on_mesh_slices(gang):
    """all_reduce (sum, max), all_gather, reduce_scatter, all_to_all and
    ring_shift on each axis's slices of a 2 x 2 mesh of ranks, each rank's
    result against the definitions over its slice's inputs."""
    _, got = gang
    xs = {r: np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * r
          for r in range(RANKS)}
    for res in got:
        for axis, out in res["collectives"]["by_axis"].items():
            ranks = out["ranks"]
            me = ranks.index(res["collectives"]["rank"])
            n = len(ranks)
            mine = [xs[r] for r in ranks]
            assert np.array_equal(out["sum"], sum(mine))
            assert np.array_equal(out["max"], np.maximum.reduce(mine))
            assert np.array_equal(out["gather1"], np.concatenate(mine, 1))
            assert np.array_equal(out["scatter0"],
                                  np.split(sum(mine), n, 0)[me])
            assert np.array_equal(out["a2a"], np.concatenate(
                [np.split(x, n, 0)[me] for x in mine], 1))
            assert np.array_equal(out["shift"], mine[(me - 1) % n])


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(np.asarray(got, np.float64) - want).max() <= tol * scale


def test_megatron_block_matches_jax_strategy(gang):
    refs, got = gang
    r, g = refs["megatron"], got[0]["megatron"]
    np.testing.assert_allclose([s[0] for s in g["steps"]],
                               [s[0] for s in r["steps"]], rtol=1e-5)
    assert g["steps"][-1][0] < g["steps"][0][0]
    for n, w in r["state"].items():
        _close(g["state"][n], w, 1e-5)


def test_vocab_parallel_embedding_matches_jax_strategy(gang):
    refs, got = gang
    r, g = refs["vocab"], got[0]["vocab"]
    np.testing.assert_allclose([s[0] for s in g["steps"]],
                               [s[0] for s in r["steps"]], rtol=1e-5)
    for n, w in r["state"].items():
        _close(g["state"][n], w, 1e-5)


@pytest.mark.parametrize("case", sorted(LM_MESHES))
def test_lm_tensor_parallel_head_matches_jax_single_device(gang, case):
    """The loss, the logits gathered to the full vocabulary and the
    (clipped) gradients of the tied embedding and two block weights, on
    every rank, against the JAX package's unsharded step."""
    refs, got = gang
    want = refs[case]["steps"][0]
    for res in got:
        g = res[case]["steps"][0]
        np.testing.assert_allclose(g[0], want[0], rtol=1e-5)
        _close(g[1], want[1], 1e-5)          # logits
        for gg, ww in zip(g[2:], want[2:]):  # gradients
            _close(gg, ww, 1e-4)


@pytest.mark.parametrize("case", sorted(TP_EXTRAS))
def test_tp_dropout_and_soft_label_vocab_loss_match_jax(gang, case):
    """Two SGD steps at step counter 5 on every rank against the JAX
    package's unsharded steps: the dropout mask on the tensor-parallel
    shard bitwise (its values within 1e-5 of max abs), the loss (rtol
    1e-5), the softmax gathered whole (1e-5 of max abs) and the
    gradients of the three tensor-parallel weights (1e-5 of max abs)."""
    refs, got = gang
    for res in got:
        for g, w in zip(res[case]["steps"], refs[case]["steps"]):
            np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
            assert np.array_equal(g[1] == 0, w[1] == 0), "dropout mask"
            assert 0 < (w[1] == 0).mean() < 1
            for gg, ww in zip(g[1:], w[1:]):
                _close(gg, ww, 1e-5)


def test_ops_along_a_tp_sharded_dim_match_jax(gang):
    """``softmax`` along, and ``reduce_sum`` over, the last dim of a
    column-parallel output on {dp 2, tp 2}: the Strategy's carrier
    gathers that dim over tp (and the rows over dp), so every rank gets
    JAX's whole-tensor values; two SGD steps against the JAX package's
    unsharded ones (loss rtol 1e-5; the softmax, the sum and the
    gradients of the sharded weight and bias within 1e-5 of max abs)."""
    refs, got = gang
    for res in got:
        for g, w in zip(res["tp_mixing"]["steps"],
                        refs["tp_mixing"]["steps"]):
            np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
            for gg, ww in zip(g[1:], w[1:]):
                _close(gg, ww, 1e-5)


def test_ops_along_a_tp_sharded_dim_on_a_tp_only_mesh_match_jax(gang):
    """The same program on {tp 2} (no data axis, no sharded sequence: the
    Strategy plans the carried ops for the model axis alone), at the same
    limits."""
    refs, got = gang
    for res in got[:2]:
        for g, w in zip(res["tp_mixing_tp2"]["steps"],
                        refs["tp_mixing"]["steps"]):
            np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
            for gg, ww in zip(g[1:], w[1:]):
                _close(gg, ww, 1e-5)


def test_lm_accuracy_over_a_vocab_sharded_head_matches_jax(gang):
    """The tiny LM with the tensor-parallel head (logits sharded on the
    vocabulary) fetching next-token ``accuracy`` with an ``Accuracy``
    evaluator, two Adam steps on {dp 2, tp 2}: the top-1 test runs over
    the whole vocabulary (the Carrier gathers it over tp and the rows
    over dp), so the accuracy, the evaluator's rate and its counts are
    exactly the JAX package's unsharded ones, the losses within rtol
    1e-5."""
    refs, got = gang
    for res in got:
        for g, w in zip(res["lm_metrics_tp"]["steps"],
                        refs["lm_metrics_tp"]["steps"]):
            np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
            for gg, ww in zip(g[1:], w[1:]):
                np.testing.assert_array_equal(gg, ww)
    assert float(got[0]["lm_metrics_tp"]["steps"][1][4][0]) == 2 * 4

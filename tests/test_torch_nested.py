"""paddle_tpu_torch's nested sequences (``layers/nested.py``) and the
hier_text document classifier (``models/hier_text.py``) against the JAX
package on the CPU.

The eight tests of ``tests/test_nested.py`` are mirrored: each program is
built in both packages on the same numpy inputs and parameters and run op
by op (``run_both``, ``test_torch_sequence_ops.py``): values within 1e-5
of their scale, integer outputs equal, every gradient within 1e-4 of its
max abs, and the JAX test's own loop-by-loop checks on the port's values.
hier_text at B = 8, S = 3, W = 5 (the JAX test's sizes): the same
parameter names; one step's loss and every gradient from the JAX
startup's weights (gradients within 1e-4 of their max abs); five Adam
steps within rtol 1e-4 of JAX's losses; the JAX test's 40-step learning
check on the port; the train step and the program pruned to the
prediction warmed, bitwise equal to eager runs; and
``tools/train_profile.py``'s hier_text recipe and classes on the CPU."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.hier_text  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.tools import train_profile as tp
from test_torch_sequence_ops import assert_match, run_both

CPU = tfluid.CPUPlace()
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _check(build, feeds, seed=0):
    want, got, *rest = run_both(build, feeds, seed=seed)
    assert_match(want, got, *rest, fwd_tol=FWD_TOL, grad_tol=GRAD_TOL)
    return got


def _nested_data(rng, B=3, S=4, W=5, D=2):
    """``tests/test_nested.py::_nested_data``."""
    x = rng.rand(B, S, W, D).astype("float32")
    n_sub = rng.randint(1, S + 1, (B,)).astype("int32")
    sub_len = rng.randint(1, W + 1, (B, S)).astype("int32")
    for b in range(B):
        sub_len[b, n_sub[b]:] = 0
        x[b, n_sub[b]:] = 0
        for s in range(n_sub[b]):
            x[b, s, sub_len[b, s]:] = 0
    return x, n_sub, sub_len


def _feeds(x, n_sub, sub_len):
    return {"x": x, "n": n_sub, "s": sub_len}


def test_masks_match_jax():
    """``_inner_mask`` [B, S, W] from sub_len and ``_outer_mask`` [B, S]
    from n_sub, equal to the JAX package's."""
    from paddle_tpu.layers import nested as jnested
    from paddle_tpu_torch.layers import nested as tnested

    _, n_sub, sub_len = _nested_data(np.random.RandomState(4))
    S, W = sub_len.shape[1], 5
    np.testing.assert_array_equal(
        tnested._inner_mask(torch.from_numpy(sub_len), W).numpy(),
        np.asarray(jnested._inner_mask(sub_len, W)))
    np.testing.assert_array_equal(
        tnested._outer_mask(torch.from_numpy(n_sub), S).numpy(),
        np.asarray(jnested._outer_mask(n_sub, S)))


def test_nested_pool_matches_jax_and_loops():
    """``test_nested_pool_matches_loops``, with ``sqrt`` too."""
    x, n_sub, sub_len = _nested_data(np.random.RandomState(0))
    kinds = ("average", "sum", "max", "first", "last", "sqrt")

    def build(fl, v):
        return [fl.layers.nested_sequence_pool(v["x"], v["n"], v["s"], p)
                for p in kinds]
    r = _check(build, _feeds(x, n_sub, sub_len))
    for b in range(x.shape[0]):
        for s in range(n_sub[b]):
            valid = x[b, s, :sub_len[b, s]]
            for got, want in zip(r, (valid.mean(0), valid.sum(0),
                                     valid.max(0), valid[0], valid[-1],
                                     valid.sum(0) / np.sqrt(len(valid)))):
                np.testing.assert_allclose(got[b, s], want, rtol=1e-5)


def test_nested_first_and_last_step_match_jax():
    x, n_sub, sub_len = _nested_data(np.random.RandomState(7))

    def build(fl, v):
        return [fl.layers.nested_sequence_first_step(v["x"], v["n"], v["s"]),
                fl.layers.nested_sequence_last_step(v["x"], v["n"], v["s"])]
    _check(build, _feeds(x, n_sub, sub_len))


def test_nested_expand_and_to_flat_match_jax():
    """``test_nested_expand_and_to_flat``."""
    x, n_sub, sub_len = _nested_data(np.random.RandomState(1))
    B, S, W, D = x.shape

    def build(fl, v):
        pooled = fl.layers.nested_sequence_pool(v["x"], v["n"], v["s"],
                                                "sum")
        expanded = fl.layers.nested_sequence_expand(pooled, v["s"], W)
        flat, flat_len = fl.layers.nested_to_flat(v["x"], v["n"], v["s"])
        return [expanded, flat, flat_len]
    r_exp, r_flat, r_len = _check(build, _feeds(x, n_sub, sub_len))
    assert r_len.dtype == np.int32
    for b in range(B):
        want = []
        for s in range(n_sub[b]):
            w = sub_len[b, s]
            ssum = x[b, s, :w].sum(0)
            np.testing.assert_allclose(r_exp[b, s, :w], np.tile(ssum, (w, 1)),
                                       rtol=1e-5)
            np.testing.assert_allclose(r_exp[b, s, w:], 0.0)
            want.append(x[b, s, :w])
        want = np.concatenate(want, axis=0)
        assert r_len[b] == want.shape[0]
        np.testing.assert_allclose(r_flat[b, :r_len[b]], want, rtol=1e-6)
        np.testing.assert_allclose(r_flat[b, r_len[b]:], 0.0)


def test_nested_to_flat_truncation_clamps_length_matches_jax():
    """``test_nested_to_flat_truncation_clamps_length``: max_len 3."""
    x, n_sub, sub_len = _nested_data(np.random.RandomState(9))
    T = 3

    def build(fl, v):
        return list(fl.layers.nested_to_flat(v["x"], v["n"], v["s"],
                                             max_len=T))
    r_flat, r_len = _check(build, _feeds(x, n_sub, sub_len))
    assert r_flat.shape[1] == T and np.all(r_len <= T)
    for b in range(x.shape[0]):
        want = np.concatenate([x[b, s, :sub_len[b, s]]
                               for s in range(n_sub[b])], axis=0)[:T]
        np.testing.assert_allclose(r_flat[b, :r_len[b]], want[:r_len[b]],
                                   rtol=1e-6)


def test_nested_rnn_over_subsequences_matches_jax():
    """``test_nested_rnn_over_subsequences``: an outer accumulator of the
    sub-sequence sums."""
    x, n_sub, sub_len = _nested_data(np.random.RandomState(2))
    B, S, W, D = x.shape

    def build(fl, v):
        rnn = fl.layers.NestedDynamicRNN()
        with rnn.step():
            sent = rnn.step_input(v["x"])
            slen = rnn.step_sub_len(v["s"])
            acc = rnn.memory(shape=[D])
            nacc = fl.layers.elementwise_add(
                acc, fl.layers.sequence_pool(sent, slen, "sum"))
            rnn.update_memory(acc, nacc)
            rnn.step_output(nacc)
        out, = rnn(lengths=v["n"])
        return out
    r, = _check(build, _feeds(x, n_sub, sub_len))
    for b in range(B):
        run = np.zeros(D, "float32")
        for s in range(n_sub[b]):
            run = run + x[b, s, :sub_len[b, s]].sum(0)
            np.testing.assert_allclose(r[b, s], run, rtol=1e-4)
        np.testing.assert_allclose(r[b, n_sub[b]:], 0.0)


def test_nested_rnn_gru_grad_matches_jax():
    """``test_nested_rnn_gru_grad``: an inner GRU encodes each
    sub-sequence, the outer RNN reads the encodings; the loss and the
    gradients of x and of every parameter.  The whole nesting is one
    ``static_rnn`` op whose body holds the ``dynamic_gru`` op."""
    x, n_sub, sub_len = _nested_data(np.random.RandomState(3), B=2, S=3,
                                     W=4, D=3)
    H = 4

    def build(fl, v):
        rnn = fl.layers.NestedDynamicRNN()
        with rnn.step():
            sent = rnn.step_input(v["x"])
            slen = rnn.step_sub_len(v["s"])
            proj = fl.layers.fc(sent, 3 * H, num_flatten_dims=2,
                                bias_attr=False)
            enc, _ = fl.layers.dynamic_gru(proj, slen, H)
            sent_vec = fl.layers.sequence_pool(enc, slen, "last")
            h = rnn.memory(shape=[H])
            nh = fl.layers.fc([sent_vec, h], H, act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out, = rnn(lengths=v["n"])
        doc = fl.layers.sequence_pool(out, v["n"], "last")
        return fl.layers.mean(fl.layers.fc(doc, 1))
    _check(build, _feeds(x, n_sub, sub_len))
    ops = tfluid.default_main_program().list_ops()
    rnn_op = next(o for o in ops if o.type == "static_rnn")
    assert "dynamic_gru" in [o.type for o in rnn_op.sub_block.ops]
    assert "dynamic_gru" not in [o.type for o in ops]


def _select_build(K):
    def build(fl, v):
        return list(fl.layers.nested_sequence_select(v["x"], v["ns"],
                                                     v["sl"], v["sel"]))
    return build


def test_nested_sequence_select_matches_jax():
    """``test_nested_sequence_select``: -1 pads, and a leading pad
    left-packs."""
    B, S, W, D = 2, 3, 4, 2
    x = np.random.RandomState(8).randn(B, S, W, D).astype("float32")
    feeds = {"x": x, "ns": np.array([3, 2], "int32"),
             "sl": np.array([[4, 2, 3], [1, 4, 0]], "int32"),
             "sel": np.array([[2, 0], [-1, 1]], "int32")}
    o, nn, nsl = _check(_select_build(2), feeds)
    np.testing.assert_allclose(o[0, 0], x[0, 2])
    np.testing.assert_allclose(o[0, 1], x[0, 0])
    np.testing.assert_allclose(o[1, 0], x[1, 1])
    np.testing.assert_allclose(o[1, 1], 0.0)
    np.testing.assert_array_equal(nn, [2, 1])
    np.testing.assert_array_equal(nsl, [[3, 4], [4, 0]])


def test_nested_sequence_select_rejects_out_of_range_matches_jax():
    """``test_nested_sequence_select_rejects_out_of_range``: an index >= S
    or >= n_sub is masked, not clamped onto group S - 1."""
    B, S, W, D = 1, 3, 2, 1
    x = np.arange(B * S * W * D, dtype="float32").reshape(B, S, W, D)
    feeds = {"x": x, "ns": np.array([2], "int32"),
             "sl": np.full((B, S), W, "int32"),
             "sel": np.array([[5, 2, 1]], "int32")}
    o, nn, _ = _check(_select_build(3), feeds)
    np.testing.assert_array_equal(nn, [1])
    np.testing.assert_allclose(o[0, 0], x[0, 1])
    np.testing.assert_allclose(o[0, 1:], 0.0)


# ------------------------------------------------------------ hier_text

SMALL = dict(S=3, W=5, vocab_size=20, emb_dim=16, word_hidden=16,
             sent_hidden=16)
B = 8


def _build(fl):
    """``train_profile.build_hier_text_program`` at SMALL, in package
    ``fl``: (loss, acc, prediction)."""
    fl.reset_default_programs()
    L = fl.layers
    S, W = SMALL["S"], SMALL["W"]
    toks = L.data("toks", [S, W], dtype="int32")
    n_sub = L.data("n_sub", [-1], dtype="int32", append_batch_size=False)
    sub_len = L.data("sub_len", [S], dtype="int32")
    label = L.data("label", [1], dtype="int32")
    outs = fl.models.hier_text.build(
        toks, n_sub, sub_len, label,
        **{k: v for k, v in SMALL.items() if k not in ("S", "W")})
    fl.optimizer.Adam(3e-3).minimize(outs[0])
    return outs


def _feed(seed, train=True):
    return tp.hier_text_batch(seed, B, SMALL["S"], SMALL["W"],
                              SMALL["vocab_size"], train=train)


def _jax_start():
    jfluid.reset_global_scope()
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    return exe, {n: np.asarray(v) for n, v in jfluid.global_scope().items()}


def _port_start(weights):
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    return exe


def test_hier_text_program_matches_jax():
    """The same parameters in order, persistable names and shapes, and op
    types; the nesting is one ``static_rnn`` op."""
    _build(jfluid)
    _build(tfluid)
    jp, tp_ = jfluid.default_main_program(), tfluid.default_main_program()
    assert [p.name for p in tp_.parameters()] == [p.name
                                                  for p in jp.parameters()]
    assert {v.name: tuple(v.shape) for v in tp_.persistable_vars()} == {
        v.name: tuple(v.shape) for v in jp.persistable_vars()}
    assert [o.type for o in tp_.list_ops()] == [o.type
                                                for o in jp.list_ops()]
    assert [o.type for o in tp_.list_ops()].count("static_rnn") == 1


def test_hier_text_one_step_matches_jax():
    """One Adam step from the JAX startup's weights: the loss within 1e-5
    relative, the accuracy and the prediction, and every gradient within
    1e-4 of its max abs."""
    jloss, jacc, jpred = _build(jfluid)
    params = [p.name for p in jfluid.default_main_program().parameters()]
    fetch = [f"{n}@GRAD" for n in params]
    jexe, weights = _jax_start()
    feed = _feed(1)
    want = [np.asarray(a) for a in jexe.run(
        feed=feed, fetch_list=[jloss, jacc, jpred] + fetch)]
    tloss, tacc, tpred = _build(tfluid)
    got = _port_start(weights).run(feed=feed,
                                   fetch_list=[tloss, tacc, tpred] + fetch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    for name, a, b in zip(fetch, got[3:], want[3:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= GRAD_TOL * scale, name


def test_hier_text_five_adam_steps_match_jax():
    """Five Adam(3e-3) steps from the same weights on five batches: the
    losses within rtol 1e-4 of JAX's."""
    jloss, _, _ = _build(jfluid)
    jexe, weights = _jax_start()
    want = [float(np.asarray(jexe.run(feed=_feed(i), fetch_list=[jloss])[0]))
            for i in range(5)]
    tloss, _, _ = _build(tfluid)
    texe = _port_start(weights)
    got = [float(texe.run(feed=_feed(i), fetch_list=[tloss])[0])
           for i in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_hier_text_model_learns():
    """``test_hier_text_model_learns`` on the port: 40 Adam(3e-3) steps on
    the JAX test's batches (its feed stream, RandomState(5)), the last
    loss below 0.7 x the first."""
    S, W, V = 3, 5, 20
    L = tfluid.layers
    toks = L.data("toks", [S, W], dtype="int32")
    nv = L.data("n", [-1], dtype="int32", append_batch_size=False)
    sv = L.data("s", [S], dtype="int32")
    label = L.data("y", [1], dtype="int32")
    loss, acc, _ = tfluid.models.hier_text.build(
        toks, nv, sv, label, vocab_size=V, emb_dim=16, word_hidden=16,
        sent_hidden=16)
    tfluid.optimizer.Adam(3e-3).minimize(loss)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    rng = np.random.RandomState(5)
    first = last = None
    for _ in range(40):
        y = rng.randint(0, 2, (B, 1)).astype("int32")
        lo = np.where(y[:, 0] == 0, 1, V // 2)[:, None, None]
        hi = np.where(y[:, 0] == 0, V // 2, V)[:, None, None]
        t = (rng.randint(0, 10**6, (B, S, W)) % (hi - lo) + lo).astype(
            "int32")
        n = rng.randint(1, S + 1, (B,)).astype("int32")
        s = rng.randint(1, W + 1, (B, S)).astype("int32")
        for b in range(B):
            s[b, n[b]:] = 0
        out, = exe.run(feed={"toks": t, "n": n, "s": s, "y": y},
                       fetch_list=[loss])
        first = float(out) if first is None else first
        last = float(out)
    assert last < first * 0.7, (first, last)


def _warm_against_eager(build, weights, feeds):
    """``feeds`` through the program ``build()`` gives ((program, fetch
    list)) by an Executor that warmed its signature and by one that did
    not, from the same weights: every fetch and every state tensor after
    the last run bitwise equal."""
    runs = []
    for warm in (True, False):
        tfluid.reset_default_programs()
        main, fetch = build()
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        tfluid.load_scope(weights, main, scope, device="cpu")
        if warm:
            assert exe.warm(main, tp.feed_sig(feeds[0]), fetch,
                            scope=scope) == "compiled"
        outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
        assert exe.replays == (len(feeds) if warm else 0)
        runs.append((outs, {n: v.clone() for n, v in scope.items()}))
    (ow, sw), (oe, se) = runs
    for a, b in zip(ow, oe):
        assert [x.tobytes() for x in a] == [y.tobytes() for y in b]
    assert set(sw) == set(se) and all(torch.equal(sw[n], se[n]) for n in sw)
    return ow


def test_hier_text_warmed_train_and_serve_bitwise_equal_eager():
    """The train step warmed (three steps: the loss and every gradient,
    then every parameter, moment and optimizer step) and the program
    pruned to the prediction warmed (two batches), bitwise equal to eager
    runs; the served probabilities equal JAX's pruned program's."""
    _, _, jpred = _build(jfluid)
    jexe, weights = _jax_start()
    params = [p.name for p in jfluid.default_main_program().parameters()]

    def train():
        loss, _, _ = _build(tfluid)
        return (tfluid.default_main_program(),
                [loss] + [f"{n}@GRAD" for n in params])
    _warm_against_eager(train, weights, [_feed(i) for i in range(3)])

    feeds = [_feed(i, train=False) for i in (3, 4)]

    def serve():
        _, _, pred = _build(tfluid)
        main = tfluid.default_main_program().prune([pred])
        assert {o.type for o in main.list_ops()}.isdisjoint(
            {"cross_entropy", "adam", "accuracy"})
        return main, [pred]
    outs = _warm_against_eager(serve, weights, feeds)
    jprog = jfluid.default_main_program().prune([jpred])
    for f, o in zip(feeds, outs):
        want = np.asarray(jexe.run(jprog, feed=f, fetch_list=[jpred])[0])
        np.testing.assert_allclose(o[0], want, atol=1e-5)


def test_train_profile_hier_text_recipe_runs_on_the_cpu():
    """The ``hier_text`` and ``hier_text-infer`` recipes at small widths on
    the CPU: the batch follows the JAX test's rule, the warmed steps
    replay, the inference program holds no loss op; and the op classes
    cover the word GRU inside the ``static_rnn`` body."""
    cfg = dict(tp.HIER_CFG)
    try:
        tp.HIER_CFG.update(vocab_size=50, emb_dim=8, word_hidden=8,
                           sent_hidden=8)
        for model in tp.HIER:
            fetch, main, startup, params, feed, items, unit = tp._recipe(
                model)
            if model == "hier_text":
                assert (items, unit) == (int(feed["sub_len"].sum()),
                                         "tokens")
                classes = tp.hier_text_op_classes(main)
                assert set(classes.values()) == set(tp.HIER_CLASSES)
            else:
                assert (items, unit) == (tp.HIER_BATCH, "documents")
                assert "label" not in feed
            exe = tfluid.Executor(CPU)
            scope = tp.train_scope(exe, startup, main, params, "cpu")
            assert exe.warm(main, tp.feed_sig(feed), fetch,
                            scope=scope) == "compiled"
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            assert exe.replays == 1 and np.all(np.isfinite(out[0]))
    finally:
        tp.HIER_CFG.clear()
        tp.HIER_CFG.update(cfg)
    feed = tp.hier_text_batch(0)
    assert feed["toks"].shape == (tp.HIER_BATCH, tp.HIER_S, tp.HIER_W)
    n_sub, sub_len = feed["n_sub"], feed["sub_len"]
    assert n_sub.min() >= 1 and n_sub.max() <= tp.HIER_S
    valid = np.arange(tp.HIER_S)[None, :] < n_sub[:, None]
    assert (sub_len[valid] >= 1).all() and (sub_len[~valid] == 0).all()
    half = tp.HIER_CFG["vocab_size"] // 2
    assert ((feed["toks"] >= half).all(axis=(1, 2))
            == (feed["label"][:, 0] == 1)).all()


def test_hier_text_entry_points_default_to_the_card():
    """No fallback: the Executor and the hier_text profile take the CUDA
    card when none is named, and raise without one."""
    if torch.cuda.is_available():
        assert tfluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        tfluid.Executor()
    with pytest.raises(RuntimeError):
        tp.profile("hier_text")

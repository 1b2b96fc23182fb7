"""paddle_tpu_torch's SRL model (``models/srl.py``, the Paddle book's
db_lstm + CRF) against the JAX package on the CPU, at the JAX test's sizes
(``tests/test_models.py::test_label_semantic_roles_crf_learns``: max_len
16, B 16, dictionaries 200 / 50 / 10, word_dim 8, mark_dim 4, hidden 16,
depth 2): the synthetic conll05 reader sample for sample; the same
persistable names and shapes; one step's loss and every gradient from the
JAX startup's weights; five Adam steps; the JAX test's 30-step learning
check on the port; ``Executor.warm`` of the train and the pruned decode
programs, bitwise equal to eager runs; and ``tools/train_profile.py``'s
SRL classes on a CPU step."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.srl  # noqa: F401  (jfluid.models)
from paddle_tpu.datasets import conll05 as jconll05
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.datasets import conll05 as tconll05

CPU = tfluid.CPUPlace()
MAX_LEN, B = 16, 16
SIZES = dict(word_dict_len=200, pred_dict_len=50, label_dict_len=10,
             word_dim=8, mark_dim=4, hidden_dim=16, depth=2)
NAMES = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2", "verb",
         "mark"]
# the JAX test's id reduction into its small dictionaries
MODS = [200, 200, 200, 200, 200, 200, 50, 2]


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


@pytest.mark.parametrize("split,n", [("train", 64), ("test", 16)])
def test_conll05_reader_matches_jax(split, n):
    """The synthetic reader: every sample's nine lists equal, and the
    dictionary sizes."""
    want = list(getattr(jconll05, split)(n)())
    got = list(getattr(tconll05, split)(n)())
    assert got == want
    assert (tconll05.WORD_DICT_LEN, tconll05.PRED_DICT_LEN,
            tconll05.LABEL_DICT_LEN) == (jconll05.WORD_DICT_LEN,
                                         jconll05.PRED_DICT_LEN,
                                         jconll05.LABEL_DICT_LEN)
    assert [len(d) for d in tconll05.get_dict()] == [
        len(d) for d in jconll05.get_dict()]


def _build(fl):
    """The JAX test's program: db_lstm at SIZES with Adam(5e-3)."""
    slots = [fl.layers.data(n, [MAX_LEN], dtype="int32") for n in NAMES]
    label = fl.layers.data("label", [MAX_LEN], dtype="int32")
    length = fl.layers.data("len", [-1], dtype="int32",
                            append_batch_size=False)
    loss, decoded, _ = fl.models.srl.db_lstm(*slots, length, label=label,
                                             **SIZES)
    fl.optimizer.Adam(5e-3).minimize(loss)
    return loss, decoded


_DATA = list(jconll05.train(n_synthetic=64)())


def _feed(i, decode=False):
    """The JAX test's batch i: sentences i*B.. of the 64, ids reduced into
    the small dictionaries."""
    batch = [_DATA[(i * B + j) % len(_DATA)] for j in range(B)]
    slots, tags, ln = jfluid.models.srl.batch_from_dataset(batch, MAX_LEN)
    feed = {n: (s % MODS[k]).astype("int32")
            for k, (n, s) in enumerate(zip(NAMES, slots))}
    if not decode:
        feed["label"] = (tags % 10).astype("int32")
    feed["len"] = ln
    return feed


def _jax_start():
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    return exe, {n: np.asarray(v) for n, v in jfluid.global_scope().items()}


def _port_start(weights):
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    return exe


def test_program_matches_jax():
    """The same persistable names, shapes and dtypes (the shared word table
    and CRF transition by name), the same parameters in order, and the same
    op types but one: the JAX package's reduce layers pass their ``name``
    argument (None) as the op type, the port's op is ``reduce_mean``."""
    _build(jfluid)
    _build(tfluid)
    for jp, tp in ((jfluid.default_main_program(),
                    tfluid.default_main_program()),
                   (jfluid.default_startup_program(),
                    tfluid.default_startup_program())):
        jv = {v.name: tuple(v.shape) for v in jp.persistable_vars()}
        tv = {v.name: tuple(v.shape) for v in tp.persistable_vars()}
        assert tv == jv
    params = [p.name for p in tfluid.default_main_program().parameters()]
    assert params == [p.name
                      for p in jfluid.default_main_program().parameters()]
    assert {"srl_word_emb", "srl_crf_transition",
            "dynamic_lstm_w_1"} <= set(params)
    jops = [o.type or "reduce_mean"
            for o in jfluid.default_main_program().list_ops()]
    assert [o.type for o in tfluid.default_main_program().list_ops()] == jops


def test_one_step_loss_and_gradients_match_jax():
    """One Adam step from the JAX startup's weights: the loss within 1e-5
    relative, every gradient within 2e-5 of its max abs, and the decoded
    tags equal."""
    jloss, jdec = _build(jfluid)
    params = jfluid.default_main_program().parameters()
    fetch = [f"{p.name}@GRAD" for p in params]
    jexe, weights = _jax_start()
    feed = _feed(1)
    want = [np.asarray(a) for a in jexe.run(
        feed=feed, fetch_list=[jloss, jdec] + fetch)]
    tloss, tdec = _build(tfluid)
    got = _port_start(weights).run(feed=feed,
                                   fetch_list=[tloss, tdec] + fetch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    for name, a, b in zip(fetch, got[2:], want[2:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= 2e-5 * scale, name


def test_five_adam_steps_match_jax():
    """Five Adam(5e-3) steps on the JAX test's batches from the same
    weights: the losses within 1e-4 relative."""
    jloss, _ = _build(jfluid)
    jexe, weights = _jax_start()
    want = [float(np.asarray(jexe.run(feed=_feed(i), fetch_list=[jloss])[0]))
            for i in range(5)]
    tloss, _ = _build(tfluid)
    texe = _port_start(weights)
    got = [float(texe.run(feed=_feed(i), fetch_list=[tloss])[0])
           for i in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_label_semantic_roles_crf_learns():
    """``tests/test_models.py::test_label_semantic_roles_crf_learns`` on the
    port: 30 Adam(5e-3) steps, the last loss below 0.8 x the first, and the
    decoded tags int32 [B, max_len]."""
    loss, decoded = _build(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    first = last = None
    for i in range(30):
        out, dec = exe.run(feed=_feed(i), fetch_list=[loss, decoded])
        first = float(out) if first is None else first
        last = float(out)
    assert dec.shape == (B, MAX_LEN) and dec.dtype == np.int32
    assert np.isfinite(last) and last < first * 0.8, (first, last)


# ------------------------------------------------------------ warm


def _warm_against_eager(build, weights, feeds):
    """Run ``feeds`` through the program ``build()`` makes (returning
    (program, fetch list)) by an Executor that warmed its signature first
    and by one that did not, from the same weights: every fetch of every
    run and every state tensor after the last bitwise equal."""
    runs = []
    for warm in (True, False):
        tfluid.reset_default_programs()
        main, fetch = build()
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        tfluid.load_scope(weights, main, scope, device="cpu")
        if warm:
            sig = [(n, v.shape, v.dtype.name) for n, v in feeds[0].items()]
            assert exe.warm(main, sig, fetch, scope=scope) == "compiled"
            assert exe.warm(main, sig, fetch, scope=scope) == "cached"
        outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
        assert exe.replays == (len(feeds) if warm else 0)
        runs.append((outs, {n: v.clone() for n, v in scope.items()}))
    (ow, sw), (oe, se) = runs
    for a, b in zip(ow, oe):
        assert [x.tobytes() for x in a] == [y.tobytes() for y in b]
    assert set(sw) == set(se)
    assert all(torch.equal(sw[n], se[n]) for n in sw)
    return ow


def test_warmed_train_steps_bitwise_equal_eager():
    """Three warmed train steps against three eager ones: the loss, the
    decoded tags and every gradient of each step, then every parameter,
    moment and optimizer step."""
    _build(jfluid)
    _, weights = _jax_start()
    params = [p.name for p in jfluid.default_main_program().parameters()]

    def build():
        loss, dec = _build(tfluid)
        return (tfluid.default_main_program(),
                [loss, dec] + [f"{n}@GRAD" for n in params])
    outs = _warm_against_eager(build, weights, [_feed(i) for i in range(3)])
    assert len(outs[0]) == 2 + len(params)


def test_warmed_decode_bitwise_equal_eager():
    """The training program pruned to the Viterbi tags (as
    ``train_profile --model srl-decode`` prunes it), warmed: the tags of
    two batches bitwise equal to eager runs, and equal to JAX's."""
    _, jdec = _build(jfluid)
    jexe, weights = _jax_start()
    feeds = [_feed(i, decode=True) for i in (3, 4)]

    def build():
        _, dec = _build(tfluid)
        main = tfluid.default_main_program().prune([dec])
        assert {o.type for o in main.list_ops()}.isdisjoint(
            {"linear_chain_crf", "adam"})
        return main, [dec]
    outs = _warm_against_eager(build, weights, feeds)
    jprog = jfluid.default_main_program().prune([jdec])
    for f, o in zip(feeds, outs):
        want = np.asarray(jexe.run(jprog, feed=f, fetch_list=[jdec])[0])
        np.testing.assert_array_equal(o[0], want)


def test_profile_classes_resolve_the_backward_by_forward_op():
    """``tools/train_profile.py``'s SRL classes on a CPU step: each op in
    its class's range, the backward's autograd nodes named by the forward
    op that made them, so the lstm, crf, matmul and embedding classes all
    reach the backward; the LSTM kernels go by name, the optimizer's
    multi-tensor kernels to optimizer."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.tools import train_profile as tp

    _build(jfluid)
    _, weights = _jax_start()
    loss, dec = _build(tfluid)
    main = tfluid.default_main_program()
    exe = _port_start(weights)
    classes = tp.srl_op_classes(main)
    assert set(classes.values()) == {"lstm", "crf", "viterbi", "matmul",
                                     "embedding", "optimizer", "other"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tp._OpRanges(lambda op: tp._S2S + classes.get(id(op), "other")):
            exe.run(main, feed=_feed(0), fetch_list=[loss, dec])
    events = prof.events()
    name = tp.seq2seq_range_names(events)
    nodes = [e for e in events if e.name.startswith(tp._NODE)]
    backward = {tp._srl_class("k", [name(a) for a in tp._chain(e)])
                for e in nodes}
    assert {"lstm", "crf", "matmul", "embedding"} <= backward, backward
    assert tp._srl_class("lstm_bwd_persistent", ["s2s::other"]) \
        == tp._BY_NAME
    assert tp._srl_class("multi_tensor_apply_kernel", ["s2s::crf"]) \
        == "optimizer"
    assert tp._srl_class("k", ["x", "s2s::viterbi"]) == "viterbi"


def test_train_profile_srl_recipe_runs_on_the_cpu():
    """The ``srl`` and ``srl-decode`` recipes at the JAX test's widths on
    the CPU: the batch is conll05's first sentences padded to SRL_LEN, the
    warmed steps replay, and the decode program holds no CRF loss op."""
    from paddle_tpu_torch.tools import train_profile as tp

    cfg = dict(tp.SRL_CFG)
    try:
        tp.SRL_CFG.update(word_dim=8, mark_dim=4, hidden_dim=16, depth=2)
        for model in tp.SRL:
            fetch, main, startup, params, feed, items, unit = tp._recipe(
                model)
            assert items == int(feed["length"].sum()) and unit == "tokens"
            assert ("label" in feed) == (model == "srl")
            exe = tfluid.Executor(CPU)
            scope = tp.train_scope(exe, startup, main, params, "cpu")
            assert exe.warm(main, tp.feed_sig(feed), fetch,
                            scope=scope) == "compiled"
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            assert exe.replays == 1 and np.all(np.isfinite(out[0]))
    finally:
        tp.SRL_CFG.clear()
        tp.SRL_CFG.update(cfg)
    feed = tp.srl_batch(0)
    samples = list(tconll05.train(tp.SRL_BATCH)())
    assert feed["word"].shape == (tp.SRL_BATCH, tp.SRL_LEN)
    assert list(feed["length"]) == [len(s[0]) for s in samples]


def test_srl_entry_points_default_to_the_card():
    """No fallback: the Executor that runs the SRL programs, and the SRL
    profile, take the CUDA card when none is named, and raise without
    one."""
    from paddle_tpu_torch.tools import train_profile as tp

    _build(tfluid)
    if torch.cuda.is_available():
        assert tfluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        tfluid.Executor()
    with pytest.raises(RuntimeError):
        tp.profile("srl")

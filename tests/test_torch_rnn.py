"""paddle_tpu_torch's recurrent layers against the JAX package on the CPU:
``concat``, ``dynamic_gru`` (forward and reverse, lengths 1, T and 0),
``gru_unit`` and ``lstm_unit``, each program's outputs within 1e-6 abs and
its gradients (``append_backward`` in both packages, ``jax.grad`` in the
JAX one) within 1e-5 of their max abs, from the same numpy weights; the
JAX package's StaticRNN / DynamicRNN tests mirrored on the port and held
against the JAX package on the same weights; ``check_kernel_shapes``
walking a ``static_rnn`` body; and ``Executor.warm`` of the text_lstm step
on the CPU, bitwise equal to eager runs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu.models.text_lstm  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu.layers import control_flow as jcf
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.layers import control_flow as tcf

CPU = tfluid.CPUPlace()
CUDA = torch.device("cuda")
B, T, D, H = 4, 6, 5, 8
LENGTHS = np.array([T, 1, 0, 3], np.int32)
OUT_ATOL = 1e-6
GRAD_REL = 1e-5


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _weights(program, seed):
    """Numpy weights N(0, 0.5^2) for every parameter of ``program``."""
    rng = np.random.RandomState(seed)
    return {p.name: (0.5 * rng.standard_normal(p.shape)).astype(np.float32)
            for p in program.parameters()}


def _run_both(build, feed, seed=0, grads=True):
    """Build ``build(fluid, cf) -> (outputs, loss)`` in both packages (with
    ``append_backward`` when ``grads``), load the same numpy weights, run
    one step on the CPU; returns (JAX's fetches, the port's, the gradient
    names, the port's loss Variable).  Both programs declare the same
    parameters, in one order."""
    jouts, jloss = build(jfluid, jcf)
    jmain = jfluid.default_main_program()
    if grads:
        jfluid.backward.append_backward(jloss)
    weights = _weights(jmain, seed)
    gnames = [f"{n}@GRAD" for n in weights] if grads else []
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    for n, v in weights.items():
        jfluid.global_scope().set_var(n, jnp.asarray(v))
    want = [np.asarray(a) for a in jexe.run(
        feed=feed, fetch_list=list(jouts) + [jloss] + gnames)]

    touts, tloss = build(tfluid, tcf)
    tmain = tfluid.default_main_program()
    assert [p.name for p in tmain.parameters()] == list(weights)
    assert [tuple(p.shape) for p in tmain.parameters()] == \
        [tuple(p.shape) for p in jmain.parameters()]
    if grads:
        tfluid.backward.append_backward(tloss)
    texe = tfluid.Executor(CPU)
    texe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tmain, tfluid.global_scope(), device="cpu")
    got = texe.run(feed=feed, fetch_list=list(touts) + [tloss] + gnames)
    return want, got, gnames, tloss


def _assert_close(want, got, gnames):
    n_out = len(want) - len(gnames)
    for i, (a, b) in enumerate(zip(got[:n_out], want[:n_out])):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=OUT_ATOL, rtol=0,
                                   err_msg=f"output {i}")
    for name, a, b in zip(gnames, got[n_out:], want[n_out:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= GRAD_REL * scale, name


def _loss(fl, *vs):
    """mean(fc(v, 1)) summed over ``vs``: a loss that weighs every element
    of each differently."""
    L = fl.layers
    return L.sums([L.mean(L.fc(v, 1, num_flatten_dims=len(v.shape) - 1))
                   for v in vs])


def _seq_feed(seed=1):
    rng = np.random.RandomState(seed)
    return {"x": rng.standard_normal((B, T, D)).astype(np.float32),
            "len": LENGTHS}


def _seq_data(fl):
    x = fl.layers.data("x", [T, D])
    ln = fl.layers.data("len", [-1], dtype="int32", append_batch_size=False)
    return x, ln


# ------------------------------------------------------------ single layers


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_dynamic_gru_matches_jax(reverse):
    """Hidden states (zero at padded steps) and the last carried state,
    lengths T, 1, 0 and 3, and the gradients of every weight: the input
    projection's, the GRU's [H, 3H] weight and its bias."""
    def build(fl, cf):
        x, ln = _seq_data(fl)
        proj = fl.layers.fc(x, 3 * H, num_flatten_dims=2, bias_attr=False)
        hs, h_last = fl.layers.dynamic_gru(proj, ln, H, is_reverse=reverse)
        return [hs, h_last], _loss(fl, hs, h_last)

    want, got, gnames, _ = _run_both(build, _seq_feed(), seed=2)
    _assert_close(want, got, gnames)
    hs = got[0]
    assert np.all(hs[2] == 0) and np.all(hs[1, 1:] == 0)   # padded steps
    assert np.all(got[1][2] == 0)     # a length-0 row carries its zero state
    assert "dynamic_gru_w_0@GRAD" in gnames


def test_gru_unit_and_concat_match_jax():
    """One GRU step on concatenated inputs (``concat`` along the feature
    axis, as the seq2seq decoder feeds it)."""
    def build(fl, cf):
        a = fl.layers.data("a", [D])
        b = fl.layers.data("b", [H])
        h0 = fl.layers.fc(fl.layers.data("h", [H]), H, act="tanh")
        inp = fl.layers.concat([fl.layers.fc(a, D), b], axis=1)
        nh = fl.layers.gru_unit(fl.layers.fc(inp, 3 * H, bias_attr=False),
                                h0, H)
        return [inp, nh], _loss(fl, nh)

    rng = np.random.RandomState(3)
    feed = {"a": rng.standard_normal((B, D)).astype(np.float32),
            "b": rng.standard_normal((B, H)).astype(np.float32),
            "h": rng.standard_normal((B, H)).astype(np.float32)}
    want, got, gnames, _ = _run_both(build, feed, seed=4)
    _assert_close(want, got, gnames)
    assert got[0].shape == (B, D + H)
    assert "gru_unit_w_0@GRAD" in gnames and "gru_unit_b_0@GRAD" in gnames


def test_concat_three_inputs_on_the_time_axis_matches_jax():
    def build(fl, cf):
        x, _ = _seq_data(fl)
        parts = [fl.layers.fc(x, 3, num_flatten_dims=2) for _ in range(3)]
        out = fl.layers.concat(parts, axis=1)
        return [out], _loss(fl, out)

    want, got, gnames, _ = _run_both(build, _seq_feed(5), seed=6)
    _assert_close(want, got, gnames)
    assert got[0].shape == (B, 3 * T, 3)


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_matches_jax(forget_bias):
    def build(fl, cf):
        x = fl.layers.fc(fl.layers.data("x", [D]), 4 * H)
        h = fl.layers.fc(fl.layers.data("h", [H]), H, act="tanh")
        c = fl.layers.fc(fl.layers.data("c", [H]), H)
        nh, nc = fl.layers.sequence.lstm_unit(x, h, c,
                                              forget_bias=forget_bias)
        return [nh, nc], _loss(fl, nh, nc)

    rng = np.random.RandomState(7)
    feed = {"x": rng.standard_normal((B, D)).astype(np.float32),
            "h": rng.standard_normal((B, H)).astype(np.float32),
            "c": rng.standard_normal((B, H)).astype(np.float32)}
    want, got, gnames, _ = _run_both(build, feed, seed=8)
    _assert_close(want, got, gnames)
    assert "lstm_unit_w_0@GRAD" in gnames


# ------------------------------------------------- mirrors of the JAX tests


def test_static_rnn_accumulator():
    """``tests/test_control_flow.py::test_static_rnn_accumulator``: the
    running sum over time, on the port, and equal to the JAX package's."""
    Bm, Tm, Dm = 2, 5, 3
    x = np.random.RandomState(0).rand(Bm, Tm, Dm).astype("float32")

    def build(fl, cf):
        xv = fl.layers.data("x", [Tm, Dm])
        rnn = cf.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(xv)
            acc = rnn.memory(shape=[Dm])
            s = fl.layers.elementwise_add(acc, xt)
            rnn.update_memory(acc, s)
            rnn.step_output(s)
        out, = rnn()
        return [out], fl.layers.mean(out)

    want, got, _, _ = _run_both(build, {"x": x}, grads=False)
    np.testing.assert_allclose(got[0], np.cumsum(x, axis=1), rtol=1e-5)
    _assert_close(want, got, [])


def test_static_rnn_fc_grad():
    """``tests/test_control_flow.py::test_static_rnn_fc_grad``: a tanh RNN
    of one fc over [x_t, h], averaged over time, then fc(1) and mean.  The
    JAX test checks its gradients by finite differences; here every
    gradient is held against ``jax.grad`` of the same program on the same
    weights, and one weight's by central differences on the port.  The
    time average is ``sequence_pool(out, T, "average")`` (the port has no
    ``reduce_mean``; over full lengths it is the same mean)."""
    Bm, Tm, Dm, Hm = 2, 4, 3, 4
    x = np.random.RandomState(1).rand(Bm, Tm, Dm).astype("float32")
    feed = {"x": x, "len": np.full((Bm,), Tm, np.int32)}

    def build(fl, cf):
        xv = fl.layers.data("x", [Tm, Dm])
        ln = fl.layers.data("len", [-1], dtype="int32",
                            append_batch_size=False)
        rnn = cf.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(xv)
            h = rnn.memory(shape=[Hm])
            nh = fl.layers.fc([xt, h], Hm, act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out, = rnn()
        last = fl.layers.sequence_pool(out, ln, "average")
        return [out], fl.layers.mean(fl.layers.fc(last, 1))

    want, got, gnames, loss = _run_both(build, feed, seed=9)
    _assert_close(want, got, gnames)
    assert len(gnames) == 5            # two fc weights, their bias, fc(1)

    # central differences on the port, one element of the RNN's input
    # weight (delta 1e-2, the JAX test's): the analytic gradient within 2%
    # (its max_relative_error)
    scope = tfluid.global_scope()
    name = gnames[0][:-len("@GRAD")]
    exe = tfluid.Executor(CPU)
    base = scope.find_var(name).clone()
    vals = []
    for sign in (1, -1):
        w = base.clone()
        w[0, 0] += sign * 1e-2
        scope.set_var(name, w)
        vals.append(float(exe.run(feed=feed, fetch_list=[loss])[0]))
    scope.set_var(name, base)
    numeric = (vals[0] - vals[1]) / 2e-2
    analytic = float(got[len(got) - len(gnames)][0, 0])
    assert abs(numeric - analytic) <= 0.02 * max(abs(analytic), 1e-3)


def test_dynamic_rnn_respects_lengths():
    """``tests/test_control_flow.py::test_dynamic_rnn_respects_lengths``:
    the running sum within each length, zero outputs past it; equal to the
    JAX package's outputs."""
    Bm, Tm, Dm = 3, 4, 2
    x = np.ones((Bm, Tm, Dm), "float32")
    ln = np.array([4, 2, 1], "int32")

    def build(fl, cf):
        xv = fl.layers.data("x", [Tm, Dm])
        lv = fl.layers.data("len", [-1], dtype="int32",
                            append_batch_size=False)
        rnn = cf.DynamicRNN()
        with rnn.step():
            xt = rnn.step_input(xv)
            acc = rnn.memory(shape=[Dm])
            s = fl.layers.elementwise_add(acc, xt)
            rnn.update_memory(acc, s)
            rnn.step_output(s)
        out, = rnn(lengths=lv)
        return [out], fl.layers.mean(out)

    want, got, _, _ = _run_both(build, {"x": x, "len": ln}, grads=False)
    r = got[0]
    np.testing.assert_allclose(r[1, 1], [2, 2], rtol=1e-6)
    np.testing.assert_allclose(r[1, 2], [0, 0], rtol=1e-6)
    np.testing.assert_allclose(r[2, 0], [1, 1], rtol=1e-6)
    np.testing.assert_allclose(r[2, 3], [0, 0], rtol=1e-6)
    _assert_close(want, got, [])


def test_dynamic_rnn_memory_init_and_static_input_match_jax():
    """A DynamicRNN with a memory booted from a Variable, a static input
    read whole at every step and a parameter created in its body
    (hoisted): outputs and every gradient against the JAX package's, with
    lengths 1, T, 0 and 3 (padded steps hold the memory)."""
    def build(fl, cf):
        x, ln = _seq_data(fl)
        boot = fl.layers.fc(fl.layers.sequence_pool(x, ln, "last"), H,
                            act="tanh")
        rnn = cf.DynamicRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(init=boot)
            ctx = rnn.static_input(x)
            pooled = fl.layers.sequence_pool(ctx, rnn.static_input(ln),
                                             "sum")
            nh = fl.layers.fc([xt, h, pooled], H, act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out, = rnn(lengths=ln)
        return [out], _loss(fl, out)

    want, got, gnames, _ = _run_both(build, _seq_feed(10), seed=11)
    _assert_close(want, got, gnames)
    assert np.all(got[0][2] == 0) and np.all(got[0][1, 1:] == 0)


# ------------------------------------------------------------ kernel checks


def test_check_kernel_shapes_walks_the_rnn_body():
    """A float64 ``dynamic_lstm`` inside a DynamicRNN body is refused for a
    CUDA device by ``check_kernel_shapes`` (it walks the ``static_rnn``
    op's sub-block) and by ``Executor.run`` before the first op, the scope
    unchanged; the CPU runs it; the float32 program passes the check."""
    def build(dtype):
        tfluid.reset_default_programs()
        x = tfluid.layers.data("x", [T, D], dtype=dtype)
        seq = tfluid.layers.data("seq", [T, 4 * H], dtype=dtype)
        ln = tfluid.layers.data("len", [-1], dtype="int32",
                                append_batch_size=False)
        rnn = tcf.DynamicRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            s = rnn.static_input(seq)
            inner_ln = rnn.static_input(ln)
            hs, _ = tfluid.layers.dynamic_lstm(s, inner_ln, H)
            pooled = tfluid.layers.sequence_pool(hs, inner_ln, "last")
            rnn.step_output(tfluid.layers.fc([xt, pooled], H))
        out, = rnn(lengths=ln)
        return out

    assert any(op.type == "dynamic_lstm"
               for _, op in build("float32").program.all_ops())
    texec.check_kernel_shapes(tfluid.default_main_program(), CUDA)

    out = build("float64")
    main = tfluid.default_main_program()
    assert all(op.type != "dynamic_lstm" for op in main.list_ops())
    with pytest.raises(ValueError, match="LSTM kernels take float32"):
        texec.check_kernel_shapes(main, CUDA)
    rng = np.random.RandomState(12)
    feed = {"x": rng.standard_normal((B, T, D)),
            "seq": rng.standard_normal((B, T, 4 * H)), "len": LENGTHS}
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    scope = tfluid.global_scope()
    before = {n: t.clone() for n, t in scope.items()}
    steps = scope.step_counter
    on_card = tfluid.Executor(CPU)
    on_card.device = CUDA          # no card here: the check comes first
    with pytest.raises(ValueError, match="LSTM kernels take float32"):
        on_card.run(feed=feed, fetch_list=[out])
    assert all(torch.equal(before[n], t) for n, t in scope.items())
    assert scope.step_counter == steps
    got, = exe.run(feed=feed, fetch_list=[out])
    assert got.dtype == np.float64 and np.isfinite(got).all()


# ------------------------------------------------------------ warm


def test_text_lstm_warmed_steps_bitwise_equal_eager():
    """``Executor.warm`` of a small text_lstm train step (2 x LSTM-16,
    Adam) on the CPU: three warmed runs (the body on static buffers)
    bitwise equal to three eager runs from the same weights, losses and
    every state tensor."""
    from paddle_tpu_torch.models import init_text_lstm_params

    cfg = dict(vocab_size=50, emb_dim=8, hidden=16, num_layers=2,
               class_dim=2)
    words = tfluid.layers.data("words", [12], dtype="int32")
    lengths = tfluid.layers.data("lengths", [-1], dtype="int32",
                                 append_batch_size=False)
    label = tfluid.layers.data("label", [1], dtype="int32")
    loss, _, _ = tfluid.models.text_lstm.build(words, lengths, label, **cfg)
    tfluid.optimizer.Adam(1e-3).minimize(loss)
    main, startup = (tfluid.default_main_program(),
                     tfluid.default_startup_program())
    weights = init_text_lstm_params(1, **cfg)
    rng = np.random.RandomState(13)
    feeds = [{"words": rng.randint(0, 50, (5, 12)).astype(np.int32),
              "lengths": np.array([12, 7, 1, 0, 9], np.int32),
              "label": rng.randint(0, 2, (5, 1)).astype(np.int32)}
             for _ in range(3)]
    runs = []
    for warm in (True, False):
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        tfluid.load_scope(weights, main, scope, device="cpu")
        if warm:
            sig = [(n, v.shape, v.dtype.name) for n, v in feeds[0].items()]
            assert exe.warm(main, sig, [loss], scope=scope) == "compiled"
        losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in feeds]
        assert exe.replays == (3 if warm else 0)
        runs.append((losses, {n: v.clone() for n, v in scope.items()}))
    (lw, sw), (le, se) = runs
    assert [a.tobytes() for a in lw] == [b.tobytes() for b in le]
    assert set(sw) == set(se)
    assert all(torch.equal(sw[n], se[n]) for n in sw)

"""paddle_tpu_torch's control flow (``cond``, ``while_loop``, ``IfElse``)
and the tensor helpers that its tests build on (``fill_constant``,
``fill_constant_batch_size_like``, ``scale``, ``cast``,
``square_error_cost``) against the JAX package on the CPU.

The JAX tests of ``tests/test_control_flow.py`` are mirrored: each program
is built in both packages on the same numpy inputs and parameters and run
op by op (``run_both``, ``test_torch_sequence_ops.py``): values within
1e-5 of their scale, integer states and trip counts equal, and every
gradient, by ``jax.vjp`` and torch autograd under one cotangent, within
1e-4 of its max abs.  Besides: ``cond`` runs only the taken branch (the
untaken one's parameters get zero gradients, and an Adam step moves them
as JAX's does; a branch with an infinite local derivative gives no NaN),
``cond`` refuses branches of different shapes or dtypes, and
``Executor.warm`` refuses ``cond`` and the unbounded ``while_loop`` before
it captures anything, while it captures the bounded loop and ``IfElse``
(on the CPU, the warmed body re-run on static buffers) bitwise equal to
eager runs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.graphs import WarmError
from test_torch_sequence_ops import assert_match, run_both

CPU = tfluid.CPUPlace()
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _check(build, feeds, seed=0):
    assert_match(*run_both(build, feeds, seed=seed), fwd_tol=FWD_TOL,
                 grad_tol=GRAD_TOL)


def _tanh(fl):
    return jnp.tanh if fl is jfluid else torch.tanh


# ------------------------------------------------------------ tensor helpers


_HELPERS = {
    # each case with one output that x reaches, so that there is a
    # gradient to compare
    "fill_constant": lambda fl, v: [
        fl.layers.fill_constant([2, 3], "float32", 1.5),
        fl.layers.fill_constant([1], "int32", 7, name="seven"),
        fl.layers.elementwise_add(
            v["x"], fl.layers.fill_constant([3], "float32", -0.5))],
    "fill_constant_batch_size_like": lambda fl, v: [
        fl.layers.fill_constant_batch_size_like(
            v["x"], [4, 1, 2], "int32", 3, input_dim_idx=1,
            output_dim_idx=2),
        fl.layers.elementwise_add(v["x"], fl.layers.fill_constant_batch_size_like(
            v["x"], [1, 3], "float32", 0.25))],
    "scale": lambda fl, v: [
        fl.layers.scale(v["x"], 2.5, bias=-1.0),
        fl.layers.scale(v["x"], -0.5, bias=3.0, bias_after_scale=False)],
    "cast": lambda fl, v: [fl.layers.cast(v["x"], "int32"),
                           fl.layers.cast(v["i"], "float32"),
                           fl.layers.cast(v["x"], "float32")],
    "square_error_cost": lambda fl, v: fl.layers.square_error_cost(
        fl.layers.fc(v["x"], 3), v["y"]),
}


@pytest.mark.parametrize("name", sorted(_HELPERS))
def test_tensor_helpers_match_jax(name):
    rng = np.random.RandomState(1)
    feeds = {"x": (rng.standard_normal((4, 3)) * 3).astype(np.float32),
             "y": rng.standard_normal((4, 3)).astype(np.float32),
             "i": rng.randint(-9, 9, (4, 3)).astype(np.int32)}
    _check(_HELPERS[name], feeds)


def test_fill_constant_names_its_output():
    v = tfluid.layers.fill_constant([1], "int32", 7, name="seven")
    assert v.name == "seven" and v.shape == (1,) and v.dtype == torch.int32


# ------------------------------------------------------------------ cond


def _x_feed(seed=0, shape=(2, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("pred", [True, False])
def test_cond_branches_match_jax(pred):
    """``test_cond_branches``: x * 2 or -x by the predicate."""
    def build(fl, v):
        return fl.layers.cond(v["p"], lambda: fl.layers.scale(v["x"], 2.0),
                              lambda: fl.layers.scale(v["x"], -1.0))
    _check(build, {"p": np.array([pred]), "x": _x_feed()})


@pytest.mark.parametrize("pred", [True, False])
def test_cond_identity_branch_matches_jax(pred):
    """``test_cond_identity_branch``: a branch returns a captured outer
    variable unchanged."""
    def build(fl, v):
        return fl.layers.cond(v["p"], lambda: v["x"],
                              lambda: fl.layers.scale(v["x"], -1.0))
    _check(build, {"p": np.array([pred]), "x": np.ones((2, 3), np.float32)})


@pytest.mark.parametrize("pred", [True, False])
def test_cond_with_parameters_and_two_outputs_matches_jax(pred):
    """Each branch builds its own fc (parameters hoisted, the untaken
    branch's gradient zero) and returns two outputs."""
    def build(fl, v):
        def branch(act):
            return lambda: [fl.layers.fc(v["x"], 4, act=act),
                            fl.layers.scale(v["x"], 3.0)]
        return fl.layers.cond(v["p"], branch("tanh"), branch(None))
    want, got, jg, tg, names = run_both(
        build, {"p": np.array([pred]), "x": _x_feed(2, (3, 5))})
    assert_match(want, got, jg, tg, names, FWD_TOL, GRAD_TOL)
    untaken = ("fc_w_1", "fc_b_1") if pred else ("fc_w_0", "fc_b_0")
    for n, g in zip(names, tg):
        assert (not g.any()) == (n in untaken), n


def test_cond_untaken_branch_gives_no_nan_gradient():
    """The false branch runs; the true one is sqrt at 0, whose local
    derivative is infinite.  A select over both branches would give 0 *
    inf = NaN; running only the taken branch gives JAX's finite
    gradient."""
    x = _x_feed(3)
    x[0, :2] = 0.0

    def build(fl, v):
        return fl.layers.cond(v["p"], lambda: fl.layers.sqrt(v["x"]),
                              lambda: fl.layers.scale(v["x"], -2.0))
    want, got, jg, tg, names = run_both(build, {"p": np.array([False]),
                                                "x": x})
    assert_match(want, got, jg, tg, names, FWD_TOL, GRAD_TOL)
    assert np.isfinite(tg[0]).all()


@pytest.mark.parametrize("other", ["shape", "dtype", "count"])
def test_cond_rejects_branches_that_differ(other):
    """Both branches must give the same number of outputs, shapes and
    dtypes, where JAX's ``lax.cond`` trace raises."""
    L = tfluid.layers
    p = L.data("p", [-1], dtype="bool", append_batch_size=False)
    x = L.data("x", [3])
    false_fn = {"shape": lambda: L.fc(x, 4),
                "dtype": lambda: L.cast(x, "int32"),
                "count": lambda: [x, x]}[other]
    with pytest.raises(ValueError, match="cond"):
        L.cond(p, lambda: L.scale(x, 2.0), false_fn)


def _cond_train_program(fl):
    L = fl.layers
    x = L.data("x", [4])
    y = L.data("y", [1])
    p = L.data("p", [-1], dtype="bool", append_batch_size=False)
    h = L.cond(p, lambda: L.fc(x, 3, act="tanh"), lambda: L.fc(x, 3))
    loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
    fl.optimizer.Adam(0.1).minimize(loss)
    return loss


def test_cond_untaken_branch_zero_gradient_and_adam_match_jax():
    """Three Adam(0.1) steps with the predicate True, False, True from the
    same weights: the loss and every gradient of each step within the
    stated limits of JAX's; the untaken branch's gradients are exact
    zeros in both; after each step every parameter and moment matches
    (the zero-gradient step still moves the branch's parameters through
    its moments, as JAX's Adam does)."""
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(6, 4).astype(np.float32),
              "y": rng.rand(6, 1).astype(np.float32),
              "p": np.array([p])} for p in (True, False, True)]
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    jloss = _cond_train_program(jfluid)
    params = [p.name for p in jfluid.default_main_program().parameters()]
    fetch = [f"{n}@GRAD" for n in params]
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    weights = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}
    tloss = _cond_train_program(tfluid)
    assert [p.name for p in tfluid.default_main_program().parameters()] \
        == params
    texe = tfluid.Executor(CPU)
    texe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    for f in feeds:
        want = [np.asarray(a) for a in jexe.run(feed=f,
                                                fetch_list=[jloss] + fetch)]
        got = texe.run(feed=f, fetch_list=[tloss] + fetch)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        untaken = ("fc_w_1", "fc_b_1") if f["p"][0] else ("fc_w_0",
                                                          "fc_b_0")
        for n, a, b in zip(params, got[1:], want[1:]):
            assert (not a.any()) == (not b.any()) == (n in untaken), n
            scale = max(float(np.abs(b).max()), 1e-30)
            assert np.abs(a - b).max() <= GRAD_TOL * scale, n
        jstate = jfluid.global_scope()
        for n, t in tfluid.global_scope().items():
            b = np.asarray(jstate.find_var(n))
            np.testing.assert_allclose(t.numpy(), b, rtol=1e-5, atol=1e-6,
                                       err_msg=n)


# ------------------------------------------------------------------ while


def _counter(fl, max_trip_count, limit=5):
    i0 = fl.layers.fill_constant([1], "int32", 0)
    s0 = fl.layers.fill_constant([1], "float32", 0.0)
    return fl.layers.while_loop(lambda i, s: (i < limit)[0],
                                lambda i, s: (i + 1, s + 2.0), [i0, s0],
                                max_trip_count=max_trip_count)


@pytest.mark.parametrize("max_trip_count", [None, 8])
def test_while_loop_counts_match_jax(max_trip_count):
    """``test_while_loop_counts`` and
    ``test_while_loop_bounded_matches_unbounded``: 5 trips, s = 10, the
    integer state equal."""
    def build(fl, v):
        return _counter(fl, max_trip_count)
    want, got, *_ = run_both(build, {})
    assert got[0].dtype == np.int32 and got[0].tolist() == [5]
    assert got[1].tolist() == [10.0]
    assert_match(want, got, [], [], [])


def test_bounded_while_loop_truncates_at_max_trip_count():
    """N is a hard bound: 3 trips where the predicate wants 5."""
    want, got, *_ = run_both(lambda fl, v: _counter(fl, 3), {})
    assert got[0].tolist() == [3] and got[1].tolist() == [6.0]
    assert_match(want, got, [], [], [])


@pytest.mark.parametrize("max_trip_count", [4, None])
def test_while_loop_grad_matches_jax(max_trip_count):
    """``test_while_loop_bounded_grad`` and
    ``test_while_loop_unbounded_grad``: an fc's output through three trips
    of s * 0.5 + tanh(s); the values and the gradients of x and the fc's
    parameters (the reference's unbounded VJP recomputes each state from
    the start, the port's tape keeps them: the same gradients)."""
    x = np.random.RandomState(2).rand(2, 3).astype(np.float32)

    def build(fl, v):
        i0 = fl.layers.fill_constant([1], "int32", 0)
        h = fl.layers.fc(v["x"], 3, act="tanh")
        tanh = _tanh(fl)
        outs = fl.layers.while_loop(
            lambda i, s: (i < 3)[0], lambda i, s: (i + 1, s * 0.5 + tanh(s)),
            [i0, h], max_trip_count=max_trip_count)
        return [outs[0], fl.layers.mean(outs[1])]
    _check(build, {"x": x})


def _while_train_program(fl, max_trip_count=None):
    L = fl.layers
    x = L.data("x", [4])
    y = L.data("y", [1])
    i0 = L.fill_constant([1], "int32", 0)
    h = L.fc(x, 8, act="tanh")
    tanh = _tanh(fl)
    outs = L.while_loop(lambda i, s: (i < 2)[0],
                        lambda i, s: (i + 1, tanh(s) * 0.9), [i0, h],
                        max_trip_count=max_trip_count)
    pred = L.fc(outs[1], 1)
    loss = L.mean(L.square_error_cost(pred, y))
    fl.optimizer.SGD(0.5).minimize(loss)
    return loss


def test_while_loop_unbounded_trains_like_jax():
    """``test_while_loop_unbounded_trains``: 15 SGD(0.5) steps through an
    unbounded while from the same weights, the losses within rtol 1e-4 of
    JAX's, and falling below 0.9 x the first."""
    rng = np.random.RandomState(0)
    x = rng.rand(8, 4).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) > 2.0).astype(np.float32)
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    jloss = _while_train_program(jfluid)
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    weights = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}
    want = [float(np.asarray(jexe.run(feed={"x": x, "y": y},
                                      fetch_list=[jloss])[0]))
            for _ in range(15)]
    tloss = _while_train_program(tfluid)
    texe = tfluid.Executor(CPU)
    texe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    got = [float(texe.run(feed={"x": x, "y": y}, fetch_list=[tloss])[0])
           for _ in range(15)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] * 0.9, got


# ------------------------------------------------------------------ IfElse


_MASK = np.array([[True], [False], [True], [False]])


def test_ifelse_partitions_batch_matches_jax():
    """``test_ifelse_partitions_batch``: x * 2 on the true rows, -x on the
    others."""
    def build(fl, v):
        ie = fl.layers.IfElse(v["p"])
        with ie.true_block():
            ie.output(fl.layers.scale(ie.input(v["x"]), 2.0))
        with ie.false_block():
            ie.output(fl.layers.scale(ie.input(v["x"]), -1.0))
        out, = ie()
        return out
    xs = np.random.RandomState(3).rand(4, 3).astype(np.float32)
    want, got, *rest = run_both(build, {"p": _MASK, "x": xs})
    assert_match(want, got, *rest, FWD_TOL, GRAD_TOL)
    np.testing.assert_allclose(got[0], np.where(_MASK, xs * 2, -xs),
                               rtol=1e-6)


def test_ifelse_closure_capture_and_identity_output_matches_jax():
    """``test_ifelse_closure_capture_and_identity_output``: a branch reads
    an outer variable without ``input()``, the other returns it
    unchanged."""
    def build(fl, v):
        ie = fl.layers.IfElse(v["p"])
        with ie.true_block():
            d = ie.input(v["x"])
            ie.output(fl.layers.elementwise_add(d, v["y"]))
        with ie.false_block():
            ie.input(v["x"])
            ie.output(v["y"])
        out, = ie()
        return out
    xs, ys = np.ones((4, 3), np.float32), np.full((4, 3), 2.0, np.float32)
    want, got, *rest = run_both(build, {"p": _MASK, "x": xs, "y": ys})
    assert_match(want, got, *rest, FWD_TOL, GRAD_TOL)
    np.testing.assert_allclose(got[0], np.where(_MASK, xs + ys, ys))


def test_ifelse_grad_through_branches_matches_jax():
    """``test_ifelse_grad_through_branches``: an fc in each branch; the
    gradients of x and of both branches' parameters."""
    def build(fl, v):
        ie = fl.layers.IfElse(v["p"])
        with ie.true_block():
            ie.output(fl.layers.fc(ie.input(v["x"]), 2, act="tanh"))
        with ie.false_block():
            ie.output(fl.layers.fc(ie.input(v["x"]), 2))
        out, = ie()
        return fl.layers.mean(out)
    _check(build, {"p": _MASK,
                   "x": np.random.RandomState(4).rand(4, 3).astype(
                       np.float32)})


def test_branch_ops_are_walked_and_cloned():
    """The op's ``sub_block`` (true branch) and ``else_block`` (false
    branch) are walked by ``Program.all_ops`` (so ``check_kernel_shapes``
    reads both) and kept by ``clone``."""
    L = tfluid.layers
    p = L.data("p", [-1], dtype="bool", append_batch_size=False)
    x = L.data("x", [3])
    L.cond(p, lambda: L.scale(x, 2.0), lambda: L.sqrt(L.fc(x, 3)))
    m = L.data("m", [1], dtype="bool")
    ie = L.IfElse(m)
    with ie.true_block():
        ie.output(L.tanh(ie.input(x)))
    with ie.false_block():
        ie.output(L.exp(ie.input(x)))
    ie()
    for prog in (tfluid.default_main_program(),
                 tfluid.default_main_program().clone()):
        types = [op.type for _, op in prog.all_ops()]
        assert types == ["cond", "scale", "mul", "elementwise_add", "sqrt",
                         "ifelse", "tanh", "exp"], types


# ------------------------------------------------------------------ warm


def _refused(kind):
    """(output, feed, expected value) of a program that reads a predicate
    on the host."""
    L = tfluid.layers
    if kind == "cond":
        x = L.data("x", [3])
        p = L.data("p", [-1], dtype="bool", append_batch_size=False)
        out = L.cond(p, lambda: L.scale(x, 2.0), lambda: L.scale(x, -1.0))
        feed = {"p": np.array([False]), "x": np.ones((2, 3), np.float32)}
        return out, feed, -np.ones((2, 3), np.float32)
    if kind == "unbounded while_loop":
        x = L.data("x", [3])
        i0 = L.fill_constant([1], "int32", 0)
        outs = L.while_loop(lambda i, s: (i < 3)[0],
                            lambda i, s: (i + 1, s * 2.0), [i0, x])
        feed = {"x": np.ones((2, 3), np.float32)}
        return outs[1], feed, 8 * np.ones((2, 3), np.float32)
    # the loop inside an RNN body: found in the static_rnn op's sub-block
    seq = L.data("seq", [2, 3])
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(seq)
        i0 = L.fill_constant([1], "int32", 0)
        outs = L.while_loop(lambda i, s: (i < 3)[0],
                            lambda i, s: (i + 1, s * 2.0), [i0, xt])
        rnn.step_output(outs[1])
    out, = rnn()
    feed = {"seq": np.ones((2, 2, 3), np.float32)}
    return out, feed, 8 * np.ones((2, 2, 3), np.float32)


@pytest.mark.parametrize("kind", ["cond", "unbounded while_loop",
                                  "unbounded while_loop in an RNN body"])
def test_warm_refuses_host_reads_before_capturing(kind):
    """``Executor.warm`` raises WarmError naming the op before it prepares
    anything (no compile, no static buffer in the scope); ``run()`` of the
    same program then runs eagerly."""
    out, feed, want = _refused(kind)
    main = tfluid.default_main_program()
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    sig = [(n, v.shape, v.dtype.name) for n, v in feed.items()]
    with pytest.raises(WarmError, match="cond|while_loop"):
        exe.warm(main, sig, [out], scope=scope)
    assert exe.compiles == 0 and scope.var_names() == []
    got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert exe.replays == 0
    np.testing.assert_array_equal(got, want)


def _bounded_while_program():
    return _while_train_program(tfluid, max_trip_count=4)


def _ifelse_program():
    L = tfluid.layers
    x = L.data("x", [4])
    y = L.data("y", [1])
    p = L.data("p", [1], dtype="bool")
    ie = L.IfElse(p)
    with ie.true_block():
        ie.output(L.fc(ie.input(x), 3, act="tanh"))
    with ie.false_block():
        ie.output(L.fc(ie.input(x), 3))
    h, = ie()
    loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
    tfluid.optimizer.Adam(0.1).minimize(loss)
    return loss


@pytest.mark.parametrize("build", [_bounded_while_program, _ifelse_program],
                         ids=["bounded while_loop", "IfElse"])
def test_warm_captures_bounded_while_and_ifelse(build):
    """The bounded loop and IfElse read nothing on the host: warmed, three
    train steps replay, their losses and every gradient, then every state
    tensor, bitwise equal to an unwarmed Executor's eager steps from the
    same weights."""
    rng = np.random.RandomState(5)
    feeds = [{"x": rng.rand(6, 4).astype(np.float32),
              "y": rng.rand(6, 1).astype(np.float32),
              "p": rng.rand(6, 1) > 0.5} for _ in range(3)]
    weights = None
    runs = []
    for warm in (True, False):
        tfluid.reset_default_programs()
        loss = build()
        main = tfluid.default_main_program()
        params = [p.name for p in main.parameters()]
        fetch = [loss] + [f"{n}@GRAD" for n in params]
        if "p" not in main.global_block.vars:
            feeds = [{k: v for k, v in f.items() if k != "p"}
                     for f in feeds]
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        if weights is None:
            weights = {n: scope.find_var(n).clone() for n in params}
        for n, w in weights.items():
            scope.set_var(n, w.clone())
        if warm:
            sig = [(n, v.shape, v.dtype.name) for n, v in feeds[0].items()]
            assert exe.warm(main, sig, fetch, scope=scope) == "compiled"
        outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
        assert exe.replays == (3 if warm else 0)
        runs.append((outs, {n: v.clone() for n, v in scope.items()}))
    (ow, sw), (oe, se) = runs
    for a, b in zip(ow, oe):
        assert [x.tobytes() for x in a] == [y.tobytes() for y in b]
    assert set(sw) == set(se) and all(torch.equal(sw[n], se[n]) for n in sw)

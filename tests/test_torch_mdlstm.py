"""paddle_tpu_torch's 2-D LSTM (``layers/mdlstm.py::md_lstm``) against the
JAX package on the CPU: ``tests/test_misc_layers.py``'s
``test_md_lstm_matches_numpy_oracle`` (the port's forward against the
per-cell numpy recurrence, from the port's own startup weights) and
``test_md_lstm_grad_and_reverse`` (here in all four sweep directions, the
values within 1e-5 of their scale and the gradients of x and of the four
parameters, by ``jax.vjp`` and torch autograd under one cotangent, within
1e-4 of each one's max abs); the parameter names and initialisers, so
that weights carry across by name; and a warmed ``md_lstm -> mean`` Adam
step bitwise equal to its eager step."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from test_torch_sequence_ops import assert_match, run_both

CPU = tfluid.CPUPlace()
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _sig(a):
    return 1.0 / (1.0 + np.exp(-a))


def test_md_lstm_matches_numpy_oracle():
    """The per-cell recurrence in numpy, from the port's startup weights
    (Xavier, bias zero): within rtol 2e-4, atol 2e-5 (the JAX test's
    limits)."""
    rng = np.random.RandomState(5)
    N, H, W, D, C = 2, 3, 4, 3, 5
    x = rng.randn(N, H, W, D).astype("float32") * 0.5
    xv = tfluid.layers.data("x", [H, W, D])
    out = tfluid.layers.md_lstm(xv, C)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    o, = exe.run(feed={"x": x}, fetch_list=[out])
    assert o.shape == (N, H, W, C)
    scope = tfluid.global_scope()
    names = [p.name for p in tfluid.default_main_program().parameters()]
    assert names == ["md_lstm_w_0", "md_lstm_w_1", "md_lstm_w_2",
                     "md_lstm_b_0"]
    w_, ul, uu, b_ = (scope.find_var(n).numpy() for n in names)
    assert not b_.any() and w_.std() > 0
    ref = np.zeros((N, H, W, C), "float32")
    cst = np.zeros((N, H, W, C), "float32")
    zeros = np.zeros((N, C), "float32")
    for i in range(H):
        for j in range(W):
            h_up = ref[:, i - 1, j] if i > 0 else zeros
            c_up = cst[:, i - 1, j] if i > 0 else zeros
            h_l = ref[:, i, j - 1] if j > 0 else zeros
            c_l = cst[:, i, j - 1] if j > 0 else zeros
            g = x[:, i, j] @ w_ + b_ + h_l @ ul + h_up @ uu
            ig, fl, fu, og, cand = np.split(g, 5, axis=-1)
            c = _sig(fl) * c_l + _sig(fu) * c_up + _sig(ig) * np.tanh(cand)
            cst[:, i, j] = c
            ref[:, i, j] = _sig(og) * np.tanh(c)
    np.testing.assert_allclose(o, ref, rtol=2e-4, atol=2e-5)


def test_md_lstm_program_matches_jax():
    """The same parameter names, shapes and initialisers' kinds (Xavier
    weights, a zero bias), so weights carry across by name."""
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.layers.md_lstm(fl.layers.data("x", [2, 3, 4]), 6)
    jp, tp = jfluid.default_main_program(), tfluid.default_main_program()
    assert [(p.name, tuple(p.shape)) for p in tp.parameters()] == [
        (p.name, tuple(p.shape)) for p in jp.parameters()]
    assert [tuple(p.shape) for p in tp.parameters()] == [
        (4, 30), (6, 30), (6, 30), (30,)]


@pytest.mark.parametrize("reverse_h,reverse_w",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_md_lstm_values_and_gradients_match_jax(reverse_h, reverse_w):
    """``test_md_lstm_grad_and_reverse`` in each sweep direction, on a
    [2, 3, 4, 3] grid to width 5, then a mean: the hidden states and the
    gradients of x and of W, U_l, U_u and b."""
    x = (np.random.RandomState(6).randn(2, 3, 4, 3) * 0.5).astype(
        np.float32)

    def build(fl, v):
        out = fl.layers.md_lstm(v["x"], 5, reverse_h=reverse_h,
                                reverse_w=reverse_w)
        return [out, fl.layers.mean(out)]
    want, got, jg, tg, names = run_both(build, {"x": x}, seed=1)
    assert_match(want, got, jg, tg, names, FWD_TOL, GRAD_TOL)
    assert sorted(names) == ["md_lstm_b_0", "md_lstm_w_0", "md_lstm_w_1",
                             "md_lstm_w_2", "x"]


def test_md_lstm_warmed_step_bitwise_equal_eager():
    """``md_lstm -> mean`` with Adam(1e-2), warmed: three steps' losses
    and gradients, then every parameter and moment, bitwise equal to an
    unwarmed Executor's eager steps from the same weights."""
    rng = np.random.RandomState(7)
    feeds = [{"x": rng.randn(2, 3, 4, 3).astype(np.float32)}
             for _ in range(3)]
    runs, weights = [], None
    for warm in (True, False):
        tfluid.reset_default_programs()
        loss = tfluid.layers.mean(tfluid.layers.md_lstm(
            tfluid.layers.data("x", [3, 4, 3]), 5, reverse_w=True))
        tfluid.optimizer.Adam(1e-2).minimize(loss)
        main = tfluid.default_main_program()
        params = [p.name for p in main.parameters()]
        fetch = [loss] + [f"{n}@GRAD" for n in params]
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        if weights is None:
            weights = {n: scope.find_var(n).clone() for n in params}
        for n, w in weights.items():
            scope.set_var(n, w.clone())
        if warm:
            assert exe.warm(main, [("x", (2, 3, 4, 3), "float32")], fetch,
                            scope=scope) == "compiled"
        outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
        assert exe.replays == (3 if warm else 0)
        runs.append((outs, {n: v.clone() for n, v in scope.items()}))
    (ow, sw), (oe, se) = runs
    for a, b in zip(ow, oe):
        assert [x.tobytes() for x in a] == [y.tobytes() for y in b]
    assert set(sw) == set(se) and all(torch.equal(sw[n], se[n]) for n in sw)

"""paddle_tpu_torch's image layers beyond conv2d and pool2d against the JAX
package on the CPU: ``conv2d_transpose`` (FCN's k4 s4 p0, k3 s2 p1, k5 s2
p2, and a padding past k - 1, where the reference's lax padding goes
negative), ``pool_with_index`` (a tie, padding, amp), ``unpool``
(overlapping windows), ``spp`` (max and avg, ragged planes), ``conv3d``
(groups) and ``pool3d`` (avg with padding, global), and ``argmax`` and the
five compares.  Each case builds the layer in both packages on the same
numpy inputs and parameters and compares the outputs within 1e-5 of their
scale (integers bitwise) and every gradient within 1e-4 of its max abs
(``run_both`` of ``test_torch_sequence_ops.py``); the JAX package cannot
differentiate ``pool_with_index`` (a reduce_window over value and index
pairs), so its gradient is held to JAX's max ``pool2d``'s.  Three cases
show where plain torch would differ: an unflipped ``F.conv_transpose2d``,
``F.max_unpool2d`` (it assigns) and ``F.adaptive_*_pool2d`` (other bin
edges)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as jfluid
from paddle_tpu.core.program import OpContext as JaxOpContext
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.program import OpContext as TorchOpContext
from test_torch_sequence_ops import assert_match, run_both

CPU = tfluid.CPUPlace()
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


def _x(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _run(fl, build, feed, amp=False):
    """``build(fl)`` (its data layers named as ``feed``'s keys) run by
    ``fl``'s Executor on the CPU from the JAX startup's parameters: the
    fetched outputs as numpy arrays."""
    fl.reset_default_programs()
    outs = build(fl)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    if amp:
        fl.amp.enable()
    exe = fl.Executor() if fl is jfluid else fl.Executor(CPU)
    exe.run(fl.default_startup_program())
    return [np.asarray(a) for a in exe.run(feed=feed, fetch_list=outs)]


# ----------------------------------------------------------- conv2d_transpose


@pytest.mark.parametrize("k,s,p", [(4, 4, 0), (3, 2, 1), (5, 2, 2),
                                   (3, 1, 3)])
def test_conv2d_transpose_matches_jax(k, s, p):
    """Values and gradients (input, filter, bias) against JAX's
    ``lax.conv_transpose``; at k3 s1 p3 the lax padding k - 1 - p is -1, a
    crop, which ``F.conv_transpose2d``'s padding past k - 1 gives too.  The
    filter unflipped, as plain ``F.conv_transpose2d`` would take it, is far
    off (by up to 11.34 at FCN's k4 s4)."""
    feeds = {"x": _x(2, 3, 6, 5)}
    res = run_both(lambda fl, v: fl.layers.conv2d_transpose(
        v["x"], 4, k, stride=s, padding=p, act="relu"), feeds, seed=k)
    want, got = res[0], res[1]
    assert got[0].shape == (2, 4, 5 * s - 2 * p + k, 4 * s - 2 * p + k)
    assert_match(*res, grad_tol=GRAD_TOL)
    # the same filter, unflipped, through F.conv_transpose2d
    rng = np.random.RandomState(k)
    w = (0.5 * rng.standard_normal((3, 4, k, k))).astype(np.float32)
    b = (0.5 * rng.standard_normal(4)).astype(np.float32)
    plain = F.relu(F.conv_transpose2d(torch.from_numpy(feeds["x"]),
                                      torch.from_numpy(w), torch.from_numpy(b),
                                      s, p)).numpy()
    assert np.abs(plain - want[0]).max() > 0.1


def test_conv2d_transpose_reference_shape_formula():
    """``tests/test_layers.py::test_conv2d_transpose_reference_shape_formula``
    in the port: out = (in - 1) * stride - 2 * pad + k, with the
    reference's parameter [in, out, kh, kw] under the reference's name."""
    cases = [(4, 4, 0, 32), (4, 2, 1, 16), (3, 1, 1, 8), (2, 2, 0, 16)]

    def build(fl):
        x = fl.layers.data("x", [3, 8, 8])
        return [fl.layers.conv2d_transpose(x, 5, k, stride=s, padding=p)
                for k, s, p, _ in cases]

    rs = _run(tfluid, build, {"x": np.zeros((2, 3, 8, 8), "float32")})
    for (k, s, p, expect), r in zip(cases, rs):
        assert r.shape == (2, 5, expect, expect), (k, s, p, r.shape)
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        build(fl)
    got = {p.name: tuple(p.shape)
           for p in tfluid.default_main_program().parameters()}
    want = {p.name: tuple(p.shape)
            for p in jfluid.default_main_program().parameters()}
    assert got == want and got["conv2d_transpose_w_0"] == (3, 5, 4, 4)


# ----------------------------------------------------------- pool_with_index


def _pwi(fl, size, stride=None, padding=0, unpool_size=None, hw=(4, 4)):
    x = fl.layers.data("x", [3, *hw])
    out, idx = fl.layers.pool_with_index(x, size, pool_stride=stride or size,
                                         pool_padding=padding)
    rec = fl.layers.unpool(out, idx, unpool_size=unpool_size or hw)
    return out, idx, rec


@pytest.mark.parametrize("size,stride,padding", [(2, 2, 0), (3, 2, 1),
                                                 (3, 1, 2)])
def test_pool_with_index_and_unpool_match_jax(size, stride, padding):
    """``tests/test_detection.py::test_pool_with_index_and_unpool``, held
    to JAX's values, int32 indices and unpooled planes at three windows
    (padding up to and past half the window); each max scattered back to
    its argmax position."""
    x = _x(2, 3, 6, 7, seed=4)
    build = lambda fl: _pwi(fl, size, stride, padding, hw=(6, 7))  # noqa
    want = _run(jfluid, build, {"x": x})
    got = _run(tfluid, build, {"x": x})
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    o, i, r = got
    np.testing.assert_allclose(r.sum((2, 3)), o.sum((2, 3)), rtol=1e-5)
    flat = x.reshape(2, 3, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, i.reshape(2, 3, -1).astype(np.int64), 2),
        o.reshape(2, 3, -1))


def test_pool_with_index_tie_takes_the_first_cell():
    """A window of equal values: the index of its first cell in window
    order, in both packages (the reference's ``pick`` keeps the earlier
    operand on ``>=``; ``F.max_pool2d`` keeps the first maximum)."""
    x = np.zeros((1, 3, 4, 4), np.float32)
    x[0, 1, :2, :2] = 1.0           # a tie of four in the first window
    x[0, 2, 2:, 2:] = [[2.0, 3.0], [3.0, 1.0]]   # a tie of two
    want = _run(jfluid, lambda fl: _pwi(fl, 2), {"x": x})
    got = _run(tfluid, lambda fl: _pwi(fl, 2), {"x": x})
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][0, 1, 0, 0] == 0 and got[1][0, 0, 1, 1] == 10
    assert got[1][0, 2, 1, 1] == 11


def test_pool_with_index_gradient_routes_as_max_pool():
    """The gradient of ``pool_with_index``'s values against JAX's max
    ``pool2d``'s at the same window, bitwise: the JAX package's own op has
    no derivative."""
    x = _x(2, 3, 6, 6, seed=5)
    cot = _x(2, 3, 3, 3, seed=6)
    jx = jnp.asarray(x)

    def jfn(a):
        env = {"x": a}
        for op in jops:
            op.apply(env, ctx)
        return env[jout.name]

    jfluid.reset_default_programs()
    xv = jfluid.layers.data("x", [3, 6, 6])
    jout = jfluid.layers.pool2d(xv, 2, "max", 2)
    jops = jfluid.default_main_program().list_ops()
    ctx = JaxOpContext(jax.random.PRNGKey(0))
    _, vjp = jax.vjp(jfn, jx)
    want = np.asarray(vjp(jnp.asarray(cot))[0])

    tfluid.reset_default_programs()
    out, _, _ = _pwi(tfluid, 2, hw=(6, 6))
    env = {"x": torch.from_numpy(x).requires_grad_(True)}
    for op in tfluid.default_main_program().list_ops():
        op.apply(env, TorchOpContext(device="cpu"))
    (g,) = torch.autograd.grad((env[out.name] * torch.from_numpy(cot)).sum(),
                               env["x"])
    np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("hw", [(16, 16), (32, 32)])
def test_pool_with_index_amp_keeps_exact_indices(hw):
    """Under amp (``pool_with_index`` is a bfloat16 op) the JAX package
    carries the flat index in bfloat16, exact up to 256: at 16 x 16 the
    two packages agree, values and indices; at 32 x 32 JAX's indices
    round (257 -> 256) and the port's stay the exact argmax,
    ``F.max_pool2d``'s."""
    x = _x(2, 3, *hw, seed=7)
    build = lambda fl: _pwi(fl, 2, hw=hw)[:2]  # noqa: E731
    want = _run(jfluid, build, {"x": x}, amp=True)
    got = _run(tfluid, build, {"x": x}, amp=True)
    np.testing.assert_array_equal(got[0].astype(np.float32),
                                  want[0].astype(np.float32))
    exact = F.max_pool2d(torch.from_numpy(x).to(torch.bfloat16), 2,
                         return_indices=True)[1].numpy()
    np.testing.assert_array_equal(got[1], exact)
    if hw[0] * hw[1] <= 256:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        wrong = got[1] != want[1]
        assert wrong.any() and (got[1][wrong] > 256).all()
        assert np.abs(got[1][wrong] - want[1][wrong]).max() <= 8


def test_unpool_adds_overlapping_windows():
    """A 3x3 stride-1 window picks one cell for several outputs; ``unpool``
    adds them there, as the reference's ``.at[i].add`` does (values and
    the gradient of its input); ``F.max_unpool2d`` keeps one of them."""
    x = _x(2, 2, 5, 5, seed=8)
    idx = _run(tfluid, lambda fl: fl.layers.pool_with_index(
        fl.layers.data("x", [2, 5, 5]), 3, pool_stride=1)[1], {"x": x})[0]
    want = _run(jfluid, lambda fl: fl.layers.pool_with_index(
        fl.layers.data("x", [2, 5, 5]), 3, pool_stride=1)[1], {"x": x})[0]
    np.testing.assert_array_equal(idx, want)
    assert any(len(set(r)) < len(r) for r in idx.reshape(4, -1).tolist())
    # unpool of y (a float feed, differentiable in JAX) at x's indices
    y = _x(2, 2, 3, 3, seed=9)
    res = run_both(lambda fl, v: fl.layers.unpool(v["y"], v["idx"],
                                                  unpool_size=(5, 5)),
                   {"y": y, "idx": idx})
    assert_match(*res, grad_tol=GRAD_TOL)
    assigned = F.max_unpool2d(torch.from_numpy(y),
                              torch.from_numpy(idx.astype(np.int64)), 3,
                              stride=1, output_size=(5, 5)).numpy()
    assert np.abs(assigned - res[1][0]).max() > 0.1


# ----------------------------------------------------------- spp, 3-D


@pytest.mark.parametrize("pool_type,levels,hw", [("max", 2, (5, 7)),
                                                 ("avg", 3, (7, 10)),
                                                 ("max", 3, (7, 10))])
def test_spp_matches_jax(pool_type, levels, hw):
    """Values and gradients on ragged planes (the last window of a level
    runs past the plane: padding at the end, -inf for max, excluded from
    the average); ``tests/test_detection.py::test_spp_fixed_length``'s
    level 0 is the plane's max.  ``F.adaptive_*_pool2d`` takes other bin
    edges and differs."""
    x = _x(2, 4, *hw, seed=5)
    res = run_both(lambda fl, v: fl.layers.spp(v["x"], levels, pool_type),
                   {"x": x})
    assert_match(*res, grad_tol=GRAD_TOL)
    got = res[1][0]
    assert got.shape == (2, 4 * sum(4 ** i for i in range(levels)))
    if pool_type == "max":
        np.testing.assert_allclose(got[:, :4], x.max((2, 3)), rtol=1e-6)
    ada = (F.adaptive_max_pool2d if pool_type == "max"
           else F.adaptive_avg_pool2d)(torch.from_numpy(x), 2).reshape(2, -1)
    assert np.abs(ada.numpy() - got[:, 4:20]).max() > 1e-3


def test_conv3d_pool3d_match_jax():
    """``tests/test_detection.py::test_conv3d_pool3d`` held to JAX's values
    and gradients: conv3d with groups 2 and padding, pool3d max, avg with
    padding (the real cells only) and global."""
    x = _x(2, 4, 4, 6, 6, seed=6)

    def build(fl, v):
        y = fl.layers.conv3d(v["x"], 6, 3, padding=1, groups=2, act="relu")
        return [fl.layers.pool3d(y, 2, pool_stride=2),
                fl.layers.pool3d(y, 3, "avg", pool_stride=2, pool_padding=1),
                fl.layers.pool3d(y, 2, "avg", global_pooling=True)]

    res = run_both(build, {"x": x})
    assert_match(*res, grad_tol=GRAD_TOL)
    assert [a.shape for a in res[1]] == [(2, 6, 2, 3, 3), (2, 6, 2, 3, 3),
                                         (2, 6, 1, 1, 1)]
    # the JAX conv3d's parameters: [O, C / groups, k, k, k] and [O]
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.layers.conv3d(fl.layers.data("x", [4, 4, 6, 6]), 6, 3, groups=2)
    shapes = [{p.name: tuple(p.shape) for p in fl.default_main_program()
               .parameters()} for fl in (jfluid, tfluid)]
    assert shapes[0] == shapes[1] == {"conv3d_w_0": (6, 2, 3, 3, 3),
                                      "conv3d_b_0": (6,)}


# ----------------------------------------------------------- argmax, compares


def test_argmax_and_compares_match_jax():
    """``argmax`` (the first maximum among ties) and the five compares
    against a Variable and a Python scalar, bitwise; ``cast`` of a bool to
    float32 and its mean, as FCN's pixel accuracy takes them (within 1e-6:
    the mean sums in another order)."""
    x = np.round(_x(3, 4, 5, seed=10), 1)
    x[0, 0, :2] = 9.0                       # a tie: the first wins
    y = np.round(_x(3, 4, 5, seed=11), 1)
    y[1] = x[1]                             # equal rows

    def build(fl):
        a = fl.layers.data("x", [4, 5])
        b = fl.layers.data("y", [4, 5])
        L = fl.layers
        outs = [L.argmax(a, axis=-1), L.argmax(a, axis=1)]
        for f in (L.less_than, L.less_equal, L.greater_than, L.equal,
                  L.not_equal):
            outs += [f(a, b), f(a, 0.5)]
        outs.append(L.mean(L.cast(L.equal(a, b), "float32")))
        return outs

    want = _run(jfluid, build, {"x": x, "y": y})
    got = _run(tfluid, build, {"x": x, "y": y})
    for a, b in zip(got[:-1], want[:-1]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-6)
    assert got[0].dtype == np.int64 and got[2].dtype == np.bool_
    assert got[0][0, 0] == 0

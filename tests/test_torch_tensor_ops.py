"""paddle_tpu_torch's dense tensor layers against the JAX package on the
CPU: ``elementwise_sub`` / ``mul`` / ``div`` / ``pow`` / ``max`` / ``min``
(same shapes, Fluid's ``axis`` mid-broadcast, a Python scalar; max and
min with exact ties, whose gradient both packages split in half),
``matmul`` (transposes, ``alpha``, batched and broadcast), ``mul``
(``x_num_col_dims`` / ``y_num_col_dims``), ``transpose``, ``split`` (equal
parts and sections), ``stack``, ``squeeze`` and ``unsqueeze`` (axes given
out of order: inserted in sorted order).  Each case runs through
``run_both`` (``test_torch_sequence_ops.py``): the forward within 1e-5 of
max(1, max abs), and the gradient of every float input and parameter
under one numpy cotangent within 1e-5 of its max abs."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from test_torch_sequence_ops import assert_match, run_both


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run: the suite's workers
    share the host's cores, and torch's thread pool on many small ops
    under that contention runs tens of times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(*shape, seed=0, low=None):
    rng = np.random.RandomState(seed)
    if low is not None:
        return rng.uniform(low, low + 1.5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _ties(seed):
    """x and y [4, 6] equal in every other column."""
    x, y = _x(4, 6, seed=seed), _x(4, 6, seed=seed + 1)
    y[:, ::2] = x[:, ::2]
    return {"x": x, "y": y}


ELEMENTWISE = ("sub", "mul", "div", "pow", "max", "min")


def _feeds(op, case):
    base = 0.5 if op in ("pow", "div") else None
    x = _x(3, 4, 5, seed=1, low=base)
    if case == "same":
        return {"x": x, "y": _x(3, 4, 5, seed=2, low=base)}
    if case == "axis":       # a y [4], aligned at axis 1 of x [3, 4, 5]
        return {"x": x, "w": _x(4, seed=3, low=base)}
    if case == "ties":
        f = _ties(4)
        if base is not None:
            f = {k: np.abs(v) + 0.5 for k, v in f.items()}
        return f
    return {"x": x}


@pytest.mark.parametrize("case", ["same", "axis", "scalar", "ties"])
@pytest.mark.parametrize("op", ELEMENTWISE)
def test_elementwise_matches_jax(op, case):
    feeds = _feeds(op, case)
    params = {"w": feeds.pop("w")} if case == "axis" else {}

    def build(fl, v):
        layer = getattr(fl.layers, f"elementwise_{op}")
        if case == "scalar":
            return layer(v["x"], 1.7)
        if case == "axis":
            # y declared [4] without a batch dim
            w = fl.layers.data("w", [4], append_batch_size=False)
            return layer(v["x"], w, axis=1)
        return layer(v["x"], v["y"])

    assert_match(*run_both(build, feeds, seed=5, params=params))


MATMUL_CASES = {   # (x shape, y shape, transpose_x, transpose_y, alpha)
    "plain": ((3, 4, 5), (3, 5, 6), False, False, 1.0),
    "trans_x": ((3, 5, 4), (3, 5, 6), True, False, 1.0),
    "trans_y_alpha": ((3, 4, 5), (3, 6, 5), False, True, 0.5),
    "both": ((3, 5, 4), (3, 6, 5), True, True, 2.0),
    "broadcast": ((3, 2, 4, 5), (3, 5, 6), False, False, 1.0),
}


@pytest.mark.parametrize("case", sorted(MATMUL_CASES))
def test_matmul_matches_jax(case):
    """matmul of two fed tensors; "broadcast": x [3, 2, 4, 5] times a
    [5, 6] y declared without a batch dim."""
    xs, ys, tx, ty, alpha = MATMUL_CASES[case]
    feeds, params = {"x": _x(*xs, seed=6)}, {}
    if case == "broadcast":
        params["w"] = _x(*ys[1:], seed=7)
    else:
        feeds["y"] = _x(*ys, seed=7)

    def build(fl, v):
        y = (fl.layers.data("w", list(ys[1:]), append_batch_size=False)
             if case == "broadcast" else v["y"])
        return fl.layers.matmul(v["x"], y, tx, ty, alpha)

    assert_match(*run_both(build, feeds, params=params))


@pytest.mark.parametrize("x_cols,y_cols", [(1, 1), (2, 1), (1, 2)])
def test_mul_matches_jax(x_cols, y_cols):
    """mul of x [3, 4, 6] flattened at x_num_col_dims and y ([24, 5],
    [6, 5] or [4, 6, 5]) flattened at y_num_col_dims."""
    yshape = {(1, 1): (24, 5), (2, 1): (6, 5), (1, 2): (4, 6, 5)}[
        (x_cols, y_cols)]
    feeds = {"x": _x(3, 4, 6, seed=8)}
    params = {"w": _x(*yshape, seed=9)}

    def build(fl, v):
        w = fl.layers.data("w", list(yshape), append_batch_size=False)
        return fl.layers.mul(v["x"], w, x_num_col_dims=x_cols,
                             y_num_col_dims=y_cols)

    assert_match(*run_both(build, feeds, params=params))


def test_shape_ops_match_jax():
    """transpose, stack, squeeze, unsqueeze (axes [3, 1]: sorted first)
    and split into equal parts, on one input through an fc."""
    feeds = {"x": _x(2, 3, 4, seed=10)}

    def build(fl, v):
        L = fl.layers
        h = L.fc(v["x"], 4, num_flatten_dims=2)             # [2, 3, 4]
        t = L.transpose(h, [2, 0, 1])                       # [4, 2, 3]
        s = L.stack([h, v["x"]], axis=1)                    # [2, 2, 3, 4]
        u = L.unsqueeze(h, [3, 1])                          # [2, 1, 3, 1, 4]
        q = L.squeeze(u, [1, 3])                            # [2, 3, 4]
        a, b = L.split(h, 2, dim=-1)
        return [t, s, u, q, a, b]

    want, got, *rest = run_both(build, feeds, seed=11)
    assert [g.shape for g in got] == [(4, 2, 3), (2, 2, 3, 4),
                                      (2, 1, 3, 1, 4), (2, 3, 4), (2, 3, 2),
                                      (2, 3, 2)]
    assert_match(want, got, *rest)


def test_split_refuses_unequal_parts_and_squeeze_a_wide_axis():
    """split into 3 of a dim of 4, and squeeze of an axis of size 3,
    raise at build time, as jnp.split and jnp.squeeze raise."""
    x = tfluid.layers.data("x", [3, 4])
    with pytest.raises(ValueError, match="equal parts"):
        tfluid.layers.split(x, 3, dim=2)
    with pytest.raises(ValueError, match="size 1"):
        tfluid.layers.squeeze(x, [1])


def test_assign_writes_into_output():
    """``assign(x, output=v)`` writes into ``v``: the op's output is ``v``
    itself (its name), holding the copy of an fc's output, and a numpy
    constant assigned into a second Variable, as in the JAX package; the
    gradient reaches the fc's weights through ``v``."""
    feeds = {"x": _x(3, 4, seed=12)}
    const = _x(3, 2, seed=13)

    def build(fl, v):
        L = fl.layers
        h = L.fc(v["x"], 5)
        into = L.fill_constant([3, 5], "float32", 0.0)
        got = L.assign(h, output=into)
        assert got is into or got.name == into.name
        held = L.fill_constant([3, 2], "float32", 7.0)
        got_c = L.assign(const, output=held)
        assert got_c.name == held.name
        return [L.scale(into, 2.0), held]

    want, got, *rest = run_both(build, feeds, seed=14)
    np.testing.assert_array_equal(got[1], const)
    assert_match(want, got, *rest)


def test_cond_compare_is_public():
    """``layers.cond_compare(name, fn)`` makes a compare layer, public in
    both packages: one built from ``torch.ge`` (``jnp.greater_equal`` in
    the JAX package) against a Variable and against a scalar matches the
    reference's."""
    import jax.numpy as jnp

    assert tfluid.layers.cond_compare is tfluid.layers.tensor.cond_compare
    feeds = {"x": _x(4, 6, seed=15), "y": _x(4, 6, seed=16)}
    feeds["y"][:, ::3] = feeds["x"][:, ::3]          # ties count as >=

    def build(fl, v):
        fn = torch.ge if fl is tfluid else jnp.greater_equal
        ge = fl.layers.cond_compare("greater_equal", fn)
        assert ge.__name__ == "greater_equal"
        return [ge(v["x"], v["y"]), ge(v["x"], 0.25)]

    want, got, *rest = run_both(build, feeds, seed=17)
    assert got[0].dtype == np.bool_ and got[0][:, ::3].all()
    assert 0 < got[1].sum() < got[1].size
    assert_match(want, got, *rest)

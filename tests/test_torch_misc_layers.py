"""The misc layers (``layers/misc.py``, all 16) and the Variable operator
sugar, paddle_tpu_torch against the JAX package on the CPU.

Each case of ``tools/layer_cases.py``'s ``MISC_CASES`` and ``SUGAR_CASES``
is built in both packages on the same numpy inputs and parameters and its
ops run directly (``run_both``, ``test_torch_sequence_ops.py``): the
forward within 1e-5 of max(1, max |JAX's|), integer outputs bitwise, and
the gradient of every float input and parameter under one numpy cotangent
within 1e-5 of its max abs.  Then: the sugar's op lists equal the
reference's, a scalar ``/`` and ``-`` bitwise the reference's (two
roundings, not one division), ``[]`` clamped as JAX clamps (where torch
raises), ``Print`` eager on every run and refused by ``warm``, the
reference's own misc-layer checks (``tests/test_misc_layers.py`` less
md_lstm, which an earlier slice ported) and ``tests/test_layers.py:155``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.tools.layer_cases import (MISC_CASES, SUGAR_CASES, X,
                                                _r)
from test_torch_sequence_ops import assert_match, run_both


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run (the suite's workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(MISC_CASES))
def test_misc_layer_matches_jax(case):
    build, feeds = MISC_CASES[case]
    assert_match(*run_both(build, feeds, seed=5))


@pytest.mark.parametrize("case", sorted(SUGAR_CASES))
def test_sugar_matches_jax(case):
    build, feeds = SUGAR_CASES[case]
    assert_match(*run_both(build, feeds, seed=5))


def _op_types(fl, build, feeds):
    fl.reset_default_programs()
    from paddle_tpu_torch.tools.layer_cases import _data_vars

    build(fl, _data_vars(fl, feeds))
    return [op.type for op in fl.default_main_program().list_ops()]


@pytest.mark.parametrize("case", sorted(SUGAR_CASES))
def test_sugar_builds_the_reference_op_list(case):
    build, feeds = SUGAR_CASES[case]
    assert _op_types(tfluid, build, feeds) == _op_types(jfluid, build, feeds)


@pytest.mark.parametrize("case", ["sugar_rdiv", "sugar_rsub"])
def test_scalar_div_and_sub_are_bitwise_the_reference(case):
    """``7 / x`` is ``elementwise_pow(x, -1.0) * 7`` and ``3 - x`` is
    ``scale(x, -1.0, bias=3)`` in both packages: bitwise equal, and for
    the division two roundings, which differ from ``7 / x`` itself."""
    build, feeds = SUGAR_CASES[case]
    want, got, *_ = run_both(build, feeds, seed=5)
    np.testing.assert_array_equal(got[0], want[0])
    x = feeds["x"]
    if case == "sugar_rdiv":
        assert (got[0] != np.float32(7.0) / x).any()
        three = np.full((1, 1), 3.0, np.float32)
        got3, = run_both(lambda fl, v: 7.0 / v["x"], {"x": three})[1]
        assert got3[0, 0] == np.float32(2.3333335)


def test_getitem_clamps_where_torch_raises():
    """``x[:, 10]`` of a [4, 6] input reads the last column and
    ``x[:, -10]`` the first (JAX's clamp), and neither passes a gradient
    back (JAX's gather transpose drops a clamped index); torch raises on
    both.  ``x[:, -1]`` wraps once and passes its gradient to the last
    column only."""
    x = X["x"]
    want, got, jg, tg, names = run_both(
        lambda fl, v: [v["x"][:, 10], v["x"][:, -10]], {"x": x}, seed=2)
    np.testing.assert_array_equal(got[0], x[:, 5])
    np.testing.assert_array_equal(got[1], x[:, 0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        torch.from_numpy(x)[:, 10]
    assert (tg[0] == 0).all() and (jg[0] == 0).all()
    want, got, jg, tg, names = run_both(lambda fl, v: v["x"][:, -1],
                                        {"x": x}, seed=2)
    np.testing.assert_array_equal(got[0], x[:, 5])
    assert (tg[0][:, :5] == 0).all() and (tg[0][:, 5] != 0).all()
    np.testing.assert_allclose(tg[0], jg[0], rtol=0, atol=1e-6)


def test_sugar_without_layers_raises_the_reference_type_error():
    from paddle_tpu_torch.core.program import Variable

    tfluid.reset_default_programs()
    x = tfluid.layers.data("x", [4])
    hooks = dict(Variable._math_hook)
    Variable._math_hook.clear()
    try:
        with pytest.raises(TypeError, match="requires paddle_tpu_torch.layers"):
            x + x
    finally:
        Variable._math_hook.update(hooks)


def _cpu_run(fetches, feed, program=None):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    return exe.run(program, feed=feed, fetch_list=fetches, scope=scope), scope


def test_variable_operator_sugar_reference_case():
    """``tests/test_layers.py:155`` mirrored."""
    tfluid.reset_default_programs()
    x = tfluid.layers.data("x", [4])
    y = tfluid.layers.data("y", [4])
    z = (x + y) * x - y
    rng = np.random.RandomState(7)
    xs = rng.rand(2, 4).astype("float32")
    ys = rng.rand(2, 4).astype("float32")
    (r,), _ = _cpu_run([z], {"x": xs, "y": ys})
    np.testing.assert_allclose(r, (xs + ys) * xs - ys, rtol=1e-5)


def test_print_prints_each_run_and_warm_refuses_it(capsys):
    """``Print`` passes its input through and prints on every run, its
    message plain text (braces and all); ``Executor.warm`` refuses the
    program before any capture, and ``run()`` still runs it."""
    from paddle_tpu_torch.core.graphs import WarmError

    tfluid.reset_default_programs()
    x = np.array([[1.0, 2.0]], "float32")
    xv = tfluid.layers.data("x", [2])
    p = tfluid.layers.Print(xv, message="it{e}r{0}")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    for _ in range(2):
        out, = exe.run(feed={"x": x}, fetch_list=[p], scope=scope)
        np.testing.assert_allclose(out, x)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("it{e}r{0} shape=(1, 2)")]
    assert len(lines) == 2, lines
    with pytest.raises(WarmError, match="Print"):
        exe.warm(tfluid.default_main_program(), [("x", (1, 2), "float32")],
                 [p], scope=scope)
    assert exe.compiles == 0


def test_cos_sim_vec_mat_reference_values():
    rng = np.random.RandomState(0)
    v = rng.randn(3, 4).astype("float32")
    m = rng.randn(3, 8).astype("float32")
    tfluid.reset_default_programs()
    out = tfluid.layers.cos_sim_vec_mat(tfluid.layers.data("v", [4]),
                                        tfluid.layers.data("m", [8]))
    (o,), _ = _cpu_run([out], {"v": v, "m": m})
    rows = m.reshape(3, 2, 4)
    ref = np.einsum("nd,nkd->nk", v, rows) / (
        np.linalg.norm(v, axis=-1, keepdims=True)
        * np.linalg.norm(rows, axis=-1))
    np.testing.assert_allclose(o, ref, rtol=1e-5)


def test_cross_channel_norm_unit_scale_and_data_norm():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 4, 4).astype("float32")
    tfluid.reset_default_programs()
    out = tfluid.layers.cross_channel_norm(tfluid.layers.data("x", [3, 4, 4]))
    (o,), _ = _cpu_run([out], {"x": x})
    np.testing.assert_allclose(np.sum(o ** 2, axis=1), np.ones((2, 4, 4)),
                               rtol=1e-4)
    tfluid.reset_default_programs()
    xv = tfluid.layers.data("x", [2])
    z = tfluid.layers.data_norm(xv, "z-score", mean=[2.0, 20.0],
                                std=[1.0, 10.0])
    mm = tfluid.layers.data_norm(xv, "min-max", min_val=[1.0, 10.0],
                                 max_val=[3.0, 30.0])
    (zo, mo), _ = _cpu_run([z, mm], {"x": np.array([[1.0, 10.0],
                                                    [3.0, 30.0]], "float32")})
    np.testing.assert_allclose(zo, [[-1, -1], [1, 1]], atol=1e-6)
    np.testing.assert_allclose(mo, [[0, 0], [1, 1]], atol=1e-6)
    with pytest.raises(ValueError, match="max_val"):
        tfluid.layers.data_norm(xv, "decimal-scaling")


def test_eos_featuremap_outer_prod_reference_values():
    tfluid.reset_default_programs()
    iv = tfluid.layers.data("ids", [1], dtype="int32")
    xv = tfluid.layers.data("x", [2])
    yv = tfluid.layers.data("y", [3])
    outs = [tfluid.layers.eos_check(iv, eos_id=1),
            tfluid.layers.featuremap_expand(xv, 3),
            tfluid.layers.outer_prod(xv, yv)]
    (eo, fo, oo), _ = _cpu_run(outs, {
        "ids": np.array([[1], [7], [1]], "int32"),
        "x": np.array([[1.0, 2.0]], "float32"),
        "y": np.array([[3.0, 4.0, 5.0]], "float32")})
    np.testing.assert_allclose(eo, [[1], [0], [1]])
    np.testing.assert_allclose(fo, [[1, 2, 1, 2, 1, 2]])
    np.testing.assert_allclose(oo, [[3, 4, 5, 6, 8, 10]])


def test_factorization_machine_matches_pairwise():
    x = np.random.RandomState(2).randn(4, 5).astype("float32")
    tfluid.reset_default_programs()
    out = tfluid.layers.factorization_machine(
        tfluid.layers.data("x", [5]), 3,
        param_attr=tfluid.ParamAttr(name="fm_v"))
    (o,), scope = _cpu_run([out], {"x": x})
    v = scope.find_var("fm_v").numpy()
    ref = np.zeros((4, 1), "float32")
    for i in range(5):
        for j in range(i + 1, 5):
            ref[:, 0] += v[i] @ v[j] * x[:, i] * x[:, j]
    np.testing.assert_allclose(o, ref, rtol=1e-4, atol=1e-5)


def test_kmax_seq_score_masks_padding_and_orders_ties():
    """The reference's case, then ties: the lower index first, the masked
    tail (k past the length) in index order, int32."""
    tfluid.reset_default_programs()
    sv = tfluid.layers.data("s", [4])
    lv = tfluid.layers.data("ln", [-1], dtype="int32",
                            append_batch_size=False)
    out = tfluid.layers.kmax_seq_score(sv, lv, k=2)
    s = np.array([[0.1, 0.9, 0.5, 0.7], [0.8, 0.2, 0.3, 0.95]], "float32")
    (o,), _ = _cpu_run([out], {"s": s, "ln": np.array([3, 2], "int32")})
    np.testing.assert_array_equal(o, [[1, 2], [0, 1]])
    assert o.dtype == np.int32
    from paddle_tpu_torch.tools.layer_cases import run_case

    (o,), _, _ = run_case("kmax_seq_score", "cpu")
    assert o.tolist() == [[1, 3, 4, 2], [4, 5, 0, 2], [0, 1, 2, 3],
                          [1, 2, 0, 3]]


def test_rotate_sequence_reshape_scale_shift_l2_and_sub_region():
    x = np.arange(6, dtype="float32").reshape(1, 1, 2, 3)
    tfluid.reset_default_programs()
    r = tfluid.layers.rotate(tfluid.layers.data("x", [1, 2, 3]))
    (ro,), _ = _cpu_run([r], {"x": x})
    np.testing.assert_allclose(ro[0, 0], np.rot90(x[0, 0]))
    tfluid.reset_default_programs()
    q = np.arange(12, dtype="float32").reshape(1, 2, 6)
    qv = tfluid.layers.data("q", [2, 6])
    outs = [tfluid.layers.sequence_reshape(qv, 4),
            tfluid.layers.scale_shift(qv)]
    (so, sso), _ = _cpu_run(outs, {"q": q})
    np.testing.assert_allclose(so, q.reshape(1, 3, 4))
    np.testing.assert_allclose(sso, q, atol=1e-6)    # init w = 1, b = 0
    tfluid.reset_default_programs()
    xs = np.random.RandomState(3).randn(2, 6).astype("float32")
    (n,), _ = _cpu_run([tfluid.layers.l2_normalize(
        tfluid.layers.data("x", [6]))], {"x": xs})
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), [1, 1], rtol=1e-5)
    tfluid.reset_default_programs()
    out = tfluid.layers.scale_sub_region(
        tfluid.layers.data("img", [2, 3, 3]),
        tfluid.layers.data("idx", [6], dtype="int32"), 2.0)
    (o,), _ = _cpu_run([out], {"img": np.ones((1, 2, 3, 3), "float32"),
                               "idx": np.array([[1, 1, 1, 2, 1, 2]],
                                               "int32")})
    assert o[0, 0, :2, :2].sum() == 8.0 and o[0, 1].sum() == 9.0
    assert o[0, 0, 2, :].sum() == 3.0


def test_dot_prod_and_cross_entropy_over_beam_oracle():
    """``dot_prod`` against numpy, and the beam loss against the
    reference test's numpy oracle: the appended gold-score candidate
    competes on dropped steps only."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(3, 5).astype("float32"), rng.randn(3, 5).astype("float32")
    tfluid.reset_default_programs()
    out = tfluid.layers.dot_prod(tfluid.layers.data("x", [5]),
                                 tfluid.layers.data("y", [5]))
    (r,), _ = _cpu_run([out], {"x": a, "y": b})
    np.testing.assert_allclose(r, np.sum(a * b, 1, keepdims=True), rtol=1e-5)

    N, S, W = 4, 3, 5
    tfluid.reset_default_programs()
    loss = tfluid.layers.cross_entropy_over_beam(
        tfluid.layers.data("sc", [S, W]),
        tfluid.layers.data("gd", [S], dtype="int32"),
        gold_score=tfluid.layers.data("gs", [S]))
    rng = np.random.RandomState(1)
    scores = rng.randn(N, S, W).astype("float32")
    gold = rng.randint(0, W, (N, S)).astype("int32")
    gold[0, 1] = -1
    gscore = rng.randn(N, S).astype("float32")
    (lv,), _ = _cpu_run([loss], {"sc": scores, "gd": gold, "gs": gscore})
    col = np.where(gold < 0, gscore, -1e30)
    aug = np.concatenate([scores, col[..., None]], -1)
    tgt = np.where(gold < 0, W, gold)
    mx = aug.max(-1, keepdims=True)
    lp = aug - mx - np.log(np.sum(np.exp(aug - mx), -1, keepdims=True))
    ce = -np.take_along_axis(lp, tgt[..., None], -1)[..., 0]
    np.testing.assert_allclose(float(lv), float(np.mean(ce.sum(-1))),
                               rtol=1e-5)


def test_factorization_machine_gradient_against_finite_differences():
    """The reference's ``check_grad`` of the FM layer, here
    ``torch.autograd.gradcheck`` on float64 tensors through its op."""
    from paddle_tpu_torch.core.program import OpContext

    tfluid.reset_default_programs()
    out = tfluid.layers.factorization_machine(tfluid.layers.data("x", [5]), 3)
    op, = tfluid.default_main_program().list_ops()
    rng = np.random.RandomState(2)
    names = [op.inputs["X"][0], op.inputs["V"][0]]

    def f(xv, vv):
        env = {names[0]: xv, names[1]: vv}
        op.apply(env, OpContext(device="cpu"))
        return env[out.name]

    ins = [torch.from_numpy(rng.randn(4, 5)).requires_grad_(True),
           torch.from_numpy(rng.randn(5, 3)).requires_grad_(True)]
    assert torch.autograd.gradcheck(f, ins, eps=1e-6, atol=1e-7)


def test_misc_names_match_the_reference():
    """``layers/misc.py``'s 16 public names equal the reference's, and the
    package's ``layers`` exports each."""
    import importlib

    def public(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and callable(v)
                and getattr(v, "__module__", None) == mod.__name__}

    ref = importlib.import_module("paddle_tpu.layers.misc")
    port = importlib.import_module("paddle_tpu_torch.layers.misc")
    assert public(ref) == public(port) and len(public(port)) == 16
    assert set(port.__all__) == public(port)
    for name in public(port):
        assert hasattr(tfluid.layers, name), name


def test_getitem_array_index_and_negative_step_against_numpy():
    """Integer-array indices wrap a negative once and clamp, a slice with a
    negative step reads as Python's."""
    x = _r(4, 6, seed=60)
    _, got, *_ = run_both(lambda fl, v: [v["x"][:, np.array([0, 9, -1, -9])],
                                         v["x"][::-1, 5:0:-2]], {"x": x})
    np.testing.assert_array_equal(got[0], x[:, [0, 5, 5, 0]])
    np.testing.assert_array_equal(got[1], x[::-1, 5:0:-2])

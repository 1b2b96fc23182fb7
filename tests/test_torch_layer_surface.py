"""The rest of the layer surface, paddle_tpu_torch against the JAX package
on the CPU: the 14 activations of ``layers/ops.py`` that take attributes
(and ``prelu``), the 21 names of ``layers/tensor.py`` and the 30 of
``layers/nn.py`` that earlier slices left.  Each case builds the layer in
both packages on the same numpy inputs and parameters and runs its ops
directly (``run_both``, ``test_torch_sequence_ops.py``): the forward within
1e-5 of max(1, max |JAX's|), integer outputs bitwise, and the gradient of
every float input and parameter under one numpy cotangent within 1e-5 of
its max abs.  The random layers (``gaussian_random``, ``uniform_random``,
``sampling_id``, ``nce``) draw from the Executor's key of one (seed,
step) in both packages.  Then: the public names of the three modules
against the reference's, ``fc(act=...)`` with an attribute activation,
the attribute protos in ``core/op_info.py``, and the JAX/torch
differences the port takes JAX's side of (crop's clamp, gather's NaN fill,
multiplex's clamp, one_hot's zero row, scatter's last write, top_k's tie
order, bilinear_interp both ways)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.tools.layer_cases import (ACT_CASES, CASES, NN_CASES,
                                                RANDOM, STEP_KEY,
                                                TENSOR_CASES, X, _r)
from test_torch_sequence_ops import assert_match, run_both


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run (the suite's workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(case):
    build, feeds = CASES[case]
    key = STEP_KEY if case in RANDOM else None
    return run_both(build, feeds, seed=5, step_key=key)


@pytest.mark.parametrize("case", sorted(ACT_CASES))
def test_activation_matches_jax(case):
    assert_match(*_run(case))


def _int64_indices(want):
    """``top_k``'s indices are int64 in the port; JAX's ``astype(int64)``
    gives int32 in its default 32-bit mode."""
    return [w.astype(np.int64) if w.dtype == np.int32 else w for w in want]


@pytest.mark.parametrize("case", sorted(set(TENSOR_CASES) - {"gather"}))
def test_tensor_layer_matches_jax(case):
    want, *rest = _run(case)
    if case.startswith("top_k"):
        assert rest[0][1].dtype == np.int64
        want = _int64_indices(want)
    assert_match(want, *rest)


def test_gather_fills_out_of_range_rows_as_jax():
    """``jnp.take``: -1 reads the last row, 3 and -4 are in range, and an
    index outside [-n, n) gives a NaN row with no gradient (an int x's
    fill is its most negative value)."""
    feeds = {"x": _r(4, 6, seed=1), "i": np.array([0, 3, -1, 5, -5],
                                                  np.int32)}
    want, got, jg, tg, names = run_both(
        lambda fl, v: fl.layers.gather(v["x"], v["i"]), feeds)
    np.testing.assert_array_equal(got[0], want[0])
    assert np.isnan(got[0][3:]).all() and np.isfinite(got[0][:3]).all()
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert_match(*_run("gather"))
    xi = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    from paddle_tpu_torch.core.program import OpContext

    tfluid.reset_default_programs()
    x = tfluid.layers.data("x", [3], dtype="int32")
    i = tfluid.layers.data("i", [-1], dtype="int32", append_batch_size=False)
    out = tfluid.layers.gather(x, i)
    env = {"x": xi, "i": torch.tensor([1, 7], dtype=torch.int32)}
    for op in tfluid.default_main_program().list_ops():
        op.apply(env, OpContext(device="cpu"))
    assert env[out.name][1].tolist() == [torch.iinfo(torch.int32).min] * 3


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_nn_layer_matches_jax(case):
    assert_match(*_run(case))


def test_run_case_rehearses_the_chip_harness():
    """``tools/layer_cases.run_case``, which the chip script runs on the
    card and on the CPU, gives every case's port outputs (JAX's values,
    as above: checked here on three) and a gradient per float input."""
    from paddle_tpu_torch.tools.layer_cases import run_case

    for case in sorted(CASES):
        outs, grads, names = run_case(case, "cpu")
        assert len(grads) == len(names)
        assert all(np.isfinite(g).all() for g in grads), case
    for case in ("nce", "bilinear_interp_down", "scatter"):
        want, got, *_ = _run(case)
        outs, _, _ = run_case(case, "cpu")
        for a, b in zip(outs, got):
            np.testing.assert_array_equal(a, b)


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("module,count", [("ops", 38), ("tensor", 56),
                                          ("nn", 48), ("misc", 16)])
def test_public_layer_names_match_the_reference(module, count):
    """Every function a module of the reference defines (its imports left
    out: the ops module's 40 names count ``LayerHelper`` and
    ``annotations``) is defined by the port's module and exported by
    ``layers``."""
    import importlib

    ref = importlib.import_module(f"paddle_tpu.layers.{module}")
    port = importlib.import_module(f"paddle_tpu_torch.layers.{module}")
    assert _public(ref) == _public(port)
    assert len(_public(port)) == count
    exported = set(port.__all__) | {"cond_compare"}
    assert _public(port) <= exported
    for name in _public(port):
        assert hasattr(tfluid.layers, name), name


def test_attribute_activations_register_their_protos():
    """Each activation with attributes is registered in ``op_info`` with
    its attributes, types and defaults, as the reference registers it; a
    layer that passes none records none."""
    from paddle_tpu.core import op_info as jinfo
    from paddle_tpu_torch.core import op_info as tinfo

    for name in ("leaky_relu", "elu", "relu6", "pow", "stanh", "brelu",
                 "soft_relu", "softshrink", "hard_shrink",
                 "thresholded_relu", "hard_sigmoid", "swish", "sigmoid"):
        jp, tp = jinfo.get(name), tinfo.get(name)
        assert tp is not None and not tp.inferred, name
        assert tp.to_string() == jp.to_string(), name
    tfluid.reset_default_programs()
    x = tfluid.layers.data("x", [4])
    tfluid.layers.leaky_relu(x)
    tfluid.layers.stanh(x, scale_b=2.0)
    ops = tfluid.default_main_program().list_ops()
    assert [op.attrs for op in ops[-2:]] == [{}, {"scale_b": 2.0}]


def test_fc_takes_an_attribute_activation_with_its_default():
    """``fc(act="leaky_relu")`` appends the activation with alpha 0.02, as
    the GAN's discriminator builds it."""
    x = _r(5, 4, seed=40)
    want, *rest = run_both(
        lambda fl, v: fl.layers.fc(v["x"], 3, act="leaky_relu"), {"x": x})
    assert_match(want, *rest)
    tfluid.reset_default_programs()
    v = tfluid.layers.data("x", [4])
    tfluid.layers.fc(v, 3, act="leaky_relu")
    assert tfluid.default_main_program().list_ops()[-1].type == "leaky_relu"


def test_crop_clamps_its_offsets_as_dynamic_slice():
    """Offsets (3, 5) for a 3 x 4 slice of a 4 x 6 input read at (1, 2),
    where torch slicing would give a short slice."""
    want, got, *_ = _run("crop_clamped")
    x = X["x"]
    np.testing.assert_array_equal(got[0], x[1:4, 2:6])
    np.testing.assert_array_equal(want[0], x[1:4, 2:6])


def test_scatter_keeps_the_last_write_of_a_repeated_index():
    """Index 1 written three times keeps update 4 (the last), -1 writes
    row 3 and 9 is dropped, in both packages."""
    want, got, *_ = _run("scatter")
    u, x = TENSOR_CASES["scatter"][1]["u"], X["x"]
    expect = x.copy()
    expect[1], expect[3] = u[4], u[3]
    np.testing.assert_array_equal(want[0], expect)
    np.testing.assert_array_equal(got[0], expect)


def test_one_hot_and_multiplex_out_of_range_as_jax():
    want, got, *_ = _run("one_hot")
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[0][[2, 3]] == 0).all()            # ids 4 and -1
    with pytest.raises(RuntimeError):
        F.one_hot(torch.tensor([4]), 4)
    want, got, *_ = _run("multiplex")
    np.testing.assert_array_equal(got[0], want[0])
    c = TENSOR_CASES["multiplex"][1]
    # 7 clamps to 2; -1 reads 2; -5 wraps to -2 and clamps to 0
    np.testing.assert_array_equal(got[0][2], c["c"][2])
    np.testing.assert_array_equal(got[0][3], c["c"][3])
    np.testing.assert_array_equal(got[0][4], c["a"][4])


def test_top_k_puts_the_lower_index_first_among_ties():
    want, got, *_ = _run("top_k")
    np.testing.assert_array_equal(got[1], _int64_indices(want)[1])
    assert got[1].dtype == np.int64
    assert got[1][0].tolist() == [1, 2, 4] and got[1][1].tolist() == [4, 0,
                                                                       2]


@pytest.mark.parametrize("shape,out", [((5, 4), (9, 7)), ((9, 8), (4, 3)),
                                       ((6, 6), (6, 3))])
def test_bilinear_interp_against_interpolate(shape, out):
    """Where both dims grow, ``F.interpolate(align_corners=False)`` gives
    the port's values; where one shrinks, JAX's antialiasing filter
    averages more inputs and the two part ways."""
    x = _r(1, 2, *shape, seed=41)
    want, got, *_ = run_both(
        lambda fl, v: fl.layers.bilinear_interp(v["x"], *out), {"x": x})
    assert_match(want, got, [], [], [])
    plain = F.interpolate(torch.from_numpy(x), size=out, mode="bilinear",
                          align_corners=False).numpy()
    grows = out[0] >= shape[0] and out[1] >= shape[1]
    assert np.allclose(got[0], plain, atol=1e-5) == grows


@pytest.mark.parametrize("classes", [7, 8])
def test_hsigmoid_is_a_normalized_distribution(classes):
    """``tests/test_nets.py:9`` mirrored: the hierarchical factorisation
    induces a proper distribution, sum_c exp(-loss(x, c)) == 1 for any x,
    at a class count with ragged depths (7) and a power of two (8)."""
    D, B = 5, 3
    x = np.random.RandomState(0).randn(B, D).astype("float32")
    tfluid.reset_default_programs()
    xv = tfluid.layers.data("x", [D])
    lv = tfluid.layers.data("lab", [1], dtype="int32")
    loss = tfluid.layers.hsigmoid(xv, lv, classes)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    total = np.zeros(B)
    for c in range(classes):
        out, = exe.run(feed={"x": x, "lab": np.full((B, 1), c, "int32")},
                       fetch_list=[loss], scope=scope)
        total += np.exp(-out.ravel().astype(np.float64))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def test_hsigmoid_gradient_against_finite_differences():
    """``tests/test_nets.py:28`` mirrored, in float64: fc -> hsigmoid ->
    reduce_mean, its ops run on double tensors, the gradients of the input
    and of every parameter held by ``torch.autograd.gradcheck``."""
    from paddle_tpu_torch.core.program import OpContext

    C, D, B = 6, 4, 3
    rng = np.random.RandomState(1)
    tfluid.reset_default_programs()
    xv = tfluid.layers.data("x", [D])
    lv = tfluid.layers.data("lab", [1], dtype="int32")
    out = tfluid.layers.reduce_mean(tfluid.layers.hsigmoid(
        tfluid.layers.fc(xv, D), lv, C))
    prog = tfluid.default_main_program()
    names = ["x"] + [p.name for p in prog.parameters()]
    shapes = [(B, D)] + [tuple(p.shape) for p in prog.parameters()]
    lab = torch.from_numpy(rng.randint(0, C, (B, 1)).astype(np.int32))

    def loss(*vals):
        env = dict(zip(names, vals), lab=lab)
        for op in prog.list_ops():
            op.apply(env, OpContext(device="cpu"))
        return env[out.name]

    inputs = [torch.from_numpy(rng.randn(*s)).requires_grad_(True)
              for s in shapes]
    assert torch.autograd.gradcheck(loss, inputs, eps=1e-6, atol=1e-7)


def test_evaluator_names_match_the_reference():
    """``evaluator.py``'s six classes (``Evaluator`` and the five
    evaluators) equal the reference's, and the module exports them."""
    import importlib

    def classes(mod):
        return {n for n, v in vars(mod).items()
                if isinstance(v, type) and v.__module__ == mod.__name__}

    ref = importlib.import_module("paddle_tpu.evaluator")
    port = importlib.import_module("paddle_tpu_torch.evaluator")
    assert classes(ref) == classes(port) and len(classes(port)) == 6
    assert set(port.__all__) == classes(port)

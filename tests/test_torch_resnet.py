"""paddle_tpu_torch's ResNet training slice against the JAX package on the
CPU: the image layers (conv2d, pool2d, batch_norm, reshape) one op at a
time, two Momentum steps of a small CIFAR ResNet from the same numpy
weights, one step of it under amp, the amp policy's routing, and the
ResNet-50 program's names and shapes (built, not run)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.resnet  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu.core.program import OpContext as JaxOpContext
from paddle_tpu_torch.core.program import OpContext as TorchOpContext
from paddle_tpu_torch.models import init_resnet_params, resnet_param_shapes

CPU = tfluid.CPUPlace()
CIFAR_DEPTH = 8          # one basic block a stage
N_IMG = 8


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


def _dtype_name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _run(fl, out_fn, feed, weights=None, steps=1):
    """Build ``out_fn(fl)`` -> fetch list in the (fresh) default programs of
    ``fl``, run the startup program, load ``weights`` and run ``steps``
    steps; returns each step's fetches and the scope, as numpy arrays."""
    fetch = out_fn(fl)
    if fl is tfluid:
        exe = tfluid.Executor(CPU)
        exe.run(tfluid.default_startup_program())
        if weights:
            tfluid.load_scope(weights, tfluid.default_main_program(),
                              tfluid.global_scope(), device="cpu")
    else:
        exe = jfluid.Executor()
        exe.run(jfluid.default_startup_program())
        for k, v in (weights or {}).items():
            jfluid.global_scope().set_var(k, jnp.asarray(v))
    outs = [[np.asarray(o, np.float32)
             for o in exe.run(feed=feed, fetch_list=fetch)]
            for _ in range(steps)]
    scope = {n: (v.float().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v, np.float32))
             for n, v in fl.global_scope().items()}
    return outs, scope


def _both(out_fn, feed, weights=None, steps=1):
    """``_run`` in both packages: ((JAX's last fetches, scope), (the
    port's))."""
    got = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        outs, scope = _run(fl, out_fn, feed, weights, steps)
        got[name] = (outs[-1], scope)
    return got["jax"], got["port"]


# ------------------------------------------------------------ single layers

CONV_CASES = {  # (stride, padding, dilation, groups, bias)
    "plain": (1, 0, 1, 1, False),
    "stride_pad_bias": (2, 1, 1, 1, True),
    "dilation": (1, 2, 2, 1, False),
    "groups_bias": (2, 1, 1, 2, True),
    "rect": ((1, 2), (0, 1), (2, 1), 1, True),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case):
    """conv2d on [2, 4, 9, 9] with a 3x3 filter (6 outputs), same weights:
    outputs within 1e-5 of max |out|; the filter is OIHW."""
    stride, pad, dil, groups, bias = CONV_CASES[case]
    rng = np.random.RandomState(len(case))
    feed = {"x": rng.standard_normal((2, 4, 9, 9)).astype(np.float32)}
    weights = {"conv2d_w_0": rng.standard_normal(
        (6, 4 // groups, 3, 3)).astype(np.float32)}
    if bias:
        weights["conv2d_b_0"] = rng.standard_normal(6).astype(np.float32)

    def out_fn(fl):
        x = fl.layers.data("x", [4, 9, 9])
        return [fl.layers.conv2d(x, 6, 3, stride=stride, padding=pad,
                                 dilation=dil, groups=groups,
                                 bias_attr=None if bias else False)]

    (jo, js), (to, ts) = _both(out_fn, feed, weights)
    assert to[0].shape == jo[0].shape
    np.testing.assert_allclose(to[0], jo[0], rtol=0,
                               atol=1e-5 * np.abs(jo[0]).max())
    assert set(ts) == set(js) == set(weights)


POOL_CASES = {  # (size, type, stride, padding, global, exclusive, ceil_mode)
    "max_3s2p1": (3, "max", 2, 1, False, True, False),
    "max_ceil_mode_ignored": (3, "max", 2, 1, False, True, True),
    "avg_exclusive_pad": (3, "avg", 2, 1, False, True, False),
    "avg_inclusive_pad": (3, "avg", 2, 1, False, False, False),
    "avg_no_pad": (2, "avg", 2, 0, False, True, False),
    "avg_global": (7, "avg", 1, 0, True, True, False),
    "max_wide_pad": (2, "max", 1, 2, False, True, False),
    "avg_wide_pad_exclusive": (3, "avg", 2, 2, False, True, False),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case):
    """pool2d on [2, 3, 9, 10] with ties (a ReLU'd input: many zeros):
    outputs within 1e-6.  ``ceil_mode`` is accepted and ignored, as the
    JAX package ignores it; padding over half the window goes through
    explicit padding."""
    size, ptype, stride, pad, glob, excl, ceil = POOL_CASES[case]
    rng = np.random.RandomState(3)
    x = np.maximum(rng.standard_normal((2, 3, 9, 10)), 0).astype(np.float32)
    feed = {"x": x}

    def out_fn(fl):
        xv = fl.layers.data("x", [3, 9, 10])
        return [fl.layers.pool2d(xv, size, ptype, stride, pool_padding=pad,
                                 global_pooling=glob, ceil_mode=ceil,
                                 exclusive=excl)]

    (jo, _), (to, _) = _both(out_fn, feed)
    assert to[0].shape == jo[0].shape
    np.testing.assert_allclose(to[0], jo[0], rtol=0, atol=1e-6)
    if ceil:   # the same output as ceil_mode=False
        tfluid.reset_default_programs()
        xv = tfluid.layers.data("x", [3, 9, 10])
        plain = tfluid.layers.pool2d(xv, size, ptype, stride,
                                     pool_padding=pad)
        exe = tfluid.Executor(CPU)
        np.testing.assert_array_equal(
            exe.run(feed=feed, fetch_list=[plain])[0], to[0])


def _op_of(fl, layer_fn, in_shape):
    fl.reset_default_programs()
    x = fl.layers.data("x", list(in_shape[1:]))
    layer_fn(fl, x)
    return fl.default_main_program().list_ops()[-1]


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool2d_gradient_routes_ties_as_jax(kind):
    """The gradient of 3x3 stride-2 pooling (padding 1) on an input with
    exact ties, through each package's own op: torch's max_pool2d and
    JAX's reduce_window max both send a tied window's gradient to the
    first element in window order; the two gradients are equal."""
    rng = np.random.RandomState(9)
    x = np.maximum(rng.standard_normal((2, 2, 8, 8)), 0).astype(np.float32)
    x[0, 0, 2:5, 2:5] = 0.0             # an all-zero window
    x[1, 1, :, 3] = 0.5                 # ties between positive values
    x[1, 1, 4, :] = 0.5
    g = rng.standard_normal((2, 2, 4, 4)).astype(np.float32)

    def layer(fl, xv):
        fl.layers.pool2d(xv, 3, kind, 2, pool_padding=1)

    jop = _op_of(jfluid, layer, x.shape)
    _, vjp = jax.vjp(lambda a: jop.fn({"X": [a]}, jop.attrs,
                                      JaxOpContext(jax.random.key(0)))[
        "Out"][0], jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    top = _op_of(tfluid, layer, x.shape)
    tx = torch.tensor(x, requires_grad=True)
    out = top.fn({"X": [tx]}, top.attrs, TorchOpContext())["Out"][0]
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), want)


@pytest.mark.parametrize("layout,is_test", [("NCHW", False), ("NCHW", True),
                                            ("NHWC", False)])
def test_batch_norm_layer_matches_jax(layout, is_test):
    """batch_norm in a one-op program over two steps: the output, and the
    running mean and variance (persistable, advanced by the op as
    ``momentum * old + (1 - momentum) * batch``), within 1e-5 of max
    |.|; the same persistable names, shapes and dtypes as JAX."""
    rng = np.random.RandomState(5)
    shape = (4, 6, 5, 5) if layout == "NCHW" else (4, 5, 5, 6)
    feed = {"x": (rng.standard_normal(shape) * 3 + 1).astype(np.float32)}
    weights = {"batch_norm_w_0": (rng.rand(6) + 0.5).astype(np.float32),
               "batch_norm_b_0": rng.standard_normal(6).astype(np.float32)}

    def out_fn(fl):
        x = fl.layers.data("x", list(shape[1:]))
        return [fl.layers.batch_norm(x, is_test=is_test, momentum=0.8,
                                     data_layout=layout, act="relu")]

    (jo, js), (to, ts) = _both(out_fn, feed, weights, steps=2)
    assert set(ts) == set(js) == {"batch_norm_w_0", "batch_norm_b_0",
                                  "batch_norm_0.w_mean",
                                  "batch_norm_1.w_var"}
    np.testing.assert_allclose(to[0], jo[0], rtol=0,
                               atol=1e-5 * np.abs(jo[0]).max())
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], rtol=0,
                                   atol=1e-5 * np.abs(js[n]).max(),
                                   err_msg=n)
    if is_test:
        assert np.all(ts["batch_norm_0.w_mean"] == 0)
    else:
        x = feed["x"]
        axes = (0, 2, 3) if layout == "NCHW" else (0, 1, 2)
        mean = x.mean(axes)
        np.testing.assert_allclose(ts["batch_norm_0.w_mean"],
                                   (1 - 0.8 ** 2) * mean, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            ts["batch_norm_1.w_var"],
            0.8 ** 2 + (1 - 0.8 ** 2) * x.var(axes), rtol=1e-5)


def test_reshape_zero_is_the_batch_dim():
    """``reshape`` maps EVERY 0 to the input's first dim, as JAX's does
    (not to the dim at its own position): [2, 4, 3] with [0, -1, 0] is
    [2, 6, 2], not [2, 4, 3].  (A second 0 needs a static first dim: at
    build time the batch dim is a large sentinel.)"""
    feed = {"x": np.arange(24, dtype=np.float32).reshape(2, 4, 3)}

    def out_fn(fl):
        x = fl.layers.data("x", [2, 4, 3], append_batch_size=False)
        return [fl.layers.reshape(x, [0, -1, 0]), fl.layers.reshape(x, [0, -1])]

    (jo, _), (to, _) = _both(out_fn, feed)
    assert to[0].shape == jo[0].shape == (2, 6, 2)
    assert to[1].shape == jo[1].shape == (2, 12)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the model


def _cifar_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.standard_normal((N_IMG, 3, 32, 32)).astype(np.float32),
            "label": rng.randint(0, 10, (N_IMG, 1)).astype(np.int32)}


def _cifar_program(amp=False):
    def out_fn(fl):
        img = fl.layers.data("img", [3, 32, 32])
        label = fl.layers.data("label", [1], dtype="int32")
        loss, acc, _ = fl.models.resnet.build_cifar(
            img, label, depth=CIFAR_DEPTH, class_dim=10)
        fl.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
        if amp:
            fl.amp.enable()
        return [loss, acc]

    return out_fn


def test_cifar_resnet_two_momentum_steps_match_jax():
    """Two Momentum(0.1, 0.9) steps of build_cifar(depth=8) on 8 images,
    from the same init_resnet_params arrays: losses rtol 1e-4, accuracies
    equal, every parameter, velocity and running statistic within 2e-5 of
    its max |.| (measured: 7.6e-6)."""
    weights = init_resnet_params(1, depth=CIFAR_DEPTH, class_dim=10,
                                 cifar=True)
    feed = _cifar_feed()
    res = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        outs, scope = _run(fl, _cifar_program(), feed, weights, steps=2)
        res[name] = ([float(o[0].ravel()[0]) for o in outs],
                     [float(o[1].ravel()[0]) for o in outs], scope)
    (jl, ja, js), (tl, ta, ts) = res["jax"], res["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert ta == ja
    assert tl[1] < tl[0]
    assert set(ts) == set(js)
    assert len([n for n in ts if n.endswith((".w_mean", ".w_var"))]) == 18
    for n, want in js.items():
        np.testing.assert_allclose(ts[n], want, rtol=0,
                                   atol=2e-5 * max(np.abs(want).max(), 1e-30),
                                   err_msg=n)


def test_bottleneck_two_momentum_steps_match_jax():
    """Two Momentum steps through one ResNet-50 bottleneck (1x1, 3x3
    stride 2, 1x1 to 4x the width, and the projection shortcut), global
    pooling and a softmax fc, from the same numpy weights: losses rtol
    1e-4, every parameter, velocity and running statistic within 2e-5 of
    its max |.|."""
    rng = np.random.RandomState(4)
    feed = {"x": rng.standard_normal((6, 8, 8, 8)).astype(np.float32),
            "label": rng.randint(0, 5, (6, 1)).astype(np.int32)}

    def out_fn(fl):
        x = fl.layers.data("x", [8, 8, 8])
        label = fl.layers.data("label", [1], dtype="int32")
        y = fl.models.resnet._bottleneck(x, 4, 2)
        y = fl.layers.pool2d(y, 4, "avg", 1, global_pooling=True)
        pred = fl.layers.fc(fl.layers.reshape(y, [0, -1]), 5, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(pred, label))
        fl.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
        return [loss]

    weights = {}
    for name, shape in (("conv2d_w_0", (4, 8, 1, 1)), ("conv2d_w_1",
                        (4, 4, 3, 3)), ("conv2d_w_2", (16, 4, 1, 1)),
                        ("conv2d_w_3", (16, 8, 1, 1)), ("fc_w_0", (16, 5))):
        weights[name] = (rng.standard_normal(shape) / np.sqrt(
            np.prod(shape[1:]) if name.startswith("conv") else shape[0])
        ).astype(np.float32)
    res = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        outs, scope = _run(fl, out_fn, feed, weights, steps=2)
        res[name] = ([float(o[0].ravel()[0]) for o in outs], scope)
    (jl, js), (tl, ts) = res["jax"], res["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert set(ts) == set(js)
    for n, want in js.items():
        np.testing.assert_allclose(ts[n], want, rtol=0,
                                   atol=2e-5 * max(np.abs(want).max(), 1e-30),
                                   err_msg=n)


def test_cifar_resnet_amp_step_matches_jax():
    """One Momentum step of the same net under amp.enable() in both
    packages.  The loss within rtol 2e-3 (half bfloat16's relative
    spacing; measured 8.6e-5).  Master parameters and velocities stay
    float32.  The update (new - old parameters): bfloat16 rounding of the
    activations and gradients moves each package's amp update away from
    its float32 one by about a tenth (measured: JAX 0.115, the port 0.079
    of the norm), so the port's amp update is held within 0.25 of the norm
    of JAX's amp update (measured 0.103) and within 0.25 of the port's
    float32 update."""
    weights = init_resnet_params(1, depth=CIFAR_DEPTH, class_dim=10,
                                 cifar=True)
    feed = _cifar_feed()
    res = {}
    for name, fl, amp in (("jax", jfluid, True), ("port", tfluid, True),
                          ("port32", tfluid, False)):
        fl.reset_default_programs()
        fl.reset_global_scope()
        (outs,), scope = _run(fl, _cifar_program(amp), feed, weights)
        if fl is tfluid:
            dtypes = {n: v.dtype for n, v in tfluid.global_scope().items()}
            assert set(dtypes.values()) <= {torch.float32, torch.int32}, \
                dtypes
        res[name] = (float(outs[0].ravel()[0]), np.concatenate(
            [(scope[n] - weights[n]).ravel() for n in sorted(weights)]))
    (jl, jd), (tl, td), (_, t32) = res["jax"], res["port"], res["port32"]
    assert abs(tl - jl) <= 2e-3 * abs(jl)
    assert np.linalg.norm(td - jd) <= 0.25 * np.linalg.norm(jd)
    assert np.linalg.norm(td - t32) <= 0.25 * np.linalg.norm(t32)


def test_amp_policy_routing_matches_jax():
    """The port's Bf16Policy routes every op type as the JAX package's
    (bfloat16, float32 or passthrough), optimizer ops to float32, custom
    extras alike; cast_ins casts float tensors only (int32 labels stay
    int32)."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp

    assert tamp.BF16_OPS == jamp.BF16_OPS
    assert tamp.PASSTHROUGH_OPS == jamp.PASSTHROUGH_OPS
    names = {jnp.bfloat16: "bf16", jnp.float32: "f32", None: "pass",
             torch.bfloat16: "bf16", torch.float32: "f32"}
    types = sorted(jamp.BF16_OPS | jamp.PASSTHROUGH_OPS
                   | {"softmax", "mean", "cross_entropy", "accuracy"})
    for kw in ({}, {"extra_f32": ["conv2d"], "extra_bf16": ["batch_norm"]}):
        jp, tp = jamp.Bf16Policy(**kw), tamp.Bf16Policy(**kw)
        for t in types:
            for attrs in ({}, {"is_optimizer_op": True}):
                assert names[tp.compute_dtype(t, attrs)] == \
                    names[jp.compute_dtype(t, attrs)], (t, attrs, kw)
    pol = tamp.Bf16Policy()
    ins = {"X": [torch.zeros(2, 2), torch.zeros(2, dtype=torch.int32)],
           "Y": [torch.zeros(2, dtype=torch.bfloat16)]}
    out = pol.cast_ins("conv2d", {}, ins)
    assert [t.dtype for t in out["X"]] == [torch.bfloat16, torch.int32]
    out = pol.cast_ins("mean", {}, ins)
    assert out["Y"][0].dtype == torch.float32
    assert pol.cast_ins("batch_norm", {}, ins) is ins


def test_resnet50_program_matches_jax():
    """build(depth=50) in both packages: the same persistable names, shapes
    and dtypes (161 parameters, 53 batch norms' running mean and
    variance), the same op types in the main and startup programs, and
    25,557,032 parameters, which ``resnet_param_shapes`` lists in
    declaration order.  Built only: a JAX ResNet-50 compile is too slow
    here."""
    progs = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        img = fl.layers.data("img", [3, 224, 224])
        label = fl.layers.data("label", [1], dtype="int32")
        loss, _, _ = fl.models.resnet.build(img, label, class_dim=1000,
                                            depth=50)
        fl.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
        progs[name] = (fl.default_main_program(), fl.default_startup_program())
    for (jp, tp) in zip(progs["jax"], progs["port"]):
        jv = {v.name: (tuple(v.shape), _dtype_name(v.dtype))
              for v in jp.persistable_vars()}
        tv = {v.name: (tuple(v.shape), _dtype_name(v.dtype))
              for v in tp.persistable_vars()}
        assert tv == jv
        assert [o.type for o in tp.list_ops()] == \
            [o.type for o in jp.list_ops()]
    main = progs["port"][0]
    params = {p.name: tuple(p.shape) for p in main.parameters()}
    assert params == resnet_param_shapes(50, 1000)
    assert list(params) == list(resnet_param_shapes(50, 1000))
    assert sum(int(np.prod(s)) for s in params.values()) == 25_557_032
    assert len(params) == 161
    stats = [n for n in (v.name for v in main.persistable_vars())
             if n.endswith((".w_mean", ".w_var"))]
    assert len(stats) == 2 * 53
    assert sum(o.type == "batch_norm" for o in main.list_ops()) == 53

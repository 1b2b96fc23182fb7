"""The dtypes paddle_tpu_torch's kernels take, against what the JAX package
runs, on the CPU.

The JAX package runs every program below on the CPU in the dtype it was
built in (XLA has no dtype limits of this kind); each test records that by
running the same program through ``paddle_tpu``'s Executor.  The port's
kernels take fewer dtypes: the conv and batch-norm kernels float32 and
bfloat16, the flash kernels float32 and bfloat16, the LSTM kernels float32.
So on a CUDA device:

* a conv the kernels do not take stays on ``F.conv2d``: ``route_inference``
  routes a 3x3 stride-1 conv only when its compute dtype (the declared
  dtype as the amp policy casts it) is float32 or bfloat16;
* a program whose kernel ops have a dtype their kernels refuse is refused
  by ``check_kernel_shapes``, with the kernel's own message, before the
  step's first op (no state changes);
* the CPU runs them all on the plain versions.
"""
import importlib

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core.fusion import FUSED_OP_TYPE, route_inference

CPU = tfluid.CPUPlace()
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


# ------------------------------------------------------------ programs


def _conv(fl, dtype, bn=False):
    """data [3, 8, 8] -> 3x3 pad-1 conv2d (-> batch_norm(is_test)) -> relu;
    forward only."""
    L = fl.layers
    img = L.data("img", [3, 8, 8], dtype=dtype)
    y = L.conv2d(img, 4, 3, padding=1, bias_attr=False)
    if bn:
        y = L.batch_norm(y, is_test=True)
    out = L.relu(y)
    return out, {"img": _normal((2, 3, 8, 8))}


def _batch_norm(fl, dtype):
    """data [4, 6, 6] -> batch_norm (training) -> mean square, SGD."""
    L = fl.layers
    x = L.data("x", [4, 6, 6], dtype=dtype)
    loss = L.mean(L.square(L.batch_norm(x)))
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, {"x": _normal((2, 4, 6, 6))}


def _attention(fl, dtype):
    """x [8, 32] -> three fcs -> the flash attention op (2 heads of 16,
    causal) -> mean square, with its backward."""
    L = fl.layers
    tr = importlib.import_module(fl.__name__ + ".models.transformer")
    x = L.data("x", [8, 32], dtype=dtype)
    q, k, v = (L.fc(x, 32, num_flatten_dims=2, bias_attr=False)
               for _ in range(3))
    loss = L.mean(L.square(tr.attention_core(q, k, v, True, 2, False)))
    fl.backward.append_backward(loss)
    return loss, {"x": _normal((2, 8, 32))}


def _lstm(fl, dtype):
    """pre-projected x [5, 16] -> dynamic_lstm(size 4) over lengths
    {5, 2, 0} -> mean square, with its backward."""
    L = fl.layers
    x = L.data("x", [5, 16], dtype=dtype)
    lengths = L.data("lengths", [-1], dtype="int32", append_batch_size=False)
    hs, _ = L.dynamic_lstm(x, lengths, 4)
    loss = L.mean(L.square(hs))
    fl.backward.append_backward(loss)
    return loss, {"x": _normal((3, 5, 16)),
                  "lengths": np.array([5, 2, 0], np.int32)}


def _normal(shape):
    return np.random.RandomState(0).standard_normal(shape).astype(np.float32)


def _run_jax(build, dtype):
    """The program through the JAX package's Executor on the CPU: the
    fetched value as numpy."""
    out, feed = build(jfluid, dtype)
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    return np.asarray(exe.run(feed=feed, fetch_list=[out])[0])


def _build_port(build, dtype, amp=False):
    out, feed = build(tfluid, dtype)
    if amp:
        tfluid.amp.enable()
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    return out, feed, exe


# ------------------------------------------------------------ convs


@pytest.mark.parametrize("bn", [False, True])
def test_float16_conv_is_not_routed(bn):
    """A float16 3x3 conv (alone, or with batch_norm(is_test) and relu) is
    not routed, with or without amp (amp casts only float32 and bfloat16),
    and the program runs in float16 on the CPU as the JAX package runs it."""
    out, feed, exe = _build_port(lambda fl, dt: _conv(fl, dt, bn), "float16")
    main = tfluid.default_main_program()
    assert route_inference(main, [out.name]) is None
    assert route_inference(main, [out.name], tfluid.amp.Bf16Policy()) is None
    got = exe.run(feed=feed, fetch_list=[out])[0]
    assert got.dtype == np.float16 and np.isfinite(got).all()
    tfluid.reset_default_programs()
    want = _run_jax(lambda fl, dt: _conv(fl, dt, bn), "float16")
    assert want.dtype == np.float16 and want.shape == got.shape


@pytest.mark.parametrize("dtype,amp", [("float32", False), ("bfloat16", False),
                                       ("float32", True)])
@pytest.mark.parametrize("bn", [False, True])
def test_float32_and_bf16_convs_stay_routed(dtype, amp, bn):
    """float32 and bfloat16 convs, and a float32 conv under amp (bfloat16
    compute), are routed as before: the plain kernel alone, the fused op
    with the batch norm and relu."""
    out, _, _ = _build_port(lambda fl, dt: _conv(fl, dt, bn), dtype, amp)
    main = tfluid.default_main_program()
    ops = route_inference(main, [out.name], main.amp_policy)
    assert ops is not None
    types = [op.type for op in ops]
    assert types == ([FUSED_OP_TYPE] if bn else ["conv2d", "relu"])


# ------------------------------------------------------------ kernel ops

# (program, dtype, the kernel's message): refused for a CUDA device
REFUSED = [
    (_batch_norm, "float16", "batch-norm kernels take float32 or bfloat16"),
    (_attention, "float16", "flash kernels take float32 or bfloat16"),
    (_lstm, "bfloat16", "LSTM kernels take float32"),
    (_lstm, "float16", "LSTM kernels take float32"),
]


@pytest.mark.parametrize("build,dtype,message", REFUSED,
                         ids=[f"{b.__name__[1:]}-{d}" for b, d, _ in REFUSED])
def test_unsupported_kernel_dtype_refused_before_the_first_op(build, dtype,
                                                              message):
    """The program is refused by ``check_kernel_shapes`` for a CUDA device,
    and by ``Executor.run`` on a CUDA executor before any op runs (the
    scope keeps every tensor it had); the CPU runs it in that dtype, and
    the JAX package runs it too."""
    out, feed, exe = _build_port(build, dtype)
    main = tfluid.default_main_program()
    scope = tfluid.global_scope()
    with pytest.raises(ValueError, match=message):
        texec.check_kernel_shapes(main, CUDA)
    texec.check_kernel_shapes(main, torch.device("cpu"))
    before = {n: t.clone() for n, t in scope.items()}
    steps = scope.step_counter
    on_card = tfluid.Executor(CPU)
    on_card.device = CUDA          # no card here: the check comes first
    with pytest.raises(ValueError, match=message):
        on_card.run(feed=feed, fetch_list=[out])
    assert set(before) == set(n for n, _ in scope.items())
    assert all(torch.equal(before[n], t) for n, t in scope.items())
    assert scope.step_counter == steps
    got = exe.run(feed=feed, fetch_list=[out])[0]
    assert np.isfinite(np.asarray(got, np.float32)).all()
    tfluid.reset_default_programs()
    want = _run_jax(build, dtype)
    assert str(want.dtype) == dtype and np.isfinite(
        want.astype(np.float32)).all()


# (program, dtype, amp): each kernel op in a dtype its kernel takes
ACCEPTED = [
    (_batch_norm, "float32", False), (_batch_norm, "bfloat16", False),
    (_attention, "float32", False), (_attention, "bfloat16", False),
    (_lstm, "float32", False),
    (_lstm, "bfloat16", True),     # amp runs dynamic_lstm in float32
    (_attention, "float32", True),  # and the attention op
]


@pytest.mark.parametrize("build,dtype,amp", ACCEPTED,
                         ids=[f"{b.__name__[1:]}-{d}{'-amp' if a else ''}"
                              for b, d, a in ACCEPTED])
def test_supported_kernel_dtypes_pass_the_check(build, dtype, amp):
    """Kernel ops in dtypes their kernels take, after the amp policy, pass
    ``check_kernel_shapes`` for a CUDA device."""
    _build_port(build, dtype, amp)
    texec.check_kernel_shapes(tfluid.default_main_program(), CUDA)


def test_batch_norm_without_its_backward_kernels_passes():
    """A float16 batch_norm whose backward kernels never run passes: with
    ``is_test``, and in a forward-only program."""
    L = tfluid.layers
    x = L.data("x", [4, 6, 6], dtype="float16")
    L.batch_norm(L.batch_norm(x, is_test=True))
    texec.check_kernel_shapes(tfluid.default_main_program(), CUDA)

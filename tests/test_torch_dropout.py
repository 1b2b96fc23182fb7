"""The port's dropout (``ops/dropout.py``, ``layers.dropout``) against the
JAX package's on the CPU: the threefry bits, the keep mask and the op key
bitwise equal to ``jax.random``'s over seeds, step counters (0, 1, past
2^31, the last uint32), tags, shapes (1-D to 4-D, ragged) and p; the layer
in training and ``is_test`` bitwise equal to the reference's through both
Executors; the gradient bitwise equal to JAX's vjp; and the kernel's dtypes
refused on a CUDA place before the first op.  The CUDA kernel itself is
held bitwise to the plain version by ``chip_smoke.py``'s dropout kernels
phase."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.executor import check_kernel_shapes
from paddle_tpu_torch.core.program import OpContext
from paddle_tpu_torch.ops import dropout as dmod

CPU = tfluid.CPUPlace()
STEPS = (0, 1, 2 ** 31 + 5, 2 ** 32 - 1)
SHAPES = ((37,), (4, 6, 5), (3, 1000), (2, 3, 4, 5))


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _jax_key(seed, step, tag):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                 np.uint32(step)),
                              np.uint32(tag))


def _staged(step):
    """The step as the Executor stages it into a warmed step: its uint32
    bits in one int32."""
    return torch.from_numpy(np.array([step & 0xFFFFFFFF], np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 40 + 3])
def test_key_words_match_jax(seed, step):
    """``OpContext.rng_key(tag).words()`` is ``jax.random.key_data`` of the
    reference's ``fold_in(fold_in(key(seed), step), tag)``, with the step
    as an int (eager) and as the staged int32 word (warmed)."""
    for tag in (1, 13, 2 ** 32 - 1):
        want = tuple(int(w) for w in np.asarray(
            jax.random.key_data(_jax_key(seed, step, tag))))
        for s in (step, _staged(step)):
            got = OpContext(seed, s).rng_key(tag).words()
            assert tuple(int(w) for w in got) == want, (seed, step, tag)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("step", STEPS)
def test_bits_and_mask_match_jax(step, shape):
    """``threefry_bits`` is ``jax.random.bits`` and ``keep_mask`` is
    ``jax.random.bernoulli(key, 1 - p, shape)``, bit for bit, for two seeds,
    two tags and p in {0.1, 0.5}."""
    for seed in (0, 7):
        for tag in (1, 13):
            jk = _jax_key(seed, step, tag)
            key = dmod.ThreefryKey(seed, step, tag)
            bits = dmod.threefry_bits(key, shape).numpy().astype(np.uint32)
            assert np.array_equal(bits, np.asarray(jax.random.bits(jk,
                                                                   shape)))
            for p in (0.1, 0.5):
                want = np.asarray(jax.random.bernoulli(jk, 1.0 - p, shape))
                got = dmod.keep_mask(key, shape, p)
                assert got.dtype == torch.bool
                assert np.array_equal(got.numpy(), want), (seed, tag, p)
            staged = dmod.ThreefryKey(seed, _staged(step), tag)
            assert torch.equal(dmod.threefry_bits(staged, shape),
                               dmod.threefry_bits(key, shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_and_gradient_match_jax_vjp(dtype):
    """``threefry_dropout`` on CPU tensors is ``a * bernoulli(...)`` in a's
    dtype and its gradient ``g * mask``, both bitwise equal to JAX's (the
    reference's op and ``jax.vjp`` of it); the gradient draws the same
    mask again."""
    rng = np.random.RandomState(0)
    shape, p, seed, step, tag = (4, 7, 9), 0.1, 3, 11, 5
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jk = _jax_key(seed, step, tag)

    def ref(a):
        mask = jax.random.bernoulli(jk, 1.0 - p, a.shape)
        return a * mask.astype(a.dtype)

    jy, vjp = jax.vjp(ref, jnp.asarray(x, jdt))
    (jdx,) = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ty = dmod.threefry_dropout(tx, dmod.ThreefryKey(seed, step, tag), p)
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(tdt))
    for got, want in ((ty, jy), (tdx, jdx)):
        assert got.dtype == tdt
        assert np.array_equal(got.detach().float().numpy(),
                              np.asarray(want, np.float32))
    assert (ty == 0).any() and (ty != 0).any()
    assert torch.equal(ty == 0, tdx == 0)


def _dropout_program(fl, p, is_test):
    x = fl.layers.data("x", [6, 5])
    h = fl.layers.dropout(x, p)
    h2 = fl.layers.dropout(h, p, is_test=is_test)
    return [h, h2]


@pytest.mark.parametrize("is_test", [False, True])
def test_layer_matches_jax_through_the_executor(is_test):
    """``layers.dropout`` (two sites, tags 1 and 2; the second in
    ``is_test`` or training) run by each package's Executor at step
    counters 0 and 2^31 + 5 and a program seed of 11: every output bitwise
    equal; ``is_test`` scales by 1 - p, no mask."""
    x = np.random.RandomState(1).randn(3, 6, 5).astype(np.float32)
    outs = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        fetch = _dropout_program(fl, 0.3, is_test)
        prog = fl.default_main_program()
        prog.random_seed = 11
        assert [op.attrs["_tag"] for op in prog.list_ops()] == [1, 2]
        exe = fl.Executor(CPU) if fl is tfluid else fl.Executor()
        scope = fl.Scope()
        got = []
        for counter in (0, 2 ** 31 + 5):
            scope.step_counter = counter
            got.append([np.asarray(v) for v in exe.run(
                prog, feed={"x": x}, fetch_list=fetch, scope=scope)])
        outs[name] = got
    for got_step, want_step in zip(outs["port"], outs["jax"]):
        for got, want in zip(got_step, want_step):
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want)
    h0, h2_0 = outs["port"][0]
    assert not np.array_equal(h0 == 0, outs["port"][1][0] == 0)
    if is_test:
        np.testing.assert_array_equal(h2_0, h0 * np.float32(0.7))


def test_bf16_is_test_scale_rounds_like_jax():
    """``is_test`` in bfloat16: the scale 1 - p is rounded to bfloat16 as
    JAX's weakly typed scalar is, so the product matches bitwise."""
    x = np.random.RandomState(2).randn(64).astype(np.float32)
    want = np.asarray(jnp.asarray(x, jnp.bfloat16) * (1.0 - 0.1), np.float32)
    fn = None
    out = tfluid.layers.dropout(tfluid.layers.data("x", [64]), 0.1,
                                is_test=True)
    op = tfluid.default_main_program().list_ops()[-1]
    fn = op.fn
    got = fn({"X": [torch.from_numpy(x).to(torch.bfloat16)]}, op.attrs,
             OpContext())["Out"][0]
    assert out.name == op.outputs["Out"][0]
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype,ok", [("float32", True), ("bfloat16", True),
                                      ("float16", False)])
def test_kernel_dtypes_refused_on_a_card_before_the_first_op(dtype, ok):
    """A training dropout in float32 or bfloat16 passes
    ``check_kernel_shapes`` for a CUDA device; float16 is refused with the
    kernel's message (``is_test`` runs no kernel and passes); the CPU runs
    float16 on the plain version."""
    x = tfluid.layers.data("x", [8], dtype=dtype)
    out = tfluid.layers.dropout(x, 0.5)
    prog = tfluid.default_main_program()
    if ok:
        check_kernel_shapes(prog, torch.device("cuda"))
    else:
        with pytest.raises(ValueError, match="dropout kernel takes float32"):
            check_kernel_shapes(prog, torch.device("cuda"))
        check_kernel_shapes(prog.clone(for_test=True), torch.device("cuda"))
    y, = tfluid.Executor(CPU).run(prog, feed={"x": np.ones((2, 8),
                                                         np.float32)},
                                  fetch_list=[out], return_numpy=False)
    assert y.dtype == getattr(torch, dtype) and set(y.unique().tolist()) <= {
        0.0, 1.0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        dmod.dropout_fwd_kernel(torch.ones(4), dmod.ThreefryKey(0, 0, 1), 0.5)

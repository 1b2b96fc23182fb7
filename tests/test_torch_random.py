"""JAX's random transforms in the port (``ops/random.py``) against
``jax.random`` on the CPU, from the same keys: ``uniform`` (float32,
float16, bfloat16), ``randint`` (ranges up to the whole int32 span),
``split`` and ``categorical`` bitwise; ``normal`` within
``NORMAL_ULPS`` units in the last place and ``gumbel`` within
``GUMBEL_TOL``; ``fma32`` against exact rational arithmetic.  Then the
random layers in a step: ``gaussian_random`` and ``uniform_random`` run
by the port's Executor against the JAX package's Executor at the same
(seed, step counter), and a warmed step's replay at step s bitwise the
eager step at s, new draws at s + 1, and the same draws at s again."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops import random as R
from paddle_tpu_torch.ops.dropout import ThreefryKey

KEYS = [(0, 0, 1), (7, 3, 5), (123456, 2 ** 31 + 5, 13),
        (2 ** 32 - 1, 2 ** 32 - 1, 2)]
SHAPES = [(7,), (33, 17), (2, 3, 5)]
CPU = "cpu"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(seed, step, tag):
    """The port's key of (seed, step, tag) and JAX's, the Executor's
    ``fold_in(fold_in(key(seed), step), tag)``; their words must agree."""
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                               np.uint32(step)),
                            np.uint32(tag))
    tk = ThreefryKey(seed, step, tag)
    assert [int(w) for w in tk.words()] == [
        int(w) for w in np.asarray(jax.random.key_data(jk))]
    return tk, jk


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_uniform_is_bitwise_jax(key, dtype):
    tk, jk = _keys(*key)
    tdt = getattr(torch, dtype)
    for shape in SHAPES:
        for lo, hi in [(0.0, 1.0), (-2.0, 3.0), (0.25, 0.5)]:
            got = R.uniform(tk, shape, tdt, lo, hi, CPU).float().numpy()
            want = np.asarray(jax.random.uniform(
                jk, shape, getattr(jnp, dtype), lo, hi)).astype(np.float32)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", KEYS)
def test_normal_is_jax_within_its_ulps(key):
    tk, jk = _keys(*key)
    for shape in SHAPES + [(4096,)]:
        got = R.normal(tk, shape, device=CPU).numpy()
        want = np.asarray(jax.random.normal(jk, shape))
        assert _ulps(got, want).max() <= R.NORMAL_ULPS


def test_normal_over_a_million_draws():
    """2^20 draws: at most NORMAL_ULPS apart from JAX's, most of them
    bitwise; the mean and variance of a standard normal."""
    tk, jk = _keys(1, 2, 3)
    got = R.normal(tk, (1 << 20,), device=CPU).numpy()
    want = np.asarray(jax.random.normal(jk, (1 << 20,)))
    d = _ulps(got, want)
    assert d.max() <= R.NORMAL_ULPS and (d == 0).mean() > 0.95
    assert abs(got.mean()) < 5e-3 and abs(got.var() - 1) < 5e-3


RANGES = [(0, 10), (3, 2074), (-5, 5), (0, 1), (5, 5), (7, 3),
          (-2 ** 31, 2 ** 31 - 1), (0, 2 ** 31 - 1), (-7, 2 ** 31 - 1)]


@pytest.mark.parametrize("key", KEYS)
def test_randint_is_bitwise_jax(key):
    tk, jk = _keys(*key)
    for shape in SHAPES:
        for lo, hi in RANGES:
            got = R.randint(tk, shape, lo, hi, CPU).numpy()
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", KEYS)
def test_split_is_bitwise_jax(key):
    tk, jk = _keys(*key)
    for n in (1, 2, 3, 7):
        got = [tuple(int(w) for w in k) for k in R.split(tk, n)]
        want = [tuple(int(w) for w in k)
                for k in np.asarray(jax.random.key_data(
                    jax.random.split(jk, n)))]
        assert got == want
    # a split key draws as JAX's split key does
    k1 = R.split(tk, 3)[2]
    jk1 = jax.random.split(jk, 3)[2]
    np.testing.assert_array_equal(
        R.uniform(k1, (9,), device=CPU).numpy(), np.asarray(jax.random.uniform(jk1,
                                                                   (9,))))


@pytest.mark.parametrize("key", KEYS)
def test_categorical_is_bitwise_jax_and_gumbel_close(key):
    tk, jk = _keys(*key)
    rng = np.random.RandomState(key[2])
    for shape, axis in [((7, 11), -1), ((5, 3, 40), -1), ((6, 4), 0)]:
        logits = (3 * rng.standard_normal(shape)).astype(np.float32)
        got = R.categorical(tk, torch.from_numpy(logits), axis).numpy()
        want = np.asarray(jax.random.categorical(jk, logits, axis))
        np.testing.assert_array_equal(got, want)
        g = R.gumbel(tk, shape, device=CPU).numpy()
        jg = np.asarray(jax.random.gumbel(jk, shape))
        assert (np.abs(g - jg) <= R.GUMBEL_TOL
                * np.maximum(1.0, np.abs(jg))).all()


def test_draws_default_to_the_card():
    """With no device and host-side words, a draw goes to the CUDA card
    (raising here, where there is none); a warmed step's tensor words
    keep their own device."""
    tk = ThreefryKey(0, 0, 1)
    if torch.cuda.is_available():
        assert R.bits(tk, (3,)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            R.uniform(tk, (3,))
    staged = ThreefryKey(0, torch.zeros((), dtype=torch.int32), 1)
    assert R.uniform(staged, (3,)).device.type == "cpu"
    np.testing.assert_array_equal(R.uniform(staged, (3,)).numpy(),
                                  R.uniform(tk, (3,), device=CPU).numpy())


def test_fma32_rounds_once():
    """``fma32`` gives the float32 nearest the exact a * b + c (ties to
    even), checked in rational arithmetic, including sums that cancel and
    products far below the addend."""
    rng = np.random.RandomState(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = (rng.standard_normal(4000) * 10.0 ** rng.randint(-8, 8, 4000)
         ).astype(np.float32)
    c = rng.standard_normal(4000).astype(np.float32)
    c[:500] = -(a[:500].astype(np.float64) * b[:500]).astype(np.float32)
    got = R.fma32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = {lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))}
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32))
                                         & 1))
        assert r == best, (x, y, z, r, best)


def _random_program(fl):
    """A program drawing gaussian_random and uniform_random in its step,
    added to a fed x."""
    fl.reset_default_programs()
    x = fl.layers.data("x", [4, 6], append_batch_size=False)
    g = fl.layers.gaussian_random([4, 6], mean=0.5, std=2.0)
    u = fl.layers.uniform_random([4, 6], -1.0, 1.0)
    out = fl.layers.elementwise_add(fl.layers.elementwise_mul(x, g), u)
    return fl.default_main_program(), out, g, u


def test_random_layers_draw_jax_numbers_in_the_executor():
    """The port's Executor and the JAX package's, program seed 11, at step
    counters 0, 1 and 5: uniform bitwise, gaussian within NORMAL_ULPS."""
    x = np.ones((4, 6), np.float32)
    got, want = [], []
    for fl, out in ((tfluid, got), (jfluid, want)):
        prog, _, g, u = _random_program(fl)
        prog.random_seed = 11
        exe = (fl.Executor(fl.CPUPlace()) if fl is tfluid
               else fl.Executor())
        scope = fl.Scope()
        for step in (0, 1, 5):
            scope.step_counter = step
            out.append(exe.run(prog, feed={"x": x}, fetch_list=[g, u],
                               scope=scope))
    for (tg, tu), (jg, ju) in zip(got, want):
        np.testing.assert_array_equal(tu, np.asarray(ju))
        assert _ulps(tg, np.asarray(jg)).max() <= R.NORMAL_ULPS
    assert not np.array_equal(got[0][0], got[1][0])


def test_warmed_gaussian_random_replays_the_eager_draws():
    """On the CPU: the signature warmed, its replay at step s is bitwise an
    unwarmed Executor's eager step at s, the replay at s + 1 draws anew,
    and a replay at s again is bitwise the first."""
    prog, out, g, u = _random_program(tfluid)
    prog.random_seed = 4
    feed = {"x": np.random.RandomState(0).standard_normal((4, 6)).astype(
        np.float32)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    s = 2 ** 31 + 7
    assert exe.warm(prog, [("x", (4, 6), "float32")], [out, g, u],
                    scope=scope) == "compiled"
    scope.step_counter = s
    first = exe.run(prog, feed=feed, fetch_list=[out, g, u], scope=scope)
    nxt = exe.run(prog, feed=feed, fetch_list=[out, g, u], scope=scope)
    assert exe.replays == 2 and scope.step_counter == s + 2
    scope.step_counter = s
    again = exe.run(prog, feed=feed, fetch_list=[out, g, u], scope=scope)
    eager = tfluid.Executor(tfluid.CPUPlace())
    escope = tfluid.Scope()
    escope.step_counter = s
    want = eager.run(prog, feed=feed, fetch_list=[out, g, u], scope=escope)
    assert eager.replays == 0
    for a, b, c in zip(first, want, again):
        assert a.tobytes() == b.tobytes() == c.tobytes()
    for a, b in zip(first, nxt):
        assert not np.array_equal(a, b)

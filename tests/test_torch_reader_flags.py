"""``paddle_tpu_torch.reader`` and ``paddle_tpu_torch.flags`` against the
JAX package's ``paddle_tpu.reader`` and ``paddle_tpu.flags`` on the CPU:

* every decorator gives the JAX package's stream on the same inputs
  (seeded ``shuffle`` over three epochs, with an int and with a numpy
  Generator, ordered ``xmap_readers``, ``buffered``, ``compose``,
  ``bucket_by_length``, ``cache``, ``pipe_reader`` over plain and gzip
  streams); a reader's and a mapper's exceptions reach the consumer;
  ``pipe_reader`` fails loudly on a failing command and a truncated gzip
  stream;
* the flag registry has the JAX package's names, types and defaults, and
  parses the environment and the command line the same way;
* the ``seed`` flag is the step seed of a program whose ``random_seed``
  is 0: a dropout mask bitwise JAX's for the same flag value, another
  mask for another value;
* ``log_clipping`` prints the clipped global norm, as JAX's does."""
import gzip

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import flags as jflags
from paddle_tpu import reader as jrd
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import reader as trd

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield
    for fl in (jflags, tflags):
        for f in fl._registry.values():
            f.value = None


def _nums(n):
    def r():
        yield from range(n)

    return r


def _streams(rd):
    """Each decorator's output, by name, on the same inputs."""
    out = {
        "map": list(rd.map_readers(lambda a, b: a * 10 + b, _nums(5),
                                   _nums(7))()),
        "chain": list(rd.chain(_nums(2), _nums(3))()),
        "compose": list(rd.compose(_nums(3), rd.map_readers(
            lambda x: (x, -x), _nums(3)))()),
        "buffered": list(rd.buffered(_nums(100), size=7)()),
        "firstn": list(rd.firstn(_nums(100), 7)()),
        "xmap": list(rd.xmap_readers(lambda x: x * x, _nums(40),
                                     process_num=4, buffer_size=3,
                                     order=True)()),
        "xmap_unordered": sorted(rd.xmap_readers(
            lambda x: x + 1, _nums(20), process_num=3, buffer_size=2)()),
        "batch": list(rd.batch(_nums(10), 3)()),
        "batch_keep": list(rd.batch(_nums(10), 3, drop_last=False)()),
        "bucket": list(rd.bucket_by_length(
            lambda: iter([[1] * 3, [2] * 7, [3] * 2, [4] * 9, [5] * 4,
                          [6] * 8, [7] * 11]), len, [4, 10],
            batch_size=2)()),
    }
    sh = rd.shuffle(_nums(50), buf_size=16, seed=3)
    out["shuffle_int"] = [list(sh()) for _ in range(3)]
    sh = rd.shuffle(_nums(30), buf_size=8, seed=np.random.default_rng(9))
    out["shuffle_generator"] = [list(sh()) for _ in range(2)]
    calls = []

    def counted():
        calls.append(1)
        yield from range(4)

    c = rd.cache(counted)
    out["cache"] = [list(c()), list(c()), len(calls)]
    return out


def test_decorator_streams_match_the_reference():
    got, want = _streams(trd), _streams(jrd)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    # the shuffles are permutations, new each epoch
    epochs = got["shuffle_int"]
    assert all(sorted(e) == list(range(50)) for e in epochs)
    assert epochs[0] != epochs[1] != epochs[2]


def test_exceptions_reach_the_consumer():
    def bad():
        yield 1
        raise KeyError("reader broke")

    for rd in (trd, jrd):
        with pytest.raises(KeyError, match="reader broke"):
            list(rd.buffered(bad, size=2)())
        with pytest.raises(KeyError, match="reader broke"):
            list(rd.xmap_readers(lambda x: x, bad, 2, 2, order=True)())

        def mapper(x):
            if x == 3:
                raise ZeroDivisionError("mapper broke")
            return x

        with pytest.raises(ZeroDivisionError, match="mapper broke"):
            list(rd.xmap_readers(mapper, _nums(8), 2, 2)())
        with pytest.raises(rd.ComposeNotAligned):
            list(rd.compose(_nums(2), _nums(3))())
        assert list(rd.compose(_nums(2), _nums(3),
                               check_alignment=False)())[:2] == [(0, 0),
                                                                 (1, 1)]
        with pytest.raises(TypeError, match="seed"):
            rd.shuffle(_nums(3), 2, seed="x")


def test_pipe_reader_streams_and_fails_loudly(tmp_path):
    text = tmp_path / "lines.txt"
    text.write_text("alpha 1\nbeta 2\n\ngamma 3")
    gz = tmp_path / "lines.gz"
    with gzip.open(gz, "wb") as f:
        f.write(b"one\ntwo\nthree\n")
    trunc = tmp_path / "trunc.gz"
    trunc.write_bytes(gz.read_bytes()[:-6])

    def parse(line):
        return line.split() or None

    for rd in (trd, jrd):
        assert list(rd.pipe_reader(f"cat {text}", parse)()) == [
            ["alpha", "1"], ["beta", "2"], ["gamma", "3"]]
        got = list(rd.pipe_reader(f"cat {gz}", lambda s: s or None,
                                  file_type="gzip")())
        assert got == ["one", "two", "three"]
        with pytest.raises(RuntimeError, match="rc=1"):
            list(rd.pipe_reader("false", parse)())
        with pytest.raises(RuntimeError, match="truncated gzip"):
            list(rd.pipe_reader(f"cat {trunc}", parse, file_type="gzip")())
        with pytest.raises(ValueError, match="plain|gzip"):
            rd.pipe_reader("true", parse, file_type="bz2")
        # an abandoned stream kills its command instead of hanging
        assert next(iter(rd.pipe_reader("yes", lambda s: s)())) == "y"


# ------------------------------------------------------------------ flags


def _reference_flags():
    """``paddle_tpu/flags.py`` loaded afresh: its own registry, without the
    flags the JAX package's ``cli.py`` defines when its commands run (other
    tests in the process may have run them)."""
    import importlib.util
    import sys

    name = "_reference_flags_fresh"
    spec = importlib.util.spec_from_file_location(name, jflags.__file__)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses resolve the module by name
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[name]
    return mod


def test_flag_registry_matches_the_reference():
    ref = _reference_flags()
    assert list(tflags._registry) == list(ref._registry)
    for name, f in ref._registry.items():
        g = tflags._registry[name]
        assert g.default == f.default and type(g.default) is type(
            f.default), name
    assert tflags.all_flags() == ref.all_flags()


def test_flag_parsing_matches_the_reference(monkeypatch):
    ref = _reference_flags()
    argv = ["--log_period=7", "--use-tpu=false", "--beam_size=3", "keep",
            "--unknown=1", "--comment=a=b"]
    for fl in (tflags, ref):
        assert fl.parse_args(list(argv)) == ["keep", "--unknown=1"]
    assert tflags.all_flags() == ref.all_flags()
    assert tflags.get("log_period") == 7 and tflags.get("use_tpu") is False
    assert tflags.get("comment") == "a=b"
    monkeypatch.setenv("PADDLE_TPU_CHECKGRAD_EPS", "0.25")
    monkeypatch.setenv("PADDLE_TPU_SAVE_ONLY_ONE", "yes")
    for fl in (tflags, ref):
        assert fl.get("checkgrad_eps") == 0.25
        assert fl.get("save_only_one") is True
    assert "no counterpart" in tflags._registry["compile_cache_dir"].help


def _dropout_program(fl):
    x = fl.layers.data("x", [64])
    return fl.layers.dropout(x, 0.5)


def _mask(fl, seed, xs):
    fl.reset_default_programs()
    fl.reset_global_scope()
    fl.flags.set_flag("seed", seed)
    out = _dropout_program(fl)
    exe = fl.Executor(CPU) if fl is tfluid else fl.Executor()
    exe.run(fl.default_startup_program())
    fl.global_scope().step_counter = 3
    got = exe.run(feed={"x": xs}, fetch_list=[out])[0]
    return np.asarray(got) != 0


def test_seed_flag_gives_the_reference_dropout_mask():
    """With the program's random_seed 0, the step seed is the flag's: the
    port's mask at seed flags 11 and 12 bitwise JAX's, and the two
    differ."""
    xs = np.ones((4, 64), "float32")
    masks = {}
    for seed in (11, 12):
        got, want = _mask(tfluid, seed, xs), _mask(jfluid, seed, xs)
        assert got.tobytes() == want.tobytes(), seed
        masks[seed] = got
    assert not np.array_equal(masks[11], masks[12])
    assert 0.3 < masks[11].mean() < 0.7


def test_log_clipping_prints_the_clipped_norm(capfd):
    """One step with a clip far below the gradient norm, the flag on: the
    port prints the reference's line, its norm equal to JAX's to the four
    digits both print; the flag off prints nothing."""
    lines = {}
    for fl in (jfluid, tfluid):
        for on in (False, True):
            fl.reset_default_programs()
            fl.reset_global_scope()
            fl.flags.set_flag("log_clipping", on)
            x = fl.layers.data("x", [4])
            loss = fl.layers.mean(fl.layers.fc(x, 3))
            fl.optimizer.SGD(0.1, grad_clip=fl.clip.GradientClipByGlobalNorm(
                1e-3)).minimize(loss)
            exe = fl.Executor(CPU) if fl is tfluid else fl.Executor()
            exe.run(fl.default_startup_program())
            capfd.readouterr()
            exe.run(feed={"x": np.full((2, 4), 3.0, "float32")},
                    fetch_list=[loss])
            if fl is jfluid:
                import jax

                jax.effects_barrier()
            out = capfd.readouterr().out
            lines[(fl, on)] = [ln for ln in out.splitlines()
                               if ln.startswith("clipping global grad norm")]
    assert lines[(tfluid, False)] == [] == lines[(jfluid, False)]
    (got,), (want,) = lines[(tfluid, True)], lines[(jfluid, True)]
    g, w = got.split(), want.split()
    assert g[:4] == w[:4] and g[5:] == w[5:]
    assert float(g[6]) == float(np.float32(1e-3))
    np.testing.assert_allclose(float(g[4]), float(w[4]), rtol=1e-3)

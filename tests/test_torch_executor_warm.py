"""``Executor.warm``, its signature cache and replay in ``run()``, on the CPU.

On the CPU a warmed signature is its step body re-run on static buffers
(on the card, a CUDA graph replay of the same body): these tests hold the
staging, the state copy-in, the cache and the signature rules.  The warm
sequence is the reference's (``tests/test_compile.py``'s executor warm
test, without the store), run in both packages from the same weights;
inputs come from numpy seeds."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import OpContext
from paddle_tpu_torch.core.graphs import Staged, WarmError
from paddle_tpu_torch.ops import _counters, flash_attention, paged_attention

CPU = tfluid.CPUPlace()
SMALL = dict(vocab_size=128, max_len=32, d_model=64, n_heads=2, n_layers=2,
             d_ff=128)
B = 2


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _tiny(fl):
    """The reference warm test's model with the port's layers: one fc,
    softmax-CE for its square error, SGD(0.1)."""
    x = fl.layers.data("x", [4])
    y = fl.layers.data("y", [1], dtype="int32")
    pred = fl.layers.fc(x, size=3)
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(pred, y))
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss


def _lm(fl):
    T = SMALL["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fl.models.transformer.build_lm(toks, labs, **SMALL)
    fl.optimizer.Adam(1e-3, grad_clip=fl.clip.GradientClipByGlobalNorm(
        1.0)).minimize(loss)
    return loss


def _feeds(model, seed, n=3):
    rng = np.random.RandomState(seed)
    if model == "tiny":
        return [{"x": rng.rand(B, 4).astype(np.float32),
                 "y": rng.randint(0, 3, (B, 1)).astype(np.int32)}
                for _ in range(n)]
    V, T = SMALL["vocab_size"], SMALL["max_len"]
    return [{"toks": rng.randint(0, V, (B, T)).astype(np.int32),
             "labs": rng.randint(0, V, (B, T, 1)).astype(np.int32)}
            for _ in range(n)]


def _sig(feed):
    return [(n, v.shape, v.dtype.name) for n, v in feed.items()]


def _scope_from(arrays):
    """A new port scope: the startup program run, then ``arrays``."""
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(tfluid.default_startup_program(), scope=scope)
    tfluid.load_scope(arrays, tfluid.default_main_program(), scope,
                      device="cpu")
    return scope


def _state(scope):
    return {n: v.detach().clone() for n, v in scope.items()}


@pytest.mark.parametrize("model", ["tiny", "lm"])
def test_warm_sequence_matches_jax(model, interpret_mode):
    """warm -> "compiled", warm -> "cached" (one compile), three runs add
    none, in both packages; the port's three losses within 1e-5 of the JAX
    Executor's from the same weights."""
    build = _tiny if model == "tiny" else _lm
    feeds = _feeds(model, 0)
    losses = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        loss = build(fl)
        if name == "jax":
            exe = jfluid.Executor()
            exe.run(jfluid.default_startup_program())
            init = {n: np.asarray(v) for n, v in
                    jfluid.global_scope().items()}
            scope = None
        else:
            exe = tfluid.Executor(CPU)
            scope = _scope_from(init)
        prog = fl.default_main_program()
        c0 = exe.compiles
        assert exe.warm(prog, _sig(feeds[0]), [loss.name],
                        scope=scope) == "compiled"
        assert exe.warm(prog, _sig(feeds[0]), [loss.name],
                        scope=scope) == "cached"
        assert exe.compiles == c0 + 1
        losses[name] = [float(np.asarray(exe.run(
            prog, feed=f, fetch_list=[loss], scope=scope)[0])) for f in feeds]
        assert exe.compiles == c0 + 1
    assert exe.replays == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)


def _warmed_lm(exe=None):
    """The small LM, two scopes from the same weights, a warmed Executor
    on the first."""
    loss = _lm(tfluid)
    arrays = {n: v.numpy().copy() for n, v in _scope_from({}).items()}
    exe = exe or tfluid.Executor(CPU)
    return loss, arrays, exe


def test_warm_changes_no_state_and_replay_equals_eager():
    """warm leaves every scope value and ``step_counter`` as they were (the
    scope then holds the static buffers); three replays are bitwise equal
    to three eager steps of an Executor that did not warm, from the same
    state: losses, every parameter and moment, the step counters."""
    loss, arrays, exe = _warmed_lm()
    prog = tfluid.default_main_program()
    warm_scope, eager_scope = _scope_from(arrays), _scope_from(arrays)
    before, counter = _state(warm_scope), warm_scope.step_counter
    old = dict(warm_scope.items())
    feeds = _feeds("lm", 1)
    assert exe.warm(prog, _sig(feeds[0]), [loss], scope=warm_scope) == \
        "compiled"
    assert warm_scope.step_counter == counter
    assert warm_scope.var_names() == list(before)
    for n, v in warm_scope.items():
        assert torch.equal(v, before[n]), n
        assert v is not old[n], n
    eager = tfluid.Executor(CPU)
    for f in feeds:
        a = exe.run(prog, feed=f, fetch_list=[loss], scope=warm_scope)[0]
        b = eager.run(prog, feed=f, fetch_list=[loss], scope=eager_scope)[0]
        assert a.tobytes() == b.tobytes()
    assert eager.compiles == eager.replays == 0 and exe.replays == 3
    assert warm_scope.step_counter == eager_scope.step_counter == counter + 3
    for n, v in eager_scope.items():
        assert torch.equal(warm_scope.find_var(n), v), n
    assert any(n.endswith(".moment2") for n in warm_scope.var_names())


def test_set_var_after_warm_is_copied_in():
    """A ``set_var`` between runs (a checkpoint load) is copied into the
    static buffer, and the scope points at the buffer again."""
    loss, arrays, exe = _warmed_lm()
    prog = tfluid.default_main_program()
    scope, ref = _scope_from(arrays), _scope_from(arrays)
    f = _feeds("lm", 2)
    exe.warm(prog, _sig(f[0]), [loss], scope=scope)
    buf = scope.find_var("tok_emb")
    exe.run(prog, feed=f[0], fetch_list=[loss], scope=scope)
    new = torch.from_numpy(np.random.RandomState(3).randn(
        *buf.shape).astype(np.float32) * 0.02)
    scope.set_var("tok_emb", new)
    # the reference: an eager step from the same state
    for n in ref.var_names():
        ref.set_var(n, scope.find_var(n).clone())
    ref.step_counter = scope.step_counter
    eager = tfluid.Executor(CPU)
    a = exe.run(prog, feed=f[1], fetch_list=[loss], scope=scope)[0]
    b = eager.run(prog, feed=f[1], fetch_list=[loss], scope=ref)[0]
    assert a.tobytes() == b.tobytes()
    assert scope.find_var("tok_emb") is buf
    assert torch.equal(buf, ref.find_var("tok_emb"))
    with pytest.raises(ValueError, match="tok_emb"):
        scope.set_var("tok_emb", torch.zeros(3, 3))
        exe.run(prog, feed=f[2], fetch_list=[loss], scope=scope)


def test_two_scopes_two_signatures_no_aliasing():
    loss, arrays, exe = _warmed_lm()
    prog = tfluid.default_main_program()
    s1, s2 = _scope_from(arrays), _scope_from(arrays)
    f = _feeds("lm", 4)
    assert exe.warm(prog, _sig(f[0]), [loss], scope=s1) == "compiled"
    assert exe.warm(prog, _sig(f[0]), [loss], scope=s2) == "compiled"
    assert exe.compiles == 2
    ptrs1 = {v.data_ptr() for v in s1._vars.values()}
    ptrs2 = {v.data_ptr() for v in s2._vars.values()}
    assert not ptrs1 & ptrs2
    s2_before = _state(s2)
    exe.run(prog, feed=f[0], fetch_list=[loss], scope=s1)
    for n, v in s2.items():
        assert torch.equal(v, s2_before[n]), n
    assert not torch.equal(s1.find_var("tok_emb"), s2.find_var("tok_emb"))
    exe.run(prog, feed=f[0], fetch_list=[loss], scope=s2)
    assert torch.equal(s1.find_var("tok_emb"), s2.find_var("tok_emb"))
    assert exe.replays == 2 and exe.compiles == 2


def test_append_op_after_warm_is_a_new_signature():
    """An op appended after warm bumps ``version``: ``run()`` of the new
    version runs eagerly (nothing replayed, nothing prepared), and warm
    prepares it anew."""
    loss, arrays, exe = _warmed_lm()
    prog = tfluid.default_main_program()
    scope = _scope_from(arrays)
    f = _feeds("lm", 5)
    exe.warm(prog, _sig(f[0]), [loss], scope=scope)
    v = prog.version
    sq = tfluid.layers.square(loss)
    assert prog.version > v
    out = exe.run(prog, feed=f[0], fetch_list=[loss, sq], scope=scope)
    assert exe.replays == 0 and exe.compiles == 1
    assert out[1] == out[0] * out[0]
    assert exe.warm(prog, _sig(f[0]), [loss], scope=scope) == "compiled"
    exe.run(prog, feed=f[1], fetch_list=[loss], scope=scope)
    assert exe.replays == 1 and exe.compiles == 2


@pytest.mark.parametrize("toggle", ["enable", "disable"])
def test_amp_toggle_after_warm_is_a_new_signature(toggle):
    """``amp.enable`` / ``amp.disable`` after warm bump ``version``, as the
    reference's do: the warmed step holds the policy it was prepared
    under, so ``run()`` replays nothing and runs the new policy op by op,
    bitwise as an Executor that never warmed; warm then prepares the new
    version."""
    loss, arrays, exe = _warmed_lm()
    prog = tfluid.default_main_program()
    if toggle == "disable":
        tfluid.amp.enable(prog)
    scope, ref = _scope_from(arrays), _scope_from(arrays)
    f = _feeds("lm", 8)
    assert exe.warm(prog, _sig(f[0]), [loss], scope=scope) == "compiled"
    v = prog.version
    getattr(tfluid.amp, toggle)(prog)
    assert prog.version == v + 1
    a = exe.run(prog, feed=f[0], fetch_list=[loss], scope=scope)[0]
    assert exe.replays == 0 and exe.compiles == 1
    b = tfluid.Executor(CPU).run(prog, feed=f[0], fetch_list=[loss],
                                 scope=ref)[0]
    assert a.tobytes() == b.tobytes()
    assert exe.warm(prog, _sig(f[0]), [loss], scope=scope) == "compiled"
    exe.run(prog, feed=f[1], fetch_list=[loss], scope=scope)
    assert exe.replays == 1 and exe.compiles == 2


def test_fetch_tensors_survive_the_next_run():
    """``return_numpy=False`` fetches are copies: the next replay leaves
    them alone.  A fetched gradient and a fed tensor come back too."""
    loss, arrays, exe = _warmed_lm()
    prog = tfluid.default_main_program()
    scope = _scope_from(arrays)
    f = _feeds("lm", 6)
    fetch = [loss, "tok_emb@GRAD", "toks"]
    exe.warm(prog, _sig(f[0]), fetch, scope=scope)
    first = exe.run(prog, feed=f[0], fetch_list=fetch, scope=scope,
                    return_numpy=False)
    kept = [t.clone() for t in first]
    second = exe.run(prog, feed={k: torch.from_numpy(v)
                                 for k, v in f[1].items()},
                     fetch_list=fetch, scope=scope, return_numpy=False)
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert not torch.equal(first[1], second[1])
    assert np.array_equal(first[2].numpy(), f[0]["toks"])
    assert np.array_equal(second[2].numpy(), f[1]["toks"])


def test_not_warmed_run_prepares_nothing():
    loss, arrays, exe = _warmed_lm()
    scope = _scope_from(arrays)
    f = _feeds("lm", 7)
    old = scope.find_var("tok_emb")
    exe.run(feed=f[0], fetch_list=[loss], scope=scope)
    assert exe.compiles == exe.replays == 0 and not exe._cache
    assert scope.find_var("tok_emb") is not old


def test_warm_refusals(tmp_path):
    """A feed signature whose dtype or shape the variable refuses raises
    before anything is prepared or stored (``store=``, the AOT store, is
    left empty)."""
    loss = _tiny(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    prog = tfluid.default_main_program()
    sig = [("x", (2, 4), "float32"), ("y", (2, 1), "int32")]
    store = tfluid.compile.AOTStore(str(tmp_path / "aot"))
    with pytest.raises(ValueError, match="declares float32"):
        exe.warm(prog, [("x", (2, 4), "int32"), sig[1]], [loss.name],
                 store=store)
    with pytest.raises(ValueError, match="dim 1 is 5"):
        exe.warm(prog, [("x", (2, 5), "float32"), sig[1]], [loss.name],
                 store=store)
    assert exe.compiles == 0 and store.entries() == []
    assert exe.warm(prog, sig, [loss.name]) == "compiled"


def _probe_op(prog, draw=False, fail=None):
    """Append an op that doubles ``x``: with ``draw`` through
    ``ctx.rng``, with ``fail`` raising while ``fail["on"]``."""
    blk = prog.global_block
    out = blk.create_var("probe.out", (None, 4), "float32")

    def fn(ins, attrs, ctx):
        if fail is not None and fail["on"]:
            raise RuntimeError("probe failed")
        x = ins["X"][0]
        if draw:
            x = x + torch.rand(x.shape, generator=ctx.rng(1))
        return {"Out": [x * 2]}

    blk.append_op(tfluid.core.Op("probe", {"X": ["x"]}, {"Out": [out.name]},
                                 {}, fn))
    return out


def test_rng_in_a_warmed_step_raises():
    """An op drawing from ``ctx.rng`` runs unwarmed, and raises in a warmed
    step, whose replays would repeat its draws."""
    _tiny(tfluid)
    prog = tfluid.default_main_program()
    out = _probe_op(prog, draw=True)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    feed = _feeds("tiny", 8)[0]
    exe.run(prog, feed=feed, fetch_list=[out])
    before = _state(tfluid.global_scope())
    with pytest.raises(WarmError, match="ctx.rng") as info:
        exe.warm(prog, _sig(feed), [out])
    assert "signature of program version" in str(info.value)
    assert exe.compiles == 0 and not exe._cache
    for n, v in tfluid.global_scope().items():
        assert v is not None and torch.equal(v, before[n]), n
    with pytest.raises(RuntimeError, match="warmed step"):
        OpContext(warmed=True).rng(0)


def test_failed_replay_raises_and_runs_nothing_eagerly():
    """A replay that fails raises ``WarmError`` naming the signature; the
    step is not run op by op in its place, and the step counter stays."""
    loss = _tiny(tfluid)
    prog = tfluid.default_main_program()
    fail = {"on": False}
    out = _probe_op(prog, fail=fail)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    feed = _feeds("tiny", 9)[0]
    exe.warm(prog, _sig(feed), [loss, out])
    counter = tfluid.global_scope().step_counter
    fail["on"] = True
    with pytest.raises(WarmError, match="replaying the signature"):
        exe.run(prog, feed=feed, fetch_list=[loss, out])
    assert tfluid.global_scope().step_counter == counter
    assert exe.replays == 0
    fail["on"] = False
    got = exe.run(prog, feed=feed, fetch_list=[loss, out])
    np.testing.assert_array_equal(got[1], feed["x"] * 2)


def test_staged_fields_of_any_dtype():
    """``Staged`` packs int32, uint32, int64, float32 and bfloat16 fields
    in one buffer, each 256-byte aligned, filled from numpy or tensors."""
    fields = [("a", (3, 5), np.int32), ("s", (4,), np.uint32),
              ("l", (2, 3), torch.int64), ("f", (7,), torch.float32),
              ("h", (2, 2), torch.bfloat16)]
    st = Staged(fields, torch.device("cpu"))
    base = st.dev.data_ptr()
    for name, shape, _ in fields:
        assert tuple(st.t[name].shape) == shape
        assert (st.t[name].data_ptr() - base) % 256 == 0
    assert st.t["s"].dtype == torch.int32 and st.np["s"].dtype == np.uint32
    assert "h" not in st.np and st.t["h"].dtype == torch.bfloat16
    rng = np.random.RandomState(0)
    vals = {"a": rng.randint(-9, 9, (3, 5)).astype(np.int32),
            "s": np.array([0, 1, 2 ** 31 + 5, 2 ** 32 - 1], np.uint32),
            "l": torch.arange(6, dtype=torch.int64).view(2, 3),
            "f": rng.randn(7).astype(np.float32),
            "h": torch.tensor([[1.5, -2.0], [0.25, 3.0]],
                              dtype=torch.bfloat16)}
    st.stage(vals)
    assert np.array_equal(st.t["a"].numpy(), vals["a"])
    assert np.array_equal(st.np["s"], vals["s"])
    assert np.array_equal(st.t["s"].numpy().view(np.uint32), vals["s"])
    assert torch.equal(st.t["l"], vals["l"])
    assert np.array_equal(st.t["f"].numpy(), vals["f"])
    assert torch.equal(st.t["h"], vals["h"])


def test_counter_registry_round_trip():
    """snapshot / restore / delta / add over every kernel counter: what a
    capture takes back and each replay adds."""
    assert set(_counters.COUNTERS) == {
        "paged_attention.launches", "flash_attention.launches",
        "flash_attention.dtype_launches", "fused_lstm.launches",
        "fused_lstm.route_launches", "batch_norm_train.launches",
        "conv.launches", "conv.route_launches",
        "threefry_dropout.launches", "threefry_dropout.dtype_launches"}
    before = _counters.snapshot()
    fwd = flash_attention.launches
    try:
        flash_attention.launches["fwd"] += 6
        flash_attention.dtype_launches["bfloat16"]["bwd_dq"] += 6
        paged_attention.launches += 2
        after = _counters.snapshot()
        d = _counters.delta(before, after)
        assert d["flash_attention.launches"]["fwd"] == 6
        assert d["flash_attention.dtype_launches"]["bfloat16"]["bwd_dq"] == 6
        assert d["paged_attention.launches"] == 2
        assert d["conv.route_launches"] == {"halo": 0, "halo_f32": 0,
                                            "gather": 0}
        _counters.restore(before)
        assert _counters.snapshot() == before
        _counters.add(d)
        _counters.add(d)
        assert flash_attention.launches["fwd"] == before[
            "flash_attention.launches"]["fwd"] + 12
        assert flash_attention.launches is fwd
    finally:
        _counters.restore(before)
    assert _counters.snapshot() == before

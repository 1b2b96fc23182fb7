"""paddle_tpu_torch's training slice against the JAX package on the CPU:
one-op programs per ported layer, ``build_lm``'s program structure, two
Adam steps with global-norm clipping on a tiny LM from the same weights
(JAX with its Pallas flash kernels interpreted), the raw step against
``__graft_entry__.entry()``, and the Executor's errors.  Weights move from
the JAX scope into the port's with ``load_scope``; inputs come from numpy
seeds."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique_name
from paddle_tpu_torch.core import unique_name as t_unique_name
from paddle_tpu_torch.models import lm_param_shapes

CPU = tfluid.CPUPlace()
# float32 on both sides, sums in another order
OUT_ATOL = 1e-5
TINY = dict(vocab_size=61, max_len=16, d_model=32, n_heads=4, n_layers=2,
            d_ff=64)


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Fresh default programs, scope and names in the port (the JAX
    package's are reset by tests/conftest.py)."""
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _jax_state(scope=None):
    scope = scope or jfluid.global_scope()
    return {n: np.asarray(v) for n, v in scope.items()}


def _port_run_from(jax_state, fetch, feed):
    """Run the port's startup program, overwrite the state with the JAX
    package's arrays, then one main-program step; returns the fetches."""
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(jax_state, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    return exe.run(feed=feed, fetch_list=fetch)


# ------------------------------------------------------------ single layers


def _layer_case(fl, which):
    """(loss var, output var, feed) for one layer in a one-op program (a
    param-free layer sits on an fc so that the program has a gradient)."""
    L = fl.layers
    rng = np.random.RandomState(3)
    x = L.data("x", [5, 6])
    feed = {"x": rng.randn(4, 5, 6).astype(np.float32)}
    if which == "fc":
        out = L.fc(x, 7, num_flatten_dims=2)
    elif which == "embedding":
        ids = L.data("ids", [5, 1], dtype="int32")
        feed = {"ids": rng.randint(0, 9, (4, 5, 1)).astype(np.int32)}
        feed["ids"][0, :2] = 3                        # the padding row
        out = L.embedding(ids, [9, 6], padding_idx=3)
    elif which == "layer_norm":
        feed["x"] = feed["x"] * 3.0 + 1.5
        out = L.layer_norm(x, begin_norm_axis=2)
    elif which == "gelu":
        out = L.gelu(L.fc(x, 7, num_flatten_dims=2))
    elif which == "softmax_with_cross_entropy":
        lab = L.data("lab", [5, 1], dtype="int32")
        feed["lab"] = rng.randint(0, 7, (4, 5, 1)).astype(np.int32)
        out = L.softmax_with_cross_entropy(L.fc(x, 7, num_flatten_dims=2),
                                           lab)
    elif which == "mean":
        out = L.mean(L.fc(x, 7, num_flatten_dims=2))
    return (out if which == "mean" else L.mean(out)), out, feed


@pytest.mark.parametrize("which", ["fc", "embedding", "layer_norm", "gelu",
                                   "softmax_with_cross_entropy", "mean"])
def test_layer_matches_jax(which):
    """Output and every parameter gradient of the layer, both packages, the
    same weights (atol 1e-5)."""
    outs = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        loss, out, feed = _layer_case(fl, which)
        pg = fl.backward.append_backward(loss)
        fetch = [out] + [g for _, g in pg]
        if name == "jax":
            exe = jfluid.Executor()
            exe.run(jfluid.default_startup_program())
            state = _jax_state()
            outs[name] = exe.run(feed=feed, fetch_list=fetch)
        else:
            outs[name] = _port_run_from(state, fetch, feed)
        outs[name + "_names"] = [f.name for f in fetch]
    assert outs["jax_names"] == outs["port_names"]
    assert len(outs["port"]) >= 2
    for n, a, b in zip(outs["port_names"], outs["port"], outs["jax"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=OUT_ATOL, rtol=0,
                                   err_msg=n)


def test_embedding_padding_row_gets_no_gradient():
    _, out, feed = _layer_case(tfluid, "embedding")
    loss = tfluid.layers.mean(out)
    (_, g), = tfluid.backward.append_backward(loss)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    o, gv = exe.run(feed=feed, fetch_list=[out, g])
    assert np.all(o[0, :2] == 0) and np.all(gv[3] == 0)
    assert np.abs(gv).sum() > 0
    with pytest.raises(NotImplementedError, match="A.8"):
        tfluid.layers.embedding(tfluid.layers.data("i2", [1], "int32"),
                                [9, 6], is_sparse=True)


# --------------------------------------------------------------- build_lm


def _build_lm(fl, clip_norm=1.0, **cfg):
    cfg = dict(TINY, **cfg)
    T = cfg["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fl.models.transformer.build_lm(toks, labs, **cfg)
    fl.optimizer.Adam(1e-3, grad_clip=fl.clip.GradientClipByGlobalNorm(
        clip_norm)).minimize(loss)
    return loss


def _dtype_name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def test_build_lm_program_matches_jax():
    """The same persistable names, shapes and dtypes, the same op-type
    sequences in the main and startup programs after ``minimize``, and a
    parameter set equal to ``lm_param_shapes``."""
    _build_lm(jfluid)
    _build_lm(tfluid)
    progs = [(jfluid.default_main_program(), tfluid.default_main_program()),
             (jfluid.default_startup_program(),
              tfluid.default_startup_program())]
    for jp, tp in progs:
        jv = {v.name: (tuple(v.shape), _dtype_name(v.dtype))
              for v in jp.persistable_vars()}
        tv = {v.name: (tuple(v.shape), _dtype_name(v.dtype))
              for v in tp.persistable_vars()}
        assert tv == jv
        assert [o.type for o in tp.list_ops()] == [o.type for o in jp.list_ops()]
    assert "blk0.q.w.adam_0.moment1" in tv
    params = {p.name: tuple(p.shape)
              for p in tfluid.default_main_program().parameters()}
    assert params == {n: tuple(s) for n, s in lm_param_shapes(
        TINY["vocab_size"], TINY["max_len"], TINY["d_model"],
        TINY["n_heads"], TINY["n_layers"], TINY["d_ff"]).items()}


@pytest.mark.parametrize("kw,match", [
    (dict(remat=True), "recompute"), (dict(dropout=0.1), "dropout"),
    (dict(use_tp=True), "A.9"), (dict(use_sp=True), "A.9")])
def test_build_lm_options_not_ported_raise(kw, match):
    """``use_tp`` and ``use_sp`` are not ported and raise (A.9).  ``remat``
    and ``dropout`` are ported (A.6): the build holds their op, and with
    ``use_tp`` beside them it still raises A.9."""
    if match == "A.9":
        with pytest.raises(NotImplementedError, match=match):
            _build_lm(tfluid, **kw)
        return
    _build_lm(tfluid, **kw)
    assert match in {op.type for op in
                     tfluid.default_main_program().list_ops()}
    tfluid.reset_default_programs()
    with pytest.raises(NotImplementedError, match="A.9"):
        _build_lm(tfluid, use_tp=True, **kw)


# ------------------------------------------------------------ training steps


@pytest.mark.parametrize("clip_norm", [0.01, 1e6])
def test_two_adam_steps_match_jax(interpret_mode, clip_norm):
    """Two Adam steps with global-norm clipping, JAX's flash attention on
    its Pallas kernels (interpreted), from the same weights (JAX's startup
    draws, read back and loaded into the port).  clip_norm 0.01 clips every
    step (the global norm is about 1); 1e6 never does.  Both losses within
    rtol 1e-5; every parameter within atol 2e-5 (two steps of lr 1e-3
    move a weight by at most 2e-3); moments within 1e-4 of their max |.|
    (moment2 squares gradients whose sums run in another order)."""
    rng = np.random.RandomState(7)
    V, T = TINY["vocab_size"], TINY["max_len"]
    feed = {"toks": rng.randint(0, V, (3, T)).astype(np.int32),
            "labs": rng.randint(0, V, (3, T, 1)).astype(np.int32)}
    jloss = _build_lm(jfluid, clip_norm)
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    init = _jax_state()
    jl = [float(np.asarray(jexe.run(feed=feed, fetch_list=[jloss])[0]))
          for _ in range(2)]
    after = _jax_state()

    tloss = _build_lm(tfluid, clip_norm)
    texe = tfluid.Executor(CPU)
    texe.run(tfluid.default_startup_program())
    tfluid.load_scope(init, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    tl = [float(texe.run(feed=feed, fetch_list=[tloss])[0]) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[1] < tl[0]
    tstate = {n: v.numpy() for n, v in tfluid.global_scope().items()}
    assert set(tstate) == set(after)
    for n, want in after.items():
        got = tstate[n]
        if n.endswith((".moment1", ".moment2")):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - want).max() <= 1e-4 * scale, n
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0,
                                       err_msg=n)
    # the clip fired at 0.01: every moment1 is then at most 0.1 * 0.01
    m1 = sum(float(np.square(v).sum()) for n, v in tstate.items()
             if n.endswith(".moment1"))
    if clip_norm == 0.01:
        assert np.sqrt(m1) <= 0.1 * 0.01 * 1.9 + 1e-9
    else:
        assert np.sqrt(m1) > 0.1 * 0.01 * 1.9


def test_raw_step_matches_graft_entry():
    """``build_raw_step`` of the port against ``__graft_entry__.entry()``'s
    function on the same weights and feed: the forward loss (rtol 1e-5)."""
    import __graft_entry__ as graft

    fn, (state, feed, key) = graft.entry()
    want = float(np.asarray(fn(state, feed, key)))
    arrays = {n: np.asarray(v) for n, v in state.items()}

    T, V = 64, 1024
    toks = tfluid.layers.data("toks", [T], dtype="int32")
    labs = tfluid.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = tfluid.models.build_lm(toks, labs, V, max_len=T, d_model=128,
                                     n_heads=4, n_layers=2, d_ff=512)
    exe = tfluid.Executor(CPU)
    scope = tfluid.global_scope()
    tfluid.load_scope(arrays, tfluid.default_main_program(), scope,
                      device="cpu")
    step, tstate = exe.build_raw_step(tfluid.default_main_program(),
                                      ["toks", "labs"], [loss.name], scope)
    assert set(tstate) == set(arrays)
    tfeed = {n: torch.from_numpy(np.asarray(v)) for n, v in feed.items()}
    fetches, new_state = step(tstate, tfeed, 0)
    assert new_state.keys() == tstate.keys()
    np.testing.assert_allclose(float(fetches[0]), want, rtol=1e-5)


# ------------------------------------------------------------ errors


def _messages(fn):
    out = []
    for fl in (jfluid, tfluid):
        with pytest.raises((ValueError, RuntimeError)) as info:
            fn(fl)
        out.append((type(info.value), str(info.value)))
    return out


def test_feed_shape_errors_match_jax():
    def bad_rank(fl):
        x = fl.layers.data("x", [5])
        out = fl.layers.mean(fl.layers.fc(x, 3))
        exe = fl.Executor(CPU if fl is tfluid else None)
        exe.run(fl.default_startup_program())
        exe.run(feed={"x": np.zeros((2, 5, 1), np.float32)}, fetch_list=[out])

    def bad_dim(fl):
        x = fl.layers.data("x", [5])
        out = fl.layers.mean(fl.layers.fc(x, 3))
        exe = fl.Executor(CPU if fl is tfluid else None)
        exe.run(fl.default_startup_program())
        exe.run(feed={"x": np.zeros((2, 4), np.float32)}, fetch_list=[out])

    for case in (bad_rank, bad_dim):
        jfluid.reset_default_programs()
        tfluid.reset_default_programs()
        (jt, jm), (tt, tm) = _messages(case)
        assert tt is jt is ValueError
        assert tm == jm


def test_startup_not_run_error_matches_jax():
    def no_startup(fl):
        x = fl.layers.data("x", [5])
        out = fl.layers.mean(fl.layers.fc(x, 3))
        exe = fl.Executor(CPU if fl is tfluid else None)
        exe.run(feed={"x": np.zeros((2, 5), np.float32)}, fetch_list=[out])

    (jt, jm), (tt, tm) = _messages(no_startup)
    assert tt is jt is RuntimeError
    assert tm == jm and "startup" in tm


def test_unique_names_match_jax():
    """The port's unique_name is a copy: the same names, resets and
    guards."""
    for un in (j_unique_name, t_unique_name):
        un.reset()
    seq = ["adam", "fc", "adam", "tmp"]
    assert [t_unique_name.generate(p) for p in seq] == \
        [j_unique_name.generate(p) for p in seq]
    with t_unique_name.guard():
        assert t_unique_name.generate("adam") == "adam_0"
    assert t_unique_name.generate("adam") == "adam_2"


def test_optimizer_options_not_ported_raise():
    """Parallel strategies are not ported and raise (A.9).  Accumulation
    and regularization are ported (A.6): they construct, and a count that
    is not a positive integer raises as in the reference."""
    assert tfluid.optimizer.Adam(1e-3, accumulate_steps=2)._accumulate == 2
    reg = tfluid.regularizer.L2Decay(1e-4)
    assert tfluid.optimizer.Adam(1e-3, regularization=reg)._regularization \
        is reg
    for bad in (0, 1.5):
        with pytest.raises(ValueError, match="positive integer"):
            tfluid.optimizer.Adam(1e-3, accumulate_steps=bad)
    with pytest.raises(NotImplementedError, match="A.9"):
        tfluid.Executor(CPU, strategy=object())


@pytest.mark.parametrize("n_heads,ok", [(2, True), (4, True), (1, False)])
def test_flash_head_dim_refused_on_card_before_first_step(n_heads, ok):
    """Head dims 32 and 16 (d_model 64) pass ``check_kernel_shapes`` for a
    CUDA place; 48 (d_model 48, one head) is refused with the kernels' own
    message before the step's first op, and the CPU place runs it on the
    plain versions.  No card is needed: the check comes before any feed or
    state moves to the device."""
    from paddle_tpu_torch.core.executor import check_kernel_shapes

    d_model = {2: 64, 4: 64, 1: 48}[n_heads]
    loss = _build_lm(tfluid, d_model=d_model, n_heads=n_heads)
    main = tfluid.default_main_program()
    check_kernel_shapes(main, torch.device("cpu"))
    if ok:
        check_kernel_shapes(main, torch.device("cuda"))
        return
    with pytest.raises(ValueError, match=r"flash kernels take head dims "
                                         r"\(16, 32, 64, 128\), got D=48"):
        check_kernel_shapes(main, torch.device("cuda"))

    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    before = {n: v.clone() for n, v in tfluid.global_scope().items()}
    steps = tfluid.global_scope().step_counter
    rng = np.random.RandomState(3)
    V, T = TINY["vocab_size"], TINY["max_len"]
    feed = {"toks": rng.randint(0, V, (2, T)).astype(np.int32),
            "labs": rng.randint(0, V, (2, T, 1)).astype(np.int32)}
    # an Executor for the card: refused before its first op, so the step
    # counter, the parameters and the moments stay as they were
    card = tfluid.Executor(CPU)
    card.device = torch.device("cuda")
    with pytest.raises(ValueError, match="got D=48"):
        card.run(feed=feed, fetch_list=[loss])
    assert tfluid.global_scope().step_counter == steps
    for n, v in tfluid.global_scope().items():
        assert torch.equal(v, before[n]), n
    # the CPU runs the same program
    out, = exe.run(feed=feed, fetch_list=[loss])
    assert np.isfinite(out).all()
    assert any(not torch.equal(v, before[n])
               for n, v in tfluid.global_scope().items())

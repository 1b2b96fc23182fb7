"""The LM with dropout, the port against the JAX package on the CPU:
``build_lm(dropout=0.1)`` at 2 layers, d = 32, T = 16 for three steps of
Transformer-base's optimizer (Adam(0.9, 0.98, 1e-9) on ``noam_decay``,
global-norm clip 1.0) from the same weights, JAX's flash attention on its
Pallas kernels (interpreted); the port with and without remat against the
reference without remat (the reference's remat reuses mask tags, ROADMAP
C.7).  Both draw bitwise-equal masks, so the float32 train tolerances of
``tests/test_torch_train.py`` hold.  Then ``Executor.warm`` on the CPU:
warmed runs bitwise equal to eager ones, each step with its own masks."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid

CPU = tfluid.CPUPlace()
TINY = dict(vocab_size=61, max_len=16, d_model=32, n_heads=4, n_layers=2,
            d_ff=64)
STEPS = 3


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _build(fl, remat=False):
    """The tiny LM with dropout 0.1 and Transformer-base's optimizer; noam
    scaled by 0.01 so that the rate (2.2e-4 to 6.6e-4 over the three
    steps) moves weights as far as the train tests' Adam(1e-3) does."""
    T = TINY["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fl.models.transformer.build_lm(toks, labs, dropout=0.1,
                                             remat=remat, **TINY)
    fl.optimizer.Adam(
        fl.learning_rate_decay.noam_decay(TINY["d_model"], 4, scale=0.01),
        beta1=0.9, beta2=0.98, epsilon=1e-9,
        grad_clip=fl.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
    return loss


def _feed(seed=7, n=3):
    rng = np.random.RandomState(seed)
    V, T = TINY["vocab_size"], TINY["max_len"]
    return {"toks": rng.randint(0, V, (n, T)).astype(np.int32),
            "labs": rng.randint(0, V, (n, T, 1)).astype(np.int32)}


@pytest.mark.parametrize("remat", [False, True])
def test_dropout_lm_matches_jax(interpret_mode, remat):
    """Three steps at step counters 5, 6, 7: losses within rtol 1e-5;
    every parameter within atol 2e-5; moments within 1e-4 of their max
    abs; the optimizer step 3 in both (the train tests' float32
    tolerances).  The losses differ step to step by more than the weights
    move them: each step draws its own masks."""
    feed = _feed()
    jloss = _build(jfluid)
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    init = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}
    jfluid.global_scope().step_counter = 5
    jl = [float(np.asarray(jexe.run(feed=feed, fetch_list=[jloss])[0]))
          for _ in range(STEPS)]
    after = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}

    tloss = _build(tfluid, remat)
    texe = tfluid.Executor(CPU)
    texe.run(tfluid.default_startup_program())
    scope = tfluid.global_scope()
    tfluid.load_scope(init, tfluid.default_main_program(), scope,
                      device="cpu")
    scope.step_counter = 5
    tl = [float(texe.run(feed=feed, fetch_list=[tloss])[0])
          for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert scope.step_counter == 5 + STEPS
    tstate = {n: v.numpy() for n, v in scope.items()}
    assert set(tstate) == set(after)
    for n, want in after.items():
        got = tstate[n]
        if n.endswith((".moment1", ".moment2")):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - want).max() <= 1e-4 * scale, n
        elif n.endswith(".step"):
            assert got.tolist() == want.tolist() == [STEPS]
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0,
                                       err_msg=n)


def _dropout_out(prog):
    """The first dropout op's output (after the positional add)."""
    return next(o for o in prog.list_ops()
                if o.type == "dropout").outputs["Out"][0]


def test_warmed_runs_bitwise_equal_eager_with_new_masks_each_step():
    """``Executor.warm`` of the dropout LM with remat on the CPU: three
    warmed runs (the body on static buffers, the step counter read from
    the staged field) bitwise equal to three eager runs of an Executor
    that did not warm, from the same weights and step counter: losses, the
    first dropout's output and the state; each step's mask (the zeros of
    that output) differs from the last."""
    loss = _build(tfluid, remat=True)
    prog = tfluid.default_main_program()
    drop = _dropout_out(prog)
    params = tfluid.init_lm_params(3, **TINY)
    feed = _feed(11, 2)
    runs = []
    for warm in (True, False):
        exe = tfluid.Executor(CPU)
        scope = tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        tfluid.load_scope(params, prog, scope, device="cpu")
        scope.step_counter = 2 ** 32 - 2
        if warm:
            sig = [(n, v.shape, v.dtype.name) for n, v in feed.items()]
            assert exe.warm(prog, sig, [loss, drop], scope=scope) == \
                "compiled"
        outs = [exe.run(prog, feed=feed, fetch_list=[loss, drop],
                        scope=scope) for _ in range(3)]
        assert exe.replays == (3 if warm else 0)
        runs.append((outs, {n: v.clone() for n, v in scope.items()},
                     scope.step_counter))
    (w_outs, w_state, w_count), (e_outs, e_state, e_count) = runs
    assert w_count == e_count == 2 ** 32 + 1
    for (wl, wd), (el, ed) in zip(w_outs, e_outs):
        assert wl.tobytes() == el.tobytes() and wd.tobytes() == ed.tobytes()
    for n, v in e_state.items():
        assert torch.equal(w_state[n], v), n
    masks = [d == 0 for _, d in w_outs]
    assert all(m.any() for m in masks)
    assert not np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[1], masks[2])

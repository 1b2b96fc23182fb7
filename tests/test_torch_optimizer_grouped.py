"""Grouped optimizer updates (``Optimizer.apply_group``, ``torch._foreach_*``)
against the per-op rule, and the grouped step against the JAX package.

The Executor runs each run of consecutive update ops of one group as one
grouped call.  On the CPU that call is bitwise equal to running the ops one
by one (the same expression order, the same roundings): the per-op path is
the Executor with its grouping turned off.  The program still holds one
update op per parameter, as the JAX package's does."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor

CPU = tfluid.CPUPlace()
# the small LM of the port's warm tests
SMALL = dict(vocab_size=128, max_len=32, d_model=64, n_heads=2, n_layers=2,
             d_ff=128)


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _optimizer(kind, clip):
    clip = tfluid.clip.GradientClipByGlobalNorm(0.05) if clip else None
    if kind == "adam":
        return tfluid.optimizer.Adam(1e-2, grad_clip=clip)
    if kind == "momentum":
        return tfluid.optimizer.Momentum(0.05, momentum=0.9, grad_clip=clip)
    if kind == "nesterov":
        return tfluid.optimizer.Momentum(0.05, momentum=0.9,
                                         use_nesterov=True, grad_clip=clip)
    return tfluid.optimizer.SGD(0.05, grad_clip=clip)


def _mlp(kind, clip):
    """Three fc layers, the middle one with a learning-rate multiplier of
    0.5 (a second group call), softmax-CE."""
    L = tfluid.layers
    x = L.data("x", [6])
    lab = L.data("lab", [1], dtype="int32")
    h = L.fc(x, 16, act="relu")
    h = L.fc(h, 12, act="relu", param_attr=tfluid.ParamAttr(
        learning_rate=0.5))
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 5), lab))
    opt = _optimizer(kind, clip)
    opt.minimize(loss)
    return loss, opt


def _steps(loss, feed, n, grouped, monkeypatch):
    """``n`` steps from the startup's draws; the losses, the scope before
    and the scope after, as numpy."""
    if not grouped:
        monkeypatch.setattr(t_executor, "_grouped", list)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program(), scope=scope)
    init = {k: v.numpy().copy() for k, v in scope.items()}
    losses = [exe.run(feed=feed, fetch_list=[loss], scope=scope)[0]
              for _ in range(n)]
    monkeypatch.undo()
    return losses, init, {k: v.numpy().copy() for k, v in scope.items()}


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("kind", ["adam", "momentum", "nesterov", "sgd"])
def test_grouped_update_bitwise_equal_to_per_op(kind, clip, monkeypatch):
    """Three steps: every loss, parameter and accumulator bit for bit."""
    loss, opt = _mlp(kind, clip)
    ops = tfluid.default_main_program().list_ops()
    upd = [op for op in ops if op.group is not None]
    params = tfluid.default_main_program().parameters()
    # one update op per parameter, in the parameters' order, all of one
    # group; two group calls (learning-rate multipliers 1 and 0.5)
    assert [op.inputs["Param"][0] for op in upd] == [p.name for p in params]
    assert all(op.group is opt and op.type == type(opt).__name__.lower()
               for op in upd)
    units = t_executor._grouped(ops)
    assert sum(isinstance(u, tuple) for u in units) == 1
    assert sorted(set(opt._lr_mults.values())) == [0.5, 1.0]
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(9, 6).astype(np.float32),
            "lab": rng.randint(0, 5, (9, 1)).astype(np.int32)}
    got_l, init, got = _steps(loss, feed, 3, True, monkeypatch)
    want_l, init2, want = _steps(loss, feed, 3, False, monkeypatch)
    assert got.keys() == want.keys() == init.keys()
    for n in want:
        assert np.array_equal(init[n], init2[n]), n
        assert np.array_equal(got[n], want[n]), n
    assert [float(x) for x in got_l] == [float(x) for x in want_l]
    for p in params:
        assert not np.array_equal(want[p.name], init[p.name]), p.name


def test_global_norm_clip_scaling_bitwise():
    """The clip's scaling as one ``_foreach_mul`` equals the per-gradient
    product bit for bit; its norm is the per-gradient sums of squares added
    in order."""
    rng = np.random.RandomState(2)
    grads = {f"g{i}": torch.from_numpy(rng.randn(*s).astype(np.float32))
             for i, s in enumerate([(7, 3), (11,), (4, 5, 2)])}
    clip = tfluid.clip.GradientClipByGlobalNorm(0.5)
    out = clip.transform(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = 0.5 / torch.clamp_min(gn, 0.5)
    assert list(out) == list(grads)
    for k, g in grads.items():
        assert torch.equal(out[k], g * scale), k


def _build_lm(fl):
    T = SMALL["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fl.models.transformer.build_lm(toks, labs, **SMALL)
    fl.optimizer.Adam(1e-3, grad_clip=fl.clip.GradientClipByGlobalNorm(
        1.0)).minimize(loss)
    return loss


def test_two_adam_clip_steps_match_jax(interpret_mode):
    """Two Adam + global-norm clip steps of the small LM, grouped, from the
    JAX startup's weights: both losses within 2e-5 (relative), every
    parameter within 2e-5 (ROADMAP A.5: what must still hold) wherever its
    gradient stands above float32's rounding at both steps (|g| >= 1e-5 of
    its max).  Where a gradient is rounding noise (|g| about 1e-9 against
    a max of 5e-3), Adam's first step lr g / (|g| + eps) is decided by that
    rounding, which the two packages do in another order, and a weight
    moves by anything up to lr a step: those elements are held to 2 lr and
    must be fewer than 1e-3 of the parameters."""
    rng = np.random.RandomState(5)
    V, T = SMALL["vocab_size"], SMALL["max_len"]
    feed = {"toks": rng.randint(0, V, (2, T)).astype(np.int32),
            "labs": rng.randint(0, V, (2, T, 1)).astype(np.int32)}
    jloss = _build_lm(jfluid)
    params = [p.name for p in jfluid.default_main_program().parameters()]
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    init = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}
    jl, quiet = [], {n: np.inf for n in params}
    for _ in range(2):
        out = jexe.run(feed=feed,
                       fetch_list=[jloss] + [f"{n}@GRAD" for n in params])
        jl.append(float(np.asarray(out[0])))
        for n, g in zip(params, out[1:]):
            g = np.abs(np.asarray(g))
            quiet[n] = np.minimum(quiet[n], g / max(float(g.max()), 1e-30))
    after = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}

    tloss = _build_lm(tfluid)
    texe = tfluid.Executor(CPU)
    texe.run(tfluid.default_startup_program())
    tfluid.load_scope(init, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    tl = [float(texe.run(feed=feed, fetch_list=[tloss])[0])
          for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    n_noise = n_all = 0
    for n in params:
        d = np.abs(tfluid.global_scope().find_var(n).numpy() - after[n])
        noise = quiet[n] < 1e-5
        assert d[~noise].max(initial=0.0) <= 2e-5, n
        assert d[noise].max(initial=0.0) <= 2 * 1e-3, n
        n_noise += int(noise.sum())
        n_all += d.size
    assert n_noise < 1e-3 * n_all, (n_noise, n_all)

"""The port's optimizer surface against the JAX package on the CPU: the
eight optimizers beyond SGD / Momentum / Adam, L1 / L2 decay (global and
per parameter), gradient accumulation (against the reference, and against
one big batch with a schedule that counts applies), the static pruning
hook, ModelAverage's apply / restore and the anomaly guard, each over
three steps from the same weights (the reference's startup draws, loaded
into the port); and every optimizer's grouped update bitwise equal to its
per-op rule, with a float and a tensor (``noam_decay``) learning rate.

Tolerance for the port against the reference: the loss within rtol 1e-5
and every state tensor within 1e-6 + 1e-4 x its max abs (float32 sums of
the fc gradients run in another order; the adaptive rules divide by
square roots of small accumulators, which scales that noise)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as t_executor

CPU = tfluid.CPUPlace()
RULES = {
    "adagrad": ("Adagrad", (0.05,), {}),
    "adamax": ("Adamax", (0.01,), {}),
    "adadelta": ("Adadelta", (1.0,), {}),
    "rmsprop": ("RMSProp", (0.01,), {"momentum": 0.9}),
    "decayed_adagrad": ("DecayedAdagrad", (0.05,), {}),
    "ftrl": ("Ftrl", (0.05,), {"l1": 1e-3, "l2": 1e-3}),
    "proximal_gd": ("ProximalGD", (0.05,), {"l1": 1e-3, "l2": 1e-3}),
    "proximal_adagrad": ("ProximalAdagrad", (0.05,), {"l1": 1e-3,
                                                      "l2": 1e-3}),
}
ALL_RULES = dict(RULES, sgd=("SGD", (0.05,), {}),
                 momentum=("Momentum", (0.05,), {"momentum": 0.9}),
                 adam=("Adam", (0.01,), {}))


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _feed(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 6).astype(np.float32),
            "lab": rng.randint(0, 5, (n, 1)).astype(np.int32)}


def _mlp(fl, w1_attr=None):
    """Three fc layers (the middle one with a learning-rate multiplier of
    0.5, a second group), softmax-CE; ``w1_attr`` the first layer's weight
    attr."""
    L = fl.layers
    x = L.data("x", [6])
    lab = L.data("lab", [1], dtype="int32")
    h = L.fc(x, 16, act="relu", param_attr=w1_attr)
    h = L.fc(h, 12, act="relu", param_attr=fl.ParamAttr(learning_rate=0.5))
    return L.mean(L.softmax_with_cross_entropy(L.fc(h, 5), lab))


def _make(fl, rule, lr=None, **kw):
    cls, args, extra = ALL_RULES[rule]
    args = (lr,) + args[1:] if lr is not None else args
    return getattr(fl.optimizer, cls)(*args, **dict(extra, **kw))


def _close(got, want, name):
    want = np.asarray(want)
    tol = 1e-6 + 1e-4 * float(np.abs(want).max())
    assert np.abs(np.asarray(got, np.float64) - want).max() <= tol, name


def _against_jax(build, feeds, before_step=None, warm=False):
    """Run ``build(fl)`` (returns the loss) in both packages: the JAX
    startup's state loaded into the port, then one step per feed (with
    ``before_step(fl, scope, i)`` before step i; ``warm``: the port's
    signature warmed first, so that its steps run the prepared body);
    returns the losses and the final states of both, JAX first, and the
    startup state."""
    out = []
    for fl in (jfluid, tfluid):
        loss = build(fl)
        if fl is jfluid:
            exe = jfluid.Executor()
            exe.run(jfluid.default_startup_program())
            init = _numpy_state(jfluid.global_scope())
        else:
            exe = tfluid.Executor(CPU)
            exe.run(tfluid.default_startup_program())
            tfluid.load_scope(init, tfluid.default_main_program(),
                              tfluid.global_scope(), device="cpu")
            if warm:
                exe.warm(tfluid.default_main_program(),
                         [(n, v.shape, v.dtype.name)
                          for n, v in feeds[0].items()], [loss])
        scope = fl.global_scope()
        losses = []
        for i, feed in enumerate(feeds):
            if before_step is not None:
                before_step(fl, scope, i)
            losses.append(np.asarray(exe.run(feed=feed,
                                             fetch_list=[loss])[0]))
        if warm and fl is tfluid:
            assert exe.replays == len(feeds)
        out.append((losses, _numpy_state(scope)))
    (jl, js), (tl, ts) = out
    assert set(ts) == set(js)
    return jl, js, tl, ts, init


def _numpy_state(scope):
    return {n: np.array(v.numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v)) for n, v in scope.items()}


def _compare(jl, js, tl, ts):
    np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), rtol=1e-5)
    for n, want in js.items():
        _close(ts[n], want, n)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_optimizer_matches_jax(rule):
    """Three steps of each new rule on the same weights and batches, its
    accumulators initialised by the startup program as in the reference;
    every parameter moved."""
    def build(fl):
        loss = _mlp(fl)
        _make(fl, rule).minimize(loss)
        return loss

    jl, js, tl, ts, init = _against_jax(build,
                                        [_feed(i) for i in range(3)])
    _compare(jl, js, tl, ts)
    for p in tfluid.default_main_program().parameters():
        assert not np.array_equal(ts[p.name], init[p.name]), p.name


@pytest.mark.parametrize("case", ["l2_global", "l1_global",
                                  "l1_param_over_l2"])
def test_regularizers_match_jax(case):
    """L2Decay and L1Decay as the optimizer's ``regularization``, and an
    L1Decay on one parameter's attr winning over a global L2Decay: a
    ``regularize`` op per regularized parameter, three Adam steps."""
    def build(fl):
        R = fl.regularizer
        attr = None
        if case == "l1_param_over_l2":
            attr = fl.ParamAttr(regularizer=R.L1Decay(0.05))
        glob = R.L1Decay(0.02) if case == "l1_global" else R.L2Decay(0.05)
        loss = _mlp(fl, attr)
        _make(fl, "adam", regularization=glob).minimize(loss)
        return loss

    jl, js, tl, ts, _ = _against_jax(build, [_feed(i) for i in range(3)])
    _compare(jl, js, tl, ts)
    ops = tfluid.default_main_program().list_ops()
    assert [o.type for o in ops].count("regularize") == 6


def test_accumulation_matches_jax_and_one_big_batch():
    """``accumulate_steps=4`` with global-norm clipping, an L2Decay and a
    ``piecewise_decay`` that steps after the first apply: eight
    micro-steps against the reference's; and against the port without
    accumulation on the four micro-batches concatenated, two steps (the
    mean of four equal micro-batch means is the big batch's mean; the
    schedule and Adam's bias correction count applies, so the second
    apply takes the second rate)."""
    def build(fl, n=4):
        loss = _mlp(fl)
        _make(fl, "adam", lr=fl.learning_rate_decay.piecewise_decay(
            [1], [0.01, 0.002]), accumulate_steps=n,
            grad_clip=fl.clip.GradientClipByGlobalNorm(0.5),
            regularization=fl.regularizer.L2Decay(1e-3)).minimize(loss)
        return loss

    micro = [_feed(i, 4) for i in range(8)]
    jl, js, tl, ts, init = _against_jax(build, micro)
    _compare(jl, js, tl, ts)
    types = [o.type for o in tfluid.default_main_program().list_ops()]
    assert types.count("grad_accumulate") == types.count("grad_eff") == 6

    tfluid.reset_default_programs()
    big = [{k: np.concatenate([m[k] for m in micro[4 * a:4 * a + 4]])
            for k in micro[0]} for a in range(2)]
    loss = build(tfluid, 1)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    tfluid.load_scope({n: v for n, v in init.items()
                       if not n.endswith(".grad_acc")},
                      tfluid.default_main_program(), scope, device="cpu")
    for feed in big:
        exe.run(feed=feed, fetch_list=[loss], scope=scope)
    for n, v in scope.items():
        if n.endswith(".step"):
            assert v.tolist() == [2] and ts[n].tolist() == [8]
            continue
        _close(v.numpy(), ts[n], n)


def test_static_pruning_hook_matches_jax():
    """``ParamAttr(update_hook=StaticPruningHook(0.6))``: the mask of the
    same value bitwise equal to the reference's (exact count, ties by
    index); the port's own startup prunes its draw to that count; three
    Momentum steps from the reference's startup state match it, and the
    pruned weights stay exactly zero."""
    v = np.random.RandomState(4).randn(6, 16).astype(np.float32)
    v[0, :5] = 0.5          # ties
    v[1, :3] = -0.5
    from paddle_tpu.hooks import StaticPruningHook as JHook
    jm = np.asarray(JHook(0.6).mask_for(v))
    tm = tfluid.hooks.StaticPruningHook(0.6).mask_for(torch.from_numpy(v))
    assert np.array_equal(tm.numpy(), jm) and jm.sum() == round(96 * 0.4)

    def build(fl):
        attr = fl.ParamAttr(name="w1", update_hook=fl.hooks.StaticPruningHook(
            0.6))
        loss = _mlp(fl, attr)
        _make(fl, "momentum").minimize(loss)
        return loss

    jl, js, tl, ts, _ = _against_jax(build, [_feed(i) for i in range(3)])
    _compare(jl, js, tl, ts)
    mask = ts["w1@prune_mask"]
    assert np.array_equal(mask, js["w1@prune_mask"])
    assert np.all(ts["w1"][mask == 0] == 0)
    tscope = tfluid.Scope()
    tfluid.Executor(CPU).run(tfluid.default_startup_program(), scope=tscope)
    w = tscope.find_var("w1").numpy()
    assert (w != 0).sum() == round(w.size * 0.4)
    assert np.array_equal(tscope.find_var("w1@prune_mask").numpy(),
                          (w != 0).astype(np.float32))


def test_model_average_apply_and_restore_match_jax():
    """ModelAverage after SGD, window 2 (the halving fires): the running
    sums and count against the reference's; inside ``apply`` the
    parameters are sum / num as the reference's, and on exit the trained
    parameters come back, the same tensors."""
    holders = {}

    def build(fl):
        loss = _mlp(fl)
        _, pg = _make(fl, "sgd").minimize(loss)
        holders[fl] = fl.optimizer.ModelAverage(pg, max_average_window=2)
        return loss

    jl, js, tl, ts, _ = _against_jax(build, [_feed(i) for i in range(4)])
    _compare(jl, js, tl, ts)
    names = [p.name for p in holders[tfluid]._params]
    tscope = tfluid.global_scope()
    kept = {n: tscope.find_var(n) for n in names}
    with holders[jfluid].apply(jfluid.Executor()):
        javg = {n: np.asarray(jfluid.global_scope().find_var(n))
                for n in names}
    with holders[tfluid].apply(tfluid.Executor(CPU)):
        for n in names:
            np.testing.assert_allclose(tscope.find_var(n).numpy(), javg[n],
                                       rtol=1e-5, atol=1e-6)
            assert tscope.find_var(n) is not kept[n]
    for n in names:
        assert tscope.find_var(n) is kept[n]


@pytest.mark.parametrize("warm", [False, True])
def test_anomaly_guard_matches_jax(warm):
    """``program.anomaly_guard`` names the loss: the step on a batch with a
    NaN fetches a NaN loss and leaves every state tensor as it was
    (bitwise), as the reference's does; the steps around it train and
    match the reference.  ``warm``: the port's signature warmed on the
    CPU, the guard inside the prepared body."""
    feeds = [_feed(i) for i in range(3)]
    feeds[1] = dict(feeds[1], x=feeds[1]["x"].copy())
    feeds[1]["x"][2, 3] = np.nan
    before = {}

    def build(fl):
        loss = _mlp(fl)
        _make(fl, "adam").minimize(loss)
        fl.default_main_program().anomaly_guard = loss.name
        return loss

    def snap(fl, scope, i):
        if i in (1, 2):
            before[(fl, i)] = _numpy_state(scope)

    jl, js, tl, ts, _ = _against_jax(build, feeds, snap, warm)
    for fl in (jfluid, tfluid):
        a, b = before[(fl, 1)], before[(fl, 2)]
        for n in a:
            assert a[n].tobytes() == b[n].tobytes(), (fl.__name__, n)
    tl, jl = np.ravel(tl), np.ravel(jl)
    assert np.isnan(tl[1]) and np.isnan(jl[1])
    np.testing.assert_allclose(tl[[0, 2]], jl[[0, 2]], rtol=1e-5)
    for n, want in js.items():
        _close(ts[n], want, n)


def _steps(loss, feed, n, grouped, monkeypatch):
    if not grouped:
        monkeypatch.setattr(t_executor, "_grouped", list)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program(), scope=scope)
    for _ in range(n):
        exe.run(feed=feed, fetch_list=[loss], scope=scope)
    monkeypatch.undo()
    return {k: v.clone() for k, v in scope.items()}


@pytest.mark.parametrize("lr", ["float", "noam"])
@pytest.mark.parametrize("rule", sorted(ALL_RULES))
def test_grouped_update_bitwise_equal_to_per_op(rule, lr, monkeypatch):
    """Every rule, grouped (``_update_group``: multi-tensor kernels, or a
    loop over ``_update`` for Ftrl, ProximalGD and ProximalAdagrad) against
    each update op on its own, three steps from the same startup state:
    every parameter and accumulator bitwise equal, with a float learning
    rate and with ``noam_decay`` (a 0-d float32 tensor); two group calls,
    one per learning-rate multiplier."""
    loss = _mlp(tfluid)
    rate = None if lr == "float" else \
        tfluid.learning_rate_decay.noam_decay(16, 3)
    _make(tfluid, rule, lr=rate).minimize(loss)
    feed = _feed(1)
    a = _steps(loss, feed, 3, True, monkeypatch)
    b = _steps(loss, feed, 3, False, monkeypatch)
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n

"""The Transformer LM's training step under amp, paddle_tpu_torch against
the JAX package on the CPU.

The same tiny LM (2 layers, d 64, 4 heads, T 32, vocab 128) is built with
``build_lm``, Adam(1e-3) and global-norm clipping in both packages, with
JAX's flash attention on its Pallas kernels (interpreted), from the same
weights (JAX's startup draws, read back and loaded into the port), and
run for two steps on one numpy-seeded batch under three policies: none
(float32), ``amp.enable()`` (the default policy, which leaves the
``attention`` op in float32: its list names ``flash_attention``) and
``amp.enable(program, Bf16Policy(extra_bf16=("attention",)))`` (attention
in bfloat16, the flash kernels' bf16 path).

Each amp step rounds activations to bfloat16 op by op, and torch and XLA
round at other places (XLA keeps excess precision inside its fusions), so
the packages do not agree bit for bit.  The tolerance is stated against
bfloat16's own effect: for each policy, every gradient of the first step
and the loss of both steps must lie within 3 times the larger of the two
packages' own distances between that policy's step and the float32 step
(in L2 and in max abs).  Independent roundings of one size put the two
packages about sqrt(2) times that distance apart (measured 1.0-1.35
times); 3 leaves room, as chip_smoke.py's parity contracts for ResNet's
amp arms do."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu.ops as jops
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.ops as tops

CFG = dict(vocab_size=128, max_len=32, d_model=64, n_heads=4, n_layers=2,
           d_ff=128)
POLICIES = ("float32", "default", "attention")
SPREAD_FACTOR = 3.0


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Fresh default programs, scope and names in the port (the JAX
    package's are reset by tests/conftest.py)."""
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _build(fl, policy):
    T = CFG["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fl.models.transformer.build_lm(toks, labs, **CFG)
    fl.optimizer.Adam(1e-3, grad_clip=fl.clip.GradientClipByGlobalNorm(
        1.0)).minimize(loss)
    if policy == "default":
        fl.amp.enable()
    elif policy == "attention":
        fl.amp.enable(fl.default_main_program(),
                      fl.amp.Bf16Policy(extra_bf16=("attention",)))
    return loss


def _recording(monkeypatch, module, seen):
    """Replace ``module.flash_attention`` (which both LMs' attention op
    looks up when it runs) by a wrapper that records its q's dtype."""
    real = module.flash_attention

    def wrapper(q, k, v, **kw):
        seen.append(str(q.dtype).replace("torch.", ""))
        return real(q, k, v, **kw)

    monkeypatch.setattr(module, "flash_attention", wrapper)


def _run_both(policy):
    """Two steps in each package from the same weights: {"jax": ..., "port":
    ...} each (losses [2], gradients of step 1 by name, dtypes the flash op
    received)."""
    rng = np.random.RandomState(7)
    V, T = CFG["vocab_size"], CFG["max_len"]
    feed = {"toks": rng.randint(0, V, (2, T)).astype(np.int32),
            "labs": rng.randint(0, V, (2, T, 1)).astype(np.int32)}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", "interpret")
        jfluid.reset_default_programs()
        jfluid.reset_global_scope()
        seen = []
        _recording(mp, jops, seen)
        loss = _build(jfluid, policy)
        seen.clear()        # the shape inference of the build
        names = [p.name + "@GRAD"
                 for p in jfluid.default_main_program().parameters()]
        exe = jfluid.Executor()
        exe.run(jfluid.default_startup_program())
        init = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}
        first = exe.run(feed=feed, fetch_list=[loss] + names)
        second = exe.run(feed=feed, fetch_list=[loss])
        out["jax"] = _result(first, second, names, seen)

        tfluid.reset_default_programs()
        tfluid.reset_global_scope()
        seen = []
        _recording(mp, tops, seen)
        loss = _build(tfluid, policy)
        seen.clear()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tfluid.default_startup_program())
        tfluid.load_scope(init, tfluid.default_main_program(),
                          tfluid.global_scope(), device="cpu")
        first = exe.run(feed=feed, fetch_list=[loss] + names)
        second = exe.run(feed=feed, fetch_list=[loss])
        out["port"] = _result(first, second, names, seen)
    return out


def _result(first, second, names, seen):
    return {"losses": [float(np.asarray(first[0])),
                       float(np.asarray(second[0]))],
            "grads": {n: np.asarray(g, np.float32)
                      for n, g in zip(names, first[1:])},
            "flash_dtypes": list(seen)}


@pytest.fixture(scope="module")
def runs():
    """Both packages under each policy, computed once for the module."""
    return {policy: _run_both(policy) for policy in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_attention_op_dtype_under_each_policy(runs, policy):
    """When the steps run, the flash op receives float32 under no amp and
    under the default policy, and bfloat16 under
    Bf16Policy(extra_bf16=("attention",)), in both packages: the port once
    per layer and step, JAX once per layer when it traces the step."""
    want = "bfloat16" if policy == "attention" else "float32"
    for pkg in ("jax", "port"):
        seen = runs[policy][pkg]["flash_dtypes"]
        assert seen and set(seen) == {want}, (pkg, policy, seen)
    assert (len(runs[policy]["port"]["flash_dtypes"])
            == 2 * CFG["n_layers"])


@pytest.mark.parametrize("policy", ("default", "attention"))
def test_amp_step_matches_jax_within_bf16_spread(runs, policy):
    """Losses of both steps and every gradient of the first: port against
    JAX within SPREAD_FACTOR times the larger of the packages' own
    distances from their float32 step (see the module note)."""
    jax, port = runs[policy]["jax"], runs[policy]["port"]
    jf, pf = runs["float32"]["jax"], runs["float32"]["port"]
    for i in range(2):
        spread = max(abs(jax["losses"][i] - jf["losses"][i]),
                     abs(port["losses"][i] - pf["losses"][i]))
        assert spread > 0
        assert (abs(port["losses"][i] - jax["losses"][i])
                <= SPREAD_FACTOR * spread), (policy, i)
    assert port["losses"][1] < port["losses"][0]
    assert set(port["grads"]) == set(jax["grads"])
    for n, want in jax["grads"].items():
        got = port["grads"][n]
        assert np.isfinite(got).all(), n
        for dist in (lambda a, b: float(np.linalg.norm(a - b)),
                     lambda a, b: float(np.abs(a - b).max())):
            spread = max(dist(want, jf["grads"][n]),
                         dist(got, pf["grads"][n]))
            assert dist(got, want) <= SPREAD_FACTOR * spread, (policy, n)


@pytest.mark.parametrize("policy", ("default", "attention"))
def test_amp_effect_is_the_same_size_in_both_packages(runs, policy):
    """Each package's own distance from its float32 step (the gradients of
    the first step in L2, each one and all together) lies within
    SPREAD_FACTOR of the other's, both ways: a port that dropped its bf16
    casts would lie much nearer float32 than JAX does, and pass the test
    above on JAX's spread alone.  (Measured: 0.46-1.22 each, 0.97 and 1.06
    together; with only the matmuls in bf16 the least gradient reads
    0.22-0.26.)"""
    def spreads(pkg):
        amp, f32 = runs[policy][pkg]["grads"], runs["float32"][pkg]["grads"]
        each = {n: float(np.linalg.norm(amp[n] - f32[n])) for n in amp}
        return each, float(np.sqrt(sum(d * d for d in each.values())))

    (port, port_all), (jax, jax_all) = spreads("port"), spreads("jax")
    for n in jax:
        ratio = port[n] / jax[n]
        assert 1.0 / SPREAD_FACTOR <= ratio <= SPREAD_FACTOR, (policy, n,
                                                               ratio)
    ratio = port_all / jax_all
    assert 1.0 / SPREAD_FACTOR <= ratio <= SPREAD_FACTOR, (policy, ratio)


def test_float32_step_matches_jax(runs):
    """The float32 reference of the spreads: the packages agree as
    ``tests/test_torch_train.py`` holds them (loss rtol 1e-5, gradients
    within 1e-5 of each one's max abs)."""
    jax, port = runs["float32"]["jax"], runs["float32"]["port"]
    np.testing.assert_allclose(port["losses"], jax["losses"], rtol=1e-5)
    for n, want in jax["grads"].items():
        got = port["grads"][n]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), n


def test_attention_policy_changes_the_step(runs):
    """Attention in bfloat16 is a different step from the default policy's
    (so the spread test above holds the bf16 flash path, not float32
    attention again), in both packages."""
    for pkg in ("jax", "port"):
        a = runs["attention"][pkg]["grads"]
        d = runs["default"][pkg]["grads"]
        assert any(np.abs(a[n] - d[n]).max() > 0 for n in a), pkg

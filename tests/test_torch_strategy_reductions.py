"""Batch reductions under a Strategy (ROADMAP C.13): a gang of 2 CPU ranks
over gloo under ``Strategy({"dp": 2})``, held against the JAX package on
2 virtual CPU devices and on one device, from the same numpy weights and
feeds, one SGD(0.1) step:

* an fc-relu-fc MLP with a ``reduce_sum`` loss;
* the same MLP with ``batch_norm`` before the relu (the training
  statistics, the parameter gradients and the running statistics);
* ``reduce_max`` / ``reduce_min`` over the batch with ties on both ranks,
  ``reduce_mean`` over (batch, features) and a ``reduce_sum`` over the
  features that stays local;
* every layer that mixes batch rows in a way no op carries itself
  (``accuracy``, ``auc``, ``chunk_eval``, ``reduce_prod`` over the batch,
  ``cumsum`` and ``argmax`` over dim 0, ``matmul`` with x transposed or a
  batch-major y, ``gather`` and ``scatter`` of a batch-major x, and the
  five evaluators' metrics and states), two steps, unsharded (``single``)
  and under ``{dp 2}`` (``dp2``, the Strategy's Carrier), each against
  the JAX package under ``{dp 2}``;
* ``sum_to_one_norm`` of a [None] vector under ``{dp 2}`` (it has no dim
  attribute: each rank once divided by its own rows' sum);
* ``DeviceFeeder(sharding=strategy)`` (each rank uploads its rows) against
  the same feeds given whole (bitwise) and JAX under ``{dp 2}``;
* the gradients through carried ops (``cumsum`` over the batch,
  ``matmul(transpose_x=True)``, ``sum_to_one_norm`` of a [None] vector),
  against JAX on one device and on ``{dp 2}``: the Carrier's backward keeps
  ``comm.py``'s convention.

One gang runs every case (the ``gang`` fixture).  Limits: losses and
reduced values within rtol 1e-5; gradients and parameters within 1e-5 of
their max abs (float32 sums in another order); the carried layers'
float outputs within rtol 1e-5 (atol 1e-6), integer outputs and the
evaluators' counts equal."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
from paddle_tpu import parallel as jpar
from paddle_tpu_torch import distributed
from paddle_tpu_torch.ops import batch_norm as TB
from paddle_tpu_torch.tools import parallel_cases as pc

RANKS = 2
MLP_PARAMS = ["w1", "b1", "w2", "b2"]
BN_PARAMS = ["w1", "bn.s", "bn.b", "w2", "b2"]


def jax_run(build, feeds, fetch=(), dp=None, init=None, state=()):
    """(init arrays, per-step fetches, final state) of the case in the JAX
    package, on one device or on ``dp`` virtual devices."""
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    out = pc.BUILDERS[build](jfluid, jpar)
    loss = out[0] if isinstance(out, tuple) else out
    strategy = None if dp is None else jpar.Strategy(
        jpar.make_mesh({"dp": dp}, devices=jax.devices()[:dp]))
    exe = jfluid.Executor(strategy=strategy)
    exe.run(jfluid.default_startup_program())
    scope = jfluid.global_scope()
    if init is None:
        init = {n: np.asarray(v) for n, v in scope.items()}
    else:
        for n, a in init.items():
            scope.set_var(n, jnp.asarray(a))
    names = [loss.name] + pc.fetch_names(out, fetch)
    steps = [[np.asarray(v) for v in exe.run(feed=f, fetch_list=names)]
             for f in feeds]
    return init, steps, {n: np.asarray(scope.find_var(n)) for n in state}


def _mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(8, 8).astype("float32"),
            "y": rng.randint(0, 4, (8, 1)).astype("int32")}


def _reduce_feed_and_weights():
    """x [8, 4]: a large row three times (twice on rank 0, once on rank 1)
    and a small one twice (once a rank), the rest in (0, 1); rw > 0, so
    every column's max and min are ties across the ranks."""
    rng = np.random.RandomState(3)
    x = rng.rand(8, 4).astype("float32")
    x[[0, 1, 5]] = 5.0
    x[[2, 6]] = -5.0
    return {"x": x}, {"rw": np.abs(rng.randn(4, 3)).astype("float32") + 0.1}


CASES = {
    "mlp_sum": dict(params=MLP_PARAMS, fetch=[p + "@GRAD" for p in
                                              MLP_PARAMS]),
    "mlp_bn": dict(params=BN_PARAMS, fetch=[p + "@GRAD" for p in BN_PARAMS],
                   extra_state=["bn.m", "bn.v"]),
    "reduce_ops": dict(params=["rw"], fetch=["$1", "$2", "$3", "rw@GRAD"]),
    "carry_grads": dict(params=["cg.w", "cg.b"],
                        fetch=["$1", "$2", "cg.w@GRAD", "cg.b@GRAD"]),
}
MIXING = list(pc.MIXING) + ["sum_to_one_norm"]
FEEDER_FETCH = [p + "@GRAD" for p in BN_PARAMS]


def jax_mixing(which, dp=None):
    """The fetches of two steps of ``mixing_program(which)`` in the JAX
    package, on one device or on ``dp`` virtual devices."""
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    feed, fetch = pc.mixing_program(jfluid, which)
    strategy = None if dp is None else jpar.Strategy(
        jpar.make_mesh({"dp": dp}, devices=jax.devices()[:dp]))
    exe = jfluid.Executor(strategy=strategy)
    exe.run(jfluid.default_startup_program())
    return [[np.asarray(v) for v in exe.run(feed=feed, fetch_list=fetch)]
            for _ in range(2)]


@pytest.fixture(scope="module")
def gang():
    specs, refs, jobs = {}, {}, {}
    for case, c in CASES.items():
        if case == "reduce_ops":
            feed, init = _reduce_feed_and_weights()
        elif case == "carry_grads":
            feed, init = _carry_feed(), jax_run(case, [])[0]
        else:
            feed, init = _mlp_feed(), jax_run(case, [])[0]
        state = c["params"] + c.get("extra_state", [])
        specs[case] = dict(kind="program", build=case, init=init,
                           feeds=[feed], fetch=c["fetch"],
                           mesh={"dp": RANKS}, state=state)

        def job(case=case, init=init, feed=feed, fetch=c["fetch"],
                state=state):
            return {arm: jax_run(case, [feed], fetch, dp, init, state)[1:]
                    for arm, dp in (("single", None), ("dp2", RANKS))}

        jobs[case] = job
    lm_init = jax_run("lm_metrics", [])[0]
    rng = np.random.RandomState(6)
    bn_feeds = [{"x": rng.rand(8, 8).astype("float32"),
                 "y": rng.randint(0, 4, (8, 1)).astype("int32")}
                for _ in range(2)]
    bn_init = jax_run("mlp_bn", [])[0]
    for arm in ("whole", "feeder"):
        specs["bn " + arm] = dict(kind="program", build="mlp_bn",
                                  init=bn_init, feeds=bn_feeds,
                                  fetch=FEEDER_FETCH, mesh={"dp": RANKS},
                                  state=BN_PARAMS + ["bn.m", "bn.v"],
                                  feeder=arm == "feeder")
    jobs["bn feeder"] = lambda: jax_run(
        "mlp_bn", bn_feeds, FEEDER_FETCH, RANKS, bn_init,
        BN_PARAMS + ["bn.m", "bn.v"])[1:]
    lm_feeds = [pc_lm_feed(s) for s in (0, 1)]
    for arm, mesh in (("single", None), ("dp2", {"dp": RANKS})):
        specs["lm_metrics " + arm] = dict(
            kind="program", build="lm_metrics", feeds=lm_feeds,
            fetch=["$1", "$2", "$3", "$4"], mesh=mesh, feeder=bool(mesh),
            init=lm_init)
    jobs["lm_metrics"] = lambda: jax_run(
        "lm_metrics", lm_feeds, ["$1", "$2", "$3", "$4"], None, lm_init)[1]
    specs["mixing single"] = dict(kind="mixing", which=MIXING, mesh=None)
    specs["mixing dp2"] = dict(kind="mixing", which=MIXING,
                               mesh={"dp": RANKS})
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(distributed.spawn, pc.run_cases, RANKS, specs,
                          device="cpu", timeout_s=300)
        refs = {case: job() for case, job in jobs.items()}
        refs["mixing"] = {w: jax_mixing(w, RANKS) for w in MIXING}
        got = fut.result()[0]
    return refs, got


def pc_lm_feed(seed):
    rng = np.random.RandomState(seed)
    V, T = pc.TINY_LM["vocab_size"], pc.TINY_LM["max_len"]
    return {"toks": rng.randint(0, V, (4, T)).astype(np.int32),
            "labs": rng.randint(0, V, (4, T, 1)).astype(np.int32)}


def _carry_feed():
    rng = np.random.RandomState(4)
    return {"x": rng.rand(8, 6).astype("float32")}


def _close(got, want, tol=1e-5, what=""):
    got = np.asarray(got, dtype=np.float64).reshape(np.shape(want))
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, what


def _check(refs, got, case, arm):
    (steps, fin) = refs[case][arm]
    g = got[case]
    np.testing.assert_allclose(np.ravel(g["steps"][0][0]),
                               np.ravel(steps[0][0]), rtol=1e-5)
    for i, name in enumerate(CASES[case]["fetch"], 1):
        if name.startswith("$"):
            np.testing.assert_allclose(np.ravel(g["steps"][0][i]),
                                       np.ravel(steps[0][i]), rtol=1e-5,
                                       err_msg=name)
        else:
            _close(g["steps"][0][i], steps[0][i], what=name)
    for n, w in fin.items():
        _close(g["state"][n], w, what=n)


@pytest.mark.parametrize("arm", ["single", "dp2"])
def test_reduce_sum_loss_matches_jax(gang, arm):
    """The global sum on every rank, and its update the single device's
    (the backward undoes the Strategy's 1/n)."""
    refs, got = gang
    _check(refs, got, "mlp_sum", arm)


@pytest.mark.parametrize("arm", ["single", "dp2"])
def test_batch_norm_matches_jax(gang, arm):
    """Statistics over the global batch; dgamma and dbeta (fetched) the
    single device's; running statistics alike on every rank."""
    refs, got = gang
    _check(refs, got, "mlp_bn", arm)


@pytest.mark.parametrize("arm", ["single", "dp2"])
def test_reduce_max_min_mean_over_batch_match_jax(gang, arm):
    """max and min over the batch with ties across the ranks (the gradient
    split over every rank's ties, as jnp.max's), a mean over (batch,
    features), a local sum over the features."""
    refs, got = gang
    _check(refs, got, "reduce_ops", arm)


def _mixing_matches(refs, got, arm, which):
    r = got[f"mixing {arm}"][which]
    assert r["error"] is None, r["error"]
    if arm == "dp2" and which not in ("accuracy", "Accuracy"):
        # accuracy and its evaluator sum their counts over the ranks
        assert r["carried"], "the Strategy carried no op"
    for step, (g, w) in enumerate(zip(r["steps"], refs["mixing"][which])):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            a, b = np.asarray(a), np.asarray(b)
            what = f"{which} step {step} fetch {i}"
            assert a.shape == b.shape, what
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                           err_msg=what)
            else:
                np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("which", pc.MIXING)
def test_batch_mixing_layer_refused_before_first_op(gang, which):
    """Once refused before the step's first op (ROADMAP C.13), each layer
    that mixes batch rows now runs under ``{dp 2}`` through the Strategy's
    Carrier and matches the JAX package under ``{dp 2}``, two steps (the
    evaluators' states accumulate)."""
    refs, got = gang
    _mixing_matches(refs, got, "dp2", which)


@pytest.mark.parametrize("which", pc.MIXING)
def test_batch_mixing_layer_single_matches_jax(gang, which):
    refs, got = gang
    _mixing_matches(refs, got, "single", which)


def test_sum_to_one_norm_of_a_batch_vector_matches_jax_under_dp(gang):
    """``sum_to_one_norm`` has no dim attribute: on a [None] vector it runs
    along the batch, and under ``{dp 2}`` each rank must divide by the
    global sum, as JAX's GSPMD does, not by its own rows' sum."""
    refs, got = gang
    _mixing_matches(refs, got, "dp2", "sum_to_one_norm")
    assert got["mixing dp2"]["sum_to_one_norm"]["carried"] == [
        "sum_to_one_norm"]


def test_device_feeder_sharding_matches_whole_feeds_and_jax(gang):
    """``DeviceFeeder(sharding=strategy)``: each rank uploads its dp rows
    and the Executor takes them as they are; two steps of the batch-norm
    MLP (statistics over the global batch) give the losses, gradients and
    state of the same feeds given whole, bitwise, and JAX's under
    ``{dp 2}`` at the limits above."""
    refs, got = gang
    whole, fed = got["bn whole"], got["bn feeder"]
    for staged in fed["staged"]:
        assert staged == {"x": ("LocalFeed", (4, 8)),
                          "y": ("LocalFeed", (4, 1))}
    for a, b in zip(fed["steps"], whole["steps"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n, v in whole["state"].items():
        np.testing.assert_array_equal(fed["state"][n], v)
    steps, fin = refs["bn feeder"]
    for g, w in zip(fed["steps"], steps):
        np.testing.assert_allclose(np.ravel(g[0]), np.ravel(w[0]), rtol=1e-5)
        for name, a, b in zip(FEEDER_FETCH, g[1:], w[1:]):
            _close(a, b, what=name)
    for n, w in fin.items():
        _close(fed["state"][n], w, what=n)


def test_lm_accuracy_and_evaluator_under_dp_with_the_feeder(gang):
    """The tiny LM fetching next-token ``accuracy`` with an ``Accuracy``
    evaluator, two Adam steps, fed through ``DeviceFeeder(sharding=)`` on
    ``{dp 2}``: the accuracy, the evaluator's rate and its correct and
    total counts exactly the unsharded run's (the counts summed over the
    ranks), the losses within rtol 1e-5 of it and of JAX's, the accuracy
    and the counts JAX's."""
    refs, got = gang
    single, dp2 = got["lm_metrics single"], got["lm_metrics dp2"]
    for staged in dp2["staged"]:
        assert {v[0] for v in staged.values()} == {"LocalFeed"}
    for a, b, j in zip(dp2["steps"], single["steps"], refs["lm_metrics"]):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5)
        np.testing.assert_allclose(a[0], j[0], rtol=1e-5)
        for x, y, z in zip(a[1:], b[1:], j[1:]):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    assert float(single["steps"][1][4][0]) == 2 * 4


@pytest.mark.parametrize("arm", ["single", "dp2"])
def test_carried_ops_gradients_match_jax(gang, arm):
    """Gradients through ops the Carrier runs (a batch-major output of
    ``cumsum`` over the batch, the replicated ``matmul(transpose_x=True)``,
    ``sum_to_one_norm`` of a [None] vector): the single device's."""
    refs, got = gang
    _check(refs, got, "carry_grads", arm)


def test_bn_dx_plain_version_takes_the_global_count():
    """Two halves of a batch, each with the whole batch's statistics,
    summed dbeta and dgamma and the global M, give the rows of the whole
    batch's dx (the dx kernel's ``count`` argument, in its plain
    version)."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(8, 3, 5).astype("float32"))
    dy = torch.from_numpy(rng.randn(8, 3, 5).astype("float32"))
    gamma = torch.from_numpy(rng.rand(3).astype("float32") + 0.5)
    dims = (0, 2)
    mean = x.mean(dims)
    rstd = torch.rsqrt(torch.clamp_min((x * x).mean(dims) - mean * mean,
                                       0.0) + 1e-5)
    db, dg = TB.bn_bwd_reduce_reference(dy, x, mean, rstd)
    whole = TB.bn_bwd_dx_reference(dy, x, mean, rstd, gamma, db, dg)
    parts = [TB.bn_bwd_reduce_reference(dy[h], x[h], mean, rstd)
             for h in (slice(0, 4), slice(4, 8))]
    db2 = parts[0][0] + parts[1][0]
    dg2 = parts[0][1] + parts[1][1]
    for h in (slice(0, 4), slice(4, 8)):
        dx = TB.bn_bwd_dx_reference(dy[h], x[h], mean, rstd, gamma, db2, dg2,
                                    count=8 * 5)
        torch.testing.assert_close(dx, whole[h], rtol=1e-5, atol=1e-6)
    # the local count is the default, and differs
    local = TB.bn_bwd_dx_reference(dy[:4], x[:4], mean, rstd, gamma, db2,
                                   dg2)
    assert not torch.allclose(local, whole[:4], rtol=1e-3, atol=1e-4)

"""The port's Switch MoE (``parallel/moe.py``) and GPipe
(``parallel/pipeline.py``) against the JAX package.

In one process: ``switch_moe_apply`` (routing exact with ample capacity,
the capacity drops, its gradients against ``jax.grad``, jitter from the
same threefry key) and ``gpipe`` without a mesh, each at the reference's
tolerances (rtol 1e-4, atol 1e-5; gradients 1e-5 of their max abs).

On a gang of 4 CPU ranks over gloo (one gang, the ``gang`` fixture):
``switch_moe`` in the reference's layer test on {dp 2, ep 2} at a
capacity that drops tokens, with and without jitter, held against the
JAX package on 4 virtual devices and on one (three Adam steps: losses
rtol 1e-5, the gradients of the gate, the expert shards and the fc
before the experts, and the final state, within 1e-5 of their max abs);
``gpipe`` on {pp 4} (8 stages, 2 a rank) and {pp 2, dp 2} (6 stages, 3 a
rank), the output and the gradients of w, b and x against ``jax.grad`` of
the sequential fold (rtol 1e-4, atol 1e-5; gradients 1e-5 of max abs);
``pipeline_fc_stack`` training on {pp 2, dp 2} (three SGD steps, limits
as for the MoE); ``switch_moe`` over an input whose sequence the port
shards on {sp 2, ep 2} (routing, capacity and drops those of the whole
sequence), and a ``reduce_sum`` over the batch keeping a sharded
sequence beside a ``cumsum`` along it on {dp 2, sp 2} (both run by the
Strategy's Carrier), and ``sequence_reverse``, ``row_conv`` and
``sequence_conv`` of a sequence the port shards on {sp 2} (ops along dim
1 with no attribute naming it; the Carrier gathers the sequence), at the
MoE's limits (the carried values, float32 sums in another order, within
1e-5 of their max abs), against JAX on one device and on the same mesh
(JAX shards no sequence)."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import parallel as jpar
from paddle_tpu.parallel.moe import switch_moe_apply as j_moe
from paddle_tpu.parallel.pipeline import gpipe as j_gpipe
from paddle_tpu_torch import distributed
from paddle_tpu_torch.ops.dropout import ThreefryKey
from paddle_tpu_torch.parallel.moe import switch_moe_apply as t_moe
from paddle_tpu_torch.parallel.pipeline import gpipe as t_gpipe
from paddle_tpu_torch.tools import parallel_cases as pc

RANKS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-5, what=""):
    got = np.asarray(got, dtype=np.float64).reshape(np.shape(want))
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, what


def _moe_inputs(seed=0, S=16, d=8, f=12, E=4, peaky=10.0):
    rng = np.random.RandomState(seed)
    return [rng.randn(S, d).astype("float32"),
            rng.randn(d, E).astype("float32") * peaky,
            rng.randn(E, d, f).astype("float32") * 0.1,
            rng.randn(E, f).astype("float32") * 0.1,
            rng.randn(E, f, d).astype("float32") * 0.1,
            rng.randn(E, d).astype("float32") * 0.1]


# ------------------------------------------------------------ one process


def test_switch_moe_apply_routing_exact_matches_jax():
    args = _moe_inputs()
    E = args[1].shape[1]
    yj, auxj = j_moe(*map(jnp.asarray, args), capacity_factor=float(E))
    yt, auxt = t_moe(*map(torch.from_numpy, args), capacity_factor=float(E))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    assert float(auxt) > 0


def test_switch_moe_capacity_drops_match_jax():
    """Capacity factor 0.5: every token to expert 0, the first 2 kept,
    the rest exactly 0, as in the reference."""
    S, d, E = 8, 4, 2
    x = np.ones((S, d), np.float32)
    gate_w = np.zeros((d, E), np.float32)
    gate_w[:, 0] = 5.0
    ws = [np.ones((E, d, d), np.float32), np.zeros((E, d), np.float32),
          np.ones((E, d, d), np.float32), np.zeros((E, d), np.float32)]
    yt, _ = t_moe(*map(torch.from_numpy, [x, gate_w] + ws),
                  capacity_factor=0.5)
    kept = yt.abs().sum(-1).numpy() > 0
    assert kept.sum() == 2 and kept[:2].all()
    yj, _ = j_moe(*map(jnp.asarray, [x, gate_w] + ws), capacity_factor=0.5)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("jitter", [0.0, 0.1])
def test_switch_moe_apply_gradients_match_jax(jitter):
    """sum(y * g) + aux at capacity 1.0 (tokens dropped), with the jitter
    drawn from one threefry key in both packages: values and the
    gradients of every input."""
    args = _moe_inputs(seed=1, S=32, peaky=1.0)
    g = np.random.RandomState(2).randn(32, 8).astype("float32")
    key = ThreefryKey(3, 7, 2)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.key(3),
                                                 np.uint32(7)), np.uint32(2))

    def jloss(*a):
        y, aux = j_moe(*a, capacity_factor=1.0, rng=jkey, jitter=jitter)
        return jnp.sum(y * g) + aux

    jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, aux = t_moe(*ts, capacity_factor=1.0, rng=key, jitter=jitter)
    tv = (y * torch.from_numpy(g)).sum() + aux
    tg = torch.autograd.grad(tv, ts)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a.numpy(), np.asarray(b), what=str(i))


def test_gpipe_no_mesh_is_the_fold_and_matches_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(3, 4, 4).astype("float32")
    b = np.zeros((3, 4), np.float32)
    x = rng.randn(5, 4).astype("float32")
    yt = t_gpipe(lambda p, h: h @ p[0] + p[1],
                 (torch.from_numpy(w), torch.from_numpy(b)),
                 torch.from_numpy(x), None)
    yj = j_gpipe(lambda p, h: h @ p[0] + p[1],
                 (jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x), None)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4)


# ------------------------------------------------------------ the gang


def jax_run(build, feeds, fetch, mesh=None, init=None, state=()):
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    out = pc.BUILDERS[build](jfluid, jpar)
    loss = out[0] if isinstance(out, tuple) else out
    strategy = None
    if mesh is not None:
        n = int(np.prod(list(mesh.values())))
        strategy = jpar.Strategy(jpar.make_mesh(mesh,
                                                devices=jax.devices()[:n]))
    exe = jfluid.Executor(strategy=strategy)
    exe.run(jfluid.default_startup_program())
    scope = jfluid.global_scope()
    if init is None:
        init = {n: np.asarray(v) for n, v in scope.items()}
    else:
        for n, a in init.items():
            scope.set_var(n, jnp.asarray(a))
    scope.step_counter = 0      # as the port's program_case
    names = [loss.name] + pc.fetch_names(out, fetch)
    steps = [[np.asarray(v) for v in exe.run(feed=f, fetch_list=names)]
             for f in feeds]
    return init, steps, {n: np.asarray(scope.find_var(n)) for n in state}


MOE_GRADS = ["m.w", "switch_moe_w_0", "switch_moe_w_1", "switch_moe_b_0",
             "switch_moe_w_2", "switch_moe_b_1"]
PROGRAMS = {
    "moe": dict(mesh={"dp": 2, "ep": 2}, feed=("x", 8, 4),
                fetch=["$1"] + [n + "@GRAD" for n in MOE_GRADS]),
    "moe_jitter": dict(mesh={"dp": 2, "ep": 2}, feed=("x", 8, 4),
                       fetch=["$1"] + [n + "@GRAD" for n in MOE_GRADS]),
    "moe_seq": dict(mesh={"sp": 2, "ep": 2}, feed=("x", (8, 8), 4),
                    fetch=["$1"] + [n + "@GRAD" for n in MOE_GRADS]),
    "seq_carry": dict(mesh={"dp": 2, "sp": 2}, feed=("x", (8, 4), None),
                      fetch=["$1", "$2", "sc.w@GRAD", "sc.b@GRAD"]),
    "seq_ops": dict(mesh={"sp": 2}, feed=("x", (8, 4), None),
                    fetch=["$1", "$2", "$3", "so.w@GRAD", "so.rc@GRAD",
                           "so.sc@GRAD"]),
    "pipe": dict(mesh={"pp": 2, "dp": 2}, feed=("x", 16, 3),
                 fetch=["pipeline_fc_stack_w_0@GRAD",
                        "pipeline_fc_stack_b_0@GRAD"]),
}
GPIPE = {"pp4": ({"pp": 4}, 8, 4), "pp2_dp2": ({"pp": 2, "dp": 2}, 6, 3)}


def _gpipe_spec(case):
    mesh, S, m = GPIPE[case]
    rng = np.random.RandomState(4)
    d, B = 5, 12
    return dict(kind="gpipe", mesh=mesh, m=m,
                w=(rng.randn(S, d, d) * 0.3).astype("float32"),
                b=(rng.randn(S, d) * 0.1).astype("float32"),
                x=rng.randn(B, d).astype("float32"),
                g=rng.randn(B, d).astype("float32"))


def _gpipe_ref(spec):
    def fold(w, b, x):
        h = x
        for s in range(w.shape[0]):
            h = jnp.tanh(h @ w[s] + b[s])
        return h

    def loss(w, b, x):
        return jnp.sum(fold(w, b, x) * spec["g"])

    args = [jnp.asarray(spec[k]) for k in ("w", "b", "x")]
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return {"y": np.asarray(fold(*args)), "gw": np.asarray(grads[0]),
            "gb": np.asarray(grads[1]), "gx": np.asarray(grads[2])}


@pytest.fixture(scope="module")
def gang():
    specs, jobs = {}, {}
    for case, c in PROGRAMS.items():
        name, dim, classes = c["feed"]
        rng = np.random.RandomState(5)
        if isinstance(dim, tuple):
            # a sequence feed [N, T, d] (with per-position labels)
            feed = {name: rng.randn(8, *dim).astype("float32")}
            if classes:
                feed["lab"] = rng.randint(0, classes, (8, dim[0], 1)
                                          ).astype("int32")
            if case == "seq_ops":
                feed["len"] = rng.randint(1, dim[0] + 1, 8).astype("int32")
        else:
            feed = {name: rng.randn(16, dim).astype("float32")
                    if case != "pipe" else rng.randn(8, dim).astype(
                        "float32"),
                    "lab": rng.randint(0, classes, (
                        16 if case != "pipe" else 8, 1)).astype("int32")}
        init, state = jax_run(case, [], [])[0], None
        state = sorted(init)
        specs[case] = dict(kind="program", build=case, init=init,
                           feeds=[feed] * 3, fetch=c["fetch"],
                           mesh=c["mesh"], state=state)

        def job(case=case, init=init, feed=feed, c=c, state=state):
            return {arm: jax_run(case, [feed] * 3, c["fetch"], mesh, init,
                                 state)[1:]
                    for arm, mesh in (("single", None), ("mesh", c["mesh"]))}

        jobs[case] = job
    specs["seq_carry_feeder"] = dict(specs["seq_carry"], feeder=True)
    for case in GPIPE:
        specs["gpipe_" + case] = _gpipe_spec(case)
        jobs["gpipe_" + case] = lambda s=specs["gpipe_" + case]: _gpipe_ref(s)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(distributed.spawn, pc.run_cases, RANKS, specs,
                          device="cpu", timeout_s=300)
        refs = {case: job() for case, job in jobs.items()}
        got = fut.result()[0]
    return refs, got


@pytest.mark.parametrize("arm", ["single", "mesh"])
@pytest.mark.parametrize("case", ["moe", "moe_jitter", "moe_seq",
                                  "seq_carry", "seq_ops", "pipe"])
def test_program_on_mesh_matches_jax(gang, case, arm):
    refs, got = gang
    steps, fin = refs[case][arm]
    g = got[case]
    for gs, rs in zip(g["steps"], steps):
        np.testing.assert_allclose(np.ravel(gs[0]), np.ravel(rs[0]),
                                   rtol=1e-5)
        for name, a, b in zip(PROGRAMS[case]["fetch"], gs[1:], rs[1:]):
            if name.startswith("$") and case not in ("seq_carry",
                                                     "seq_ops"):
                np.testing.assert_allclose(np.ravel(a), np.ravel(b),
                                           rtol=1e-5, err_msg=name)
            else:
                _close(a, b, what=name)
    for n, w in fin.items():
        _close(g["state"][n], w, what=n)


@pytest.mark.parametrize("case", list(GPIPE))
def test_gpipe_on_mesh_matches_jax_grad_of_the_fold(gang, case):
    refs, got = gang
    r, g = refs["gpipe_" + case], got["gpipe_" + case]
    np.testing.assert_allclose(g["y"], r["y"], rtol=1e-4, atol=1e-5)
    for k in ("gw", "gb", "gx"):
        _close(g[k], r[k], what=k)
    mesh, _, m = GPIPE[case]
    pp = mesh["pp"]
    # one shift a tick but the last, forward and backward
    assert g["shifts"] == 2 * (m + pp - 2)


def test_device_feeder_uploads_the_rank_sequence_slice(gang):
    """``DeviceFeeder(sharding=strategy)`` on {dp 2, sp 2}: a rank stages
    its 4 rows and its 4 of the 8 positions of x, and the three steps of
    ``seq_carry`` are bitwise those of the same feeds given whole."""
    _, got = gang
    fed, whole = got["seq_carry_feeder"], got["seq_carry"]
    for staged in fed["staged"]:
        assert staged == {"x": ("LocalFeed", (4, 4, 4))}
    for a, b in zip(fed["steps"], whole["steps"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n, v in whole["state"].items():
        np.testing.assert_array_equal(fed["state"][n], v)

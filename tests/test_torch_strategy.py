"""The port's Strategy (dp, ZeRO-1, global-norm clip under tp, dropout
under dp and sp) on a gang of 4 CPU ranks over gloo, held against the
JAX package on the conftest's 8-device CPU mesh (and its single-device
runs) from the same numpy weights and feeds; then the port's
``dryrun_multichip(4)`` and ``(8)`` at the reference's rtol 2e-3,
atol 1e-4.  One gang runs every program case of this file (the
``gang`` fixture); each case is a test of its own.  Limits: losses and
values within rtol 1e-5, parameters within 1e-5 of their max abs (float32
sums in another order), dropout masks bitwise."""
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
from paddle_tpu import parallel as jpar
from paddle_tpu_torch import distributed
from paddle_tpu_torch.ops import dropout as dmod
from paddle_tpu_torch.parallel.mesh import Mesh
from paddle_tpu_torch.param_attr import SeqAxis
from paddle_tpu_torch.parallel.strategy import StepLayout
from paddle_tpu_torch.tools import parallel_cases as pc
from paddle_tpu_torch.tools import dryrun_multichip as dry

RANKS = 4


def jax_run(build, feeds, fetch=(), mesh=None, data_axis="dp", zero1=False,
            init=None, state=(), kw=None, step_counter=0):
    """The case in the JAX package: (init arrays, per-step fetches, final
    state, the strategy)."""
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    out = pc.BUILDERS[build](jfluid, jpar, **(kw or {}))
    loss = out[0] if isinstance(out, tuple) else out
    strategy = None
    if mesh is not None:
        n = math.prod(mesh.values())
        strategy = jpar.Strategy(jpar.make_mesh(mesh,
                                                devices=jax.devices()[:n]),
                                 data_axis=data_axis,
                                 shard_optimizer_state=zero1)
    exe = jfluid.Executor(strategy=strategy)
    exe.run(jfluid.default_startup_program())
    scope = jfluid.global_scope()
    if init is None:
        init = {n: np.asarray(v) for n, v in scope.items()}
    else:
        for n, a in init.items():
            scope.set_var(n, jnp.asarray(a))
    scope.step_counter = step_counter
    names = [loss.name] + pc.fetch_names(out, fetch)
    steps = [[np.asarray(v) for v in exe.run(feed=f, fetch_list=names)]
             for f in feeds]
    final = {n: np.asarray(scope.find_var(n)) for n in state}
    return init, steps, final, strategy


def _mlp_feeds():
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(16, 8).astype("float32"),
             "y": rng.randint(0, 4, (16, 1)).astype("int32")}] * 5


def _z_feeds(dim, classes, seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(8, dim).astype("float32"),
            "lab": rng.randint(0, classes, (8, 1)).astype("int32")}


def _lm_feeds(seed=7, n=4, steps=2):
    rng = np.random.RandomState(seed)
    V, T = pc.TINY_LM["vocab_size"], pc.TINY_LM["max_len"]
    f = {"toks": rng.randint(0, V, (n, T)).astype(np.int32),
         "labs": rng.randint(0, V, (n, T, 1)).astype(np.int32)}
    return [f] * steps


@pytest.fixture(scope="module")
def gang():
    """JAX references and the port's results, by case.  The weights come
    from the JAX package's startup programs first; then the gang runs
    while this process computes the JAX references."""
    refs, specs, jobs = {}, {}, {}

    feeds = _mlp_feeds()
    init = jax_run("mlp", [])[0]
    specs["dp_mlp"] = dict(kind="program", build="mlp", init=init,
                           feeds=feeds, mesh={"dp": RANKS}, state=["w1"])

    def dp_mlp(init=init, feeds=feeds):
        _, single, fin, _ = jax_run("mlp", feeds, init=init, state=["w1"])
        _, dp, dfin, _ = jax_run("mlp", feeds, mesh={"dp": RANKS},
                                 init=init, state=["w1"])
        return {"single": single, "single_state": fin, "dp": dp,
                "dp_state": dfin}

    jobs["dp_mlp"] = dp_mlp
    for case, dim, classes, seed in (("zero1", 8, 4, 0),
                                     ("zero1_packed", 7, 5, 3)):
        feeds = [_z_feeds(dim, classes, seed)] * 3
        init = jax_run(case, [])[0]
        names = sorted(init)
        specs[case] = dict(kind="program", build=case, init=init,
                           feeds=feeds, mesh={"dp": RANKS}, zero1=True,
                           state=names)

        def zero1(case=case, init=init, feeds=feeds, names=names):
            _, steps, fin, strat = jax_run(case, feeds, mesh={"dp": RANKS},
                                           zero1=True, init=init,
                                           state=names)
            return {"steps": steps, "state": fin,
                    "coverage": strat.last_shard_coverage}

        jobs[case] = zero1

    full = _z_feeds(8, 4, 5)
    halves = [{k: v[:4] for k, v in full.items()},
              {k: v[4:] for k, v in full.items()}]
    init = jax_run("accum_1", [])[0]
    specs["zero1_accum"] = dict(kind="program", build="accum",
                                init={n: a for n, a in init.items()
                                      if n in ("za.w", "za.b")},
                                feeds=halves * 2, mesh={"dp": RANKS},
                                zero1=True, state=["za.w", "za.b"])
    jobs["zero1_accum"] = lambda init=init: {"state": jax_run(
        "accum_1", [full] * 2, init=init, state=["za.w", "za.b"])[2]}

    rng = np.random.RandomState(1)
    feeds = [{"x": rng.rand(8, 12).astype("float32"),
              "y": rng.randint(0, 4, (8, 1)).astype("int32")}] * 4
    wnames = ["col.w", "col.b", "row.w", "row.b", "out.w", "out.b"]
    init = jax_run("megatron_clip", [])[0]
    specs["clip_tp"] = dict(kind="program", build="megatron_clip",
                            init=init, feeds=feeds, mesh={"dp": 2, "tp": 2},
                            state=wnames)

    def clip_tp(init=init, feeds=feeds):
        _, steps, fin, _ = jax_run("megatron_clip", feeds,
                                   mesh={"dp": 2, "tp": 2}, init=init,
                                   state=wnames)
        return {"steps": steps, "state": fin,
                "unclipped": jax_run("megatron", feeds, init=init)[1]}

    jobs["clip_tp"] = clip_tp
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.randn(8, 16, 32).astype("float32")}] * 2
    init = jax_run("dropout", [])[0]
    specs["dropout_dp"] = dict(kind="program", build="dropout", init=init,
                               feeds=feeds, fetch=["$1"],
                               mesh={"dp": RANKS}, step_counter=3)
    jobs["dropout_dp"] = lambda init=init, feeds=feeds: {"steps": jax_run(
        "dropout", feeds, fetch=["$1"], init=init, step_counter=3)[1]}

    feeds = _lm_feeds()
    init = jax_run("lm", [], kw={"dropout": 0.1})[0]
    for case, mesh, kw in (
            ("lm_dropout_dp_sp", {"dp": 2, "sp": 2},
             {"dropout": 0.1, "use_sp": True}),
            ("lm_dropout_striped_tp", {"sp": 2, "tp": 2},
             {"dropout": 0.1, "use_sp": True, "use_tp": True,
              "sp_strategy": "ring_striped"})):
        specs[case] = dict(kind="program", build="lm", kw=kw, init=init,
                           feeds=feeds, mesh=mesh, step_counter=5)
    jobs["lm_dropout"] = lambda init=init, feeds=feeds: {"steps": jax_run(
        "lm", feeds, kw={"dropout": 0.1}, init=init, step_counter=5)[1]}

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(distributed.spawn, pc.run_cases, RANKS, specs,
                          device="cpu", timeout_s=400)
        refs = {case: job() for case, job in jobs.items()}
        got = fut.result()[0]
    return refs, got


def _close_state(got, want, tol=1e-5):
    assert set(got) == set(want)
    for n, w in want.items():
        g = np.asarray(got[n], dtype=np.float64).reshape(np.shape(w))
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, n


def _losses(steps):
    return [float(np.ravel(s[0])[0]) for s in steps]


def test_data_parallel_matches_single_device_and_jax_dp(gang):
    refs, got = gang
    r, g = refs["dp_mlp"], got["dp_mlp"]
    np.testing.assert_allclose(_losses(g["steps"]), _losses(r["single"]),
                               rtol=1e-5)
    np.testing.assert_allclose(_losses(g["steps"]), _losses(r["dp"]),
                               rtol=1e-5)
    _close_state(g["state"], r["single_state"])
    _close_state(g["state"], r["dp_state"])


@pytest.mark.parametrize("case", ["zero1", "zero1_packed"])
def test_zero1_matches_jax_and_coverage(gang, case):
    refs, got = gang
    r, g = refs[case], got[case]
    np.testing.assert_allclose(_losses(g["steps"]), _losses(r["steps"]),
                               rtol=1e-5)
    # the coverage dict is the reference's, byte for byte
    assert g["coverage"] == r["coverage"]
    assert g["coverage"]["fraction"] == 1.0
    # JAX keeps packed accumulators flat and padded; the port's gathered
    # state has the variable's shape, the pad tail dropped
    want = {}
    for n, w in r["state"].items():
        w = np.asarray(w)
        shape = np.shape(g["state"][n])
        want[n] = w.reshape(-1)[:int(np.prod(shape))].reshape(shape)
        if w.size > np.prod(shape):
            assert np.all(w.reshape(-1)[int(np.prod(shape)):] == 0), n
    _close_state(g["state"], want)
    # each rank holds a quarter of every moment (spec rows or packed)
    for n, shape in g["local_shapes"].items():
        if n.endswith((".moment1", ".moment2")):
            full = np.shape(g["state"][n])
            assert np.prod(shape) == -(-int(np.prod(full)) // RANKS), \
                (n, shape)
    if case == "zero1_packed":
        assert g["local_shapes"]["zp.w.adam_p.moment1"] == (9,)


def test_zero1_with_gradient_accumulation(gang):
    """Accumulation over two half-batch micro-steps under ZeRO-1 on dp = 4
    equals the JAX package's big-batch single-device run."""
    refs, got = gang
    _close_state(got["zero1_accum"]["state"], refs["zero1_accum"]["state"])


def test_global_norm_clip_under_tp(gang):
    refs, got = gang
    r, g = refs["clip_tp"], got["clip_tp"]
    np.testing.assert_allclose(_losses(g["steps"]), _losses(r["steps"]),
                               rtol=1e-5)
    _close_state(g["state"], r["state"])
    # the clip bites: the unclipped run's losses differ
    assert abs(_losses(r["unclipped"])[-1] - _losses(r["steps"])[-1]) > 1e-4


def test_dropout_masks_under_dp_are_the_global_tensors(gang):
    refs, got = gang
    for gs, rs in zip(got["dropout_dp"]["steps"],
                      refs["dropout_dp"]["steps"]):
        assert np.array_equal(gs[1], rs[1])       # bitwise, zeros included
        np.testing.assert_allclose(gs[0], rs[0], rtol=1e-5)


@pytest.mark.parametrize("case", ["lm_dropout_dp_sp", "lm_dropout_striped_tp"])
def test_lm_dropout_sharded_matches_jax_single_device(gang, case):
    refs, got = gang
    np.testing.assert_allclose(_losses(got[case]["steps"]),
                               _losses(refs["lm_dropout"]["steps"]),
                               rtol=1e-5)


def _slice_mask(key, shape, p, mesh_axes, seq, striped):
    """The mask a rank draws for its slice, every rank's slices put back in
    global order."""
    grid = np.arange(math.prod(mesh_axes.values())).reshape(
        *mesh_axes.values())
    dp = mesh_axes.get("dp", 1)
    sp = mesh_axes.get("sp", 1)
    out = np.zeros(shape, bool)
    for r in range(grid.size):
        mesh = Mesh(grid, tuple(mesh_axes), r)
        sp_ax = SeqAxis("sp", striped) if seq else None
        lay = StepLayout(mesh, "dp" if "dp" in mesh_axes else None, sp_ax,
                         shape[0])
        b = shape[0] // dp
        rows = slice(mesh.coord("dp") * b, (mesh.coord("dp") + 1) * b)
        local = (b, shape[1] // sp) + tuple(shape[2:]) if seq \
            else (b,) + tuple(shape[1:])
        m = dmod.keep_mask(key, local, p, cmap=lay.counter_map(local, sp_ax))
        if seq:
            pos = pc.shard_seq(np.arange(shape[1])[None, None], sp,
                               mesh.coord("sp"), striped)[0, 0]
            out[rows][:, pos] = m.numpy()   # out[rows] is a view
        else:
            out[rows] = m.numpy()
    return out


@pytest.mark.parametrize("layout", ["dp4", "dp2_sp2", "sp4_striped"])
def test_dropout_offsets_split_the_global_mask_bitwise(layout):
    """The mask of one [8, 1024, 512] tensor drawn as 4 slices, each with its
    counter map (4 row slices; dp x sp; striped sp), is bitwise the whole
    tensor's mask and JAX's bernoulli."""
    shape, p = (8, 1024, 512), 0.1
    key = dmod.ThreefryKey(0, 5, 13)
    mesh_axes, seq, striped = {
        "dp4": ({"dp": 4}, False, False),
        "dp2_sp2": ({"dp": 2, "sp": 2}, True, False),
        "sp4_striped": ({"sp": 4}, True, True)}[layout]
    got = _slice_mask(key, shape, p, mesh_axes, seq, striped)
    whole = dmod.keep_mask(key, shape, p).numpy()
    assert np.array_equal(got, whole)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.key(0),
                                                 np.uint32(5)), 13)
    want = np.asarray(jax.random.bernoulli(jkey, 1 - p, shape))
    assert np.array_equal(whole, want)


def _kernel_walk(n: int, cmap, stride: int) -> np.ndarray:
    """The global indices ``dropout.cu``'s mapped kernel draws, thread by
    thread as it walks: one division of its first index by ``row``, then
    the quotient and remainder advanced by the grid stride's."""
    g = np.full(n, -1, np.int64)
    dr, dc = divmod(stride, cmap.row)
    for i in range(min(stride, n)):
        r, c = divmod(i, cmap.row)
        while i < n:
            g[i] = cmap.base + r * cmap.stride + c + (
                cmap.off0 if c < cmap.seg else cmap.off1)
            r, c, i = r + dr, c + dc, i + stride
            if c >= cmap.row:
                r, c = r + 1, c - cmap.row
    return g


@pytest.mark.parametrize("layout", ["sp2", "sp2_striped", "dp2_sp2_striped"])
def test_dropout_kernel_walk_is_the_counter_map(layout):
    """The mapped kernel's index walk, at grid strides below, at and above
    a row (carries), gives every element the global index the plain
    version's ``global_index`` gives it."""
    axes = {"sp2": {"sp": 2}, "sp2_striped": {"sp": 2},
            "dp2_sp2_striped": {"dp": 2, "sp": 2}}[layout]
    sp_ax = SeqAxis("sp", striped=layout.endswith("striped"))
    grid = np.arange(math.prod(axes.values())).reshape(*axes.values())
    local = (3, 8, 5)
    n = math.prod(local)
    for r in range(grid.size):
        mesh = Mesh(grid, tuple(axes), r)
        lay = StepLayout(mesh, "dp" if "dp" in axes else None, sp_ax, 6)
        cmap = lay.counter_map(local, sp_ax)
        assert cmap.row == 40
        want = dmod.global_index(torch.arange(n), cmap).numpy()
        for stride in (1, 7, 40, 97, 256):
            np.testing.assert_array_equal(_kernel_walk(n, cmap, stride),
                                          want, err_msg=f"{r} {stride}")


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n, capsys):
    out = dry.dryrun_multichip(n, device="cpu")
    labels = [label for label, _, _ in out]
    assert labels[0] == "composite" and "tp=4" in labels
    assert labels[-1] == "pp+ep"
    assert out[-1][1] == {"dp": n // 4, "pp": 2, "ep": 2}
    if n == 8:
        assert labels == ["composite", "striped ring", "ulysses", "tp=4",
                          "pp+ep"]
        assert out[0][1] == {"dp": 2, "sp": 2, "tp": 2}
    printed = capsys.readouterr().out
    assert printed.count("dryrun_multichip ok:") == len(out)


@pytest.mark.parametrize("zero1", [False, True])
def test_describe_pack_state_and_packed_names_match_jax(zero1):
    """``describe`` is the reference's canonical descriptor string, and
    ``packed_accumulators`` and ``pack_state`` give the reference's names
    and arrays, for the Megatron block with Adam and the packed program on
    one mesh {dp: 2, tp: 2} (built in both packages; no ranks needed)."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import parallel as tpar

    def build(fl, par):
        fl.reset_default_programs()
        pc.build_megatron(fl, par)
        pc.build_zero1_packed(fl, par)
        prog = fl.default_main_program()
        names = sorted(v.name for v in prog.persistable_vars())
        return prog, names

    jprog, jnames = build(jfluid, jpar)
    tprog, tnames = build(tfluid, tpar)
    assert jnames == tnames
    jmesh = jpar.make_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    tmesh = tpar.make_mesh({"dp": 2, "tp": 2}, devices=list(range(4)))
    js = jpar.Strategy(jmesh, shard_optimizer_state=zero1)
    ts = tpar.Strategy(tmesh, shard_optimizer_state=zero1)
    feeds = ["x", "y", "lab"]
    assert ts.describe(tprog, tnames, feeds) == \
        js.describe(jprog, jnames, feeds)
    assert ts.packed_accumulators(tprog, tnames) == \
        js.packed_accumulators(jprog, jnames)
    rng = np.random.RandomState(4)
    state = {n: rng.randn(*[d for d in tprog.global_block.var(n).shape])
             .astype("float32") for n in tnames
             if tprog.global_block.var(n).dtype == torch.float32}
    jp, tp_ = js.pack_state(jprog, state), ts.pack_state(tprog, state)
    assert set(jp) == set(tp_)
    for n in jp:
        assert np.array_equal(np.asarray(jp[n]), np.asarray(tp_[n])), n

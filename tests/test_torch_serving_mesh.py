"""The port's mesh-sharded serving (``serving/mesh.py``,
``ContinuousDecodeEngine(mesh=)``), the sharded embedding table and ctr's
``shard_spec``, against the JAX package.

In one process: ``SpecLayout`` on every LM parameter, ``fit_axes``,
``_fit_spec``, parsing, degrading and the environment, and the canonical
descriptor, each the reference's value (the descriptor string equal to
the JAX package's for the same request); a one-device ServingMesh is
bitwise the engine without a mesh (step logits and token streams).

On a gang of 4 CPU ranks over gloo (one gang, the ``gang`` fixture), the
reference's engine configuration (V 200, d 64, 4 heads, 2 layers, 8
slots, block 8):
* {data 4}: token streams equal to the port's single engine (the
  reference's bitwise token contract), the scheduler's mesh stats, no
  leaked block;
* {fsdp 2, tp 2}: the teacher-forced step logits within the reference's
  rtol = atol = 2e-5 of the JAX package's mesh engine on 4 virtual
  devices (and of the port's single engine), greedy streams matching the
  single engine at the C.5 floor of 0.98 of the tokens, 2 heads a rank,
  ``warm()`` refused with WarmError, no leaked block;
* ``ShardedEmbeddingTable(mesh=)`` over {fsdp 2} and {fsdp 2, tp 2}:
  lookup and row-touched apply bitwise the unsharded table;
* ctr's wide_deep with every field table vocab-sharded over tp
  (``shard_spec``) on {dp 2, tp 2}, dense and ``is_sparse=True``: two Adam
  steps against the JAX package on one device, losses rtol 1e-5,
  parameters within 1e-5 of their max abs;
* ``kv_dtype="int8"`` on {data 2, tp 2} (logits against the JAX int8 mesh
  engine and the single int8 engine at rtol = atol = 2e-5, streams at the
  0.98 floor) and ``kv_dtype="bfloat16"`` on {data 4} (streams equal to
  the single bf16 engine's, logits within 2e-5)."""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jfluid
import paddle_tpu.models.ctr  # noqa: F401  (jfluid.models.ctr)
from paddle_tpu import parallel as jpar
from paddle_tpu.models import transformer as jtfm
from paddle_tpu.serving import ContinuousDecodeEngine as JEngine
from paddle_tpu.serving import make_serving_mesh as j_make
from paddle_tpu.serving import mesh as jmesh
from paddle_tpu_torch import distributed
from paddle_tpu_torch.models import transformer as ttfm
from paddle_tpu_torch.serving import ContinuousDecodeEngine
from paddle_tpu_torch.serving import mesh as tmesh
from paddle_tpu_torch.tools import parallel_cases as pc

RANKS = 4
LM_KW = dict(vocab_size=200, max_len=48, d_model=64, n_heads=4, n_layers=2,
             d_ff=128, n_slots=8, block_size=8, prompt_buckets=(16,))
TABLE_IDS = np.array([[1, 2], [5, 2], [0, 3], [7, 6]], dtype=np.int64)
# a kv_dtype other than the compute dtype on a serving mesh: the int8 pool
# (payload and scales) with heads over tp and rows over data, and bf16 K/V
# under float32 compute over data
KV_MESHES = {"data=2,tp=2": "int8", "data=4": "bfloat16"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jspec(spec) -> tuple:
    return tuple(spec)


# ------------------------------------------------------------ table units


def test_spec_layout_covers_every_lm_param_as_the_reference():
    shapes = ttfm.lm_param_shapes(1000, 64, d_model=64, n_heads=4,
                                  n_layers=2, d_ff=128, tie_embeddings=False)
    assert shapes == jtfm.lm_param_shapes(1000, 64, d_model=64, n_heads=4,
                                          n_layers=2, d_ff=128,
                                          tie_embeddings=False)
    tl, jl = tmesh.SpecLayout(), jmesh.SpecLayout()
    for name, shape in shapes.items():
        assert tuple(tl.spec_for(name, shape)) == \
            _jspec(jl.spec_for(name, shape)), name
    assert tuple(tl.spec_for("tok_emb", (1000, 64))) == (("fsdp", "tp"), None)
    assert tuple(tl.spec_for("conv1.filters", (3, 3, 16, 32))) == ()
    for fam in ("embeddings", "qkv_projection", "attn_output", "ffn_up",
                "ffn_down", "norm_or_bias", "lm_head", "activations"):
        assert tuple(getattr(tl, fam)()) == _jspec(getattr(jl, fam)()), fam


def test_fit_axes_and_fit_spec_match_the_reference():
    for req, n in (({"data": 2, "fsdp": 2, "tp": 2}, 8),
                   ({"data": 2, "fsdp": 2, "tp": 2}, 4),
                   ({"data": 2, "fsdp": 2, "tp": 2}, 2),
                   ({"data": 8, "fsdp": 4, "tp": 4}, 1),
                   ({"tp": 8}, 3)):
        assert tmesh.fit_axes(req, n) == jmesh.fit_axes(req, n)
    sizes = {"data": 2, "fsdp": 2, "tp": 4}
    for spec, shape, sz in (
            ((("fsdp", "tp"),), (7, 64), sizes),
            (("fsdp", "tp"), (7, 64), sizes),
            ((("fsdp", "tp"), None), (12, 64), sizes),
            (("fsdp", "tp"), (64, 64), {"data": 8, "fsdp": 1, "tp": 1}),
            (("tp", "fsdp"), (64, 6), sizes)):
        got = tmesh._fit_spec(tmesh.P(*spec), shape, sz)
        want = jmesh._fit_spec(JP(*spec), shape, sz)
        assert tuple(got) == _jspec(want), (spec, shape)


def test_make_serving_mesh_parse_degrade_and_env():
    assert tmesh.make_serving_mesh(None) is None
    assert tmesh.make_serving_mesh("") is None
    with pytest.raises(ValueError):
        tmesh.make_serving_mesh("warp=4")
    with pytest.raises(ValueError):
        tmesh.make_serving_mesh("data")
    with pytest.raises(ValueError):
        tmesh.make_serving_mesh({"data": 0})
    sm = tmesh.make_serving_mesh("data=2,tp=4", devices=list(range(8)))
    assert sm.axes == {"data": 2, "tp": 4} and sm.size == 8
    assert sm.mesh is not None and sm.summary()["sharded"] is True
    sm4 = tmesh.make_serving_mesh({"data": 4}, devices=list(range(8)))
    assert sm4.size == 4 and sm4.mesh is not None
    # one process, no process group: every request collapses to one rank
    sm1 = tmesh.make_serving_mesh("data=8,tp=8")
    assert sm1 is not None and sm1.mesh is None and sm1.size == 1
    assert sm1.summary() == {"axes": {"data": 1, "fsdp": 1, "tp": 1},
                             "devices": 1, "sharded": False}
    assert sm1.shard_params({"w": np.ones(3)})["w"].shape == (3,)
    assert sm.heads_shardable(8) and not sm.heads_shardable(6)
    os.environ[tmesh.MESH_ENV] = "data=2"
    try:
        env = tmesh.mesh_from_env()
        assert env is not None and env.mesh is None   # one rank here
        assert tmesh.mesh_from_env({tmesh.MESH_ENV: ""}) is None
    finally:
        del os.environ[tmesh.MESH_ENV]


def test_canonical_descriptor_is_device_free_and_the_references():
    shapes = ttfm.lm_param_shapes(256, 32, d_model=32, n_heads=4,
                                  n_layers=1, d_ff=64)
    devs = list(range(8))
    a = tmesh.make_serving_mesh("data=2,tp=4", devices=devs)
    b = tmesh.make_serving_mesh("data=2,tp=4", devices=devs[4:] + devs[:4])
    assert a.describe(shapes) == b.describe(shapes)
    c = tmesh.make_serving_mesh("data=4,tp=2", devices=devs)
    assert a.describe(shapes) != c.describe(shapes)
    ja = j_make("data=2,tp=4", devices=jax.devices()[:8])
    assert a.describe(shapes) == ja.describe(shapes)
    assert a.describe() == ja.describe()


def test_one_device_mesh_is_bitwise_the_unsharded_engine():
    params = ttfm.init_lm_params(0, 200, 48, 64, 4, 2, 128)
    sm = tmesh.make_serving_mesh("data=8,fsdp=2,tp=4")
    assert sm.mesh is None
    plain = ContinuousDecodeEngine(params, device="cpu", **LM_KW)
    meshed = ContinuousDecodeEngine(params, device="cpu", mesh=sm, **LM_KW)
    assert type(meshed.model) is type(plain.model)
    probe = pc.probe_inputs(plain)
    assert np.array_equal(plain.step_logits(*probe),
                          meshed.step_logits(*probe))
    a = pc.drive_scheduler(plain, 8, 10)[0]
    b, sched = pc.drive_scheduler(meshed, 8, 10)[:2]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sched.stats()["mesh"]["sharded"] is False


# ------------------------------------------------------------ the gang


def jax_ctr_run(feeds, init=None, state=(), is_sparse=False):
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    loss = pc.build_ctr_tp(jfluid, jpar, P=JP, is_sparse=is_sparse)
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    scope = jfluid.global_scope()
    if init is None:
        init = {n: np.asarray(v) for n, v in scope.items()}
    else:
        for n, a in init.items():
            scope.set_var(n, jnp.asarray(a))
    scope.step_counter = 0
    steps = [[np.asarray(v) for v in exe.run(feed=f, fetch_list=[loss])]
             for f in feeds]
    return init, steps, {n: np.asarray(scope.find_var(n)) for n in state}


def _ctr_feed():
    rng = np.random.RandomState(6)
    n = 8
    return {"dense": rng.randn(n, 13).astype("float32"),
            "sparse": np.stack([rng.randint(0, v, n) for v in
                                pc.CTR_VOCABS], 1).astype("int32"),
            "label": rng.randint(0, 2, (n, 1)).astype("int32")}


@pytest.fixture(scope="module")
def gang():
    params = jtfm.init_lm_params(0, 200, 48, 64, 4, 2, 128)
    params = {n: np.asarray(v) for n, v in params.items()}
    specs = {m: dict(kind="serve", mesh=m, params=params, cfg=LM_KW,
                     n_req=8, max_gen=10)
             for m in ("data=4", "fsdp=2,tp=2")}
    for m in ("fsdp=2", "fsdp=2,tp=2"):
        specs["table " + m] = dict(kind="table", mesh=m, vocabs=[8, 8],
                                   ids=TABLE_IDS)
    feed = _ctr_feed()
    init = jax_ctr_run([])[0]
    specs["ctr_tp"] = dict(kind="program", build="ctr_tp", init=init,
                           feeds=[feed] * 2, mesh={"dp": 2, "tp": 2},
                           state=sorted(init))
    # the sparse engine's lookup on the vocab-sharded tables, with ids
    # past every field's vocabulary and below 0 (clamped forward, dropped
    # from the table cotangent)
    sfeed = dict(feed, sparse=feed["sparse"].copy())
    sfeed["sparse"][0] = [-1, 40, 9, 99]
    specs["ctr_tp_sparse"] = dict(kind="program", build="ctr_tp",
                                  kw={"is_sparse": True}, init=init,
                                  feeds=[sfeed] * 2, mesh={"dp": 2, "tp": 2},
                                  state=sorted(init))
    for m, kv in KV_MESHES.items():
        specs[f"{kv} {m}"] = dict(kind="serve", mesh=m, params=params,
                                  cfg=dict(LM_KW, kv_dtype=kv), n_req=8,
                                  max_gen=10)

    def refs():
        out = {}
        single = ContinuousDecodeEngine(params, device="cpu", **LM_KW)
        single.warm()
        out["probe"] = single.step_logits(*pc.probe_inputs(single))
        out["streams"] = pc.drive_scheduler(single, 8, 10)[0]
        jsm = j_make("fsdp=2,tp=2", devices=jax.devices()[:4])
        jeng = JEngine(params, mesh=jsm, **LM_KW)
        out["jax_probe"] = np.asarray(jeng.step_logits(
            *pc.probe_inputs(jeng)))
        for m in ("fsdp=2", "fsdp=2,tp=2"):
            out["table " + m] = pc.table_case(dict(
                mesh=None, vocabs=[8, 8], ids=TABLE_IDS))
        out["ctr_tp"] = jax_ctr_run([feed] * 2, init, sorted(init))[1:]
        out["ctr_tp_sparse"] = jax_ctr_run([sfeed] * 2, init, sorted(init),
                                           is_sparse=True)[1:]
        for m, kv in KV_MESHES.items():
            eng = ContinuousDecodeEngine(params, device="cpu", kv_dtype=kv,
                                         **LM_KW)
            out[kv + " probe"] = eng.step_logits(*pc.probe_inputs(eng))
            out[kv + " streams"] = pc.drive_scheduler(eng, 8, 10)[0]
        jeng = JEngine(params, mesh=j_make("data=2,tp=2",
                                           devices=jax.devices()[:4]),
                       kv_dtype="int8", **LM_KW)
        out["jax int8 probe"] = np.asarray(jeng.step_logits(
            *pc.probe_inputs(jeng)))
        return out

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(distributed.spawn, pc.run_cases, RANKS, specs,
                          device="cpu", timeout_s=300)
        want = refs()
        got = fut.result()[0]
    return want, got


def _no_leak(blocks):
    assert not blocks.get("leaked"), blocks


def test_data_mesh_streams_equal_the_single_engine(gang):
    want, got = gang
    g = got["data=4"]
    assert g["rows"] == 2 and g["pool_heads"] == 4
    assert isinstance(g["warm"], int) and g["warm"] > 0
    for a, b in zip(g["streams"], want["streams"]):
        assert np.array_equal(a, b)
    assert g["mesh"] == {"axes": {"data": 4, "fsdp": 1, "tp": 1},
                         "devices": 4, "sharded": True}
    _no_leak(g["blocks"])


def test_fsdp_tp_mesh_step_logits_match_jax_mesh_engine(gang):
    want, got = gang
    g = got["fsdp=2,tp=2"]
    np.testing.assert_allclose(g["logits"], want["jax_probe"], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(g["logits"], want["probe"], rtol=2e-5,
                               atol=2e-5)
    assert g["pool_heads"] == 2 and g["rows"] == LM_KW["n_slots"]
    assert "WarmError" not in g["warm"] and "gloo" in g["warm"]
    hits = sum(int(np.sum(a == b)) for a, b in zip(g["streams"],
                                                   want["streams"]))
    total = sum(b.size for b in want["streams"])
    assert hits >= 0.98 * total
    assert g["mesh"]["axes"] == {"data": 1, "fsdp": 2, "tp": 2}
    _no_leak(g["blocks"])


@pytest.mark.parametrize("mesh", ["fsdp=2", "fsdp=2,tp=2"])
def test_sharded_table_is_bitwise_the_unsharded_one(gang, mesh):
    want, got = gang
    g, w = got["table " + mesh], want["table " + mesh]
    assert np.array_equal(g["lookup"], w["lookup"])
    assert np.array_equal(g["value"], w["value"])
    assert g["rows"] == (8 if mesh == "fsdp=2" else 4)
    assert '"spec": [' in g["describe"]


@pytest.mark.parametrize("case", ["ctr_tp", "ctr_tp_sparse"])
def test_ctr_shard_spec_on_tp_matches_jax(gang, case):
    """Dense lookups, and ``is_sparse=True`` (the sparse engine's rule on
    each rank's rows; out-of-range ids in the feed)."""
    want, got = gang
    steps, fin = want[case]
    g = got[case]
    np.testing.assert_allclose([float(np.ravel(s[0])[0]) for s in g["steps"]],
                               [float(np.ravel(s[0])[0]) for s in steps],
                               rtol=1e-5)
    for n, w in fin.items():
        a = np.asarray(g["state"][n], np.float64).reshape(np.shape(w))
        assert np.abs(a - w).max() <= 1e-5 * max(float(np.abs(w).max()),
                                                 1e-30), n


def test_int8_pool_on_data_tp_mesh_matches_jax_and_the_single_engine(gang):
    """kv_dtype="int8" on {data 2, tp 2}: 2 heads a rank in payload and
    scale plane, the step logits within rtol = atol = 2e-5 of the JAX
    package's int8 mesh engine and of the port's single int8 engine, the
    greedy streams matching the single int8 engine at the floor of 0.98 of
    the tokens, no leaked block."""
    want, got = gang
    g = got["int8 data=2,tp=2"]
    assert g["pool_heads"] == 2 and g["rows"] == LM_KW["n_slots"] // 2
    np.testing.assert_allclose(g["logits"], want["jax int8 probe"],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(g["logits"], want["int8 probe"], rtol=2e-5,
                               atol=2e-5)
    hits = sum(int(np.sum(a == b)) for a, b in zip(g["streams"],
                                                   want["int8 streams"]))
    assert hits >= 0.98 * sum(b.size for b in want["int8 streams"])
    _no_leak(g["blocks"])


def test_bf16_kv_on_data_mesh_streams_equal_the_single_engine(gang):
    """bf16 K/V under float32 compute on {data 4}: the rows gathered in
    the pool's dtype, the step logits within rtol = atol = 2e-5 of the
    single bf16 engine's (a rank's matmuls run 2 rows, not 8) and the
    streams its own, token for token."""
    want, got = gang
    g = got["bfloat16 data=4"]
    assert isinstance(g["warm"], int) and g["warm"] > 0
    np.testing.assert_allclose(g["logits"], want["bfloat16 probe"],
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(g["streams"], want["bfloat16 streams"]):
        assert np.array_equal(a, b)
    _no_leak(g["blocks"])

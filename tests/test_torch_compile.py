"""The compile store (``compile/aot.py``) and its hooks, on the CPU, held to
the contract of the JAX package's (``tests/test_compile.py``): the
fingerprint's stability and sensitivity (a changed kernel library too);
the store's round trips, misses and version skew that are not corruption,
quarantine of a whole entry and ``clear``, an entry another user could
have written read as a miss; the stored graph, in which every kernel of
a training step is a ``paddle_tpu_torch::*`` node (the LM, text_lstm, a
conv + BN + dropout step) and a step that launches outside a custom op is
not stored; ``Executor.warm`` returning ``compiled``, ``cached`` and
``aot_exec`` with a fresh Executor's stored step bitwise the live one and
within the LM tolerance
of the JAX package's step on the same weights; the Trainer's generations
restarting warm; the Session's buckets installed from the store, and a
corrupt store degrading to the live path; the ``compile`` verb and the
supervisor's forwarding.  One torch thread, tiny programs, stores under
``tmp_path``."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import capi_server
from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import obs
from paddle_tpu_torch.compile import AOTStore, aot
from paddle_tpu_torch.models.weights import load_scope
from paddle_tpu_torch.ops import dropout as dmod

REPO = Path(__file__).resolve().parents[1]
CPU = tfluid.CPUPlace()
LM = dict(vocab_size=64, max_len=16, d_model=32, n_heads=2, n_layers=2,
          d_ff=64)
B = 2


@pytest.fixture(autouse=True)
def fresh_state():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    obs.metrics.reset()
    obs.prof.reset()
    aot._active["store"] = None
    yield
    aot._active["store"] = None
    torch.set_num_threads(threads)


def _counter(name):
    return obs.metrics.default_registry().counter_value(name)


# ------------------------------------------------------------ fingerprint


def test_fingerprint_is_stable_and_sensitive(monkeypatch):
    args = ("train_step", "ir", (("x", (2, 4), "float32"),))
    base = aot.fingerprint(*args)
    assert base == aot.fingerprint(*args) and len(base) == 64
    assert base == aot.fingerprint(*args, kv_dtype="")
    variants = [
        aot.fingerprint("serving_bucket", *args[1:]),
        aot.fingerprint(args[0], "ir2", args[2]),
        aot.fingerprint(args[0], args[1], (("x", (3, 4), "float32"),)),
        aot.fingerprint(*args, sharding="s"),
        aot.fingerprint(*args, donate=(0,)),
        aot.fingerprint(*args, extra="amp"),
        aot.fingerprint(*args, backend="cuda:NVIDIA H100:sm_90"),
        aot.fingerprint(*args, kv_dtype="int8"),
    ]
    assert len({base, *variants}) == len(variants) + 1
    # a rebuilt kernel library (another source hash) and another torch
    kernels = aot.kernel_versions()
    assert "flash_attention.cu" in kernels
    changed = dict(kernels, **{"dropout.cu": "0" * 16})
    monkeypatch.setattr(aot, "kernel_versions", lambda: changed)
    assert aot.fingerprint(*args) != base
    monkeypatch.setattr(aot, "kernel_versions", lambda: kernels)
    assert aot.fingerprint(*args) == base
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert aot.fingerprint(*args) != base
    # the canonical sharding names axes and specs, never objects
    a = aot.canonical_sharding([("dp", 2), ("tp", 2)],
                               {"state": {"w": ("tp", None), "b": None}})
    b = aot.canonical_sharding([("dp", 2), ("tp", 2)],
                               {"state": {"b": None, "w": ["tp", None]}})
    assert a == b and "0x" not in a
    assert aot.backend_of("cpu") == "cpu"


# ------------------------------------------------------------------ store


def test_store_round_trip_miss_skew_quarantine_clear(tmp_path,
                                                     monkeypatch):
    obs.trace.enable()
    try:
        store = AOTStore(str(tmp_path / "aot"))
        fp, fp2 = "a" * 64, "b" * 64
        store.put_bytes(fp, "exec", b"exact", {"label": "t"})
        assert store.get_bytes(fp, "exec") == b"exact"
        assert store.get_bytes(fp2, "exec") is None   # a miss
        assert _counter("compile.aot_hits") == 1
        assert _counter("compile.aot_misses") == 1
        assert _counter("compile.aot_writes") == 1
        # a meta mismatch and version skew are misses, not corruption
        assert store.get_bytes(fp, "exec", require_meta={"devices": 8}) \
            is None
        real = aot._versions()
        monkeypatch.setattr(aot, "_versions", lambda: dict(real,
                                                            torch="0.0.0"))
        assert store.get_bytes(fp, "exec", require_exact_version=True) \
            is None
        monkeypatch.setattr(aot, "_versions", lambda: real)
        assert store.get_bytes(fp, "exec", require_exact_version=True) \
            == b"exact"
        assert _counter("compile.aot_corrupt") == 0
        spans = {e["name"] for e in obs.trace.events()}
        assert {"compile.aot_write", "compile.aot_load"} <= spans
    finally:
        obs.trace.disable()
    # one flipped byte quarantines the whole entry, its meta too
    store.put_bytes(fp2, "exec", b"x" * 64)
    path = tmp_path / "aot" / fp / "exec.bin"
    blob = bytearray(path.read_bytes())
    blob[3] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert store.get_bytes(fp, "exec") is None
    assert _counter("compile.aot_corrupt") == 1
    assert not (tmp_path / "aot" / fp).exists()
    assert (tmp_path / "aot" / (fp + ".corrupt") / "exec.meta.json").exists()
    assert store.get_bytes(fp, "exec") is None
    st = store.stats()
    assert st["entries"] == 1 and st["quarantined"] == 1
    assert st["layers"] == {"exec": 1}
    corrupt = [e for e in store.entries() if e["corrupt"]]
    assert [e["fingerprint"] for e in corrupt] == [fp + ".corrupt"]
    assert store.clear(include_quarantined=False) == 1
    assert [e["corrupt"] for e in store.entries()] == [True]
    assert store.clear() == 1 and store.entries() == []
    # an unpicklable exec layer of verified bytes is quarantined too
    store.put_bytes(fp, "exec", b"not a pickle")
    assert store.get_executable(fp) is None
    assert _counter("compile.aot_corrupt") == 2


@pytest.mark.parametrize("what", ["other_user", "group_writable",
                                  "world_writable_dir"])
def test_an_entry_others_could_write_is_a_miss(what, tmp_path,
                                               monkeypatch):
    """Loading unpickles, so the store reads only an entry whose directory
    and files this user owns and no one else can write; any other is a
    miss, left in place (not quarantined).  The store's own directories
    are 0700 and its files 0600."""
    import pickle

    store = AOTStore(str(tmp_path / "aot"))
    fp = "c" * 64
    store.put_bytes(fp, "exec", pickle.dumps({"w": 1}))
    entry = tmp_path / "aot" / fp
    assert (tmp_path / "aot").stat().st_mode & 0o777 == 0o700
    assert entry.stat().st_mode & 0o777 == 0o700
    for f in ("exec.bin", "exec.meta.json"):
        assert (entry / f).stat().st_mode & 0o077 == 0
    assert store.get_executable(fp) == {"w": 1}
    hits = _counter("compile.aot_hits")
    if what == "other_user":
        uid = os.getuid()
        monkeypatch.setattr(aot.os, "getuid", lambda: uid + 1)
    elif what == "group_writable":
        os.chmod(entry / "exec.bin", 0o620)
    else:
        os.chmod(entry, 0o777)
    assert store.get_executable(fp) is None
    assert _counter("compile.aot_hits") == hits
    assert _counter("compile.aot_corrupt") == 0 and entry.exists()
    monkeypatch.undo()
    os.chmod(entry, 0o700)
    os.chmod(entry / "exec.bin", 0o600)
    assert store.get_executable(fp) == {"w": 1}


def test_health_reports_the_store(tmp_path):
    assert tfluid.compile.health()["persistent_cache"]["enabled"] is False
    store = AOTStore(str(tmp_path / "aot")).activate()
    h = tfluid.compile.health()
    assert h["persistent_cache"] == {"dir": store.dirname, "enabled": True,
                                     "reason": "aot store"}
    assert obs.metrics.default_registry().gauge_value(
        "compile.persistent_cache_enabled") == 1.0


def test_check_launches():
    counts = {"flash_fwd": 2, "flash_bwd": 2, "dropout_fwd": 3}
    want = {("flash_attention.launches", "fwd"): 2,
            ("flash_attention.launches", "bwd_dkdv"): 2,
            ("flash_attention.launches", "bwd_dq"): 2,
            ("threefry_dropout.launches", "fwd"): 3}
    assert aot.expected_launches(counts) == want
    live = {"flash_attention.launches": {"fwd": 2, "bwd_dkdv": 2,
                                         "bwd_dq": 2},
            "threefry_dropout.launches": {"fwd": 3, "bwd": 0},
            "paged_attention.launches": 0}
    aot.check_launches(counts, live)
    aot.check_launches(counts, None)   # the CPU launches nothing
    live["threefry_dropout.launches"]["bwd"] = 3   # a launch outside
    with pytest.raises(RuntimeError, match="outside a custom op"):
        aot.check_launches(counts, live)


# ----------------------------------------------------- the stored graph


def _lm(fl, dropout=0.0):
    T = LM["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fl.models.transformer.build_lm(toks, labs, dropout=dropout,
                                             **LM)
    fl.optimizer.Adam(1e-3, grad_clip=fl.clip.GradientClipByGlobalNorm(
        1.0)).minimize(loss)
    return loss


def _lm_feeds(seed, n=3):
    rng = np.random.RandomState(seed)
    V, T = LM["vocab_size"], LM["max_len"]
    return [{"toks": rng.randint(0, V, (B, T)).astype(np.int32),
             "labs": rng.randint(0, V, (B, T, 1)).astype(np.int32)}
            for _ in range(n)]


def _text_lstm(fl):
    words = fl.layers.data("words", [12], dtype="int32")
    lengths = fl.layers.data("lengths", [-1], dtype="int32",
                             append_batch_size=False)
    label = fl.layers.data("label", [1], dtype="int32")
    loss, _, _ = fl.models.text_lstm.build(words, lengths, label, 30,
                                           emb_dim=8, hidden=16)
    fl.optimizer.Adam(1e-3).minimize(loss)
    return loss


def _conv_bn_dropout(fl):
    img = fl.layers.data("img", [3, 8, 8])
    label = fl.layers.data("label", [1], dtype="int32")
    c = fl.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
    h = fl.layers.dropout(fl.layers.batch_norm(c, act="relu"), 0.3)
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        fl.layers.fc(h, 3), label))
    fl.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return loss


def _model_sig(model):
    if model == "lm":
        return [(n, v.shape, v.dtype.name)
                for n, v in _lm_feeds(0, 1)[0].items()]
    if model == "text_lstm":
        return [("words", (B, 12), "int32"), ("lengths", (B,), "int32"),
                ("label", (B, 1), "int32")]
    return [("img", (B, 3, 8, 8), "float32"), ("label", (B, 1), "int32")]


def _count_ops(program, op_type, **attrs):
    return sum(1 for _, op in program.all_ops() if op.type == op_type
               and all(op.attrs.get(k) == v for k, v in attrs.items()))


@pytest.mark.parametrize("model", ["lm", "text_lstm", "conv_bn_dropout"])
def test_export_layer_holds_every_kernel_as_a_custom_op(model, tmp_path):
    """A live warm with a store writes its entry; the stored graph holds
    the step's kernels as ``paddle_tpu_torch::*`` nodes, one a launch: the flash
    forward and backward an attention op, the LSTM training forward and
    backward a ``dynamic_lstm``, the BN backward pair a training batch
    norm, the dropout forward and backward a training dropout."""
    build = {"lm": lambda fl: _lm(fl, dropout=0.1), "text_lstm": _text_lstm,
             "conv_bn_dropout": _conv_bn_dropout}[model]
    loss = build(tfluid)
    prog = tfluid.default_main_program()
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    store = AOTStore(str(tmp_path / "aot"))
    assert exe.warm(prog, _model_sig(model), [loss.name],
                    store=store) == "compiled"
    (entry,) = store.entries()
    assert set(entry["layers"]) == {"exec"}
    fp = entry["fingerprint"]
    attn = _count_ops(prog, "attention")
    lstm = _count_ops(prog, "dynamic_lstm")
    bn = _count_ops(prog, "batch_norm", is_test=False)
    drop = _count_ops(prog, "dropout", is_test=False)
    want = {k: n for k, n in (
        ("flash_fwd", attn), ("flash_bwd", attn), ("lstm_fwd_train", lstm),
        ("lstm_bwd", lstm), ("bn_bwd_reduce", bn), ("bn_bwd_dx", bn),
        ("dropout_fwd", drop), ("dropout_bwd", drop)) if n}
    assert want and (model != "lm" or drop > 0)
    assert aot.custom_op_counts(store.get_executable(fp)) == want


def test_a_raw_launch_is_refused_at_export_and_runs_live(tmp_path,
                                                         monkeypatch,
                                                         capfd):
    """A kernel launched outside a custom op (here a dropout forward that
    reads its operand's data pointer, as a ``ctypes`` launch does) fails
    the fake-mode trace: nothing is stored, and the live step runs."""
    real = dmod._Dropout.forward

    def raw(ctx, x, key, p, cmap):
        x.data_ptr()
        return real(ctx, x, key, p, cmap)

    monkeypatch.setattr(dmod._Dropout, "forward", staticmethod(raw))
    loss = _conv_bn_dropout(tfluid)
    prog = tfluid.default_main_program()
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    store = AOTStore(str(tmp_path / "aot"))
    assert exe.warm(prog, _model_sig("conv"), [loss.name],
                    store=store) == "compiled"
    assert store.entries() == []
    assert "AOT persist failed" in capfd.readouterr().err
    rng = np.random.RandomState(1)
    out = exe.run(prog, feed={
        "img": rng.rand(B, 3, 8, 8).astype(np.float32),
        "label": rng.randint(0, 3, (B, 1)).astype(np.int32)},
        fetch_list=[loss])[0]
    assert np.isfinite(out).all() and exe.replays == 1


# ------------------------------------------------------------- warm paths


def _weights(build):
    """Numpy startup weights of ``build``'s program."""
    build(tfluid)
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(tfluid.default_startup_program(), scope=scope)
    tfluid.reset_default_programs()
    return {n: v.numpy().copy() for n, v in scope.items()}


def _generation(build, arrays, feeds, store, analyze_calls=None):
    """A fresh program, scope and Executor (as a new process has): warm
    through ``store``, then run ``feeds``.  Returns (how, losses, state,
    executor)."""
    tfluid.reset_default_programs()
    loss = build(tfluid)
    prog = tfluid.default_main_program()
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(tfluid.default_startup_program(), scope=scope)
    load_scope(arrays, prog, scope, device="cpu")
    exe = tfluid.Executor(CPU)
    sig = [(n, v.shape, v.dtype.name) for n, v in feeds[0].items()]
    how = exe.warm(prog, sig, [loss.name], scope=scope, store=store)
    assert exe.warm(prog, sig, [loss.name], scope=scope,
                    store=store) == "cached"
    losses = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
              for f in feeds]
    state = {n: scope.find_var(n).clone() for n in arrays}
    return how, losses, state, exe


def test_warm_paths_and_stored_steps_bitwise(tmp_path, monkeypatch):
    """compiled (and cached) -> aot_exec, twice -> compiled again once the
    entry is corrupt: every generation's losses and final state bitwise
    the live one's, the
    dropout masks drawn from each replay's staged step counter; a loaded
    step whose costs the ledger sidecar knows skips the counted first
    run."""
    build = lambda fl: _lm(fl, dropout=0.1)  # noqa: E731
    arrays = _weights(build)
    feeds = _lm_feeds(3)
    store = AOTStore(str(tmp_path / "aot"))
    how, losses, state, exe = _generation(build, arrays, feeds, store)
    assert how == "compiled" and exe.compiles == 1 and exe.loads == 0
    (timings,) = exe.timings.values()
    assert {"trace_s", "write_s", "persist_s"} <= set(timings)
    assert (tmp_path / "prof_ledger.json").exists()
    calls = []
    real = obs.prof.analyze
    monkeypatch.setattr(obs.prof, "analyze",
                        lambda body: calls.append(1) or real(body))
    runs = {}
    for gen in (1, 2):
        h, ls, st, e = _generation(build, arrays, feeds, store)
        assert h == "aot_exec" and e.compiles == 0 and e.loads == 1
        assert set(e.timings[next(iter(e.timings))]) >= {"load_s",
                                                         "total_s"}
        runs[gen] = (ls, st)
    assert calls == []
    rows = obs.prof.ledger().snapshot()
    assert {r["source"] for r in rows.values()} == {"aot_exec"}
    assert all(r.get("flops") for r in rows.values())
    for ls, st in runs.values():
        assert all(np.array_equal(a, b) for a, b in zip(ls, losses))
        assert all(torch.equal(st[n], state[n]) for n in state)
    # a corrupt entry: quarantined, a live warm, the same numbers
    (entry,) = store.entries()
    path = tmp_path / "aot" / entry["fingerprint"] / "exec.bin"
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    path.write_bytes(bytes(blob))
    h, ls, st, e = _generation(build, arrays, feeds, store)
    assert h == "compiled" and _counter("compile.aot_corrupt") == 1
    assert all(np.array_equal(a, b) for a, b in zip(ls, losses))
    assert all(torch.equal(st[n], state[n]) for n in state)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def test_stored_step_matches_jax(tmp_path, interpret_mode):
    """The LM's three steps from the store (aot_exec) within 1e-5 of the JAX
    Executor's from the same weights, the executor warm test's bound."""
    feeds = _lm_feeds(5)
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    loss = _lm(jfluid)
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    arrays = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}
    want = [float(np.asarray(jexe.run(feed=f, fetch_list=[loss])[0]))
            for f in feeds]
    store = AOTStore(str(tmp_path / "aot"))
    live = _generation(_lm, arrays, feeds, store)
    loaded = _generation(_lm, arrays, feeds, store)
    assert (live[0], loaded[0]) == ("compiled", "aot_exec")
    assert all(np.array_equal(a, b) for a, b in zip(live[1], loaded[1]))
    np.testing.assert_allclose([float(v) for v in loaded[1]], want,
                               rtol=1e-5)


# ------------------------------------------------------------------ Trainer


def _trainer_model(fl):
    x = fl.layers.data("x", [6])
    y = fl.layers.data("y", [1])
    h = fl.layers.dropout(fl.layers.fc(x, 8, act="relu"), 0.2)
    loss = fl.layers.mean(fl.layers.square_error_cost(fl.layers.fc(h, 1),
                                                      y))
    return x, y, loss


def _reader(n=6, bs=4):
    rng = np.random.RandomState(0)
    xs = rng.rand(n * bs, 6).astype(np.float32)
    ys = xs.sum(1, keepdims=True).astype(np.float32)
    rows = [(xs[i], ys[i]) for i in range(n * bs)]
    return tfluid.reader.batch(lambda: iter(rows), bs)


def _train_generation(ckpt, num_passes, **kw):
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    x, y, loss = _trainer_model(tfluid)
    tr = tfluid.Trainer(loss, tfluid.optimizer.Adam(0.01), [x, y],
                        checkpoint_dir=str(ckpt), checkpoint_every_n_steps=4,
                        place=CPU, recompile_policy="raise",
                        recompile_budget=0, handle_preemption=False, **kw)
    tr.train(_reader(), num_passes=num_passes)
    params = {n: tfluid.global_scope().find_var(n).clone()
              for n in ("fc_w_0", "fc_b_0", "fc_w_1", "fc_b_1")}
    return tr, params


def test_trainer_generations_restart_warm(tmp_path):
    """Generation 0 starts cold (``prepare`` None), records its signature in
    the manifest and seeds the store through its first warm; generation 1
    resumes from the checkpoint and warm-starts from the store (aot_exec, no
    live preparation, 0 steady retraces, ``prepare`` idempotent), bitwise
    the same parameters as a generation 1 that prepares live."""
    tr0, _ = _train_generation(tmp_path / "ck", 1)
    assert tr0._warmup is None and tr0.exe.compiles == 1
    cdir = tmp_path / "ck" / "compile"
    man = json.loads((cdir / "manifest.json").read_text())
    assert len(man["entries"]) == 1
    assert len(AOTStore(str(cdir / "aot")).entries()) == 1
    shutil.copytree(tmp_path / "ck", tmp_path / "ck_live")
    shutil.rmtree(tmp_path / "ck_live" / "compile")   # no store: live
    obs.metrics.reset()
    tr1, warm = _train_generation(tmp_path / "ck", 2)
    wu = tr1._warmup
    assert wu is not None and tr1.prepare() is wu
    assert [v["result"] for v in wu.status().values()] == ["aot_exec"]
    assert wu.summary()["aot_satisfied"] == 1
    assert tr1.exe.compiles == 0 and tr1.exe.loads == 1
    assert _counter("compile.retraces") == 0
    assert tfluid.compile.health()["warm_start"] is True
    tr_live, live = _train_generation(tmp_path / "ck_live", 2)
    assert tr_live._warmup is None and tr_live.exe.compiles == 1
    assert tr1.global_step == tr_live.global_step == 12
    assert all(torch.equal(warm[n], live[n]) for n in warm)


# ------------------------------------------------------------------ serving


@pytest.fixture(params=["fc", "lm"])
def merged(request, tmp_path, monkeypatch):
    """A merged artifact with a symbolic batch: fc + softmax, or the LM's
    logits (whose heads' reshape is a view at batch 1)."""
    monkeypatch.setenv(capi_server.PLATFORM_ENV, "cpu")
    if request.param == "fc":
        x = tfluid.layers.data("x", [8])
        pred = tfluid.layers.fc(x, 4, act="softmax")
    else:
        T = LM["max_len"]
        x = tfluid.layers.data("toks", [T], dtype="int32")
        labs = tfluid.layers.data("labs", [T, 1], dtype="int32")
        _, pred = tfluid.models.transformer.build_lm(x, labs, **LM)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.io.save_inference_model(str(tmp_path / "m"), [x.name], [pred],
                                   exe, example_batch=2)
    tfluid.io.merge_model(str(tmp_path / "m"), str(tmp_path / "m.tar"))
    return str(tmp_path / "m.tar")


def _session(path, cdir):
    sess = capi_server.Session(path)
    sess.enable_batching(max_batch_size=4, compile_dir=cdir)
    sess._state.batcher.close()
    wu = sess._state.warmup
    results = {k: v["result"] for k, v in wu.status().items()}
    infer = sess._infer
    outs = {b: infer(sess._bucket_feeds(b))[0]
            for b in sorted(int(k.split(":")[1]) for k in results)}
    return results, infer, outs


def test_session_buckets_restart_warm(merged, tmp_path):
    """A cold Session prepares every bucket live and stores it; a second
    Session installs each from the store (no live preparation:
    ``trace_count`` 0, ``installed_count`` the ladder) with outputs bitwise
    the cold ones'; a corrupt store degrades to the live path with the
    same outputs, the entries quarantined."""
    cdir = str(tmp_path / "c")
    cold, infer0, outs0 = _session(merged, cdir)
    ladder = len(cold)
    assert ladder >= 2 and set(cold.values()) == {"compiled"}
    assert infer0.trace_count() == ladder and infer0.installed_count() == 0
    store = AOTStore(os.path.join(cdir, "aot"))
    assert len(store.entries()) == ladder
    warm, infer1, outs1 = _session(merged, cdir)
    assert set(warm.values()) == {"aot_exec"}
    assert infer1.trace_count() == 0 and infer1.installed_count() == ladder
    assert infer1.artifact_hash == infer0.artifact_hash
    assert all(np.array_equal(outs0[b], outs1[b]) for b in outs0)
    for e in store.entries():
        path = Path(store.dirname) / e["fingerprint"] / "exec.bin"
        blob = bytearray(path.read_bytes())
        blob[-1] ^= 0xFF
        path.write_bytes(bytes(blob))
    bad, infer2, outs2 = _session(merged, cdir)
    assert set(bad.values()) == {"compiled"}
    assert infer2.trace_count() == ladder
    assert _counter("compile.aot_corrupt") == ladder
    assert all(np.array_equal(outs0[b], outs2[b]) for b in outs0)


def test_session_fingerprint_carries_kv_dtype(merged, tmp_path):
    """A session declared int8-KV keys its buckets apart from a
    full-precision one sharing the compile dir."""
    cdir = str(tmp_path / "c")
    _session(merged, cdir)
    sess = capi_server.Session(merged).set_kv_dtype("int8")
    sess.enable_batching(max_batch_size=4, compile_dir=cdir)
    sess._state.batcher.close()
    results = {v["result"] for v in sess._state.warmup.status().values()}
    assert results == {"compiled"}


# -------------------------------------------------------- the command line


@pytest.fixture
def flag_registry():
    """The CLI defines its own flags (``compile_dir``, ...) in the
    process-wide registry: leave it as it was found."""
    saved = [(k, f, f.value) for k, f in tflags._registry.items()]
    yield
    tflags._registry.clear()
    for k, f, value in saved:
        f.value = value
        tflags._registry[k] = f


def test_compile_verb_stats_ls_clear(tmp_path, capsys, flag_registry):
    loss = _conv_bn_dropout(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    cdir = tmp_path / "c"
    exe.warm(tfluid.default_main_program(), _model_sig("conv"), [loss.name],
             store=AOTStore(str(cdir / "aot")))
    tfluid.compile.ShapeManifest(str(cdir / "manifest.json")).save()
    assert tcli.main(["compile", "stats", f"--compile_dir={cdir}"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["store"]["entries"] == 1
    assert out["store"]["layers"] == {"exec": 1}
    assert "manifest.json" in out["manifests"]
    assert tcli.main(["compile", "ls", f"--compile_dir={cdir}"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "exec:" in lines[0] and lines[-1].startswith("# 1 entr")
    assert tcli.main(["compile", "clear", f"--compile_dir={cdir}"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"cleared_entries": 1,
                   "removed_manifests": ["manifest.json"]}
    tflags.set_flag("compile_dir", "")
    assert tcli.main(["compile", "stats"]) == 2
    assert tcli.main(["compile", "nope", f"--compile_dir={cdir}"]) == 2


def test_supervisor_forwards_the_compile_dir(tmp_path):
    """``tools/supervise.py --compile-dir`` hands every generation the dir
    in ``PADDLE_TPU_COMPILE_DIR``, where a port Trainer finds it."""
    cdir = str(tmp_path / "c")
    child = ("import os; open(os.path.join(os.environ['PADDLE_TPU_COMPILE_"
             "DIR'] + '.seen'), 'w').write('1')")
    p = subprocess.run(
        [sys.executable, str(REPO / "paddle_tpu_torch" / "tools" /
                             "supervise.py"), "--max-restarts=0",
         f"--compile-dir={cdir}", "--", sys.executable, "-c", child],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr
    assert os.path.exists(cdir + ".seen")

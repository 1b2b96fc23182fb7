"""paddle_tpu_torch's serving front on the CPU: ``io.InferenceModel`` under
concurrent calls (ROADMAP C.15: each caller gets exactly its own solo
result, directly and through ``Session.clone``), the ``DynamicBatcher`` on
the reference's runner-level cases (``tests/test_serving_batching.py``),
the ``CircuitBreaker`` (``tests/test_resilience.py``), and the ``Session``
on a port ``merge_model`` artifact built from the JAX package's weights:
outputs at rtol 1e-5 (atol 1e-6, the reference's own test) against the JAX
package's ``Session`` on the same feeds, no capture after warm, the
healthz key set equal to the JAX Session's, the decode scheduler's stats in
healthz, and the hooks left for ROADMAP A.10 raising with its name."""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import capi_server as jcapi
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import capi_server, io as tio, profiler
from paddle_tpu_torch.models import load_scope
from paddle_tpu_torch.resilience import (CircuitBreaker, CircuitOpenError,
                                         Deadline, DeadlineExceeded,
                                         TransientError, faults)
from paddle_tpu_torch.serving import (AdmissionShed, BatchPolicy,
                                      DynamicBatcher)

CPU = tfluid.CPUPlace()
RTOL, ATOL = 1e-5, 1e-6   # tests/test_serving_batching.py:277
JOIN_S = 60               # every thread joins within this


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("PADDLE_TPU_CAPI_PLATFORM", "cpu")
    faults.clear()
    yield
    faults.clear()
    torch.set_num_threads(n)


def _run_threads(fns):
    ts = [threading.Thread(target=f, daemon=True) for f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in ts), "a client thread hung"


# ------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The reference's fc model (x [8] -> fc 4 softmax, example_batch 2)
    exported by both packages with the JAX startup's weights, each
    merged: {"jax": path, "port": path, "port_dir": dir}."""
    d = tmp_path_factory.mktemp("session")
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    x = jfluid.layers.data("x", [8])
    pred = jfluid.layers.fc(x, 4, act="softmax")
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    weights = {n: np.asarray(jfluid.global_scope().find_var(n))
               for n in ("fc_w_0", "fc_b_0")}
    jfluid.io.save_inference_model(str(d / "jax"), ["x"], [pred], jexe,
                                   example_batch=2)
    jfluid.io.merge_model(str(d / "jax"), str(d / "jax.tar"))
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    x = tfluid.layers.data("x", [8])
    pred = tfluid.layers.fc(x, 4, act="softmax")
    texe = tfluid.Executor(CPU)
    texe.run(tfluid.default_startup_program())
    load_scope(weights, tfluid.default_main_program(),
               tfluid.global_scope(), device="cpu")
    tfluid.io.save_inference_model(str(d / "port"), ["x"], [pred], texe,
                                   example_batch=2)
    tfluid.io.merge_model(str(d / "port"), str(d / "port.tar"))
    return {"jax": str(d / "jax.tar"), "port": str(d / "port.tar"),
            "port_dir": str(d / "port")}


@pytest.fixture
def sessions():
    """Sessions made by a test: their batchers are closed after it."""
    made = []
    yield made
    for s in made:
        if s._state.batcher is not None:
            s._state.batcher.close()


# ----------------------------------------------------------------- C.15


def _solo_results(model, xs):
    return [model({"x": a})[0] for a in xs]


def test_inference_model_is_safe_across_threads(artifacts):
    """ROADMAP C.15: 16 threads x 50 calls of one model at one feed
    signature ([4, 8]), each thread with its own input, each call getting
    exactly its solo result (the parent's model staged, replayed and read
    its one buffer set unlocked: most calls returned another thread's
    rows)."""
    model, _, _ = tio.load_inference_model(artifacts["port_dir"],
                                           tfluid.Executor(CPU))
    xs = [np.random.RandomState(i).randn(4, 8).astype("float32")
          for i in range(16)]
    solo = _solo_results(model, xs)
    wrong = [0] * 16

    def client(i):
        for _ in range(50):
            if not np.array_equal(model({"x": xs[i]})[0], solo[i]):
                wrong[i] += 1

    _run_threads([lambda i=i: client(i) for i in range(16)])
    assert wrong == [0] * 16
    assert model.trace_count() == 1


def test_session_clones_each_get_their_own_result(artifacts, sessions):
    """C.15 through the serving front: 8 clones of one Session (one model)
    run from 8 threads, each getting bitwise its own solo result."""
    sess = capi_server.Session(artifacts["port"])
    xs = [np.random.RandomState(100 + i).randn(3, 8).astype("float32")
          for i in range(8)]
    solo = _solo_results(sess._infer, xs)
    wrong = [0] * 8

    def client(i):
        c = sess.clone()
        for _ in range(25):
            c.feed("x", xs[i].tobytes(), "float32", list(xs[i].shape))
            assert c.run() == 1
            buf, dt, shape = c.output(0)
            if not np.array_equal(np.frombuffer(buf, dt).reshape(shape),
                                  solo[i]):
                wrong[i] += 1

    _run_threads([lambda i=i: client(i) for i in range(8)])
    assert wrong == [0] * 8
    assert sess.healthz()["requests"] == 200


# ----------------------------------------------------- the batcher alone


class CountingRunner:
    """Fake device (the reference test's): output 2x, counts calls and
    batch shapes; can block on a gate or fail a batch holding POISON."""

    POISON = 666.0

    def __init__(self, gate=None):
        self.calls = 0
        self.shapes = []
        self.gate = gate
        self.lock = threading.Lock()

    def __call__(self, feeds):
        if self.gate is not None:
            self.gate.wait(timeout=10)
        x = np.asarray(feeds["x"])
        with self.lock:
            self.calls += 1
            self.shapes.append(x.shape)
        if (x == self.POISON).any():
            raise ValueError("poisoned request")
        return [x * 2.0]


def _rows(i, n_rows=1, dim=4):
    return {"x": np.full((n_rows, dim), float(i + 1), "float32")}


def test_concurrent_requests_coalesce_into_one_call():
    runner = CountingRunner()
    eng = DynamicBatcher(runner, BatchPolicy(max_batch_size=8,
                                             max_queue_delay_ms=100.0))
    barrier = threading.Barrier(8)
    results = [None] * 8

    def client(i):
        barrier.wait()
        results[i] = eng.submit(_rows(i))

    _run_threads([lambda i=i: client(i) for i in range(8)])
    eng.close()
    assert runner.calls <= 2
    for i, outs in enumerate(results):
        np.testing.assert_array_equal(outs[0], np.full((1, 4), 2.0 * (i + 1)))
    s = eng.stats()
    assert s["batched_requests"] == 8
    assert s["avg_requests_per_batch"] >= 4


def test_deadline_expired_request_shed_before_admission():
    gate = threading.Event()
    runner = CountingRunner(gate=gate)
    eng = DynamicBatcher(runner, BatchPolicy(max_batch_size=4,
                                             max_queue_delay_ms=1.0))
    t1 = threading.Thread(target=lambda: eng.submit(_rows(0)))
    t1.start()
    time.sleep(0.05)  # the scheduler is now blocked inside the runner
    err = [None]

    def doomed():
        try:
            eng.submit(_rows(1), deadline=Deadline(0.0))
        except DeadlineExceeded as e:
            err[0] = e

    t2 = threading.Thread(target=doomed)
    t2.start()
    time.sleep(0.05)
    gate.set()
    t1.join(JOIN_S)
    t2.join(JOIN_S)
    eng.close()
    assert isinstance(err[0], AdmissionShed)
    assert all(s[0] == 1 for s in runner.shapes)
    assert eng.stats()["batch_sheds"] == 1


def test_poisoned_request_does_not_fail_batch_mates():
    gate = threading.Event()
    runner = CountingRunner(gate=gate)
    eng = DynamicBatcher(runner, BatchPolicy(max_batch_size=8,
                                             max_queue_delay_ms=50.0))
    results, errors = [None] * 4, [None] * 4

    def client(i, poison):
        feeds = ({"x": np.full((1, 4), CountingRunner.POISON, "float32")}
                 if poison else _rows(i))
        try:
            results[i] = eng.submit(feeds)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    ts = [threading.Thread(target=client, args=(i, i == 2)) for i in range(4)]
    for t in ts:
        t.start()
    time.sleep(0.02)
    gate.set()
    for t in ts:
        t.join(JOIN_S)
    eng.close()
    assert isinstance(errors[2], ValueError)
    for i in (0, 1, 3):
        assert errors[i] is None
        np.testing.assert_array_equal(results[i][0],
                                      np.full((1, 4), 2.0 * (i + 1)))
    assert eng.stats()["isolation_reruns"] == 1


def test_bucket_padding_round_trips_outputs():
    runner = CountingRunner()
    eng = DynamicBatcher(runner, BatchPolicy(max_batch_size=16,
                                             max_queue_delay_ms=60.0,
                                             buckets=(4, 8, 16)))
    barrier = threading.Barrier(2)
    results = [None, None]

    def client(i, rows):
        barrier.wait()
        results[i] = eng.submit(_rows(i, n_rows=rows))

    _run_threads([lambda: client(0, 3), lambda: client(1, 2)])
    eng.close()
    assert runner.shapes == [(8, 4)]
    np.testing.assert_array_equal(results[0][0], np.full((3, 4), 2.0))
    np.testing.assert_array_equal(results[1][0], np.full((2, 4), 4.0))
    s = eng.stats()
    assert s["pad_waste"] == pytest.approx(3 / 8)
    assert s["avg_batch_rows"] == 5


def test_mismatched_feed_shapes_isolate_and_scheduler_survives():
    runner = CountingRunner()
    eng = DynamicBatcher(runner, BatchPolicy(max_batch_size=8,
                                             max_queue_delay_ms=50.0))
    barrier = threading.Barrier(2)
    results = [None, None]

    def client(i, dim):
        barrier.wait()
        results[i] = eng.submit(
            {"x": np.full((1, dim), float(i + 1), "float32")})

    _run_threads([lambda: client(0, 4), lambda: client(1, 8)])
    np.testing.assert_array_equal(results[0][0], np.full((1, 4), 2.0))
    np.testing.assert_array_equal(results[1][0], np.full((1, 8), 4.0))
    outs = eng.submit(_rows(9))
    np.testing.assert_array_equal(outs[0], np.full((1, 4), 20.0))
    eng.close()


def test_oversize_request_runs_exact_shape():
    runner = CountingRunner()
    eng = DynamicBatcher(runner, BatchPolicy(max_batch_size=4,
                                             max_queue_delay_ms=1.0))
    outs = eng.submit(_rows(0, n_rows=9))
    eng.close()
    np.testing.assert_array_equal(outs[0], np.full((9, 4), 2.0))
    assert runner.shapes == [(9, 4)]


# ------------------------------------------------------ circuit breaker


def test_circuit_breaker_open_half_open_cycle():
    now = [0.0]
    br = CircuitBreaker(failure_threshold=2, reset_timeout_s=10.0,
                        clock=lambda: now[0])
    assert br.state == "closed"
    br.allow()
    br.record_failure()
    br.allow()
    before = profiler.counter("resilience.circuit_open")
    br.record_failure()
    assert br.state == "open"
    assert profiler.counter("resilience.circuit_open") - before == 1
    with pytest.raises(CircuitOpenError):
        br.allow()
    now[0] += 10.0
    assert br.state == "half_open"
    br.allow()
    br.record_failure()
    assert br.state == "open"
    now[0] += 10.0
    br.allow()
    br.record_success()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "closed"


def test_named_breaker_exports_state_gauge():
    from paddle_tpu_torch.obs import metrics as obs_metrics
    from paddle_tpu_torch.resilience.policy import BREAKER_STATE_VALUES

    g = obs_metrics.labeled_gauge("resilience.breaker_state")

    def val():
        return g.value(default=-1.0, name="unit.gaugebr")

    now = [0.0]
    br = CircuitBreaker(failure_threshold=2, reset_timeout_s=10.0,
                        clock=lambda: now[0], name="unit.gaugebr")
    assert val() == BREAKER_STATE_VALUES["closed"] == 0
    br.record_failure()
    br.record_failure()
    assert val() == BREAKER_STATE_VALUES["open"] == 2
    now[0] += 10.0
    assert br.state == "half_open"
    assert val() == BREAKER_STATE_VALUES["half_open"] == 1
    br.record_success()
    assert br.state == "closed" and val() == 0


# -------------------------------------------------------------- Session


def _drive_clients(sess, n_clients, rows_of, repeat=3):
    outputs = [[] for _ in range(n_clients)]
    errors = []

    def client(i):
        c = sess.clone()
        xs = np.random.RandomState(i).randn(rows_of(i), 8).astype("float32")
        for _ in range(repeat):
            c.feed("x", xs.tobytes(), "float32", list(xs.shape))
            try:
                c.run()
                buf, dt, shape = c.output(0)
                outputs[i].append(np.frombuffer(buf, dt).reshape(shape))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    _run_threads([lambda i=i: client(i) for i in range(n_clients)])
    assert not errors, errors
    return outputs


def test_batched_session_matches_jax_with_no_capture_after_warm(
        artifacts, sessions):
    """The port's batching Session against the JAX package's unbatched
    Session on the same feeds (rtol 1e-5, atol 1e-6): every request shape
    lands on a warmed bucket, so no capture after warm."""
    sess = capi_server.Session(artifacts["port"])
    sessions.append(sess)
    assert sess._infer.symbolic_batch
    sess.enable_batching(max_batch_size=8, max_queue_delay_ms=2.0)
    warm_traces = sess._infer.trace_count()
    assert warm_traces == len(sess._state.batcher.buckets)
    rows_of = lambda i: 1 + (i % 3)  # noqa: E731
    outputs = _drive_clients(sess, 6, rows_of)
    assert sess._infer.trace_count() == warm_traces
    jsess = jcapi.Session(artifacts["jax"])
    for i in range(6):
        xs = np.random.RandomState(i).randn(rows_of(i), 8).astype("float32")
        jsess.feed("x", xs.tobytes(), "float32", list(xs.shape))
        jsess.run()
        buf, dt, shape = jsess.output(0)
        ref = np.frombuffer(buf, dt).reshape(shape)
        for got in outputs[i]:
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # the ledger knows every warmed bucket, keyed as the batcher times it
    from paddle_tpu_torch.obs import prof

    keys = {e.get("sig_key") for e in prof.ledger().snapshot().values()}
    for b in sess._state.batcher.buckets:
        assert f"{sess._infer.sig_prefix}:{b}" in keys


def test_healthz_reports_batching_stats(artifacts, sessions):
    sess = capi_server.Session(artifacts["port"])
    sessions.append(sess)
    assert sess.healthz()["batching"] is None
    sess.enable_batching(max_batch_size=8, max_queue_delay_ms=2.0)
    _drive_clients(sess, 4, lambda i: 1, repeat=2)
    hz = sess.healthz()
    b = hz["batching"]
    for key in ("queue_depth", "batches", "avg_batch_rows", "pad_waste",
                "batch_sheds", "occupancy", "jit_traces"):
        assert key in b
    assert b["batches"] >= 1 and b["batched_requests"] == 8
    assert 0.0 <= b["pad_waste"] < 1.0
    assert b["jit_traces"] == sess._infer.trace_count()
    assert hz["ok"] and hz["requests"] == 8 and hz["errors"] == 0
    assert sess.clone()._state.batcher is sess._state.batcher
    assert hz["compile"]["warmup"]["states"] == {
        "done": len(sess._state.batcher.buckets)}
    assert hz["compile"]["guard"]["steady_retraces"] == 0


def test_healthz_keys_equal_jax(artifacts, sessions):
    """The same configuration (batching on, one decode scheduler attached)
    in both packages: the healthz key sets are equal, and so are those of
    its batching, compile and decode blocks."""
    from paddle_tpu.models import transformer as jtf
    from paddle_tpu.serving import ContinuousDecodeEngine as JEngine
    from paddle_tpu.serving import ContinuousScheduler as JScheduler
    from paddle_tpu_torch.serving import (ContinuousDecodeEngine,
                                          ContinuousScheduler)

    cfg = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2,
               n_layers=2, d_ff=64)
    params = jtf.init_lm_params(7, **cfg)
    eng = dict(n_slots=2, block_size=8, prompt_buckets=(8, 16),
               prefix_cache=True)
    jsess = jcapi.Session(artifacts["jax"])
    jsess.enable_batching(max_batch_size=4, max_queue_delay_ms=1.0)
    jsess.attach_decode(JScheduler(JEngine(params, **eng, **cfg)))
    sess = capi_server.Session(artifacts["port"])
    sessions.append(sess)
    sess.enable_batching(max_batch_size=4, max_queue_delay_ms=1.0)
    sess.attach_decode(ContinuousScheduler(ContinuousDecodeEngine(
        params, device="cpu", **eng, **cfg)))
    try:
        jhz, hz = jsess.healthz(), sess.healthz()
    finally:
        jsess._state.batcher.close()
    assert set(hz) == set(jhz)
    for block in ("batching", "compile"):
        assert set(hz[block]) == set(jhz[block]), block
    assert set(hz["compile"]["warmup"]) == set(jhz["compile"]["warmup"])
    assert set(hz["hotspots"]) == set(jhz["hotspots"])
    assert set(hz["kv"]) == set(jhz["kv"])
    assert set(hz["prefix_cache"]) == set(jhz["prefix_cache"])


def test_attach_decode_folds_scheduler_stats(artifacts, sessions):
    from paddle_tpu.models import transformer as jtf
    from paddle_tpu_torch.serving import (ContinuousDecodeEngine,
                                          ContinuousScheduler)

    cfg = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2,
               n_layers=2, d_ff=64)
    sched = ContinuousScheduler(ContinuousDecodeEngine(
        jtf.init_lm_params(7, **cfg), n_slots=2, block_size=8,
        prompt_buckets=(8, 16), device="cpu", **cfg))
    sess = capi_server.Session(artifacts["port"]).attach_decode(sched)
    assert sess.clone()._state.decode is sched
    reqs = [sched.submit(np.arange(3, 3 + n, dtype=np.int32), 4)
            for n in (5, 9, 7)]
    hz = sess.healthz()
    assert hz["decode"]["waiting"] == 3
    assert hz["queue_depth"] == 3 and hz["ok"]
    sched.run_until_idle()
    for r in reqs:
        assert r.result(1).size == 4
    hz = sess.healthz()
    assert hz["decode"]["retired"] == 3 and hz["queue_depth"] == 0
    assert hz["kv"]["kv_dtype"] == "float32"
    sched.close()
    assert not sess.healthz()["ok"]   # a closed scheduler is not routable


def test_batched_deadline_shed_does_not_open_breaker(artifacts, sessions):
    sess = capi_server.Session(artifacts["port"])
    sessions.append(sess)
    sess.enable_batching(max_batch_size=4, max_queue_delay_ms=1.0)
    sess._state.breaker = CircuitBreaker(failure_threshold=2,
                                         reset_timeout_s=5.0)
    xs = np.random.RandomState(5).randn(2, 8).astype("float32")
    for _ in range(4):
        sess.feed("x", xs.tobytes(), "float32", [2, 8])
        with pytest.raises(DeadlineExceeded):
            sess.run(deadline_s=0.0)
    assert sess.healthz()["circuit"] == "closed"
    sess.feed("x", xs.tobytes(), "float32", [2, 8])
    assert sess.run() == 1
    hz = sess.healthz()
    assert hz["errors"] == 4 and hz["requests"] == 5


@pytest.mark.parametrize("batched", [False, True])
def test_session_circuit_breaker_opens_and_recovers(artifacts, sessions,
                                                   batched):
    now = [0.0]
    sess = capi_server.Session(artifacts["port"])
    sessions.append(sess)
    if batched:
        sess.enable_batching(max_batch_size=4, max_queue_delay_ms=1.0)
    sess._state.breaker = CircuitBreaker(failure_threshold=2,
                                         reset_timeout_s=5.0,
                                         clock=lambda: now[0])
    xs = np.random.RandomState(5).randn(2, 8).astype("float32")
    sess.feed("x", xs.tobytes(), "float32", [2, 8])
    faults.inject("serving.run", RuntimeError("model runtime down"))
    for _ in range(2):
        with pytest.raises(RuntimeError):
            sess.run()
    hz = sess.healthz()
    assert hz["circuit"] == "open" and not hz["ok"]
    with pytest.raises(CircuitOpenError):
        sess.run()
    faults.clear("serving.run")
    now[0] += 5.0
    assert sess.run() == 1
    hz = sess.healthz()
    assert hz["circuit"] == "closed" and hz["ok"]


@pytest.mark.parametrize("batched", [False, True])
def test_session_transient_blip_recovers(artifacts, sessions, batched):
    """One transient backend error: the Session's retry (or, batched, the
    isolation rerun) absorbs it, and the client sees success."""
    sess = capi_server.Session(artifacts["port"])
    sessions.append(sess)
    if batched:
        sess.enable_batching(max_batch_size=4, max_queue_delay_ms=1.0)
    xs = np.random.RandomState(5).randn(2, 8).astype("float32")
    sess.feed("x", xs.tobytes(), "float32", [2, 8])
    faults.inject("serving.run", TransientError("backend blip"), count=1)
    before = profiler.counter("resilience.retries")
    assert sess.run() == 1
    assert sess.healthz()["errors"] == 0
    if not batched:
        assert profiler.counter("resilience.retries") - before == 1


def test_session_deadlines_and_timing(artifacts):
    sess = capi_server.Session(artifacts["port"])
    xs = np.random.RandomState(5).randn(2, 8).astype("float32")
    sess.feed("x", xs.tobytes(), "float32", [2, 8])
    assert sess.run() == 1
    with pytest.raises(DeadlineExceeded):
        sess.run(deadline_s=0.0)
    assert sess.run(deadline_s=60.0) == 1
    hz = sess.healthz()
    assert hz["model_loaded"] and hz["requests"] == 3 and hz["errors"] == 1
    assert hz["last_latency_ms"] > 0 and 0 < hz["error_rate"] < 1
    t = sess.last_timing
    assert t["retries"] == 0 and t["worker_ms"] >= t["exec_ms"] > 0
    buf, dt, shape = sess.output(0)
    assert dt == "float32" and shape == [2, 4]


def test_flash_op_hands_its_kernel_contiguous_operands(monkeypatch):
    """An exported LM at batch 1 hands the flash custom op strided views
    (the heads' reshape of a transposed tensor): its CUDA implementation
    makes them contiguous before the kernel's operand check."""
    from paddle_tpu_torch.ops import attention

    seen = []
    monkeypatch.setattr(attention, "flash_fwd_kernel",
                        lambda q, k, v, s, c: seen.append(
                            all(t.is_contiguous() for t in (q, k, v))))
    x = torch.randn(1, 16, 2, 8).transpose(1, 2).reshape(2, 16, 8)
    assert not x.is_contiguous()
    attention._flash_fwd_cuda(x, x, x, 0.5, True)
    assert seen == [True]


def test_hooks_left_for_a10_name_it(artifacts, monkeypatch):
    sess = capi_server.Session(artifacts["port"])
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        sess.enable_mesh("data=1")
    assert sess._state.batcher is None
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        sess._infer.shard(None)


def test_session_runs_on_the_card_unless_asked(artifacts, monkeypatch):
    """Without PADDLE_TPU_CAPI_PLATFORM=cpu the Session takes the card,
    which this host lacks: it raises instead of falling back."""
    monkeypatch.delenv("PADDLE_TPU_CAPI_PLATFORM")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        capi_server.Session(artifacts["port"])

"""paddle_tpu_torch's observability against the JAX package's on the CPU:

* registry parity: one scripted sequence of registry operations in both
  packages gives a byte-identical ``prometheus()`` and an equal
  ``snapshot()``; one scripted span sequence gives equal Chrome traces once
  ``ts``, ``dur``, ``pid`` and ``tid`` are removed;
* the reference's own cases (``tests/test_obs.py``): the ring overflow,
  the recorder's postmortem and a ``dump`` that never raises, the HTTP
  exposer (200 and 503), and an induced hang through the port's Trainer
  and ``Watchdog`` writing a postmortem and counting ``obs.postmortems``;
* the name lint: every literal name the port passes to ``incr`` /
  ``gauge`` / ``counter`` / ``histogram`` / ``span`` is in the port's table
  (equal to the reference's), and every name of the table is emitted by
  the port or listed in ``WAITING`` with the ROADMAP item that will;
* the decode counters: one scripted request stream (prefix cache, a
  parallel-n fork, a preemption, a deadline shed, a W = 2 speculative
  window) through the JAX scheduler and the port's on the same weights:
  equal token streams, then every ``serving.*`` counter and gauge equal,
  but the capture counters, which equal the port's own ``trace_count()``;
* the Trainer counters: uci_housing with one NaN batch and a rollback in
  both packages: ``train.*``, ``ckpt.*`` and ``resilience.*`` counters,
  the histograms' counts and the ``train.*`` / ``ckpt.*`` spans equal;
* ``profiler``: timers, ``BarrierStat`` (``tests/test_observability.py``)
  and ``profiler()`` on the CPU writing the reference-named trace under
  ``PADDLE_TPU_TRACE_DIR``, merged with the host spans."""
import json
import os
import re
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import obs as jobs
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import obs, profiler

REPO = Path(__file__).resolve().parents[1]
CPU = tfluid.CPUPlace()

# Names of the table the port does not emit yet, with the ROADMAP item
# that ports their emitter (and one the port never emits).
WAITING = {
    **{n: "A.10 (fleet/)" for n in jobs.names.METRICS if n.startswith("fleet.")},
    **{n: "A.10 (fleet/)" for n in jobs.names.SPANS if n.startswith("fleet.")},
    # the port has no fallback: a card that cannot run the paged kernel
    # raises (serving.decode.kernel_impl reads 1 on the card, 0 on the CPU)
    "serving.pallas.fallbacks": "never",
}


@pytest.fixture(autouse=True)
def fresh_obs():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for o in (obs, jobs):
        o.metrics.reset()
        o.trace.disable()
        o.recorder.get().clear()
        o.prof.reset()
    yield
    for o in (obs, jobs):
        o.metrics.reset()
        o.trace.disable()
        o.recorder.get().clear()
        o.prof.reset()
    torch.set_num_threads(torch_threads)


# --------------------------------------------------------- registry parity


def _registry_script(o):
    m = o.metrics
    m.counter("train.steps").inc(3)
    m.counter("train.steps").inc()
    m.counter("serving.batches").inc(7)
    m.gauge("serving.queue_depth").set(5)
    m.gauge("serving.batch_occupancy").set(0.625)
    m.gauge("serving.decode.waiting").set(0)
    h = m.histogram("train.step_ms")
    for v in (0.05, 0.3, 1.0, 7.5, 42.0, 1234.5, 1e9):
        h.observe(v)
    m.histogram("serving.queue_wait_ms", buckets=(1.0, 2.0)).observe(1.5)
    lg = m.labeled_gauge("resilience.breaker_state")
    lg.set(2, name="serving")
    lg.set(0, name='we"ird\\name')
    m.labeled_gauge("serving.mesh.axis_size").set(4, axis="tp")


def test_registry_output_is_identical_to_jax():
    _registry_script(obs)
    _registry_script(jobs)
    assert obs.metrics.prometheus() == jobs.metrics.prometheus()
    # equal but the wall-clock stamp each snapshot carries
    ours, theirs = obs.metrics.snapshot(), jobs.metrics.snapshot()
    assert isinstance(ours.pop("time"), float) and theirs.pop("time")
    assert ours == theirs
    ours = json.loads(obs.metrics.snapshot_json())
    theirs = json.loads(jobs.metrics.snapshot_json())
    ours.pop("time"), theirs.pop("time")
    assert ours == theirs


def _span_script(o):
    o.trace.enable(capacity=64)
    o.trace.set_process_label("parity")
    with o.span("train.step", step=1):
        with o.span("train.fetch"):
            pass
    with o.trace.child_span("fleet.request", trace_id="t1",
                            parent="p1") as sp:
        assert sp.span_id
    t = time.perf_counter()
    o.trace.record_at("serving.queue_wait", t, 0.001, trace_id="t1",
                      bucket=4)
    o.trace.record_at("obs.prof.sample", t, 0.002, site="k")


def _strip(ct):
    out = []
    for e in ct["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                     "tid")}
        args = dict(e.get("args") or {})
        args.pop("span_id", None)   # random per span
        e["args"] = args
        out.append(e)
    return out


def test_chrome_trace_equals_jax_but_times_and_ids():
    _span_script(obs)
    _span_script(jobs)
    ours, theirs = obs.trace.chrome_trace(), jobs.trace.chrome_trace()
    assert _strip(ours) == _strip(theirs)
    assert sorted(e["name"] for e in obs.trace.events()) == [
        "fleet.request", "obs.prof.sample", "serving.queue_wait",
        "train.fetch", "train.step"]


# ------------------------------------------------------ reference's cases


def test_trace_ring_overflow_drops_oldest_without_error():
    obs.trace.enable(capacity=8)
    for i in range(20):
        with obs.span(f"s{i}"):
            pass
    evs = obs.trace.events()
    assert [e["name"] for e in evs] == [f"s{i}" for i in range(12, 20)]
    assert obs.trace.dropped() == 12


def test_flight_recorder_ring_and_postmortem(tmp_path):
    rec = obs.recorder.FlightRecorder(capacity=16)
    for i in range(40):
        rec.record_step(i, pass_id=0, batch_id=i, cost=float(i))
    rec.record_event("anomaly", cost=float("nan"), consecutive=1)
    rows = rec.records()
    assert len(rows) == 16 and rows[-1]["kind"] == "anomaly"
    assert rows[0]["step"] == 25
    obs.metrics.counter("train.steps").inc(40)
    pm = rec.postmortem("unit_test", extra={"why": "testing"})
    assert pm["schema"] == "paddle_tpu.postmortem.v1"
    assert pm["reason"] == "unit_test" and pm["extra"] == {"why": "testing"}
    assert pm["metrics"]["counters"]["train.steps"] == 40
    assert "thread" in pm["threads"].lower()
    # the keys of the reference's postmortem, and no others
    jpm = jobs.recorder.FlightRecorder().postmortem("unit_test")
    assert set(pm) == set(jpm)
    path = rec.dump("unit_test", path=str(tmp_path / "pm.json"))
    assert path and json.load(open(path))["reason"] == "unit_test"
    assert obs.metrics.counter_value("obs.postmortems") == 1


def test_postmortem_dump_never_raises(tmp_path):
    rec = obs.recorder.FlightRecorder()
    assert rec.dump("x", path=str(tmp_path / "no" / "such" / "f.json")) \
        is None


def test_http_exposer_serves_metrics_and_healthz():
    obs.metrics.counter("train.steps").inc(3)
    srv = obs.http.start_exposer(port=0)
    try:
        body = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=30).read().decode()
        assert "# TYPE train_steps counter" in body and "train_steps 3" in body
        hz = json.loads(urllib.request.urlopen(srv.url + "/healthz",
                                               timeout=30).read())
        assert hz == {"ok": True}
    finally:
        srv.stop()


def test_http_exposer_unhealthy_is_503():
    srv = obs.http.start_exposer(
        port=0, healthz=lambda: {"ok": False, "circuit": "open"})
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/healthz", timeout=30)
        assert e.value.code == 503
        assert json.loads(e.value.read())["circuit"] == "open"
    finally:
        srv.stop()


_TINY_MODEL = """
x = fluid.layers.data('x', [4])
y = fluid.layers.data('y', [1], dtype='int32')
h = fluid.layers.fc(x, 8, act='relu')
pred = fluid.layers.fc(h, 2, act='softmax')
loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
"""


def test_induced_hang_writes_postmortem(tmp_path):
    """tests/test_obs.py::test_induced_hang_writes_postmortem through the
    port: dropped heartbeats (the cluster.heartbeat fault) make the
    Trainer's watchdog force-exit EXIT_HUNG, leaving a postmortem with the
    last step records, every thread's stack, the metrics snapshot,
    ``resilience.hang_kills`` and ``obs.postmortems``."""
    from paddle_tpu_torch.resilience.cluster import EXIT_HUNG

    script = tmp_path / "hang.py"
    script.write_text(
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import paddle_tpu_torch as fluid\n"
        "from paddle_tpu_torch.resilience import faults\n"
        + _TINY_MODEL
        + "faults.inject('cluster.heartbeat', RuntimeError('dropped'))\n"
        "rng = np.random.RandomState(0)\n"
        "samples = [(rng.rand(4).astype('float32'),"
        " np.array([i % 2], 'int32')) for i in range(8)]\n"
        "def reader():\n"
        "    for _ in range(10**6):\n"
        "        yield samples\n"
        "t = fluid.Trainer(loss, fluid.optimizer.SGD(0.1), [x, y],\n"
        "                  hang_timeout_s=2.0, place=fluid.CPUPlace())\n"
        "t.train(reader, num_passes=1)\n")
    pm_dir = tmp_path / "pm"
    env = dict(os.environ, PADDLE_TPU_POSTMORTEM_DIR=str(pm_dir),
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == EXIT_HUNG, p.stdout + p.stderr
    files = [f for f in os.listdir(pm_dir) if f.startswith("postmortem-hang")]
    assert files, f"no hang postmortem in {pm_dir}: {p.stderr}"
    pm = json.load(open(pm_dir / files[0]))
    assert pm["reason"] == "hang"
    assert pm["extra"]["watchdog"] == "train.step"
    assert pm["extra"]["stalled_s"] > 2.0
    steps = [r for r in pm["records"] if r["kind"] == "step"]
    assert len(steps) >= 8, f"only {len(steps)} step records"
    assert "Thread" in pm["threads"]
    assert pm["metrics"]["counters"]["train.steps"] >= 8
    assert pm["metrics"]["counters"]["resilience.hang_kills"] == 1


def test_watchdog_hang_dumps_and_counts_postmortem(tmp_path, monkeypatch):
    """The watchdog's own hang hook in this process (its force-exit
    caught): the postmortem lands and ``obs.postmortems`` counts it."""
    from paddle_tpu_torch.resilience import cluster, faults

    monkeypatch.setenv("PADDLE_TPU_POSTMORTEM_DIR", str(tmp_path))
    exits = []
    monkeypatch.setattr(cluster.os, "_exit", exits.append)
    faults.inject("cluster.heartbeat", RuntimeError("dropped"))
    try:
        wd = cluster.Watchdog(0.2, name="unit", poll_s=0.05).start()
        deadline = time.monotonic() + 30
        while not exits and time.monotonic() < deadline:
            wd.beat()
            time.sleep(0.02)
        wd.stop()
    finally:
        faults.clear("cluster.heartbeat")
    assert exits == [cluster.EXIT_HUNG] and wd.fired
    files = [f for f in os.listdir(tmp_path) if f.startswith(
        "postmortem-hang")]
    assert len(files) == 1
    assert json.load(open(tmp_path / files[0]))["extra"]["watchdog"] == "unit"
    assert obs.metrics.counter_value("obs.postmortems") == 1
    assert obs.metrics.counter_value("resilience.hang_kills") == 1


def test_new_modules_load_no_jax():
    src = ("import sys\n"
           "import paddle_tpu_torch.capi_server, paddle_tpu_torch.profiler\n"
           "import paddle_tpu_torch.obs, paddle_tpu_torch.compile\n"
           "import paddle_tpu_torch.ops._cost\n"
           "print(sorted(m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'jaxlib', 'paddle_tpu')))\n")
    p = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, timeout=120, cwd=str(REPO),
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


# ---------------------------------------------------------------- name lint

_CALL = re.compile(
    r"""(?:incr|gauge|counter|histogram|labeled_gauge|span|child_span"""
    r"""|record_at)\(\s*f?["']([A-Za-z0-9_.{}:]+)["']""")


def _emitted():
    found = {}
    for f in sorted((REPO / "paddle_tpu_torch").rglob("*.py")):
        for m in _CALL.finditer(f.read_text()):
            found.setdefault(m.group(1), f.name)
    return found


def test_port_name_table_equals_the_reference():
    assert obs.names.METRICS == jobs.names.METRICS
    assert obs.names.SPANS == jobs.names.SPANS


def test_name_lint():
    """Every literal metric or span name in the port is in the table, and
    every table name is emitted or waits for its ROADMAP item."""
    table = set(obs.names.METRICS) | set(obs.names.SPANS)
    found = _emitted()
    unknown = {n: f for n, f in found.items() if n not in table}
    assert unknown == {}
    missing = sorted(n for n in table if n not in found and n not in WAITING)
    assert missing == []
    stale = sorted(n for n in WAITING if n in found or n not in table)
    assert stale == []


# ---------------------------------------------------- decode counters vs JAX

LM = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2, n_layers=2,
          d_ff=64)
ENG = dict(n_slots=4, block_size=8, prompt_buckets=(8, 16), spec_window=2,
           prefix_cache=True)
N_BLOCKS = 16


def _stream(pkg, eng_cls, sched_cls, deadline_cls, sampling, params):
    """The scripted request stream: a prompt and a second one sharing its
    first two blocks (a prefix hit), a parallel-n root of 2 branches,
    repetitive prompts for the W = 2 drafts, one request whose deadline
    has passed (shed); after 3 steps a joiner, then the pool's free list
    taken away until growth preempts a slot (the prefix cache's
    unreferenced blocks are evicted first), then another joiner."""
    eng = eng_cls(params, n_blocks=N_BLOCKS, **ENG, **LM,
                  **({"device": "cpu"} if pkg == "port" else {}))
    eng.warm()
    sched = sched_cls(eng, spec=True)
    rng = np.random.RandomState(3)
    base = rng.randint(2, LM["vocab_size"], 20).astype(np.int32)
    clock = [0.0]
    hs = [sched.submit(base, 24),
          sched.submit(np.tile(base[:4], 3), 20),
          sched.submit(rng.randint(2, 61, 9).astype(np.int32), 12,
                       sampling=sampling),
          sched.submit(rng.randint(2, 61, 5).astype(np.int32), 8,
                       deadline=deadline_cls(1.0, clock=lambda: clock[0]))]
    clock[0] = 2.0
    for _ in range(3):
        sched.step()
    hs.append(sched.submit(np.concatenate([base[:16], base[:5]]), 16))
    # pool pressure: the free list taken away until growth preempts a slot
    stolen, eng.pool._free = eng.pool._free, []
    for _ in range(6 * ENG["block_size"]):
        if sched.counters["preemptions"]:
            break
        sched.step()
    eng.pool._free = stolen + eng.pool._free
    hs.append(sched.submit(np.tile(base[5:9], 4), 14))
    sched.run_until_idle()
    out = []
    for h in hs:
        try:
            toks = h.result(1)
        except Exception as e:  # noqa: BLE001 — the shed request
            toks = type(e).__name__
        out.append(toks)
        for b in getattr(h, "branches", None) or []:
            if b is not h:
                out.append(b.result(1))
    return eng, sched, out


def _serving(o):
    snap = o.metrics.snapshot()
    return ({k: v for k, v in snap["counters"].items()
             if k.startswith("serving.")},
            {k: v for k, v in snap["gauges"].items()
             if k.startswith("serving.")})


def test_decode_counters_equal_jax():
    from paddle_tpu.models import transformer as jtf
    from paddle_tpu.resilience import Deadline as JDeadline
    from paddle_tpu.serving import ContinuousDecodeEngine as JEngine
    from paddle_tpu.serving import ContinuousScheduler as JScheduler
    from paddle_tpu.serving.sampling import SamplingParams as JSampling
    from paddle_tpu_torch.resilience import Deadline
    from paddle_tpu_torch.serving import (ContinuousDecodeEngine,
                                          ContinuousScheduler)

    params = jtf.init_lm_params(7, **LM)
    rec = JSampling(n=2, temperature=0.8, top_p=0.9, seed=5).to_record()
    jeng, jsched, jout = _stream("jax", JEngine, JScheduler, JDeadline, rec,
                                 params)
    teng, tsched, tout = _stream("port", ContinuousDecodeEngine,
                                 ContinuousScheduler, Deadline, rec, params)
    assert len(tout) == len(jout) == 7
    for a, b in zip(tout, jout):
        if isinstance(b, str):
            assert a == b == "AdmissionShed"
        else:
            np.testing.assert_array_equal(a, b)
    tc, tg = _serving(obs)
    jc, jg = _serving(jobs)
    # the capture counters count the port's prepared signatures
    assert tc.pop("serving.decode_traces") == teng.trace_count()
    jc.pop("serving.decode_traces")
    # 1 where the CUDA kernel runs, 0 on the CPU's plain version
    assert tg.pop("serving.decode.kernel_impl") == 0
    jg.pop("serving.decode.kernel_impl", None)
    assert tc == jc
    assert tg == jg
    for k in ("serving.decode.preemptions", "serving.decode.sheds",
              "serving.prefix.hits", "serving.fork.forks",
              "serving.decode.spec_proposed", "serving.sample.requests"):
        assert tc[k] > 0, k
    assert tc["serving.decode.preemptions"] == 1
    assert tc["serving.decode.retired"] == tsched.counters["retired"]


# ---------------------------------------------------- trainer counters vs JAX


def _uci(fl):
    x = fl.layers.data("x", [13])
    y = fl.layers.data("y", [1])
    pred = fl.layers.fc(x, 1)
    loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
    return loss, fl.optimizer.SGD(0.01), [x, y]


def test_trainer_counters_equal_jax(tmp_path, monkeypatch):
    """The uci_housing Trainer in both packages from the same step-0
    checkpoint, 2 passes of 4 batches, checkpoints every 2 steps; the
    third batch of the first attempt is NaN past a budget of 0, so the
    pass rolls back once and replays clean."""
    from paddle_tpu_torch.datasets import uci_housing

    samples = list(uci_housing.train(64)())
    attempts = {}

    def reader_for(key):
        def batches():
            attempts[key] = attempts.get(key, 0) + 1
            for i in range(4):
                rows = samples[16 * i:16 * (i + 1)]
                if attempts[key] == 1 and i == 2:
                    rows = [(np.full_like(rows[0][0], np.nan), rows[0][1])] \
                        + rows[1:]
                yield rows
        return batches

    dirs = {jfluid: str(tmp_path / "jax"), tfluid: str(tmp_path / "port")}
    for o in (obs, jobs):
        o.trace.enable(capacity=4096)
    for fl in (jfluid, tfluid):
        # a directory each: the two packages' dumps can share a file name
        monkeypatch.setenv("PADDLE_TPU_POSTMORTEM_DIR",
                           dirs[fl] + ".postmortem")
        fl.reset_default_programs()
        fl.reset_global_scope()
        loss, opt, feeds = _uci(fl)
        extra = {"place": CPU} if fl is tfluid else {}
        tr = fl.Trainer(loss, opt, feeds, checkpoint_dir=dirs[fl],
                        checkpoint_every_n_steps=2, anomaly_budget=0,
                        max_rollbacks=2, **extra)
        if fl is jfluid:
            jexe = jfluid.Executor()
            jexe.run(jfluid.default_startup_program())
            jfluid.io.CheckpointManager(dirs[jfluid]).save(
                0, extra={"pass_id": 0})
            shutil.copytree(dirs[jfluid], dirs[tfluid])
            jobs.metrics.reset()   # the seeding save is not the Trainer's
            jobs.trace.clear()
        tr.train(reader_for(fl), num_passes=2)
    assert attempts == {jfluid: 3, tfluid: 3}

    def picked(o):
        snap = o.metrics.snapshot()
        pre = ("train.", "ckpt.", "resilience.")
        counters = {k: v for k, v in snap["counters"].items()
                    if k.startswith(pre)}
        hists = {k: v["count"] for k, v in snap["histograms"].items()
                 if k.startswith(pre)}
        spans = {}
        for e in o.trace.events():
            if e["name"].startswith(("train.", "ckpt.")):
                spans[e["name"]] = spans.get(e["name"], 0) + 1
        return counters, hists, spans

    ours, theirs = picked(obs), picked(jobs)
    assert ours == theirs
    counters, hists, spans = ours
    assert counters["resilience.rollbacks"] == 1
    assert counters["resilience.anomalies_skipped"] == 1
    assert counters["train.epochs"] == 2
    assert hists["train.step_ms"] == counters["train.steps"]
    assert spans["ckpt.save"] == counters["ckpt.saves"]
    for d in dirs.values():   # the rollback's postmortem
        assert [f.split("-")[1] for f in os.listdir(d + ".postmortem")] \
            == ["anomaly_rollback"]


# ----------------------------------------------------------------- profiler


def test_timers_and_barrier_stat():
    """tests/test_observability.py:8-23 on the port."""
    profiler.reset_stats()
    for _ in range(3):
        with profiler.timer("fwd"):
            time.sleep(0.001)
    rep = profiler.stats_report()
    assert "fwd" in rep and "3" in rep
    b = profiler.BarrierStat("sync")
    for _ in range(4):
        assert b.wait() == 0.0    # one process: nothing to wait for
    assert "samples=4" in b.report()
    assert profiler._global_stats["sync.wait"].count == 4
    profiler.incr("train.epochs", 2)
    profiler.gauge("serving.queue_depth", 3.0)
    assert profiler.counter("train.epochs") == 2
    assert profiler.counters("train.") == {"train.epochs": 2}
    assert profiler.gauges("serving.") == {"serving.queue_depth": 3.0}
    assert profiler.step_timer_loop(lambda: torch.ones(2), 3) >= 0


def test_profiler_writes_reference_named_trace_and_merges(tmp_path,
                                                          monkeypatch):
    """``profiler()`` on the CPU under PADDLE_TPU_TRACE_DIR: the chrome
    trace lands as ``trace-xprof-<label>-<pid>.json`` holding the profiled
    ops, and ``merge_chrome_traces`` stitches it with the host spans'
    ``trace-<label>-<pid>.json``."""
    monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path))
    obs.trace.enable()
    a = torch.randn(16, 16)
    with profiler.profiler(label="unit") as info:
        with obs.span("train.step", step=0):
            (a @ a).sum()
    want = tmp_path / f"trace-xprof-unit-{os.getpid()}.json"
    assert info["fleet_trace"] == str(want) and want.exists()
    ct = json.loads(want.read_text())
    assert any("mm" in str(e.get("name", "")) for e in ct["traceEvents"])
    host = obs.trace.export_to_dir(label="unit")
    merged = obs.trace.merge_chrome_traces([str(want), host])
    assert set(merged["mergedFrom"]) == {want.name, os.path.basename(host)}
    names = {e.get("name") for e in merged["traceEvents"]}
    assert "train.step" in names and any("mm" in str(n) for n in names)


def test_profiler_failure_leaves_the_run_alone(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: (_ for _ in ()).throw(RuntimeError("x")))
    with profiler.profiler(output_dir=str(tmp_path)) as info:
        y = torch.ones(3) * 2
    assert info["chrome_trace"] is None and float(y.sum()) == 6.0

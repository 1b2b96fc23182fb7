"""paddle_tpu_torch's device-time attribution (``obs/prof.py``) on the CPU:
the cost ledger (persist, reload, quarantine), sampled dispatch timing and
the hotspot join, a sample riding the trace ring, the postmortem provider
and ``merge_hotspots``, as ``tests/test_prof.py`` holds the reference's;
then the port's count of a prepared signature (``ops/_cost.py``): one
ledger entry per signature the decode engine prepares, flops and bytes
above 0; a matmul-only fc program counted at exactly 2 B K N flops; the
``flash_fwd`` custom op counted at the kernel's formula; the Executor's
warmed step registered and ticked; and sampling at N = 1 through scheduler
churn adding no capture."""
import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import obs
from paddle_tpu_torch.obs import prof
from paddle_tpu_torch.ops import _cost

CPU = tfluid.CPUPlace()
LM = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2, n_layers=2,
          d_ff=64)


@pytest.fixture(autouse=True)
def fresh_prof_state():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prof.reset()
    obs.metrics.reset()
    yield
    prof.reset()
    obs.metrics.reset()
    torch.set_num_threads(n)


def _params():
    from paddle_tpu_torch.models import init_lm_params

    return init_lm_params(7, **LM)


# ------------------------------------------------------------------- ledger


def test_ledger_persist_reload_roundtrip(tmp_path):
    led = prof.CostLedger().attach(str(tmp_path))
    led.register("fp1", label="train_step", sig_key="train_step:ab",
                 source="live", compile_ms=123.4,
                 cost={"flops": 2e6, "bytes_accessed": 1e6})
    assert os.path.exists(tmp_path / "prof_ledger.json")
    led2 = prof.CostLedger().attach(str(tmp_path))
    ent = led2.costs("fp1")
    assert ent["flops"] == 2e6 and ent["intensity"] == 2.0
    assert ent["source"] == "live" and ent["compile_ms"] == 123.4
    # merge rule: a costless re-registration keeps the flops
    led2.register("fp1", label="train_step", sig_key="train_step:ab",
                  source="live", compile_ms=2.5)
    ent = led2.costs("fp1")
    assert ent["compile_ms"] == 2.5 and ent["flops"] == 2e6


def test_ledger_garbage_sidecar_quarantined(tmp_path):
    path = tmp_path / "prof_ledger.json"
    path.write_text("{ this is not json")
    led = prof.CostLedger().attach(str(tmp_path))
    assert len(led) == 0 and not path.exists()
    assert [f for f in os.listdir(tmp_path) if ".corrupt" in f]
    assert obs.metrics.counter_value("obs.prof.ledger_corrupt") == 1
    path.write_text(json.dumps({"schema": "somebody.else.v9",
                                "entries": []}))
    led2 = prof.CostLedger().attach(str(tmp_path))
    assert len(led2) == 0
    led2.register("fp9", label="x", source="live")
    assert prof.CostLedger().attach(str(tmp_path)).costs("fp9") is not None


# ----------------------------------------------------------------- sampling


def test_sampling_disabled_cost_bounded():
    prof.set_sample_every(0)
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        prof.tick("decode_step:w1")
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 50e-6, f"disabled tick cost {per_call * 1e6:.2f}us"
    assert prof.stats_snapshot() == {}


def test_sampling_period_and_hotspot_join():
    prof.set_sample_every(4)
    stamps = [prof.tick("k") for _ in range(12)]
    sampled = [i for i, s in enumerate(stamps) if s is not None]
    assert sampled == [3, 7, 11]
    for i in sampled:
        prof.tock("k", stamps[i] - 0.001)
    snap = prof.stats_snapshot()["k"]
    assert snap["samples"] == 3 and snap["calls"] == 12
    assert 0.5 < snap["mean_ms"] < 50
    prof.register("fpA", label="step", sig_key="k", source="live",
                  cost={"flops": 1e6, "bytes_accessed": 1e6})
    row = prof.hotspots(ridge=16.0)["rows"][0]
    assert row["key"] == "k" and row["bound"] == "memory"
    assert row["share"] == 1.0 and row["intensity"] == 1.0
    prof.register("fpA", label="step", sig_key="k", source="live",
                  cost={"flops": 1e9, "bytes_accessed": 1e6})
    assert prof.hotspots(ridge=16.0)["rows"][0]["bound"] == "compute"
    assert obs.metrics.counter_value("obs.prof.samples") == 3
    assert prof.ridge_flops_per_byte() == 16.0   # the reference's default


def test_sample_rides_trace_ring():
    prof.set_sample_every(1)
    obs.trace.enable(1024)
    try:
        t0 = prof.tick("k2")
        prof.tock("k2", t0)
        assert "obs.prof.sample" in {e["name"] for e in obs.trace.events()}
    finally:
        obs.trace.disable()


def test_postmortem_carries_hotspots_provider():
    prof.set_sample_every(1)
    t0 = prof.tick("decode_step:w1")
    prof.tock("decode_step:w1", t0)
    hs = obs.recorder.get().postmortem("unit_test")["providers"]["hotspots"]
    assert hs["rows"] and hs["rows"][0]["key"] == "decode_step:w1"


def test_merge_hotspots_aggregates_replica_views():
    a = {"sample_every": 8, "ridge_flops_per_byte": 16.0,
         "rows": [{"key": "decode_step:ab:w1", "calls": 100, "samples": 10,
                   "mean_ms": 1.0, "est_total_ms": 100.0, "max_ms": 2.0,
                   "share": 1.0, "intensity": 0.3, "bound": "memory"}]}
    b = {"sample_every": 8, "ridge_flops_per_byte": 16.0,
         "rows": [{"key": "decode_step:ab:w1", "calls": 300, "samples": 30,
                   "mean_ms": 1.0, "est_total_ms": 300.0, "max_ms": 3.0,
                   "share": 0.75, "intensity": 0.3, "bound": "memory"},
                  {"key": "serving_bucket:cd:8", "calls": 50, "samples": 5,
                   "mean_ms": 2.0, "est_total_ms": 100.0, "max_ms": 4.0,
                   "share": 0.25, "intensity": 20.0, "bound": "compute"}]}
    m = prof.merge_hotspots([a, b, None, {"garbage": True}])
    assert m["merged_from"] == 2
    assert [r["key"] for r in m["rows"]] == ["decode_step:ab:w1",
                                             "serving_bucket:cd:8"]
    top = m["rows"][0]
    assert top["calls"] == 400 and top["est_total_ms"] == 400.0
    assert top["share"] == 0.8 and top["bound"] == "memory"
    assert prof.merge_hotspots([None, {}]) is None
    d = prof.compare_hotspots(a, b)
    deltas = {r["key"]: r["share_delta"] for r in d["rows"]}
    assert deltas == {"decode_step:ab:w1": -0.25, "serving_bucket:cd:8": 0.25}
    assert "share_delta" in prof.render_hotspots_compare(d)
    assert "decode_step:ab:w1" in prof.render_hotspots(m)


# --------------------------------------------------- the port's own counts


def test_flash_fwd_count_equals_the_kernel_formula():
    """The custom op is one op to the counting modes: its registered flop
    formula (two products over the kept score entries) and its operands'
    bytes (q, k, v in; o, lse out), the work chip_smoke.py's bound
    reckons."""
    N, T, D = 6, 24, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(N, T, D, generator=g) for _ in range(3))
    for causal in (False, True):
        got = _cost.count(lambda: torch.ops.paddle_tpu_torch.flash_fwd(
            q, k, v, 0.25, causal))
        pairs = (N * sum(min(i + 1, T) for i in range(T)) if causal
                 else N * T * T)
        assert got["flops"] == 2.0 * D * pairs * 2
        assert got["bytes_accessed"] == 4 * (4 * N * T * D + N * T)


def test_matmul_only_fc_program_counts_2bkn(tmp_path):
    """A warmed inference program of one bias-free fc: its ledger entry
    holds exactly 2 B K N flops, and its replays tick its timing key."""
    B, K, N = 3, 5, 7
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    x = tfluid.layers.data("x", [K])
    y = tfluid.layers.fc(x, N, bias_attr=False)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    prog = tfluid.default_main_program()
    prof.set_sample_every(1)
    assert exe.warm(prog, [("x", (B, K), "float32")], [y.name]) == "compiled"
    (ent,) = prof.ledger().snapshot().values()
    assert ent["flops"] == 2 * B * K * N and ent["bytes_accessed"] > 0
    assert ent["label"] == "train_step" and ent["source"] == "live"
    for _ in range(3):
        exe.run(prog, feed={"x": np.ones((B, K), "float32")},
                fetch_list=[y])
    assert prof.stats_snapshot()[ent["sig_key"]]["samples"] == 3
    assert obs.metrics.counter_value("compile.executor_compiles") == 1
    assert obs.metrics.snapshot()["histograms"]["compile.compile_ms"][
        "count"] == 1


def test_decode_warm_registers_every_prepared_signature():
    from paddle_tpu_torch.serving import ContinuousDecodeEngine

    eng = ContinuousDecodeEngine(_params(), n_slots=4, block_size=8,
                                 prompt_buckets=(8, 16), spec_window=2,
                                 device="cpu", **LM)
    assert eng.warm() == eng.trace_count()
    ents = list(prof.ledger().snapshot().values())
    assert len(ents) == eng.trace_count() == len(eng._sigs)
    assert {e["sig_key"] for e in ents} == {s.prof_key
                                            for s in eng._sigs.values()}
    assert all(e["flops"] > 0 and e["bytes_accessed"] > 0 for e in ents)
    assert obs.metrics.counter_value("serving.decode_traces") \
        == eng.trace_count()
    # a fused and a composed program never share an entry: every entry's
    # fingerprint is its own
    assert len({e["fingerprint"] for e in ents}) == len(ents)


def test_zero_capture_under_sampling_on_scheduler_churn():
    """tests/test_prof.py:184 on the port: every dispatch timed through
    join / leave churn prepares nothing after warm."""
    from paddle_tpu_torch.serving import (ContinuousDecodeEngine,
                                          ContinuousScheduler)

    eng = ContinuousDecodeEngine(_params(), n_slots=4, block_size=8,
                                 device="cpu", **LM)
    prof.set_sample_every(1)
    eng.warm()
    step_key = f"decode_step:{eng._sig_scope}:w1"
    keys = {e["sig_key"] for e in prof.ledger().snapshot().values()}
    assert step_key in keys
    assert any(k.startswith(f"decode_prefill:{eng._sig_scope}:pb")
               for k in keys)
    sched = ContinuousScheduler(eng)
    rng = np.random.RandomState(0)
    before = eng.trace_count()
    replays_before = sum(eng.step_dispatches.values())
    for _ in range(3):
        reqs = [sched.submit(rng.randint(2, 61, int(rng.choice([8, 12, 24])))
                             .astype("int32"), int(rng.randint(2, 7)))
                for _ in range(8)]
        sched.run_until_idle()
        assert all(r.done.is_set() for r in reqs)
    assert eng.trace_count() == before
    snap = prof.stats_snapshot()
    assert snap[step_key]["samples"] == snap[step_key]["calls"] \
        == sum(eng.step_dispatches.values()) - replays_before
    h = prof.hotspots()
    assert h["rows"][0]["key"] == step_key
    assert h["rows"][0]["bound"] == "memory"
    eng2 = ContinuousDecodeEngine(_params(), n_slots=2, block_size=8,
                                  device="cpu", **LM)
    assert eng2._sig_scope != eng._sig_scope


def test_counting_failure_never_breaks_preparation(monkeypatch):
    """Attribution is fail-safe: a count that raises leaves the signature
    prepared, with an empty cost."""
    from paddle_tpu_torch.core.graphs import Graphs

    def boom(body):
        raise RuntimeError("counting broke")

    monkeypatch.setattr(prof, "analyze", boom)
    ran = []
    p = Graphs("cpu").prepare(lambda: ran.append(1), count=True)
    assert p.cost == {} and ran == [1]
    p.replay()
    assert ran == [1, 1]

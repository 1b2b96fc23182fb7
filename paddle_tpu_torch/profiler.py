"""Profiling and timers (PyTorch port of ``paddle_tpu/profiler.py``).

Reference: paddle/utils/Stat.h:111-151,230 (REGISTER_TIMER accumulating into
globalStat, printed per pass; BarrierStat for straggler skew) and
fluid/profiler.py:18-46 (the nvprof bracket).

Host-side accumulating timers (the report shape of Stat.h's
printAllStatus), the counter and gauge shims over the typed
``obs.metrics`` registry (the names every module and test reads), and a
context manager bracketing ``torch.profiler`` (the nvprof analog; the
reference brackets ``jax.profiler``)."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

from .obs import metrics as _metrics


class _Stat:
    __slots__ = ("total", "count", "max")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def add(self, dt: float):
        self.total += dt
        self.count += 1
        self.max = max(self.max, dt)


_global_stats: Dict[str, _Stat] = defaultdict(_Stat)


@contextlib.contextmanager
def timer(name: str):
    """REGISTER_TIMER analog: ``with profiler.timer("forward"): ...``"""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _global_stats[name].add(time.perf_counter() - t0)


def incr(name: str, n: int = 1) -> None:
    _metrics.counter(name).inc(n)


def counter(name: str) -> int:
    return _metrics.default_registry().counter_value(name)


def counters(prefix: str = "") -> Dict[str, int]:
    return _metrics.default_registry().counters(prefix)


def gauge(name: str, value: float) -> None:
    _metrics.gauge(name).set(value)


def gauge_value(name: str, default: float = 0.0) -> float:
    return _metrics.default_registry().gauge_value(name, default)


def gauges(prefix: str = "") -> Dict[str, float]:
    return _metrics.default_registry().gauges(prefix)


def reset_stats():
    _global_stats.clear()
    _metrics.reset()


def stats_report() -> str:
    """Stat.h printAllStatus analog."""
    lines = [f"{'name':<30}{'calls':>8}{'total_ms':>12}{'avg_ms':>10}{'max_ms':>10}"]
    for name, s in sorted(_global_stats.items()):
        avg = s.total / max(s.count, 1)
        lines.append(f"{name:<30}{s.count:>8}{s.total * 1e3:>12.2f}{avg * 1e3:>10.2f}"
                     f"{s.max * 1e3:>10.2f}")
    snap = _metrics.snapshot()
    for name, c in sorted(snap["counters"].items()):
        lines.append(f"{name:<30}{c:>8}")
    for name, g in sorted(snap["gauges"].items()):
        lines.append(f"{name:<30}{g:>12.3f}")
    for name, h in sorted(snap["histograms"].items()):
        avg = h["sum"] / max(h["count"], 1)
        lines.append(f"{name:<30}{h['count']:>8}{h['sum']:>12.2f}{avg:>10.2f}")
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(output_dir: str = None, label: str = None):
    """``torch.profiler`` bracket with the CPU and (when there is a card)
    CUDA activities (fluid.profiler.cuda_profiler analog):

        with profiler.profiler() as info:
            for _ in range(10): exe.run(...)

    On exit the Chrome trace goes to ``output_dir`` (default
    ``<trace_dir>/xprof`` with ``PADDLE_TPU_TRACE_DIR`` set, else
    ``paddle_tpu_profile`` under the temporary directory) as
    ``info["chrome_trace"]``; with ``PADDLE_TPU_TRACE_DIR`` set it is also
    written as ``<trace_dir>/trace-xprof-<label>-<pid>.json``
    (``info["fleet_trace"]``), the per-process naming of the reference
    (``paddle_tpu/profiler.py::_reemit_perfetto_trace``), so
    ``obs.trace.merge_chrome_traces`` stitches the device profile with the
    host spans.  ``info["profile"]`` is the finished
    ``torch.profiler.profile``.  Opt-in only, and fail-safe: a profiler
    that cannot start or export leaves the run being profiled alone
    (``info["chrome_trace"]`` stays None)."""
    from .obs import trace as _obs_trace

    trace_dir = os.environ.get(_obs_trace.DIR_ENV)
    d = output_dir or (os.path.join(trace_dir, "xprof") if trace_dir
                       else os.path.join(tempfile.gettempdir(),
                                         "paddle_tpu_profile"))
    info = {"output_dir": d, "fleet_trace": None, "chrome_trace": None,
            "profile": None}
    prof = None
    try:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception:  # noqa: BLE001 — deep profiling is strictly opt-in
        prof = None
    try:
        yield info
    finally:
        if prof is not None:
            _finish(prof, info, d, trace_dir, label)


def _finish(prof, info: Dict, d: str, trace_dir, label) -> None:
    """Stop the profiler and export its Chrome trace (never raises: this
    rides the bracket's teardown)."""
    try:
        prof.__exit__(None, None, None)
        info["profile"] = prof
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        info["chrome_trace"] = path
        if trace_dir:
            info["fleet_trace"] = _reemit_trace(path, trace_dir, label)
    except Exception:  # noqa: BLE001
        pass


def _reemit_trace(path: str, trace_dir: str, label: str = None):
    """Copy the bracket's Chrome trace into the fleet trace dir under the
    ``trace-xprof-<label>-<pid>.json`` convention.  Returns the path, or
    None (never raises)."""
    import json

    try:
        with open(path) as f:
            ct = json.load(f)
        if not isinstance(ct.get("traceEvents"), list):
            return None
        from .obs import trace as _obs_trace

        name = f"xprof-{label or _obs_trace.process_label()}"
        out = os.path.join(trace_dir, f"trace-{name}-{os.getpid()}.json")
        os.makedirs(trace_dir, exist_ok=True)
        with open(out, "w") as f:
            json.dump(ct, f)
        return out
    except Exception:  # noqa: BLE001 — deep profiling is strictly opt-in
        return None


def _block(out) -> None:
    """Wait for the devices that hold ``out``'s tensors."""
    import torch

    devs = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devs.add(x.device)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(out)
    for dev in devs:
        torch.cuda.synchronize(dev)


def step_timer_loop(fn, n: int, name: str = "step"):
    """Time n calls of fn() with the device blocked at the end: the
    --job=time harness primitive (benchmark/paddle/image/run.sh)."""
    out = None
    t0 = time.perf_counter()
    for _ in range(n):
        with timer(name):
            out = fn()
    _block(out)
    return (time.perf_counter() - t0) / n


class BarrierStat:
    """Straggler analysis for synchronous multi-process steps (ref:
    paddle/utils/Stat.h BarrierStat: per-trainer arrival skew at pserver
    barriers).

    Each process measures how long IT waited at a barrier of the default
    ``torch.distributed`` group, then the wait durations are all-gathered;
    the largest wait is the arrival spread (the earliest arriver waits the
    longest).  One process (no group, or a group of one) records a skew of
    0."""

    def __init__(self, name: str = "barrier"):
        self.name = name
        self._skews: list = []

    def wait(self) -> float:
        """Blocks until every process reaches the barrier; returns this
        process's wait time in seconds and records the global skew."""
        from .parallel import comm
        from .resilience import cluster

        t_arrive = time.perf_counter()
        if cluster._world()[0] > 1:
            comm.barrier()
            waited = time.perf_counter() - t_arrive
            skew = float(max(cluster._allgather(waited)))
        else:
            waited = 0.0
            skew = 0.0
        self._skews.append(skew)
        _global_stats[f"{self.name}.wait"].add(waited)
        return waited

    def report(self) -> str:
        if not self._skews:
            return f"{self.name}: no samples"
        import numpy as np

        a = np.asarray(self._skews)
        return (f"{self.name}: samples={len(a)} skew mean={a.mean()*1e3:.2f}ms "
                f"max={a.max()*1e3:.2f}ms p95={np.percentile(a, 95)*1e3:.2f}ms")

"""Thread-aware span tracing into a bounded ring, exportable as Chrome
trace-event JSON (load in Perfetto / chrome://tracing — the xprof/trace-viewer
workflow PAPERS.md's profiling line of work standardised on).

    from paddle_tpu_torch import obs
    obs.trace.enable()
    with obs.span("train.step", step=i):
        ...
    obs.trace.export("trace.json")

Cost model:
  * disabled (the default): ``span(name)`` is one global check returning a
    shared no-op context manager — no allocation beyond the kwargs dict, no
    lock, no clock read.  A regression test bounds this.
  * enabled: two perf_counter reads plus one ring-slot write per span.  The
    ring is "lock-free-ish": slots are claimed with ``next()`` on an
    ``itertools.count`` (atomic under the GIL — CPython guarantees a single
    bytecode for the C-implemented iterator) and written without a lock; a
    torn read can only surface in ``events()``, which tolerates and drops
    in-flight slots.  Overflow overwrites the oldest slot silently — a trace
    that stops the workload to preserve history would be worse than a gap.

Spans record host-side wall time.  Device-side truth stays with
``profiler.profiler`` (the torch.profiler bracket); these spans are the cheap
always-available layer that needs no tooling to read.

Fleet tracing (DESIGN.md §16): a request that crosses processes carries a
``trace_id`` (plus the parent span's id) over the wire, and each process
records its own spans tagged with it:

  * :func:`child_span` — a span with an explicit trace/parent identity
    (``sp.span_id`` is what the next hop parents off);
  * :func:`record_at` — retroactively record a completed span from explicit
    ``perf_counter`` stamps (the batcher measures a request's queue wait and
    device-exec share while it happens; the session emits the spans after,
    tagged with the request's trace_id);
  * Chrome-trace ``ts`` is exported on the **unix epoch** (µs), so traces
    from different processes land on one timeline and Perfetto merges a
    multi-process request view — stitch per-process files with
    :func:`merge_chrome_traces`.
"""
from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence

_enabled = False
_capacity = 0
_ring: List[Optional[tuple]] = []
_slots = itertools.count()
_written = 0  # high-water mark of claimed slots (approximate under races)
_epoch = time.perf_counter()  # ts origin: monotonic, per-process
# unix-time of the perf_counter origin: lets every process export its spans
# on one shared (wall-clock) timeline, which is what makes a cross-process
# merge line hops up instead of stacking them all at t=0
_epoch_unix = time.time()
_process_label: Optional[str] = None

DIR_ENV = "PADDLE_TPU_TRACE_DIR"
LABEL_ENV = "PADDLE_TPU_TRACE_LABEL"


# id generation: one urandom seed per process, then getrandbits (C-level,
# GIL-atomic) — getrandom(2) is a syscall per call and costs ~100x more under
# some kernels' syscall filters, and a fresh trace id is minted on EVERY untraced request
_idgen = random.Random()
if hasattr(os, "register_at_fork"):  # a forked child must not repeat ids
    os.register_at_fork(after_in_child=_idgen.seed)


def new_trace_id() -> str:
    """A fresh 16-hex request trace id (cheap, collision-safe enough for a
    fleet's in-flight window)."""
    return f"{_idgen.getrandbits(64):016x}"


def new_span_id() -> str:
    return f"{_idgen.getrandbits(32):08x}"


def set_process_label(label: str) -> None:
    """Name this process's track in merged traces (default: the fleet replica
    env, else ``pid<pid>``)."""
    global _process_label
    _process_label = str(label)


def process_label() -> str:
    if _process_label:
        return _process_label
    env = os.environ.get(LABEL_ENV)
    if env:
        return env
    rep = os.environ.get("PADDLE_TPU_FLEET_REPLICA")
    if rep is not None:
        return f"replica{rep}"
    return f"pid{os.getpid()}"


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()
    span_id = ""  # child_span callers read .span_id on either path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "span_id", "_t0")

    def __init__(self, name: str, args: Optional[dict], span_id: str = ""):
        self.name = name
        self.args = args
        self.span_id = span_id

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _written
        t1 = time.perf_counter()
        n = next(_slots)
        # one tuple write: atomic enough under the GIL; readers drop slots
        # that are mid-flight
        _ring[n % _capacity] = (self.name, threading.get_ident(),
                                threading.current_thread().name,
                                (self._t0 - _epoch) * 1e6,
                                (t1 - self._t0) * 1e6, self.args)
        _written = n + 1  # losing a race only under-reports `dropped`
        return False


def span(name: str, **args):
    """``with obs.span("train.step", step=i): ...`` — near-zero when tracing
    is disabled."""
    if not _enabled:
        return _NULL
    return _Span(name, args or None)


def child_span(name: str, trace_id: Optional[str] = None,
               parent: Optional[str] = None, **args):
    """A span with explicit trace identity: tagged with ``trace_id`` (fresh
    if None), its own ``span_id`` (read it off the returned span — that is
    what the next hop passes as ``parent``), and the parent span's id when
    given.  Near-zero when disabled (``span_id`` is then '')."""
    if not _enabled:
        return _NULL
    sid = new_span_id()
    a = dict(args)
    a["trace_id"] = trace_id or new_trace_id()
    a["span_id"] = sid
    if parent:
        a["parent_span"] = parent
    return _Span(name, a, span_id=sid)


def record_at(name: str, t0_s: float, dur_s: float,
              trace_id: Optional[str] = None,
              parent: Optional[str] = None, **args) -> None:
    """Retroactively record a completed span from explicit ``perf_counter``
    stamps — for phases measured by another thread (the batcher's queue wait
    and exec share) that must appear on the *request's* trace.  No-op when
    disabled."""
    global _written
    if not _enabled:
        return
    a = dict(args)
    if trace_id:
        a["trace_id"] = trace_id
        a["span_id"] = new_span_id()
    if parent:
        a["parent_span"] = parent
    n = next(_slots)
    _ring[n % _capacity] = (name, threading.get_ident(),
                            threading.current_thread().name,
                            (t0_s - _epoch) * 1e6,
                            max(dur_s, 0.0) * 1e6, a or None)
    _written = n + 1


def enable(capacity: int = 65536) -> None:
    """Turn tracing on with a fresh ring of ``capacity`` span slots."""
    global _enabled, _capacity, _ring, _slots, _written
    if capacity <= 0:
        raise ValueError(f"trace capacity must be positive, got {capacity}")
    _capacity = int(capacity)
    _ring = [None] * _capacity
    _slots = itertools.count()
    _written = 0
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    global _ring, _slots, _written
    if _capacity:
        _ring = [None] * _capacity
        _slots = itertools.count()
        _written = 0


def dropped() -> int:
    """Spans overwritten by ring overflow so far (0 until the ring wraps)."""
    return max(0, _written - _capacity)


def _recorded() -> List[tuple]:
    """Completed slots, oldest first (ring order reconstructed by ts)."""
    rows = [r for r in list(_ring) if r is not None]
    rows.sort(key=lambda r: r[3])
    return rows


def events() -> List[Dict]:
    """Completed spans as dicts, oldest first."""
    out = []
    for name, tid, tname, ts, dur, args in _recorded():
        ev = {"name": name, "tid": tid, "thread": tname,
              "ts_us": ts, "dur_us": dur}
        if args:
            ev["args"] = args
        out.append(ev)
    return out


def chrome_trace() -> Dict:
    """The Chrome trace-event JSON object ({"traceEvents": [...]}) — complete
    'X' (duration) events plus one 'M' thread_name metadata row per thread
    and a 'M' process_name row, loadable in Perfetto.  ``ts`` is µs on the
    UNIX epoch (not process start), so traces exported by different processes
    share one timeline and a concatenated merge lines the hops up."""
    pid = os.getpid()
    base_us = _epoch_unix * 1e6
    evs: List[Dict] = []
    threads = {}
    for name, tid, tname, ts, dur, args in _recorded():
        threads[tid] = tname
        ev = {"name": name, "ph": "X", "cat": "paddle_tpu", "pid": pid,
              "tid": tid, "ts": round(base_us + ts, 3), "dur": round(dur, 3)}
        if args:
            ev["args"] = args
        evs.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": process_label()}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
              "args": {"name": tname}} for tid, tname in sorted(threads.items())]
    return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}


def export(path: str) -> str:
    """Write the Chrome trace JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return path


def export_to_dir(dirname: Optional[str] = None,
                  label: Optional[str] = None) -> Optional[str]:
    """Write this process's trace into the fleet trace dir (default
    ``$PADDLE_TPU_TRACE_DIR``) as ``trace-<label>-<pid>.json`` — the
    per-process file ``obs trace --fleet`` stitches.  None (no write) when
    tracing is disabled or no dir is configured; never raises (export rides
    drain/shutdown paths)."""
    d = dirname or os.environ.get(DIR_ENV)
    if not d or not _enabled:
        return None
    if label:
        set_process_label(label)
    try:
        os.makedirs(d, exist_ok=True)
        return export(os.path.join(
            d, f"trace-{process_label()}-{os.getpid()}.json"))
    except Exception:  # noqa: BLE001 — shutdown path, never mask the exit
        return None


def merge_chrome_traces(paths: Sequence[str],
                        trace_id: Optional[str] = None) -> Dict:
    """Stitch per-process Chrome trace files into ONE trace object: events
    keep their own pid (distinct real pids -> distinct Perfetto tracks) and
    already share the unix-epoch timebase.  ``trace_id`` keeps only the 'X'
    events of one request (metadata rows always survive).  Unreadable or
    foreign-schema files are skipped, not fatal — a merge over a partly
    dead fleet still explains the live part."""
    events: List[Dict] = []
    merged_from = []
    for p in paths:
        try:
            with open(p) as f:
                ct = json.load(f)
            evs = ct.get("traceEvents")
            if not isinstance(evs, list):
                continue
        except Exception:  # noqa: BLE001 — tolerate partial fleets
            continue
        merged_from.append(os.path.basename(p))
        for ev in evs:
            if not isinstance(ev, dict):
                continue
            if (trace_id and ev.get("ph") == "X"
                    and (ev.get("args") or {}).get("trace_id") != trace_id):
                continue
            events.append(ev)
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "mergedFrom": merged_from}


# opt-in from the environment: PADDLE_TPU_TRACE=1 (or a capacity number)
# traces from process start — the zero-code-change way to capture a run
_env = os.environ.get("PADDLE_TPU_TRACE", "")
if _env and _env != "0":
    enable(int(_env) if _env.isdigit() and int(_env) > 1 else 65536)

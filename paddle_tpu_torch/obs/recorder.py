"""Crash flight recorder: the artifact that explains a dead run.

The resilience layer KILLS processes on purpose (the watchdog's EXIT_HUNG
force-exit, the anomaly guard's rollback, the preemption drain, the
supervisor's gang teardown), and none of them leaves evidence beyond an
exit code.  The flight recorder is a bounded ring of recent step records and
resilience events, dumped (with the metrics snapshot and all-thread stacks)
to a postmortem JSON at exactly those moments:

  hang              Watchdog._default_on_hang, before os._exit(EXIT_HUNG)
  anomaly_rollback  Trainer._rollback, before the restore
  preemption        Trainer._drain_preemption, before resumable_exit
  child_death       Supervisor.run, when a gang member crashes or hangs

Thread stacks come from ``faulthandler.dump_traceback(all_threads=True)`` —
the same output a fatal-signal handler would give, which is the point: on an
EXIT_HUNG the interesting fact is WHERE every thread was stuck, and
faulthandler reads frames without running Python code in the stuck threads.

Postmortem JSON schema (DESIGN.md §13):
  {"schema": "paddle_tpu.postmortem.v1", "reason", "time", "time_iso",
   "pid", "host", "restarts", "extra": {...},
   "records": [{"kind", "t", ...payload}...],   # oldest -> newest
   "providers": {key: <registered live-state snapshot>},  # e.g. the fleet
   #            router's last-N per-request breakdowns ("fleet_requests")
   "metrics": <obs.metrics.snapshot()>,
   "threads": "<faulthandler text>"}

Dump paths are fail-safe: every writer is inside a crash path, so a failure
to record must never mask (or delay) the exit it is documenting — errors are
reported to stderr and swallowed.  Stdlib-only, jax-free, like the rest of
obs/.
"""
from __future__ import annotations

import faulthandler
import json
import os
import socket
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import metrics as _metrics

DIR_ENV = "PADDLE_TPU_POSTMORTEM_DIR"
_DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "paddle_tpu_postmortem")
SCHEMA = "paddle_tpu.postmortem.v1"


def postmortem_dir() -> str:
    return os.environ.get(DIR_ENV) or _DEFAULT_DIR


def thread_stacks() -> str:
    """All-thread stacks via faulthandler (frame walk in C, safe while other
    threads are wedged in native code); falls back to sys._current_frames if
    faulthandler can't write (no real fd, esoteric platforms)."""
    try:
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()
    except Exception:
        import traceback

        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f"Thread {names.get(tid, '?')} (ident {tid}):")
            out.extend(line.rstrip()
                       for line in traceback.format_stack(frame))
        return "\n".join(out)


class FlightRecorder:
    """Bounded ring of step records + events.  Appends are one deque op under
    a lock — cheap enough for every training step; overflow drops oldest."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dumps = 0  # distinguishes same-reason dumps within one second
        # live-state providers: subsystems that hold their own bounded rings
        # (the fleet router's last-N per-request breakdowns) register a
        # callable; every postmortem snapshots them so an EXIT_HUNG or
        # child-death dump shows what the fleet was DOING, not just that it
        # died.  Each provider is fail-safe at dump time.
        self._providers: Dict[str, object] = {}

    # ------------------------------------------------------------- providers
    def register_provider(self, key: str, fn) -> None:
        """``fn() -> json-safe object``, snapshotted into every postmortem
        under ``providers[key]``.  Re-registering a key replaces it (a new
        router generation supersedes the old one's view)."""
        with self._lock:
            self._providers[key] = fn

    def unregister_provider(self, key: str, fn=None) -> None:
        """Remove ``key`` — but with ``fn`` given, only when the registered
        provider IS that callable: a closed router must not delete the
        registration of the newer router that replaced it."""
        with self._lock:
            if fn is None or self._providers.get(key) is fn:
                self._providers.pop(key, None)

    def _provider_snapshots(self) -> Dict:
        with self._lock:
            items = list(self._providers.items())
        out = {}
        for key, fn in items:
            try:
                out[key] = fn()
            except Exception as e:  # noqa: BLE001 — crash-path, never mask
                out[key] = {"provider_error": repr(e)}
        return out

    # ------------------------------------------------------------- recording
    def record_step(self, step: int, pass_id: int = 0, batch_id: int = 0,
                    cost: Optional[float] = None,
                    metrics: Optional[Dict[str, float]] = None) -> None:
        rec = {"kind": "step", "t": time.time(), "step": step,
               "pass_id": pass_id, "batch_id": batch_id}
        if cost is not None:
            rec["cost"] = cost
        if metrics:
            rec["metrics"] = dict(metrics)
        with self._lock:
            self._ring.append(rec)

    def record_event(self, kind: str, **payload) -> None:
        rec = {"kind": kind, "t": time.time()}
        rec.update(payload)
        with self._lock:
            self._ring.append(rec)

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # ------------------------------------------------------------ postmortem
    def postmortem(self, reason: str, extra: Optional[Dict] = None) -> Dict:
        now = time.time()
        try:
            restarts = int(os.environ.get("PADDLE_TPU_RESTARTS", "0"))
        except ValueError:
            restarts = 0
        return {
            "schema": SCHEMA,
            "reason": reason,
            "time": now,
            "time_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z",
                                      time.localtime(now)),
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "restarts": restarts,
            "extra": dict(extra or {}),
            "records": self.records(),
            "providers": self._provider_snapshots(),
            "metrics": _metrics.snapshot(),
            "threads": thread_stacks(),
        }

    def dump(self, reason: str, path: Optional[str] = None,
             extra: Optional[Dict] = None) -> Optional[str]:
        """Write the postmortem JSON; returns the path, or None on failure.
        Never raises — every caller is already on a crash path."""
        try:
            pm = self.postmortem(reason, extra)
            if path is None:
                d = postmortem_dir()
                os.makedirs(d, exist_ok=True)
                with self._lock:
                    seq, self._dumps = self._dumps, self._dumps + 1
                # the per-recorder sequence number keeps two same-reason
                # dumps inside one second (rollback -> fast replay ->
                # rollback) from os.replace'ing each other's evidence
                path = os.path.join(
                    d, f"postmortem-{reason}-{os.getpid()}-"
                       f"{int(pm['time'])}-{seq}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(pm, f, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _metrics.counter("obs.postmortems").inc()
            sys.stderr.write(f"paddle_tpu obs: postmortem ({reason}) written "
                             f"to {path}\n")
            sys.stderr.flush()
            return path
        except Exception as e:  # noqa: BLE001 — must not mask the crash
            try:
                sys.stderr.write(f"paddle_tpu obs: postmortem dump failed: "
                                 f"{e!r}\n")
            except Exception:
                pass
            return None


# ------------------------------------------------------- process-wide default

_global = FlightRecorder()


def get() -> FlightRecorder:
    return _global


def record_step(step: int, pass_id: int = 0, batch_id: int = 0,
                cost: Optional[float] = None,
                metrics: Optional[Dict[str, float]] = None) -> None:
    _global.record_step(step, pass_id, batch_id, cost, metrics)


def record_event(kind: str, **payload) -> None:
    _global.record_event(kind, **payload)


def register_provider(key: str, fn) -> None:
    _global.register_provider(key, fn)


def unregister_provider(key: str, fn=None) -> None:
    _global.unregister_provider(key, fn)


def dump(reason: str, path: Optional[str] = None,
         extra: Optional[Dict] = None) -> Optional[str]:
    return _global.dump(reason, path=path, extra=extra)

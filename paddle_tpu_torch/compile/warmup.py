"""Warmup orchestrator: load-or-compile manifest entries off the hot path.

One background thread executes warm tasks in priority order (train step
first, then serving buckets hottest-first — the ShapeManifest ordering) and
exposes PER-TASK readiness, so serving admission can gate on "is THIS
bucket warm" instead of "is everything warm".  A consumer that needs a cold
entry right now calls ``require(name)``: the task jumps the queue and the
caller waits exactly as long as that one compile — never longer than the
inline compile it replaces, and never duplicating it.

Failure is a first-class outcome: a task that raises records its error and
READINESS IS GRANTED ANYWAY (``ready()`` -> True) — warmup is an
optimization, and a consumer gated forever on a failed warm would turn a
cache problem into an outage.  The consumer's own call then compiles live.

The port's copy of ``paddle_tpu/compile/warmup.py``.  A task's callable is
the port's capture: ``Executor.warm`` of one signature, or
``Session._warm_bucket`` (one ``InferenceModel`` call at the bucket's
rows, which prepares its signature).  A failed task grants readiness, and
the consumer's own call then captures live: that call raises if the
capture fails again, so no failure is hidden.
``summary()['aot_satisfied']`` counts the tasks an AOT store answered;
the store is ROADMAP A.10, so here it reads 0.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import metrics as _metrics
from ..obs import trace as _trace

PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"


class _Task:
    __slots__ = ("name", "priority", "seq", "fn", "state", "result", "error",
                 "ms", "event")

    def __init__(self, name: str, priority: float, seq: int, fn: Callable):
        self.name = name
        self.priority = priority
        self.seq = seq
        self.fn = fn
        self.state = PENDING
        self.result = None
        self.error: Optional[BaseException] = None
        self.ms: Optional[float] = None
        self.event = threading.Event()


class Warmup:
    """Priority-ordered background warm tasks with per-task readiness.

    ``add(name, fn, priority)`` before or after ``start()``; lower priority
    number runs first (add order breaks ties).  ``on_complete`` fires once
    when the queue first drains — the storm guard marks steady state there.
    """

    def __init__(self, name: str = "warmup",
                 on_complete: Optional[Callable[["Warmup"], None]] = None):
        self.name = name
        self.on_complete = on_complete
        self._cv = threading.Condition()
        self._tasks: Dict[str, _Task] = {}
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._completed_fired = False
        self.started_at: Optional[float] = None
        self.first_ready_s: Optional[float] = None

    # ------------------------------------------------------------------ build
    def add(self, name: str, fn: Callable, priority: float = 100.0) -> None:
        with self._cv:
            if name in self._tasks:
                return  # idempotent: first registration wins
            self._tasks[name] = _Task(name, priority, self._seq, fn)
            self._seq += 1
            self._cv.notify_all()

    def start(self) -> "Warmup":
        with self._cv:
            if self._thread is None:
                self.started_at = time.perf_counter()
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"compile-warmup-{self.name}")
                self._thread.start()
        return self

    def close(self) -> None:
        """Let the worker exit once the queue drains (pending tasks still
        run; nothing is abandoned).  Owners call this when no further adds
        can come — the thread must not poll its condition forever."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    # ------------------------------------------------------------- scheduling
    def _next_pending(self) -> Optional[_Task]:
        pending = [t for t in self._tasks.values() if t.state == PENDING]
        if not pending:
            return None
        return min(pending, key=lambda t: (t.priority, t.seq))

    def _loop(self) -> None:
        while True:
            with self._cv:
                task = self._next_pending()
                if task is None:
                    if self._stop:
                        return
                    if not self._completed_fired:
                        self._completed_fired = True
                        cb = self.on_complete
                    else:
                        cb = None
                else:
                    task.state = RUNNING
                    cb = None
            if cb is not None:
                try:
                    cb(self)
                except Exception:
                    pass  # a completion hook must not kill the warm thread
            if task is None:
                with self._cv:
                    if self._stop:
                        return
                    self._cv.wait(timeout=0.5)  # late add() wakes us anyway
                continue
            t0 = time.perf_counter()
            try:
                with _trace.span("compile.warmup", task=task.name):
                    task.result = task.fn()
                task.state = DONE
            except BaseException as e:  # noqa: BLE001 — recorded, not fatal
                task.error = e
                task.state = FAILED
            task.ms = (time.perf_counter() - t0) * 1e3
            _metrics.counter("compile.warmups").inc()
            _metrics.histogram("compile.warmup_ms").observe(task.ms)
            if self.first_ready_s is None and self.started_at is not None:
                self.first_ready_s = time.perf_counter() - self.started_at
            with self._cv:
                task.event.set()
                self._completed_fired = False if self._next_pending() else \
                    self._completed_fired
                self._cv.notify_all()

    # -------------------------------------------------------------- readiness
    def ready(self, name: str) -> bool:
        """True when the task finished (even FAILED — see module doc) or was
        never registered (no gating for unknown names)."""
        with self._cv:
            t = self._tasks.get(name)
        return t is None or t.state in (DONE, FAILED)

    def wait(self, name: str, timeout: Optional[float] = None) -> bool:
        with self._cv:
            t = self._tasks.get(name)
        if t is None:
            return True
        return t.event.wait(timeout)

    def prioritize(self, name: str) -> None:
        """Move a pending task to the front of the queue (a consumer needs
        it NOW — the cold-bucket admission path)."""
        with self._cv:
            t = self._tasks.get(name)
            if t is not None and t.state == PENDING:
                t.priority = float("-inf")
                self._cv.notify_all()

    def require(self, name: str, timeout: Optional[float] = 120.0) -> bool:
        """Prioritize + wait: the gate a consumer calls before running a
        possibly-cold entry.  Bounded by ``timeout`` so a wedged warm thread
        can never deadlock serving — on timeout the caller compiles inline."""
        if self.ready(name):
            return True
        self.prioritize(name)
        if self._thread is None or not self._thread.is_alive():
            # never started, or already drained-and-exited: nothing will
            # ever run the task — the caller compiles inline
            return True
        return self.wait(name, timeout)

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cv:
                unfinished = [t for t in self._tasks.values()
                              if t.state in (PENDING, RUNNING)]
            if not unfinished:
                return True
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return False
            if not unfinished[0].event.wait(
                    min(0.5, left) if left is not None else 0.5):
                continue

    def done(self) -> bool:
        with self._cv:
            return all(t.state in (DONE, FAILED) for t in self._tasks.values())

    # ----------------------------------------------------------- introspection
    def status(self) -> Dict[str, Dict]:
        with self._cv:
            return {t.name: {"state": t.state,
                             "ms": round(t.ms, 2) if t.ms is not None else None,
                             "priority": t.priority,
                             "result": t.result if isinstance(
                                 t.result, (str, int, float, bool, type(None)))
                             else str(t.result),
                             "error": str(t.error) if t.error else None}
                    for t in sorted(self._tasks.values(),
                                    key=lambda t: (t.priority, t.seq))}

    def summary(self) -> Dict:
        st = self.status()
        states: Dict[str, int] = {}
        for v in st.values():
            states[v["state"]] = states.get(v["state"], 0) + 1
        return {"tasks": len(st), "states": states,
                "first_ready_s": self.first_ready_s,
                # tasks the AOT store answered (no compile paid) — for a
                # sharded fleet this is the respawn-warm evidence per task
                "aot_satisfied": sum(
                    1 for v in st.values()
                    if str(v["result"]).startswith("aot")),
                "total_warm_ms": round(sum(v["ms"] or 0 for v in st.values()), 2)}


def mark_start(warm: bool) -> None:
    """Record whether this process started warm (a manifest had entries at
    boot) — the healthz 'did the restart actually skip work' signal.  Sticky:
    the trainer and the serving ladder each report their own verdict into
    the one process gauge, and warm-anywhere must not be overwritten by a
    cold-elsewhere report (e.g. first boot after enabling serving: warm
    train manifest, empty serving manifest)."""
    if warm:
        _metrics.gauge("compile.warm_start").set(1.0)

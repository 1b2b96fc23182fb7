"""Recompile-storm guard (PyTorch port of
``paddle_tpu/compile/guard.py``): steady-state captures are a bug, find
the shape.

After warmup the consumer marks steady state, and every later execution
calls ``check(shape)`` with the shape signature it just ran.  A rising
counter is attributed to that shape (the capture happened inside the run
that just returned) and, past ``budget``, escalated per policy: ``warn``
(a line on stderr), ``raise`` (``RecompileBudgetExceeded``) or ``off``.

Works against any monotonic counter.  In the port that counter is the
number of CUDA graphs captured (the signatures prepared: on the CPU, the
bodies prepared), such as ``SparseEmbeddingTrainer.traces`` or
``Executor.compiles``.  Each steady-state capture counts
``compile.retraces`` and each breach ``compile.storms``, and both go to the
flight recorder as events (``recompile``, ``compile_storm``).
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Dict, Optional

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder


class RecompileBudgetExceeded(RuntimeError):
    """Steady-state captures exceeded the configured budget: shapes are
    leaking past the bucket ladder or the warmup set, and every leak costs
    a capture on the hot path."""


class RecompileGuard:
    """``counter_fn``: returns the monotonic capture count.  ``budget``:
    steady-state captures tolerated before escalation.  ``policy``:
    'warn' | 'raise' | 'off'."""

    def __init__(self, counter_fn: Callable[[], int], *, budget: int = 0,
                 policy: str = "warn", name: str = "serving"):
        if policy not in ("warn", "raise", "off"):
            raise ValueError(
                f"recompile policy {policy!r} not in warn|raise|off")
        self.counter_fn = counter_fn
        self.budget = int(budget)
        self.policy = policy
        self.name = name
        self._lock = threading.Lock()
        self._steady_base: Optional[int] = None
        self._last_seen: Optional[int] = None
        self._by_shape: Dict[str, int] = {}
        self._escalated = False

    def mark_steady(self) -> int:
        """Warmup is over: captures from here on are storms, not startup.
        Returns the baseline count."""
        base = int(self.counter_fn())
        with self._lock:
            self._steady_base = base
            self._last_seen = base
        return base

    @property
    def steady(self) -> bool:
        """Whether ``mark_steady`` has run."""
        with self._lock:
            return self._steady_base is not None

    def check(self, shape: str = "?") -> int:
        """Call after an execution, passing the shape signature that ran.
        Returns the steady-state captures so far.  A no-op before
        ``mark_steady``."""
        if self.policy == "off":
            return 0
        now = int(self.counter_fn())
        with self._lock:
            if self._steady_base is None:
                return 0
            delta = now - (self._last_seen if self._last_seen is not None
                           else now)
            self._last_seen = now
            if delta > 0:
                self._by_shape[shape] = self._by_shape.get(shape, 0) + delta
            total = now - self._steady_base
            over = total > self.budget and not self._escalated
            if over and self.policy == "raise":
                self._escalated = True
        if delta > 0:
            _metrics.counter("compile.retraces").inc(delta)
            _recorder.record_event("recompile", guard=self.name, shape=shape,
                                   retraces=delta, steady_total=total,
                                   time=time.time())
        if total > self.budget and delta > 0:
            _metrics.counter("compile.storms").inc()
            msg = (f"compile storm [{self.name}]: {total} steady-state "
                   f"capture(s) exceed budget {self.budget}; last triggered "
                   f"by shape {shape} (per-shape: {self._by_shape})")
            _recorder.record_event("compile_storm", guard=self.name,
                                   total=total, budget=self.budget,
                                   by_shape=dict(self._by_shape))
            if over and self.policy == "raise":
                raise RecompileBudgetExceeded(msg)
            sys.stderr.write(f"paddle_tpu_torch compile: WARNING {msg}\n")
        return total

    def stats(self) -> Dict:
        """The healthz view: policy, budget, whether steady, the
        steady-state captures (the reference's key, ``steady_retraces``)
        and their per-shape attribution."""
        with self._lock:
            base = self._steady_base
            total = ((self._last_seen - base)
                     if base is not None and self._last_seen is not None
                     else 0)
            return {"name": self.name, "policy": self.policy,
                    "budget": self.budget, "steady": base is not None,
                    "steady_retraces": total,
                    "by_shape": dict(self._by_shape)}

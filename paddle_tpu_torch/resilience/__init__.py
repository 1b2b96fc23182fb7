"""Resilience (PyTorch port of ``paddle_tpu/resilience``): the retry,
backoff, deadline and circuit-breaker primitives (``policy.py``; the
serving ``Session`` sheds load behind a ``CircuitBreaker``), the cluster
conventions (``cluster.py``: preemption, the hang watchdog, restore
agreement, the resumable exit codes) and the fault-injection registry
``faults``."""
from __future__ import annotations

from . import cluster, faults
from .cluster import (
    EXIT_HUNG,
    EXIT_PREEMPTED,
    RESUMABLE_EXITS,
    PreemptionGuard,
    Watchdog,
    agree_restore_step,
    barrier,
    restart_count,
    resumable_exit,
)
from .policy import (
    Backoff,
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    TransientError,
    retry,
)

__all__ = ["Backoff", "CircuitBreaker", "CircuitOpenError", "Deadline", "DeadlineExceeded", "EXIT_HUNG",
           "EXIT_PREEMPTED", "PreemptionGuard", "RESUMABLE_EXITS",
           "RetryPolicy", "TransientError", "Watchdog", "agree_restore_step",
           "barrier", "cluster", "faults", "restart_count", "resumable_exit",
           "retry"]

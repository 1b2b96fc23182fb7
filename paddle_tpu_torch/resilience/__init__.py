"""Resilience (PyTorch port of ``paddle_tpu/resilience``): the retry,
backoff and deadline primitives (``policy.py``), the cluster conventions
(``cluster.py``: preemption, the hang watchdog, restore agreement, the
resumable exit codes) and the fault-injection registry ``faults``.  The
``CircuitBreaker`` and the profiler counters are ROADMAP A.10."""
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
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    TransientError,
    retry,
)

__all__ = ["Backoff", "Deadline", "DeadlineExceeded", "EXIT_HUNG",
           "EXIT_PREEMPTED", "PreemptionGuard", "RESUMABLE_EXITS",
           "RetryPolicy", "TransientError", "Watchdog", "agree_restore_step",
           "barrier", "cluster", "faults", "restart_count", "resumable_exit",
           "retry"]

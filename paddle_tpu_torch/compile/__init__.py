"""Compilation and startup (PyTorch port of ``paddle_tpu/compile``): the
port's "compile" is a capture (``core/graphs.py``: a CUDA graph on the
card, the body's first run on the CPU).

  manifest  the shape manifest: every (function, shapes, bucket) actually
            executed, with hit counts, so the next generation knows what
            to warm and in what order.
  warmup    the warmup orchestrator: warm tasks on a background thread in
            priority order with per-task readiness, so serving admission
            gates per bucket.
  guard     the recompile-storm detector over a capture counter.

``health()`` is the compile side of ``Session.healthz``.  The
content-addressed AOT store (``aot``) and ``warm(store=...)`` are ROADMAP
A.10.
"""
from . import guard, manifest, warmup
from .guard import RecompileBudgetExceeded, RecompileGuard
from .manifest import ShapeManifest
from .warmup import Warmup

__all__ = ["guard", "manifest", "warmup", "RecompileBudgetExceeded",
           "RecompileGuard", "ShapeManifest", "Warmup", "health",
           "default_compile_dir"]

# the reference's env var for the compile dir a supervisor forwards; the
# port reads it only to refuse it (the AOT store is ROADMAP A.10)
COMPILE_DIR_ENV = "PADDLE_TPU_COMPILE_DIR"


def default_compile_dir():
    """The compile dir in effect for this process: the env var, or None."""
    import os

    return os.environ.get(COMPILE_DIR_ENV) or None


def health():
    """The compile side of healthz, the reference's keys: the persistent
    cache (the port has none: its captures live in the process), warm or
    cold start, the capture and AOT counters (the AOT ones read 0 until
    ROADMAP A.10), retraces and storms."""
    from ..obs import metrics as _metrics

    reg = _metrics.default_registry()
    return {
        "persistent_cache": {"dir": None, "enabled": False,
                             "reason": "captures live in the process; "
                                       "the AOT store is ROADMAP A.10"},
        "warm_start": bool(reg.gauge_value("compile.warm_start")),
        "executor_compiles": reg.counter_value("compile.executor_compiles"),
        "aot": {
            "hits": reg.counter_value("compile.aot_hits"),
            "misses": reg.counter_value("compile.aot_misses"),
            "writes": reg.counter_value("compile.aot_writes"),
            "corrupt": reg.counter_value("compile.aot_corrupt"),
        },
        "retraces": reg.counter_value("compile.retraces"),
        "storms": reg.counter_value("compile.storms"),
    }

"""Compilation and startup (PyTorch port of ``paddle_tpu/compile``): the
port's "compile" is a capture (``core/graphs.py``: a CUDA graph on the
card, the body's first run on the CPU).

  aot       prepared steps as durable artifacts: a content-addressed
            on-disk store keyed by a canonical fingerprint (program text,
            argument shapes and dtypes, sharding, torch / CUDA / kernel
            versions, device).  An entry is the step's traced graph,
            pickled; sha256-verified atomic writes, quarantine of a
            corrupt entry, and the live preparation on any miss.  A loaded
            graph is still captured: a CUDA graph cannot be serialized.
            Loading unpickles, so a compile dir must be as trusted as the
            code: the store reads only entries of this user that no one
            else can write.
  manifest  the shape manifest: every (function, shapes, bucket) actually
            executed, with hit counts, so the next generation knows what
            to warm and in what order.
  warmup    the warmup orchestrator: warm tasks on a background thread in
            priority order with per-task readiness, so serving admission
            gates per bucket.
  guard     the recompile-storm detector over a capture counter.

Wired through ``Executor.warm(store=)``, ``Trainer`` (``compile_dir``: the
store and the manifest; ``prepare()`` warm-starts from them),
``capi_server.Session.enable_batching(compile_dir=)``, the supervisor
(``--compile-dir`` forwarded as ``PADDLE_TPU_COMPILE_DIR``) and the
``compile`` verb of the command line.  ``health()`` is the compile side of
``Session.healthz``.
"""
from . import aot, guard, manifest, warmup
from .aot import AOTStore, canonical_sharding, fingerprint
from .guard import RecompileBudgetExceeded, RecompileGuard
from .manifest import ShapeManifest
from .warmup import Warmup

__all__ = ["aot", "guard", "manifest", "warmup", "AOTStore",
           "canonical_sharding", "fingerprint", "RecompileBudgetExceeded",
           "RecompileGuard", "ShapeManifest", "Warmup", "health",
           "default_compile_dir"]

# the env var the supervisor forwards, so that the store and the manifests
# survive its generations (the dirs are plain files; the env is how
# children find them)
COMPILE_DIR_ENV = "PADDLE_TPU_COMPILE_DIR"


def default_compile_dir():
    """The compile dir in effect for this process: the env var, or None."""
    import os

    return os.environ.get(COMPILE_DIR_ENV) or None


def health():
    """The compile side of healthz, the reference's keys: the persistent
    store (the AOT store this process warms through: its dir, or disabled
    when there is none), warm or cold start, the capture and AOT counters,
    retraces and storms."""
    from ..obs import metrics as _metrics

    reg = _metrics.default_registry()
    store = aot.active_store()
    cache = ({"dir": store.dirname, "enabled": True, "reason": "aot store"}
             if store is not None else
             {"dir": None, "enabled": False,
              "reason": "disabled: no compile_dir (captures live in the "
                        "process)"})
    return {
        "persistent_cache": cache,
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

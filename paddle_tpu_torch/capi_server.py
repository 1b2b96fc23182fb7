"""Python half of the C inference API (PyTorch port of
``paddle_tpu/capi_server.py``; ref: paddle/capi/gradient_machine.h,
create_for_inference_with_parameters / forward / create_shared_param).

A ``Session`` loads a ``merge_model`` artifact (``io.load_merged_model``:
the exported program, one CUDA graph a feed signature on the card), binds
feeds from raw buffers, runs the model and hands raw bytes back: one copy
in (``feed``), one copy out (``output``).  Clones share the model, the
health state, the circuit breaker and the micro-batcher, so one model
serves many threads (the model's calls are serialised by its own lock,
``io.InferenceModel``).

The Session runs on the CUDA card unless ``PADDLE_TPU_CAPI_PLATFORM=cpu``
asks for the CPU (the reference pins JAX's platform the same way, with the
CPU as its default; the port's entry points default to the card).  Left
for ROADMAP A.10, each raising with a message naming it: ``compile_dir``
(the AOT store), ``enable_mesh`` (it needs ``InferenceModel.shard``) and
the native C shim (``native/capi.cc``, which needs ``native.py``).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .obs import trace as _trace
from .resilience import (CircuitBreaker, Deadline, DeadlineExceeded,
                         TransientError, faults)

PLATFORM_ENV = "PADDLE_TPU_CAPI_PLATFORM"
_A10 = "ROADMAP A.10"


def _platform_device() -> str:
    """The Session's device: the card unless the env var names the CPU."""
    return ("cpu" if os.environ.get(PLATFORM_ENV, "").lower() == "cpu"
            else "cuda")


class _ServingState:
    """Health and degradation state SHARED by a session and its per-thread
    clones (one model, one health signal; capi's create_shared_param
    likewise shares the weights).  The dynamic batcher, when enabled, lives
    here too: one scheduler and queue per loaded model."""

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0):
        self.lock = threading.Lock()
        # named breaker: its state rides the resilience.breaker_state
        # labeled gauge, so a scrape sees open / half-open without healthz
        self.breaker = CircuitBreaker(failure_threshold=failure_threshold,
                                      reset_timeout_s=reset_timeout_s,
                                      name="serving")
        self.requests = 0
        self.errors = 0
        self.in_flight = 0           # requests currently inside run()
        self.healthz_seq = 0         # monotonic per-process probe counter
        self.last_latency_ms: Optional[float] = None
        self.batcher = None  # serving.DynamicBatcher once enable_batching()
        self.decode = None   # serving.ContinuousScheduler once attach_decode()
        self.kv_dtype = None  # declared quantized-KV regime
        # the compile side, populated by enable_batching:
        self.warmup = None           # compile.Warmup: per-bucket readiness
        self.recompile_guard = None  # compile.RecompileGuard
        self.compile_manifest = None  # compile.ShapeManifest (bucket heat)

    def record(self, ok: bool, latency_ms: Optional[float]) -> None:
        with self.lock:
            self.requests += 1
            if not ok:
                self.errors += 1
            if latency_ms is not None:
                self.last_latency_ms = latency_ms
        if ok:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()

    def record_shed(self, latency_ms: Optional[float] = None) -> None:
        """A request that failed against its CLIENT-chosen deadline.  Counts
        against the error rate but NOT the circuit breaker: one
        tight-deadline client must not shed every other client's traffic."""
        with self.lock:
            self.requests += 1
            self.errors += 1
            if latency_ms is not None:
                self.last_latency_ms = latency_ms


class Session:
    """One loaded inference model; cheap to clone per serving thread (the
    model and its parameters are shared).

    ``run`` takes an optional per-request deadline, retries ONCE on a
    transient backend error, and sits behind a shared circuit breaker:
    consecutive failures open it and further requests are shed at once
    (CircuitOpenError).  ``healthz()`` is the load-balancer probe."""

    def __init__(self, merged_path: str, _shared=None):
        if _shared is not None:
            self._infer, self.feed_names, self.fetch_names, self._state = \
                _shared
        else:
            from . import io
            from .core.executor import Executor
            from .core.types import Place

            exe = Executor(Place("cpu")) if _platform_device() == "cpu" \
                else None
            self._infer, self.feed_names, self.fetch_names = \
                io.load_merged_model(merged_path, exe)
            self._state = _ServingState()
            if os.environ.get("PADDLE_TPU_SERVING_MESH"):
                self.enable_mesh()
        self._feeds: Dict[str, np.ndarray] = {}
        self._outputs: List[np.ndarray] = []
        # per-request latency attribution of the LAST run() of this session
        # (clones are per thread, so this is per request)
        self.last_timing: Optional[Dict] = None

    def clone(self) -> "Session":
        return Session("", _shared=(self._infer, self.feed_names,
                                    self.fetch_names, self._state))

    def feed(self, name: str, buf, dtype: str, shape) -> None:
        self._feeds[name] = np.frombuffer(buf, dtype=dtype).reshape(
            [int(s) for s in shape])

    # ----------------------------------------------------------------- mesh
    def enable_mesh(self, spec=None) -> "Session":
        """Mesh-sharded serving of the artifact: needs
        ``InferenceModel.shard``, which is not ported yet."""
        raise NotImplementedError(
            f"Session.enable_mesh is not ported yet ({_A10}: the "
            f"artifact's mesh hooks, InferenceModel.shard / place_feeds); "
            f"serve the mesh-sharded LM through "
            f"serving.ContinuousDecodeEngine(mesh=)")

    # ---------------------------------------------------------- quantized KV
    def set_kv_dtype(self, kv_dtype: Optional[str]) -> "Session":
        """Declare this session's quantized-KV regime, the kv_dtype of the
        paged decode pool it will serve.  Must run BEFORE
        ``enable_batching`` (the reference stamps it into the bucket
        fingerprints).  Shared across clones; idempotent for an equal
        value."""
        kv = None if kv_dtype in (None, "", "float32") else str(kv_dtype)
        with self._state.lock:
            if self._state.kv_dtype == kv:
                return self
            if self._state.batcher is not None:
                raise RuntimeError(
                    "set_kv_dtype must run before enable_batching: the "
                    "bucket ladder's fingerprints are already minted")
            self._state.kv_dtype = kv
        return self

    # ------------------------------------------------------------- batching
    def enable_batching(self, max_batch_size: int = 16,
                        max_queue_delay_ms: float = 2.0,
                        buckets=None, warm: bool = True,
                        warm_background: bool = False,
                        compile_dir: Optional[str] = None,
                        recompile_budget: int = 0,
                        recompile_policy: str = "warn") -> "Session":
        """Route this model's ``run`` calls through the dynamic micro-batcher
        (``serving.DynamicBatcher``): concurrent requests coalesce into one
        padded device batch per (max_batch_size, max_queue_delay_ms)
        window.  Shared across clones.

        Warmup: every bucket's signature is prepared through the warmup
        orchestrator (``compile.Warmup``) in priority order (the in-memory
        manifest's hottest first, then the ladder smallest first), and
        admission gates per bucket.  ``warm=True`` blocks until the ladder
        is warm; ``warm_background=True`` returns at once.  A failed warm
        task grants readiness and the batch's own call captures live (and
        raises if that fails again).  The recompile-storm guard arms when
        warmup completes.  A fixed-shape artifact degrades to its single
        ``example_batch`` bucket.  ``compile_dir`` (the AOT store) raises:
        ROADMAP A.10.  Idempotent; returns self."""
        from . import compile as _compile
        from .serving import BatchPolicy, DynamicBatcher

        cdir = compile_dir or _compile.default_compile_dir()
        if cdir:
            raise NotImplementedError(
                f"Session.enable_batching(compile_dir=...) needs the AOT "
                f"store, which is not ported yet ({_A10}: compile/aot.py); "
                f"unset {_compile.COMPILE_DIR_ENV} to warm by capture")
        with self._state.lock:
            if self._state.batcher is not None:
                return self
            if not self._infer.symbolic_batch:
                # fixed-shape artifact: every call is example_batch rows
                buckets = [self._infer.example_batch]
                max_batch_size = self._infer.example_batch
            policy = BatchPolicy(max_batch_size=max_batch_size,
                                 max_queue_delay_ms=max_queue_delay_ms,
                                 buckets=buckets)
            infer = self._infer

            def runner(feeds):
                faults.check("serving.run")
                return [np.ascontiguousarray(o) for o in infer(feeds)]

            manifest = _compile.ShapeManifest()
            guard = _compile.RecompileGuard(
                infer.trace_count, budget=recompile_budget,
                policy=recompile_policy, name="serving")
            warmup = None
            specs = infer.feed_specs
            if warm and specs:
                ladder = policy.resolve_buckets()
                hot = [b for b in manifest.buckets() if b in ladder]
                order = hot + [b for b in sorted(ladder) if b not in hot]
                _compile.warmup.mark_start(bool(hot))
                warmup = _compile.Warmup(
                    name="serving",
                    on_complete=lambda w: guard.mark_steady())
                for i, b in enumerate(order):
                    warmup.add(f"bucket:{b}",
                               lambda rows=b: self._warm_bucket(
                                   self._bucket_feeds(rows)),
                               priority=float(i))
                warmup.start()
            else:
                # no warmup phase: arm the guard at once
                guard.mark_steady()
            batcher = DynamicBatcher(
                runner, policy=policy, readiness=warmup, manifest=manifest,
                guard=guard, sig_prefix=infer.sig_prefix,
                device=infer.device)
            self._state.batcher = batcher
            self._state.warmup = warmup
            self._state.recompile_guard = guard
            self._state.compile_manifest = manifest
        if warmup is not None and not warm_background:
            warmup.wait_all()
        return self

    def _bucket_feeds(self, rows: int) -> Dict[str, np.ndarray]:
        """Zero feeds of ``rows`` batch rows, the warm call's inputs."""
        specs = self._infer.feed_specs
        return {n: np.zeros([rows] + [int(d) for d in specs[n]["shape"][1:]],
                            specs[n]["dtype"])
                for n in self.feed_names}

    def _warm_bucket(self, feeds) -> str:
        """Prepare one bucket's signature: one call of the model at the
        bucket's rows (its capture on the card).  The reference's AOT load
        path (``store``) is ROADMAP A.10."""
        self._infer(feeds)
        return "compiled"

    def attach_decode(self, scheduler) -> "Session":
        """Register a continuous decode scheduler
        (``serving.ContinuousScheduler``) with this session's health state:
        ``healthz()`` then carries its stats and folds its load into the
        top-level ``queue_depth``.  A scheduler over a QUANTIZED pool must
        have been declared through ``set_kv_dtype`` before batching was
        enabled (attaching first declares it).  Shared across clones.
        Idempotent; returns self."""
        pool = getattr(getattr(scheduler, "eng", None), "pool", None)
        kv = (str(pool.kv_dtype)
              if getattr(pool, "quantized", False) else None)
        with self._state.lock:
            if kv != self._state.kv_dtype:
                if self._state.batcher is not None:
                    raise RuntimeError(
                        f"attach_decode: scheduler pool kv_dtype={kv!r} but "
                        f"this session's bucket ladder was declared as "
                        f"kv_dtype={self._state.kv_dtype!r}; call "
                        f"set_kv_dtype before enable_batching")
                self._state.kv_dtype = kv
            self._state.decode = scheduler
        return self

    def _infer_once(self) -> List[np.ndarray]:
        faults.check("serving.run")
        return [np.ascontiguousarray(o) for o in self._infer(self._feeds)]

    def run(self, deadline_s: Optional[float] = None, trace=None) -> int:
        """Execute the model on the current feeds; returns the output count.

        ``deadline_s``: per-request budget.  An already-expired deadline is
        shed before touching the backend; a run that finishes past it
        raises DeadlineExceeded.  Both count against the healthz error
        rate but NOT the circuit breaker.  With batching the call is
        coalesced with concurrent clients; every semantic above holds PER
        REQUEST (an expired deadline sheds before admission, a poisoned
        batch degrades to per-request isolation).

        ``trace``: optional propagated trace context (an object with
        ``trace_id`` / ``parent``); it tags this request's retroactive
        ``serving.queue_wait`` / ``serving.exec`` spans when tracing is on.
        Every run fills ``self.last_timing``."""
        from . import profiler
        from .serving import AdmissionShed

        self.last_timing = None
        self._state.breaker.allow()  # raises CircuitOpenError when open
        dl = Deadline(deadline_s) if deadline_s is not None else None
        if dl is not None and dl.expired():
            profiler.incr("resilience.shed")
            self._state.record_shed()
            raise DeadlineExceeded("request deadline expired before dispatch")
        batcher = self._state.batcher
        tinfo: Dict = {"retries": 0}

        def direct():
            te0 = time.perf_counter()
            outs = self._infer_once()
            tinfo["t_exec0"] = te0
            tinfo["t_exec1"] = time.perf_counter()
            tinfo["exec_ms"] = (tinfo["t_exec1"] - te0) * 1e3
            return outs

        call = (direct if batcher is None
                else lambda: batcher.submit(self._feeds, deadline=dl,
                                            timing=tinfo))
        t0 = time.perf_counter()
        with self._state.lock:
            self._state.in_flight += 1
        try:
            try:
                try:
                    outs = call()
                except TransientError:
                    if dl is not None and dl.expired():
                        raise  # the client gave up: no second inference
                    profiler.incr("resilience.retries")
                    tinfo["retries"] += 1
                    outs = call()
            except AdmissionShed:
                # expired while queued for a batch: the backend never saw it
                profiler.incr("resilience.shed")
                self._state.record_shed((time.perf_counter() - t0) * 1e3)
                raise
            except BaseException:
                self._state.record(False, (time.perf_counter() - t0) * 1e3)
                raise
        finally:
            with self._state.lock:
                self._state.in_flight -= 1
        latency_ms = (time.perf_counter() - t0) * 1e3
        self.last_timing = {
            "queue_ms": round(float(tinfo.get("queue_ms", 0.0)), 3),
            "exec_ms": round(float(tinfo.get("exec_ms", 0.0)), 3),
            "worker_ms": round(latency_ms, 3),
            "rows": tinfo.get("rows"),
            "bucket": tinfo.get("bucket"),
            "pad_rows": int(tinfo.get("pad_rows", 0) or 0),
            "retries": int(tinfo.get("retries", 0)),
        }
        if trace is not None and _trace.enabled():
            tid = getattr(trace, "trace_id", None)
            parent = getattr(trace, "parent", None) or None
            if "t_queue0" in tinfo and "t_exec0" in tinfo:
                _trace.record_at("serving.queue_wait", tinfo["t_queue0"],
                                 tinfo["t_exec0"] - tinfo["t_queue0"],
                                 trace_id=tid, parent=parent,
                                 bucket=tinfo.get("bucket"))
            if "t_exec0" in tinfo and "t_exec1" in tinfo:
                _trace.record_at("serving.exec", tinfo["t_exec0"],
                                 tinfo["t_exec1"] - tinfo["t_exec0"],
                                 trace_id=tid, parent=parent,
                                 bucket=tinfo.get("bucket"),
                                 pad_rows=tinfo.get("pad_rows", 0))
        if dl is not None and dl.expired():
            profiler.incr("resilience.deadline_missed")
            # the BACKEND succeeded: reset its failure streak; the request
            # still counts as an error for the client-facing error rate
            self._state.breaker.record_success()
            self._state.record_shed(latency_ms)
            raise DeadlineExceeded(
                f"request completed in {latency_ms:.1f}ms, past its deadline")
        self._outputs = outs
        self._state.record(True, latency_ms)
        return len(self._outputs)

    def output(self, i: int):
        a = self._outputs[i]
        return a.tobytes(), str(a.dtype), list(a.shape)

    def healthz(self) -> Dict:
        """Serving health signal: model loaded, circuit state, load (in
        flight, queue depth: the batcher's queue plus the decode
        scheduler's waiting and active slots), error rate, the batching
        stats, the decode scheduler's stats, the compile side, the
        hotspots, the metrics snapshot, and the restart facts of the
        supervisor's env contract (``restarts``, ``supervised``) with
        ``epochs`` (the ``train.epochs`` counter of a colocated trainer).
        The reference's keys."""
        from . import compile as _compile
        from . import profiler
        from .obs import metrics as _obs_metrics
        from .obs import prof as _obs_prof
        from .resilience import cluster as _cluster

        s = self._state
        with s.lock:
            circuit = s.breaker.state
            s.healthz_seq += 1
            hz = {
                "restarts": _cluster.restart_count(),
                "supervised": _cluster.under_supervisor(),
                "epochs": profiler.counter("train.epochs"),
                "model_loaded": self._infer is not None,
                "pid": os.getpid(),
                # monotonic per process: a router seeing it REGRESS knows
                # the process behind the port restarted between two polls
                "healthz_seq": s.healthz_seq,
                "in_flight": s.in_flight,
                "queue_depth": 0,
                "circuit": circuit,
                # half_open counts as ok: the probe traffic that closes the
                # breaker has to come from somewhere
                "ok": self._infer is not None and circuit != "open",
                "requests": s.requests,
                "errors": s.errors,
                "error_rate": s.errors / max(s.requests, 1),
                "last_latency_ms": s.last_latency_ms,
                "batching": None,
                "mesh": None,
            }
            batcher = s.batcher
            decode = s.decode
        if batcher is not None:
            # outside s.lock: the batcher has its own lock and thread
            b = batcher.stats()
            b["jit_traces"] = self._infer.trace_count()
            hz["batching"] = b
            hz["queue_depth"] = int(b.get("queue_depth", 0))
        if decode is not None:
            # a lock-free snapshot read: a probe never waits behind a step
            d = decode.stats()
            hz["decode"] = d
            hz["queue_depth"] += int(d.get("waiting", 0)) + int(
                d.get("slots_active", 0))
            if d.get("broken") or d.get("closed"):
                # a closed scheduler reports zero load; stop advertising ok
                # so the fleet pulls the instance
                hz["ok"] = False
            if d.get("kv_dtype"):
                hz["kv"] = {
                    "kv_dtype": d.get("kv_dtype"),
                    "bytes_per_token": d.get("kv_bytes_per_token"),
                    "slots_resident_per_gib": d.get("kv_slots_per_gib"),
                }
            if d.get("prefix"):
                # reclaimable cached blocks are capacity, not load: never
                # folded into queue_depth
                p = d["prefix"]
                hz["prefix_cache"] = {
                    "hit_rate": p.get("hit_rate"),
                    "hit_tokens": p.get("hit_tokens"),
                    "cached_blocks": p.get("cached_blocks"),
                    "reclaimable_blocks": d.get("blocks_reclaimable"),
                }
        comp = _compile.health()
        if s.warmup is not None:
            comp["warmup"] = {**s.warmup.summary(),
                              "tasks_detail": s.warmup.status()}
        if s.recompile_guard is not None:
            comp["guard"] = s.recompile_guard.stats()
        hz["compile"] = comp
        # attribution, never load: built from lock-free snapshots
        hz["hotspots"] = _obs_prof.hotspots_snapshot(top=5)
        hz["metrics"] = _obs_metrics.snapshot()
        return hz


def load(path: str) -> Session:
    return Session(path)

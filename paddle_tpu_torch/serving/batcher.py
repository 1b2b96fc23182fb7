"""Request coalescing and decode admission (the port's copy of
``paddle_tpu/serving/batcher.py``): the bucket ladder helpers, the
length-tiered ``DecodeAdmissionQueue`` of the streaming decode loop with
its deadline shed and aging guard, and the ``DynamicBatcher``: many
concurrent ``Session.run`` calls, one device batch.

Orca-style dynamic batching scoped to the request level: a client thread
enqueues its feed rows and blocks; the scheduler thread admits queued
requests into a batch once ``max_batch_size`` rows are waiting OR the
oldest request has waited ``max_queue_delay_ms``, whichever comes first.
The batch is padded up to the nearest bucket (each bucket's signature is
prepared at load time by the warmup), run once, and the output rows are
sliced back per request.  The runner is any callable over numpy feeds; in
the Session it is the port's ``io.InferenceModel``, whose graphs another
thread may have captured (the batcher thread sets the model's device
before its first call).

Resilience contract (kept from the unbatched path, see
``capi_server.Session``):
  * a request whose deadline expired while queued is shed BEFORE admission
    (AdmissionShed, a DeadlineExceeded): it never occupies batch rows and
    never touches the backend;
  * a backend failure on a coalesced batch does NOT fail the batch-mates:
    the batch degrades to per-request execution, so only the poisoned
    request's submitter sees its error;
  * the batcher itself never retries: retry-once-on-transient stays at the
    Session layer, per request, exactly as unbatched.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import events as _events
from .. import profiler as _profiler
from ..obs import metrics as _metrics
from ..obs import prof as _prof
from ..obs import trace as _trace
from ..resilience import DeadlineExceeded


class AdmissionShed(DeadlineExceeded):
    """Request deadline expired while queued: shed before admission, before
    any slot or KV block was spent on it."""


def build_bucket_ladder(max_size: int, buckets: Optional[Sequence[int]] = None,
                        base: int = 1) -> List[int]:
    """Explicit ``buckets`` verbatim (sorted, deduplicated), else powers of
    two from ``base`` up to AND INCLUDING ``max_size``."""
    if buckets:
        return sorted(set(int(b) for b in buckets))
    out, b = [], base
    while b < max_size:
        out.append(b)
        b *= 2
    out.append(int(max_size))
    return sorted(set(out))


def bucket_for(ladder: Sequence[int], n: int, *, oversize_exact: bool = False,
               what: str = "batch rows") -> int:
    """Smallest bucket >= n.  Oversize either runs at its exact size
    (``oversize_exact``, one extra capture) or is a ValueError."""
    for b in ladder:
        if b >= n:
            return b
    if oversize_exact:
        return n
    top = ladder[-1] if ladder else 0
    raise ValueError(f"{what} {n} exceeds largest bucket {top}")


class DecodeAdmissionQueue:
    """Waiting room of the continuous decode loop.

      * deadline-expired waiters are shed before a slot or a KV block is
        spent on them (``shed_expired``);
      * admission is LENGTH-TIERED: when several waiters fit, the shortest
        prompt tier (by the bucket ladder) admits first;
      * an AGING GUARD bounds the tiering: once the oldest waiter has waited
        past ``max_wait_ms``, only the oldest is eligible (strict FIFO), so a
        long prompt is never starved by a stream of short ones;
      * with ``effective_len`` (cache-aware admission) the tiering keys on
        what a request would cost to prefill now, its unshared tail after
        the prefix-cache match, so a long prompt whose prefix is cached
        admits with the short ones.
    """

    def __init__(self, prompt_buckets: Sequence[int],
                 max_wait_ms: float = 200.0,
                 effective_len: Optional[Callable] = None):
        self._ladder = sorted(int(b) for b in prompt_buckets)
        self.max_wait_ms = float(max_wait_ms)
        self.effective_len = effective_len
        self._q: List = []  # DecodeRequest-shaped, arrival order

    def __len__(self) -> int:
        return len(self._q)

    def _tier(self, req) -> int:
        n = (req.prompt_len if self.effective_len is None
             else self.effective_len(req))
        for b in self._ladder:
            if b >= n:
                return b
        return n  # oversize: its own tier, last

    def push(self, req) -> None:
        req.enqueued_at = time.monotonic()
        self._q.append(req)

    def requeue(self, req) -> None:
        """Re-admit WITHOUT restamping the enqueue time: a preempted request
        keeps the aging credit it already earned."""
        self._q.append(req)

    def shed_expired(self) -> List:
        """Remove and return every waiter whose deadline already expired."""
        shed = [r for r in self._q
                if r.deadline is not None and r.deadline.expired()]
        if shed:
            self._q = [r for r in self._q if r not in shed]
        return shed

    def pop(self, fits: Optional[Callable] = None):
        """Next admissible waiter under the tiered policy, or None.  ``fits``
        says whether the scheduler can seat a request right now; under the
        aging guard only the oldest waiter is eligible."""
        if not self._q:
            return None
        oldest = self._q[0]
        if (time.monotonic() - oldest.enqueued_at) * 1e3 > self.max_wait_ms:
            if fits is None or fits(oldest):
                self._q.pop(0)
                return oldest
            return None  # head-of-line holds its turn until it fits
        for req in sorted(self._q,
                          key=lambda r: (self._tier(r), r.enqueued_at)):
            if fits is None or fits(req):
                self._q.remove(req)
                return req
        return None

    def drain(self) -> List:
        out, self._q = self._q, []
        return out


@dataclass
class BatchPolicy:
    """(max_batch_size, max_queue_delay_ms) coalescing policy + the bucket
    ladder requests are padded onto.  Buckets default to powers of two up to
    max_batch_size — small enough a lone request doesn't pay 16x pad waste,
    few enough that warmup compiles stay cheap."""
    max_batch_size: int = 16
    max_queue_delay_ms: float = 2.0
    buckets: Optional[Sequence[int]] = None

    def resolve_buckets(self) -> List[int]:
        return build_bucket_ladder(self.max_batch_size, self.buckets)


class _Request:
    __slots__ = ("feeds", "rows", "deadline", "done", "outputs", "error",
                 "enqueued_at", "timing")

    def __init__(self, feeds, rows, deadline, timing=None):
        self.feeds = feeds
        self.rows = rows
        self.deadline = deadline  # resilience.Deadline or None
        self.done = threading.Event()
        self.outputs = None
        self.error = None
        self.enqueued_at = time.monotonic()
        # optional caller-owned dict the scheduler fills with this request's
        # latency attribution: queue_ms, exec_ms, bucket, pad_rows, plus the
        # raw perf_counter stamps (t_queue0/t_exec0/t_exec1) a tracing
        # caller needs to emit retroactive per-request spans
        self.timing = timing
        if timing is not None:
            timing["t_queue0"] = time.perf_counter()


@dataclass
class BatchStats:
    """Aggregates the scheduler maintains under its lock; ``snapshot`` is the
    healthz/profiler view."""
    batches: int = 0
    requests: int = 0
    rows: int = 0
    padded_rows: int = 0
    sheds: int = 0
    isolation_reruns: int = 0
    occupancy_sum: float = field(default=0.0)

    def snapshot(self, queue_depth: int) -> Dict:
        return {
            "queue_depth": queue_depth,
            "batches": self.batches,
            "batched_requests": self.requests,
            "avg_batch_rows": self.rows / max(self.batches, 1),
            "avg_requests_per_batch": self.requests / max(self.batches, 1),
            "occupancy": self.occupancy_sum / max(self.batches, 1),
            "pad_waste": 1.0 - self.rows / max(self.padded_rows, 1),
            "batch_sheds": self.sheds,
            "isolation_reruns": self.isolation_reruns,
        }


class DynamicBatcher:
    """Coalesce concurrent feed-dict requests into padded device batches.

    ``runner``: callable(feeds: Dict[str, np.ndarray]) -> List[np.ndarray],
    batch-major along axis 0 for every feed and every output (the loaded
    inference callable).  ``submit`` blocks the calling thread until its rows
    are served (or its error is known) — it is the drop-in replacement for the
    direct backend call inside Session.run.
    """

    def __init__(self, runner: Callable, policy: Optional[BatchPolicy] = None,
                 on_batch: Optional[Callable] = None, readiness=None,
                 manifest=None, guard=None, model_name: str = "serving",
                 sig_prefix: Optional[str] = None, device=None):
        self.runner = runner
        # the runner's card: the scheduler thread makes it current before
        # its first call (a CUDA graph replays on the device it was
        # captured on, possibly by another thread); a bare "cuda" is the
        # constructing thread's current card
        self.device = None
        if device is not None and str(device).startswith("cuda"):
            import torch

            dev = torch.device(device)
            self.device = (dev.index if dev.index is not None
                           else torch.cuda.current_device())
        self.policy = policy or BatchPolicy()
        self.buckets = self.policy.resolve_buckets()
        self.on_batch = on_batch
        # dispatch-timing signature prefix: the session passes
        # "serving_bucket:<artifact_hash[:8]>" so two models served from one
        # process keep distinct timing rows; merged rows would join one
        # model's time with the other model's ledger intensity
        self.sig_prefix = sig_prefix or "serving_bucket"
        # compile subsystem hooks, all optional:
        #   readiness  a compile.Warmup — admission gates per bucket: a batch
        #              whose bucket is still warming waits for THAT bucket
        #              (bounded; a failed/absent warm degrades to an inline
        #              capture), instead of all buckets blocking all traffic
        #   manifest   a compile.ShapeManifest — records every executed
        #              bucket with hit counts, so the next generation warms
        #              hottest-first
        #   guard      a compile.RecompileGuard — attributes steady-state
        #              captures to the bucket that triggered them; under
        #              policy='raise' the breach fails subsequent submits
        #              (canary semantics), never the batch that surfaced it
        self.readiness = readiness
        self.manifest = manifest
        self.guard = guard
        self.model_name = model_name
        self._storm_error: Optional[BaseException] = None
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._stop = False
        self._stats = BatchStats()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-batcher")
        self._thread.start()

    # ------------------------------------------------------------------ API
    def warm(self, make_feeds: Callable[[int], Dict[str, np.ndarray]]) -> int:
        """Prepare every bucket (``make_feeds(batch_rows)`` synthesizes a
        feed dict) so mixed request shapes never capture on the hot path.
        Returns the number of buckets warmed."""
        for b in self.buckets:
            self.runner(make_feeds(b))
        return len(self.buckets)

    def submit(self, feeds: Dict[str, np.ndarray], deadline=None,
               timing=None) -> List[np.ndarray]:
        """Coalesce one request.  ``timing`` (optional dict) receives this
        request's attribution — queue_ms/exec_ms/bucket/pad_rows and the
        perf_counter stamps behind them — filled before the call returns;
        the cost when passed is a handful of dict writes per request."""
        rows = int(next(iter(feeds.values())).shape[0]) if feeds else 1
        req = _Request(feeds, rows, deadline, timing=timing)
        if self._storm_error is not None:
            # recompile budget breached under policy='raise': fail fast at
            # the door rather than keep burning compiles on the hot path
            raise self._storm_error
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher is closed")
            self._queue.append(req)
            _profiler.gauge("serving.queue_depth", len(self._queue))
            self._cv.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.outputs

    def stats(self) -> Dict:
        with self._cv:
            return self._stats.snapshot(len(self._queue))

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        if self.manifest is not None:
            self.manifest.save()  # bucket heat survives for the next warm
        if self.readiness is not None:
            self.readiness.close()  # warm worker drains its queue and exits
        # take the leftover queue UNDER the lock: each request is then owned
        # by exactly one side — popped by the scheduler (which completes it)
        # or claimed here — even when the join timed out on a hung runner
        with self._cv:
            leftover, self._queue = self._queue, []
        for req in leftover:
            req.error = RuntimeError("batcher closed")
            req.done.set()

    # ------------------------------------------------------------ scheduler
    def _loop(self):
        if self.device is not None:
            import torch

            torch.cuda.set_device(self.device)
        while True:
            batch = self._gather()
            if batch is None:
                return
            if not batch:
                continue
            try:
                self._execute(batch)
            except BaseException as exc:  # noqa: BLE001
                # the scheduler thread must survive ANYTHING — a dead
                # scheduler turns one bad request into a permanent hang for
                # every current and future submitter.  Whatever slipped past
                # _execute's own handling fails the admitted requests only.
                for req in batch:
                    if not req.done.is_set():
                        req.error = exc
                        req.done.set()

    def _gather(self) -> Optional[List[_Request]]:
        """Block until a batch is due under the (max_batch_size,
        max_queue_delay_ms) policy; shed expired requests; pop the admitted
        window.  None = shutdown."""
        max_rows = self.policy.max_batch_size
        delay_s = self.policy.max_queue_delay_ms / 1e3
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait()
            if self._stop:
                return None
            close_at = self._queue[0].enqueued_at + delay_s
            while (sum(r.rows for r in self._queue) < max_rows
                   and not self._stop):
                left = close_at - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(timeout=left)
                if not self._queue:
                    # everything ahead was drained by a close(); start over
                    return []
            admitted: List[_Request] = []
            taken_rows = 0
            rest: List[_Request] = []
            for req in self._queue:
                # deadline check at ADMISSION time: a request that expired
                # while queued must not occupy batch rows
                if req.deadline is not None and req.deadline.expired():
                    req.error = AdmissionShed(
                        "request deadline expired while queued for batching")
                    self._stats.sheds += 1
                    _profiler.incr("serving.batch_sheds")
                    req.done.set()
                    continue
                if admitted and taken_rows + req.rows > max_rows:
                    rest.append(req)
                    continue
                admitted.append(req)
                taken_rows += req.rows
            self._queue = rest
            _profiler.gauge("serving.queue_depth", len(self._queue))
            return admitted

    # ------------------------------------------------------------ execution
    def _bucket_for(self, rows: int) -> int:
        # oversize requests run at their exact shape (captured once)
        return bucket_for(self.buckets, rows, oversize_exact=True)

    def _pad_feeds(self, admitted: List[_Request], bucket: int, rows: int):
        names = list(admitted[0].feeds)
        feeds = {}
        for n in names:
            parts = [np.asarray(r.feeds[n]) for r in admitted]
            cat = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
            if bucket > rows:
                # pad with copies of the first row: real-data values keep any
                # value-sensitive model numerics (log/softmax/embedding
                # lookups) in-range, unlike zeros
                pad = np.broadcast_to(cat[:1], (bucket - rows,) + cat.shape[1:])
                cat = np.concatenate([cat, pad], axis=0)
            feeds[n] = cat
        return feeds

    def _execute(self, admitted: List[_Request]):
        rows = sum(r.rows for r in admitted)
        bucket = self._bucket_for(rows)
        if self.readiness is not None:
            # per-bucket admission gate: wait only for THIS bucket's warm
            # task (it jumps the warm queue), never for the whole ladder.
            # Bounded — and a failed/unknown task grants readiness — so the
            # worst case is the inline compile this batch would have paid
            # anyway, minus the duplicate when warmup already started it.
            self.readiness.require(f"bucket:{bucket}")
        wait_ms = (time.monotonic() - admitted[0].enqueued_at) * 1e3
        _metrics.histogram("serving.queue_wait_ms").observe(wait_ms)
        t_exec = time.monotonic()
        t_exec0 = time.perf_counter()
        try:
            # padding inside the try too: mismatched trailing dims or feed
            # names across coalesced requests fail here, and the isolation
            # path below still serves every internally-consistent request
            feeds = self._pad_feeds(admitted, bucket, rows)
            # sampled dispatch timing: every Nth batch per bucket is timed;
            # the runner returns host arrays (its copy to the host waits for
            # the device), so the wall below includes device time.  The key
            # joins the ledger entry InferenceModel registers when it
            # prepares this model's bucket.
            t_prof = _prof.tick(f"{self.sig_prefix}:{bucket}")
            with _trace.span("serving.batch_exec", rows=rows, bucket=bucket,
                             requests=len(admitted)):
                outs = self.runner(feeds)
            if t_prof is not None:
                _prof.tock(f"{self.sig_prefix}:{bucket}", t_prof)
        except BaseException:
            self._isolate(admitted)
            return
        _metrics.histogram("serving.batch_exec_ms").observe(
            (time.monotonic() - t_exec) * 1e3)
        self._fill_timing(admitted, bucket, rows, t_exec0,
                          time.perf_counter())
        self._scatter(admitted, outs, rows, bucket)
        with self._cv:
            self._stats.batches += 1
            self._stats.requests += len(admitted)
            self._stats.rows += rows
            self._stats.padded_rows += bucket
            self._stats.occupancy_sum += rows / bucket
            depth = len(self._queue)
        _profiler.incr("serving.batches")
        _profiler.incr("serving.batched_requests", len(admitted))
        _profiler.incr("serving.pad_rows", bucket - rows)
        _profiler.gauge("serving.batch_occupancy", rows / bucket)
        if self.manifest is not None:
            from ..compile import manifest as _cmanifest

            self.manifest.record(_cmanifest.SERVING_BUCKET, self.model_name,
                                 bucket=bucket)
            if self._stats.batches % 64 == 0:
                self.manifest.save()  # no-op for an in-memory manifest
        if self.guard is not None:
            try:
                # after scatter: the batch that SURFACED a storm was already
                # served; the breach fails the door (submit), not its finder
                self.guard.check(f"bucket:{bucket}")
            except BaseException as e:  # RecompileBudgetExceeded under 'raise'
                self._storm_error = e
        if self.on_batch is not None:
            self.on_batch(_events.ServingBatchExecuted(
                rows=rows, bucket=bucket, requests=len(admitted),
                queue_depth=depth, wait_ms=wait_ms))

    @staticmethod
    def _fill_timing(admitted: List[_Request], bucket: int, rows: int,
                     t_exec0: float, t_exec1: float) -> None:
        """Per-request latency attribution (only for requests that passed a
        ``timing`` dict): queue wait is THIS request's enqueue -> exec start
        (readiness/warm gating included — that wait is real), exec and pad
        waste are the batch's (the request rode that batch, so it paid
        them)."""
        exec_ms = (t_exec1 - t_exec0) * 1e3
        for req in admitted:
            t = req.timing
            if t is None:
                continue
            t["t_exec0"] = t_exec0
            t["t_exec1"] = t_exec1
            t["queue_ms"] = max(
                (t_exec0 - t.get("t_queue0", t_exec0)) * 1e3, 0.0)
            t["exec_ms"] = exec_ms
            t["bucket"] = bucket
            t["rows"] = req.rows
            t["batch_rows"] = rows
            t["pad_rows"] = bucket - rows

    def _scatter(self, admitted: List[_Request], outs, rows: int, bucket: int):
        off = 0
        for req in admitted:
            sliced = []
            for o in outs:
                o = np.asarray(o)
                if o.ndim >= 1 and o.shape[0] == bucket:
                    sliced.append(np.ascontiguousarray(o[off:off + req.rows]))
                else:
                    # non-batch-major fetch (scalar metric, reduced stat):
                    # every request sees the whole thing, as documented
                    sliced.append(o)
            req.outputs = sliced
            req.error = None
            off += req.rows
            req.done.set()

    def _isolate(self, admitted: List[_Request]):
        """The coalesced batch failed: degrade to per-request execution so a
        poisoned request cannot fail its batch-mates.  Each request runs alone
        (padded to its own bucket); its outcome — success or ITS error —
        propagates to its own submitter only."""
        with self._cv:
            self._stats.isolation_reruns += 1
        _profiler.incr("serving.isolation_reruns")
        for req in admitted:
            if req.deadline is not None and req.deadline.expired():
                req.error = AdmissionShed(
                    "request deadline expired during batch isolation rerun")
                with self._cv:
                    self._stats.sheds += 1
                _profiler.incr("serving.batch_sheds")
                req.done.set()
                continue
            bucket = self._bucket_for(req.rows)
            t0p = time.perf_counter()
            try:
                with _trace.span("serving.isolation_rerun", rows=req.rows,
                                 bucket=bucket):
                    outs = self.runner(self._pad_feeds([req], bucket, req.rows))
            except BaseException as exc:  # noqa: BLE001 — belongs to the client
                # padding and backend errors alike: this request's problem only
                req.error = exc
                req.done.set()
                continue
            self._fill_timing([req], bucket, req.rows, t0p,
                              time.perf_counter())
            self._scatter([req], outs, req.rows, bucket)
            with self._cv:
                self._stats.batches += 1
                self._stats.requests += 1
                self._stats.rows += req.rows
                self._stats.padded_rows += bucket
                self._stats.occupancy_sum += req.rows / bucket

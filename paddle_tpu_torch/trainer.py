"""Trainers (PyTorch port of ``paddle_tpu/trainer.py``): the v2-style
``Trainer``, the pass / batch event loop (ref: python/paddle/v2/trainer.py:24
``class SGD``; Trainer.cpp:265 ``Trainer::train``), and
``SparseEmbeddingTrainer``, which trains the sparse embedding engine.

``Trainer`` wraps the Program / Executor machinery: reader -> DataFeeder ->
``DeviceFeeder`` (asynchronous staging on the device) -> the step, with
events to a callback, periodic checkpoints (``io.CheckpointManager``),
resume, the anomaly guard's skip and rollback, preemption and hang
handling (``resilience.cluster``) and ``test()`` over an eval reader.

The reference compiles each new step signature on its first run.  The
port warms it instead (``Executor.warm``, before its first batch), so that
every step of a signature after that replays one CUDA graph; a program
that ``check_capturable`` refuses (a host read every run: ``cond``, an
unbounded ``while_loop``, ``Print``), and any step under a Strategy, runs
eagerly, their documented path.  ``recompile_guard`` watches the captures
(``Executor.compiles``) past the first synced step.  The loop counts and
times itself with the reference's names (``train.epochs``,
``train.steps``, ``train.step_ms``, ``train.data_wait_ms``,
``train.fetch_ms``, the ``resilience.*`` recovery counters; spans
``train.data_wait``, ``train.step``, ``train.fetch``,
``train.checkpoint``), records every step in the flight recorder and dumps
a postmortem before a rollback and a preemption exit.  The reference's
compile store, warm start and ``prepare()`` (``compile_dir``) are ROADMAP
A.10.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import events as _events
from . import profiler as _profiler
from .compile import guard as _guard
from .core.executor import (Executor, Scope, _to_numpy, check_capturable,
                            global_scope)
from .core.graphs import Graphs, Staged, WarmError
from .core.program import Variable, default_startup_program
from .core.types import dtype_name
from .data_feeder import DataFeeder, DeviceFeeder
from .io import CheckpointCorrupt, CheckpointManager
from .obs import metrics as _metrics
from .obs import recorder as _recorder
from .obs import trace as _trace
from .resilience import cluster as _cluster
from .resilience import faults


class AnomalyBudgetExceeded(RuntimeError):
    """Anomalous (non-finite) steps persisted past the budget and past
    ``max_rollbacks`` checkpoint rollbacks: the data or the model is
    systematically broken; refusing to spin forever."""


def _scalar(t) -> float:
    return float(_to_numpy(torch.as_tensor(t)).ravel()[0])


class Trainer:
    """The pass / batch loop over ``cost``'s program (``optimizer.minimize``
    runs here).  Arguments as the reference's, plus ``place``: the
    Executor's (the CUDA card unless given ``CPUPlace()``).

    ``checkpoint_dir`` / ``checkpoint_every_n_steps``: a checkpoint (with
    ``extra={"pass_id", "batch_id"}``) every N steps and one at the end;
    ``train(resume=True)`` restores the newest intact one first.
    ``anomaly_guard``: the program's on-device guard (a step whose loss or
    any gradient is not finite keeps the old state and fetches a NaN
    loss); the loop skips such a batch (``AnomalyDetected``), rolls back to
    the newest intact checkpoint past ``anomaly_budget`` consecutive ones
    and replays the pass, and raises ``AnomalyBudgetExceeded`` past
    ``max_rollbacks``.  ``task_queue``: any object with the reference's
    ``snapshot(path)``, ``rewind(path)`` and ``new_epoch()``; its snapshot
    (``queue_snapshot_path``) rides with every checkpoint, and a rollback
    rewinds it to the one paired with the restored checkpoint.
    ``handle_preemption``: SIGTERM / SIGINT drain (finish the staged
    batches, checkpoint, exit ``EXIT_PREEMPTED``); ``hang_timeout_s``: the
    watchdog.  ``compile_dir`` (the reference's compile store) raises, and
    its ``warm_start`` is not taken: ROADMAP A.10."""

    def __init__(
        self,
        cost: Variable,
        optimizer,
        feed_list: Sequence[Variable],
        extra_fetch: Optional[Dict[str, Variable]] = None,
        strategy=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_n_steps: int = 1000,
        prefetch_depth: int = 2,
        task_queue=None,
        queue_snapshot_path: Optional[str] = None,
        anomaly_guard: bool = True,
        anomaly_budget: int = 3,
        max_rollbacks: int = 2,
        hang_timeout_s: Optional[float] = None,
        handle_preemption: bool = True,
        log_every: int = 1,
        compile_dir: Optional[str] = None,
        recompile_budget: int = 4,
        recompile_policy: str = "warn",
        place=None,
    ):
        if compile_dir is not None:
            raise NotImplementedError(
                "Trainer(compile_dir=...): the compile store, its manifest "
                "and the warm start are not ported yet (ROADMAP A.10); each "
                "new step signature is warmed in process")
        self.cost = cost
        self.program = cost.program
        optimizer.minimize(cost)
        self.test_program = self.program.clone(for_test=True)
        self.feed_vars = list(feed_list)
        self.extra_fetch = dict(extra_fetch or {})
        self.strategy = strategy
        self.exe = Executor(place, strategy=strategy)
        self.feeder = DataFeeder(self.feed_vars)
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        self.ckpt_every = checkpoint_every_n_steps
        self.prefetch_depth = prefetch_depth
        self.global_step = 0
        # the queue's snapshot rides with every checkpoint, so that a
        # restart resumes the weights AND the dataset position
        self.task_queue = task_queue
        self.queue_snapshot_path = queue_snapshot_path
        self.anomaly_guard = anomaly_guard
        self.anomaly_budget = anomaly_budget
        self.max_rollbacks = max_rollbacks
        self.hang_timeout_s = hang_timeout_s
        self.handle_preemption = handle_preemption
        # fetching the cost to the host every step is a sync: log_every=N
        # syncs every Nth step (and the pass's last); EndIteration and the
        # host-side anomaly budget run there, while the on-device guard
        # still keeps every poisoned update out
        self.log_every = max(1, int(log_every))
        self._preempt: Optional[_cluster.PreemptionGuard] = None
        self._watchdog: Optional[_cluster.Watchdog] = None
        self._warmed: set = set()
        self._capturable: Optional[bool] = None
        self.recompile_guard = _guard.RecompileGuard(
            lambda: self.exe.compiles, budget=recompile_budget,
            policy=recompile_policy, name="train")
        if anomaly_guard:
            # on the TRAIN program only (after the for_test clone)
            self.program.anomaly_guard = cost.name
            self.program._version += 1  # no step warmed before it replays
        elif getattr(self.program, "anomaly_guard", None) is not None:
            # guard off must really apply the updates
            self.program.anomaly_guard = None
            self.program._version += 1

    def prepare(self, wait: bool = True, timeout: Optional[float] = None):
        """The reference's manifest-driven warm start (ROADMAP A.10)."""
        raise NotImplementedError(
            "Trainer.prepare: the warm start from a compile manifest is not "
            "ported yet (ROADMAP A.10); train() warms each new step "
            "signature before its first batch")

    # ------------------------------------------------------------------ step
    def _run_step(self, feed, fetch):
        """One training step: a signature seen for the first time is warmed
        first (when the program and the Executor can capture), then run;
        returns the fetches as device tensors."""
        if self._capturable is None:
            try:
                check_capturable(self.program)
                self._capturable = self.strategy is None
            except WarmError:
                self._capturable = False
        if self._capturable:
            block = self.program.global_block
            sig = tuple(sorted(
                (n, tuple(int(d) for d in v.shape), dtype_name(
                    block.vars[n].dtype if n in block.vars else v.dtype))
                for n, v in feed.items()))
            key = (sig, tuple(f.name for f in fetch))
            if key not in self._warmed:
                self.exe.warm(self.program, sig, list(key[1]),
                              scope=global_scope())
                self._warmed.add(key)
        return self.exe.run(self.program, feed=feed, fetch_list=fetch,
                            return_numpy=False)

    # ------------------------------------------------------------------ train
    def train(self, reader, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              resume: bool = True):
        handler = event_handler or (lambda e: None)
        self._preempt = (_cluster.PreemptionGuard().install()
                         if self.handle_preemption else None)
        # created unstarted: restore and agreement time is not a hang; each
        # pass attempt starts it at its first step
        self._watchdog = (_cluster.Watchdog(self.hang_timeout_s,
                                            name="train.step")
                          if self.hang_timeout_s else None)
        try:
            self.exe.run(default_startup_program())
            start_pass = 0
            if self.ckpt and resume:
                state = self._restore_agreed(handler)
                if state:
                    self.global_step = state["step"]
                    start_pass = state["extra"].get("pass_id", 0)
            fetch = [self.cost] + list(self.extra_fetch.values())
            fetch_keys = list(self.extra_fetch.keys())
            for pass_id in range(start_pass, num_passes):
                handler(_events.BeginPass(pass_id))
                rollbacks = 0
                while True:
                    done, last_metrics = self._train_pass(
                        pass_id, reader, handler, fetch, fetch_keys)
                    if done:
                        break
                    if rollbacks >= self.max_rollbacks:
                        raise AnomalyBudgetExceeded(
                            f"pass {pass_id}: non-finite steps persisted "
                            f"through {rollbacks} checkpoint rollback(s): "
                            f"data or model is systematically producing "
                            f"NaN/inf")
                    rollbacks += 1
                    if self._watchdog is not None:
                        # recovery I/O is not step progress
                        self._watchdog.stop()
                    self._rollback()
                handler(_events.EndPass(pass_id, last_metrics))
                _profiler.incr("train.epochs")
                if self.task_queue is not None:
                    self.task_queue.new_epoch()
            if self.ckpt:
                self.ckpt.save(self.global_step, self.program,
                               extra={"pass_id": num_passes},
                               strategy=self.strategy)
            self._snapshot_queue()
        finally:
            # no watchdog thread outlives train(), and the signal
            # disposition is restored, whatever path left the loop
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            if self._preempt is not None:
                self._preempt.uninstall()
                self._preempt = None

    def _train_pass(self, pass_id, reader, handler, fetch, fetch_keys):
        """One attempt at a pass: (True, last metrics) when the reader is
        exhausted; (False, ...) on an anomaly-budget breach, so that
        train() rolls back and replays the pass.  The feed pipeline is
        closed before returning: its producer must stop before a rollback
        rewinds the task queue underneath it."""
        last_metrics: Dict[str, float] = {}
        consecutive_anomalies = 0
        last_batch = -1
        feed_iter = self._device_feeds(reader)
        # the wait and step histograms and the flight recorder's step ring
        # are always on; the spans land in the trace ring only while
        # tracing is enabled
        data_wait_h = _metrics.histogram("train.data_wait_ms")
        step_h = _metrics.histogram("train.step_ms")
        steps_c = _metrics.counter("train.steps")
        if self._watchdog is not None and not self._watchdog.alive():
            self._watchdog.start()
        try:
            pending = None  # (batch_id, outs) of the newest un-synced step
            it = iter(feed_iter)
            end = object()  # a feed is never this object
            batch_id = -1
            while True:
                t_wait = time.perf_counter()
                with _trace.span("train.data_wait"):
                    feed = next(it, end)
                if feed is end:
                    break
                data_wait_h.observe((time.perf_counter() - t_wait) * 1e3)
                batch_id += 1
                last_batch = batch_id
                if self._preempt is not None and self._preempt.preempted:
                    # stop pulling new work, but train the batches already
                    # staged: a task marked done whose batches never
                    # trained would be lost on resume
                    feed_iter.stop_intake()
                handler(_events.BeginIteration(pass_id, batch_id))
                faults.check("collective.step")
                t_step = time.perf_counter()
                with _trace.span("train.step", step=self.global_step):
                    outs = self._run_step(feed, fetch)
                step_h.observe((time.perf_counter() - t_step) * 1e3)
                steps_c.inc()
                if self._watchdog is not None:
                    self._watchdog.beat()
                if batch_id % self.log_every != 0:
                    pending = (batch_id, outs)
                    _recorder.record_step(self.global_step, pass_id, batch_id)
                    self.global_step += 1
                    self._maybe_checkpoint(pass_id, batch_id)
                    continue
                pending = None
                with _trace.span("train.fetch"):
                    t_fetch = time.perf_counter()
                    cost = _scalar(outs[0])
                    _metrics.histogram("train.fetch_ms").observe(
                        (time.perf_counter() - t_fetch) * 1e3)
                if self.anomaly_guard and not np.isfinite(cost):
                    # the on-device guard already kept the old state; with
                    # the guard off the update WAS applied, and the NaN
                    # cost reaches the handler like any other
                    consecutive_anomalies += 1
                    _profiler.incr("resilience.anomalies_skipped")
                    _recorder.record_event("anomaly", pass_id=pass_id,
                                           batch_id=batch_id, cost=cost,
                                           consecutive=consecutive_anomalies)
                    handler(_events.AnomalyDetected(pass_id, batch_id, cost,
                                                    consecutive_anomalies))
                    if consecutive_anomalies > self.anomaly_budget:
                        return False, last_metrics
                    continue
                consecutive_anomalies = 0
                last_metrics = {k: _scalar(v)
                                for k, v in zip(fetch_keys, outs[1:])}
                _recorder.record_step(self.global_step, pass_id, batch_id,
                                      cost=cost, metrics=last_metrics)
                handler(_events.EndIteration(pass_id, batch_id, cost,
                                             last_metrics))
                # the first synced step closes warmup: captures after it
                # are attributed to the feed shapes that just ran
                if not self.recompile_guard.steady:
                    self.recompile_guard.mark_steady()
                else:
                    self.recompile_guard.check(
                        "|".join(f"{n}{list(v.shape)}"
                                 for n, v in sorted(feed.items())))
                self.global_step += 1
                self._maybe_checkpoint(pass_id, batch_id)
            if pending is not None:
                # the pass ends with real metrics (and an EndIteration) even
                # when its last step fell between log points
                batch_id, outs = pending
                cost = _scalar(outs[0])
                if self.anomaly_guard and not np.isfinite(cost):
                    consecutive_anomalies += 1
                    _profiler.incr("resilience.anomalies_skipped")
                    handler(_events.AnomalyDetected(pass_id, batch_id, cost,
                                                    consecutive_anomalies))
                else:
                    last_metrics = {k: _scalar(v)
                                    for k, v in zip(fetch_keys, outs[1:])}
                    handler(_events.EndIteration(pass_id, batch_id, cost,
                                                 last_metrics))
            if self._preempt is not None and self._preempt.preempted:
                self._drain_preemption(pass_id, last_batch, handler)
            return True, last_metrics
        finally:
            feed_iter.close()

    def _maybe_checkpoint(self, pass_id: int, batch_id: int) -> None:
        if self.global_step % self.ckpt_every == 0:
            # train.checkpoint is the whole periodic persist; the nested
            # ckpt.save span times the blob write alone
            with _trace.span("train.checkpoint", step=self.global_step):
                if self.ckpt:
                    self.ckpt.save(self.global_step, self.program,
                                   extra={"pass_id": pass_id,
                                          "batch_id": batch_id},
                                   strategy=self.strategy)
                self._snapshot_queue()

    def _drain_preemption(self, pass_id: int, batch_id: int, handler) -> None:
        """The grace flag is armed and the staged steps are done: checkpoint
        at the current step with the queue snapshot, tell the handler, and
        exit with the resumable code."""
        if self.ckpt:
            self.ckpt.save(self.global_step, self.program,
                           extra={"pass_id": pass_id, "batch_id": batch_id,
                                  "preempted": True},
                           strategy=self.strategy)
        self._snapshot_queue()
        _profiler.incr("resilience.preemptions")
        # the drain is about to exit: leave the postmortem that says the
        # state on disk is a deliberate drain, with the steps that led here
        _recorder.record_event("preemption", pass_id=pass_id,
                               batch_id=batch_id, step=self.global_step)
        _recorder.dump("preemption", extra={"step": self.global_step,
                                            "pass_id": pass_id})
        handler(_events.Preempted(pass_id, batch_id, self.global_step))
        _cluster.resumable_exit(_cluster.EXIT_PREEMPTED)

    def _restore_agreed(self, handler=None):
        """Restore for resume or rollback.  One rank: the plain restore, no
        collective.  A gang: the ranks agree on the newest step every rank
        holds intact (``agree_restore_step``, a ``RestoreAgreed`` event) and
        all restore it."""
        if self.ckpt is None:
            return None
        from . import distributed

        if distributed.process_count() <= 1:
            return self.ckpt.restore(strategy=self.strategy,
                                     device=self.exe.device)
        local = self.ckpt.intact_steps()
        agreed = _cluster.agree_restore_step(local)
        if handler is not None:
            handler(_events.RestoreAgreed(local[0] if local else None, agreed))
        if agreed is None:
            return None
        return self.ckpt.restore(strategy=self.strategy, limit_step=agreed,
                                 device=self.exe.device)

    def _rollback(self):
        """Past the budget: restore the newest intact checkpoint (agreed in
        a gang) and rewind the dataset queue to the snapshot paired with
        it, so that the replayed pass re-reads the batches that poisoned
        this attempt; with no checkpoint left, the initial parameters."""
        _profiler.incr("resilience.rollbacks")
        # postmortem before the restore changes state: the evidence is the
        # anomalous run of steps that triggered the rollback
        _recorder.record_event("rollback", step=self.global_step)
        _recorder.dump("anomaly_rollback", extra={"step": self.global_step})
        state = None
        if self.ckpt:
            try:
                state = self._restore_agreed()
            except CheckpointCorrupt:
                # every checkpoint is corrupt: replay from scratch rather
                # than crash mid-recovery (environment errors propagate)
                state = None
        if state is not None:
            self.global_step = state["step"]
        else:
            self.exe.run(default_startup_program())
            self.global_step = 0
        if self.task_queue is not None:
            # only the snapshot PAIRED with the restored checkpoint is a
            # valid cursor; without one, requeue everything
            snap = None
            if state is not None and self.ckpt:
                cand = os.path.join(self.ckpt._ckpt_dir(state["step"]),
                                    "queue.snap")
                if os.path.exists(cand):
                    snap = cand
            if snap is not None:
                try:
                    self.task_queue.rewind(snap)
                except (OSError, ValueError):
                    self.task_queue.new_epoch()
            else:
                self.task_queue.new_epoch()

    def _snapshot_queue(self):
        # up to prefetch_depth batches may still be in flight when the
        # snapshot fires; a crash in that window skips them on resume (the
        # Go master has the same window)
        if self.task_queue is not None and self.queue_snapshot_path:
            self.task_queue.snapshot(self.queue_snapshot_path)
            # pair the cursor with the checkpoint it rode along with, by
            # tmp + rename (never a truncated pair)
            if self.ckpt:
                d = self.ckpt._ckpt_dir(self.global_step)
                if os.path.isdir(d):
                    tmp = os.path.join(d, "queue.snap.tmp")
                    shutil.copy(self.queue_snapshot_path, tmp)
                    os.replace(tmp, os.path.join(d, "queue.snap"))

    def _device_feeds(self, reader):
        def feed_reader():
            for batch_samples in reader():
                yield self.feeder.feed(batch_samples)

        # the DeviceFeeder itself: the pass loop needs its stop_intake()
        return DeviceFeeder(feed_reader, depth=self.prefetch_depth,
                            device=self.exe.device)

    # ------------------------------------------------------------------ test
    def test(self, reader,
             fetch: Optional[Dict[str, Variable]] = None) -> Dict[str, float]:
        """Run the forward-only clone over an eval reader, averaging the
        fetches (ref Tester.cpp / v2 SGD.test), eagerly, in a THROWAWAY
        copy of the scope: the test program keeps its metric-accumulating
        ops, whose writes must not reach the training state."""
        fetch = fetch or {"cost": self.cost}
        keys = list(fetch)
        train_scope = global_scope()
        test_scope = Scope()
        for name, v in train_scope.items():
            test_scope.set_var(name, v)
        test_scope.step_counter = train_scope.step_counter
        sums = {k: 0.0 for k in keys}
        n = 0
        for feed in self._device_feeds(reader):
            outs = self.exe.run(self.test_program, feed=feed,
                                fetch_list=[fetch[k] for k in keys],
                                scope=test_scope, return_numpy=False)
            for k, v in zip(keys, outs):
                sums[k] += _scalar(v)
            n += 1
        return {k: sums[k] / max(n, 1) for k in keys}


class SparseEmbeddingTrainer:
    """Drives the sparse embedding engine (``paddle_tpu_torch.sparse``,
    DESIGN.md §26): a ShardedEmbeddingTable and the row-touched optimizer
    apply over a SparseFeeder id stream, outside the Program graph.

    The whole step (gather the unique rows as a leaf, ``loss_fn``,
    ``torch.autograd.grad`` for the rows and the dense parameters, the
    row-touched apply, the dense apply) is prepared once per signature (a
    bucket rung, with the batch's shapes), at its first visit: on the card
    one CUDA graph, on the CPU the body run on static buffers; every later
    step of that signature stages its batch and replays it.  The gathered
    ``[bucket, D]`` rows are the differentiated leaf, so their gradient is
    the segment-summed per-row cotangent and the dense ``[V, D]`` gradient
    never exists.  ``lr`` and ``t`` are staged as device scalars for each
    replay, so a schedule moves without a new capture.  ``traces`` counts
    the captures; ``recompile_guard`` holds a revisited rung to zero new
    ones.

    ``loss_fn(rows, params, batch) -> scalar``, such as
    ``models.ctr.wide_deep_sparse_loss``; ``batch`` is the SparseFeeder's
    staged feed without the raw id field, its uids and its count.
    ``params``: numpy arrays (or tensors) by name, moved to the table's
    device."""

    def __init__(self, table, loss_fn, params, optimizer,
                 field: str = "sparse", prefetch_depth: int = 2,
                 recompile_budget: int = 0, recompile_policy: str = "warn"):
        from .sparse.update import RowTouchedOptimizer, init_dense_state

        self.table = table
        self.device = table.device
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.field = field
        self.prefetch_depth = prefetch_depth
        self.row_opt = RowTouchedOptimizer(optimizer)
        self.slots = self.row_opt.init_slots(table)
        self.params = {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(self.device).clone()
            for k, v in params.items()}
        self.state = init_dense_state(optimizer, self.params)
        self.global_step = 0
        self._traces = 0
        self._seen_rungs: set = set()
        self._graphs = Graphs(self.device)
        self._steps: Dict[tuple, tuple] = {}
        self.feeder = None
        self.recompile_guard = _guard.RecompileGuard(
            lambda: self._traces, budget=recompile_budget,
            policy=recompile_policy, name="sparse_train")

    @property
    def traces(self) -> int:
        return self._traces

    def step_body(self, uids, lr, t, batch):
        """One step on tensors on the table's device, eagerly, updating the
        table, the slots, the parameters and their state in place; returns
        the loss (a 0-d tensor).  The body every prepared signature runs."""
        from .sparse.update import apply_dense

        rows = self.table.gather(uids).detach().requires_grad_(True)
        names = list(self.params)
        leaves = [self.params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = self.loss_fn(rows, dict(zip(names, leaves)), batch)
            grads = torch.autograd.grad(loss, [rows] + leaves)
        with torch.no_grad():
            self.row_opt.apply_rows(self.table.storage, self.slots,
                                    self.table.local_uids(uids),
                                    grads[0], lr, t)
            new_p, new_s = apply_dense(self.opt, self.params,
                                       dict(zip(names, grads[1:])),
                                       self.state, lr, t)
            dst = [self.params[k] for k in names] + [
                self.state[k][a] for k in names for a in self.state[k]]
            src = [new_p[k] for k in names] + [
                new_s[k][a] for k in names for a in self.state[k]]
            torch._foreach_copy_(dst, src)
        return loss.detach()

    def _state_tensors(self):
        return ([self.table.storage] + list(self.slots.values())
                + list(self.params.values())
                + [v for s in self.state.values() for v in s.values()])

    def _prepare(self, uids, batch):
        """Static buffers for one signature and its body prepared; the
        prepare's own run of the body is undone (every state tensor put
        back), so preparing changes no state."""
        fields = [("uids", tuple(uids.shape), np.int32),
                  ("lr", (), np.float32), ("t", (), np.float32)]
        for k, v in sorted(batch.items()):
            fields.append(("b:" + k, tuple(v.shape), v.dtype))
        staged = Staged(fields, self.device)
        outs = {}

        def body(t=staged.t, outs=outs):
            b = {k[2:]: v for k, v in t.items() if k.startswith("b:")}
            outs["loss"] = self.step_body(t["uids"], t["lr"], t["t"], b)

        snapshot = [v.clone() for v in self._state_tensors()]
        staged.stage(self._stage_values(uids, batch, 0.0, 1.0))
        run = self._graphs.prepare(body)
        with torch.no_grad():
            torch._foreach_copy_(self._state_tensors(), snapshot)
        self._traces += 1
        return staged, run, outs

    @staticmethod
    def _stage_values(uids, batch, lr, t) -> dict:
        vals = {"uids": uids, "lr": np.asarray(lr, np.float32),
                "t": np.asarray(t, np.float32)}
        vals.update({"b:" + k: v for k, v in batch.items()})
        return vals

    def _lr(self) -> float:
        lr = self.opt._lr_value(torch.tensor(self.global_step,
                                             dtype=torch.int32))
        return float(lr)

    def step(self, feed):
        """One step over a SparseFeeder-staged feed dict (tensors on the
        table's device, or numpy arrays).  Returns the loss as a 0-d tensor
        on the device (``float()`` syncs)."""
        uids = feed[self.field + "__uids"]
        drop = (self.field, self.field + "__uids", self.field + "__nuniq")
        batch = {k: (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.asarray(v)))
                 for k, v in feed.items() if k not in drop}
        uids = (uids if isinstance(uids, torch.Tensor)
                else torch.from_numpy(np.asarray(uids)))
        key = (tuple(uids.shape),) + tuple(
            (k, tuple(v.shape), str(v.dtype)) for k, v in sorted(
                batch.items()))
        prep = self._steps.get(key)
        if prep is None:
            prep = self._steps[key] = self._prepare(uids, batch)
        staged, run, outs = prep
        staged.stage(self._stage_values(uids, batch, self._lr(),
                                        self.global_step + 1))
        run.replay()
        loss = outs["loss"].clone()
        nuniq = feed.get(self.field + "__nuniq")
        if nuniq is not None:
            _metrics.counter("sparse.update.rows_touched").inc(
                int(np.asarray(nuniq).reshape(-1)[0]))
        # the ladder bounds the captures: the first visit to a rung is
        # warmup (the guard re-baselines over it), a revisit that captures
        # is a storm
        bucket = int(uids.shape[0])
        if bucket not in self._seen_rungs:
            self._seen_rungs.add(bucket)
            self.recompile_guard.mark_steady()
        else:
            self.recompile_guard.check(f"bucket[{bucket}]")
        self.global_step += 1
        return loss

    def train(self, reader, num_steps: Optional[int] = None,
              event_handler: Optional[Callable] = None):
        """Train over ``reader`` (a creator yielding feed dicts with the raw
        id field), streamed through a SparseFeeder (kept as ``feeder``) so
        that dedup and bucketing run on its producer thread, overlapped
        with the device step.  Returns the per-step losses, synced once at
        the end."""
        from .sparse.pipeline import SparseFeeder

        handler = event_handler or (lambda e: None)
        feeder = self.feeder = SparseFeeder(
            reader, {self.field: self.table}, depth=self.prefetch_depth,
            device=self.device)
        losses = []
        try:
            for feed in feeder:
                losses.append(self.step(feed))
                handler(_events.EndIteration(0, self.global_step - 1, None,
                                             {}))
                if num_steps is not None and len(losses) >= num_steps:
                    feeder.stop_intake()
                    break
        finally:
            feeder.close()
        return [float(x) for x in losses]

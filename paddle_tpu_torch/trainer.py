"""Trainers (PyTorch port of the part of ``paddle_tpu/trainer.py`` the
sparse engine needs): ``SparseEmbeddingTrainer``.  The v2-style
``Trainer`` (the pass / batch event loop with checkpoints and the anomaly
guard's rollback) is ROADMAP A.12 (rest)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import events as _events
from .compile import guard as _guard
from .core.graphs import Graphs, Staged


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

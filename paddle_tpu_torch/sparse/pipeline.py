"""Streaming host pipeline for sparse id streams (PyTorch port of
``paddle_tpu/sparse/pipeline.py``).

``SparseFeeder`` extends ``DeviceFeeder`` (the same bounded staging
queue, ``stop_intake`` / ``close`` semantics and one-shot stream) and
runs the per-batch dedup-and-bucket of every registered sparse field on
the producer thread, overlapped with the running device step, so that the
device only sees ladder-shaped id buffers.  For each registered field
``f`` the staged feed grows four entries::

    f__uids   [bucket] int32   deduped ids, the sentinel in dead slots
    f__inv    ids-shaped int32 inverse indices into f__uids
    f__mask   ids-shaped f32   0.0 where the id was padding_idx
    f__nuniq  [1] int32        live rows this batch (stays on the host)

``dedup_ms`` keeps the producer's dedup time per batch and ``stall_ms``
the consumer's wait on the staging queue per batch (the pipeline's "are we
host-bound?" reading), as do the reference's ``sparse.pipeline.dedup_ms``
and ``sparse.pipeline.stall_ms`` histograms; ``sparse.pipeline.batches``
counts the staged batches and the ``sparse.bucket.size`` /
``sparse.bucket.occupancy`` gauges describe the last one.
"""
from __future__ import annotations

import time
from typing import Mapping

import numpy as np
import torch

from ..data_feeder import DeviceFeeder
from ..obs import metrics as _metrics
from .table import ShardedEmbeddingTable


class SparseFeeder(DeviceFeeder):
    """DeviceFeeder with producer-thread id dedup and bucketing.

    ``tables`` maps feed-field name -> ShardedEmbeddingTable; each named
    field must be in every feed dict the reader yields (ids shaped
    [..., F] for an F-field fused table).  Stages on the first table's
    device unless ``device`` is given."""

    def __init__(self, feed_reader,
                 tables: Mapping[str, ShardedEmbeddingTable],
                 depth: int = 2, sharding=None, device=None):
        self._tables = dict(tables)
        if device is None and self._tables:
            device = next(iter(self._tables.values())).device
        super().__init__(feed_reader, depth=depth, sharding=sharding,
                         device=device)
        self.dedup_ms = []
        self.stall_ms = []

    def _stage(self, feed):
        t0 = time.perf_counter()
        feed = dict(feed)
        host = {}
        for field, table in self._tables.items():
            if field not in feed:
                raise KeyError(
                    f"SparseFeeder: feed is missing sparse field {field!r} "
                    f"(have {sorted(feed)})")
            db = table.dedup(feed[field])
            feed[field + "__uids"] = db.uids
            feed[field + "__inv"] = db.inv
            feed[field + "__mask"] = db.mask
            _metrics.gauge("sparse.bucket.size").set(float(db.bucket))
            _metrics.gauge("sparse.bucket.occupancy").set(
                db.n_unique / float(db.bucket))
            host[field + "__nuniq"] = torch.tensor([db.n_unique],
                                                   dtype=torch.int32)
        ms = (time.perf_counter() - t0) * 1e3
        self.dedup_ms.append(ms)
        _metrics.histogram("sparse.pipeline.dedup_ms").observe(ms)
        _metrics.counter("sparse.pipeline.batches").inc()
        staged, event = super()._stage(feed)
        staged.update(host)  # read by the step without a device sync
        return staged, event

    def _on_wait(self, seconds: float) -> None:
        self.stall_ms.append(seconds * 1e3)
        _metrics.histogram("sparse.pipeline.stall_ms").observe(seconds * 1e3)

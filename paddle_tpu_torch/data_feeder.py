"""DataFeeder: sample lists to padded dense feed dicts, and an asynchronous
device-staging pipeline (PyTorch port of ``paddle_tpu/data_feeder.py``;
ref: fluid/data_feeder.py and the PyDataProvider2 double-buffering
provider, gserver/dataproviders/PyDataProvider2).

``DeviceFeeder`` stages the next batches on the device while the current
step runs: a daemon thread pulls feed dicts from a reader and copies them
to the device (the CUDA card unless ``device`` names another) on a side
CUDA stream of its own, recording an event after each batch's copies; the
consumer's stream waits on that event before the batch is handed out, and
each tensor is marked as used by the consumer's stream
(``record_stream``), so the caching allocator never reuses its memory
while the consumer's work is pending.  No tensor is touched from two
streams without that order.  On the CPU the staging is ``from_numpy``.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
import weakref
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .core.program import Variable, default_main_program


class DataFeeder:
    """Convert a list of samples (tuples aligned with ``feed_list``) into a
    feed dict of dense numpy arrays; ragged sequence slots are padded and a
    ``'<name>__len'`` feed is emitted when the Variable declares
    ``lod_level > 0``."""

    def __init__(self, feed_list: Sequence[Variable], place=None):
        self.feed_vars = list(feed_list)

    def feed(self, samples: Iterable[Sequence]) -> Dict[str, np.ndarray]:
        samples = list(samples)
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            col = [s[i] for s in samples]
            dt = torch.empty(0, dtype=var.dtype).numpy().dtype
            if var.lod_level > 0:
                lens = np.asarray([len(c) for c in col], dtype=np.int32)
                maxlen = int(lens.max()) if len(lens) else 1
                tail_shape = np.asarray(col[0]).shape[1:]
                arr = np.zeros((len(col), maxlen) + tail_shape, dtype=dt)
                for b, c in enumerate(col):
                    c = np.asarray(c, dtype=dt)
                    arr[b, : len(c)] = c
                out[var.name] = arr
                out[var.name + "__len"] = lens
            else:
                out[var.name] = np.asarray(col, dtype=dt)
        return out


class DeviceFeeder:
    """Asynchronous host-to-device staging: a daemon thread pulls feed
    dicts from ``feed_reader()`` and stages them on ``device`` ahead of
    consumption, at most ``depth`` batches ahead (PyDataProvider2's double
    buffer).

    One-shot iterable: ``iter()`` always returns the same underlying
    stream.  ``stop_intake()`` closes the producer's intake: it stops
    pulling new batches from the reader (the reader generator is closed),
    but the batches already staged still flow to the consumer.
    ``close()`` abandons the stream (staged batches are dropped).  The
    stream is held by a weak reference, so a consumer that drops its
    iterator lets it close and the producer thread stop.  A reader's or
    the staging's error reaches the consumer, raised where the batch would
    have been.

    ``sharding``: a ``parallel.Strategy`` (the counterpart of the
    reference's ``NamedSharding``, ``device_put`` of each feed).  Each rank
    then uploads only its part of every global batch: the dp rows of the
    batch-major feeds of the default main program when the feeder is
    made, and the sequence slice of those with a ``SeqAxis`` on dim 1.
    A batch comes out as a ``parallel.LocalFeed``, marked as the rank's
    with the global batch size, which ``Executor.run`` under that
    Strategy takes without slicing again: fetches, losses and state are
    those of the same feeds given whole.  The run refuses a
    ``LocalFeed`` whose rows are not its program's part of the batch (a
    feeder made for another program)."""

    _END = object()

    def __init__(self, feed_reader, depth: int = 2, sharding=None,
                 device=None):
        if sharding is not None and not hasattr(sharding, "local_feed"):
            raise TypeError(f"DeviceFeeder(sharding=...) takes a "
                            f"parallel.Strategy, got "
                            f"{type(sharding).__name__}")
        self._sharding = sharding
        self._program = default_main_program()
        self._reader = feed_reader
        self._depth = depth
        self.device = resolve_device(device)
        self._intake_closed = threading.Event()
        self._it_ref = None
        self._copy_stream = None

    def stop_intake(self) -> None:
        self._intake_closed.set()

    def _live_iter(self):
        return self._it_ref() if self._it_ref is not None else None

    def close(self) -> None:
        it = self._live_iter()
        if it is not None:
            it.close()

    def __iter__(self):
        it = self._live_iter()
        if it is None:
            it = self._stream()
            self._it_ref = weakref.ref(it)
        return it

    # ---------------------------------------------------- subclass hooks
    def _stage(self, feed):
        """Producer-thread staging of one feed dict on the device: on the
        card each array goes through pinned memory and an asynchronous copy
        on the feeder's side stream, which then records the event the
        consumer waits on.  Returns (staged dict, event or None).
        Subclass hook: the sparse pipeline (``sparse/pipeline.py``)
        deduplicates and buckets the batch's ids here first.  With
        ``sharding`` the batch is sliced to this rank's part on the host
        first."""
        local = None
        if self._sharding is not None:
            local = self._sharding.local_feed(self._program, feed)
            feed = dict(local)
        staged, event = self._upload(feed)
        if local is not None:
            staged = type(local)(staged, local.batch, local.seq_axis)
        return staged, event

    def _upload(self, feed):
        if self.device.type != "cuda":
            return {k: torch.as_tensor(np.asarray(v)) for k, v in
                    feed.items()}, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        staged = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in feed.items():
                host = (v if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.ascontiguousarray(v)))
                if host.device.type == "cpu":
                    host = host.pin_memory()
                staged[k] = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return staged, event

    def _on_wait(self, seconds: float) -> None:
        """Consumer-side hook: called with the time the consumer spent
        blocked on the staging queue for each batch.  The base feeder keeps
        no record; the sparse pipeline keeps it as stall time."""

    def _release(self, item):
        """Make a staged batch safe on the consumer's stream: wait on its
        event and mark each device tensor as used there (a subclass may
        keep a field on the host: the sparse pipeline's ``__nuniq``)."""
        staged, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for v in staged.values():
                if v.device.type == "cuda":
                    v.record_stream(cur)
        return staged

    def _stream(self):
        q: _queue.Queue = _queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def producer():
            err = None
            it = iter(self._reader())
            try:
                while not self._intake_closed.is_set():
                    try:
                        feed = next(it)
                    except StopIteration:
                        break
                    if not _put(self._stage(feed)):
                        return
            except BaseException as e:  # noqa: BLE001 — handed to the consumer
                err = e
            finally:
                if hasattr(it, "close"):
                    try:
                        it.close()
                    except Exception:  # noqa: BLE001
                        pass
            _put((self._END, err))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self._on_wait(time.perf_counter() - t0)
                if item[0] is self._END:
                    if item[1] is not None:
                        raise item[1]
                    return
                yield self._release(item)
        finally:
            stop.set()
            t.join(timeout=5.0)

"""Composable reader decorators (the port's copy of
``paddle_tpu/reader/decorator.py``; ref: python/paddle/v2/reader/
decorator.py:29-337: map_readers, shuffle, chain, compose, buffered,
firstn, xmap_readers, pipe_reader, cache, batch).

A *reader creator* is a zero-arg callable returning an iterator of samples.
The API is kept 1:1 with the reference; ``bucket_by_length`` is the JAX
package's addition that makes padded dense sequence batches cheap (fewer
distinct shapes: fewer signatures to warm, less padding).  Pure Python and
numpy, stream for stream the JAX package's (a seeded ``shuffle`` gives the
same permutations)."""
from __future__ import annotations

import itertools
import queue as _queue
import random as _random
import threading
from typing import Callable, List, Sequence

import numpy as np


def map_readers(func: Callable, *readers):
    """Apply func over samples zipped from readers (ref decorator.py:29)."""

    def reader():
        its = [r() for r in readers]
        for sample in zip(*its):
            yield func(*sample)

    return reader


def shuffle(reader, buf_size: int, seed=None):
    """Pool-based shuffle (ref decorator.py:62).

    ``seed`` may be None (fresh OS entropy per epoch), an int, or a
    ``numpy.random.Generator`` — the three forms behave uniformly: every
    epoch (each call of the returned reader) draws a NEW permutation.  An
    int seed stays reproducible ACROSS epochs by deriving epoch ``e``'s rng
    from ``(seed, e)`` — the old behaviour reseeded identically each call,
    so a multi-epoch CTR run replayed the same permutation every epoch and
    the "shuffled" stream was an epoch-length cycle.  A Generator is simply
    consumed statefully (numpy's own cross-epoch contract)."""
    if seed is not None and not isinstance(seed, (int, np.integer,
                                                  np.random.Generator)):
        raise TypeError(f"shuffle: seed must be None, an int, or a "
                        f"numpy.random.Generator, got {type(seed).__name__}")
    epoch = itertools.count()

    def shuffled():
        if isinstance(seed, np.random.Generator):
            do_shuffle = seed.shuffle  # stateful: advances across epochs
        elif seed is None:
            do_shuffle = _random.Random().shuffle
        else:
            # str seeding goes through sha512 — deterministic across
            # processes (unlike hash()), and folding the epoch in gives a
            # distinct, reproducible permutation per epoch
            do_shuffle = _random.Random(
                f"shuffle|{int(seed)}|{next(epoch)}").shuffle
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                do_shuffle(buf)
                while buf:
                    yield buf.pop()
        do_shuffle(buf)
        while buf:
            yield buf.pop()

    return shuffled


def chain(*readers):
    """Concatenate readers (ref decorator.py:103)."""

    def chained():
        return itertools.chain(*[r() for r in readers])

    return chained


class ComposeNotAligned(ValueError):
    """Raised when composed readers yield different lengths
    (ref decorator.py:114 — same exception name for API parity)."""


def compose(*readers, check_alignment: bool = True):
    """Zip readers into combined samples (ref decorator.py:141)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        its = [r() for r in readers]
        for parts in itertools.zip_longest(*its):
            if check_alignment and any(p is None for p in parts):
                raise ComposeNotAligned(
                    "compose: readers have different lengths")
            yield sum((make_tuple(p) for p in parts), ())

    return composed


def buffered(reader, size: int):
    """Background-thread producer with a bounded queue (ref decorator.py:190 —
    the PyDataProvider2 double-buffering idea).  Producer exceptions re-raise in
    the consumer; an abandoned consumer unblocks the producer via a stop flag."""

    end = object()

    def buffered_reader():
        q: _queue.Queue = _queue.Queue(maxsize=size)
        stop = threading.Event()

        def producer():
            err = None
            try:
                for s in reader():
                    while not stop.is_set():
                        try:
                            q.put(s, timeout=0.1)
                            break
                        except _queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate to the consumer
                err = e
            while not stop.is_set():
                try:
                    q.put((end, err), timeout=0.1)
                    return
                except _queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                s = q.get()
                if isinstance(s, tuple) and len(s) == 2 and s[0] is end:
                    if s[1] is not None:
                        raise s[1]
                    return
                yield s
        finally:
            stop.set()

    return buffered_reader


def firstn(reader, n: int):
    """First n samples (ref decorator.py:231)."""

    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper: Callable, reader, process_num: int, buffer_size: int,
                 order: bool = False):
    """Parallel map with worker threads (ref decorator.py:252)."""

    end = object()

    def xreader():
        in_q: _queue.Queue = _queue.Queue(buffer_size)
        out_q: _queue.Queue = _queue.Queue(buffer_size)

        def feeder():
            # the end sentinels must reach the workers even if reader() raises,
            # or every thread (and then the consumer) deadlocks
            err = None
            try:
                for i, s in enumerate(reader()):
                    in_q.put((i, s))
            except BaseException as e:
                err = e
            finally:
                for _ in range(process_num):
                    in_q.put((end, err))
                    err = None

        def worker():
            while True:
                item = in_q.get()
                if isinstance(item, tuple) and item[0] is end:
                    out_q.put((end, item[1]))
                    return
                i, s = item
                try:
                    out_q.put((i, mapper(s)))
                except BaseException as e:
                    out_q.put((end, e))
                    return

        threading.Thread(target=feeder, daemon=True).start()
        workers = [threading.Thread(target=worker, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item[0] is end:
                if item[1] is not None:
                    raise item[1]
                finished += 1
                continue
            if not order:
                yield item[1]
            else:
                pending[item[0]] = item[1]
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        while order and next_idx in pending:
            yield pending.pop(next_idx)
            next_idx += 1

    return xreader


def pipe_reader(left_cmd, parser, bufsize: int = 8192, file_type: str = "plain",
                cut_lines: bool = True, line_break: str = "\n"):
    """Stream records from a shell command's stdout (ref decorator.py:337 —
    v2 users pipe `hadoop fs -cat`/`cat` through this).  ``parser(line)``
    maps each line (or raw chunk when cut_lines=False) to a sample; yielding
    None skips the record.  file_type "gzip" decompresses the stream."""
    import gzip as _gzip
    import shlex
    import subprocess

    if file_type not in ("plain", "gzip"):
        raise ValueError(f"file_type must be plain|gzip, got {file_type!r}")

    def reader():
        proc = subprocess.Popen(shlex.split(left_cmd), stdout=subprocess.PIPE)
        # GzipFile handles concatenated members (cat a.gz b.gz — the
        # documented hadoop pipeline shape), delivers bytes buffered at EOF,
        # reads b"" on an empty stream, and flags mid-member truncation
        # (EOFError) / trailing garbage (BadGzipFile) — all semantics the
        # record stream needs
        src = _gzip.GzipFile(fileobj=proc.stdout) \
            if file_type == "gzip" else proc.stdout
        remained = b""
        drained = False
        try:
            while True:
                try:
                    buf = src.read(bufsize)
                except EOFError:
                    raise RuntimeError(f"pipe_reader: truncated gzip stream "
                                       f"from {left_cmd}") from None
                except _gzip.BadGzipFile as e:
                    raise RuntimeError(f"pipe_reader: bad gzip stream from "
                                       f"{left_cmd}: {e}") from None
                if not buf:
                    drained = True
                    break
                if not cut_lines:
                    sample = parser(buf)
                    if sample is not None:
                        yield sample
                    continue
                remained += buf
                *lines, remained = remained.split(line_break.encode())
                for ln in lines:
                    sample = parser(ln.decode("utf-8", errors="replace"))
                    if sample is not None:
                        yield sample
            if cut_lines and remained:
                sample = parser(remained.decode("utf-8", errors="replace"))
                if sample is not None:
                    yield sample
        finally:
            proc.stdout.close()
            if not drained:
                # consumer abandoned the stream (break/firstn/close): the
                # command's SIGPIPE death is expected, and a command that
                # never notices (tail -f) must not hang wait() — kill it
                proc.kill()
                proc.wait()
            else:
                rc = proc.wait()
                if rc != 0:
                    raise RuntimeError(f"pipe_reader command failed rc={rc}: "
                                       f"{left_cmd}")

    return reader


def cache(reader):
    """Materialise the whole stream on first use, replay thereafter.  Eager fill
    (not append-as-you-go) so an abandoned partial iteration can't leave a
    corrupt store that later replays duplicated samples."""
    store: List = []
    filled = [False]

    def cached():
        if not filled[0]:
            store.extend(reader())
            filled[0] = True
        yield from store

    return cached


def batch(reader, batch_size: int, drop_last: bool = True):
    """Group samples into lists (ref: python/paddle/v2/minibatch.py).  drop_last
    defaults True, as in the JAX package: constant batch shapes keep one
    warmed step signature."""

    def batched():
        b = []
        for s in reader():
            b.append(s)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batched


def bucket_by_length(reader, length_fn: Callable, bucket_bounds: Sequence[int],
                     batch_size: int, drop_last: bool = False):
    """Bucket variable-length samples so each batch pads to its bucket bound
    (the JAX package's addition; replaces the reference's LoDRankTable
    sort-by-length).  Yields (bucket_bound, [samples])."""
    bounds = sorted(bucket_bounds)

    def bucketed():
        buckets = {b: [] for b in bounds}
        for s in reader():
            ln = length_fn(s)
            for b in bounds:
                if ln <= b:
                    buckets[b].append(s)
                    if len(buckets[b]) == batch_size:
                        yield b, buckets[b]
                        buckets[b] = []
                    break
            # samples longer than the last bound are dropped (caller should size
            # bounds to the dataset's max)
        if not drop_last:
            for b in bounds:
                if buckets[b]:
                    yield b, buckets[b]

    return bucketed

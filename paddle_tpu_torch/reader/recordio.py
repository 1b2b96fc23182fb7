"""RecordIO-backed dataset storage and the native prefetch reader (PyTorch
port of ``paddle_tpu/reader/recordio.py``).

The reference's Go master partitions datasets into RecordIO chunks and hands
them to trainers as tasks (go/master/service.go partition; design
doc/design/cluster_train/README.md); its C++ data providers stream batches on
background threads (PyDataProvider2.cpp).  Here:

  dump(reader, prefix, ...)      — materialise any python reader into sharded
                                   CRC-checked RecordIO files (native writer)
  reader(files, ...)             — stream samples back through the C++
                                   threaded prefetcher with streaming shuffle
  dispatched_reader(queue, ...)  — pull file-tasks from a TaskQueue (the
                                   master analog) so any trainer can die and a
                                   replacement picks up remaining shards

Samples are arbitrary picklable python objects (numpy tuples from the dataset
pack), serialized per record; the CRC sits below the pickle so corruption is
detected before deserialization.  Shards are the JAX package's byte for byte:
either package reads what the other wrote.

Fault site (``resilience/faults.py``):
  reader.pipeline   once per record streamed by ``reader`` and
                    ``dispatched_reader``.
"""
from __future__ import annotations

import glob as _glob
import pickle
import time as _time
from typing import Callable, List, Optional

from .. import native
from ..resilience import Backoff, RetryPolicy, faults, retry

# transient I/O in the record stream (flaky NFS/GCS mount, injected faults)
# is retried per task before the task is failed back to the queue
READER_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0)


def encode_sample(sample) -> bytes:
    return pickle.dumps(sample, protocol=4)


def decode_sample(record: bytes):
    return pickle.loads(record)


def dump(reader: Callable, prefix: str, num_shards: int = 8,
         samples_per_shard: Optional[int] = None) -> List[str]:
    """Write reader() samples round-robin into `{prefix}-{i:05d}.rio` shards."""
    paths = [f"{prefix}-{i:05d}.rio" for i in range(num_shards)]
    writers = []
    try:
        for p in paths:
            writers.append(native.RecordIOWriter(p))
        n = 0
        for sample in reader():
            writers[n % num_shards].write(encode_sample(sample))
            n += 1
            if samples_per_shard is not None and n >= samples_per_shard * num_shards:
                break
    finally:
        for w in writers:
            w.close()
    return paths


def reader(files, n_threads: int = 2, shuffle_buffer: int = 0, seed: int = 0):
    """A reader-creator streaming decoded samples via the native prefetcher.
    `files` is a list or a glob pattern."""
    if isinstance(files, str):
        file_list = sorted(_glob.glob(files))
    else:
        file_list = list(files)
    if not file_list:
        raise ValueError(f"no recordio files match {files!r}")

    def read():
        with native.Prefetcher(file_list, n_threads=n_threads,
                               shuffle_buffer=shuffle_buffer, seed=seed) as pf:
            for rec in pf:
                faults.check("reader.pipeline")
                yield decode_sample(rec)

    return read


def dispatched_reader(queue: "native.TaskQueue", n_threads: int = 2,
                      shuffle_buffer: int = 0, seed: int = 0,
                      retry_policy: Optional[RetryPolicy] = None):
    """Reader pulling RecordIO *file tasks* from a TaskQueue whose payloads are
    file paths (see distributed.make_file_dispatcher).  Finishing a file marks
    the task done; a crash mid-file leaves it pending until the queue's timeout
    requeues it for another trainer — the Go master's elasticity semantics.

    Transient errors (resilience.TransientError / IOError) while streaming a
    file are retried in place per ``retry_policy`` with backoff, re-opening
    the file and skipping the records already handed downstream, so the
    consumer sees each record once; only an exhausted policy fails the task
    back to the queue (failure_max then discards chronic shards).  The queue
    pop itself is retried the same way."""
    policy = retry_policy or READER_RETRY

    def read():
        while True:
            queue.sweep()  # requeue tasks whose claimant died past its deadline
            task = retry(policy)(queue.get)()
            if task is None:
                break
            tid, path = task
            yielded = 0  # records already delivered from this file
            bo = Backoff(policy)
            attempt = 0
            last_fail_at = -1
            while True:
                try:
                    with native.Prefetcher([path], n_threads=n_threads,
                                           shuffle_buffer=shuffle_buffer,
                                           seed=seed) as pf:
                        for i, rec in enumerate(pf):
                            faults.check("reader.pipeline")
                            if i >= yielded:
                                yield decode_sample(rec)
                                yielded += 1
                    break
                except Exception as e:
                    if yielded > last_fail_at:
                        # progress since the last incident: the retry budget
                        # is per-incident, or widely-spaced blips across a
                        # large file would eventually fail the whole task
                        attempt = 0
                        bo.reset()
                    last_fail_at = yielded
                    attempt += 1
                    if not policy.retryable(e) or attempt >= policy.max_attempts:
                        queue.fail(tid)
                        raise
                    from .. import profiler

                    profiler.incr(policy.counter)
                    _time.sleep(bo.next())
            queue.finish(tid)

    return read

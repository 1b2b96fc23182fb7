"""Readers (PyTorch port of ``paddle_tpu/reader``): the decorators of
``decorator.py``.  ``recordio`` (the sharded record files and the
dispatched reader) needs ``native``'s RecordIO writer and prefetcher, and
waits for ROADMAP A.10."""
from .decorator import (
    ComposeNotAligned,
    batch,
    bucket_by_length,
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    pipe_reader,
    shuffle,
    xmap_readers,
)

__all__ = [
    "ComposeNotAligned",
    "batch",
    "bucket_by_length",
    "buffered",
    "cache",
    "chain",
    "compose",
    "firstn",
    "map_readers",
    "pipe_reader",
    "shuffle",
    "xmap_readers",
]

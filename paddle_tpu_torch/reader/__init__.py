"""Readers (PyTorch port of ``paddle_tpu/reader``): the decorators of
``decorator.py`` and ``recordio`` (the sharded record files, the native
prefetch reader and the dispatched reader over a ``native.TaskQueue``)."""
from . import recordio
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
    "recordio",
    "shuffle",
    "xmap_readers",
]

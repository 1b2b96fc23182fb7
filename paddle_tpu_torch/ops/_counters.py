"""One registry of every kernel wrapper's launch counters.

Each wrapper counts its calls that launch its kernel in an attribute of its
own (``paged_attention.launches``, an int; the others dicts of ints, some
nested by dtype or route).  A CUDA graph capture runs the wrappers without
launching anything, so a capture takes a ``snapshot`` before, ``restore``s
it after and keeps the ``delta``; each replay then ``add``s that delta, and
the counters go on counting the launches that ran on the device.

A snapshot is a dict of plain copies by counter name (``"<owner>.<attr>"``).
``restore`` and ``add`` write dict counters in place, so that a reference
to one (``ops.conv.launches``) stays the counter.
"""
from __future__ import annotations

from typing import Any, Dict

from . import conv
from .attention import flash_attention
from .batch_norm import batch_norm_train
from .dropout import threefry_dropout
from .lstm import fused_lstm
from .paged_attention import paged_attention

# name -> (owner, attribute)
COUNTERS = {
    "paged_attention.launches": (paged_attention, "launches"),
    "flash_attention.launches": (flash_attention, "launches"),
    "flash_attention.dtype_launches": (flash_attention, "dtype_launches"),
    "fused_lstm.launches": (fused_lstm, "launches"),
    "fused_lstm.route_launches": (fused_lstm, "route_launches"),
    "batch_norm_train.launches": (batch_norm_train, "launches"),
    "conv.launches": (conv, "launches"),
    "conv.route_launches": (conv, "route_launches"),
    "threefry_dropout.launches": (threefry_dropout, "launches"),
    "threefry_dropout.dtype_launches": (threefry_dropout, "dtype_launches"),
}


def _copy(v):
    return {k: _copy(x) for k, x in v.items()} if isinstance(v, dict) else v


def _combine(f, a, b):
    if isinstance(a, dict):
        return {k: _combine(f, a[k], b[k]) for k in a}
    return f(a, b)


def _write(cur: dict, value: dict) -> None:
    for k, v in value.items():
        if isinstance(v, dict):
            _write(cur[k], v)
        else:
            cur[k] = v


def snapshot() -> Dict[str, Any]:
    """Every counter's current value, copied."""
    return {name: _copy(getattr(o, a)) for name, (o, a) in COUNTERS.items()}


def restore(snap: Dict[str, Any]) -> None:
    """Set every counter back to ``snap``."""
    for name, (o, a) in COUNTERS.items():
        if isinstance(snap[name], dict):
            _write(getattr(o, a), snap[name])
        else:
            setattr(o, a, snap[name])


def delta(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, Any]:
    """``after - before``, counter by counter."""
    return {name: _combine(lambda x, y: y - x, before[name], after[name])
            for name in COUNTERS}


def add(d: Dict[str, Any]) -> None:
    """Add a ``delta`` to every counter."""
    now = snapshot()
    restore({name: _combine(lambda x, y: x + y, now[name], d[name])
             for name in COUNTERS})

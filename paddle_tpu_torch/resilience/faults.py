"""Process-wide fault injection registry (the port's copy of
``paddle_tpu/resilience/faults.py``).

A failure path carries a named site, a one-line ``check("site")`` call, and
tests arm a site with ``inject(...)`` to raise a real error through the real
call stack.  ``check`` returns at once while no site is armed.

Sites in this package:
  serving.prefix_match
                    one prefix-cache lookup at continuous-decode admission
                    (``serving/decode.py`` ``ContinuousScheduler._match_prefix``)
                    — a fired fault makes THAT admission a cache miss: the
                    request pays a cold full-history prefill, its stream is
                    unchanged, nothing aborts
  serving.fork      one copy-on-write fork of a live generation
                    (``ContinuousScheduler._fork_state``, beam re-gathers)
                    — a fired fault degrades THAT fork to a private
                    full-lineage recompute instead of sharing the parent's
                    blocks; every branch's stream is unchanged
  queue.pop         ``native.TaskQueue.get``, before the native pop
  reader.pipeline   every record that ``reader.recordio`` streams
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Union

_lock = threading.Lock()
_sites: Dict[str, "_Fault"] = {}
_fired: Dict[str, int] = {}


class _Fault:
    def __init__(self, error, prob: Optional[float], count: Optional[int],
                 seed):
        self.error = error
        self.prob = prob
        self.remaining = count  # None = unlimited
        self.rng = random.Random(seed)

    def should_fire(self) -> bool:
        if self.remaining is not None and self.remaining <= 0:
            return False
        if self.prob is not None and self.rng.random() >= self.prob:
            return False
        if self.remaining is not None:
            self.remaining -= 1
        return True


def inject(site: str, error: Union[BaseException, type],
           prob: Optional[float] = None, count: Optional[int] = None,
           seed: int = 0) -> None:
    """Arm ``site``: the next check() raises ``error`` (instance or class).
    ``prob`` fires probabilistically (a seeded per-site RNG); ``count``
    caps total firings; both None = fire every time until clear()."""
    with _lock:
        _sites[site] = _Fault(error, prob, count, seed)
        _fired.setdefault(site, 0)


def clear(site: Optional[str] = None) -> None:
    with _lock:
        if site is None:
            _sites.clear()
            _fired.clear()
        else:
            _sites.pop(site, None)


def fired(site: str) -> int:
    """How many times ``site`` actually raised."""
    return _fired.get(site, 0)


def check(site: str) -> None:
    """The planted probe: no-op unless the site is armed and elects to
    fire."""
    if not _sites:  # fast path: nothing armed anywhere
        return
    with _lock:
        f = _sites.get(site)
        if f is None or not f.should_fire():
            return
        _fired[site] = _fired.get(site, 0) + 1
        err = f.error
    raise err if isinstance(err, BaseException) else err(
        f"injected fault at {site}")


class active:
    """Context manager: arm a site for the block, always disarm after.

        with faults.active("serving.fork", RuntimeError("down"), count=1):
            ...
    """

    def __init__(self, site: str, error, prob=None, count=None,
                 seed: int = 0):
        self.site = site
        self.args = (error, prob, count, seed)

    def __enter__(self):
        inject(self.site, *self.args)
        return self

    def __exit__(self, *exc):
        clear(self.site)

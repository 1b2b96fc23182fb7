"""Unique-name generator for variables/ops (ref: python/paddle/v2/fluid framework
name uniquing; the reference derives unique names inside LayerHelper)."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class NameGenerator:
    def __init__(self):
        self._counters = defaultdict(int)

    def generate(self, prefix: str) -> str:
        idx = self._counters[prefix]
        self._counters[prefix] += 1
        return f"{prefix}_{idx}"

    def reset(self):
        self._counters.clear()


_generator = NameGenerator()


def generate(prefix: str) -> str:
    return _generator.generate(prefix)


def reset():
    _generator.reset()


@contextlib.contextmanager
def guard():
    """Fresh name namespace (used by tests to get reproducible names)."""
    global _generator
    old = _generator
    _generator = NameGenerator()
    try:
        yield
    finally:
        _generator = old

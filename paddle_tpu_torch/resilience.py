"""Request deadlines for the serving loop: the port's own copy of
``Deadline`` and ``DeadlineExceeded`` (``paddle_tpu/resilience/policy.py``)."""
from __future__ import annotations

import time
from typing import Optional


class DeadlineExceeded(TimeoutError):
    """A Deadline ran out (request-level timeout, not a transport error)."""


class Deadline:
    """A monotonic-clock budget for one request: ``check()`` raises
    DeadlineExceeded once the budget is spent.  ``clock`` is injectable for
    tests."""

    def __init__(self, timeout_s: Optional[float], clock=time.monotonic):
        self._clock = clock
        self._expires = None if timeout_s is None else clock() + timeout_s

    def remaining(self) -> float:
        if self._expires is None:
            return float("inf")
        return self._expires - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what} exceeded its deadline "
                                   f"(over by {-self.remaining():.3f}s)")

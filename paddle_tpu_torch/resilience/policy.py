"""Retry, backoff and deadlines (the port's copy of the retry half of
``paddle_tpu/resilience/policy.py``).

One idiom for every failure loop (the Go generation's bounded retries with
exponential backoff around every RPC, go/master/client.go): a declarative
``RetryPolicy``, a ``Backoff`` schedule with jitter, the ``retry``
wrapper, and a monotonic ``Deadline``.  ``io.CheckpointManager.restore``
retries a checkpoint load once in place before it quarantines it, and
``datasets.common.download`` refetches once.

The reference bumps a profiler counter on every retry; ``profiler.py`` is
ROADMAP A.10, and so is the ``CircuitBreaker`` with its gauge, which the
serving ``Session`` calls.  Standard library only.
"""
from __future__ import annotations

import functools
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


class TransientError(Exception):
    """An error the caller is expected to retry (fault injection's
    favourite; the moral equivalent of a retryable RPC status)."""


class DeadlineExceeded(TimeoutError):
    """A Deadline ran out (request-level timeout, not a transport error)."""


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to try and how long to wait between tries.

    ``jitter`` is the +/- fraction applied to each delay (0.5: uniform in
    [0.5d, 1.5d]); delays are always clamped to [0, max_delay_s], so the
    bound holds for jittered values too.  (The reference's ``counter``,
    the profiler counter a retry bumps, waits for ``profiler.py``: ROADMAP
    A.10.)"""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    retry_on: Tuple[Type[BaseException], ...] = (TransientError, IOError,
                                                 OSError)

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retry_on)


class Backoff:
    """The delay schedule of a RetryPolicy as a stateful object: ``next()``
    returns the delay for this failure and advances; ``reset()`` starts
    over after a success."""

    def __init__(self, policy: Optional[RetryPolicy] = None, seed=None, **kw):
        self.policy = policy or RetryPolicy(**kw)
        self._rng = random.Random(seed)
        self._attempt = 0

    def peek(self) -> float:
        """The un-jittered delay the next ``next()`` call jitters around."""
        p = self.policy
        return min(p.base_delay_s * (p.multiplier ** self._attempt),
                   p.max_delay_s)

    def next(self) -> float:
        p = self.policy
        d = self.peek()
        if p.jitter:
            d *= 1.0 + self._rng.uniform(-p.jitter, p.jitter)
        self._attempt += 1
        return min(max(d, 0.0), p.max_delay_s)

    def reset(self) -> None:
        self._attempt = 0


def retry(policy: Optional[RetryPolicy] = None,
          sleep: Callable[[float], None] = time.sleep,
          deadline: Optional["Deadline"] = None):
    """Decorator/wrapper: ``retry(policy)(fn)(*args)`` calls fn up to
    ``policy.max_attempts`` times, sleeping a jittered exponential backoff
    between retryable failures.  Non-retryable exceptions propagate at
    once; the last retryable one propagates when the attempts (or the
    optional deadline) run out."""
    policy = policy or RetryPolicy()

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            bo = Backoff(policy)
            for attempt in range(policy.max_attempts):
                try:
                    return fn(*args, **kwargs)
                except BaseException as e:
                    last_try = attempt == policy.max_attempts - 1
                    if last_try or not policy.retryable(e):
                        raise
                    if deadline is not None and deadline.expired():
                        raise
                    sleep(bo.next())
            raise AssertionError("unreachable")  # pragma: no cover

        return wrapped

    return deco


class Deadline:
    """A monotonic-clock budget for one request or operation: ``check()``
    raises DeadlineExceeded once the budget is spent.  ``clock`` is
    injectable for tests."""

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

"""Retry, backoff, deadlines and the circuit breaker (the port's copy of
``paddle_tpu/resilience/policy.py``).

One idiom for every failure loop (the Go generation's bounded retries with
exponential backoff around every RPC, go/master/client.go): a declarative
``RetryPolicy``, a ``Backoff`` schedule with jitter, the ``retry``
wrapper, a monotonic ``Deadline``, and a ``CircuitBreaker`` for
serving-side load shedding (``capi_server.Session``).
``io.CheckpointManager.restore`` retries a checkpoint load once in place
before it quarantines it, and ``datasets.common.download`` refetches once.
Every retry, open and shed bumps a ``profiler`` counter
(``resilience.retries``, ``resilience.circuit_open``,
``resilience.shed``); a named breaker publishes its state as the
``resilience.breaker_state`` labeled gauge.  Standard library only.
"""
from __future__ import annotations

import functools
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type


class TransientError(Exception):
    """An error the caller is expected to retry (fault injection's
    favourite; the moral equivalent of a retryable RPC status)."""


def _incr(name: str) -> None:
    from ..profiler import incr

    incr(name)


class DeadlineExceeded(TimeoutError):
    """A Deadline ran out (request-level timeout, not a transport error)."""


class CircuitOpenError(RuntimeError):
    """The circuit breaker is open: the call was shed without being tried."""


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to try and how long to wait between tries.

    ``jitter`` is the +/- fraction applied to each delay (0.5: uniform in
    [0.5d, 1.5d]); delays are always clamped to [0, max_delay_s], so the
    bound holds for jittered values too.  ``counter`` is the profiler
    counter a retry bumps."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    retry_on: Tuple[Type[BaseException], ...] = (TransientError, IOError,
                                                 OSError)
    counter: str = "resilience.retries"

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
    optional deadline) run out.  Each retry increments
    ``policy.counter``."""
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
                    _incr(policy.counter)
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


# numeric encoding of breaker state for the resilience.breaker_state gauge
# (closed < half_open < open, so alert thresholds read naturally)
BREAKER_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


def _breaker_gauge(name: Optional[str], state: str) -> None:
    """Publish a NAMED breaker's state as the ``resilience.breaker_state``
    labeled gauge: the Prometheus-visible form of what healthz shows."""
    if name is None:
        return
    from ..obs import metrics as _m

    try:
        _m.labeled_gauge("resilience.breaker_state").set(
            BREAKER_STATE_VALUES[state], name=name)
    except Exception:  # noqa: BLE001
        pass  # exporting state must never break the breaker itself


@dataclass
class CircuitBreaker:
    """Closed -> (failure_threshold consecutive failures) -> open -> after
    ``reset_timeout_s`` -> half-open probe -> success closes / failure
    re-opens.  While open, ``allow()`` raises CircuitOpenError so callers
    shed load instead of queueing onto a failing backend.
    Thread-compatible: the races (two probes in half-open) are benign, state
    only moves between valid states.

    ``name`` opts the breaker into the ``resilience.breaker_state`` labeled
    gauge (0=closed, 1=half_open, 2=open): every transition, the lazy
    open -> half_open flip inside ``state`` included, publishes, so a scrape
    never shows a breaker stuck open that healthz would call half-open."""

    failure_threshold: int = 5
    reset_timeout_s: float = 30.0
    clock: Callable[[], float] = time.monotonic
    name: Optional[str] = None
    _failures: int = field(default=0, init=False)
    _state: str = field(default="closed", init=False)
    _opened_at: float = field(default=0.0, init=False)

    def __post_init__(self):
        _breaker_gauge(self.name, self._state)

    def _transition(self, state: str) -> None:
        if state != self._state:
            self._state = state
            _breaker_gauge(self.name, state)

    @property
    def state(self) -> str:
        if (self._state == "open"
                and self.clock() - self._opened_at >= self.reset_timeout_s):
            self._transition("half_open")
        return self._state

    def allow(self) -> None:
        if self.state == "open":
            _incr("resilience.shed")
            raise CircuitOpenError(
                f"circuit open after {self._failures} consecutive failures; "
                f"retry in {self.reset_timeout_s - (self.clock() - self._opened_at):.1f}s")

    def record_success(self) -> None:
        self._failures = 0
        self._transition("closed")

    def record_failure(self) -> None:
        self._failures += 1
        # read through the PROPERTY: a failure after the reset window is a
        # failed half-open probe (re-open, no counter), not a fresh streak
        if self.state == "half_open" or self._failures >= self.failure_threshold:
            if self._state != "open":
                _incr("resilience.circuit_open")
            self._transition("open")
            self._opened_at = self.clock()

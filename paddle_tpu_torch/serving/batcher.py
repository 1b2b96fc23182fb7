"""Admission for the streaming decode loop (the port's copy of the decode
half of ``paddle_tpu/serving/batcher.py``): the bucket ladder helpers and the
length-tiered ``DecodeAdmissionQueue`` with its deadline shed and aging
guard."""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from ..resilience import DeadlineExceeded


class AdmissionShed(DeadlineExceeded):
    """Request deadline expired while queued: shed before admission, before
    any slot or KV block was spent on it."""


def build_bucket_ladder(max_size: int, buckets: Optional[Sequence[int]] = None,
                        base: int = 1) -> List[int]:
    """Explicit ``buckets`` verbatim (sorted, deduplicated), else powers of
    two from ``base`` up to AND INCLUDING ``max_size``."""
    if buckets:
        return sorted(set(int(b) for b in buckets))
    out, b = [], base
    while b < max_size:
        out.append(b)
        b *= 2
    out.append(int(max_size))
    return sorted(set(out))


def bucket_for(ladder: Sequence[int], n: int, *,
               what: str = "batch rows") -> int:
    """Smallest bucket >= n; oversize is a ValueError."""
    for b in ladder:
        if b >= n:
            return b
    top = ladder[-1] if ladder else 0
    raise ValueError(f"{what} {n} exceeds largest bucket {top}")


class DecodeAdmissionQueue:
    """Waiting room of the continuous decode loop.

      * deadline-expired waiters are shed before a slot or a KV block is
        spent on them (``shed_expired``);
      * admission is LENGTH-TIERED: when several waiters fit, the shortest
        prompt tier (by the bucket ladder) admits first;
      * an AGING GUARD bounds the tiering: once the oldest waiter has waited
        past ``max_wait_ms``, only the oldest is eligible (strict FIFO), so a
        long prompt is never starved by a stream of short ones.
    """

    def __init__(self, prompt_buckets: Sequence[int],
                 max_wait_ms: float = 200.0):
        self._ladder = sorted(int(b) for b in prompt_buckets)
        self.max_wait_ms = float(max_wait_ms)
        self._q: List = []  # DecodeRequest-shaped, arrival order

    def __len__(self) -> int:
        return len(self._q)

    def _tier(self, req) -> int:
        n = req.prompt_len
        for b in self._ladder:
            if b >= n:
                return b
        return n  # oversize: its own tier, last

    def push(self, req) -> None:
        req.enqueued_at = time.monotonic()
        self._q.append(req)

    def requeue(self, req) -> None:
        """Re-admit WITHOUT restamping the enqueue time: a preempted request
        keeps the aging credit it already earned."""
        self._q.append(req)

    def shed_expired(self) -> List:
        """Remove and return every waiter whose deadline already expired."""
        shed = [r for r in self._q
                if r.deadline is not None and r.deadline.expired()]
        if shed:
            self._q = [r for r in self._q if r not in shed]
        return shed

    def pop(self, fits: Optional[Callable] = None):
        """Next admissible waiter under the tiered policy, or None.  ``fits``
        says whether the scheduler can seat a request right now; under the
        aging guard only the oldest waiter is eligible."""
        if not self._q:
            return None
        oldest = self._q[0]
        if (time.monotonic() - oldest.enqueued_at) * 1e3 > self.max_wait_ms:
            if fits is None or fits(oldest):
                self._q.pop(0)
                return oldest
            return None  # head-of-line holds its turn until it fits
        for req in sorted(self._q,
                          key=lambda r: (self._tier(r), r.enqueued_at)):
            if fits is None or fits(req):
                self._q.remove(req)
                return req
        return None

    def drain(self) -> List:
        out, self._q = self._q, []
        return out

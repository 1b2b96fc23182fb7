"""Typed metric registry: Counter / Gauge / Histogram with exporters.

The reference accumulated per-pass timers in a global Stat table
(paddle/utils/Stat.h) and printed them; profiler.py kept that shape, with
counters and gauges for recovery and serving telemetry.  This module is the typed replacement: one registry,
three metric kinds, two exporters (Prometheus text exposition for scraping,
JSON snapshot for healthz/bench records/postmortems).  ``profiler.incr`` /
``profiler.gauge`` now delegate here, so every existing call site and every
existing reader (healthz, stats_report, tests) sees the same numbers through
the same names.

The port's copy of ``paddle_tpu/obs/metrics.py``: standard library only,
so a parent process or a script can read and export metrics without
loading torch.

Naming: ``^[a-z0-9_.]+$`` enforced at registration (the name lint in
``tests/test_torch_obs.py`` additionally pins every literal name in the
port's sources to the one table in obs/names.py).  Dots are the in-process namespace separator;
the Prometheus exporter maps them to underscores (its grammar has no dots).
"""
from __future__ import annotations

import bisect
import json
import re
import threading
import time
from typing import Dict, List, Optional, Sequence

NAME_RE = re.compile(r"^[a-z0-9_.]+$")

# default histogram buckets (milliseconds) — latency-shaped: sub-ms host ops
# through multi-second compiles.  Upper bounds; +Inf is implicit.
DEFAULT_MS_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def _check_name(name: str) -> str:
    if not NAME_RE.match(name or ""):
        raise ValueError(f"metric name {name!r} must match {NAME_RE.pattern}")
    return name


class Counter:
    """Monotonic event count.  ``inc`` is a lock-protected add — serving and
    reader threads bump concurrently and a lost recovery count defeats the
    point of counting recoveries (same contract profiler.py documented)."""

    kind = "counter"
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = _check_name(name)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-observed value (queue depth, occupancy) — a current-state signal
    a counter cannot carry (a deep queue an hour ago must not look like one
    now)."""

    kind = "gauge"
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = _check_name(name)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket distribution (upper bounds ascending; +Inf implicit).
    ``observe`` is O(log buckets) + one lock — cheap enough for per-step and
    per-batch latencies, which is all the hot paths record."""

    kind = "histogram"
    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = _check_name(name)
        bs = tuple(float(b) for b in (buckets or DEFAULT_MS_BUCKETS))
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"ascending, got {bs}")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Dict:
        with self._lock:
            counts = list(self._counts)
            return {"buckets": list(self.buckets), "counts": counts,
                    "sum": self._sum, "count": self._count}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class LabeledGauge:
    """A gauge with one value PER LABELSET (``set(v, name="serving")``) —
    Prometheus's labeled series for the few metrics where one number per
    process genuinely isn't enough (e.g. ``resilience.breaker_state``: every
    named circuit breaker reports its own state through one metric).  Kept
    deliberately minimal: gauges only, no label-cardinality bookkeeping —
    label values here are small fixed sets (breaker names, replica ids),
    not request-scoped data."""

    kind = "gauge"
    __slots__ = ("name", "_values", "_lock")

    def __init__(self, name: str):
        self.name = _check_name(name)
        self._values: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def value(self, default: float = 0.0, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, default)

    def remove(self, **labels) -> bool:
        """Drop one labelset's row entirely (returns whether it existed).
        Retirement hygiene: a labelset whose subject is gone for good (e.g. a
        scaled-in replica's breaker) must leave the exposition, not freeze at
        its last value — stale rows accumulate without bound under autoscale
        churn and read as live state to every scrape."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.pop(key, None) is not None

    def snapshot(self) -> List[Dict]:
        """Structured per-labelset rows — ``[{"labels": {...}, "value": v}]``
        — so JSON/healthz consumers can address a specific series (e.g.
        ``resilience.breaker_state`` for one replica) without parsing a
        flattened ``k=v,k2=v2`` string key."""
        with self._lock:
            items = sorted(self._values.items())
        return [{"labels": {k: v for k, v in key}, "value": val}
                for key, val in items]

    def prometheus_lines(self, pname: str) -> List[str]:
        def esc(v) -> str:  # label-value escaping per the exposition format
            return str(v).replace("\\", "\\\\").replace('"', '\\"')

        with self._lock:
            items = sorted(self._values.items())
        out = []
        for key, val in items:
            lbls = ",".join(f'{k}="{esc(v)}"' for k, v in key)
            out.append(f"{pname}{{{lbls}}} {_fmt(val)}" if lbls
                       else f"{pname} {_fmt(val)}")
        return out


class Registry:
    """One table of named typed metrics.  get-or-create accessors; asking for
    an existing name with a different kind (or different histogram buckets)
    is a programming error surfaced loudly — silent kind drift is exactly the
    stringly-typed rot this module replaces."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                                f"{cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._get_or_create(name, Histogram, buckets)
        if buckets is not None and tuple(float(b) for b in buckets) != h.buckets:
            raise ValueError(f"histogram {name!r} already registered with "
                             f"buckets {h.buckets}")
        return h

    def labeled_gauge(self, name: str) -> LabeledGauge:
        return self._get_or_create(name, LabeledGauge)

    # ------------------------------------------------------------- read side
    def counter_value(self, name: str, default: int = 0) -> int:
        with self._lock:
            m = self._metrics.get(name)
        return m.value if isinstance(m, Counter) else default

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            m = self._metrics.get(name)
        return m.value if isinstance(m, Gauge) else default

    def counters(self, prefix: str = "") -> Dict[str, int]:
        with self._lock:
            ms = list(self._metrics.values())
        return {m.name: m.value for m in ms
                if isinstance(m, Counter) and m.name.startswith(prefix)}

    def gauges(self, prefix: str = "") -> Dict[str, float]:
        with self._lock:
            ms = list(self._metrics.values())
        return {m.name: m.value for m in ms
                if isinstance(m, Gauge) and m.name.startswith(prefix)}

    def reset(self) -> None:
        """Drop every metric (tests and profiler.reset_stats).  Metrics are
        re-created on next use; holders of old objects keep a detached
        instance, which is fine — a reset mid-flight is a test-only event."""
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------ exporters
    def snapshot(self) -> Dict:
        """JSON-safe snapshot: {counters, gauges, histograms, time}."""
        with self._lock:
            ms = list(self._metrics.values())
        out = {"time": time.time(), "counters": {}, "gauges": {},
               "histograms": {}, "labeled": {}}
        for m in sorted(ms, key=lambda m: m.name):
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            elif isinstance(m, LabeledGauge):
                out["labeled"][m.name] = m.snapshot()
            else:
                out["histograms"][m.name] = m.snapshot()
        return out

    def prometheus(self) -> str:
        """Text exposition (the format a Prometheus scrape expects): for each
        metric a ``# TYPE`` line then value line(s); histograms emit
        cumulative ``_bucket{le=...}`` counts (monotonic by construction),
        ``_sum`` and ``_count``.  Dots become underscores — Prometheus names
        have no dot in their grammar."""
        with self._lock:
            ms = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in ms:
            pname = m.name.replace(".", "_")
            lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, Counter):
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"{pname} {_fmt(m.value)}")
            elif isinstance(m, LabeledGauge):
                lines.extend(m.prometheus_lines(pname))
            else:
                s = m.snapshot()
                cum = 0
                for ub, c in zip(s["buckets"], s["counts"]):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{_fmt(ub)}"}} {cum}')
                cum += s["counts"][-1]
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {_fmt(s['sum'])}")
                lines.append(f"{pname}_count {s['count']}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Float formatting without exponent surprises for round numbers."""
    if float(v) == int(v):
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------- default registry

_default = Registry()


def default_registry() -> Registry:
    return _default


def counter(name: str) -> Counter:
    return _default.counter(name)


def gauge(name: str) -> Gauge:
    return _default.gauge(name)


def histogram(name: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _default.histogram(name, buckets)


def labeled_gauge(name: str) -> LabeledGauge:
    return _default.labeled_gauge(name)


def counter_value(name: str, default: int = 0) -> int:
    return _default.counter_value(name, default)


def gauge_value(name: str, default: float = 0.0) -> float:
    return _default.gauge_value(name, default)


def snapshot() -> Dict:
    return _default.snapshot()


def prometheus() -> str:
    return _default.prometheus()


def reset() -> None:
    _default.reset()


def snapshot_json(indent: Optional[int] = None) -> str:
    return json.dumps(snapshot(), indent=indent)

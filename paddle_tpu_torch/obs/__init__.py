"""Observability (PyTorch port of ``paddle_tpu/obs``): typed metrics, span
tracing, the crash flight recorder, the HTTP exposer and device-time
attribution.

  metrics    Counter/Gauge/Histogram registry with Prometheus text
             exposition and JSON snapshot exporters; ``profiler.incr`` /
             ``gauge`` are thin shims over it.
  trace      ``with obs.span("train.step", step=i): ...``: thread-aware
             spans in a bounded ring (``PADDLE_TPU_TRACE``), exported as
             Chrome trace-event JSON (``PADDLE_TPU_TRACE_DIR``,
             ``PADDLE_TPU_TRACE_LABEL``); near-zero cost while disabled.
  recorder   flight recorder: ring of recent step records and resilience
             events, dumped to a postmortem JSON (metrics snapshot and all
             thread stacks; ``PADDLE_TPU_POSTMORTEM_DIR``) on a watchdog
             hang, an anomaly rollback and a preemption drain.
  http       optional stdlib exposer: GET /metrics + /healthz.
  prof       device-time attribution: the signature cost ledger (flops and
             bytes counted at each signature's capture), sampled dispatch
             timing (``PADDLE_TPU_PROF_SAMPLE``) and the hotspot report.
  names      the table every literal metric and span name is linted
             against.

Metric and span names, environment variables, file names and JSON schemas
are the reference's, so that a dashboard or a parent process reads either
package the same way.  Standard library only (``prof.analyze`` imports
torch when it is called).
"""
from . import http, metrics, names, prof, recorder, trace
from .trace import span

__all__ = ["http", "metrics", "names", "prof", "recorder", "trace", "span"]

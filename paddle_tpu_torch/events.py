"""Training events (PyTorch port of ``paddle_tpu/events.py``; ref:
python/paddle/v2/event.py:45-88): BeginPass / EndPass / BeginIteration /
EndIteration carrying cost and metrics to user callbacks, and the
preemption, restore, serving-batch and anomaly events, as plain
dataclasses.  ``trainer.SparseEmbeddingTrainer.train`` reports
``EndIteration``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class BeginPass:
    pass_id: int


@dataclass
class EndPass:
    pass_id: int
    metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


@dataclass
class EndIteration:
    pass_id: int
    batch_id: int
    cost: float
    metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class Preempted:
    """The process received a preemption notice (SIGTERM/SIGINT) and is
    draining: the in-flight step was finished, a checkpoint + dataset-queue
    snapshot were written at ``step``, and the process exits with the
    resumable code (resilience.cluster.EXIT_PREEMPTED) right after this
    event — the handler's last chance to flush logs/metrics."""
    pass_id: int
    batch_id: int
    step: int


@dataclass
class RestoreAgreed:
    """Multi-host restore agreement resolved: this host's newest intact
    checkpoint was ``local_step`` (None = nothing restorable) and the gang
    agreed to restore ``agreed_step`` (None = everyone cold-starts).  Only
    emitted when process_count() > 1 — the single-host path never gathers."""
    local_step: object
    agreed_step: object


@dataclass
class ServingBatchExecuted:
    """One coalesced device batch left the serving batcher (the serving-side
    counterpart of EndIteration — delivered to the DynamicBatcher's optional
    ``on_batch`` observer, e.g. a benchmark harness or a metrics exporter).
    ``rows`` is the real request rows executed, ``bucket`` the padded batch
    size actually run on the device (pad waste = 1 - rows/bucket),
    ``requests`` how many client calls were coalesced, ``queue_depth`` the
    queue length left behind, ``wait_ms`` how long the oldest admitted
    request sat in the queue."""
    rows: int
    bucket: int
    requests: int
    queue_depth: int
    wait_ms: float


@dataclass
class AnomalyDetected:
    """A non-finite loss/gradient step the anomaly guard skipped (the
    parameter update was suppressed on-device; training continues with the
    next batch).  ``consecutive`` counts the current run of anomalous steps —
    past the Trainer's budget a checkpoint rollback follows."""
    pass_id: int
    batch_id: int
    cost: float
    consecutive: int

"""THE table of metric and span names (the port's copy of
``paddle_tpu/obs/names.py``, entry for entry, so that a dashboard reads
either package the same way).  Every literal name the port passes to
``profiler.incr/gauge/counter``, ``obs.metrics.counter/gauge/histogram`` or
``obs.span`` must appear here; ``tests/test_torch_obs.py`` lints the port's
sources against it, and lists each name the port does not emit yet with the
ROADMAP item that will.

Grammar: ``^[a-z0-9_.]+$`` (dots namespace; the Prometheus exporter maps
them to underscores).
"""
from __future__ import annotations

import re

NAME_RE = re.compile(r"^[a-z0-9_.]+$")

# name -> kind ("counter" | "gauge" | "histogram" | "labeled_gauge")
METRICS = {
    # training loop
    "train.epochs": "counter",
    "train.steps": "counter",
    "train.step_ms": "histogram",
    "train.data_wait_ms": "histogram",
    "train.fetch_ms": "histogram",
    # checkpointing
    "ckpt.saves": "counter",
    "ckpt.restores": "counter",
    "ckpt.save_ms": "histogram",
    "ckpt.restore_ms": "histogram",
    # resilience / recovery
    "resilience.retries": "counter",
    "resilience.anomalies_skipped": "counter",
    "resilience.rollbacks": "counter",
    "resilience.ckpt_fallbacks": "counter",
    "resilience.circuit_open": "counter",
    "resilience.shed": "counter",
    "resilience.deadline_missed": "counter",
    "resilience.preemptions": "counter",
    "resilience.hang_kills": "counter",
    "resilience.restarts": "counter",
    "resilience.hang_restarts": "counter",
    "resilience.crash_restarts": "counter",
    "resilience.restore_agreements": "counter",
    "resilience.restore_downgrades": "counter",
    # every NAMED CircuitBreaker publishes 0=closed/1=half_open/2=open per
    # breaker through one labeled series (policy.CircuitBreaker(name=...))
    "resilience.breaker_state": "labeled_gauge",
    # serving
    "serving.jit_traces": "counter",
    "serving.decode_traces": "counter",
    "serving.batches": "counter",
    "serving.batched_requests": "counter",
    "serving.pad_rows": "counter",
    "serving.batch_sheds": "counter",
    "serving.isolation_reruns": "counter",
    "serving.queue_depth": "gauge",
    "serving.batch_occupancy": "gauge",
    "serving.queue_wait_ms": "histogram",
    "serving.batch_exec_ms": "histogram",
    # continuous decode: paged KV + iteration-level scheduling
    # (DESIGN.md §17)
    "serving.decode.slots_active": "gauge",    # occupied decode slots
    "serving.decode.waiting": "gauge",         # admission-queue depth
    "serving.decode.blocks_free": "gauge",     # KV pool free blocks
    "serving.decode.prefill_inserts": "counter",  # joins (incl. resumes)
    "serving.decode.retired": "counter",          # leaves (any outcome)
    "serving.decode.sheds": "counter",         # deadline-expired waiters
    "serving.decode.preemptions": "counter",   # pool-pressure evictions
    "serving.decode.spec_proposed": "counter",  # draft tokens offered
    "serving.decode.spec_accepted": "counter",  # ...verified and kept
    # generation-surviving serving (DESIGN.md §20)
    "serving.decode.resumed_in": "counter",    # streams seeded from a
    #                                            resume prefix (migration or
    #                                            crash failover re-admission)
    "serving.decode.migrated_out": "counter",  # streams snapshot off this
    #                                            replica by a drain
    "serving.decode.bad_frees": "counter",     # rejected pool frees (double-
    #                                            free / trash / out-of-range)
    # prefix-aware KV reuse (DESIGN.md §21)
    "serving.prefix.hits": "counter",        # admissions with >=1 matched block
    "serving.prefix.miss": "counter",        # admissions matching nothing
    "serving.prefix.hit_tokens": "counter",  # prompt tokens NOT re-prefilled
    "serving.prefix.cached_blocks": "gauge",  # pool blocks the cache tracks
    "serving.prefix.evictions": "counter",   # refcount-0 blocks reclaimed
    "serving.prefix.cow_copies": "counter",  # divergent/partial blocks
    #                                          recomputed privately (the
    #                                          copy half of copy-on-write)
    # decoding-policy subsystem (DESIGN.md §25) — sampled slots and
    # COW-forked generations (parallel-n branches, beam re-gathers)
    "serving.sample.requests": "counter",   # non-greedy submissions admitted
    "serving.fork.forks": "counter",        # fork events (branch seats +
    #                                         beam re-gather forks)
    "serving.fork.cow_blocks": "counter",   # lineage blocks SHARED by forks
    #                                         (refcount acquire, zero prefill)
    "serving.fork.private": "counter",      # forks degraded to a private
    #                                         full-lineage recompute (cache
    #                                         off, miss, or injected fault)
    "serving.fork.groups": "gauge",         # live beam groups on the batch
    # quantized paged-KV serving arm (DESIGN.md §22) — CAPACITY facts and
    # the cross-dtype resume guard; density gauges are set at engine build
    # (static for the pool's lifetime) and never fold into load signals
    "serving.quant.bytes_per_token": "gauge",   # K+V bytes per live token
    #                                             (scale planes included)
    "serving.quant.slots_per_gib": "gauge",     # full max_len slots one GiB
    #                                             of arena holds at this dtype
    "serving.quant.resume_dtype_mismatch": "counter",  # resume records from a
    #                                             pool of another kv_dtype:
    #                                             re-prefilled cold, counted
    # fused paged decode-attention kernel (DESIGN.md §24)
    "serving.decode.kernel_impl": "gauge",     # 1 = fused Pallas kernel,
    #                                            0 = composed gather+einsum;
    #                                            set once at engine build
    "serving.pallas.fallbacks": "counter",     # kernel build/validation
    #                                            failures degraded loudly to
    #                                            the composed path
    # mesh-sharded serving tier (DESIGN.md §18)
    "serving.mesh.devices": "gauge",          # devices in the serving mesh
    "serving.mesh.axis_size": "labeled_gauge",  # per-axis size (data/fsdp/tp)
    "serving.mesh.params_sharded": "gauge",   # params with a non-replicated spec
    "serving.mesh.collapsed_axes": "gauge",   # axes degraded below request
    # sparse embedding engine (DESIGN.md §26): streaming id pipeline +
    # dedup-and-bucket lookup + row-touched apply
    "sparse.pipeline.batches": "counter",   # batches dedup/bucketed + staged
    "sparse.pipeline.dedup_ms": "histogram",  # host dedup+bucket per batch
    #                                           (worker thread, overlapped)
    "sparse.pipeline.stall_ms": "histogram",  # consumer blocked on the
    #                                           staging queue — host-bound?
    "sparse.bucket.size": "gauge",          # ladder rung the last batch used
    "sparse.bucket.occupancy": "gauge",     # n_unique / bucket, last batch
    "sparse.lookup.traces": "counter",      # lookup jit signatures minted
    #                                         (one per warm rung; zero growth
    #                                          in steady state)
    "sparse.update.rows_touched": "counter",  # unique rows gathered/updated
    #                                           — the bytes-touched fact the
    #                                           ctr_sparse A/B gates on
    # compile subsystem (DESIGN.md §14)
    "compile.executor_compiles": "counter",  # live step traces (not AOT loads)
    "compile.aot_hits": "counter",
    "compile.aot_misses": "counter",
    "compile.aot_writes": "counter",
    "compile.aot_corrupt": "counter",        # quarantined store entries
    "compile.warmups": "counter",            # warm tasks executed (any outcome)
    "compile.warmup_ms": "histogram",
    # compile-latency accounting (DESIGN.md §23): how long acquiring each
    # executable actually took, split by how it was satisfied — the
    # cold-vs-warm claim as a standing metric instead of a one-off bench.
    # The exact three-way live|aot_exec|aot_export split rides each cost-
    # ledger entry's ``source``/``compile_ms``; these histograms are the
    # scrapeable aggregate (live compiles vs warm loads of either layer).
    "compile.compile_ms": "histogram",   # live trace+XLA-compile wall-ms
    "compile.aot_load_ms": "histogram",  # store-satisfied wall-ms (exec or
    #                                      export layer, deserialize incl.)
    "compile.retraces": "counter",           # steady-state retraces (storm fuel)
    "compile.storms": "counter",             # budget breaches observed
    "compile.warm_start": "gauge",           # 1 = manifest had entries at boot
    "compile.manifest_entries": "gauge",
    "compile.persistent_cache_enabled": "gauge",
    # observability itself
    "obs.postmortems": "counter",
    # device-time attribution (DESIGN.md §23): sampled dispatch timing +
    # the executable cost ledger.  Per-signature stats live in obs.prof's
    # own lock-free snapshot (signatures are unbounded label space, not
    # metric names); these are the bounded aggregates.
    "obs.prof.samples": "counter",      # sampled dispatches recorded
    "obs.prof.sample_ms": "histogram",  # sampled dispatch wall-ms (all sites)
    "obs.prof.ledger_entries": "gauge",  # executables the cost ledger knows
    "obs.prof.ledger_corrupt": "counter",  # quarantined garbage sidecars
    # serving fleet (DESIGN.md §15)
    "fleet.replicas": "gauge",               # configured size
    "fleet.healthy_replicas": "gauge",       # READY + ok healthz right now
    "fleet.tier": "gauge",                   # 0 normal … 3 brownout
    "fleet.routed": "counter",               # requests served through route()
    "fleet.failovers": "counter",            # retried on a different replica
    "fleet.unavailable": "counter",          # no healthy replica at all
    "fleet.hedges": "counter",               # duplicate fired past p99 budget
    "fleet.hedge_wins": "counter",           # ...where the duplicate answered first
    "fleet.sheds": "counter",                # all classes, pre-dispatch refusals
    "fleet.background_sheds": "counter",
    "fleet.batch_sheds": "counter",
    "fleet.brownouts": "counter",            # tier-3 entries
    "fleet.replica_deaths": "counter",       # observed child exits (any cause)
    "fleet.replica_respawns": "counter",     # replacement generations spawned
    "fleet.seq_regressions": "counter",      # healthz_seq went backwards (silent restart)
    "fleet.health_poll_failures": "counter",
    "fleet.interactive_latency_ms": "histogram",
    "fleet.batch_latency_ms": "histogram",
    "fleet.background_latency_ms": "histogram",
    # elastic membership + autoscaling (DESIGN.md §19)
    "fleet.replica_grown": "counter",        # scale-out slots added
    "fleet.replica_retirements": "counter",  # scale-in slots drained + removed
    "fleet.autoscale.desired": "gauge",      # the size the controller steers to
    "fleet.autoscale.replicas": "gauge",     # live slots (incl. draining)
    "fleet.autoscale.occupancy": "gauge",    # load fraction the law last saw
    "fleet.autoscale.breach_rate": "gauge",  # per-tick new-breach fraction
    "fleet.autoscale.scale_outs": "counter",  # acted grow decisions
    "fleet.autoscale.scale_ins": "counter",   # acted shrink decisions
    "fleet.autoscale.holds": "counter",       # signal fired but blocked
    #                                           (cooldown/bounds/precedence)
    "fleet.autoscale.skipped_ticks": "counter",  # tick faults/errors survived
    "fleet.autoscale.observed_only": "counter",  # observe-mode decisions
    "fleet.autoscale.scaleup_ready_s": "histogram",  # grow -> first READY
    # generation-surviving serving (DESIGN.md §20): migration on drain +
    # the router resume journal
    "fleet.generations": "counter",          # fleet-level generations completed
    "fleet.migration.drains": "counter",     # drain snapshots collected
    "fleet.migration.failed": "counter",     # snapshot collection failures
    #                                          (old worker, timeout, fault)
    "fleet.migration.drain_ms": "histogram",  # POST /drain round-trip — the
    #                                           bounded-drain claim's number
    "fleet.migration.records": "counter",    # resume records re-admitted
    "fleet.resume.crash": "counter",         # journal resumes after replica
    #                                          death (SIGKILL, transport loss)
    "fleet.resume.migrate": "counter",       # record resumes after a drain
    "fleet.resume.failed": "counter",        # resume attempts that errored
    #                                          (incl. injected faults)
    "fleet.resume.token_mismatch": "counter",  # record vs journal divergence
    #                                            — zero-tolerance invariant
    "fleet.resume.journal_entries": "gauge",   # in-flight streams journaled
    "fleet.resume.journal_evictions": "counter",  # cap-evicted (lost crash
    #                                               protection, not stream)
    "fleet.drain_killed_inflight": "counter",  # work discarded by SIGKILL
    #                                            escalation past drain_grace_s
    # fleet-wide request tracing + SLO accounting (DESIGN.md §16)
    "fleet.slo.interactive_e2e_ms": "histogram",  # end-to-end, router-measured
    "fleet.slo.batch_e2e_ms": "histogram",
    "fleet.slo.background_e2e_ms": "histogram",
    "fleet.slo.samples": "counter",              # requests with a breakdown
    "fleet.slo.attributed_ratio": "gauge",       # sum(components)/e2e, rolling
    "fleet.slo.interactive_breaches": "counter",  # e2e past the class target
    "fleet.slo.batch_breaches": "counter",
    "fleet.slo.background_breaches": "counter",
}

# span names (obs.span / obs.trace.span)
SPANS = frozenset({
    "train.step",
    "train.data_wait",
    "train.fetch",
    "train.checkpoint",
    "ckpt.save",
    "ckpt.restore",
    "serving.batch_exec",
    "serving.isolation_rerun",
    "compile.aot_write",
    "compile.aot_load",
    "compile.warmup",
    # device-time attribution (DESIGN.md §23): one retroactive span per
    # SAMPLED dispatch — rides the trace ring via record_at so a timed
    # decode step shows up on the request timeline it interleaved with
    "obs.prof.sample",
    # fleet request tracing (DESIGN.md §16) — all carry trace_id
    "fleet.route",          # router: one request end-to-end
    "fleet.dispatch",       # router: one replica hop (retry/hedge = more hops)
    "fleet.request",        # worker: one request inside the replica
    "serving.queue_wait",   # per-request batcher queue wait (retroactive)
    "serving.exec",         # per-request device-exec share (retroactive)
    "serving.decode_prefill",
    "serving.decode_loop",
    # continuous decode loop (DESIGN.md §17)
    "serving.decode.step",            # one iteration of the persistent loop
    "serving.decode.prefill_insert",  # one request joining a slot
    # prefix-aware KV reuse (DESIGN.md §21)
    "serving.prefix.match",           # the chained-hash longest-run lookup
    "serving.fork",                   # one COW fork: register + acquire +
    #                                   private-tail recompute (§25)
    # mesh-sharded serving (DESIGN.md §18)
    "serving.mesh.shard_params",      # the device_put placement pass
    # elastic autoscaling (DESIGN.md §19)
    "fleet.autoscale.tick",           # one pass of the controller law
    # generation-surviving serving (DESIGN.md §20)
    "fleet.generate",                 # router: one generation end-to-end
    "fleet.generation",               # worker: one generation admitted
    "fleet.migration.drain",          # parent: one /drain snapshot collect
    "fleet.resume.readmit",           # router: one crash/migrate resume
})


def _validate():
    for n in list(METRICS) + sorted(SPANS):
        if not NAME_RE.match(n):
            raise ValueError(f"obs name table entry {n!r} violates "
                             f"{NAME_RE.pattern}")
    bad = {n: k for n, k in METRICS.items()
           if k not in ("counter", "gauge", "histogram", "labeled_gauge")}
    if bad:
        raise ValueError(f"obs name table has unknown kinds: {bad}")


_validate()

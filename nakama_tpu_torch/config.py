"""Matchmaker configuration of the PyTorch/CUDA port.

Field names and defaults follow the JAX package's `MatchmakerConfig`
(reference defaults: server/config.go:971-989), less the mesh-sharding
knobs (the port runs on one card), plus the matchmaker-facing parts of
its `TracingConfig` and `DevObsConfig`. `apply_observability` hands the
latter two to the process-wide trace store and telemetry plane.
`OverloadConfig` and `RecoveryConfig` carry the JAX package's fields
(names and defaults) that the port reads so far: the ladder's and the
admission controller's, and the recovery plane's. The rest of those
sections, and the metrics and database sections, come with the server
slice that reads them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OverloadConfig:
    """Overload-control plane (overload.py): admission control and the
    load-level ladder. Defaults are the disarmed production posture —
    admission is bounded, but the bounds are wide enough that an
    unloaded server never queues."""

    # Server-wide concurrent-request permits shared by all three
    # priority classes (realtime socket ops > authenticated RPC/storage
    # > anonymous list/read endpoints).
    admission_max_concurrent: int = 256
    # Bounded per-class wait queues; a full queue rejects with 429 +
    # Retry-After. WARN halves these and stops queueing the list class;
    # SHED rejects the list class outright.
    admission_queue_realtime: int = 512
    admission_queue_rpc: int = 256
    admission_queue_list: int = 64
    retry_after_sec: int = 1
    # Load-level ladder (OK→WARN→SHED): sampled every ladder_sample_ms;
    # escalation is immediate, de-escalation needs
    # ladder_recover_samples consecutive calmer samples.
    ladder_sample_ms: int = 250
    ladder_recover_samples: int = 3
    # db_write_queue_depth thresholds as fractions of the engine's
    # write queue depth.
    shed_queue_depth_warn: float = 0.5
    shed_queue_depth_shed: float = 0.9
    # Matchmaker interval-lag thresholds (seconds past the head
    # cohort's delivery deadline).
    interval_lag_warn_sec: float = 2.0
    interval_lag_shed_sec: float = 15.0


@dataclass
class RecoveryConfig:
    """Crash-recovery plane (recovery.py): the durable ticket journal
    (append-only, LSN-ordered, drained through the group-commit write
    pipeline), periodic pool checkpoints that truncate it, and the
    warm-restart replay at boot. Durability requires a file-backed
    database; on `:memory:` engines the plane runs but a process
    restart starts a fresh store."""

    # Journal ticket outcomes (add/remove/matched/publish-failed).
    # False keeps checkpoints only: replay granularity becomes the
    # checkpoint interval instead of the last durable journal drain.
    journal: bool = True
    # Pool snapshot cadence (interval idle gap). Bounds both replay
    # work at boot and the journal's disk footprint.
    checkpoint_interval_sec: int = 60
    # Buffered journal records per drain unit (one atomic execute_many
    # riding a shared group commit).
    journal_flush_max: int = 2048
    # Degraded-mode (storage down) in-memory buffer bound; overflow
    # drops oldest records — the pool still holds the tickets and the
    # next checkpoint covers them.
    journal_buffer_cap: int = 65536
    # Checkpoint/snapshot directory; empty = the server's data_dir.
    recovery_dir: str = ""


@dataclass
class MatchmakerConfig:
    max_tickets: int = 3
    interval_sec: int = 15
    max_intervals: int = 2
    rev_precision: bool = False
    # "cuda": CudaBackend on cuda:0 (raises without a CUDA device);
    # "cpu": the exact host oracle (CpuBackend).
    backend: str = "cuda"
    pool_capacity: int = 131_072
    max_constraints: int = 16  # query constraint slots compiled per ticket
    candidates_per_ticket: int = 64  # device top-K candidate width
    numeric_fields: int = 24
    string_fields: int = 16
    max_party_size: int = 8
    embedding_dims: int = 16  # learned skill-embedding width
    # Pools whose scanned column extent reaches this switch from the exact
    # blockwise top-K scan to the two-stage kernel (device2.py).
    big_pool_threshold: int = 32_768
    emb_score_scale: float = 256.0  # stage-1 embedding-score quantisation
    # Pipelined intervals (the shipped default): process() dispatches the
    # current interval's device pass and collects completed earlier ones,
    # so the device pass and its host tail leave the interval's critical
    # path. False = synchronous reference semantics (same-interval
    # delivery).
    interval_pipelining: bool = True
    # Device-side 1v1 pair assignment (device2.pair_partners) when every
    # live ticket is a solo 1v1; only the partner vector crosses D2H.
    device_pairing: bool = True
    # Per-interval cap on host-only actives run through the CPU oracle
    # fallback (queries the device kernels cannot express); overflow
    # defers to the next interval, oldest first.
    host_budget_per_interval: int = 512
    # Seconds before a pipelined cohort's delivery deadline at which the
    # delivery stage block-joins the cohort's assembly (once per head).
    # join_head also refuses to block past deadline + guard, so a wedged
    # head costs the guard at most one bounded join before the reclaim
    # path (inflight_reclaim_deadline_ms) takes it.
    pipeline_deadline_guard_sec: float = 2.0
    # Delivery-stage watchdog poll cadence (seconds): the timed drain
    # that runs even if a completion signal is lost. It bounds recovery
    # from a lost signal; it is NOT the delivery latency.
    delivery_watchdog_sec: float = 1.0
    # Degradation ladder (faults.py CircuitBreaker in the device
    # backend): after `breaker_threshold` consecutive transient device
    # failures (dispatch or collect; a fatal error trips immediately)
    # the breaker OPENS and intervals run the bounded host-oracle
    # fallback (host_budget_per_interval still caps it). After
    # `breaker_cooldown_ms` a half-open probe re-tries the device path;
    # success closes the breaker, failure re-opens it with the cooldown
    # doubled (capped at 16x).
    breaker_threshold: int = 3
    breaker_cooldown_ms: int = 30_000
    # Backstop reclamation sweep: a pipelined cohort still unfinished
    # this long PAST its delivery deadline is abandoned — its slots'
    # in-flight claims are released and the tickets re-activated.
    inflight_reclaim_deadline_ms: int = 60_000


@dataclass
class TracingConfig:
    """Request-scoped tracing + the SLO plane (tracing.py): span trees
    down to the matchmaker's cohorts, tail-based sampling into the
    bounded in-process trace store, the interval and publish-lag SLOs.
    Defaults are the disarmed production posture: tracing on, 1%
    p-sample, errors/slow traces kept 100%."""

    enabled: bool = True
    # Probability a non-error, non-slow trace is kept (deterministic by
    # trace id). Error traces and traces slower than slow_trace_ms
    # (judged on the full span extent) are always kept.
    sample_rate: float = 0.01
    slow_trace_ms: int = 1000
    # Bounded stores: kept traces, in-flight trace buffer, spans/trace.
    capacity: int = 256
    max_active_traces: int = 512
    max_spans_per_trace: int = 64
    # Optional JSONL export: one kept trace per line, appended.
    export_path: str = ""
    # Shared p-sampling salt (empty = per-boot random salt).
    sample_salt: str = ""
    # SLO plane: target good-fraction + per-SLI thresholds.
    slo_target: float = 0.99
    slo_interval_ms: int = 1000  # matchmaker process() wall time
    slo_publish_lag_ms: int = 5000  # cohort dispatch→published lag


@dataclass
class DevObsConfig:
    """Device telemetry plane (devobs.py): build-watch, per-kernel host
    and CUDA-event clocks and the HBM ownership ledger. `enabled=False`
    reduces every hook to one attribute read."""

    enabled: bool = True
    # Interval ticks before the warmup window closes: builds inside it
    # are expected; after it, a build on the hot path is counted as a
    # recompile and WARNs.
    warmup_intervals: int = 3
    # Bounded kernel-event timeline depth (delivery-ledger device phase
    # chains slice it by wall window).
    timeline_depth: int = 256


def apply_observability(
    tracing: TracingConfig | None = None,
    devobs: DevObsConfig | None = None,
    *,
    metrics=None,
    logger=None,
):
    """Configure the process-wide trace store and telemetry plane from
    their config sections; returns the `SloRecorder` for a matchmaker's
    `slo` hook (None when tracing is disabled)."""
    from .devobs import DEVOBS
    from .tracing import TRACES, SloRecorder

    tc = tracing or TracingConfig()
    dv = devobs or DevObsConfig()
    TRACES.configure(
        enabled=tc.enabled,
        capacity=tc.capacity,
        sample_rate=tc.sample_rate,
        slow_ms=tc.slow_trace_ms,
        max_active=tc.max_active_traces,
        max_spans=tc.max_spans_per_trace,
        export_path=tc.export_path,
        sample_salt=tc.sample_salt,
        metrics=metrics,
    )
    DEVOBS.configure(
        enabled=dv.enabled,
        warmup_intervals=dv.warmup_intervals,
        timeline_depth=dv.timeline_depth,
        metrics=metrics,
        logger=logger,
    )
    if not tc.enabled:
        return None
    return SloRecorder(
        {
            "matchmaker_interval": {
                "target": tc.slo_target,
                "threshold_ms": tc.slo_interval_ms,
            },
            "delivery_publish": {
                "target": tc.slo_target,
                "threshold_ms": tc.slo_publish_lag_ms,
            },
        },
        metrics=metrics,
    )

"""Metrics registry and Prometheus text exposition, without
prometheus_client.

Port of the JAX package's `metrics.py` (reference server/metrics.go:33-68:
API timers, realtime gauges, the matchmaker gauges + process timer,
snapshot counters for the console status dashboard, and custom metrics
exposed to the user runtime). The card's machine has no
`prometheus_client`, so the port keeps its own small registry of
counters, gauges and histograms with labels, under the JAX package's
metric names, types and label names, and renders the text exposition
format 0.0.4 itself (`scrape`).

The exposition follows prometheus_client's rendering: counters carry
`_total`, histograms `_bucket{le=...}`, `_count` and `_sum`, values
print in Go's float format (`nakama_matchmaker_tickets 42.0`), labels
sorted by name. The one difference: the port emits no `_created`
series (the creation timestamps prometheus_client adds per series).
They are wall-clock stamps that differ between any two registries, so
nothing compares them, and `snapshot()` drops them in both packages.

Each Metrics instance owns a private `Registry`, so tests and embedded
servers never collide. Metrics are thread-safe: the matchmaker's worker
threads and the event loop both record.
"""

from __future__ import annotations

import math
import threading
import time
from collections import namedtuple
from typing import Any

_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

Sample = namedtuple("Sample", ("name", "labels", "value"))
Family = namedtuple("Family", ("name", "type", "documentation", "samples"))


def float_to_go_string(d) -> str:
    """A sample value as Prometheus' Go exposition prints it (the rule
    prometheus_client's `floatToGoString` follows)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python.
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


class Registry:
    """The metrics of one Metrics instance, in registration order."""

    def __init__(self):
        self._metrics: list = []
        self._names: set[str] = set()
        self._lock = threading.Lock()

    def register(self, metric) -> None:
        with self._lock:
            if metric._name in self._names:
                raise ValueError(f"duplicated metric {metric._name}")
            self._names.add(metric._name)
            self._metrics.append(metric)

    def collect(self) -> list[Family]:
        with self._lock:
            metrics = list(self._metrics)
        return [m.collect() for m in metrics]


class _Metric:
    """A metric family: an unlabeled metric is its own single series;
    a labeled one holds a child series per label-value tuple."""

    _type = ""

    def __init__(
        self,
        name: str,
        documentation: str,
        labelnames=(),
        namespace: str = "",
        registry: Registry | None = None,
    ):
        full = "_".join(x for x in (namespace, name) if x)
        if self._type == "counter" and full.endswith("_total"):
            full = full[: -len("_total")]
        self._name = full
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}
        if not self._labelnames:
            self._value = self._new_value()
        if registry is not None:
            registry.register(self)

    def labels(self, *values, **kw):
        if not self._labelnames:
            raise ValueError(f"no labels on metric {self._name}")
        if values and kw:
            raise ValueError("labels: positional or keyword, not both")
        if kw:
            if set(kw) != set(self._labelnames):
                raise ValueError("Incorrect label names")
            values = tuple(str(kw[n]) for n in self._labelnames)
        else:
            if len(values) != len(self._labelnames):
                raise ValueError("Incorrect label count")
            values = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = _Child(
                    self, self._new_value()
                )
            return child

    def _series(self):
        if not self._labelnames:
            return [({}, self._value)]
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self._labelnames, k)), c._value) for k, c in items]

    def _unlabeled(self):
        if self._labelnames:
            raise ValueError(
                f"metric {self._name} has labels {self._labelnames}:"
                " call labels() first"
            )
        return self._value

    def collect(self) -> Family:
        samples = []
        for labels, value in self._series():
            samples.extend(self._samples(labels, value))
        return Family(self._name, self._type, self._documentation, samples)


class _Child:
    """One labeled series: the same recording methods as its family."""

    __slots__ = ("_metric", "_value")

    def __init__(self, metric, value):
        self._metric = metric
        self._value = value

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._value, amount)

    def set(self, value: float) -> None:
        self._metric._set(self._value, value)

    def observe(self, value: float) -> None:
        self._metric._observe(self._value, value)


class Counter(_Metric):
    _type = "counter"

    def _new_value(self):
        return [0.0]

    def _inc(self, v, amount):
        if amount < 0:
            raise ValueError("counters can only be incremented")
        with self._lock:
            v[0] += float(amount)

    def inc(self, amount: float = 1.0) -> None:
        self._inc(self._unlabeled(), amount)

    def _samples(self, labels, v):
        return [Sample(self._name + "_total", labels, v[0])]


class Gauge(_Metric):
    _type = "gauge"

    def _new_value(self):
        return [0.0]

    def _inc(self, v, amount):
        with self._lock:
            v[0] += float(amount)

    def _set(self, v, value):
        with self._lock:
            v[0] = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._inc(self._unlabeled(), amount)

    def set(self, value: float) -> None:
        self._set(self._unlabeled(), value)

    def _samples(self, labels, v):
        return [Sample(self._name, labels, v[0])]


class Histogram(_Metric):
    _type = "histogram"

    def __init__(self, name, documentation, labelnames=(), namespace="",
                 registry=None, buckets=_LATENCY_BUCKETS):
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self._upper_bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, namespace, registry)

    def _new_value(self):
        # Per-bucket (non-cumulative) counts, then the sum.
        return [0.0] * len(self._upper_bounds) + [0.0]

    def _observe(self, v, value):
        value = float(value)
        for i, bound in enumerate(self._upper_bounds):
            if value <= bound:
                break
        with self._lock:
            v[i] += 1.0
            v[-1] += value

    def observe(self, value: float) -> None:
        self._observe(self._unlabeled(), value)

    def _samples(self, labels, v):
        with self._lock:
            counts, total = v[:-1], v[-1]
        out = []
        acc = 0.0
        for bound, n in zip(self._upper_bounds, counts):
            acc += n
            out.append(Sample(
                self._name + "_bucket",
                {**labels, "le": float_to_go_string(bound)}, acc,
            ))
        out.append(Sample(self._name + "_count", labels, acc))
        out.append(Sample(self._name + "_sum", labels, total))
        return out


def generate_latest(registry: Registry) -> bytes:
    """The registry in the Prometheus text exposition format 0.0.4."""
    out = []
    for fam in registry.collect():
        name = fam.name + "_total" if fam.type == "counter" else fam.name
        doc = fam.documentation.replace("\\", r"\\").replace("\n", r"\n")
        out.append(f"# HELP {name} {doc}\n")
        out.append(f"# TYPE {name} {fam.type}\n")
        for s in fam.samples:
            labels = ""
            if s.labels:
                labels = "{" + ",".join(
                    f'{k}="{_escape_label_value(v)}"'
                    for k, v in sorted(s.labels.items())
                ) + "}"
            out.append(f"{s.name}{labels} {float_to_go_string(s.value)}\n")
    return "".join(out).encode("utf-8")


class Metrics:
    def __init__(self, namespace: str = ""):
        self.registry = Registry()
        self._custom_lock = threading.Lock()
        ns = namespace or "nakama"
        self._ns = ns

        def counter(name, doc, labels=()):
            return Counter(name, doc, labels, namespace=ns, registry=self.registry)

        def gauge(name, doc, labels=()):
            return Gauge(name, doc, labels, namespace=ns, registry=self.registry)

        def histo(name, doc, labels=()):
            return Histogram(
                name, doc, labels, namespace=ns, registry=self.registry,
                buckets=_LATENCY_BUCKETS,
            )

        # API layer.
        self.api_time = histo("api_time_sec", "Per-RPC latency", ("rpc",))
        self.api_count = counter("api_count", "Per-RPC calls", ("rpc", "code"))
        self.api_recv_bytes = counter("api_recv_bytes", "Request bytes", ("rpc",))
        self.api_sent_bytes = counter("api_sent_bytes", "Response bytes", ("rpc",))

        # Realtime gauges.
        self.sessions = gauge("sessions", "Connected sessions")
        self.presences = gauge("presences", "Tracked presences")
        self.matches = gauge("matches_authoritative", "Live authoritative matches")
        self.parties = gauge("parties", "Live parties")

        # Matchmaker (north star).
        self.mm_tickets = gauge("matchmaker_tickets", "Tickets in the pool")
        self.mm_active_tickets = gauge(
            "matchmaker_active_tickets", "Actively-querying tickets"
        )
        self.mm_process_time = histo(
            "matchmaker_process_time_sec", "Per-interval Process() latency"
        )
        self.mm_matched = counter("matchmaker_matched", "Tickets matched")
        self.mm_device_time = histo(
            "matchmaker_device_time_sec", "Device kernel time inside Process()"
        )
        # Pipelined delivery observability: per-cohort dispatch→delivered
        # lag (bucketed to interval scale, not the RPC-latency grid), a
        # loud counter for cohorts delivered past their own interval
        # deadline (the slip the bench gates on), and the gaps whose
        # GC/drain/flush work was shed under pipeline backpressure.
        self.mm_delivery_lag = Histogram(
            "matchmaker_delivery_lag_sec",
            "Pipelined cohort dispatch→delivered lag",
            (),
            namespace=ns,
            registry=self.registry,
            buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0, 60.0),
        )
        self.mm_cohort_slipped = counter(
            "matchmaker_cohort_slipped",
            "Cohorts delivered past their own interval deadline",
        )
        # Event-driven delivery stage: dispatch→published per-cohort
        # latency (the full stage chain, one step past the collect lag
        # above) and the stage's wakeup causes — a healthy deployment
        # is dominated by "event"; a rising "watchdog"/"deadline" share
        # means completion signals are being lost or heads are wedging.
        self.mm_delivery_publish_lag = Histogram(
            "matchmaker_delivery_publish_lag_sec",
            "Pipelined cohort dispatch→published lag (full stage chain)",
            (),
            namespace=ns,
            registry=self.registry,
            buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0, 60.0),
        )
        self.mm_delivery_wakeups = counter(
            "matchmaker_delivery_wakeups",
            "Delivery-stage wakeups by cause (event = cohort-completion "
            "signal, deadline = guard point, watchdog = fallback poll)",
            ("cause",),
        )
        self.mm_gap_shed = counter(
            "matchmaker_gap_work_shed",
            "Interval gaps whose GC/drain/flush were shed under pipeline "
            "backpressure",
        )

        # Degradation ladder (faults.py): device-backend breaker state,
        # classified backend failures, in-flight slots reclaimed after a
        # failure or by the backstop sweep, and delivery-publish faults.
        self.mm_backend_state = gauge(
            "matchmaker_backend_state",
            "Device-backend circuit state (0 closed, 1 open, 2 half-open)",
        )
        self.mm_backend_failures = counter(
            "matchmaker_backend_failures",
            "Device dispatch/collect failures by stage and classification",
            ("stage", "kind"),
        )
        self.mm_inflight_reclaimed = counter(
            "matchmaker_inflight_reclaimed",
            "In-flight ticket slots reclaimed after backend failure or by "
            "the stale-cohort backstop sweep",
        )
        self.mm_delivery_failed = counter(
            "matchmaker_delivery_failed",
            "Matched-cohort deliveries dropped or failed in the publish "
            "callback",
        )

        # Crash-recovery plane (recovery.py): journal progress + health,
        # checkpoint cadence, and the warm-restart outcome gauges an
        # operator reads after a crash ("how much came back, how fast").
        self.mm_journal_records = counter(
            "matchmaker_journal_records",
            "Ticket-journal records appended, by op "
            "(add, remove, matched, unpublished)",
            ("op",),
        )
        self.mm_journal_lsn = gauge(
            "matchmaker_journal_durable_lsn",
            "Highest journal LSN whose group commit resolved (records "
            "at or below it survive a crash)",
        )
        self.mm_journal_degraded = gauge(
            "matchmaker_journal_degraded",
            "1 while the ticket journal is degraded to in-memory-only "
            "after a failed write (heals on the next successful drain)",
        )
        self.mm_checkpoints = counter(
            "matchmaker_checkpoints",
            "Pool checkpoint attempts by outcome (ok, failed)",
            ("outcome",),
        )
        self.mm_checkpoint_lsn = gauge(
            "matchmaker_checkpoint_lsn",
            "Journal LSN covered by the newest durable pool checkpoint",
        )
        self.mm_recovery_duration = gauge(
            "matchmaker_recovery_duration_sec",
            "Wall time of the last warm restart (snapshot load + "
            "journal replay + device re-put)",
        )
        self.mm_recovery_tickets = gauge(
            "matchmaker_recovery_tickets",
            "Tickets rebuilt into the pool by the last warm restart",
        )

        # Storage engine: group-commit write pipeline (storage/db.py
        # WriteBatcher) + the reader-pool concurrency high-water mark.
        # Batch-size buckets are unit counts per shared commit, not
        # latencies, so they get their own grid.
        self.db_write_batch_size = Histogram(
            "db_write_batch_size",
            "Write units coalesced per group commit",
            (),
            namespace=ns,
            registry=self.registry,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
        )
        self.db_write_queue_depth = gauge(
            "db_write_queue_depth", "Write units queued for the next drain"
        )
        self.db_group_commits = counter(
            "db_group_commits_total", "Shared commits drained by the batcher"
        )
        self.db_peak_concurrent_reads = gauge(
            "db_peak_concurrent_reads",
            "High-water mark of concurrent reader-pool fetches",
        )
        self.db_drain_restarts = counter(
            "db_drain_restarts",
            "Storage drain-loop crash-restarts (supervised write batcher "
            "and read coalescer)",
            ("loop",),
        )

        # Fault-injection plane (faults.py): armed-point injections
        # actually delivered. Zero in production (points are armed only
        # by tests/bench/chaos) — a nonzero value in a live scrape means
        # someone left a fault armed.
        self.faults_injected = counter(
            "faults_injected",
            "Fault-plane injections delivered, by point and mode",
            ("point", "mode"),
        )

        # Overload-control plane (overload.py): the ladder state, what
        # was shed and why, deadline short-circuits by checkpoint stage,
        # and the admission controller's live concurrency.
        self.overload_state = gauge(
            "overload_state",
            "Load-level ladder state (0 ok, 1 warn, 2 shed)",
        )
        self.requests_shed = counter(
            "requests_shed",
            "Requests rejected by admission control, by priority class "
            "and reason (queue_full, warn, shed, rate_limited)",
            ("class", "reason"),
        )
        self.request_deadline_exceeded = counter(
            "request_deadline_exceeded",
            "Requests short-circuited on an expired deadline, by "
            "checkpoint stage (http, pipeline, matchmaker, db)",
            ("stage",),
        )
        self.admission_inflight = gauge(
            "admission_inflight",
            "Requests currently holding an admission permit",
        )

        # Device leaderboard rank engine (leaderboard/device.py): the
        # breaker state an operator reads first, write-staging ->
        # device-flush lag (the read-staleness bound the config
        # promises), and the batch sizes the read kernels amortize —
        # both on their own grids (lag runs to board-refresh scale;
        # batch sizes are counts, not latencies).
        self.lb_device_state = gauge(
            "leaderboard_device_state",
            "Leaderboard device-engine circuit state (0 closed, 1 open, "
            "2 half-open)",
        )
        self.lb_flush_lag = Histogram(
            "leaderboard_flush_lag_sec",
            "Lag from first staged leaderboard write to its device flush",
            (),
            namespace=ns,
            registry=self.registry,
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.5, 5.0, 10.0, 30.0),
        )
        self.lb_rank_batch_size = Histogram(
            "leaderboard_rank_batch_size",
            "Owner ranks served per batched device rank query",
            (),
            namespace=ns,
            registry=self.registry,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
        )

        # Device telemetry plane (devobs.py): compile-watch, kernel
        # clocks, and the HBM ownership ledger for the shared-mesh
        # workloads. Compile counts/label by named kernel; an
        # xla_recompiles tick after the warmup window is the "shape
        # churn became a p99 spike" alarm. Compile durations get their
        # own grid (multi-second XLA compiles dwarf the RPC buckets);
        # kernel wall times ride the latency grid.
        self.xla_compiles = counter(
            "xla_compiles",
            "XLA backend compiles, by named device kernel "
            "(unattributed = outside any registered device call)",
            ("kernel",),
        )
        self.xla_recompiles = counter(
            "xla_recompiles",
            "Unexpected XLA recompiles after the warmup window, by "
            "named device kernel — compile-shape churn on the hot path",
            ("kernel",),
        )
        self.xla_compile_time = Histogram(
            "xla_compile_time_sec",
            "XLA backend compile duration",
            (),
            namespace=ns,
            registry=self.registry,
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                     30.0),
        )
        self.device_kernel_time = histo(
            "device_kernel_time_sec",
            "Host wall time held by each named device call "
            "(dispatch + compile for async kernels; compute + "
            "transfer for blocking fetches)",
            ("kernel",),
        )
        self.device_memory = gauge(
            "device_memory_bytes",
            "Device-resident bytes by owning workload (HBM ledger; "
            "matchmaker.pool, matchmaker.dispatch, leaderboard.boards)",
            ("owner",),
        )
        self.device_memory_high_water = gauge(
            "device_memory_high_water_bytes",
            "High-watermark of total ledger-tracked device bytes",
        )
        self.device_transfers = counter(
            "device_transfers",
            "Host<->device transfers by call site and direction",
            ("site", "direction"),
        )
        self.device_transfer_bytes = counter(
            "device_transfer_bytes",
            "Host<->device bytes moved, by call site and direction",
            ("site", "direction"),
        )
        # Mesh-sharded matchmaking (parallel/mesh.py): the pool's
        # candidate axis split over N devices, plus the per-merge ICI
        # gather cost — the "is the mesh live and what does the
        # collective cost" operator view.
        self.mesh_devices = gauge(
            "mesh_devices",
            "Devices in the live matchmaker pool mesh (0 = single-device)",
        )
        self.mesh_shard_slots = gauge(
            "mesh_shard_slots",
            "Pool slots resident on each mesh device (column shard size)",
            ("device",),
        )
        self.mesh_gather_bytes = gauge(
            "mesh_gather_bytes",
            "Bytes gathered across the mesh by the last top-K merge "
            "(devices x rows x per-shard width)",
        )

        # Tracing + SLO plane (tracing.py): tail-sampling decisions on
        # completed traces (kept_error / kept_slow / kept_sampled /
        # dropped) and the multi-window error-budget burn per SLO.
        self.traces_sampled = counter(
            "traces_sampled",
            "Completed request traces by tail-sampling decision",
            ("decision",),
        )
        self.slo_burn_rate = gauge(
            "slo_burn_rate",
            "Error-budget burn rate per SLO and window (1.0 = budget "
            "spent exactly at its sustainable pace)",
            ("slo", "window"),
        )

        # Cluster plane (cluster/): peer liveness, the bus's frame flow
        # and queue posture, matchmaker fan-in forwards, and the
        # node-death presence sweeps. A nonzero `down` peer count is
        # the local-only degraded posture the overload ladder WARNs on.
        self.cluster_peers = gauge(
            "cluster_peers",
            "Configured cluster peers by liveness state (up, down)",
            ("state",),
        )
        self.cluster_bus_queue_depth = gauge(
            "cluster_bus_queue_depth",
            "Outbound bus frames queued per peer",
            ("peer",),
        )
        self.cluster_frames = counter(
            "cluster_frames",
            "Bus frames by type and direction (sent, received)",
            ("type", "direction"),
        )
        self.cluster_bus_dropped = counter(
            "cluster_bus_dropped",
            "Bus frames dropped, by reason (peer_down, queue_full, "
            "breaker_open, oversize, bad_frame, fault)",
            ("reason",),
        )
        self.cluster_forwards = counter(
            "cluster_forwards",
            "Matchmaker ops forwarded to the device-owner node, by op "
            "(add, remove, matched, reject)",
            ("op",),
        )
        self.cluster_presence_sweeps = counter(
            "cluster_presence_sweeps",
            "Presences swept from this node's view after a peer death "
            "(leave events fired locally)",
        )
        self.cluster_party_ops = counter(
            "cluster_party_ops",
            "Party operations by op and whether they crossed the bus "
            "to a remote authority node (crossed=true/false)",
            ("op", "crossed"),
        )
        self.cluster_rpcs = counter(
            "cluster_rpcs",
            "Correlated bus RPCs (op.req/op.res) by op and outcome "
            "(ok, timeout, unavailable, error, ...) — party/match "
            "authority ops and the fleet-obs pull cadence",
            ("op", "outcome"),
        )

        # Fleet observability plane (cluster/obs.py): the collector's
        # pane of glass made scrapeable — trace-fragment flow, pull
        # outcomes, per-node freshness, the stitched-trace inventory,
        # the clock-offset estimates honesty demands be visible, and
        # the health-rule engine's alert counts + OK/WARN/CRITICAL
        # roll-up an operator pages on.
        self.obs_fragments = counter(
            "obs_fragments",
            "Kept-trace fragments exported toward the fleet collector "
            "by outcome (shipped, dropped)",
            ("outcome",),
        )
        self.obs_pulls = counter(
            "obs_pulls",
            "Collector obs.pull rounds per node by outcome (ok, "
            "timeout, unavailable, error)",
            ("outcome",),
        )
        self.obs_stitched_traces = gauge(
            "obs_stitched_traces",
            "Fleet traces retained in the collector's bounded "
            "stitching store",
        )
        self.fleet_nodes = gauge(
            "fleet_nodes",
            "Fleet nodes by federation freshness (fresh, stale, down)",
            ("state",),
        )
        self.fleet_clock_offset_ms = gauge(
            "fleet_clock_offset_ms",
            "Estimated clock offset per node, collector-minus-node "
            "(pull-RTT midpoints, EMA; a node running ahead reads "
            "negative) — the correction stitched cross-node spans "
            "are annotated with",
            ("node",),
        )
        self.fleet_alerts = gauge(
            "fleet_alerts",
            "Active fleet health-rule alerts by rule and severity",
            ("rule", "severity"),
        )
        self.fleet_status = gauge(
            "fleet_status",
            "Fleet health roll-up (0 ok, 1 warn, 2 critical)",
        )

        # Load & soak plane (loadgen/): the open-loop session
        # population by tier (modeled in-process vs real websocket) and
        # state, every scenario op by outcome, and the per-scenario SLO
        # burn the soak judge gates on — the "millions of users" claim
        # is read off these three families plus the judge table.
        self.loadgen_sessions = gauge(
            "loadgen_sessions",
            "Load-rig sessions by tier (modeled, real) and state "
            "(active, spawned, completed, shed)",
            ("tier", "state"),
        )
        self.loadgen_ops = counter(
            "loadgen_ops",
            "Load-rig scenario operations by scenario and outcome "
            "(ok, error, internal_error, timeout)",
            ("scenario", "outcome"),
        )
        self.slo_scenario_burn_rate = gauge(
            "slo_scenario_burn_rate",
            "Per-scenario error-budget burn rate per window (soak "
            "judge; 1.0 = budget spent exactly at its sustainable "
            "pace)",
            ("scenario", "window"),
        )

        # Owner scale-out plane (cluster/sharding.py, replication.py,
        # lease.py): the epoch-versioned shard map (a bump on a shard =
        # a takeover; the owning node is on the console shard map), the
        # warm-standby journal replication backlog, per-shard lease
        # decay, and the takeover counter an operator alerts on.
        self.cluster_shard_owner = gauge(
            "cluster_shard_owner",
            "Current ownership epoch per shard (an epoch bump is a "
            "lease takeover; the owning node is in the console map)",
            ("shard",),
        )
        self.replication_lag_lsn = gauge(
            "replication_lag_lsn",
            "Journal records durable on the owner but not yet "
            "acknowledged applied by its warm standby",
        )
        self.replication_lag_sec = gauge(
            "replication_lag_sec",
            "Age of the replication backlog (0 when the standby has "
            "acknowledged everything durable)",
        )
        self.lease_state = gauge(
            "lease_state",
            "Per-shard ownership lease state (0 held, 1 in grace, "
            "2 expired — promotable)",
            ("shard",),
        )
        self.owner_takeovers = counter(
            "owner_takeovers",
            "Standby promotions to shard owner, by reason",
            ("reason",),
        )

        # Elastic resharding plane (cluster/reshard.py): the
        # generation-versioned shard map plus the live-migration state
        # machine — an operator watches the generation converge
        # fleet-wide and the per-phase gauge walk snapshot → tail →
        # handover → idle on every executed plan.
        self.cluster_map_generation = gauge(
            "cluster_map_generation",
            "Shard-map generation this node routes by (highest "
            "generation wins fleet-wide; 0 is the boot-time map)",
        )
        self.reshard_state = gauge(
            "reshard_state",
            "Live-migration state machine, one-hot per phase (1 = the "
            "local migrator is in that phase)",
            ("phase",),
        )
        self.reshard_migrated_tickets = counter(
            "reshard_migrated_tickets",
            "Tickets handed over to a new shard owner by completed "
            "reshard migrations",
        )

        # Message routing / presence events.
        self.outgoing_dropped = counter(
            "socket_outgoing_dropped", "Messages dropped on full session queues"
        )
        self.session_outgoing_overflow = counter(
            "session_outgoing_overflow",
            "Per-session outgoing-queue overflow events: dropped "
            "envelopes and the queue-full session closes they trigger",
            ("kind",),
        )
        self.sessions_closed = counter(
            "sessions_closed",
            "Sessions closed, by structured reason (normal, error, "
            "overflow, shutdown)",
            ("reason",),
        )
        self.presence_event_time = histo(
            "presence_event_sec", "Tracker event queue latency"
        )

        # Custom metrics surface for the user runtime. Keyed by kind+name;
        # names are kind-prefixed in the registry so a counter and a gauge
        # sharing a user name never collide, and a label-set change on an
        # existing name is a loud error instead of a duplicated series.
        self._custom: dict[tuple[str, str], tuple[Any, tuple[str, ...]]] = {}

        self._snapshot_start = time.time()

    # -- custom metrics (runtime-facing, reference runtime_go_nakama.go
    #    MetricsCounterAdd / MetricsGaugeSet / MetricsTimerRecord) --

    def _custom_metric(self, kind: str, cls, name: str, labels: dict):
        labelnames = tuple(sorted(labels))
        with self._custom_lock:
            entry = self._custom.get((kind, name))
            if entry is None:
                kwargs = {"namespace": self._ns, "registry": self.registry}
                if cls is Histogram:
                    kwargs["buckets"] = _LATENCY_BUCKETS
                metric = cls(
                    f"custom_{kind}_{name}", f"custom {kind}", labelnames,
                    **kwargs,
                )
                self._custom[(kind, name)] = (metric, labelnames)
            else:
                metric, registered = entry
                if registered != labelnames:
                    raise ValueError(
                        f"custom {kind} {name!r} registered with labels "
                        f"{registered}, called with {labelnames}"
                    )
        return metric.labels(**labels) if labels else metric

    def counter_add(self, name: str, value: float = 1.0, **labels: str):
        self._custom_metric("counter", Counter, name, labels).inc(value)

    def gauge_set(self, name: str, value: float, **labels: str):
        self._custom_metric("gauge", Gauge, name, labels).set(value)

    def timer_record(self, name: str, seconds: float, **labels: str):
        self._custom_metric("timer", Histogram, name, labels).observe(seconds)

    # -- scrape / snapshot --

    def scrape(self) -> bytes:
        return generate_latest(self.registry)

    def snapshot(self) -> dict:
        """Console status dashboard sample (reference status_handler.go:64)."""
        out: dict[str, float] = {}
        for metric in self.registry.collect():
            for sample in metric.samples:
                label = ",".join(f"{k}={v}" for k, v in sorted(sample.labels.items()))
                key = sample.name + ("{" + label + "}" if label else "")
                out[key] = sample.value
        return out


class _Timed:
    __slots__ = ("_h", "_t0")

    def __init__(self, h: Histogram):
        self._h = h

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._h.observe(time.perf_counter() - self._t0)
        return False


def timed(histogram: Histogram) -> _Timed:
    return _Timed(histogram)

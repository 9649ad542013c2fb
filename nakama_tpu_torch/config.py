"""Configuration tree of the PyTorch/CUDA port: dataclasses, YAML files
and reflected CLI flags.

Field names, defaults and comments follow the JAX package's `config.py`
section for section (reference server/config.go:35-1073), for the
sections the port serves so far: the server's own fields (`name`,
`data_dir`, `shutdown_grace_sec`), `logger`, `metrics`, `session`,
`socket`, `database`, `matchmaker`, `match`, `tracker`, `runtime`,
`console`, `leaderboard`, `iap`, `social`, `satori`, `overload`,
`tracing`, `recovery` and `devobs`. The matchmaker section drops the mesh-sharding
knobs (the port runs on one card); `database` has no `group_commit`
(the port has no such path), and fields no
port code reads yet are left out until the code that reads them lands
(the metrics section's `reporting_freq_sec`,
`session.single_session`, `socket.read_buffer_size_bytes`,
`write_buffer_size_bytes`, `ping_backoff_threshold`, `database.driver`,
`conn_max_lifetime_ms`), and `leaderboard` drops
`device_read_budget_ms` (the port's rank engine reads a board on the
card whatever a request's deadline has left). A section the
port does not have yet (`cluster`, `parallel`, ...) is an
unknown key to `load_config`, as a typo is. `--config file.yml` imports
PyYAML only when a file is given; flags alone need nothing outside the
standard library. `apply_observability` hands the tracing and devobs
sections to the process-wide trace store and telemetry plane.
"""

from __future__ import annotations

import re
import socket
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any


@dataclass
class LoggerConfig:
    level: str = "info"
    format: str = "json"  # json | text | logfmt | stackdriver
    stdout: bool = True
    file: str = ""
    # File-sink rotation (reference server/config.go:627-646, lumberjack
    # semantics): size-triggered rotation with count/age retention.
    rotation: bool = False
    max_size: int = 100  # megabytes before the file rotates
    max_age: int = 0  # days to retain rotated files (0 = no age pruning)
    max_backups: int = 0  # rotated files to retain (0 = keep all)
    local_time: bool = False  # timestamp rotated names in local time
    compress: bool = False  # gzip rotated files


@dataclass
class MetricsConfig:
    namespace: str = ""
    # 0 = exposition disabled (reference semantics); >0 = dedicated
    # internal listener; -1 = ephemeral port (tests).
    prometheus_port: int = 0


@dataclass
class SessionConfig:
    encryption_key: str = "defaultencryptionkey"
    token_expiry_sec: int = 60
    refresh_encryption_key: str = "defaultrefreshencryptionkey"
    refresh_token_expiry_sec: int = 3600
    single_socket: bool = False
    single_match: bool = False
    single_party: bool = False


@dataclass
class SocketConfig:
    server_key: str = "defaultkey"
    port: int = 7350
    address: str = ""
    max_message_size_bytes: int = 4096
    max_request_size_bytes: int = 262_144
    idle_timeout_ms: int = 60_000
    ping_period_ms: int = 15_000
    pong_wait_ms: int = 25_000
    outgoing_queue_size: int = 64
    # gRPC front door port (reference convention: gRPC on port-1 = 7349,
    # HTTP on 7350, console on 7351 — server/config.go). 0 = main port - 1
    # (ephemeral when port is 0); -1 disables the gRPC listener.
    grpc_port: int = 0


@dataclass
class DatabaseConfig:
    # ":memory:" = embedded non-durable default; point at a file path for
    # durability (reference default is a live Postgres DSN, config.go).
    address: list[str] = field(default_factory=lambda: [":memory:"])
    max_open_conns: int = 100
    # Reader pool width (file-backed WAL engines only; capped by
    # max_open_conns at construction, server.py). 8 matches the
    # pre-knob hardcoded server pool so existing deployments keep
    # their read parallelism.
    read_pool_size: int = 8
    write_batch_max: int = 256  # most units one drain may share a commit
    write_queue_depth: int = 4096  # queued units before submitters park
    # Bounded linger (ms) before a non-full drain commits; 0 = drain
    # immediately (commit latency already batches concurrent writers).
    write_drain_deadline_ms: int = 0
    # Storage self-healing (faults.py degradation ladder): a crashed
    # write-drain / read-coalescer loop fails its pending futures with
    # DatabaseError and restarts with backoff; after this many
    # consecutive crash-restarts the batcher fails fast (new submits
    # rejected) until a drain succeeds or the engine reconnects.
    db_drain_restart_max: int = 8


@dataclass
class MatchConfig:
    """Queue sizes mirror reference server/config.go:893-902."""

    input_queue_size: int = 128
    call_queue_size: int = 128
    signal_queue_size: int = 10
    join_attempt_queue_size: int = 128
    deferred_queue_size: int = 128
    join_marker_deadline_ms: int = 15_000
    max_empty_sec: int = 0
    label_update_interval_ms: int = 1000


@dataclass
class TrackerConfig:
    event_queue_size: int = 1024


@dataclass
class RuntimeConfig:
    path: str = ""
    env: dict[str, str] = field(default_factory=dict)
    http_key: str = "defaulthttpkey"
    event_queue_size: int = 65_536
    event_queue_workers: int = 8


@dataclass
class ConsoleConfig:
    port: int = 7351
    address: str = ""
    username: str = "admin"
    password: str = "password"
    signing_key: str = "defaultsigningkey"
    max_message_size_bytes: int = 4_194_304
    token_expiry_sec: int = 86_400


@dataclass
class LeaderboardConfig:
    blacklist_rank_cache: list[str] = field(default_factory=list)
    callback_queue_size: int = 65_536
    callback_queue_workers: int = 8
    # Device rank engine (leaderboard/device.py): boards at or past
    # device_min_board_size mirror onto the card for batched rank
    # reads; smaller boards stay host-only (the bisect oracle wins
    # there). Write staging flushes at the dirty threshold or the
    # interval, whichever trips first — that pair bounds read staleness.
    device_enabled: bool = True
    device_min_board_size: int = 4096
    device_flush_dirty_threshold: int = 1024
    device_flush_interval_sec: float = 2.0
    device_breaker_threshold: int = 3
    device_breaker_cooldown_ms: int = 30_000


@dataclass
class IAPConfig:
    apple_shared_password: str = ""
    google_client_email: str = ""
    google_private_key: str = ""
    google_package_name: str = ""
    google_refund_poll_sec: int = 900
    huawei_client_id: str = ""
    huawei_client_secret: str = ""
    huawei_public_key: str = ""


@dataclass
class SatoriConfig:
    url: str = ""
    api_key_name: str = ""
    api_key: str = ""
    signing_key: str = ""


@dataclass
class SocialConfig:
    steam_app_id: int = 0
    steam_publisher_key: str = ""
    facebook_instant_app_secret: str = ""
    apple_bundle_id: str = ""


@dataclass
class OverloadConfig:
    """Overload-control plane (overload.py): admission control, deadline
    propagation, prioritized shedding. Defaults are the disarmed
    production posture — deadlines propagate and admission is bounded,
    but the bounds are wide enough that an unloaded server never
    queues."""

    enabled: bool = True
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
    # Per-class request deadline defaults (ms), used when the client
    # sent no grpc-timeout / X-Request-Timeout header; 0 falls back to
    # deadline_default_ms. Expired deadlines short-circuit with 504
    # before doing dead work, and the storage write batcher drops
    # queued units whose caller deadline passed.
    deadline_default_ms: int = 10_000
    deadline_realtime_ms: int = 5_000
    deadline_rpc_ms: int = 0
    deadline_list_ms: int = 0
    # Token-bucket per-key (ip+token) rate limiter generalizing the
    # LoginAttemptCache tiers; 0 rps = disabled (the default: the
    # admission queues are the primary bound).
    rate_limit_rps: float = 0.0
    rate_limit_burst: int = 32
    # Load-level ladder (OK→WARN→SHED): sampled every ladder_sample_ms;
    # escalation is immediate, de-escalation needs
    # ladder_recover_samples consecutive calmer samples.
    ladder_sample_ms: int = 250
    ladder_recover_samples: int = 3
    # db_write_queue_depth thresholds as fractions of
    # database.write_queue_depth.
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
    warm-restart replay at boot. Defaults are the armed production
    posture — journaling on, checkpoints every 60s. Durability requires
    a file-backed database; on `:memory:` engines the plane runs but a
    process restart starts a fresh store (documented, not an error)."""

    enabled: bool = True
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
    # Checkpoint/snapshot directory; empty = config.data_dir.
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
    slo_api_latency_ms: int = 200
    slo_interval_ms: int = 1000  # matchmaker process() wall time
    slo_publish_lag_ms: int = 5000  # cohort dispatch→published lag
    # Feed the 5m burn rate into the OverloadController ladder (WARN at
    # slo_burn_warn, SHED at slo_burn_shed). Off by default: a freshly
    # booted server's first intervals (kernel builds, the first
    # 100,000-ticket pass) would spike the burn and tighten admission.
    slo_overload_feedback: bool = False
    slo_burn_warn: float = 14.0
    slo_burn_shed: float = 100.0


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
    # Bounded kernel-event timeline depth (console last-interval view;
    # delivery-ledger device phase chains slice it by wall window).
    timeline_depth: int = 256
    # Upper bound on one console-triggered torch.profiler capture; the
    # endpoint clamps requested durations here (output under data_dir).
    capture_max_ms: int = 10_000


@dataclass
class Config:
    name: str = "nakama-tpu"
    data_dir: str = "./data"
    # Graceful-stop budget: in-flight matchmaker cohorts get this long
    # to publish, queued storage writes this long to commit, before
    # close() starts rejecting. A small nonzero grace is the
    # crash-only-software posture: fast, but never lossy by default.
    shutdown_grace_sec: int = 3
    logger: LoggerConfig = field(default_factory=LoggerConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    session: SessionConfig = field(default_factory=SessionConfig)
    socket: SocketConfig = field(default_factory=SocketConfig)
    database: DatabaseConfig = field(default_factory=DatabaseConfig)
    matchmaker: MatchmakerConfig = field(default_factory=MatchmakerConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    console: ConsoleConfig = field(default_factory=ConsoleConfig)
    leaderboard: LeaderboardConfig = field(default_factory=LeaderboardConfig)
    iap: IAPConfig = field(default_factory=IAPConfig)
    social: SocialConfig = field(default_factory=SocialConfig)
    satori: SatoriConfig = field(default_factory=SatoriConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    devobs: DevObsConfig = field(default_factory=DevObsConfig)

    @property
    def node(self) -> str:
        return self.name

    def check(self) -> list[str]:
        """Sanity-check the config; returns warnings. The JAX package's
        checks of the sections the port has, in its order and words."""
        warnings: list[str] = []
        # The node name is embedded in presence/ticket/match IDs with
        # "." as the separator and is parsed back out by rsplit.
        if not re.fullmatch(r"[A-Za-z0-9_-]+", self.name or ""):
            raise ValueError(
                "name must be non-empty and contain only"
                " [A-Za-z0-9_-] (it is embedded in presence/ticket/"
                "match IDs with '.' as the separator)"
            )
        if self.session.encryption_key == "defaultencryptionkey":
            warnings.append("session.encryption_key is the insecure default")
        if self.socket.server_key == "defaultkey":
            warnings.append("socket.server_key is the insecure default")
        if self.console.password == "password":
            warnings.append("console.password is the insecure default")
        if self.matchmaker.max_tickets < 1:
            raise ValueError("matchmaker.max_tickets must be >= 1")
        if self.matchmaker.interval_sec < 1:
            raise ValueError("matchmaker.interval_sec must be >= 1")
        if self.matchmaker.max_intervals < 1:
            raise ValueError("matchmaker.max_intervals must be >= 1")
        if self.socket.port == self.console.port:
            raise ValueError("socket.port and console.port must differ")
        if self.overload.admission_max_concurrent < 1:
            raise ValueError(
                "overload.admission_max_concurrent must be >= 1"
            )
        if not (
            0.0 < self.overload.shed_queue_depth_warn
            <= self.overload.shed_queue_depth_shed
        ):
            warnings.append(
                "overload.shed_queue_depth_warn should be in"
                " (0, shed_queue_depth_shed]"
            )
        if not (0.0 <= self.tracing.sample_rate <= 1.0):
            warnings.append(
                "tracing.sample_rate should be in [0, 1]"
            )
        if not (0.0 < self.tracing.slo_target < 1.0):
            warnings.append("tracing.slo_target should be in (0, 1)")
        if self.devobs.warmup_intervals < 0:
            raise ValueError("devobs.warmup_intervals must be >= 0")
        if self.devobs.capture_max_ms > 60_000:
            warnings.append(
                "devobs.capture_max_ms over 60s — a console-triggered"
                " profiler capture of that length can fill data_dir"
            )
        if self.recovery.checkpoint_interval_sec < 1:
            raise ValueError(
                "recovery.checkpoint_interval_sec must be >= 1"
            )
        if self.recovery.enabled and self.database.address == [":memory:"]:
            warnings.append(
                "recovery is enabled but database.address is :memory: —"
                " the ticket journal will not survive a restart"
            )
        return warnings


_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _coerce(current: Any, value: Any, where: str) -> Any:
    """Coerce `value` (a flag string or a YAML scalar) to the type of the
    field's current/default value; reject mismatches loudly."""
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in _TRUE:
                return True
            if low in _FALSE:
                return False
        raise ValueError(f"{where}: expected a boolean, got {value!r}")
    if isinstance(current, int) and not isinstance(current, bool):
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        if isinstance(value, str):
            try:
                return int(value)
            except ValueError:
                pass
        raise ValueError(f"{where}: expected an integer, got {value!r}")
    if isinstance(current, float):
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                pass
        raise ValueError(f"{where}: expected a number, got {value!r}")
    if isinstance(current, list):
        if isinstance(value, list):
            return value
        if isinstance(value, str):
            return [x for x in value.split(",") if x]
        raise ValueError(f"{where}: expected a list, got {value!r}")
    if isinstance(current, dict):
        if isinstance(value, dict):
            return value
        if isinstance(value, str):
            return dict(
                kv.split("=", 1) for kv in value.split(",") if "=" in kv
            )
        raise ValueError(f"{where}: expected a mapping, got {value!r}")
    if isinstance(value, str):
        return value
    raise ValueError(f"{where}: expected a string, got {value!r}")


def _set_dotted(obj: Any, dotted: str, raw: str) -> None:
    parts = dotted.split(".")
    try:
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        current = getattr(obj, leaf)
        if leaf not in {f.name for f in fields(obj)}:
            raise AttributeError(leaf)  # property/method, not a config field
        setattr(obj, leaf, _coerce(current, raw, f"--{dotted}"))
    except AttributeError as e:
        raise ValueError(f"unknown config flag: --{dotted}") from e


def _merge_dict(cfg: Any, data: Any) -> None:
    if not isinstance(data, dict):
        raise ValueError(
            f"config document must be a mapping, got {type(data).__name__}"
        )
    for key, value in data.items():
        if not hasattr(cfg, key):
            raise ValueError(f"unknown config key: {key}")
        current = getattr(cfg, key)
        if is_dataclass(current):
            if value is None:
                continue  # empty yaml section ("logger:") keeps defaults
            if not isinstance(value, dict):
                raise ValueError(
                    f"config section {key!r} must be a mapping, got {type(value).__name__}"
                )
            _merge_dict(current, value)
        else:
            setattr(cfg, key, _coerce(current, value, key))


def _load_yaml(path: str) -> Any:
    """One YAML config document. PyYAML is imported here, only when a
    file is given: the flags-only path needs nothing outside the
    standard library."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"--config {path}: reading a YAML config file needs the PyYAML"
            " package (yaml), which is not installed; pass the settings as"
            " --section.key flags instead"
        ) from e
    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def load_config(
    yaml_paths: list[str] | None = None, argv: list[str] | None = None
) -> Config:
    """Build a Config from YAML file(s) then CLI flags (flags win).

    Flags are ``--section.key value`` or ``--section.key=value``, generated
    by reflection over the dataclass tree the way the reference's flags/
    package reflects over struct yaml tags.
    """
    cfg = Config()
    for path in yaml_paths or []:
        _merge_dict(cfg, _load_yaml(path))

    argv = list(argv or [])
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument: {arg}")
        body = arg[2:]
        if "=" in body:
            dotted, raw = body.split("=", 1)
            i += 1
        else:
            dotted = body
            if i + 1 >= len(argv):
                raise ValueError(f"flag {arg} missing value")
            raw = argv[i + 1]
            i += 2
        _set_dotted(cfg, dotted, raw)
    return cfg


def parse_args(argv: list[str]) -> Config:
    """CLI entrypoint parsing: ``--config file.yml`` flags first, rest as overrides."""
    yaml_paths: list[str] = []
    rest: list[str] = []
    i = 0
    while i < len(argv):
        if argv[i] == "--config":
            if i + 1 >= len(argv):
                raise ValueError("flag --config missing value")
            yaml_paths.append(argv[i + 1])
            i += 2
        elif argv[i].startswith("--config="):
            yaml_paths.append(argv[i].split("=", 1)[1])
            i += 1
        else:
            rest.append(argv[i])
            i += 1
    cfg = load_config(yaml_paths, rest)
    if not cfg.name:
        # Hostnames may carry dots/invalid chars; the node name is an
        # ID component (check() enforces [A-Za-z0-9_-]) — sanitize the
        # fallback instead of failing the default boot.
        cfg.name = (
            re.sub(r"[^A-Za-z0-9_-]", "-", socket.gethostname())
            or "nakama"
        )
    return cfg


def config_to_dict(cfg: Any, redact: bool = False) -> dict:
    """Dump the config tree (redacts keys/passwords)."""
    out: dict[str, Any] = {}
    for f in fields(cfg):
        value = getattr(cfg, f.name)
        if is_dataclass(value):
            out[f.name] = config_to_dict(value, redact=redact)
        else:
            if redact and any(
                s in f.name for s in ("key", "password", "secret")
            ):
                value = "***" if value else ""
            out[f.name] = value
    return out


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
            "api_latency": {
                "target": tc.slo_target,
                "threshold_ms": tc.slo_api_latency_ms,
            },
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

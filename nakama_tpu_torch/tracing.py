"""Tracing, device profiling and the SLO plane.

Port of the JAX package's `tracing.py`. Three layers live here:

1. **Breadcrumbs + ledgers** (`Tracing`): cheap per-interval timing
   crumbs and bounded event ledgers (deliveries, breaker transitions
   and reclaims, storage group-commit drains, overload-ladder
   transitions) — the aggregate, always-on layer. Every ledger is a
   `Ledger`: a bounded deque plus a monotonic `total` counter, so "how
   many ever" questions never read a saturated deque length.
   `Tracing.device_trace` captures a bounded `torch.profiler` trace
   (CPU and CUDA activity) of a block; `busy_share` reads the card's
   busy share over a window off the exported trace. The JAX package's
   live profiler server (`start_profiler_server`, for xprof) has no
   torch counterpart and is left out.

2. **Request-scoped distributed traces** (module API + `TraceStore`):
   Dapper-style spans carried in a contextvar alongside overload.py's
   Deadline. `span()` / `root_span()` create real spans (parent
   linkage, status, attributes, events, links); W3C `traceparent`
   ids parse and format here; completed traces land in the
   process-wide bounded `TRACES` store under **tail-based sampling** —
   error traces and slow-over-threshold traces are kept 100%, the rest
   are p-sampled deterministically by trace id.

3. **SLO burn rates** (`SloRecorder`): multi-window (5m/1h) error-budget
   burn over matchmaker interval time and delivery publish lag; the
   overload ladder samples it (`overload.slo_burn_signal`).

The disarmed posture (no ambient trace on the caller) costs one
contextvar read per instrumentation point.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
import zlib
from collections import Counter, OrderedDict, deque

# Per-boot salt for the p-sampling hash (see TraceStore._p_sample).
# Cluster deployments may override it with a fleet-shared secret
# (config.tracing.sample_salt) so every node keeps the SAME p-sampled
# trace ids — without that, a cross-node trace's fragments survive
# tail sampling independently per node and the fleet collector can
# only stitch the error/slow-kept ones.
_SAMPLE_SALT = os.urandom(8)

# --------------------------------------------------------------- ledgers


class Ledger:
    """Bounded event deque + monotonic `total` counter — the general
    form of the old `deliveries`/`deliveries_total` pair: once the
    bounded deque fills, its length stops moving, so "how many did this
    call add" and "how many ever" questions must read the counter, and
    every ledger now answers them correctly."""

    __slots__ = ("_items", "total")

    def __init__(self, capacity: int = 256):
        self._items: deque[dict] = deque(maxlen=capacity)
        self.total = 0

    def append(self, item: dict) -> None:
        item.setdefault("ts", time.time())
        self._items.append(item)
        self.total += 1

    def recent(self, n: int = 32) -> list[dict]:
        return list(self._items)[-n:]

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self):
        return iter(self._items)

    def __reversed__(self):
        return reversed(self._items)

    def __getitem__(self, idx):
        return self._items[idx]


# ------------------------------------------------------ W3C traceparent

_TP_VERSION = "00"

# Ids need uniqueness, not cryptographic strength: Mersenne Twister
# seeded from urandom is ~20x cheaper than uuid4 (~0.7µs vs ~14µs on
# this host), and the cohort path mints ids every interval.
_ids = random.Random(int.from_bytes(os.urandom(16), "big"))


def new_trace_id() -> str:
    return f"{_ids.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_ids.getrandbits(64):016x}"


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"{_TP_VERSION}-{trace_id}-{span_id}-01"


def parse_traceparent(value: str) -> tuple[str, str]:
    """`00-<32 hex trace-id>-<16 hex span-id>-<2 hex flags>` → (trace_id,
    span_id). Raises ValueError on malformed input (the front door
    ignores it and starts a fresh trace — a bad header must never 500 a
    request)."""
    parts = value.strip().split("-")
    if len(parts) != 4:
        raise ValueError(f"malformed traceparent: {value!r}")
    _, trace_id, span_id, flags = parts
    if (
        len(trace_id) != 32
        or len(span_id) != 16
        or len(flags) != 2
        or trace_id == "0" * 32
        or span_id == "0" * 16
    ):
        raise ValueError(f"malformed traceparent: {value!r}")
    int(trace_id, 16), int(span_id, 16), int(flags, 16)  # hex-validate
    return trace_id, span_id


# ----------------------------------------------------------------- spans


class Span:
    """One operation in a trace: identity + parent linkage, wall-clock
    bounds, attributes, events, links to other traces, and a status.
    Mutable until `end()`; cheap by design (plain slots, no registry
    work until the span finishes)."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name",
        "start_ts", "end_ts", "_pc0",
        "attrs", "events", "links", "status", "message",
    )

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: str,
        name: str,
        attrs: dict | None = None,
        start_ts: float | None = None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ts = time.time() if start_ts is None else start_ts
        self._pc0 = time.perf_counter()
        self.end_ts: float | None = None
        self.attrs = dict(attrs) if attrs else {}
        self.events: list[dict] = []
        self.links: list[dict] = []
        self.status = "ok"
        self.message = ""

    def set_attribute(self, key: str, value) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs) -> None:
        self.events.append({"name": name, "ts": time.time(), **attrs})

    def add_link(self, trace_id: str, span_id: str = "", **attrs) -> None:
        link = {"trace_id": trace_id, "span_id": span_id}
        if attrs:
            link.update(attrs)
        self.links.append(link)

    def set_status(self, status: str, message: str = "") -> None:
        self.status = status
        if message:
            self.message = message

    def end(self) -> None:
        if self.end_ts is None:
            self.end_ts = self.start_ts + (time.perf_counter() - self._pc0)

    @property
    def duration_ms(self) -> float:
        end = self.end_ts
        if end is None:
            end = self.start_ts + (time.perf_counter() - self._pc0)
        return (end - self.start_ts) * 1000.0

    def as_dict(self) -> dict:
        """OTLP-ish span shape (camelCase ids/times; attributes kept as
        a flat dict rather than the keyValue list for readability)."""
        out = {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_id,
            "name": self.name,
            "startTimeUnixNano": int(self.start_ts * 1e9),
            "endTimeUnixNano": int(
                (self.end_ts if self.end_ts is not None else self.start_ts)
                * 1e9
            ),
            "durationMs": round(self.duration_ms, 3),
            "status": {"code": self.status.upper(), "message": self.message},
        }
        if self.attrs:
            out["attributes"] = self.attrs
        if self.events:
            out["events"] = self.events
        if self.links:
            out["links"] = self.links
        return out


# The propagation channel: follows a request through every awaited call
# on its task (and through explicit copies into worker threads), exactly
# like overload.py's deadline contextvar.
_current_span: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "nakama_current_span", default=None
)


def current_span() -> Span | None:
    return _current_span.get()


def current_trace_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the active span, or None — the logger's
    correlation hook (one contextvar read per log line)."""
    sp = _current_span.get()
    if sp is None:
        return None
    return sp.trace_id, sp.span_id


def current_traceparent() -> str | None:
    """The W3C `traceparent` of the active span, or None."""
    sp = _current_span.get()
    if sp is None:
        return None
    return format_traceparent(sp.trace_id, sp.span_id)


def add_event(name: str, **attrs) -> None:
    """Attach an event to the active span; no-op without one."""
    sp = _current_span.get()
    if sp is not None:
        sp.add_event(name, **attrs)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Real child span under the active span. Yields the Span (set
    attributes/events/status on it) or None when there is no active
    trace or tracing is disabled — the disarmed fast path is one
    contextvar read."""
    parent = _current_span.get()
    if parent is None or not TRACES.enabled:
        yield None
        return
    sp = Span(parent.trace_id, new_span_id(), parent.span_id, name, attrs)
    token = _current_span.set(sp)
    try:
        yield sp
    except BaseException as e:
        sp.set_status("error", f"{type(e).__name__}: {e}")
        raise
    finally:
        _current_span.reset(token)
        sp.end()
        TRACES.add_span(sp)


@contextlib.contextmanager
def root_span(name: str, traceparent: str = "", **attrs):
    """Root span of a new trace (or a child continuing an ingested W3C
    `traceparent`). On exit the trace is submitted for tail-based
    sampling — unless holds (`TRACES.hold`) keep it open for deferred
    spans (a matchmaker ticket waiting to match)."""
    if not TRACES.enabled:
        yield None
        return
    parent_span = ""
    trace_id = ""
    if traceparent:
        try:
            trace_id, parent_span = parse_traceparent(traceparent)
        except ValueError:
            trace_id = ""
    if not trace_id:
        trace_id = new_trace_id()
    sp = Span(trace_id, new_span_id(), parent_span, name, attrs)
    token = _current_span.set(sp)
    try:
        yield sp
    except BaseException as e:
        sp.set_status("error", f"{type(e).__name__}: {e}")
        raise
    finally:
        _current_span.reset(token)
        sp.end()
        TRACES.add_span(sp)
        TRACES.root_done(sp)


def emit_span(
    trace_id: str,
    parent_id: str,
    name: str,
    *,
    start_ts: float,
    end_ts: float,
    status: str = "ok",
    message: str = "",
    links: list[dict] | None = None,
    **attrs,
) -> None:
    """Record an already-finished span into `trace_id` post-hoc — how
    the matchmaker attaches cohort stage timings (dispatch→ready→
    collected→published) to a ticket's trace after the fact, from
    ledger timestamps instead of live context."""
    if not TRACES.enabled:
        return
    sp = Span(trace_id, new_span_id(), parent_id, name, attrs,
              start_ts=start_ts)
    if links:
        sp.links = list(links)
    if status != "ok":
        sp.set_status(status, message)
    sp.end_ts = max(start_ts, end_ts)
    TRACES.add_span(sp)


def emit_trace(
    name: str,
    *,
    start_ts: float,
    end_ts: float,
    status: str = "ok",
    message: str = "",
    links: list[dict] | None = None,
    **attrs,
) -> str:
    """Record a complete single-span trace post-hoc (the storage
    group-commit span: one root per drain, its batched units attached
    as span links). Returns the trace id ("" when disabled)."""
    if not TRACES.enabled:
        return ""
    sp = Span(new_trace_id(), new_span_id(), "", name, attrs,
              start_ts=start_ts)
    if links:
        sp.links = list(links)
    if status != "ok":
        sp.set_status(status, message)
    sp.end_ts = max(start_ts, end_ts)
    TRACES.add_span(sp)
    TRACES.root_done(sp)
    return sp.trace_id


# ------------------------------------------------------------ trace store


class _ActiveTrace:
    __slots__ = ("spans", "root", "holds", "started", "dropped")

    def __init__(self):
        self.spans: list[Span] = []
        self.root: Span | None = None
        self.holds = 0
        self.started = time.time()
        self.dropped = 0  # spans past the per-trace cap: counted


class TraceStore:
    """Process-wide bounded trace sink with tail-based sampling (one
    per process like faults.PLANE — spans are recorded via the
    contextvar from every subsystem, so the sink must be reachable
    without threading an instance through each of them).

    In-flight spans buffer per trace id; when the root span finishes
    (and any holds are released) the whole trace is judged at once:

    - any span with status "error"        → kept ("error")
    - root duration >= `slow_ms`          → kept ("slow")
    - otherwise                           → kept with probability
      `sample_rate`, decided deterministically from the trace id
      ("sampled"), else dropped (span data discarded, counters kept).

    Bounded everywhere: `max_active` in-flight traces (oldest evicted
    and finalized early), `max_spans` per trace (extra spans counted,
    not stored), `capacity` kept traces."""

    # One source of truth for the defaults: __init__ AND reset() both
    # apply these, so a future default change cannot drift between them
    # (reset() exists precisely to kill suite-order coupling).
    DEFAULTS = {
        "enabled": True,
        "capacity": 256,
        "sample_rate": 0.01,
        "slow_ms": 1000.0,
        "max_active": 512,
        "max_spans": 64,
    }

    def __init__(self, **overrides):
        self._lock = threading.Lock()
        self._export_file = None
        self._apply_defaults(overrides)

    def _apply_defaults(self, overrides: dict | None = None) -> None:
        cfg = {**self.DEFAULTS, **(overrides or {})}
        self.enabled = cfg["enabled"]
        self.capacity = cfg["capacity"]
        self.sample_rate = cfg["sample_rate"]
        self.slow_ms = cfg["slow_ms"]
        self.max_active = cfg["max_active"]
        self.max_spans = cfg["max_spans"]
        self.metrics = None
        if self._export_file is not None:
            try:
                self._export_file.close()
            except OSError:
                pass
            self._export_file = None
        self.export_path = ""
        self._active: OrderedDict[str, _ActiveTrace] = OrderedDict()
        # Tombstones of finalized trace ids (bounded): late spans for a
        # closed trace are counted and dropped, never allowed to
        # resurrect an active entry — resurrection double-finalizes the
        # trace and leaves rootless orphans squatting in the buffer.
        self._closed: OrderedDict[str, None] = OrderedDict()
        self.late_spans = 0
        # Kept records whose JSONL export is pending: the file write
        # happens OUTSIDE the lock (see _drain_export) so a slow disk
        # can never serialize the request plane behind it.
        self._export_pending: list[dict] = []
        self.kept: deque[dict] = deque(maxlen=self.capacity)
        self.finished_total = 0
        self.kept_total = 0
        self.kept_by: Counter = Counter()

    def configure(
        self,
        *,
        enabled: bool | None = None,
        capacity: int | None = None,
        sample_rate: float | None = None,
        slow_ms: float | None = None,
        max_active: int | None = None,
        max_spans: int | None = None,
        export_path: str | None = None,
        sample_salt: str | None = None,
        metrics=None,
    ) -> None:
        global _SAMPLE_SALT
        if sample_salt:
            # Fleet-shared sampling salt: every node judges a trace id
            # the same way, so cross-node fragments live or die
            # together (the stitching prerequisite). Still a secret
            # w.r.t. clients — traceparent senders cannot mint
            # always-kept ids without knowing it.
            _SAMPLE_SALT = sample_salt.encode()
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if capacity is not None and capacity != self.capacity:
                self.capacity = max(1, int(capacity))
                self.kept = deque(self.kept, maxlen=self.capacity)
            if sample_rate is not None:
                self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
            if slow_ms is not None:
                self.slow_ms = float(slow_ms)
            if max_active is not None:
                self.max_active = max(1, int(max_active))
            if max_spans is not None:
                self.max_spans = max(1, int(max_spans))
            if export_path is not None and export_path != self.export_path:
                if self._export_file is not None:
                    try:
                        self._export_file.close()
                    except OSError:
                        pass
                    self._export_file = None
                self.export_path = export_path
            if metrics is not None:
                self.metrics = metrics

    def reset(self) -> None:
        """Drop all state AND restore the constructor-default config.
        The store is process-global, so a reset that kept the previous
        caller's sampling posture would make test outcomes depend on
        suite order."""
        with self._lock:
            self._apply_defaults()

    # -------------------------------------------------------- recording

    def _entry(self, trace_id: str) -> _ActiveTrace:
        entry = self._active.get(trace_id)
        if entry is None:
            entry = _ActiveTrace()
            self._active[trace_id] = entry
            while len(self._active) > self.max_active:
                # Evict the oldest in-flight trace and judge it as-is
                # (attrs mark the truncation) — a leak of held traces
                # must never grow the buffer without bound.
                old_id, old = self._active.popitem(last=False)
                self._finalize(old_id, old, truncated=True)
        return entry

    def add_span(self, sp: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            if sp.trace_id in self._closed:
                # A late span for an already-finalized trace (evicted
                # under hold pressure, or released by the expiry
                # sweep): counted, never resurrected.
                self.late_spans += 1
                return
            entry = self._entry(sp.trace_id)
            if len(entry.spans) < self.max_spans:
                entry.spans.append(sp)
            else:
                entry.dropped += 1
        self._drain_export()

    def hold(self, trace_id: str) -> None:
        """Keep `trace_id` open past its root's end — deferred spans
        (matchmaker cohort stages) arrive later; `release` closes it."""
        if not self.enabled:
            return
        with self._lock:
            if trace_id in self._closed:
                return
            self._entry(trace_id).holds += 1
        self._drain_export()

    def release(self, trace_id: str) -> None:
        with self._lock:
            entry = self._active.get(trace_id)
            if entry is None:
                return
            entry.holds -= 1
            if entry.holds <= 0 and entry.root is not None:
                self._active.pop(trace_id, None)
                self._finalize(trace_id, entry)
        self._drain_export()

    def root_done(self, sp: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            entry = self._active.get(sp.trace_id)
            if entry is None:
                return
            entry.root = sp
            if entry.holds <= 0:
                self._active.pop(sp.trace_id, None)
                self._finalize(sp.trace_id, entry)
        self._drain_export()

    # --------------------------------------------------------- sampling

    @staticmethod
    def _p_sample(trace_id: str, rate: float) -> bool:
        """Deterministic per trace id WITHIN a process (tests need no
        seed plumbing; a trace is judged the same every time), but
        salted per boot: trace ids can be client-supplied via
        traceparent, and an unsalted prefix hash would let any caller
        mint always-kept ids and churn genuine error traces out of the
        bounded kept ring."""
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        h = zlib.crc32(_SAMPLE_SALT + trace_id.encode())
        return (h / 0xFFFFFFFF) < rate

    def _finalize(
        self, trace_id: str, entry: _ActiveTrace, truncated: bool = False
    ) -> None:
        # Called with the lock held.
        self._closed[trace_id] = None
        while len(self._closed) > 4096:
            self._closed.popitem(last=False)
        self.finished_total += 1
        root = entry.root
        # Slow is judged on the FULL span extent, not the root alone:
        # held traces (a cohort's dispatch→published, a ticket's
        # add→matched) carry their duration in post-hoc spans appended
        # long after the root span ended.
        extent_ms = 0.0
        if entry.spans:
            t0 = min(s.start_ts for s in entry.spans)
            t1 = max(
                (s.end_ts if s.end_ts is not None else s.start_ts)
                for s in entry.spans
            )
            extent_ms = (t1 - t0) * 1000.0
        reason = None
        if any(s.status == "error" for s in entry.spans):
            reason = "error"
        elif extent_ms >= self.slow_ms:
            reason = "slow"
        elif self._p_sample(trace_id, self.sample_rate):
            reason = "sampled"
        decision = f"kept_{reason}" if reason else "dropped"
        if self.metrics is not None:
            try:
                self.metrics.traces_sampled.labels(decision=decision).inc()
            except Exception:
                pass
        if reason is None:
            return
        self.kept_total += 1
        self.kept_by[reason] += 1
        record = {
            "trace_id": trace_id,
            "root": root.name if root is not None else "",
            # Wall extent over ALL spans (a held trace's story runs
            # long past its root span's end).
            "duration_ms": round(extent_ms, 3) if entry.spans else None,
            "status": (
                "error"
                if any(s.status == "error" for s in entry.spans)
                else "ok"
            ),
            "reason": reason,
            # Either form of loss is flagged: evicted-early from the
            # active buffer, or spans dropped past the per-trace cap —
            # a missing stage span must read as truncation, not as the
            # stage never having happened.
            "truncated": truncated or entry.dropped > 0,
            "spans_dropped": entry.dropped,
            "n_spans": len(entry.spans),
            "ts": entry.started,
            "spans": [s.as_dict() for s in entry.spans],
        }
        self.kept.append(record)
        if self.export_path:
            self._export_pending.append(record)

    def _drain_export(self) -> None:
        """Write pending kept records to the JSONL export OUTSIDE the
        lock — called by the public entry points after releasing it, so
        a slow disk never serializes span recording behind a write."""
        if not self.export_path:
            return
        while True:
            with self._lock:
                if not self._export_pending:
                    return
                record = self._export_pending.pop(0)
            try:
                if self._export_file is None:
                    self._export_file = open(
                        self.export_path, "a", buffering=1
                    )
                self._export_file.write(json.dumps(record) + "\n")
            except OSError:
                self.export_path = ""  # dead sink: stop paying for it
                return

    # ------------------------------------------------------------ reads

    def list(self, n: int = 32) -> list[dict]:
        """Newest-first kept-trace summaries (no span bodies)."""
        with self._lock:
            out = [
                {k: v for k, v in rec.items() if k != "spans"}
                for rec in list(self.kept)[-n:]
            ]
        out.reverse()
        return out

    def get(self, trace_id: str) -> dict | None:
        """Full kept trace in the OTLP-ish shape, or None."""
        with self._lock:
            for rec in reversed(self.kept):
                if rec["trace_id"] == trace_id:
                    return {
                        **{k: v for k, v in rec.items() if k != "spans"},
                        "resourceSpans": [
                            {"scopeSpans": [{"spans": rec["spans"]}]}
                        ],
                    }
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "sample_rate": self.sample_rate,
                "slow_ms": self.slow_ms,
                "finished_total": self.finished_total,
                "kept_total": self.kept_total,
                "kept_by": dict(self.kept_by),
                "active": len(self._active),
                "retained": len(self.kept),
                "late_spans": self.late_spans,
            }


# The process-wide store (faults.PLANE precedent): configured from
# config.tracing (`TracingConfig`); tests reset/configure it directly.
TRACES = TraceStore()


def emit_matched_spans(
    ctx: tuple[str, str],
    entry: dict | None,
    *,
    cohort_trace: str = "",
    published: bool = True,
) -> None:
    """Close a matched ticket's trace: synthesize the cohort stage
    spans (dispatch→ready→collected→published) from the delivery-ledger
    entry into the ticket's own trace, link the cohort's trace, and
    release the hold taken at `matchmaker.add`. The whole add→matched
    story then reads off ONE trace id."""
    trace_id, parent = ctx
    now = time.time()
    if entry is not None:
        base = entry.get("dispatched_ts") or now
        umbrella = Span(
            trace_id, new_span_id(), parent, "matchmaker.matched",
            start_ts=base,
        )
        umbrella.end_ts = now
        link_trace = cohort_trace or entry.get("trace_id") or ""
        if link_trace:
            umbrella.add_link(link_trace, kind="cohort")
        if entry.get("slipped"):
            umbrella.set_attribute("slipped", True)
        TRACES.add_span(umbrella)
        stages = (
            ("matchmaker.dispatch_to_ready", entry.get("ready_lag_s")),
            ("matchmaker.collected", entry.get("collect_lag_s")),
            ("matchmaker.published", entry.get("publish_lag_s")),
        )
        if not published:
            stages = stages[:-1]
        for name, lag in stages:
            if lag is None:
                continue
            emit_span(
                trace_id, umbrella.span_id, name,
                start_ts=base, end_ts=base + float(lag),
            )
    TRACES.release(trace_id)


# ------------------------------------------------------ device busy share

# Chrome-trace categories of work on the card (torch.profiler / Kineto).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_share(trace: dict | str, window: str) -> dict:
    """The card's busy share over a window of a `torch.profiler` Chrome
    trace: the union of kernel, copy and memset intervals that fall in
    the window, divided by the window. `window` names the user
    annotation that spans it (`Tracing.device_trace` records one).
    Overlapping device work (two streams) counts once. Returns the
    window and busy microseconds, the share, and the number of device
    events seen — 0 events means the trace holds no device activity
    and the share says nothing."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) else trace
    win = [
        e for e in events
        if e.get("ph") == "X" and e.get("name") == window
        and e.get("cat") in ("user_annotation", "cpu_op")
    ]
    if not win:
        raise ValueError(f"no annotation named {window!r} in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans = sorted(
        (max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
    )
    n_device = len(spans)
    busy = 0.0
    cur0 = cur1 = None
    for t0, t1 in spans:
        if t1 <= t0:
            continue  # outside the window
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
    window_us = w1 - w0
    return {
        "window_us": window_us,
        "busy_us": busy,
        "busy_share": busy / window_us if window_us > 0 else 0.0,
        "device_events": n_device,
    }


# ------------------------------------------------------------- SLO plane


class SloRecorder:
    """Multi-window (5m/1h) error-budget burn-rate recorder.

    Each SLO is (target, threshold): an observation is *good* when its
    value is at/under the threshold; the burn rate over a window is
    `bad_fraction / (1 - target)` — burn 1.0 spends the budget exactly
    at its sustainable pace, 14+ is the classic page-now fast burn.
    Ring-bucketed at 10s over one hour: O(1) observes, O(buckets)
    reads (the ladder samples at ~4Hz, so reads are off the hot path).
    """

    BUCKET_S = 10
    N_BUCKETS = 360  # one hour of 10s buckets
    WINDOWS = (("5m", 300), ("1h", 3600))

    def __init__(self, slos: dict[str, dict], metrics=None):
        # slos: name -> {"target": 0.99, "threshold_ms": 200}
        self.slos = {
            name: {
                "target": float(spec.get("target", 0.99)),
                "threshold_ms": float(spec.get("threshold_ms", 0.0)),
            }
            for name, spec in slos.items()
        }
        self.metrics = metrics
        self._lock = threading.Lock()
        n = self.N_BUCKETS
        self._good = {name: [0] * n for name in self.slos}
        self._bad = {name: [0] * n for name in self.slos}
        self._epoch = {name: [-1] * n for name in self.slos}

    def observe(self, name: str, value_ms: float) -> None:
        spec = self.slos.get(name)
        if spec is None:
            return
        self.observe_good(name, value_ms <= spec["threshold_ms"])

    def observe_good(self, name: str, good: bool) -> None:
        if name not in self.slos:
            return
        b = int(time.monotonic() // self.BUCKET_S)
        i = b % self.N_BUCKETS
        with self._lock:
            if self._epoch[name][i] != b:
                self._epoch[name][i] = b
                self._good[name][i] = 0
                self._bad[name][i] = 0
            if good:
                self._good[name][i] += 1
            else:
                self._bad[name][i] += 1

    def burn_rate(self, name: str, window_s: int) -> float:
        spec = self.slos.get(name)
        if spec is None:
            return 0.0
        budget = max(1e-9, 1.0 - spec["target"])
        b_now = int(time.monotonic() // self.BUCKET_S)
        k = max(1, min(self.N_BUCKETS, window_s // self.BUCKET_S))
        good = bad = 0
        with self._lock:
            for back in range(k):
                b = b_now - back
                i = b % self.N_BUCKETS
                if self._epoch[name][i] == b:
                    good += self._good[name][i]
                    bad += self._bad[name][i]
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / budget

    def burn_rates(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                label: round(self.burn_rate(name, w), 3)
                for label, w in self.WINDOWS
            }
            for name in self.slos
        }

    def sample(self) -> dict[str, dict[str, float]]:
        """Compute all burn rates and publish the gauges — called from
        the overload ladder's sampling loop, never per request."""
        rates = self.burn_rates()
        if self.metrics is not None:
            for name, windows in rates.items():
                for label, value in windows.items():
                    try:
                        self.metrics.slo_burn_rate.labels(
                            slo=name, window=label
                        ).set(value)
                    except Exception:
                        pass
        return rates

    def max_burn(self, window: str = "5m") -> float:
        w = dict(self.WINDOWS)[window]
        return max(
            (self.burn_rate(name, w) for name in self.slos), default=0.0
        )

    def snapshot(self) -> dict:
        return {
            "slos": self.slos,
            "burn_rates": self.burn_rates(),
        }

# ------------------------------------------------- aggregate Tracing obj


class Tracing:
    def __init__(self, config=None, logger=None):
        capacity = 256
        if config is not None:
            capacity = getattr(config, "breadcrumb_capacity", 256)
        self.logger = logger
        self.last_device_trace = ""
        self.breadcrumbs = Ledger(capacity)
        # Per-cohort pipelined delivery ledger (dispatch→delivered lag,
        # deadline slips): slips are observable here and via metrics,
        # not inferred from bench WARN lines.
        self.deliveries = Ledger(capacity)
        # Group-commit drain spans from the storage write batcher
        # (record_db_drain): batch size / drain time / queue depth.
        self.db_drains = Ledger(capacity)
        # Degradation-ladder transitions (faults.py CircuitBreaker) and
        # reclamation events: breaker open/half-open/closed flips plus
        # in-flight cohort reclamations, so an operator can read the
        # outage timeline off the ledger instead of correlating logs.
        self.breaker_events = Ledger(capacity)
        # Overload-ladder transitions (overload.py OverloadController):
        # OK→WARN→SHED flips with the per-signal levels that drove
        # them, so "why did we shed at 14:02" reads off the ledger.
        self.overload_events = Ledger(capacity)

    @property
    def deliveries_total(self) -> int:
        """Monotonic count of deliveries ever recorded (survives the
        bounded deque filling) — kept as a property for the pre-Ledger
        callers."""
        return self.deliveries.total

    def ledger_totals(self) -> dict:
        """Monotonic "how many ever" count per ledger."""
        return {
            "breadcrumbs": self.breadcrumbs.total,
            "deliveries": self.deliveries.total,
            "db_drains": self.db_drains.total,
            "breaker_events": self.breaker_events.total,
            "overload_events": self.overload_events.total,
        }

    # ------------------------------------------------------ device trace

    @contextlib.contextmanager
    def device_trace(self, out_dir: str, name: str = "device_trace"):
        """Capture one `torch.profiler` trace (CPU activity, plus CUDA
        kernels and copies when a card is present) around a block and
        write it as a Chrome trace under `out_dir`. Bounded by the
        block: the profiler runs only while it does. Yields the
        profiler; `last_device_trace` holds the written file's path.
        The window the block spans is recorded as a user annotation
        named `name`, which `busy_share` reads."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            with record_function(name):
                yield prof
        path = os.path.join(out_dir, f"{name}-{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(path)
        self.last_device_trace = path
        if self.logger is not None:
            self.logger.info("device trace written", path=path)

    # ------------------------------------------------------- breadcrumbs

    @contextlib.contextmanager
    def span(self, crumb: dict, key: str):
        """Accumulating timing crumb (NOT a request-scoped trace span —
        that is the module-level `span()`): adds elapsed seconds under
        `key` on the aggregate interval breadcrumb."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            crumb[key] = crumb.get(key, 0.0) + time.perf_counter() - t0

    def record(self, crumb: dict):
        self.breadcrumbs.append(crumb)

    def recent(self, n: int = 32) -> list[dict]:
        return self.breadcrumbs.recent(n)

    # -------------------------------------------------- cohort deliveries

    def record_delivery(self, **fields) -> dict:
        """One pipelined cohort delivered: lag attribution + slip flag
        (tpu.py accept path). Kept separate from interval breadcrumbs so
        mid-gap deliveries don't dilute per-interval timing rows.
        Returns the stored entry — later stage stamps (mark_published)
        mutate it in place, so holders of the return value see them."""
        self.deliveries.append(fields)
        return fields

    def recent_deliveries(self, n: int = 32) -> list[dict]:
        return self.deliveries.recent(n)

    def mark_published(
        self, pc_now: float, max_n: int | None = None
    ) -> list[float]:
        """Stamp dispatch→published lag on the newest ledger entries
        that have none yet (the cohorts whose batch the caller just
        handed to `on_matched`), closing each entry's stage chain:
        ready_lag_s → fetch_lag_s → collect_lag_s → accept_lag_s →
        publish_lag_s, all relative to dispatch. `max_n` bounds the
        stamping to the entries one collect call recorded, so a cohort
        that never published (empty batch, no callback) cannot absorb a
        much-later publish stamp. Returns the lags stamped."""
        out: list[float] = []
        for entry in reversed(self.deliveries):
            if "publish_lag_s" in entry:
                break
            if max_n is not None and len(out) >= max_n:
                break
            t_disp = entry.get("_pc_dispatch")
            if t_disp is None:
                continue
            lag = pc_now - t_disp
            entry["publish_lag_s"] = round(lag, 3)
            out.append(lag)
        return out

    def delivery_stage_stats(self) -> dict:
        """p50/p99 per delivery stage over the retained ledger — the
        one-call attribution surface: a
        delivery-gap regression names its stage here instead of hiding
        inside a single end-to-end number."""
        stages = (  # chain order: D2H fetch, then assembly completes
            "fetch_lag_s",
            "ready_lag_s",
            "collect_lag_s",
            "accept_lag_s",
            "publish_lag_s",
        )
        out: dict[str, dict] = {}
        for key in stages:
            vals = sorted(
                d[key]
                for d in self.deliveries
                if isinstance(d.get(key), (int, float))
            )
            if vals:
                out[key] = {
                    "p50": vals[len(vals) // 2],
                    "p99": vals[min(len(vals) - 1, int(len(vals) * 0.99))],
                    "n": len(vals),
                }
        return out

    def slip_count(self) -> int:
        """Deliveries in the retained window that missed their cohort's
        interval deadline."""
        return sum(1 for d in self.deliveries if d.get("slipped"))

    # ---------------------------------------------------- db drain spans

    def record_db_drain(self, **fields):
        """One group-commit drain by the storage write batcher: batch
        size, drain duration, and post-drain queue depth (storage/db.py
        WriteBatcher). A separate ledger so high-rate write drains don't
        evict the interval breadcrumbs."""
        self.db_drains.append(fields)

    def recent_db_drains(self, n: int = 32) -> list[dict]:
        return self.db_drains.recent(n)

    # ------------------------------------------------ degradation ladder

    def record_breaker(self, **fields):
        """One breaker transition or reclamation event (matchmaker
        backend): state flip, reason, and counts. Also
        attached as an event to the active trace span, so an error
        trace carries its breaker context inline."""
        sp = _current_span.get()
        if sp is not None:
            sp.add_event("breaker", **fields)
        self.breaker_events.append(fields)

    def recent_breaker_events(self, n: int = 32) -> list[dict]:
        return self.breaker_events.recent(n)

    # ------------------------------------------------- overload ladder

    def record_overload(self, **fields):
        """One overload-ladder transition (overload.py): old/new level
        and the per-signal levels at the sample that drove it."""
        self.overload_events.append(fields)

    def recent_overload_events(self, n: int = 32) -> list[dict]:
        return self.overload_events.recent(n)

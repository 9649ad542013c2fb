"""Overload-control plane: admit, bound, shed — by priority.

Port of the JAX package's `overload.py`, over the port's own `faults`
and `tracing` modules. The classic overload triad, wired to the load
signals the matchmaker and the storage engine export:

- **Deadline propagation** — every request carries a `Deadline` (from
  `grpc-timeout` / `X-Request-Timeout`, else a per-class config
  default) in a contextvar that follows the request through the
  pipeline into storage calls and matchmaker adds. Expired deadlines
  short-circuit with `DeadlineExceeded` *before* doing dead work:
  `LocalMatchmaker.add` refuses the ticket, and the storage write
  batcher drops queued units whose caller deadline already passed.

- **AdmissionController** — a concurrency limiter with three priority
  classes (realtime socket ops > authenticated RPC/storage > anonymous
  list/read endpoints), bounded per-class wait queues, and fast
  rejection (`AdmissionRejected`, 429 + Retry-After at a front door)
  when a class's queue is full. A token-bucket per-key `RateLimiter`
  generalizes login lockouts to arbitrary request keys.

- **OverloadController** — the OK→WARN→SHED load-level ladder, fed by
  registered signals (`db_queue_signal` on the write-queue depth,
  `breaker_signal` on the device breaker, `interval_lag_signal` on the
  matchmaker's delivery lag, `slo_burn_signal` on the SLO plane).
  Escalation is immediate; recovery requires `recover_samples`
  consecutive calmer samples (hysteresis). WARN tightens the wait
  queues and stops queueing the lowest class; SHED rejects the lowest
  class outright and flushes its waiters. Transitions land in metrics
  (`overload_state`, `requests_shed{class,reason}`,
  `request_deadline_exceeded`) and the tracing overload ledger.

The disarmed posture costs one contextvar set/reset and one counter
bump per request.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import contextvars
import time

from . import faults
from . import tracing as trace_api

# ------------------------------------------------------- priority classes

REALTIME = 0  # socket ops: match data, party, status, matchmaker adds
RPC = 1  # authenticated request/response: storage writes, rpc, account
LIST = 2  # list/read endpoints: cheapest to retry, first to shed

CLASS_NAMES = {REALTIME: "realtime", RPC: "rpc", LIST: "list"}

# ------------------------------------------------------------ load levels

OK = 0
WARN = 1
SHED = 2

LEVEL_NAMES = {OK: "ok", WARN: "warn", SHED: "shed"}


class OverloadError(Exception):
    pass


class AdmissionRejected(OverloadError):
    """The request was refused admission — mapped to HTTP 429 +
    Retry-After / gRPC RESOURCE_EXHAUSTED by the front doors. Raised
    synchronously (no dead work): the whole point of shedding is that a
    rejection costs microseconds, not a timeout."""

    def __init__(self, cls: int, reason: str, retry_after_sec: float = 1.0):
        super().__init__(
            f"admission rejected ({CLASS_NAMES.get(cls, cls)}: {reason})"
        )
        self.cls = cls
        self.reason = reason
        self.retry_after_sec = retry_after_sec


class DeadlineExceeded(OverloadError):
    """The caller's deadline passed — mapped to HTTP 504 / gRPC
    DEADLINE_EXCEEDED. Raised *before* dead work wherever a deadline
    checkpoint exists (admission, matchmaker add, storage drain)."""


# --------------------------------------------------------------- deadline


class Deadline:
    """Absolute expiry on the monotonic clock, carried per-request.

    `explicit` distinguishes a client-supplied timeout (grpc-timeout /
    X-Request-Timeout — the front door enforces it with a bounded wait)
    from a per-class config default (propagated for queue-drop
    checkpoints but not worth a wait_for task per request)."""

    __slots__ = ("expires_at", "explicit")

    def __init__(self, timeout_s: float, explicit: bool = False):
        self.expires_at = time.monotonic() + max(0.0, float(timeout_s))
        self.explicit = explicit

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at


_GRPC_TIMEOUT_UNITS = {
    "H": 3600.0,
    "M": 60.0,
    "S": 1.0,
    "m": 1e-3,
    "u": 1e-6,
    "n": 1e-9,
}


def parse_grpc_timeout(value: str) -> float:
    """gRPC `grpc-timeout` wire format: ASCII digits + one unit letter
    (e.g. "100m" = 100ms, "5S" = 5s). Returns seconds; raises
    ValueError on malformed input."""
    value = value.strip()
    if (
        len(value) < 2
        or value[-1] not in _GRPC_TIMEOUT_UNITS
        or not value[:-1].isdigit()  # spec: ASCII digits, no sign
    ):
        raise ValueError(f"malformed grpc-timeout: {value!r}")
    return int(value[:-1]) * _GRPC_TIMEOUT_UNITS[value[-1]]


def deadline_from_headers(headers, default_ms: int) -> Deadline:
    """Build the request Deadline from `grpc-timeout` (gRPC wire
    format) or `X-Request-Timeout` (milliseconds), else the per-class
    config default. Raises ValueError on a malformed header (the front
    door maps it to 400)."""
    raw = headers.get("grpc-timeout", "")
    if raw:
        return Deadline(parse_grpc_timeout(raw), explicit=True)
    raw = headers.get("X-Request-Timeout", "")
    if raw:
        try:
            ms = float(raw)
        except ValueError:
            raise ValueError(f"malformed X-Request-Timeout: {raw!r}")
        if ms <= 0:
            raise ValueError(f"X-Request-Timeout must be > 0: {raw!r}")
        return Deadline(ms / 1000.0, explicit=True)
    return Deadline(max(1, int(default_ms)) / 1000.0, explicit=False)


# The propagation channel: contextvars follow the request through every
# awaited call on its task, so storage/matchmaker checkpoints read the
# caller's deadline without threading a parameter through every core
# signature.
_current_deadline: contextvars.ContextVar[Deadline | None] = (
    contextvars.ContextVar("nakama_request_deadline", default=None)
)


def current_deadline() -> Deadline | None:
    return _current_deadline.get()


def set_deadline(deadline: Deadline | None):
    """Install `deadline` for the current context; returns the reset
    token for `reset_deadline`."""
    return _current_deadline.set(deadline)


def reset_deadline(token) -> None:
    _current_deadline.reset(token)


@contextlib.contextmanager
def deadline_scope(deadline: Deadline | None):
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)


def check_deadline(where: str = "") -> None:
    """Short-circuit checkpoint: raise DeadlineExceeded if the current
    context's deadline already passed. One contextvar get + one clock
    read when a deadline is set; one contextvar get when not."""
    dl = _current_deadline.get()
    if dl is not None and dl.expired():
        raise DeadlineExceeded(
            f"deadline exceeded{f' at {where}' if where else ''}"
        )


# ------------------------------------------------------------ rate limiter


class TokenBucket:
    __slots__ = ("tokens", "stamp")

    def __init__(self, burst: float, now: float):
        self.tokens = burst
        self.stamp = now


class RateLimiter:
    """Token bucket per key (session/IP) — the general form of the
    tiered `LocalLoginAttemptCache` lockouts: `rate` tokens/sec refill
    up to `burst`; a request spends one token or is rejected. Bounded
    memory with O(1) maintenance: the bucket dict is kept in LRU order
    (touched keys re-inserted at the end), so at capacity the
    least-recently-seen key is evicted in constant time — the
    limiter's own cost must not inflate under the very key-flood it
    exists to absorb."""

    def __init__(self, rate: float, burst: int, max_keys: int = 8192):
        self.rate = float(rate)
        self.burst = max(1, int(burst))
        self.max_keys = max(16, int(max_keys))
        self._buckets: dict[str, TokenBucket] = {}

    def allow(self, key: str) -> bool:
        if self.rate <= 0:
            return True
        now = time.monotonic()
        b = self._buckets.pop(key, None)
        if b is None:
            while len(self._buckets) >= self.max_keys:
                # LRU eviction: insertion order IS recency order
                # because every touch re-inserts at the end.
                del self._buckets[next(iter(self._buckets))]
            b = TokenBucket(float(self.burst), now)
        else:
            b.tokens = min(
                float(self.burst), b.tokens + (now - b.stamp) * self.rate
            )
            b.stamp = now
        self._buckets[key] = b
        if b.tokens >= 1.0:
            b.tokens -= 1.0
            return True
        return False


# ------------------------------------------------------------- admission


class _Waiter:
    __slots__ = ("future", "cls")

    def __init__(self, future, cls):
        self.future = future
        self.cls = cls


class AdmissionController:
    """Server-wide concurrency limiter with priority classes.

    `max_concurrent` permits are shared by every class; when none is
    free, a request parks in its class's bounded wait queue. Releases
    grant strictly by priority (all realtime waiters before any rpc
    waiter before any list waiter; FIFO within a class). A full queue
    rejects immediately.

    The ladder tightens policy via `set_level`:

    - OK: full queue caps.
    - WARN: queue caps halve; the lowest class (LIST) no longer queues
      at all — it is admitted only when a permit is immediately free.
    - SHED: the lowest class is rejected outright (queued LIST waiters
      are flushed with rejection); remaining queues stay halved.

    Single-loop discipline: all state mutation happens on the server's
    event loop (admit/release are called from request handlers), so no
    internal lock is needed — same ownership model as CircuitBreaker.
    """

    def __init__(
        self,
        max_concurrent: int,
        queue_caps: dict[int, int],
        retry_after_sec: float = 1.0,
        metrics=None,
    ):
        self.max_concurrent = max(1, int(max_concurrent))
        self._base_caps = {
            cls: max(0, int(queue_caps.get(cls, 0)))
            for cls in (REALTIME, RPC, LIST)
        }
        self.retry_after_sec = float(retry_after_sec)
        self.metrics = metrics
        self.level = OK
        self.inflight = 0
        self._queues: dict[int, collections.deque[_Waiter]] = {
            cls: collections.deque() for cls in (REALTIME, RPC, LIST)
        }
        # Ledger counters (bench/tests/console).
        self.admitted_total = 0
        self.shed_total = 0
        self.shed_by: collections.Counter = collections.Counter()

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        return {
            "level": LEVEL_NAMES[self.level],
            "inflight": self.inflight,
            "max_concurrent": self.max_concurrent,
            "queued": {
                CLASS_NAMES[cls]: len(q) for cls, q in self._queues.items()
            },
            "admitted_total": self.admitted_total,
            "shed_total": self.shed_total,
            "shed_by": {
                f"{CLASS_NAMES[c]}:{r}": n
                for (c, r), n in self.shed_by.items()
            },
        }

    def _queue_cap(self, cls: int) -> int:
        cap = self._base_caps[cls]
        if self.level == OK:
            return cap
        if cls == LIST:
            return 0  # WARN/SHED: the lowest class never queues
        return cap // 2

    # ------------------------------------------------------------- ladder

    def set_level(self, level: int) -> None:
        self.level = level
        if level == SHED:
            # Flush parked LIST waiters NOW: they would be rejected on
            # grant anyway, and a fast rejection is the contract.
            q = self._queues[LIST]
            while q:
                w = q.popleft()
                if not w.future.done():
                    w.future.set_exception(self.reject(LIST, "shed"))

    # ---------------------------------------------------------- admission

    def reject(self, cls: int, reason: str) -> AdmissionRejected:
        """Mint (and account for) a shed: bumps the shed ledger and the
        requests_shed metric, returns the AdmissionRejected carrying
        the retry hint. Public so front doors can record policy
        rejections that happen OUTSIDE the permit path (e.g. the rate
        limiter) through the same books."""
        self.shed_total += 1
        self.shed_by[(cls, reason)] += 1
        # A shed on the active trace span: the 429's trace carries WHY
        # it was rejected (class + reason), and error-status sampling
        # keeps it.
        trace_api.add_event(
            "admission.shed",
            **{"class": CLASS_NAMES.get(cls, cls), "reason": reason},
        )
        if self.metrics is not None:
            try:
                self.metrics.requests_shed.labels(
                    **{"class": CLASS_NAMES[cls], "reason": reason}
                ).inc()
            except Exception:
                pass
        return AdmissionRejected(
            cls, reason, retry_after_sec=self.retry_after_sec
        )

    def try_admit(self, cls: int):
        """Synchronous fast path: a permit, a parked waiter future, or
        an immediate AdmissionRejected — never an await. Callers that
        get a future await it (deadline-bounded) then own a permit."""
        faults.fire("api.admit")
        if self.level == SHED and cls == LIST:
            raise self.reject(cls, "shed")
        # Park behind earlier same/higher-priority waiters even when a
        # permit is free: granted strictly in priority+FIFO order. Dead
        # heads (timed out / cancelled while parked) are trimmed first —
        # a queue of only dead waiters must read as uncontended, or a
        # fresh arrival would park behind ghosts with no release coming.
        contended = False
        for c in (REALTIME, RPC, LIST):
            if c > cls:
                break
            q = self._queues[c]
            while q and q[0].future.done():
                q.popleft()
            if q:
                contended = True
        if self.inflight < self.max_concurrent and not contended:
            self.inflight += 1
            self.admitted_total += 1
            self._note_gauges()
            return None
        q = self._queues[cls]
        if len(q) >= self._queue_cap(cls):
            raise self.reject(
                cls, "queue_full" if self.level == OK else "warn"
            )
        fut = asyncio.get_running_loop().create_future()
        q.append(_Waiter(fut, cls))
        self._note_gauges()
        return fut

    async def admit(self, cls: int, deadline: Deadline | None = None) -> None:
        """Acquire one permit (priority-ordered, queue-bounded,
        deadline-bounded). Raises AdmissionRejected or DeadlineExceeded;
        on success the caller MUST `release()` exactly once."""
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded("deadline exceeded before admission")
        fut = self.try_admit(cls)
        if fut is None:
            return
        # The wait is the observable: a request that parked behind the
        # permit pool records when (and how long) it queued on its
        # trace span, so "why was this request slow" names admission
        # instead of blaming the handler.
        t_queued = time.monotonic()
        trace_api.add_event(
            "admission.queued",
            **{"class": CLASS_NAMES.get(cls, cls),
               "queued": len(self._queues[cls])},
        )
        timeout = None if deadline is None else max(0.0, deadline.remaining())

        def _granted() -> bool:
            return (
                fut.done()
                and not fut.cancelled()
                and fut.exception() is None
            )

        try:
            await asyncio.wait_for(fut, timeout)
            trace_api.add_event(
                "admission.granted",
                wait_ms=round((time.monotonic() - t_queued) * 1000, 2),
            )
        except asyncio.TimeoutError:
            if _granted():
                return  # granted in the timeout race window: keep it
            raise DeadlineExceeded("deadline exceeded waiting for admission")
        except asyncio.CancelledError:
            if _granted():
                self.release()  # granted but the caller is going away
            raise
        finally:
            # Rejected-by-flush futures resolve with AdmissionRejected;
            # timed-out/cancelled waiters are lazily skipped on grant
            # (their future is done), so no queue scan is needed here.
            self._note_gauges()

    def release(self) -> None:
        """Return a permit and hand it to the highest-priority waiter."""
        self.inflight -= 1
        for cls in (REALTIME, RPC, LIST):
            q = self._queues[cls]
            while q:
                w = q.popleft()
                if w.future.done():
                    continue  # timed out / cancelled while parked
                if self.level == SHED and cls == LIST:
                    w.future.set_exception(self.reject(cls, "shed"))
                    continue
                self.inflight += 1
                self.admitted_total += 1
                w.future.set_result(None)
                self._note_gauges()
                return
        self._note_gauges()

    @contextlib.asynccontextmanager
    async def admitted(self, cls: int, deadline: Deadline | None = None):
        await self.admit(cls, deadline)
        try:
            yield
        finally:
            self.release()

    def _note_gauges(self) -> None:
        if self.metrics is not None:
            try:
                self.metrics.admission_inflight.set(self.inflight)
            except Exception:
                pass


# ------------------------------------------------------------ the ladder


class OverloadController:
    """OK→WARN→SHED state machine over registered load signals.

    Signals are zero-arg callables returning a level (OK/WARN/SHED);
    the sampled state is the max across signals. Escalation applies
    immediately; de-escalation requires `recover_samples` consecutive
    samples at the lower level (hysteresis). The armed
    `overload.signal` fault point (drop mode) forces a SHED sample so
    chaos runs can drive the ladder without manufacturing real load.

    Owns the AdmissionController + RateLimiter so the front doors have
    one object to consult; `sample()` pushes each transition into the
    admission policy, metrics, the tracing overload ledger, and the
    log.
    """

    def __init__(
        self,
        admission: AdmissionController,
        rate_limiter: RateLimiter | None = None,
        *,
        recover_samples: int = 3,
        logger=None,
        metrics=None,
        tracing=None,
    ):
        self.admission = admission
        self.rate_limiter = rate_limiter
        self.recover_samples = max(1, int(recover_samples))
        self.logger = logger
        self.metrics = metrics
        self.tracing = tracing
        self.state = OK
        self.transitions = 0
        self._signals: list[tuple[str, object]] = []
        self._calm_streak = 0
        self._task: asyncio.Task | None = None
        self._last_levels: dict[str, int] = {}

    def register_signal(self, name: str, fn) -> None:
        """`fn() -> OK|WARN|SHED`; exceptions count as OK (a broken
        signal must never be the thing that sheds traffic)."""
        self._signals.append((name, fn))

    def sample(self) -> int:
        level = OK
        levels: dict[str, int] = {}
        for name, fn in self._signals:
            try:
                lv = int(fn())
            except Exception:
                lv = OK
            levels[name] = lv
            if lv > level:
                level = lv
        if faults.fire("overload.signal"):
            # drop-mode chaos: one forced SHED sample per fire.
            levels["fault"] = SHED
            level = SHED
        self._last_levels = levels
        if level >= self.state:
            if level > self.state:
                self._transition(level, levels)
            self._calm_streak = 0
        else:
            self._calm_streak += 1
            if self._calm_streak >= self.recover_samples:
                self._transition(level, levels)
                self._calm_streak = 0
        return self.state

    def _transition(self, new: int, levels: dict[str, int]) -> None:
        old, self.state = self.state, new
        self.transitions += 1
        self.admission.set_level(new)
        if self.metrics is not None:
            try:
                self.metrics.overload_state.set(new)
            except Exception:
                pass
        if self.tracing is not None:
            self.tracing.record_overload(
                old=LEVEL_NAMES[old],
                new=LEVEL_NAMES[new],
                signals={k: LEVEL_NAMES[v] for k, v in levels.items()},
            )
        if self.logger is not None:
            log = (
                self.logger.warn if new > old else self.logger.info
            )
            log(
                "overload state changed",
                old=LEVEL_NAMES[old],
                new=LEVEL_NAMES[new],
                signals={k: LEVEL_NAMES[v] for k, v in levels.items()},
            )

    def stats(self) -> dict:
        return {
            "state": LEVEL_NAMES[self.state],
            "transitions": self.transitions,
            "signals": {
                k: LEVEL_NAMES.get(v, v)
                for k, v in self._last_levels.items()
            },
            "admission": self.admission.stats(),
        }

    # ----------------------------------------------------------- lifecycle

    def start(self, interval_s: float) -> None:
        async def _loop():
            while True:
                await asyncio.sleep(interval_s)
                try:
                    self.sample()
                except Exception as e:  # never kill the sampler
                    if self.logger is not None:
                        self.logger.error(
                            "overload sample error", error=str(e)
                        )

        self._task = asyncio.get_running_loop().create_task(_loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def enter_drain(self) -> None:
        """Graceful-shutdown posture (server.stop): kill the sampler —
        no calm signal may de-escalate a draining server — and walk the
        ladder straight to SHED, so new low-priority work is rejected
        with Retry-After while in-flight requests and matchmaker
        cohorts finish inside the grace window."""
        self.stop()
        if self.state != SHED:
            self._transition(SHED, {"drain": SHED})
        else:
            self.admission.set_level(SHED)


# ------------------------------------------------------- signal builders


def db_queue_signal(depth_fn, capacity: int, warn_frac: float,
                    shed_frac: float):
    """Level from the storage write-queue depth as a fraction of its
    bound (the `db_write_queue_depth` gauge, read directly)."""
    cap = max(1, int(capacity))

    def signal() -> int:
        frac = depth_fn() / cap
        if frac >= shed_frac:
            return SHED
        if frac >= warn_frac:
            return WARN
        return OK

    return signal


def breaker_signal(breaker_fn):
    """Level from a faults.CircuitBreaker: open/half-open means the
    protected backend is degraded — tighten admission (WARN), but the
    fallback path still serves, so a breaker alone never SHEDs."""

    def signal() -> int:
        breaker = breaker_fn()
        if breaker is None:
            return OK
        return OK if breaker.state == "closed" else WARN

    return signal


def slo_burn_signal(recorder, warn_burn: float, shed_burn: float,
                    escalate: bool = True):
    """Level from the SLO plane's 5m error-budget burn (tracing.py
    SloRecorder): sampling this signal also publishes the
    `slo_burn_rate{slo,window}` gauges (the ladder loop is the periodic
    context they need). With `escalate=False` the signal only publishes
    and always reports OK — the burn is observable without feeding
    admission policy (the default posture: first intervals pay XLA
    compiles that would spike the burn on a fresh boot)."""

    def signal() -> int:
        recorder.sample()
        if not escalate:
            return OK
        burn = recorder.max_burn("5m")
        if burn >= shed_burn:
            return SHED
        if burn >= warn_burn:
            return WARN
        return OK

    return signal


def interval_lag_signal(next_deadline_fn, warn_lag_s: float,
                        shed_lag_s: float):
    """Level from matchmaker delivery lag: how far past its delivery
    deadline the head cohort is (perf_counter seconds). A cohort
    slightly past deadline = WARN; a full interval past = SHED."""

    def signal() -> int:
        dl = next_deadline_fn()
        if dl is None:
            return OK
        lag = time.perf_counter() - dl
        if lag >= shed_lag_s:
            return SHED
        if lag >= warn_lag_s:
            return WARN
        return OK

    return signal

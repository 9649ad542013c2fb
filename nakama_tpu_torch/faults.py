"""Fault-injection plane + degradation primitives.

Port of the JAX package's `faults.py` (the port keeps its own copy; it
imports nothing of that package). Three pieces:

- `FaultPlane` — a process-wide registry of named injection points.
  Hot paths call ``fire("device.dispatch")``; when nothing is armed
  that is one empty-dict truthiness check (zero overhead, the
  disarmed production posture). Points are coarse-grained (per
  interval / per cohort, never per row). The port's point names are in
  `FAULT_POINTS`.

- `CircuitBreaker` — closed → open after N consecutive transient
  failures (or ONE fatal), open → half-open after a cooldown,
  half-open admits exactly one probe whose outcome closes or re-opens
  the breaker with exponentially grown cooldown. Consumer: the
  matchmaker's device path (open = bounded host-oracle fallback,
  matchmaker/cuda.py).

- `classify_exception` — transient vs fatal. Transient errors (I/O,
  timeouts, injected faults, CUDA out-of-memory) count toward the
  breaker threshold; fatal ones (programming errors: ValueError,
  KeyError, ...) trip it immediately — retrying a deterministic bug N
  times just burns N intervals.

- `degrades` — which device-path failures the ladder may absorb at
  all: injected faults and CUDA out-of-memory. Everything else (a
  hand-written kernel that fails to build or launch, an illegal
  address surfacing at a fetch, any other CUDA error) propagates out
  of the matchmaker: serving the pool from the host oracle would hide
  a broken kernel behind a working service.
"""

from __future__ import annotations

import asyncio
import contextlib
import random
import threading
import time

FAULT_POINTS = (
    "device.dispatch",   # CudaBackend._dispatch (raise/stall)
    "device.collect",    # the cohort's fetch/assembly worker thread
    "db.drain",          # WriteBatcher drain loop, per batch
    "db.read",           # ReadCoalescer drain worker, per chunk
    "delivery.publish",  # LocalMatchmaker on_matched delivery
    "api.admit",         # AdmissionController.try_admit (overload.py)
    "overload.signal",   # ladder sample; drop mode forces a SHED sample
    "journal.append",    # TicketJournal flush (recovery.py), per batch
    "journal.replay",    # warm-restart journal replay (recovery.py)
    "checkpoint.write",  # pool snapshot write (recovery.py), per attempt
    "leaderboard.flush",  # DeviceRankEngine staging flush, per board
    "leaderboard.rank",  # DeviceRankEngine rank/window/sweep read
)


class InjectedFault(Exception):
    """Default exception raised by an armed ``raise``-mode point.
    Classified transient unless armed with ``fatal=True``."""

    def __init__(self, point: str, fatal: bool = False):
        super().__init__(f"injected fault at {point}")
        self.point = point
        self.fatal = fatal


class _Armed:
    __slots__ = (
        "mode", "probability", "remaining", "exc", "stall_s", "rng",
        "fatal",
    )

    def __init__(self, mode, probability, remaining, exc, stall_s, seed,
                 fatal):
        self.mode = mode
        self.probability = probability
        self.remaining = remaining
        self.exc = exc
        self.stall_s = stall_s
        self.rng = random.Random(seed)
        self.fatal = fatal


class FaultPlane:
    """Named injection points, armed by tests and chaos runs — never by
    production config. ``fire`` is called from the event loop AND from
    worker threads (the cohort assembly thread), so arming state is
    lock-guarded; the disarmed fast path takes no lock."""

    def __init__(self):
        self._armed: dict[str, _Armed] = {}
        self._lock = threading.Lock()
        self._metrics = None
        # name -> injections actually delivered (observability + the
        # deterministic tests' "did it actually fire" assertions).
        self.fired: dict[str, int] = {}

    def bind_metrics(self, metrics) -> None:
        """Attach a Metrics sink for the `faults_injected` counter."""
        self._metrics = metrics

    def arm(
        self,
        point: str,
        mode: str = "raise",
        *,
        probability: float = 1.0,
        count: int | None = None,
        exc: Exception | None = None,
        stall_s: float = 0.05,
        seed: int | None = None,
        fatal: bool = False,
    ) -> None:
        """Arm `point`. ``mode``: "raise" (throw ``exc`` or
        InjectedFault), "stall" (sleep ``stall_s`` in the caller's
        thread), "drop" (``fire`` returns True; the caller drops the
        unit of work). ``probability`` gates each fire through a
        dedicated seeded RNG so chaos runs replay; ``count`` bounds
        total injections (the point disarms itself when exhausted)."""
        if mode not in ("raise", "stall", "drop"):
            raise ValueError(f"unknown fault mode {mode!r}")
        with self._lock:
            self._armed[point] = _Armed(
                mode, probability, count, exc, stall_s, seed, fatal
            )

    def disarm(self, point: str | None = None) -> None:
        """Disarm one point, or every point when None."""
        with self._lock:
            if point is None:
                self._armed.clear()
            else:
                self._armed.pop(point, None)

    def armed(self) -> list[str]:
        with self._lock:
            return sorted(self._armed)

    def fire(self, point: str) -> bool:
        """Hot-path check. Disarmed (the production posture): one dict
        truthiness check, no lock. Armed: maybe raise ("raise"), sleep
        ("stall"), or return True ("drop" — caller discards the work
        unit). Returns False when nothing fires."""
        if not self._armed:
            return False
        with self._lock:
            a = self._armed.get(point)
            if a is None:
                return False
            if a.probability < 1.0 and a.rng.random() >= a.probability:
                return False
            if a.remaining is not None:
                a.remaining -= 1
                if a.remaining <= 0:
                    del self._armed[point]
            self.fired[point] = self.fired.get(point, 0) + 1
            mode, exc, stall_s, fatal = a.mode, a.exc, a.stall_s, a.fatal
        if self._metrics is not None:
            try:
                self._metrics.faults_injected.labels(
                    point=point, mode=mode
                ).inc()
            except Exception:
                pass  # observability must never mask the injection
        if mode == "stall":
            time.sleep(stall_s)
            return False
        if mode == "raise":
            raise exc if exc is not None else InjectedFault(
                point, fatal=fatal
            )
        return True  # drop

    @contextlib.contextmanager
    def armed_ctx(self, point: str, **kw):
        """``with PLANE.armed_ctx("device.collect"): ...`` — scoped
        arming for tests; always disarms, even when the body raises."""
        self.arm(point, **kw)
        try:
            yield self
        finally:
            self.disarm(point)


# The process-wide plane: callers use the module-level aliases so the
# call sites read `faults.fire("device.dispatch")`.
PLANE = FaultPlane()
fire = PLANE.fire
arm = PLANE.arm
disarm = PLANE.disarm
armed_ctx = PLANE.armed_ctx


# ------------------------------------------------------- classification

_TRANSIENT_TYPES = (
    OSError,                      # sockets, files, ECONNRESET, ...
    TimeoutError,
    asyncio.IncompleteReadError,  # wire connection died mid-message
)
# Device weather matched BY NAME so this module never imports torch:
# `torch.cuda.OutOfMemoryError` (alias `torch.OutOfMemoryError`) is an
# allocation that may succeed once in-flight cohorts free their tensors.
# Every other device error is FATAL — in particular the
# `RuntimeError("... kernel launch failed ...")` the hand-written
# kernel wrappers raise (kernels.py). Such errors never reach the
# breaker at all: `degrades` keeps them out of the ladder.
_TRANSIENT_NAMES = ("OutOfMemoryError",)


def classify_exception(exc: BaseException) -> str:
    """"transient" (retry/degrade: I/O, timeouts, device weather,
    injected faults) or "fatal" (a programming error: open the breaker
    immediately, a deterministic bug never succeeds on retry)."""
    if isinstance(exc, InjectedFault):
        return "fatal" if exc.fatal else "transient"
    if isinstance(exc, _TRANSIENT_TYPES):
        return "transient"
    if type(exc).__name__ in _TRANSIENT_NAMES:
        return "transient"
    return "fatal"


def degrades(exc: BaseException) -> bool:
    """May the degradation ladder absorb this device-path failure?
    Only an injected fault (chaos drills) or device memory pressure.
    A kernel build or launch error, or any other error from the card,
    is a bug: it must raise out of the interval, never move the work
    to the host oracle while the pool stays on the card."""
    return isinstance(exc, InjectedFault) or (
        type(exc).__name__ in _TRANSIENT_NAMES
    )


def from_card(exc: BaseException) -> bool:
    """Is this an error from the card that no storage-side degrade path
    may absorb? torch raises a CUDA fault as a `RuntimeError`
    (`torch.AcceleratorError` is one), and the kernel wrappers raise
    one for a failed build or launch (kernels.py); storage errors
    (sqlite3, OSError, pickle, `DatabaseError`) never are. `degrades`
    admits what the ladder may absorb, device memory pressure
    included. The recovery plane degrades to the journal on storage
    errors, the JAX package's behaviour, and raises these."""
    return isinstance(exc, RuntimeError) and not degrades(exc)


# ------------------------------------------------------ circuit breaker

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# matchmaker_backend_state gauge encoding.
STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probes.

    closed: work proceeds; N consecutive transient failures (or one
    fatal) open it. open: ``allow()`` is False until the cooldown
    elapses, then the breaker goes half-open and admits exactly ONE
    probe. half-open: probe success closes (cooldown resets to base),
    probe failure re-opens with the cooldown doubled (capped), so a
    persistently dead backend is probed at a decaying rate instead of
    hammered every interval.

    Single-owner discipline: all mutation happens on the owner's event
    loop (the matchmaker interval path) — no internal lock.
    ``record_success`` outside half-open only resets the failure
    streak; it can never close an OPEN breaker (stale successes from
    work dispatched before the failures must not mask an outage)."""

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 30.0,
        max_cooldown_s: float | None = None,
        clock=time.monotonic,
        on_transition=None,
    ):
        self.threshold = max(1, int(threshold))
        self.base_cooldown_s = max(0.001, float(cooldown_s))
        self.max_cooldown_s = (
            16.0 * self.base_cooldown_s
            if max_cooldown_s is None
            else float(max_cooldown_s)
        )
        self._clock = clock
        self._on_transition = on_transition
        self.state = CLOSED
        self.consecutive_failures = 0
        self.cooldown_s = self.base_cooldown_s
        self.opened_at: float | None = None
        self._probe_inflight = False
        # Ledger counters for metrics/tests.
        self.opens = 0
        self.failures = 0

    def _transition(self, new: str, reason: str = ""):
        old, self.state = self.state, new
        if old != new and self._on_transition is not None:
            self._on_transition(old, new, reason)

    def allow(self) -> bool:
        """May work proceed on the protected (primary) path? In
        half-open, True exactly once — the probe — until its outcome
        is recorded."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if (
                self.opened_at is not None
                and self._clock() - self.opened_at >= self.cooldown_s
            ):
                self._transition(HALF_OPEN, "cooldown elapsed")
                self._probe_inflight = True
                return True
            return False
        # HALF_OPEN: one probe at a time.
        if not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def release_probe(self):
        """The granted half-open probe never launched (no work to send):
        hand the slot back so the next ``allow()`` can probe instead of
        wedging half-open forever."""
        if self.state == HALF_OPEN:
            self._probe_inflight = False

    def record_success(self):
        if self.state == HALF_OPEN:
            self._probe_inflight = False
            self.consecutive_failures = 0
            self.cooldown_s = self.base_cooldown_s
            self._transition(CLOSED, "probe succeeded")
        elif self.state == CLOSED:
            self.consecutive_failures = 0
        # OPEN: ignore — stale success from pre-outage work.

    def record_failure(self, fatal: bool = False):
        self.failures += 1
        now = self._clock()
        if self.state == HALF_OPEN:
            self._probe_inflight = False
            self.cooldown_s = min(
                self.max_cooldown_s, self.cooldown_s * 2.0
            )
            self.opened_at = now
            self.opens += 1
            self._transition(OPEN, "probe failed")
            return
        if self.state == OPEN:
            self.opened_at = now  # keep the window anchored at last failure
            return
        self.consecutive_failures += 1
        if fatal or self.consecutive_failures >= self.threshold:
            self.opened_at = now
            self.opens += 1
            self._transition(
                OPEN, "fatal error" if fatal else "failure threshold"
            )


def jittered_backoff(
    attempt: int,
    base_s: float,
    max_s: float,
    rng: random.Random | None = None,
) -> float:
    """Full-jitter exponential backoff (attempt is 1-based): uniform in
    [0, min(max_s, base_s * 2^(attempt-1))]. Decorrelates retry storms
    when many writers lose the same connection at once."""
    cap = min(max_s, base_s * (2.0 ** max(0, attempt - 1)))
    r = rng.random() if rng is not None else random.random()
    return cap * r

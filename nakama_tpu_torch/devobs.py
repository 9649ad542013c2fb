"""Device telemetry plane: build-watch, kernel clocks, HBM ledger.

Port of the JAX package's `devobs.py`: the always-on layer under the
host spans. One instance per process (`DEVOBS`, the faults.PLANE /
tracing.TRACES precedent) — device calls happen on the interval loop
and on cohort worker threads, so the sink must be reachable without
threading an instance through each of them. Three instruments:

1. **Build-watch** — eager PyTorch compiles nothing per shape; what the
   port compiles is its hand-written kernels (`nvcc`, kernels.py) and
   its native library (`g++`, native/). Each build is counted and timed
   under the kernel it builds. Once the warmup window
   (`warmup_intervals` interval ticks) closes, a build inside a hot-path
   `device_call` is an "unexpected recompile": WARN + span event +
   `recompiles` count.

2. **Kernel clocks** — per-kernel stats (count, EMA, p50/p99 over a
   bounded ring) around each named device call, plus a bounded
   process-wide timeline of (kernel, ts, host ms, device ms) events the
   delivery ledger slices per cohort (`timeline_between`). The host
   wall time is the time the caller was held (launch cost, or the whole
   wait for a fetch). Where the call ran on the card, a pair of CUDA
   events brackets it on the stream, and the device time between them
   is added — but only once both events have COMPLETED (`Event.query()`):
   events are resolved lazily, at the next interval tick or by the
   cohort's worker thread after its fetch, and the plane never
   synchronises the device.

3. **HBM ledger** — ownership-tagged device-buffer accounting
   (`matchmaker.pool`, `matchmaker.dispatch`) set at alloc/restore and
   adjusted at dispatch/fetch, with a high-watermark, cross-checked
   against `torch.cuda.memory_stats()` where a card is present, plus
   h2d/d2h transfer counters per call site.

`describe_devices` lists the `torch` devices the process sees, for the
console's device view (the JAX package's `describe_mesh`; the port runs
on one card and describes no mesh).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from . import tracing as trace_api

# Kernel name used for builds that happen outside any device_call
# context (an explicit build step, test scaffolding): counted, never
# judged.
UNATTRIBUTED = "unattributed"


def _percentiles(vals) -> tuple[float, float]:
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return 0.0, 0.0
    return vals[n // 2], vals[min(n - 1, int(n * 0.99))]


class _KernelClock:
    """Per-named-kernel wall-time (and device-time) stats + build
    counters."""

    __slots__ = (
        "name", "calls", "total_s", "ema_s", "ring", "device_ring",
        "device_calls", "device_total_s",
        "compiles", "compile_total_s", "last_compile_s",
        "recompiles", "last_recompile_ts", "_time_child",
    )

    RING = 256
    EMA_ALPHA = 0.1

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.total_s = 0.0
        self.ema_s = 0.0
        self.ring: deque[float] = deque(maxlen=self.RING)
        self.device_ring: deque[float] = deque(maxlen=self.RING)
        self.device_calls = 0
        self.device_total_s = 0.0
        self.compiles = 0
        self.compile_total_s = 0.0
        self.last_compile_s = 0.0
        self.recompiles = 0
        self.last_recompile_ts = 0.0
        self._time_child = None  # cached labeled histogram child

    def record(self, dur_s: float) -> None:
        self.calls += 1
        self.total_s += dur_s
        self.ring.append(dur_s)
        # EMA seeded by the first sample so early reads aren't dragged
        # toward zero by the initializer.
        if self.calls == 1:
            self.ema_s = dur_s
        else:
            self.ema_s += self.EMA_ALPHA * (dur_s - self.ema_s)

    def record_device(self, dur_s: float) -> None:
        self.device_calls += 1
        self.device_total_s += dur_s
        self.device_ring.append(dur_s)

    def stats(self) -> dict:
        p50, p99 = _percentiles(self.ring)
        d50, d99 = _percentiles(self.device_ring)
        return {
            "kernel": self.name,
            "calls": self.calls,
            "p50_ms": round(p50 * 1000, 3),
            "p99_ms": round(p99 * 1000, 3),
            "ema_ms": round(self.ema_s * 1000, 3),
            "total_s": round(self.total_s, 3),
            "device_calls": self.device_calls,
            "device_p50_ms": round(d50 * 1000, 3),
            "device_p99_ms": round(d99 * 1000, 3),
            "device_total_s": round(self.device_total_s, 3),
            "compiles": self.compiles,
            "compile_total_s": round(self.compile_total_s, 3),
            "last_compile_s": round(self.last_compile_s, 3),
            "recompiles": self.recompiles,
        }


class _Call:
    """Context manager for one timed device call (allocation-light: the
    plane hands these out from `device_call`)."""

    __slots__ = ("plane", "kernel", "expect_compile", "device", "t0", "ev0")

    def __init__(self, plane, kernel, expect_compile, device):
        self.plane = plane
        self.kernel = kernel
        self.expect_compile = expect_compile
        self.device = device

    def __enter__(self):
        tls = self.plane._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        stack.append((self.kernel, self.expect_compile))
        self.ev0 = None
        if self.device is not None:
            import torch

            # Recorded on the caller's current stream, in order with
            # the work this call enqueues; read only once completed.
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        plane = self.plane
        plane._tls.stack.pop()
        ev1 = None
        if self.ev0 is not None:
            import torch

            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(torch.cuda.current_stream(self.device))
        clock = plane._kernels.get(self.kernel)
        if clock is None:
            clock = plane.register(self.kernel)
        # [kernel, wall ts, host ms, device ms (None until resolved)]
        event = [self.kernel, time.time(), round(dur * 1000, 3), None]
        with plane._lock:
            clock.record(dur)
            plane.timeline.append(event)
            if ev1 is not None:
                plane._pending.append((clock, event, self.ev0, ev1))
        child = clock._time_child
        if child is not None:
            try:
                child.observe(dur)
            except Exception:
                pass
        return False


class _NullCall:
    """Disarmed context: two attribute reads, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CALL = _NullCall()


class DeviceTelemetry:
    """The process-wide plane. Thread model: `device_call` runs on the
    interval loop and on cohort worker threads concurrently, so every
    read-modify-write on shared state — clock fields, transfer entries,
    the memory ledger, build bookkeeping, pending events — happens under
    `_lock`. Metrics publishes happen outside the lock."""

    DEFAULTS = {
        "enabled": True,
        "warmup_intervals": 3,
        "timeline_depth": 256,
    }

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.metrics = None
        self.logger = None
        self._apply_defaults()

    def _apply_defaults(self, overrides: dict | None = None) -> None:
        cfg = {**self.DEFAULTS, **(overrides or {})}
        self.enabled = bool(cfg["enabled"])
        self.warmup_intervals = max(0, int(cfg["warmup_intervals"]))
        self.timeline_depth = max(16, int(cfg["timeline_depth"]))
        self._kernels: dict[str, _KernelClock] = {}
        self.timeline: deque[list] = deque(maxlen=self.timeline_depth)
        # (clock, timeline event, start event, end event) awaiting
        # completion on the card.
        self._pending: list[tuple] = []
        self.intervals_seen = 0
        self.warmed = self.warmup_intervals == 0
        # HBM ledger: owner -> bytes, plus the total high-watermark.
        self._memory: dict[str, int] = {}
        self.memory_high_water = 0
        # (site, direction) -> [count, bytes]
        self._transfers: dict[tuple[str, str], list[int]] = {}
        self.compiles_total = 0
        self.recompiles_total = 0

    def configure(
        self,
        *,
        enabled: bool | None = None,
        warmup_intervals: int | None = None,
        timeline_depth: int | None = None,
        metrics=None,
        logger=None,
    ) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if warmup_intervals is not None:
                self.warmup_intervals = max(0, int(warmup_intervals))
                self.warmed = (
                    self.intervals_seen >= self.warmup_intervals
                )
            if timeline_depth is not None and (
                int(timeline_depth) != self.timeline_depth
            ):
                self.timeline_depth = max(16, int(timeline_depth))
                self.timeline = deque(
                    self.timeline, maxlen=self.timeline_depth
                )
            if metrics is not None:
                self.metrics = metrics
                for clock in self._kernels.values():
                    self._bind_clock_metric(clock)
            if logger is not None:
                self.logger = logger

    def reset(self) -> None:
        """Drop all state AND restore default config: the plane is
        process-global, so a reset keeping a previous caller's warmup
        posture would couple test outcomes to suite order."""
        with self._lock:
            self.metrics = None
            self.logger = None
            self._apply_defaults()

    # ----------------------------------------------------------- build-watch

    def _bind_clock_metric(self, clock: _KernelClock) -> None:
        try:
            clock._time_child = self.metrics.device_kernel_time.labels(
                kernel=clock.name
            )
        except Exception:
            clock._time_child = None

    def register(self, kernel: str) -> _KernelClock:
        """Register a named device entry point (idempotent)."""
        clock = self._kernels.get(kernel)
        if clock is None:
            with self._lock:
                clock = self._kernels.get(kernel)
                if clock is None:
                    clock = _KernelClock(kernel)
                    if self.metrics is not None:
                        self._bind_clock_metric(clock)
                    self._kernels[kernel] = clock
        return clock

    def device_call(
        self, kernel: str, expect_compile: bool = False, device=None
    ):
        """Context manager timing one device call under `kernel`. With a
        CUDA `device`, CUDA events bracket the call on the current
        stream and its device time is added once they complete. Disarmed
        cost is one attribute read + a constant return."""
        if not self.enabled:
            return _NULL_CALL
        if device is not None and getattr(device, "type", None) != "cuda":
            device = None
        return _Call(self, kernel, expect_compile, device)

    def on_compile(self, duration_s: float, kernel: str | None = None) -> None:
        """One build (nvcc/g++) completed on this thread, of `kernel`.
        It is unexpected when it ran after warmup inside a hot-path
        `device_call` that did not expect it; a build outside any
        device_call (an explicit build step) is always expected."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            active, expected = stack[-1]
        else:
            active, expected = UNATTRIBUTED, True
        if kernel is None:
            kernel = active
        clock = self._kernels.get(kernel)
        if clock is None:
            clock = self.register(kernel)
        with self._lock:
            clock.compiles += 1
            clock.compile_total_s += duration_s
            clock.last_compile_s = duration_s
            self.compiles_total += 1
            unexpected = (
                self.warmed and not expected and active != UNATTRIBUTED
            )
            if unexpected:
                clock.recompiles += 1
                clock.last_recompile_ts = time.time()
                self.recompiles_total += 1
        if unexpected:
            trace_api.add_event(
                "device.recompile",
                kernel=kernel,
                duration_ms=round(duration_s * 1000, 1),
            )
            if self.logger is not None:
                try:
                    self.logger.warn(
                        "unexpected kernel build after warmup —"
                        " a build landed on the hot path",
                        kernel=kernel,
                        duration_ms=round(duration_s * 1000, 1),
                        intervals_seen=self.intervals_seen,
                    )
                except Exception:
                    pass

    def interval_tick(self) -> None:
        """One processing interval elapsed (matchmaker process_slots):
        resolves the device times of completed calls and closes the
        warmup window after `warmup_intervals` ticks."""
        self.resolve()
        self.intervals_seen += 1
        if not self.warmed and self.intervals_seen >= self.warmup_intervals:
            self.warmed = True

    # --------------------------------------------------------- kernel clocks

    def resolve(self) -> int:
        """Fold in the device time of every pending call whose end event
        has completed on the card; calls still running stay pending.
        Never blocks: `Event.query()` only asks. Returns the number
        resolved."""
        with self._lock:
            pending, self._pending = self._pending, []
        done = []
        keep = []
        for item in pending:
            _, _, ev0, ev1 = item
            if ev1.query() and ev0.query():
                done.append((item, ev0.elapsed_time(ev1)))
            else:
                keep.append(item)
        with self._lock:
            self._pending = keep + self._pending
            for (clock, event, _, _), ms in done:
                clock.record_device(ms / 1000.0)
                event[3] = round(ms, 3)
        return len(done)

    # ----------------------------------------------------------- HBM ledger

    def _apply_mem_locked(self, owner: str, nbytes: int) -> int:
        """Write one ledger row (caller holds `_lock`); returns the
        clamped value for the gauge publish."""
        if nbytes <= 0:
            self._memory.pop(owner, None)
            nbytes = 0
        else:
            self._memory[owner] = int(nbytes)
        total = sum(self._memory.values())
        if total > self.memory_high_water:
            self.memory_high_water = total
        return nbytes

    def _publish_mem(self, owner: str, nbytes: int) -> None:
        m = self.metrics
        if m is not None:
            try:
                m.device_memory.labels(owner=owner).set(nbytes)
                m.device_memory_high_water.set(self.memory_high_water)
            except Exception:
                pass

    def mem_set(self, owner: str, nbytes: int) -> None:
        """Absolute device-resident bytes held by `owner` (alloc /
        resize / restore all land here; 0 frees the row)."""
        if not self.enabled:
            return
        with self._lock:
            value = self._apply_mem_locked(owner, int(nbytes))
        self._publish_mem(owner, value)

    def mem_add(self, owner: str, delta: int) -> None:
        """Relative adjustment (transient dispatch buffers: + at
        launch, − when the fetch releases them), read-modify-write
        under one lock acquisition."""
        if not self.enabled or not delta:
            return
        with self._lock:
            value = self._apply_mem_locked(
                owner, self._memory.get(owner, 0) + int(delta)
            )
        self._publish_mem(owner, value)

    def transfer(self, site: str, direction: str, nbytes: int) -> None:
        """One host↔device transfer at a named call site; direction is
        "h2d" or "d2h"."""
        if not self.enabled:
            return
        with self._lock:
            entry = self._transfers.setdefault((site, direction), [0, 0])
            entry[0] += 1
            entry[1] += int(nbytes)
        m = self.metrics
        if m is not None:
            try:
                m.device_transfers.labels(
                    site=site, direction=direction
                ).inc()
                m.device_transfer_bytes.labels(
                    site=site, direction=direction
                ).inc(max(0, int(nbytes)))
            except Exception:
                pass

    @staticmethod
    def backend_memory_stats() -> dict | None:
        """The allocator's own view (`torch.cuda.memory_stats`) per card,
        where a card is present (None on CPU-only hosts) — the
        cross-check against the ownership ledger."""
        try:
            import torch

            if not torch.cuda.is_available():
                return None
            out = {}
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                if stats:
                    out[str(i)] = {
                        k: v for k, v in stats.items()
                        if k in (
                            "allocated_bytes.all.current",
                            "allocated_bytes.all.peak",
                            "reserved_bytes.all.current",
                            "reserved_bytes.all.peak",
                            "num_alloc_retries",
                            "num_ooms",
                        )
                    }
            return out or None
        except Exception:
            return None

    # ---------------------------------------------------------------- reads

    def timeline_between(
        self, t0: float, t1: float, limit: int = 64
    ) -> list[dict]:
        """Kernel events whose wall timestamp falls in [t0, t1] — how a
        delivery-ledger entry gets its device phase chain. `device_ms`
        is None for a call whose events have not completed yet (or that
        ran on the host)."""
        out = []
        for kernel, ts, dur_ms, dev_ms in list(self.timeline):
            if t0 <= ts <= t1:
                out.append(
                    {"kernel": kernel, "ts": ts, "ms": dur_ms,
                     "device_ms": dev_ms}
                )
                if len(out) >= limit:
                    break
        return out

    def recent_timeline(self, n: int = 64) -> list[dict]:
        """The newest `n` kernel events (the console's device view)."""
        return [
            {"kernel": k, "ts": ts, "ms": ms, "device_ms": dev_ms}
            for k, ts, ms, dev_ms in list(self.timeline)[-n:]
        ]

    def memory_by_owner(self) -> dict[str, int]:
        with self._lock:
            return dict(self._memory)

    def kernel_stats(self) -> list[dict]:
        with self._lock:  # registers mutate the dict from any thread
            clocks = sorted(self._kernels.items())
        return [clock.stats() for _, clock in clocks]

    def stats(self) -> dict:
        mem = self.memory_by_owner()
        with self._lock:
            transfer_rows = sorted(
                (k, list(v)) for k, v in self._transfers.items()
            )
            pending = len(self._pending)
        transfers = [
            {
                "site": site,
                "direction": direction,
                "count": entry[0],
                "bytes": entry[1],
            }
            for (site, direction), entry in transfer_rows
        ]
        return {
            "enabled": self.enabled,
            "warmup": {
                "intervals_seen": self.intervals_seen,
                "warmup_intervals": self.warmup_intervals,
                "warmed": self.warmed,
            },
            "kernels": self.kernel_stats(),
            "pending_device_events": pending,
            "compiles": {
                "total": self.compiles_total,
                "recompiles_total": self.recompiles_total,
            },
            "memory": {
                "by_owner": mem,
                "total_bytes": sum(mem.values()),
                "high_water_bytes": self.memory_high_water,
                "backend": self.backend_memory_stats(),
            },
            "transfers": transfers,
        }

    # ------------------------------------------------------- console report

    def report_lines(self) -> list[str]:
        """The plain-text device report."""
        s = self.stats()
        lines = ["device telemetry:"]
        lines.append(
            f"  warmup: {s['warmup']['intervals_seen']} intervals seen,"
            f" warmed={s['warmup']['warmed']}"
        )
        lines.append(
            "  kernel                     calls   p50ms   p99ms   emams"
            "  dev_p50ms  compiles  recompiles"
        )
        for k in s["kernels"]:
            lines.append(
                f"  {k['kernel']:<26} {k['calls']:>5}"
                f" {k['p50_ms']:>7.2f} {k['p99_ms']:>7.2f}"
                f" {k['ema_ms']:>7.2f} {k['device_p50_ms']:>10.2f}"
                f" {k['compiles']:>9} {k['recompiles']:>11}"
            )
        mem = s["memory"]
        lines.append(
            f"  memory: total={mem['total_bytes']:,}B"
            f" high_water={mem['high_water_bytes']:,}B"
        )
        for owner, nbytes in sorted(mem["by_owner"].items()):
            lines.append(f"    {owner:<24} {nbytes:>14,}B")
        for t in s["transfers"]:
            lines.append(
                f"  transfer {t['site']:<24} {t['direction']}"
                f" n={t['count']} bytes={t['bytes']:,}"
            )
        return lines


# The process-wide plane (faults.PLANE precedent): configured from
# config.devobs (`DevObsConfig`); tests reset/configure it directly.
DEVOBS = DeviceTelemetry()


def describe_devices() -> dict:
    """The CUDA devices the process sees (index, name, memory), for the
    console's device view; `mesh` is None (the port shards nothing).
    Never raises; a host without a card reports `devices: []`."""
    devices = []
    try:
        import torch

        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                devices.append(
                    {"index": i, "name": props.name,
                     "memory_bytes": int(props.total_memory)}
                )
    except Exception:
        devices = []
    return {"devices": devices, "mesh": None}

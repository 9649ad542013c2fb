"""LocalMatchmaker: ticket pool bookkeeping + interval processing.

Port of the JAX package's `matchmaker/local.py`. Capability parity with
the reference Matchmaker interface and LocalMatchmaker
(reference server/matchmaker.go:169-1068): add/remove/extract/insert with
per-session and per-party MaxTickets enforcement, pause/resume/stop, and a
per-interval `process()` that forms matches and reports them to a callback.

Host bookkeeping is slot-centric (store.py): ticket state lives in
numpy arrays + native hash maps indexed by pool slot, so the interval
path — interval bumping, expiry, matched-ticket unregistration, match
delivery — is O(batch) numpy/native calls, never per-entry Python.
Delivery hands `on_matched` a columnar `MatchBatch`; consumers that need
entry objects materialize them lazily.

The process backend is pluggable: the CPU oracle (`process.py`, via
`CpuBackend`) or the device backend (`cuda.py`). Custom (runtime-override)
processing always runs the host path since it enumerates combinatorial
candidates for user code.

Async production use: `start()` spawns an asyncio interval task; tests call
`process()` directly with the ticker off, mirroring the reference's
NewLocalBenchMatchmaker (server/matchmaker_test.go:1697).
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Callable, Protocol

import numpy as np

from .. import faults, overload
from .. import tracing as trace_api
from ..config import MatchmakerConfig
from ..logger import Logger
from .process import process_custom, process_default
from .query import QueryError, parse_query
from .store import SlotStore
from .types import (
    MatchBatch,
    MatchmakerEntry,
    MatchmakerExtract,
    MatchmakerPresence,
    MatchmakerTicket,
)


class MatchmakerError(Exception):
    pass


class ErrTooManyTickets(MatchmakerError):
    pass


class ErrQueryInvalid(MatchmakerError):
    pass


class ErrDuplicateSession(MatchmakerError):
    pass


class ErrNotAvailable(MatchmakerError):
    pass


class PartialPublish(Exception):
    """Raised by an `on_matched` handler that delivered SOME cohorts
    but had to hold others (cluster: a cohort's origin node is down).
    `failed_tickets` names every ticket of every HELD cohort — those
    journal `unpublished` (a restart re-pools them) while the delivered
    cohorts journal `matched` as usual. Holding must be all-or-nothing
    per cohort: a partially-listed cohort would re-pool some of its
    tickets after a restart while its other members already saw the
    match."""

    def __init__(self, failed_tickets, reason: str = ""):
        super().__init__(
            reason or f"{len(failed_tickets)} cohort ticket(s) held"
        )
        self.failed_tickets = frozenset(failed_tickets)


MatchedCallback = Callable[[MatchBatch], None]
OverrideFn = Callable[
    [list[list[MatchmakerEntry]]], list[list[MatchmakerEntry]]
]


class ProcessBackend(Protocol):
    def attach(self, store: SlotStore) -> None:
        """Bind the shared slot store before any other call."""

    def on_add(self, ticket: MatchmakerTicket, slot: int) -> None:
        """Called after the ticket is slot-registered; may raise to reject
        it (the caller rolls the registration back)."""

    def on_remove_slots(self, slots: np.ndarray) -> None:
        """Called when tickets leave the pool, BEFORE the store clears
        their slots."""

    def process_slots(
        self,
        active_slots: np.ndarray,
        last_interval: np.ndarray,
        *,
        max_intervals: int,
        rev_precision: bool,
    ) -> tuple[MatchBatch, np.ndarray, np.ndarray]:
        """Returns (batch, matched_slots, reactivate_slots).

        `reactivate_slots` covers tickets whose pipelined match was
        invalidated after they already went inactive — they get another
        active interval so churn can't strand them passively matchable
        forever."""
        ...


class CpuBackend:
    """The oracle backend — exact reference semantics on host objects."""

    def __init__(self):
        self.store: SlotStore | None = None

    def attach(self, store: SlotStore):
        self.store = store

    def on_add(self, ticket: MatchmakerTicket, slot: int) -> None:
        pass

    def on_remove_slots(self, slots: np.ndarray) -> None:
        pass

    def process_slots(
        self, active_slots, last_interval, *, max_intervals, rev_precision
    ):
        store = self.store
        actives, _, pool = store.oracle_view(active_slots)
        matched = process_default(
            actives,
            pool,
            max_intervals=max_intervals,
            rev_precision=rev_precision,
        )
        batch, slots = lists_to_batch(matched, store)
        return batch, slots, np.zeros(0, dtype=np.int32)


def lists_to_batch(
    matched: list[list[MatchmakerEntry]], store: SlotStore
) -> tuple[MatchBatch, np.ndarray]:
    """Wrap object-path match lists (oracle / override) as a MatchBatch +
    the flat matched slot array for bulk removal."""
    batch = MatchBatch.from_lists(matched)
    slot_parts: list[int] = []
    for entry_set in matched:
        for tid in dict.fromkeys(e.ticket for e in entry_set):
            slot = store.slot_by_id(tid)
            if slot is not None:
                slot_parts.append(slot)
    return batch, np.asarray(slot_parts, dtype=np.int32)


def _select_backend(config: MatchmakerConfig, logger, metrics):
    """config.backend: "cuda" → CudaBackend on cuda:0 (raises without a
    CUDA device — the port never falls back to the oracle quietly);
    "cpu" → the exact oracle."""
    if config.backend == "cpu":
        return CpuBackend()
    if config.backend != "cuda":
        raise ValueError(
            f"matchmaker backend {config.backend!r}: expected 'cuda' or 'cpu'"
        )
    from .cuda import CudaBackend

    return CudaBackend(config, logger, metrics)


class LocalMatchmaker:
    def __init__(
        self,
        logger: Logger,
        config: MatchmakerConfig,
        metrics=None,
        node: str = "local",
        backend: ProcessBackend | None = None,
        on_matched: MatchedCallback | None = None,
    ):
        self.logger = logger.with_fields(subsystem="matchmaker")
        self.config = config
        self.metrics = metrics
        self.node = node
        self.store = SlotStore(config.pool_capacity, config.max_party_size)
        self.backend = backend or _select_backend(config, self.logger, metrics)
        self.backend.attach(self.store)
        self.on_matched = on_matched
        self.override_fn: OverrideFn | None = None

        self._paused = False
        self._stopped = False
        # Request-scoped tracing: tickets added inside an active trace
        # hold that trace open (tail sampling defers until the ticket
        # resolves) so the cohort's dispatch→ready→collected→published
        # stages land in the SAME trace as the socket envelope that
        # created the ticket. Values carry the ticket's SLOT so the
        # interval sweep is O(held tickets), never O(matched slots).
        # Bounded: oldest holds release at the cap; expiry releases on
        # deactivation (a later passive match is not appended).
        self._ticket_traces: dict[str, tuple[str, str, int]] = {}
        # SLO plane (tracing.SloRecorder, bound by the server): interval
        # wall time and publish lag observations feed the burn gauges.
        self.slo = None
        # Crash-recovery plane (recovery.py, bound by the server's
        # RecoveryPlane): the durable ticket journal — every add /
        # remove / matched outcome appended (lazy payloads, drained
        # through the group-commit write pipeline) — and the idle-gap
        # checkpointer. None = journaling off (tests/bench default).
        self.journal = None
        self.checkpointer = None
        self._task: asyncio.Task | None = None
        # Event-driven delivery stage (start() spawns it alongside the
        # interval task): cohort worker threads set this event via
        # call_soon_threadsafe the moment assembly finishes, and the
        # delivery task runs accept → finalize → publish immediately —
        # no gap poll between a cohort being ready and players seeing
        # the match.
        self._delivery_task: asyncio.Task | None = None
        self._delivery_wakeup: asyncio.Event | None = None
        # The error a loop task ended on (None while healthy).
        self.error: BaseException | None = None

    # ------------------------------------------------------------- lifecycle

    def pause(self):
        self._paused = True

    def resume(self):
        self._paused = False

    def stop(self):
        """Stop both loop tasks and join the backend's worker threads.
        Raises the error a loop task ended on, if any."""
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._delivery_task is not None:
            self._delivery_task.cancel()
            self._delivery_task = None
        set_cb = getattr(self.backend, "set_ready_callback", None)
        if set_cb is not None:
            # Unhook the wakeup before the loop closes: a cohort
            # finishing during shutdown must not signal a dead loop.
            set_cb(None)
        wait_idle = getattr(self.backend, "wait_idle", None)
        if wait_idle is not None:
            # No fetch/assembly worker thread outlives the matchmaker.
            wait_idle(timeout=5.0)
        if self.error is not None:
            raise self.error

    def start(self):
        """Spawn the per-interval processing task (reference
        matchmaker.go:250-260) AND the event-driven delivery stage: the
        interval task owns dispatch + gap maintenance; the delivery
        task wakes on cohort-completion signals from the backend's
        worker threads and ships accept → finalize → publish the
        moment a cohort is ready (deadline-guard and watchdog timed
        fallbacks cover lost signals and wedged heads)."""

        async def _loop():
            import gc

            # The gap pass below owns full collections; an AUTOMATIC
            # gen2 pass over this server's steady heap (~100k ticket
            # objects plus runtime state) measures 100-650ms and lands
            # mid-interval whenever allocation counters happen to cross
            # the default threshold there. Push the gen2 trigger out of
            # reach — every gap still runs an explicit full collect, so
            # cyclic garbage is bounded by one interval's churn.
            g0, g1, g2_saved = gc.get_threshold()
            gc.set_threshold(g0, g1, 1_000_000)
            try:
                await _loop_body()
            finally:
                # Process-global state: hand automatic gen2 collection
                # back when this matchmaker stops — without the gap
                # collector running, the rest of the process must not be
                # left with full collections effectively disabled.
                gc.set_threshold(g0, g1, g2_saved)

        async def _loop_body():
            import gc

            shed_streak = 0
            while not self._stopped:
                t0 = time.perf_counter()
                interval_end = t0 + self.config.interval_sec
                # Split the configured interval (cadence stays exactly
                # interval_sec): a short head-gap after process() lets a
                # pipelined device pass + D2H clear, then the GC pass
                # collects the interval's object churn (~2 objects per
                # matched entry) at a chosen point in the idle gap instead
                # of a generational pass landing mid-interval (measured
                # 1-2s pauses at 100k churn). The store graveyard (matched
                # ticket objects parked at removal) drains here too, so
                # the refcount cascade of ~100k objects is idle-gap work.
                gap = min(2.0, self.config.interval_sec / 4)
                await asyncio.sleep(gap)
                if self._stopped:
                    break
                # Backpressure: while an unfinished cohort needs the host
                # (slow D2H fetch, heap-contended assembly), the gap work
                # is SHED for this gap — GC/drain/flush are deferrable
                # optimizations, delivery is not, and on a small host
                # they queue the cohort's worker thread behind seconds of
                # main-thread work. The streak cap keeps a permanently
                # slow pipeline from starving heap maintenance forever.
                backlogged = getattr(
                    self.backend, "pipeline_backlogged", None
                )
                if (
                    backlogged is not None
                    and backlogged()
                    and shed_streak < 2
                ):
                    shed_streak += 1
                    if self.metrics is not None:
                        self.metrics.mm_gap_shed.inc()
                else:
                    shed_streak = 0
                    # Preemptible: stop the teardown pass early rather
                    # than queue a due cohort delivery behind it. The
                    # budget is floored at 200ms forward — when the head
                    # cohort is already past its guard point (chronically
                    # slow pipeline, forced maintenance gap) the drain
                    # must still make progress, or the graveyard grows
                    # until the allocator pays the full teardown inline
                    # on the add path.
                    deadline = self._next_cohort_deadline()
                    self.store.drain(
                        None
                        if deadline is None
                        else max(
                            time.perf_counter() + 0.2,
                            deadline
                            - self.config.pipeline_deadline_guard_sec,
                        )
                    )
                    gc.collect()
                    # Idle-gap flush: push ticket rows staged so far so
                    # the interval's own flush handles only the adds that
                    # arrive during the remaining sleep (eager 2048-row
                    # chunking already streams the bulk as adds come in).
                    # A failing copy to the card propagates like any
                    # other device error.
                    flush = getattr(
                        getattr(self.backend, "pool", None), "flush", None
                    )
                    if flush is not None:
                        flush()
                    if (
                        self.checkpointer is not None
                        and self.checkpointer.due()
                    ):
                        # Crash-recovery checkpoint rides the same idle
                        # gap as GC/drain/flush: pool snapshot + journal
                        # truncation, bounded replay for the next boot.
                        # A storage failure is survivable (WARNed
                        # inside) and never kills the interval loop; an
                        # error from the card ends the service like any
                        # other device error (faults.from_card).
                        try:
                            await self.checkpointer.maybe_checkpoint(
                                self
                            )
                        except Exception as e:
                            if faults.from_card(e):
                                raise
                            self.logger.error(
                                "checkpoint error", error=str(e)
                            )
                # Delivery is NOT this loop's job: the dedicated
                # delivery stage (spawned alongside, below) wakes on the
                # cohort-completion event the worker thread fires and
                # runs accept → finalize → publish the moment a cohort
                # is ready — the interval loop keeps only dispatch and
                # maintenance, so a cohort ready 80ms after dispatch no
                # longer waits out a gap poll schedule.
                # Same small epsilon the pre-event gap poll ended on:
                # process() fires just BEFORE the nominal boundary, so
                # callers pacing adds on whole intervals enqueue for the
                # NEXT dispatch instead of racing this one.
                await asyncio.sleep(
                    max(0.0, interval_end - 0.02 - time.perf_counter())
                )
                if self._stopped:
                    break
                if not self._paused:
                    # No catch: the backend absorbs the failures its
                    # ladder may serve, and anything else is a bug that
                    # ends the service (`_on_task_done`, `stop`).
                    self.process()

        async def _delivery_loop():
            # The delivery stage: waits for a cohort-completion wakeup
            # (worker thread → call_soon_threadsafe), with two timed
            # fallbacks — the head cohort's deadline-guard point (ship a
            # near-deadline cohort via a bounded join even if its signal
            # was lost) and a slow watchdog poll (belt-and-braces drain
            # for lost wakeups / signal-less backends, NOT the delivery
            # latency). Runs on the event loop, so accept/finalize/
            # publish serialize with process() — the in-flight mask and
            # sel-scratch invariants need no new locking.
            guard = max(
                0.1, float(self.config.pipeline_deadline_guard_sec)
            )
            watchdog = max(
                0.05,
                float(getattr(self.config, "delivery_watchdog_sec", 1.0)),
            )
            wakeup = self._delivery_wakeup
            guard_joined = None  # head token already guard-joined once
            while not self._stopped:
                deadline = self._next_cohort_deadline()
                now = time.perf_counter()
                if deadline is None or deadline - guard <= now:
                    # Nothing due (or the head is already at/past its
                    # guard point and was handled below): event or
                    # watchdog.
                    timeout = watchdog
                else:
                    timeout = min(watchdog, deadline - guard - now)
                cause = "watchdog"
                try:
                    await asyncio.wait_for(wakeup.wait(), timeout)
                    cause = "event"
                except asyncio.TimeoutError:
                    if (
                        deadline is not None
                        and time.perf_counter() >= deadline - guard
                    ):
                        cause = "deadline"
                wakeup.clear()
                if self._stopped:
                    break
                if self._paused:
                    continue
                deadline = self._next_cohort_deadline()
                now = time.perf_counter()
                if deadline is not None and now >= deadline - guard:
                    token = getattr(
                        self.backend, "head_token", lambda: None
                    )()
                    ready = getattr(
                        self.backend, "head_ready", lambda: True
                    )()
                    join = getattr(self.backend, "join_head", None)
                    if (
                        join is not None
                        and not ready
                        and token is not None
                        and token != guard_joined
                    ):
                        # Bounded join in a worker thread (the event
                        # loop stays responsive; the cohort's
                        # assembly gets the core) — ONCE per head:
                        # join_head itself refuses to block past the
                        # head's own interval, and a head that
                        # failed its one guard join is wedged —
                        # booked to the reclaim path below, never
                        # re-joined into the next cycle.
                        guard_joined = token
                        await asyncio.to_thread(
                            join,
                            max(
                                deadline + guard,
                                time.perf_counter() + 0.25,
                            ),
                        )
                    if time.perf_counter() > deadline:
                        reclaim = getattr(
                            self.backend, "reclaim_stale", None
                        )
                        if reclaim is not None:
                            reclaim()
                if self.metrics is not None:
                    self.metrics.mm_delivery_wakeups.labels(
                        cause=cause
                    ).inc()
                self.collect_pipelined()

        loop = asyncio.get_running_loop()
        self._delivery_wakeup = asyncio.Event()
        set_cb = getattr(self.backend, "set_ready_callback", None)
        if set_cb is not None:
            wakeup = self._delivery_wakeup

            def _signal():
                # Worker thread → event loop: the only thread-safe way
                # to poke an asyncio.Event. A loop already closed
                # (shutdown race) just drops the signal — stop()'s
                # wait_idle covers the tail.
                try:
                    loop.call_soon_threadsafe(wakeup.set)
                except RuntimeError:
                    pass

            set_cb(_signal)
        self._task = loop.create_task(_loop())
        self._delivery_task = loop.create_task(_delivery_loop())
        for task in (self._task, self._delivery_task):
            task.add_done_callback(self._on_task_done)

    def _on_task_done(self, task: asyncio.Task):
        """A loop task that ended on an error (a bug: the backend
        absorbs what its ladder may serve) ends the service: the other
        task stops, adds are refused, and `stop()` re-raises it."""
        if task.cancelled() or task.exception() is None:
            return
        if self.error is None:
            self.error = task.exception()
            self.logger.error(
                "matchmaker service failed", error=repr(self.error)
            )
        self._stopped = True
        if self._delivery_wakeup is not None:
            self._delivery_wakeup.set()

    # ------------------------------------------------------------------ add

    def add(
        self,
        presences: list[MatchmakerPresence],
        session_id: str,
        party_id: str,
        query: str,
        min_count: int,
        max_count: int,
        count_multiple: int = 1,
        string_properties: dict[str, str] | None = None,
        numeric_properties: dict[str, float] | None = None,
        embedding=None,
        ticket_id: str | None = None,
        created_at: float | None = None,
    ) -> tuple[str, float]:
        """Submit a ticket. Returns (ticket id, created_at seconds).

        `ticket_id`/`created_at` are normally minted here; the cluster
        ingest (cluster/matchmaker.py) passes the origin frontend's
        pre-minted node-stamped id and wall clock so cross-node tickets
        keep their identity and age through the pool, journal and
        checkpoints.

        Reference Add: server/matchmaker.go:443-566."""
        if self._stopped:
            raise ErrNotAvailable("matchmaker stopped")
        # Deadline propagation (overload.py): a caller whose deadline
        # already passed gets DEADLINE_EXCEEDED before the ticket is
        # registered — registering it would be dead work the client has
        # already given up on (their retry re-adds it).
        dl = overload.current_deadline()
        if dl is not None and dl.expired():
            if self.metrics is not None:
                self.metrics.request_deadline_exceeded.labels(
                    stage="matchmaker"
                ).inc()
            raise overload.DeadlineExceeded(
                "caller deadline expired before matchmaker add"
            )
        if not presences:
            raise MatchmakerError("at least one presence required")
        if count_multiple < 1:
            raise MatchmakerError("count_multiple must be >= 1")
        if min_count < 1 or max_count < min_count:
            raise MatchmakerError("invalid min/max counts")
        if len(presences) > max_count:
            raise MatchmakerError("more presences than max_count")
        try:
            parsed = parse_query(query)
        except QueryError as e:
            raise ErrQueryInvalid(str(e)) from e

        session_ids: set[str] = set()
        for p in presences:
            if p.session_id in session_ids:
                raise ErrDuplicateSession(p.session_id)
            session_ids.add(p.session_id)

        if ticket_id is None:
            ticket_id = str(uuid.uuid4())
        elif self.store.get(ticket_id) is not None:
            # Re-delivered cluster forward: the id is already live. The
            # duplicate check MUST precede the MaxTickets enforcement —
            # a ticket re-forwarded during an owner takeover (frontend
            # closing the replication-lag window) is already counted in
            # this pool's quota, and judging it over-quota here would
            # reject-back a live ticket instead of absorbing the
            # idempotent re-delivery.
            raise KeyError(ticket_id)

        max_tickets = self.config.max_tickets
        for p in presences:
            if self.store.session_ticket_count(p.session_id) >= max_tickets:
                raise ErrTooManyTickets(p.session_id)
        if (
            party_id
            and self.store.party_ticket_count(party_id) >= max_tickets
        ):
            raise ErrTooManyTickets(party_id)
        if created_at is None:
            created_at = time.time()
        string_properties = string_properties or {}
        numeric_properties = numeric_properties or {}
        entries = [
            MatchmakerEntry(
                ticket=ticket_id,
                presence=p,
                string_properties=string_properties,
                numeric_properties=numeric_properties,
                party_id=party_id,
                create_time=created_at,
            )
            for p in presences
        ]
        ticket = MatchmakerTicket(
            ticket=ticket_id,
            query=query,
            min_count=min_count,
            max_count=max_count,
            count_multiple=count_multiple,
            session_id=session_id,
            party_id=party_id,
            entries=entries,
            string_properties=string_properties,
            numeric_properties=numeric_properties,
            created_at=created_at,
            parsed_query=parsed,
            embedding=embedding,
        )
        self._register(ticket)
        if self.journal is not None:
            self.journal.record_add(ticket)
        sp = trace_api.current_span()
        if sp is not None:
            slot = self.store.slot_by_id(ticket_id)
            # The add as a real span in the caller's trace, plus a hold
            # so the trace stays open until the ticket matches (or is
            # removed) — the add→matched story reads off one trace id.
            trace_api.emit_span(
                sp.trace_id, sp.span_id, "matchmaker.add",
                start_ts=created_at, end_ts=time.time(),
                ticket=ticket_id, query=query,
                min_count=min_count, max_count=max_count,
            )
            if slot is not None:
                self._hold_ticket_trace(ticket_id, sp, slot)
            self.logger.debug(
                "matchmaker ticket added", ticket=ticket_id
            )
        return ticket_id, created_at

    def _hold_ticket_trace(self, ticket_id: str, sp, slot: int) -> None:
        trace_api.TRACES.hold(sp.trace_id)
        self._ticket_traces[ticket_id] = (sp.trace_id, sp.span_id, slot)
        while len(self._ticket_traces) > 4096:
            # Bounded holds: a flood of traced adds that never resolve
            # must not pin traces forever — oldest release unfinished.
            old_id = next(iter(self._ticket_traces))
            old_trace = self._ticket_traces.pop(old_id)[0]
            trace_api.TRACES.release(old_trace)

    def _release_ticket_trace(self, ticket_id: str) -> None:
        ctx = self._ticket_traces.pop(ticket_id, None)
        if ctx is not None:
            trace_api.TRACES.release(ctx[0])

    def trace_context(self, ticket_id: str) -> tuple[str, str] | None:
        """(trace_id, span_id) of a held traced ticket, or None — the
        cluster publish-back stamps outbound route frames with it so
        the delivery hop joins the ticket's own trace."""
        ctx = self._ticket_traces.get(ticket_id)
        if ctx is None:
            return None
        return ctx[0], ctx[1]

    def _finish_ticket_traces(self, matched_slots, tracing) -> None:
        """Resolve held ticket traces after an interval/collect pass:
        matched tickets get the cohort stage spans (attributed to THEIR
        cohort's ledger entry via backend._accepted_cohorts) and their
        hold released; tickets parked inactive with no cohort in flight
        (expired unmatched) release too — their trace completes with
        just the add, and a later PASSIVE match is not appended (the
        bounded store cannot hold traces for tickets that may linger
        pooled indefinitely). O(held tickets) python plus O(matched)
        numpy mask writes; O(1) when no traced tickets exist (the
        bench path pays one dict bool check)."""
        if not self._ticket_traces:
            return
        cap = len(self.store.ticket_at)
        matched_mask = np.zeros(cap, dtype=bool)
        if matched_slots is not None and len(matched_slots):
            matched_mask[matched_slots] = True
        # slot → accepted-cohort index (numpy fancy-assign, C speed):
        # when one collect accepted SEVERAL cohorts, each matched slot
        # maps to ITS cohort's ledger entry — a ticket must not wear
        # another cohort's stage chain.
        cohorts = list(getattr(self.backend, "_accepted_cohorts", ()))
        cohort_of = None
        if cohorts:
            cohort_of = np.full(cap, -1, dtype=np.int32)
            for i, (_, slots_arr) in enumerate(cohorts):
                cohort_of[slots_arr] = i
        default_entry = None
        if tracing is not None and len(tracing.deliveries):
            default_entry = tracing.deliveries[-1]
        ticket_at = self.store.ticket_at
        active = self.store.active
        inflight = getattr(self.backend, "_in_flight_mask", None)
        for tid, (trace_id, span_id, slot) in list(
            self._ticket_traces.items()
        ):
            t = ticket_at[slot]
            if t is None or t.ticket != tid:
                # Slot already drained/reassigned under this entry (a
                # path that bypassed the release hooks): close it out
                # rather than pin the trace forever.
                del self._ticket_traces[tid]
                trace_api.TRACES.release(trace_id)
                continue
            if matched_mask[slot]:
                del self._ticket_traces[tid]
                entry = default_entry
                if cohort_of is not None and cohort_of[slot] >= 0:
                    entry = cohorts[cohort_of[slot]][0]
                trace_api.emit_matched_spans((trace_id, span_id), entry)
            elif not active[slot] and (
                inflight is None or not inflight[slot]
            ):
                # Deactivated (expired / min==max attempt spent) with
                # no dispatched cohort that could still match it: the
                # add→(not yet matched) trace finalizes now.
                del self._ticket_traces[tid]
                trace_api.TRACES.release(trace_id)

    def _register(self, ticket: MatchmakerTicket, active: bool = True):
        slot = self.store.add(ticket, active=active)
        try:
            self.backend.on_add(ticket, slot)
        except Exception:
            # A rejection (bad embedding, device row overflow) must leave
            # everything as it was.
            self.store.remove_slots(
                np.asarray([slot], dtype=np.int32), defer_free=False
            )
            raise
        self._update_gauges()

    # -------------------------------------------------------------- process

    def _next_cohort_deadline(self) -> float | None:
        """Earliest delivery deadline among the backend's queued cohorts
        (perf_counter seconds), or None: pipeline-less backends and an
        empty queue both report nothing due."""
        nd = getattr(self.backend, "next_deadline", None)
        return None if nd is None else nd()

    def collect_pipelined(self, block_until=None) -> MatchBatch | None:
        """Deliver any pipelined cohorts whose device pass + gap assembly
        already completed — called mid-gap by the interval loop so a
        match reaches players seconds after its dispatch instead of a
        full interval later. `block_until` (perf_counter seconds) bounds
        a blocking join of the head cohort for deadline-guard delivery.
        No-op (None) for backends without a pipeline or when nothing is
        ready."""
        collect = getattr(self.backend, "collect_ready", None)
        if collect is None:
            return None
        tracing = getattr(self.backend, "tracing", None)
        n_ledger = getattr(tracing, "deliveries_total", 0)
        # The backend reclaims + degrades the failures its ladder may
        # serve; anything it raises (a CUDA error at a cohort's fetch)
        # is a bug and propagates.
        out = collect(
            rev_precision=self.config.rev_precision,
            block_until=block_until,
        )
        if out is None:
            return None
        batch, matched_slots, reactivate = out
        objs = None
        if len(matched_slots):
            self.backend.on_remove_slots(matched_slots)
            objs = self.store.remove_slots(matched_slots)
            if batch.offsets is not None:
                batch.bind_tickets(objs)
        self.store.reactivate(reactivate)
        if self.metrics is not None:
            self.metrics.mm_matched.inc(batch.entry_count if batch else 0)
            self._update_gauges()
        published_ok = True
        if len(batch) and self.on_matched is not None:
            published_ok = self._publish(batch)
            self._stamp_published(tracing, n_ledger)
        self._journal_matched(matched_slots, objs, published_ok)
        self._finish_ticket_traces(matched_slots, tracing)
        return batch

    def _stamp_published(self, tracing, n_before: int):
        """Close the per-cohort stage chain: stamp dispatch→published
        lag on the ledger entries this collect/process call recorded
        (the cohorts whose matches were just handed to `on_matched`).
        Feeds the matchmaker_delivery_publish_lag histogram — the
        end-to-end number the dispatched→ready→accepted→published
        attribution hangs off."""
        if tracing is None:
            return
        mark = getattr(tracing, "mark_published", None)
        if mark is None:
            return
        # Monotonic-counter delta, NOT a deque-length delta: once the
        # bounded ledger fills, its length stops moving and a length
        # delta would stamp nothing forever.
        n_new = max(0, tracing.deliveries_total - n_before)
        lags = mark(time.perf_counter(), max_n=n_new)
        if self.metrics is not None:
            for lag in lags:
                self.metrics.mm_delivery_publish_lag.observe(lag)
        if self.slo is not None:
            for lag in lags:
                self.slo.observe("delivery_publish", lag * 1000)

    def _publish(self, batch: MatchBatch) -> bool:
        """Deliver a matched batch to `on_matched`, bounded by the fault
        plane's `delivery.publish` point. The tickets are already
        removed from the pool by the time delivery runs (reference
        single-shot semantics), so a failed or dropped publish is
        counted and logged loudly — the session-facing retry belongs to
        the consumer — but it must never poison interval bookkeeping.
        Returns publish success: a False journals the whole batch as
        `unpublished` matches so a restart re-pools the tickets; a
        handler raising PartialPublish (cluster: some cohorts' origin
        nodes down) returns the held tickets' id set so ONLY those
        cohorts journal unpublished."""
        try:
            if faults.fire("delivery.publish"):
                # drop-mode chaos: delivery intentionally discarded.
                self.logger.warn(
                    "match delivery dropped (fault armed)",
                    matches=len(batch),
                )
                if self.metrics is not None:
                    self.metrics.mm_delivery_failed.inc()
                return False
            self.on_matched(batch)
            return True
        except PartialPublish as e:
            self.logger.warn(
                "match delivery partially held",
                held_tickets=len(e.failed_tickets),
                matches=len(batch),
                reason=str(e),
            )
            if self.metrics is not None:
                self.metrics.mm_delivery_failed.inc()
            return e.failed_tickets
        except Exception as e:
            self.logger.error(
                "match delivery failed",
                error=str(e),
                matches=len(batch),
            )
            if self.metrics is not None:
                self.metrics.mm_delivery_failed.inc()
            return False

    def _journal_matched(self, matched_slots, objs, published_ok: bool):
        """Journal one interval/collect call's matched outcome: ids only
        when the cohort published (the tickets are consumed for good),
        full payloads when it did NOT (`unpublished` — a restart
        re-pools them for re-dispatch). `objs` is the store's removal
        snapshot — usually the LAZY resolver, passed through unresolved
        so serialization lands in the journal drain (idle gap), never
        here on the delivery path."""
        if (
            self.journal is None
            or matched_slots is None
            or not len(matched_slots)
        ):
            return
        if callable(objs):
            resolver = objs
        else:
            arr = objs
            resolver = lambda: (arr if arr is not None else ())  # noqa: E731
        if isinstance(published_ok, frozenset):
            # Partial publish (cluster: held cohorts): only the held
            # tickets journal unpublished — journaling the delivered
            # ones too would double-deliver their matches after a
            # restart's re-pool.
            held = published_ok
            self.journal.record_unpublished(
                lambda: [
                    t for t in resolver()
                    if t is not None and t.ticket in held
                ]
            )
            self.journal.record_matched(
                lambda: [
                    t for t in resolver()
                    if t is not None and t.ticket not in held
                ]
            )
        elif published_ok:
            self.journal.record_matched(resolver)
        else:
            self.journal.record_unpublished(resolver)

    def process(self) -> MatchBatch:
        """One matching interval (reference Process, matchmaker.go:282-441).

        Interval bookkeeping is vectorized over the active slot array; the
        backend returns matches columnar; unregistration is one bulk store
        call. Per-entry Python objects are only touched on the override /
        host-only object paths."""
        t0 = time.perf_counter()
        t_backend = t0  # re-stamped just before the backend call below
        _tracing = getattr(self.backend, "tracing", None)
        _n_ledger = getattr(_tracing, "deliveries_total", 0)
        store = self.store
        meta = store.meta
        active_slots = store.active_slots()
        max_intervals = self.config.max_intervals

        if self.override_fn is not None:
            batch, matched_slots, expired_slots = self._process_override(
                active_slots
            )
            reactivate = np.zeros(0, dtype=np.int32)
        else:
            # Interval bump + expiry, vectorized (reference bumps
            # per-active in the loop; equivalent because matched actives
            # leave the pool anyway).
            meta["intervals"][active_slots] += 1
            iv = meta["intervals"][active_slots]
            last = (iv >= max_intervals) | (
                meta["min_count"][active_slots]
                == meta["max_count"][active_slots]
            )
            expired_slots = active_slots[last]
            t_backend = time.perf_counter()
            # The device backend absorbs only the failures its ladder
            # may serve (injected faults, device memory pressure); what
            # it raises is a bug — a kernel that fails to build or
            # launch, a CUDA error — and propagates to the caller.
            batch, matched_slots, reactivate = self.backend.process_slots(
                active_slots,
                last,
                max_intervals=max_intervals,
                rev_precision=self.config.rev_precision,
            )

        t_rm = time.perf_counter()
        store.deactivate(expired_slots)
        t_rm1 = time.perf_counter()
        if len(matched_slots):
            self.backend.on_remove_slots(matched_slots)
        t_rm2 = time.perf_counter()
        objs = None
        if len(matched_slots):
            objs = store.remove_slots(matched_slots)
            if batch.offsets is not None:
                # Columnar batch: its slots ARE matched_slots in order —
                # reuse the parked refs as the delivery snapshot.
                batch.bind_tickets(objs)
        store.reactivate(reactivate)
        t_cb = time.perf_counter()

        if self.metrics is not None:
            self.metrics.mm_process_time.observe(time.perf_counter() - t0)
            self.metrics.mm_matched.inc(batch.entry_count if batch else 0)
            self._update_gauges()
        if self.slo is not None:
            self.slo.observe(
                "matchmaker_interval", (time.perf_counter() - t0) * 1000
            )

        published_ok = True
        if len(batch) and self.on_matched is not None:
            published_ok = self._publish(batch)
            self._stamp_published(_tracing, _n_ledger)
        self._journal_matched(matched_slots, objs, published_ok)
        self._finish_ticket_traces(matched_slots, _tracing)
        # Attribute the post-backend tail (slot removal, delivery
        # callback) on the interval's breadcrumb: the work that isn't
        # inside process_slots must still be visible per interval.
        # Override intervals never called process_slots, so the last
        # crumb is some earlier interval's — updating it would corrupt
        # that interval's attribution.
        tracing = (
            getattr(self.backend, "tracing", None)
            if self.override_fn is None
            else None
        )
        if tracing is not None and tracing.breadcrumbs:
            import threading as _threading

            tracing.breadcrumbs[-1].update(
                remove_s=t_cb - t_rm,
                rm_backend_s=t_rm2 - t_rm1,
                rm_store_s=t_cb - t_rm2,
                callback_s=time.perf_counter() - t_cb,
                pre_backend_s=t_backend - t0,
                threads=_threading.active_count(),
            )
        return batch

    def _process_override(self, active_slots: np.ndarray):
        """Runtime-override interval: object semantics (the override fn
        consumes entry lists), small pools by design."""
        store = self.store
        actives, ordered, pool = store.oracle_view(active_slots)
        matched, expired_ids = process_custom(
            actives,
            pool,
            max_intervals=self.config.max_intervals,
            rev_precision=self.config.rev_precision,
            override_fn=self.override_fn,
        )
        # process_custom bumped object intervals; write back.
        store.meta["intervals"][ordered] = [t.intervals for t in actives]
        # An override fn may return overlapping or raced-out sets: first
        # set wins, later ones drop (old unregister-as-you-go behaviour).
        confirmed: list[list[MatchmakerEntry]] = []
        taken: set[str] = set()
        for entry_set in matched:
            tids = {e.ticket for e in entry_set}
            if all(t in store and t not in taken for t in tids):
                confirmed.append(entry_set)
                taken |= tids
        batch, matched_slots = lists_to_batch(confirmed, store)
        expired_slots = np.asarray(
            [
                s
                for tid in expired_ids
                if (s := store.slot_by_id(tid)) is not None
            ],
            dtype=np.int32,
        )
        return batch, matched_slots, expired_slots

    # -------------------------------------------------------------- removal

    def _remove_slots(self, slots: np.ndarray):
        if len(slots) == 0:
            return
        # API callers may pass duplicate ids; the store requires unique
        # slots (a duplicate would double-free into the allocator).
        slots = np.unique(np.asarray(slots, dtype=np.int32))
        removed_ids: list[str] = []
        if self.journal is not None:
            # Ids captured BEFORE the eager teardown clears ticket_at;
            # journaled only AFTER the removal really happened (a remove
            # record for a removal that raised would drop a live ticket
            # at replay). Cancel-path removals are small (client/session
            # scoped): the id walk is O(removed), not interval work.
            ticket_at = self.store.ticket_at
            removed_ids = [
                ticket_at[s].ticket
                for s in slots
                if ticket_at[s] is not None
            ]
        if self._ticket_traces:
            # Cancelled/removed tickets release their trace holds (no
            # matched spans — the trace finalizes with just the add).
            ticket_at = self.store.ticket_at
            for s in slots:
                t = ticket_at[s]
                if t is not None:
                    self._release_ticket_trace(t.ticket)
        self.backend.on_remove_slots(slots)
        # Eager teardown: API removals are small, and immediate slot free
        # keeps LIFO reuse (pool density). Only the interval's bulk
        # matched-removal defers to the idle-gap drain.
        self.store.remove_slots(slots, defer_free=False)
        if self.journal is not None and removed_ids:
            self.journal.record_remove(removed_ids)

    def _unregister(self, ticket_id: str):
        slot = self.store.slot_by_id(ticket_id)
        if slot is None:
            return
        self._remove_slots(np.asarray([slot], dtype=np.int32))

    def remove_session(self, session_id: str, ticket_id: str):
        """Ownership-checked removal (reference matchmaker.go:725)."""
        t = self.store.get(ticket_id)
        if t is None or session_id not in t.session_ids:
            raise MatchmakerError("ticket not found")
        self._unregister(ticket_id)
        self._update_gauges()

    def remove_session_all(self, session_id: str):
        slots = [
            self.store.slot_by_id(t.ticket)
            for t in self.store.session_tickets(session_id)
        ]
        self._remove_slots(
            np.asarray([s for s in slots if s is not None], dtype=np.int32)
        )
        self._update_gauges()

    def remove_party(self, party_id: str, ticket_id: str):
        t = self.store.get(ticket_id)
        if t is None or t.party_id != party_id:
            raise MatchmakerError("ticket not found")
        self._unregister(ticket_id)
        self._update_gauges()

    def remove_party_all(self, party_id: str):
        slots = [
            self.store.slot_by_id(t.ticket)
            for t in self.store.party_tickets(party_id)
        ]
        self._remove_slots(
            np.asarray([s for s in slots if s is not None], dtype=np.int32)
        )
        self._update_gauges()

    def remove_all(self, node: str):
        if node == self.node:
            self._remove_slots(self.store.live_slots())
        else:
            # Cluster sweep: tickets whose presences belong to a (dead)
            # foreign node. O(pool) object walk — peer death is rare
            # and off the interval path.
            ticket_at = self.store.ticket_at
            slots = [
                s
                for s in self.store.live_slots()
                if any(
                    e.presence.node == node
                    for e in ticket_at[s].entries
                )
            ]
            self._remove_slots(np.asarray(slots, dtype=np.int32))
        self._update_gauges()

    def remove(self, ticket_ids: list[str]):
        slots = [self.store.slot_by_id(tid) for tid in ticket_ids]
        self._remove_slots(
            np.asarray([s for s in slots if s is not None], dtype=np.int32)
        )
        self._update_gauges()

    # ------------------------------------------------------ extract / insert

    def extract(self, ticket_ids=None) -> list[MatchmakerExtract]:
        """Export all tickets for node-drain handover (matchmaker.go:684),
        or only the live ones among `ticket_ids` (the tickets a graceful
        stop held for their players, recovery.HeldTickets)."""
        store = self.store
        iv = store.meta["intervals"]
        out = []
        if ticket_ids is None:
            slots = store.live_slots()
        else:
            slots = [store.slot_by_id(tid) for tid in ticket_ids]
            slots = [s for s in slots if s is not None]
        for s in slots:
            t = store.ticket_at[s]
            out.append(
                MatchmakerExtract(
                    presences=[e.presence for e in t.entries],
                    session_id=t.session_id,
                    party_id=t.party_id,
                    query=t.query,
                    min_count=t.min_count,
                    max_count=t.max_count,
                    count_multiple=t.count_multiple,
                    string_properties=dict(t.string_properties),
                    numeric_properties=dict(t.numeric_properties),
                    ticket=t.ticket,
                    created_at=t.created_at,
                    intervals=int(iv[s]),
                    embedding=t.embedding,
                )
            )
        return out

    def insert(self, extracts: list[MatchmakerExtract]):
        """Bulk-import tickets from another node (matchmaker.go:567) or
        the crash-recovery replay. Query ASTs are parsed once per
        DISTINCT query across the batch — handover/replay batches
        repeat a small canonical query set, and the shared-AST
        discipline is already established by the checkpoint thaw
        path (types.thaw_ticket)."""
        parse_cache: dict[str, object] = {}
        for ex in extracts:
            parsed = parse_cache.get(ex.query)
            if parsed is None:
                try:
                    parsed = parse_cache[ex.query] = parse_query(ex.query)
                except QueryError:
                    self.logger.warn(
                        "insert: dropping bad query", ticket=ex.ticket
                    )
                    continue
            entries = [
                MatchmakerEntry(
                    ticket=ex.ticket,
                    presence=p,
                    string_properties=ex.string_properties,
                    numeric_properties=ex.numeric_properties,
                    party_id=ex.party_id,
                    create_time=ex.created_at,
                )
                for p in ex.presences
            ]
            ticket = MatchmakerTicket(
                ticket=ex.ticket,
                query=ex.query,
                min_count=ex.min_count,
                max_count=ex.max_count,
                count_multiple=ex.count_multiple,
                session_id=ex.session_id,
                party_id=ex.party_id,
                entries=entries,
                string_properties=dict(ex.string_properties),
                numeric_properties=dict(ex.numeric_properties),
                created_at=ex.created_at,
                intervals=ex.intervals,
                parsed_query=parsed,
                embedding=ex.embedding,
            )
            try:
                self._register(ticket)
            except KeyError:
                # Re-delivered handover batch: the id is already live.
                self.logger.warn(
                    "insert: duplicate ticket", ticket=ex.ticket
                )
                continue
            if self.journal is not None:
                # Handover inserts are adds for durability purposes;
                # recovery replay suspends the journal so replayed
                # tickets are not re-journaled.
                self.journal.record_add(ticket)

    # ------------------------------------------------- snapshot / restore

    def snapshot_state(self) -> dict:
        """Checkpoint view of the whole matchmaker (recovery.py): the
        slot store's columnar state + ticket objects, and — when the
        backend keeps derived device state — its compiled pool rows and
        mirrors, so a warm restart is bulk restores + one device_put,
        never ~pool_size re-registrations."""
        snap: dict = {
            "store": self.store.snapshot(),
            "tickets_total": len(self.store),
        }
        alive = self.store.alive
        snap["max_created_seq"] = (
            int(self.store.meta["created_seq"][alive].max())
            if alive.any()
            else 0
        )
        backend_snap = getattr(self.backend, "snapshot_state", None)
        if backend_snap is not None:
            snap["backend"] = backend_snap()
        return snap

    def restore_state(self, snap: dict) -> None:
        """Warm-restart restore onto a FRESH matchmaker built from the
        same config. Restores the store, then the backend's derived
        state — directly when the snapshot carries a matching backend
        section, else by re-registering each live ticket through
        `on_add` (cross-backend restore: correct, not bulk-fast)."""
        from .types import advance_created_seq

        self.store.restore(snap["store"])
        advance_created_seq(snap.get("max_created_seq", 0))
        backend_restore = getattr(self.backend, "restore_state", None)
        backend_snap = snap.get("backend")
        if backend_restore is not None and backend_snap is not None:
            try:
                backend_restore(backend_snap)
            except Exception as e:
                # Schema drift (config changed across the restart) or a
                # torn backend section: the store is already populated,
                # so bailing here would leave live tickets with no
                # device rows — permanently unmatchable zombies. Fall
                # back to re-deriving each ticket's rows through the
                # normal add path: slow, correct.
                self.logger.warn(
                    "backend snapshot restore failed; re-deriving"
                    " device rows per ticket",
                    error=str(e),
                )
                self._rederive_backend_rows()
        elif getattr(self.backend, "snapshot_state", None) is not None:
            # Snapshot written by a state-less backend (CPU oracle)
            # restored onto a device backend: re-derive rows per ticket.
            self._rederive_backend_rows()
        self._update_gauges()

    def _rederive_backend_rows(self) -> None:
        """Rebuild the backend's per-ticket derived state through
        `on_add` for every live slot (cross-backend/cross-schema
        restore). A ticket the CURRENT backend rejects (e.g. embedding
        width changed) is dropped from the pool — loudly — rather than
        left registered-but-unmatchable."""
        ticket_at = self.store.ticket_at
        rejected: list[int] = []
        for s in self.store.live_slots():
            try:
                self.backend.on_add(ticket_at[s], int(s))
            except Exception as e:
                rejected.append(int(s))
                self.logger.warn(
                    "restored ticket rejected by backend; dropping",
                    ticket=ticket_at[s].ticket,
                    error=str(e),
                )
        if rejected:
            self.store.remove_slots(
                np.asarray(rejected, dtype=np.int32), defer_free=False
            )

    # -------------------------------------------------------------- helpers

    def _update_gauges(self):
        if self.metrics is not None:
            self.metrics.mm_tickets.set(len(self.store))
            self.metrics.mm_active_tickets.set(self.store.n_active)

    def __len__(self) -> int:
        return len(self.store)

"""LocalMatchmaker: ticket pool bookkeeping + interval processing.

Port of the JAX package's `matchmaker/local.py` (reference
server/matchmaker.go:169-1068): add/remove with per-session and
per-party MaxTickets enforcement, stop, and a per-interval `process()`
that forms matches and reports them to a callback.

Host bookkeeping is slot-centric (store.py): the interval path — interval
bumping, expiry, matched-ticket unregistration, match delivery — is
O(batch) numpy/native calls, never per-entry Python. Delivery hands
`on_matched` a columnar `MatchBatch`.

The process backend is pluggable: the CPU oracle (`process.py`, via
`CpuBackend`) or the device backend (`cuda.py`). Callers drive intervals
by calling `process()`, and `collect_pipelined()` between intervals to
deliver pipelined cohorts as soon as they finish.
"""

from __future__ import annotations

import time
import uuid
from typing import Callable, Protocol

import numpy as np

from ..config import MatchmakerConfig
from ..logger import Logger
from .process import process_default
from .query import QueryError, parse_query
from .store import SlotStore
from .types import (
    MatchBatch,
    MatchmakerEntry,
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


MatchedCallback = Callable[[MatchBatch], None]


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
        active interval so churn cannot strand them."""
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
    """Wrap the oracle's match lists as a MatchBatch +
    the flat matched slot array for bulk removal."""
    batch = MatchBatch.from_lists(matched)
    slot_parts: list[int] = []
    for entry_set in matched:
        for tid in dict.fromkeys(e.ticket for e in entry_set):
            slot = store.slot_by_id(tid)
            if slot is not None:
                slot_parts.append(slot)
    return batch, np.asarray(slot_parts, dtype=np.int32)


def _select_backend(config: MatchmakerConfig, logger):
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

    return CudaBackend(config, logger)


class LocalMatchmaker:
    def __init__(
        self,
        logger: Logger,
        config: MatchmakerConfig,
        node: str = "local",
        backend: ProcessBackend | None = None,
        on_matched: MatchedCallback | None = None,
    ):
        self.logger = logger.with_fields(subsystem="matchmaker")
        self.config = config
        self.node = node
        self.store = SlotStore(config.pool_capacity, config.max_party_size)
        self.backend = backend or _select_backend(config, self.logger)
        self.backend.attach(self.store)
        self.on_matched = on_matched
        self._stopped = False

    # ------------------------------------------------------------- lifecycle

    def stop(self):
        self._stopped = True
        wait_idle = getattr(self.backend, "wait_idle", None)
        if wait_idle is not None:
            # No fetch/assembly worker thread outlives the matchmaker.
            wait_idle(timeout=5.0)

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

        Reference Add: server/matchmaker.go:443-566."""
        if self._stopped:
            raise ErrNotAvailable("matchmaker stopped")
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
        return ticket_id, created_at

    def _register(self, ticket: MatchmakerTicket):
        slot = self.store.add(ticket)
        try:
            self.backend.on_add(ticket, slot)
        except Exception:
            # A rejection (bad embedding) must leave everything as it was.
            self.store.remove_slots(
                np.asarray([slot], dtype=np.int32), defer_free=False
            )
            raise

    # -------------------------------------------------------------- process

    def collect_pipelined(self) -> MatchBatch | None:
        """Deliver pipelined cohorts whose device pass + host assembly
        already completed (between intervals). None when the backend has
        no pipeline or nothing is ready."""
        collect = getattr(self.backend, "collect_ready", None)
        if collect is None:
            return None
        out = collect()
        if out is None:
            return None
        batch, matched_slots, reactivate = out
        if len(matched_slots):
            self.backend.on_remove_slots(matched_slots)
            objs = self.store.remove_slots(matched_slots)
            batch.bind_tickets(objs)
        self.store.reactivate(reactivate)
        if len(batch) and self.on_matched is not None:
            self._publish(batch)
        return batch

    def _publish(self, batch: MatchBatch) -> None:
        """Deliver a matched batch to `on_matched`. The tickets are already
        removed from the pool (reference single-shot semantics), so a
        failing handler is logged loudly and never poisons interval
        bookkeeping."""
        try:
            self.on_matched(batch)
        except Exception as e:
            self.logger.error(
                "match delivery failed", error=str(e), matches=len(batch)
            )

    def process(self) -> MatchBatch:
        """One matching interval (reference Process, matchmaker.go:282-441).

        Interval bookkeeping is vectorised over the active slot array; the
        backend returns matches columnar; unregistration is one bulk store
        call."""
        store = self.store
        meta = store.meta
        active_slots = store.active_slots()
        max_intervals = self.config.max_intervals

        # Interval bump + expiry, vectorised.
        meta["intervals"][active_slots] += 1
        iv = meta["intervals"][active_slots]
        last = (iv >= max_intervals) | (
            meta["min_count"][active_slots] == meta["max_count"][active_slots]
        )
        expired_slots = active_slots[last]
        try:
            batch, matched_slots, reactivate = self.backend.process_slots(
                active_slots,
                last,
                max_intervals=max_intervals,
                rev_precision=self.config.rev_precision,
            )
        except Exception as e:
            # A failing backend costs one interval's matching, never the
            # bookkeeping around it: tickets stay pooled, expiring actives
            # get their attempt back next interval.
            self.logger.error(
                "backend process failed; interval degraded",
                error=str(e),
                backend=type(self.backend).__name__,
            )
            batch = MatchBatch.from_lists([])
            matched_slots = np.zeros(0, dtype=np.int32)
            reactivate = expired_slots.astype(np.int32)

        store.deactivate(expired_slots)
        if len(matched_slots):
            self.backend.on_remove_slots(matched_slots)
            objs = store.remove_slots(matched_slots)
            if batch.offsets is not None:
                # Columnar batch: its slots ARE matched_slots in order.
                batch.bind_tickets(objs)
        store.reactivate(reactivate)
        if len(batch) and self.on_matched is not None:
            self._publish(batch)
        return batch

    # -------------------------------------------------------------- removal

    def _remove_slots(self, slots: np.ndarray):
        if len(slots) == 0:
            return
        # API callers may pass duplicate ids; the store requires unique
        # slots (a duplicate would double-free into the allocator).
        slots = np.unique(np.asarray(slots, dtype=np.int32))
        self.backend.on_remove_slots(slots)
        self.store.remove_slots(slots, defer_free=False)

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

    def remove_session_all(self, session_id: str):
        slots = [
            self.store.slot_by_id(t.ticket)
            for t in self.store.session_tickets(session_id)
        ]
        self._remove_slots(
            np.asarray([s for s in slots if s is not None], dtype=np.int32)
        )

    def remove_party(self, party_id: str, ticket_id: str):
        t = self.store.get(ticket_id)
        if t is None or t.party_id != party_id:
            raise MatchmakerError("ticket not found")
        self._unregister(ticket_id)

    def remove_party_all(self, party_id: str):
        slots = [
            self.store.slot_by_id(t.ticket)
            for t in self.store.party_tickets(party_id)
        ]
        self._remove_slots(
            np.asarray([s for s in slots if s is not None], dtype=np.int32)
        )

    def remove_all(self, node: str):
        if node == self.node:
            self._remove_slots(self.store.live_slots())
            return
        # Tickets whose presences belong to a (dead) foreign node.
        ticket_at = self.store.ticket_at
        slots = [
            s
            for s in self.store.live_slots()
            if any(e.presence.node == node for e in ticket_at[s].entries)
        ]
        self._remove_slots(np.asarray(slots, dtype=np.int32))

    def remove(self, ticket_ids: list[str]):
        slots = [self.store.slot_by_id(tid) for tid in ticket_ids]
        self._remove_slots(
            np.asarray([s for s in slots if s is not None], dtype=np.int32)
        )

    def __len__(self) -> int:
        return len(self.store)

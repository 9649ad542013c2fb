"""Slot-centric ticket store: the matchmaker's host-side source of truth.

Round-2 profiling found the interval floor was per-entry Python dict/set
churn — ~1.5s at ~100k matched entries — in exactly the maps the
reference keeps per ticket in Go (sessionTickets/partyTickets/indexes,
reference server/matchmaker.go:171-214). This store re-lays that state
out columnar, indexed by pool slot:

- ticket *objects* live in one object ndarray (`ticket_at`) — the
  interval path never walks them; they are only materialized per entry at
  delivery (lazily, by MatchBatch) and for the host-only oracle path,
- per-slot metadata (counts, intervals, created, session hashes) are
  persistent numpy arrays shared with the device backend and the native
  assembler,
- id/session/party reverse maps are 64-bit-hash maps in C++
  (native/tickstore.cpp) updated by ONE bulk call per interval,
- removed ticket objects drop into a graveyard list freed in the
  interval's idle gap (`drain()`), so refcount cascades of ~300k objects
  never land on the interval's critical path (the same treatment the
  interval loop already gives gc).

Slot allocation is LIFO from slot 0 so the pool stays dense at the low
end and the device kernel can stop at the high-water mark (device.py).
"""

from __future__ import annotations

import numpy as np

from .. import native
from .compile import hash64
from .types import MatchmakerTicket


def _hash_id(value: str) -> int:
    return hash64(value) or 1


class SlotStore:
    """Slot allocator + per-slot ticket state + hash reverse maps."""

    def __init__(self, capacity: int, max_party_size: int):
        self.capacity = capacity
        self.ticket_at = np.full(capacity, None, dtype=object)
        self.alive = np.zeros(capacity, dtype=bool)
        self.active = np.zeros(capacity, dtype=bool)
        self.meta = {
            "min_count": np.zeros(capacity, dtype=np.int32),
            "max_count": np.zeros(capacity, dtype=np.int32),
            "count_multiple": np.ones(capacity, dtype=np.int32),
            "count": np.zeros(capacity, dtype=np.int32),
            "intervals": np.zeros(capacity, dtype=np.int32),
            "created": np.zeros(capacity, dtype=np.int64),  # ns wall clock
            "created_seq": np.zeros(capacity, dtype=np.int64),
            "session_hashes": np.zeros(
                (capacity, max_party_size), dtype=np.uint64
            ),
            "session_counts": np.zeros(capacity, dtype=np.int32),
        }
        # Bumped on every slot (re)assignment; pipelined device work
        # snapshots it at dispatch so collection can drop matches touching
        # reused slots (cuda.py).
        self.gen = np.zeros(capacity, dtype=np.int64)
        self.n_active = 0  # O(1) gauge (the masks are O(capacity) to sum)
        self.n_live = 0  # O(1) len() (maps lag removals until drain)
        # LIFO free stack (numpy: bulk push is one slice write); top at
        # index _free_n-1, initialized so slot 0 pops first (density).
        self._free = np.arange(capacity - 1, -1, -1, dtype=np.int32)
        self._free_n = capacity
        self.maps = native.TickStore(capacity, max_party_size)
        self._graveyard: list[tuple[np.ndarray, np.ndarray]] = []

    def __len__(self) -> int:
        return self.n_live

    # ------------------------------------------------------------ mutation

    def add(self, ticket: MatchmakerTicket, active: bool = True) -> int:
        """Assign a slot and register the ticket. Raises on capacity/dup;
        leaves no partial state behind on failure."""
        if self._free_n == 0 and self._graveyard:
            self.drain()  # lazily-freed slots cover the shortfall
        if self._free_n == 0:
            raise RuntimeError("matchmaker pool capacity exceeded")
        sessions = sorted(ticket.session_ids)
        stride = self.meta["session_hashes"].shape[1]
        if len(sessions) > stride:
            raise ValueError(
                f"party size {len(sessions)} exceeds max_party_size {stride}"
            )
        sh = np.asarray(
            [_hash_id(s) for s in sessions], dtype=np.uint64
        )
        slot = int(self._free[self._free_n - 1])
        try:
            self.maps.add(
                slot,
                _hash_id(ticket.ticket),
                sh,
                _hash_id(ticket.party_id) if ticket.party_id else 0,
            )
        except KeyError:
            if not self._graveyard:
                raise
            # The duplicate id may be an undrained removed ticket
            # (remove-then-readd within one interval gap): settle the
            # lazy removals and retry once. drain() pushes freed slots on
            # top of the stack, so the slot MUST be re-popped — retrying
            # with the pre-drain slot would leave the actually-allocated
            # top-of-stack slot on the free list (allocator poison).
            self.drain()
            slot = int(self._free[self._free_n - 1])
            self.maps.add(
                slot,
                _hash_id(ticket.ticket),
                sh,
                _hash_id(ticket.party_id) if ticket.party_id else 0,
            )
        self._free_n -= 1
        self.n_live += 1
        m = self.meta
        m["min_count"][slot] = ticket.min_count
        m["max_count"][slot] = ticket.max_count
        m["count_multiple"][slot] = ticket.count_multiple
        m["count"][slot] = ticket.count
        m["intervals"][slot] = ticket.intervals
        m["created"][slot] = int(ticket.created_at * 1e9)
        m["created_seq"][slot] = ticket.created_seq
        m["session_counts"][slot] = len(sessions)
        m["session_hashes"][slot, : len(sessions)] = sh
        m["session_hashes"][slot, len(sessions) :] = 0
        self.ticket_at[slot] = ticket
        self.alive[slot] = True
        self.active[slot] = active
        self.n_active += active
        self.gen[slot] += 1
        return slot

    def remove_slots(self, slots: np.ndarray, defer_free: bool = True):
        """Bulk unregistration (matched/removed tickets). The interval
        path (defer_free=True) flips only the alive/active masks NOW —
        the authoritative liveness every consumer checks — and parks the
        rest of the teardown (reverse-map removal, object-ref clearing,
        free-list push) for `drain()` in the interval's idle gap: at
        ~100k matched slots the native map removal + object fancy
        indexing measured ~15ms of interval tail. `defer_free=False`
        (small rollback paths) tears down eagerly.

        Returns the delivery snapshot: a LAZY resolver (zero-arg
        callable yielding ticket_at[slots]) on the deferred path, the
        materialized object array on the eager path — either binds into
        MatchBatch.bind_tickets without a second O(entries) fancy index.

        `slots` must be duplicate-free AND alive: the interval path
        guarantees it by construction (matches are slot-disjoint); API
        paths resolve via slot_by_id (alive-checked) and dedupe in
        LocalMatchmaker._remove_slots. A duplicate here would double-free
        the slot into the free list and poison the allocator."""
        if len(slots) == 0:
            return None
        slots = np.asarray(slots, dtype=np.int32)
        self.alive[slots] = False
        self.n_active -= int(self.active[slots].sum())
        self.active[slots] = False
        self.n_live -= len(slots)
        if defer_free:
            # The delivery snapshot is LAZY: the ~100k-object fancy
            # index costs 9-30ms on the 1-core host and lands straight
            # in the interval p99 if taken here. ticket_at stays valid
            # until drain() (which resolves any unresolved snapshot
            # first), so consumers iterating the batch pay the gather at
            # consumption — normally the idle gap, never the interval.
            holder: dict = {}
            ticket_at = self.ticket_at

            def resolve(_h=holder, _t=ticket_at, _s=slots):
                # Atomic/idempotent under concurrent callers: gather into
                # a local, then publish with setdefault — first writer
                # wins. A consumer racing drain() (which resolves before
                # clearing ticket_at) can therefore never overwrite the
                # valid cached array with a post-clear all-None gather.
                objs = _h.get("objs")
                if objs is None:
                    _h.setdefault("objs", _t[_s])
                    objs = _h["objs"]
                return objs

            self._graveyard.append((slots, resolve))
            return resolve
        objs = self.ticket_at[slots]
        self.maps.remove_slots(slots)
        self.ticket_at[slots] = None
        self.meta["session_counts"][slots] = 0
        n = len(slots)
        self._free[self._free_n : self._free_n + n] = slots
        self._free_n += n
        return objs

    def deactivate(self, slots: np.ndarray):
        if len(slots) == 0:
            return
        self.n_active -= int(self.active[slots].sum())
        self.active[slots] = False

    def reactivate(self, slots: np.ndarray):
        """Re-activate (alive) slots; inactive-only counting."""
        if len(slots) == 0:
            return
        turn_on = self.alive[slots] & ~self.active[slots]
        self.active[slots] |= turn_on
        self.n_active += int(turn_on.sum())

    def drain(self, deadline: float | None = None):
        """Settle lazily-removed slots (reverse maps, object refs, free
        list) and release the parked objects; called from the interval
        idle gap, and on-demand when the allocator or a duplicate-id add
        needs undrained slots settled early.

        `deadline` (perf_counter seconds) makes the pass preemptible: a
        cohort delivery due mid-gap must not queue behind a ~100k-object
        teardown, so the loop's gap work can stop between parked batches
        and leave the rest for the next gap (each batch settles
        atomically; partially-drained state is just a shorter
        graveyard)."""
        import time as _time

        parked, self._graveyard = self._graveyard, []
        for i, (slots, snapshot) in enumerate(parked):
            if deadline is not None and _time.perf_counter() >= deadline:
                # Park the remainder for the next gap (order preserved).
                self._graveyard = parked[i:] + self._graveyard
                return
            if callable(snapshot):
                # Materialize any still-lazy delivery snapshot before the
                # refs are cleared: a batch consumed after this drain
                # still sees its tickets.
                snapshot()
            self.maps.remove_slots(slots)
            self.ticket_at[slots] = None
            self.meta["session_counts"][slots] = 0
            n = len(slots)
            self._free[self._free_n : self._free_n + n] = slots
            self._free_n += n

    # -------------------------------------------------- snapshot / restore

    def snapshot(self) -> dict:
        """Checkpoint view of the store (recovery.py): the live slots'
        columnar metadata plus frozen ticket rows, slot-addressed so a
        restore rebuilds the EXACT slot assignment (device rows and gen
        counters are slot-keyed). Settles the graveyard first so maps,
        masks, and parked snapshots are consistent. Everything is a
        copy/compact row — the pool keeps mutating while the checkpoint
        pickles off-loop — and the id/party hashes are precomputed here
        (idle gap) so restore's bulk map rebuild does no hashing."""
        from .types import freeze_ticket

        self.drain()
        live = self.live_slots()
        tickets = [self.ticket_at[s] for s in live]
        return {
            "capacity": self.capacity,
            "live_slots": live,
            "active": self.active[live].copy(),
            "gen": self.gen.copy(),
            "meta": {k: v[live].copy() for k, v in self.meta.items()},
            "tickets": [freeze_ticket(t) for t in tickets],
            "id_hash": np.asarray(
                [_hash_id(t.ticket) for t in tickets], dtype=np.uint64
            ),
            "party_hash": np.asarray(
                [
                    _hash_id(t.party_id) if t.party_id else 0
                    for t in tickets
                ],
                dtype=np.uint64,
            ),
        }

    def restore(self, snap: dict) -> None:
        """Rebuild slot state from a snapshot onto THIS (fresh) store:
        bulk columnar writes, one thaw pass over the frozen ticket rows
        (query ASTs re-parsed once per distinct query), and ONE native
        bulk call rebuilding the reverse maps from the precomputed
        hashes — the restore half of the <2s 100k-pool recovery
        budget. No per-ticket query compilation, no device staging (the
        backend restores its own rows)."""
        from .types import thaw_ticket

        if snap["capacity"] != self.capacity:
            raise ValueError(
                f"snapshot capacity {snap['capacity']} != store"
                f" capacity {self.capacity} (restore onto a store built"
                " from the same matchmaker config)"
            )
        if self.n_live:
            raise RuntimeError("restore requires an empty store")
        live = np.asarray(snap["live_slots"], dtype=np.int32)
        for k, v in snap["meta"].items():
            self.meta[k][live] = v
        self.alive[live] = True
        self.active[live] = snap["active"]
        self.gen = np.asarray(snap["gen"], dtype=np.int64).copy()
        qcache: dict = {}
        tickets = [thaw_ticket(r, qcache) for r in snap["tickets"]]
        if len(live):
            obj = np.empty(len(tickets), dtype=object)
            obj[:] = tickets
            self.ticket_at[live] = obj
            add_bulk = getattr(self.maps, "add_bulk", None)
            if add_bulk is not None:
                add_bulk(
                    live,
                    snap["id_hash"],
                    self.meta["session_hashes"][live],
                    self.meta["session_counts"][live],
                    snap["party_hash"],
                )
            else:
                sh = self.meta["session_hashes"]
                sc = self.meta["session_counts"]
                for i, s in enumerate(live):
                    self.maps.add(
                        int(s),
                        int(snap["id_hash"][i]),
                        sh[s, : sc[s]],
                        int(snap["party_hash"][i]),
                    )
        self.n_live = len(live)
        self.n_active = int(self.active[live].sum())
        # Free list: every non-live slot, descending so the lowest slot
        # pops first (same density bias as a fresh store).
        free_mask = np.ones(self.capacity, dtype=bool)
        free_mask[live] = False
        free = np.nonzero(free_mask)[0][::-1].astype(np.int32)
        self._free[: len(free)] = free
        self._free_n = len(free)

    # ------------------------------------------------------------- queries

    def __contains__(self, ticket_id: str) -> bool:
        return self.slot_by_id(ticket_id) is not None

    def slot_by_id(self, ticket_id: str) -> int | None:
        slot = self.maps.slot_of(_hash_id(ticket_id))
        if slot is None or not self.alive[slot]:
            # alive is the authority: a lazily-removed slot still resolves
            # in the maps until drain().
            return None
        t = self.ticket_at[slot]
        # 64-bit collision guard: verify the resolved object really is it.
        if t is None or t.ticket != ticket_id:
            return None
        return slot

    def get(self, ticket_id: str) -> MatchmakerTicket | None:
        slot = self.slot_by_id(ticket_id)
        return None if slot is None else self.ticket_at[slot]

    def session_ticket_count(self, session_id: str) -> int:
        # alive filter: lazily-removed slots stay mapped until drain and
        # must not count against MaxTickets.
        slots = self.maps.session_slots(_hash_id(session_id))
        return int(self.alive[slots].sum())

    def party_ticket_count(self, party_id: str) -> int:
        slots = self.maps.party_slots(_hash_id(party_id))
        return int(self.alive[slots].sum())

    def session_tickets(self, session_id: str) -> list[MatchmakerTicket]:
        out = []
        for slot in self.maps.session_slots(_hash_id(session_id)):
            t = self.ticket_at[slot]
            if (
                self.alive[slot]
                and t is not None
                and session_id in t.session_ids
            ):
                out.append(t)
        return out

    def party_tickets(self, party_id: str) -> list[MatchmakerTicket]:
        out = []
        for slot in self.maps.party_slots(_hash_id(party_id)):
            t = self.ticket_at[slot]
            if self.alive[slot] and t is not None and t.party_id == party_id:
                out.append(t)
        return out

    def live_tickets(self) -> list[MatchmakerTicket]:
        return list(self.ticket_at[self.alive])

    def live_slots(self) -> np.ndarray:
        return np.nonzero(self.alive)[0].astype(np.int32)

    def active_slots(self) -> np.ndarray:
        return np.nonzero(self.active)[0].astype(np.int32)

    def ordered_actives(
        self, active_slots: np.ndarray
    ) -> tuple[list[MatchmakerTicket], np.ndarray]:
        """Active ticket objects ordered oldest-first by (created_at,
        created_seq), plus the matching ordered slot array. Does NOT sync
        object intervals — pair with `oracle_view()` for oracle paths."""
        order = np.lexsort(
            (
                self.meta["created_seq"][active_slots],
                self.meta["created"][active_slots],
            )
        )
        ordered = active_slots[order]
        ticket_at = self.ticket_at
        return [ticket_at[s] for s in ordered], ordered

    def oracle_view(
        self, active_slots: np.ndarray
    ) -> tuple[list[MatchmakerTicket], np.ndarray, dict[str, MatchmakerTicket]]:
        """Object-path prelude shared by the CPU oracle and the CUDA
        backend's host-only fallback: ONE O(pool) walk that syncs every live ticket object's `intervals` from the
        authoritative array (the oracle's "let them wait" rule reads
        hit.intervals) and builds the id->ticket dict the candidate scan
        walks; returns (ordered actives, ordered slots, pool dict)."""
        iv = self.meta["intervals"]
        ticket_at = self.ticket_at
        pool: dict[str, MatchmakerTicket] = {}
        for s in self.live_slots():
            t = ticket_at[s]
            t.intervals = int(iv[s])
            pool[t.ticket] = t
        actives, ordered = self.ordered_actives(active_slots)
        return actives, ordered, pool

"""Matchmaker data model.

Capability parity with the reference ticket model (reference
server/matchmaker.go:61-130): a ticket carries one entry per presence (a
party ticket carries several), string+numeric properties, a query, min/max
count, count multiple, and bookkeeping used by the process loop. Extract is
the node-drain handover format (server/matchmaker.go:110-130); frozen
ticket rows (`freeze_ticket`) are the snapshot format, plain tuples that
the JAX package's snapshots share.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

_created_seq = itertools.count(1)


def advance_created_seq(past: int) -> None:
    """Advance the process-wide created_seq counter past `past` (warm
    restart: restored tickets keep their sequence numbers, so new adds
    must not collide with — or sort before — them on the oldest-first
    tie-break)."""
    global _created_seq
    current = next(_created_seq)
    _created_seq = itertools.count(max(current, int(past) + 1))


@dataclass(frozen=True)
class MatchmakerPresence:
    user_id: str
    session_id: str
    username: str = ""
    node: str = ""

    def as_dict(self) -> dict:
        return {
            "user_id": self.user_id,
            "session_id": self.session_id,
            "username": self.username,
        }


@dataclass
class MatchmakerEntry:
    ticket: str
    presence: MatchmakerPresence
    string_properties: dict[str, str] = field(default_factory=dict)
    numeric_properties: dict[str, float] = field(default_factory=dict)
    party_id: str = ""
    create_time: float = 0.0

    @property
    def properties(self) -> dict[str, Any]:
        return {**self.string_properties, **self.numeric_properties}


@dataclass
class MatchmakerTicket:
    """One pool entry (reference MatchmakerIndex, server/matchmaker.go:88-108)."""

    ticket: str
    query: str
    min_count: int
    max_count: int
    count_multiple: int
    session_id: str  # "" for party tickets
    party_id: str  # "" for solo tickets
    entries: list[MatchmakerEntry]
    string_properties: dict[str, str]
    numeric_properties: dict[str, float]
    created_at: float  # wall-clock seconds
    created_seq: int = 0  # monotone tiebreaker, assigned by the pool
    intervals: int = 0
    parsed_query: Any = None  # query AST, set on add
    # Optional learned skill embedding (BASELINE.md config 3): candidates are
    # scored by dot-product similarity on the MXU in addition to boosts.
    embedding: Any = None  # np.ndarray [D] | None

    def __post_init__(self):
        if self.created_seq == 0:
            self.created_seq = next(_created_seq)

    @property
    def count(self) -> int:
        return len(self.entries)

    @property
    def session_ids(self) -> set[str]:
        return {e.presence.session_id for e in self.entries}

    def document(self) -> dict[str, Any]:
        """The searchable view of this ticket (reference MapMatchmakerIndex,
        server/matchmaker.go:1026-1040): ticket fields + flattened
        ``properties.*`` keys."""
        doc: dict[str, Any] = {
            "ticket": self.ticket,
            "min_count": float(self.min_count),
            "max_count": float(self.max_count),
            "party_id": self.party_id,
            "created_at": float(self.created_at),
        }
        for k, v in self.string_properties.items():
            doc[f"properties.{k}"] = v
        for k, v in self.numeric_properties.items():
            doc[f"properties.{k}"] = float(v)
        return doc


class MatchBatch:
    """Columnar view of one interval's formed matches.

    The interval path produces matches as (CSR offsets, flat slot array)
    straight out of the native assembler; this wrapper exposes them to
    consumers WITHOUT materializing ~100k per-entry Python objects on the
    interval's critical path (the round-2 host floor). It behaves as a
    sequence of entry lists — ``len``, iteration, indexing — materializing
    each match's `MatchmakerEntry` list lazily from the slot-indexed
    ticket array; columnar consumers (metrics, the bench, batched envelope
    fan-out) read `.offsets` / `.slots` / `.entry_count` directly.
    """

    __slots__ = ("offsets", "slots", "_tickets", "_counts", "_cache")

    def __init__(self, offsets, slots, ticket_at=None, counts=None):
        self.offsets = offsets  # i32/i64 [n_matches + 1]
        self.slots = slots  # i32 [total ticket slots]
        # Object refs + entry counts are SNAPSHOT, not slot-indexed live:
        # matched slots are store-removed right after delivery, so lazy
        # consumers would read None otherwise. The ticket snapshot may be
        # deferred (ticket_at=None) and bound via bind_tickets() with the
        # removal path's parked array, saving a duplicate O(entries)
        # object fancy-index per interval.
        self._tickets = None if ticket_at is None else ticket_at[slots]
        self._counts = None if counts is None else counts[slots]
        self._cache: dict[int, list[MatchmakerEntry]] = {}

    def bind_tickets(self, tickets_arr):
        """Late-bind the ticket snapshot (aligned with `slots`): either
        the materialized object array, or a zero-arg resolver from the
        store's lazy removal path — resolved on first entry access so
        the O(entries) object gather stays off the interval."""
        if self._tickets is None:
            self._tickets = tickets_arr

    @classmethod
    def from_lists(cls, matched: list[list["MatchmakerEntry"]]):
        """Adapter for object-path producers (CPU oracle, runtime
        overrides): wraps pre-built entry lists without slot data."""
        batch = cls(None, None, None)
        batch._cache = dict(enumerate(matched))
        batch.offsets = None
        return batch

    def __len__(self) -> int:
        if self.offsets is None:
            return len(self._cache)
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> list["MatchmakerEntry"]:
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        hit = self._cache.get(i)
        if hit is None:
            if callable(self._tickets):
                self._tickets = self._tickets()  # lazy store snapshot
            entries: list[MatchmakerEntry] = []
            for t in self._tickets[self.offsets[i] : self.offsets[i + 1]]:
                entries.extend(t.entries)
            self._cache[i] = hit = entries
        return hit

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self) -> bool:
        return len(self) > 0

    def __eq__(self, other):
        if isinstance(other, MatchBatch):
            other = list(other)
        if isinstance(other, list):
            return list(self) == other
        return NotImplemented

    @property
    def entry_count(self) -> int:
        """Total matched entries, without materializing entry objects."""
        if self.offsets is None:
            return sum(len(m) for m in self._cache.values())
        if self._counts is not None:
            return int(self._counts.sum())
        return sum(len(m) for m in self)

    def tickets(self, i: int) -> list["MatchmakerTicket"]:
        """The ticket objects of match i (active ticket last)."""
        if self.offsets is None:
            raise ValueError("object-path batch has no slot data")
        if callable(self._tickets):
            self._tickets = self._tickets()  # lazy store snapshot
        return list(self._tickets[self.offsets[i] : self.offsets[i + 1]])


def freeze_ticket(t: MatchmakerTicket) -> tuple:
    """Compact checkpoint row for one ticket (recovery.py snapshots):
    plain tuples pickle ~3x leaner/faster than the object graph, and
    the query AST is dropped entirely — `thaw_ticket` re-parses once
    per DISTINCT query (production pools repeat a small canonical set),
    which measured far cheaper than pickling ~pool_size AST trees."""
    return (
        t.ticket,
        t.query,
        t.min_count,
        t.max_count,
        t.count_multiple,
        t.session_id,
        t.party_id,
        [
            (
                e.presence.user_id,
                e.presence.session_id,
                e.presence.username,
                e.presence.node,
            )
            for e in t.entries
        ],
        t.string_properties,
        t.numeric_properties,
        t.created_at,
        t.created_seq,
        int(t.intervals),
        t.embedding,
    )


def thaw_ticket(row: tuple, query_cache: dict) -> MatchmakerTicket:
    """Rebuild a ticket from its checkpoint row. Constructs via
    `object.__new__` + direct `__dict__` fill — the dataclass
    `__init__`/`__post_init__` overhead is ~3x the restore budget at
    100k tickets, and every invariant they enforce already held when
    the row was frozen. `query_cache` maps query string -> parsed AST,
    shared across the whole restore."""
    (
        tid, query, mn, mx, cm, sid, pid, pres, sprops, nprops,
        created_at, seq, iv, emb,
    ) = row
    ast = query_cache.get(query)
    if ast is None:
        from .query import parse_query

        ast = query_cache[query] = parse_query(query)
    new = object.__new__
    entries = []
    for user_id, session_id, username, node in pres:
        p = new(MatchmakerPresence)
        # Frozen dataclass: object.__setattr__ sidesteps the (irrelevant
        # here) immutability guard the same way pickle does.
        object.__setattr__(
            p,
            "__dict__",
            {
                "user_id": user_id,
                "session_id": session_id,
                "username": username,
                "node": node,
            },
        )
        e = new(MatchmakerEntry)
        e.__dict__ = {
            "ticket": tid,
            "presence": p,
            "string_properties": sprops,
            "numeric_properties": nprops,
            "party_id": pid,
            "create_time": created_at,
        }
        entries.append(e)
    t = new(MatchmakerTicket)
    t.__dict__ = {
        "ticket": tid,
        "query": query,
        "min_count": mn,
        "max_count": mx,
        "count_multiple": cm,
        "session_id": sid,
        "party_id": pid,
        "entries": entries,
        "string_properties": sprops,
        "numeric_properties": nprops,
        "created_at": created_at,
        "created_seq": seq,
        "intervals": iv,
        "parsed_query": ast,
        "embedding": emb,
    }
    return t


@dataclass
class MatchmakerExtract:
    """Ticket handover/checkpoint format for node drain
    (reference MatchmakerExtract, server/matchmaker.go:110-130)."""

    presences: list[MatchmakerPresence]
    session_id: str
    party_id: str
    query: str
    min_count: int
    max_count: int
    count_multiple: int
    string_properties: dict[str, str]
    numeric_properties: dict[str, float]
    ticket: str
    created_at: float
    intervals: int = 0
    embedding: Any = None

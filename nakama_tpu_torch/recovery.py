"""Crash-recovery plane: durable ticket journal, checkpoints, warm restart.

Port of the JAX package's `recovery.py`, over the port's own storage
engine (`storage/db.py`), fault plane and tracing. The journal rows
(`lsn, op, payload JSON, node, created_at`), the checkpoint pointer row
and the snapshot dict are the JAX package's formats, so a database and
checkpoint written by either package recover in the other.

The fault and overload planes keep the matchmaker serving while the
process stays up; this module makes its state survive the process
itself. Three pieces, the ARIES WAL+checkpoint pattern mapped onto the
group-commit storage engine:

- `TicketJournal` — an append-only, LSN-ordered log of every ticket
  outcome (add / remove / matched / publish-failed), buffered in memory
  and drained through the engine's group-commit write pipeline as ONE
  atomic unit per drain (``execute_many``), so durability rides the
  batching win instead of adding per-record fsyncs. Payloads are lazy
  (zero-arg closures resolved at drain time in the interval idle gap),
  so the interval critical path pays one list append per outcome, never
  serialization. A torn/failed journal write DEGRADES the journal to
  in-memory-only with a WARN (`journal.append` fault point) — it never
  wedges the interval loop; the next successful drain (or checkpoint)
  heals it.

- `Checkpointer` — periodic pool snapshots written in the interval idle
  gap: the matchmaker's columnar state (slot arrays, device pool rows,
  exact mirrors) plus the pickled ticket objects, fsynced to a sidecar
  file with an atomic rename, then the checkpoint pointer row and the
  journal truncation (rows with lsn <= the checkpoint's) committed as
  one atomic write unit. Replay work after a crash is therefore bounded
  by one checkpoint interval of journal tail.

- `recover()` — warm restart: load the snapshot (one bulk restore +
  one copy of the pool to the card instead of ~100k per-ticket
  re-registrations), then
  replay the journal tail in LSN order. Replay is idempotent: removal
  and matched records are keyed by ticket id and consumed exactly once;
  re-running a tail (double recovery, an untruncated overlap row) can
  never double-deliver a match or double-insert a ticket. Tickets whose
  match was formed but whose publish FAILED before the crash
  (`unpublished` records carry full payloads) are re-pooled so the
  restarted delivery loop re-dispatches them — matched-exactly-once or
  poolside, never lost, never published twice off the journal.

Durability window: a record is durable once its journal drain's group
commit resolves — exactly the storage engine's own durability unit.
Records buffered but not yet drained at a SIGKILL are lost with the
process; a crash harness (`chip_smoke.py`'s crash phase, the JAX
package's `bench.py --crash`) therefore acknowledges
tickets at the durable LSN, and the graceful-stop path flushes the
journal and writes a final checkpoint before exit so a clean SIGTERM
loses nothing at all.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import pickle
import time

from . import faults, overload
from . import tracing as trace_api

# Journal record ops. `matched` consumes tickets (ids only — the
# tickets are gone for good once their match published). `unpublished`
# carries FULL payloads: the match formed but its publish failed, so a
# restart must be able to rebuild the tickets and re-dispatch them even
# after their original `add` rows were truncated by a checkpoint.
OP_ADD = "add"
OP_REMOVE = "remove"
OP_MATCHED = "matched"
OP_UNPUBLISHED = "unpublished"

# One journal row, written or rewritten on its (node, lsn) key. An
# explicit upsert rather than INSERT OR REPLACE: the Postgres engine's
# dialect shim turns INSERT OR REPLACE into an upsert on the first
# column, and no constraint of this table is on `lsn` alone.
JOURNAL_UPSERT = (
    "INSERT INTO matchmaker_journal (lsn, op, payload, node, created_at)"
    " VALUES (?, ?, ?, ?, ?) ON CONFLICT (node, lsn) DO UPDATE SET"
    " op = EXCLUDED.op, payload = EXCLUDED.payload,"
    " created_at = EXCLUDED.created_at"
)

SNAPSHOT_VERSION = 1
# The checkpoint section of the leaderboard device boards.
LEADERBOARD_SECTION = "leaderboard_device"


def ticket_payload(ticket) -> dict:
    """JSON-able journal payload for one ticket (a `MatchmakerTicket`,
    or a `MatchmakerExtract`: the held-tickets file) — the
    MatchmakerExtract handover shape (types.py), which
    `payload_to_extract` inverts and `LocalMatchmaker.insert`
    re-registers."""
    presences = getattr(ticket, "presences", None)
    if presences is None:
        presences = [e.presence for e in ticket.entries]
    return {
        "ticket": ticket.ticket,
        "query": ticket.query,
        "min_count": ticket.min_count,
        "max_count": ticket.max_count,
        "count_multiple": ticket.count_multiple,
        "session_id": ticket.session_id,
        "party_id": ticket.party_id,
        "presences": [
            {
                "user_id": p.user_id,
                "session_id": p.session_id,
                "username": p.username,
                "node": p.node,
            }
            for p in presences
        ],
        "string_properties": dict(ticket.string_properties),
        "numeric_properties": dict(ticket.numeric_properties),
        "created_at": ticket.created_at,
        "intervals": int(ticket.intervals),
        "embedding": (
            None
            if ticket.embedding is None
            else [float(x) for x in ticket.embedding]
        ),
    }


def payload_to_extract(p: dict):
    """Inverse of `ticket_payload`: the MatchmakerExtract insert() takes."""
    import numpy as np

    from .matchmaker.types import MatchmakerExtract, MatchmakerPresence

    emb = p.get("embedding")
    return MatchmakerExtract(
        presences=[
            MatchmakerPresence(
                user_id=d["user_id"],
                session_id=d["session_id"],
                username=d.get("username", ""),
                node=d.get("node", ""),
            )
            for d in p["presences"]
        ],
        session_id=p["session_id"],
        party_id=p["party_id"],
        query=p["query"],
        min_count=p["min_count"],
        max_count=p["max_count"],
        count_multiple=p["count_multiple"],
        string_properties=dict(p["string_properties"]),
        numeric_properties=dict(p["numeric_properties"]),
        ticket=p["ticket"],
        created_at=p["created_at"],
        intervals=int(p.get("intervals", 0)),
        embedding=None if emb is None else np.asarray(emb, dtype=np.float32),
    )


class TicketJournal:
    """Append-only ticket journal over the group-commit write pipeline.

    Single-owner discipline: records are appended from the event loop
    (API add/remove paths, the interval/delivery stages) or from the
    single bench/test thread driving process() directly — never from
    worker threads — so the buffer needs no lock. Appends assign a
    client-side monotonic LSN (initialized past everything durable by
    `open()`); `durable_lsn` trails it by at most one drain.
    """

    def __init__(
        self,
        db,
        logger,
        node: str = "local",
        metrics=None,
        flush_max: int = 2048,
        buffer_cap: int = 65536,
    ):
        self._db = db
        self.logger = logger.with_fields(subsystem="recovery.journal")
        self.node = node
        self.metrics = metrics
        self.flush_max = max(1, flush_max)
        self.buffer_cap = max(self.flush_max, buffer_cap)
        self.enabled = True
        # Replay/restore suspension: recovery re-inserts tickets whose
        # records are already durable; journaling those again would
        # double them on the next replay.
        self.suspended = False
        self._lsn = 0
        self.durable_lsn = 0
        self._buf: list[tuple[int, str, object]] = []
        # Serializes _flush_once across the background drain task and
        # explicit flush() callers: both slice the buffer head, so two
        # interleaved passes would each delete len(batch) records and
        # the second deletion would discard never-written records.
        self._flush_lock: asyncio.Lock | None = None
        self._task: asyncio.Task | None = None
        self._resume_at = 0.0
        self._fail_streak = 0
        self.degraded = False
        # Ledger totals (tests/console/bench).
        self.appended = 0
        self.flushed = 0
        self.dropped = 0

    # ------------------------------------------------------------ record

    def record_add(self, ticket) -> int:
        # Lazy payload: the closure captures the (immutable-after-add)
        # ticket object; serialization happens at drain time in the
        # idle gap, so the add path pays one append.
        return self._append(OP_ADD, lambda t=ticket: ticket_payload(t))

    def record_remove(self, ticket_ids: list[str]) -> int:
        if not ticket_ids:
            return 0
        return self._append(OP_REMOVE, {"tickets": list(ticket_ids)})

    def record_matched(self, resolver) -> int:
        """`resolver()` -> iterable of ticket objects (the store's lazy
        removal snapshot); resolved at drain time, never on the interval
        path. The record's own LSN is the match's identity."""
        return self._append(
            OP_MATCHED,
            lambda r=resolver: {
                "tickets": [t.ticket for t in r() if t is not None]
            },
        )

    def record_unpublished(self, resolver) -> int:
        """A formed match whose publish FAILED: full payloads, so the
        restart can re-pool these tickets even after their add rows were
        checkpoint-truncated."""
        return self._append(
            OP_UNPUBLISHED,
            lambda r=resolver: {
                "tickets": [
                    ticket_payload(t) for t in r() if t is not None
                ]
            },
        )

    def _append(self, op: str, payload) -> int:
        if not self.enabled or self.suspended:
            return 0
        self._lsn += 1
        self._buf.append((self._lsn, op, payload))
        self.appended += 1
        if len(self._buf) > self.buffer_cap:
            # Bounded degraded-mode buffer: for add/remove/matched the
            # pool still holds (or a checkpoint will cover) the state,
            # so dropping the oldest loses journal tail, not tickets.
            # `unpublished` records are the exception — their tickets
            # exist NOWHERE else — so eviction skips them (their count
            # is bounded by real publish failures, not add volume).
            over = len(self._buf) - self.buffer_cap
            keep_tail = self._buf[over:]
            evictable = self._buf[:over]
            preserved = [
                r for r in evictable if r[1] == OP_UNPUBLISHED
            ]
            self.dropped += len(evictable) - len(preserved)
            self._buf = preserved + keep_tail
        if self.metrics is not None:
            try:
                self.metrics.mm_journal_records.labels(op=op).inc()
            except Exception:
                pass
        self._kick()
        return self._lsn

    def _kick(self) -> None:
        if self._task is not None and not self._task.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # sync context (bench/tests): buffer until flush()
        self._task = loop.create_task(self._drain())

    # ------------------------------------------------------------- drain

    async def _drain(self):
        # The drain task copies the context of the add that kicked it,
        # a socket envelope's included: its write units must not carry
        # that request's deadline, or a unit that waits it out in the
        # write queue is dropped and the journal degrades.
        overload.set_deadline(None)
        try:
            while self._buf and not self.suspended:
                if self._resume_at:
                    delay = self._resume_at - time.monotonic()
                    self._resume_at = 0.0
                    if delay > 0:
                        await asyncio.sleep(delay)
                if not await self._flush_once():
                    return  # degraded: wait for the next kick/flush
        finally:
            self._task = None

    async def _flush_once(self) -> bool:
        """Drain up to `flush_max` buffered records as ONE atomic write
        unit through the group-commit pipeline. True on success (or on
        an armed drop — the records are gone either way). Serialized:
        a checkpoint-barrier flush() and the background drain must not
        interleave over the same buffer head."""
        if self._flush_lock is None:
            self._flush_lock = asyncio.Lock()
        async with self._flush_lock:
            return await self._flush_once_locked()

    async def _flush_once_locked(self) -> bool:
        if not self._buf:
            return True
        batch = self._buf[: self.flush_max]
        now = time.time()
        rows = []
        for lsn, op, payload in batch:
            if callable(payload):
                try:
                    payload = payload()
                except Exception as e:
                    # A resolver that dies (freed snapshot) must not
                    # poison the whole drain; the record degrades to a
                    # marker so replay skips it.
                    payload = {"tickets": [], "error": str(e)}
            rows.append(
                (
                    lsn,
                    op,
                    json.dumps(payload, separators=(",", ":")),
                    self.node,
                    now,
                )
            )
        try:
            if faults.fire("journal.append"):
                # drop-mode chaos: the batch is torn away (simulated
                # lost write) — journaling continues from the next
                # record; the tickets stay pool-covered for the next
                # checkpoint.
                del self._buf[: len(batch)]
                self.dropped += len(batch)
                self.logger.warn(
                    "journal batch dropped (fault armed)",
                    records=len(batch),
                )
                return True
            # An upsert on the (node, lsn) key: a degraded retry whose
            # earlier commit actually landed (drain crashed post-commit)
            # re-runs idempotently instead of erroring on the key.
            await self._db.execute_many(JOURNAL_UPSERT, rows)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._note_degraded(e)
            return False
        del self._buf[: len(batch)]
        self.flushed += len(batch)
        self.durable_lsn = max(self.durable_lsn, batch[-1][0])
        self._fail_streak = 0
        if self.degraded:
            self.degraded = False
            self.logger.info(
                "journal healed; durable again",
                durable_lsn=self.durable_lsn,
            )
        if self.metrics is not None:
            try:
                self.metrics.mm_journal_lsn.set(self.durable_lsn)
                self.metrics.mm_journal_degraded.set(0)
            except Exception:
                pass
        return True

    def _note_degraded(self, exc: Exception) -> None:
        self._fail_streak += 1
        if not self.degraded:
            # WARN once per outage, not per retry — the ladder
            # convention: loud transition, quiet steady state.
            self.logger.warn(
                "journal write failed; degrading to in-memory-only"
                " (tickets stay pool-covered until the next checkpoint)",
                error=str(exc),
                buffered=len(self._buf),
            )
        self.degraded = True
        self._resume_at = time.monotonic() + min(
            5.0, 0.25 * (2.0 ** min(self._fail_streak, 5))
        )
        if self.metrics is not None:
            try:
                self.metrics.mm_journal_degraded.set(1)
            except Exception:
                pass

    async def flush(self) -> bool:
        """Drain everything buffered now (graceful stop / checkpoint
        barrier). One pass over the buffer — a degraded journal returns
        False instead of spinning on a dead engine."""
        # Let an in-flight drain finish its current unit first.
        task = self._task
        if task is not None and not task.done():
            try:
                await task
            except Exception:
                pass
        while self._buf:
            if not await self._flush_once():
                return False
        return True

    # ----------------------------------------------------------- recovery

    async def open(self) -> int:
        """Initialize the LSN counter past everything durable (journal
        rows AND the checkpoint pointer — a truncated journal must not
        reissue covered LSNs)."""
        row = await self._db.fetch_one(
            "SELECT MAX(lsn) AS lsn FROM matchmaker_journal"
            " WHERE node = ?",
            (self.node,),
        )
        jl = int(row["lsn"]) if row and row["lsn"] is not None else 0
        row = await self._db.fetch_one(
            "SELECT lsn FROM matchmaker_checkpoint WHERE node = ?",
            (self.node,),
        )
        cl = int(row["lsn"]) if row and row["lsn"] is not None else 0
        self._lsn = max(self._lsn, jl, cl)
        self.durable_lsn = max(self.durable_lsn, jl)
        return self._lsn

    async def load_tail(self, after_lsn: int) -> list[dict]:
        return await self._db.fetch_all(
            "SELECT lsn, op, payload FROM matchmaker_journal"
            " WHERE node = ? AND lsn > ? ORDER BY lsn",
            (self.node, after_lsn),
        )

    def reserve_lsn(self) -> int:
        """Claim the next LSN for a record written OUTSIDE the buffered
        drain (recovery settlement writes its own atomic unit)."""
        self._lsn += 1
        return self._lsn

    @property
    def lsn(self) -> int:
        return self._lsn

    @property
    def pending(self) -> int:
        return len(self._buf)

    def stats(self) -> dict:
        return {
            "lsn": self._lsn,
            "durable_lsn": self.durable_lsn,
            "pending": len(self._buf),
            "appended": self.appended,
            "flushed": self.flushed,
            "dropped": self.dropped,
            "degraded": self.degraded,
        }


class Checkpointer:
    """Periodic pool snapshots in the interval idle gap, truncating the
    journal so replay stays bounded. Failure is always survivable: a
    failed snapshot (disk, injected `checkpoint.write`) WARNs and
    leaves the previous checkpoint + full journal tail in place."""

    def __init__(
        self,
        journal: TicketJournal,
        db,
        path: str,
        logger,
        node: str = "local",
        metrics=None,
        interval_sec: float = 60.0,
    ):
        self.journal = journal
        self._db = db
        self.path = path
        self.logger = logger.with_fields(subsystem="recovery.checkpoint")
        self.node = node
        self.metrics = metrics
        self.interval_sec = max(1.0, float(interval_sec))
        # Anchored at construction so the FIRST checkpoint also waits
        # a full interval — short-lived servers (tests, probes) must
        # not write a snapshot in their first idle gap.
        self._last = time.monotonic()
        self._running = False
        # Optional async pre-hook awaited at the top of checkpoint()
        # (the RecoveryPlane retries failed unpublished-row settlement
        # here, so a stale row is reconciled before the truncation that
        # would otherwise preserve it forever).
        self.pre_hook = None
        # The leaderboard `DeviceRankEngine` whose board columns ride
        # every checkpoint as its `leaderboard_device` section (the JAX
        # package's name and shape), snapshot inline with the pool so
        # the two agree; None writes no section. A failing snapshot is
        # logged and the section skipped — never the whole checkpoint.
        self.rank_engine = None
        self.checkpoints = 0  # ledger total (tests/console)
        self.last_lsn = 0

    def due(self) -> bool:
        return (
            not self._running
            and time.monotonic() - self._last >= self.interval_sec
        )

    async def maybe_checkpoint(self, mm) -> dict | None:
        if not self.due():
            return None
        return await self.checkpoint(mm)

    async def checkpoint(self, mm) -> dict | None:
        """One checkpoint round: journal barrier -> consistent snapshot
        -> fsync'd atomic file write -> pointer row + journal truncation
        as one atomic write unit. Returns stats, or None on failure
        (logged, counted). An error from the card while the pool is
        read back raises (faults.from_card): the port hides none."""
        self._last = time.monotonic()
        self._running = True
        t0 = time.perf_counter()
        try:
            if self.pre_hook is not None:
                try:
                    await self.pre_hook()
                except Exception:
                    pass  # the hook owns its own logging
            # Barrier first so the truncation below covers everything
            # buffered; a degraded journal is fine — records that stay
            # buffered are reflected in the snapshot (appends are
            # synchronous with their pool mutations) and their late-
            # arriving rows fall at or below the checkpoint LSN, which
            # replay skips.
            await self.journal.flush()
            if faults.fire("checkpoint.write"):
                # drop-mode chaos: this checkpoint round is discarded —
                # the previous checkpoint + journal tail stay
                # authoritative, exactly like a failed write. The fault
                # sits AFTER the journal barrier because it models the
                # snapshot write failing: the flush it barriers on is
                # real either way, so the surviving journal tail is
                # durable, not buffered.
                self.logger.warn("checkpoint dropped (fault armed)")
                if self.metrics is not None:
                    try:
                        self.metrics.mm_checkpoints.labels(
                            outcome="failed"
                        ).inc()
                    except Exception:
                        pass
                return None
            # No await between the LSN capture and the snapshot: the
            # pair must be consistent (every op <= lsn reflected, none
            # above it), and both run on the event loop the mutations
            # run on.
            lsn = self.journal.lsn
            t_snap = time.perf_counter()
            snap = mm.snapshot_state()
            snapshot_s = time.perf_counter() - t_snap
            snap["version"] = SNAPSHOT_VERSION
            snap["journal_lsn"] = lsn
            snap["node"] = self.node
            if self.rank_engine is not None:
                snap["extras"] = {}
                try:
                    snap["extras"][LEADERBOARD_SECTION] = (
                        self.rank_engine.snapshot_state()
                    )
                except Exception as e:
                    if faults.from_card(e):
                        raise
                    self.logger.warn(
                        "checkpoint extra section failed; skipped",
                        section=LEADERBOARD_SECTION, error=str(e),
                    )
            tickets = int(snap.get("tickets_total", 0))
            path, tmp = self.path, self.path + ".tmp"

            def _write():
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                with open(tmp, "wb") as fh:
                    pickle.dump(snap, fh, protocol=pickle.HIGHEST_PROTOCOL)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
                return os.path.getsize(path)

            # The pickle + fsync runs off-loop: at 100k tickets the blob
            # is tens of MB and the event loop must keep serving.
            t_write = time.perf_counter()
            size = await asyncio.to_thread(_write)
            t_commit = time.perf_counter()
            write_s = t_commit - t_write
            await self._db.submit_write(
                [
                    (
                        "INSERT OR REPLACE INTO matchmaker_checkpoint"
                        " (node, lsn, path, tickets, created_at)"
                        " VALUES (?, ?, ?, ?, ?)",
                        (self.node, lsn, path, tickets, time.time()),
                    ),
                    (
                        # `unpublished` rows are the one record class a
                        # snapshot can never cover — their tickets left
                        # the pool when the match formed, so the journal
                        # row is the ONLY copy. Truncation must keep
                        # them; recovery re-journals the re-pooled
                        # tickets as fresh adds and only then deletes
                        # the consumed rows.
                        "DELETE FROM matchmaker_journal"
                        " WHERE node = ? AND lsn <= ?"
                        " AND op != 'unpublished'",
                        (self.node, lsn),
                    ),
                ]
            )
            commit_s = time.perf_counter() - t_commit
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if faults.from_card(e):
                raise
            self.logger.warn(
                "checkpoint failed; previous checkpoint + journal tail"
                " remain authoritative",
                error=str(e),
            )
            if self.metrics is not None:
                try:
                    self.metrics.mm_checkpoints.labels(
                        outcome="failed"
                    ).inc()
                except Exception:
                    pass
            return None
        finally:
            self._running = False
        dt = time.perf_counter() - t0
        self.checkpoints += 1
        self.last_lsn = lsn
        if self.metrics is not None:
            try:
                self.metrics.mm_checkpoints.labels(outcome="ok").inc()
                self.metrics.mm_checkpoint_lsn.set(lsn)
            except Exception:
                pass
        self.logger.info(
            "checkpoint written",
            lsn=lsn,
            tickets=tickets,
            bytes=size,
            duration_ms=round(dt * 1000, 1),
        )
        return {
            "lsn": lsn,
            "tickets": tickets,
            "bytes": size,
            "duration_s": dt,
            # The split (the port's addition): the event loop is held
            # for snapshot_s; write_s (pickle + fsync + rename) runs off
            # it; commit_s is the pointer row + truncation unit.
            "snapshot_s": snapshot_s,
            "write_s": write_s,
            "commit_s": commit_s,
        }


async def recover(
    mm, db, path: str, node: str, logger, journal=None, rank_engine=None
) -> dict:
    """Warm restart: snapshot load + journal-tail replay + the pool's
    copy to the card, in LSN order, idempotent. Returns recovery stats.
    A storage failure degrades to whatever earlier phases recovered
    (worst case a cold empty pool), logged loudly; an error from the
    card raises (faults.from_card), so no node serves a pool it could
    not put on the card. `rank_engine`, when given, restores the
    checkpoint's `leaderboard_device` section right after the pool
    (None when the checkpoint has none), before the leaderboards'
    database load."""
    import gc

    # Restore allocates ~5 objects per ticket in one burst; automatic
    # generational GC passes over that growing heap measured 3x the
    # whole thaw (the same effect the interval loop's gen2 threshold
    # push guards against). Nothing allocated here is garbage — pause
    # collection for the duration, no final collect (the boot path's
    # steady-state GC picks up from here). try/finally: a cancellation
    # escaping the awaits must not leave the process with collection
    # off forever.
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        return await _recover_impl(
            mm, db, path, node, logger, journal, rank_engine
        )
    finally:
        if gc_was_enabled:
            gc.enable()


async def _recover_impl(
    mm, db, path, node, logger, journal, rank_engine=None
) -> dict:
    t0 = time.perf_counter()
    log = logger.with_fields(subsystem="recovery")
    out = {
        "checkpoint_lsn": 0,
        "checkpoint_tickets": 0,
        "replayed_rows": 0,
        "reinserted": 0,
        "removed": 0,
        "repooled_unpublished": 0,
        "tickets": 0,
        "duration_s": 0.0,
        # The split (the port's addition): pointer read, snapshot load
        # (unpickle, off the loop), restore_state (the pool's copy to
        # the card included), journal-tail replay.
        "pointer_s": 0.0,
        "load_s": 0.0,
        "restore_s": 0.0,
        "replay_s": 0.0,
    }
    ckpt_lsn = 0
    try:
        row = await db.fetch_one(
            "SELECT lsn, path, tickets FROM matchmaker_checkpoint"
            " WHERE node = ?",
            (node,),
        )
    except Exception as e:
        log.warn("checkpoint pointer unreadable; journal-only replay",
                 error=str(e))
        row = None
    t1 = time.perf_counter()
    out["pointer_s"] = t1 - t0
    if row is not None:
        try:
            snap = await asyncio.to_thread(_load_snapshot, row["path"])
            t2 = time.perf_counter()
            out["load_s"] = t2 - t1
            mm.restore_state(snap)
            out["restore_s"] = time.perf_counter() - t2
            ckpt_lsn = int(row["lsn"])
            out["checkpoint_lsn"] = ckpt_lsn
            out["checkpoint_tickets"] = len(mm.store)
            # The leaderboard device boards, fenced on their own: a bad
            # section costs the rank engine its warm start, never the
            # pool's.
            if rank_engine is not None:
                try:
                    rank_engine.restore_state(
                        snap.get("extras", {}).get(LEADERBOARD_SECTION)
                    )
                except Exception as e:
                    if faults.from_card(e):
                        raise
                    log.warn(
                        "extra checkpoint section restore failed",
                        section=LEADERBOARD_SECTION, error=str(e),
                    )
        except Exception as e:
            if faults.from_card(e):
                raise
            # Snapshot-covered tickets whose journal rows were truncated
            # are unrecoverable here — say so loudly instead of booting
            # silently empty; the journal tail still replays below.
            log.error(
                "checkpoint snapshot load failed; replaying the full"
                " journal (snapshot-only tickets are lost)",
                error=str(e),
                path=row["path"],
            )
            ckpt_lsn = 0
    unpub_lsns: list[int] = []
    repooled_ids: set[str] = set()
    t_replay = time.perf_counter()
    try:
        if faults.fire("journal.replay"):
            # drop-mode chaos: the tail replay is discarded — the boot
            # continues on the snapshot alone, degraded and loud.
            log.warn("journal replay dropped (fault armed)")
            rows = []
        else:
            # The tail past the checkpoint, PLUS every surviving
            # `unpublished` row regardless of LSN (truncation preserves
            # them — see Checkpointer). LSN order keeps replay causal:
            # an unpublished row's re-add is consumed by any later
            # matched / remove record before it ever touches the store.
            rows = await db.fetch_all(
                "SELECT lsn, op, payload FROM matchmaker_journal"
                " WHERE node = ? AND (lsn > ? OR op = 'unpublished')"
                " ORDER BY lsn",
                (node, ckpt_lsn),
            )
        out["replayed_rows"] = len(rows)
        # Pending adds not yet applied to the pool; removal/matched
        # records consume them before they ever touch the store, so a
        # ticket that lived and died inside the tail costs two dict ops.
        pending: dict[str, dict] = {}

        def _consume(tids: list[str]):
            direct = [t for t in tids if t not in pending]
            for t in tids:
                pending.pop(t, None)
            if direct:
                # Already in the restored pool (snapshot-covered): a
                # plain id-keyed removal, no-op for unknown ids — which
                # is exactly what makes replay idempotent.
                mm.remove(direct)
                out["removed"] += len(direct)

        for r in rows:
            op = r["op"]
            try:
                payload = json.loads(r["payload"])
            except (TypeError, ValueError):
                continue  # torn row: skip, never wedge the boot
            if op == OP_ADD:
                pending[payload["ticket"]] = payload
            elif op in (OP_REMOVE, OP_MATCHED):
                _consume([t for t in payload.get("tickets", ())])
            elif op == OP_UNPUBLISHED:
                # Formed-but-unpublished match: re-pool its tickets so
                # the restarted delivery loop re-dispatches them. Keyed
                # by ticket id — replaying twice re-pools once, and a
                # stale row whose tickets a snapshot already covers is
                # absorbed by insert()'s duplicate guard.
                unpub_lsns.append(int(r["lsn"]))
                for p in payload.get("tickets", ()):
                    pending[p["ticket"]] = p
                    repooled_ids.add(p["ticket"])
        if pending:
            extracts = []
            for p in pending.values():
                try:
                    extracts.append(payload_to_extract(p))
                except Exception as e:
                    log.warn(
                        "journal replay: dropping malformed payload",
                        error=str(e),
                    )
            mm.insert(extracts)
            out["reinserted"] = len(extracts)
        out["repooled_unpublished"] = len(repooled_ids)
    except Exception as e:
        if faults.from_card(e):
            raise
        log.error(
            "journal replay failed; continuing with what recovered",
            error=str(e),
        )
    out["replay_s"] = time.perf_counter() - t_replay
    out["unpublished_lsns"] = unpub_lsns
    out["repooled_ids"] = sorted(repooled_ids)
    if journal is not None:
        try:
            await journal.open()
        except Exception as e:
            log.warn("journal LSN probe failed", error=str(e))
    out["tickets"] = len(mm.store)
    out["duration_s"] = time.perf_counter() - t0
    return out


def _load_snapshot(path: str) -> dict:
    with open(path, "rb") as fh:
        snap = pickle.load(fh)
    if snap.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot version {snap.get('version')} !="
            f" {SNAPSHOT_VERSION}"
        )
    return snap


class HeldTickets:
    """The tickets a graceful stop keeps for its connected players.

    A difference from the JAX package, whose stop removes every
    connected session's tickets. The stop tells its players to come
    back (close 1012 with Retry-After), names their tickets in a file
    beside the checkpoint (`save`), and the final checkpoint keeps
    them. The next start takes the named tickets out of the pool
    (`load`), so no live player is matched with a player who is not
    there, and hands each back to its user's next session (`reown`),
    under that session's id and within `max_tickets`, so its match
    reaches the player. What no player claims within the window is
    dropped (`release`).

    The file holds each ticket's whole payload and, once a start has
    begun the hold, the hold's end (wall clock). It stays on disk until
    every ticket it names has been reowned or released, and is
    rewritten as they go, so a crash during the hold loses none: the
    restart holds the same tickets again, taken from the pool where the
    journal still has them and rebuilt from the file where it does not,
    for what remains of the window. Tickets recovered after a crash
    that no graceful stop named are not held, as in the JAX package."""

    def __init__(self, matchmaker, path: str, logger):
        self.matchmaker = matchmaker
        self.path = path
        self.logger = logger
        self._by_user: dict[str, list] = {}
        # Wall-clock end of the hold; None until a start begins it.
        self.until: float | None = None

    def __len__(self) -> int:
        return sum(len(v) for v in self._by_user.values())

    def ticket_ids(self) -> set[str]:
        return {ex.ticket for v in self._by_user.values() for ex in v}

    def _write(self, entries: dict) -> None:
        """Rewrite the file atomically; remove it when nothing is left."""
        if not entries:
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"until": self.until, "tickets": entries}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def _persist(self) -> None:
        self._write({
            ex.ticket: {"user": user, "payload": ticket_payload(ex)}
            for user, v in self._by_user.items() for ex in v
        })

    def save(self, sessions) -> int:
        """At stop, after the matchmaker stopped and before the sessions
        close: unclaimed held tickets go back to the pool, and the file
        names them and every open session's tickets by user."""
        mm = self.matchmaker
        named = {
            ex.ticket: user for user, v in self._by_user.items() for ex in v
        }
        mm.insert([ex for v in self._by_user.values() for ex in v])
        self._by_user.clear()
        for session in sessions:
            for t in mm.store.session_tickets(session.id):
                named[t.ticket] = session.user_id
        self.until = None
        self._write({
            ex.ticket: {"user": named[ex.ticket],
                        "payload": ticket_payload(ex)}
            for ex in mm.extract(list(named))
        })
        return len(named)

    def load(self, window_s: float) -> int:
        """At start, after the warm restart: hold the named tickets by
        user — taken out of the pool (a journaled removal) where it has
        them, rebuilt from the file where it does not — until the end of
        the hold (`window_s` from a graceful stop's file; what remains
        of it after a crash during the hold). A hold that already ended
        drops them."""
        try:
            with open(self.path) as fh:
                named = json.load(fh)
        except FileNotFoundError:
            return 0
        until = named.get("until")
        self.until = time.time() + window_s if until is None else until
        entries = named.get("tickets", {})
        mm = self.matchmaker
        if self.until <= time.time():
            mm.remove(list(entries))
            self.until = None
            self._write({})
            return 0
        pooled = {ex.ticket: ex for ex in mm.extract(list(entries))}
        for tid, entry in entries.items():
            ex = pooled.get(tid) or payload_to_extract(entry["payload"])
            self._by_user.setdefault(entry["user"], []).append(ex)
        # The file first: a crash between the two steps finds the
        # tickets in the pool and holds them again.
        self._persist()
        mm.remove(list(pooled))
        return len(self)

    def remaining_s(self) -> float:
        """Seconds left in the hold (0 when none is running)."""
        if self.until is None:
            return 0.0
        return max(0.0, self.until - time.time())

    def reown(self, session) -> int:
        """A session of a user whose tickets are held: they return to
        the pool under this session's id, as far as `max_tickets` lets
        `add` take them (per session and per party); the rest are
        dropped, so the client that adds again meets its quota as it
        would have without the restart."""
        held = self._by_user.pop(session.user_id, None)
        if not held:
            return 0
        mm = self.matchmaker
        max_tickets = mm.config.max_tickets
        back = 0
        for ex in held:
            ex.session_id = session.id
            ex.presences = [
                dataclasses.replace(p, session_id=session.id)
                if p.user_id == session.user_id
                else p
                for p in ex.presences
            ]
            if mm.store.session_ticket_count(session.id) >= max_tickets or (
                ex.party_id
                and mm.store.party_ticket_count(ex.party_id) >= max_tickets
            ):
                self.logger.info(
                    "held ticket dropped: its player is at max_tickets",
                    user_id=session.user_id, ticket=ex.ticket,
                )
                continue
            mm.insert([ex])
            back += 1
        self._persist()
        self.logger.info(
            "held tickets returned to their player",
            user_id=session.user_id,
            tickets=back,
        )
        return back

    def release(self) -> None:
        """The hold's window ended: drop what no player claimed."""
        if self._by_user:
            self.logger.info(
                "held tickets released unclaimed", tickets=len(self)
            )
        self._by_user.clear()
        self.until = None
        self._write({})


class RecoveryPlane:
    """Server-facing wiring: builds the journal + checkpointer from
    config, attaches them to the matchmaker, and owns the warm-restart
    and drain-to-durable shutdown entry points."""

    def __init__(
        self, config, db, matchmaker, logger, metrics=None,
        node: str = "local", data_dir: str = "./data",
    ):
        # `config` is the port's RecoveryConfig; the JAX package's plane
        # takes the whole server Config and reads `.recovery` and
        # `.data_dir` from it (the port's server config is a later
        # slice, so `data_dir` comes as its own argument).
        rc = config
        self.config = config
        self.db = db
        self.matchmaker = matchmaker
        self.logger = logger.with_fields(subsystem="recovery")
        self.metrics = metrics
        self.node = node
        base = rc.recovery_dir or data_dir
        self.path = os.path.join(base, f"{node}-matchmaker.ckpt")
        self.journal = TicketJournal(
            db,
            logger,
            node=node,
            metrics=metrics,
            flush_max=rc.journal_flush_max,
            buffer_cap=rc.journal_buffer_cap,
        )
        self.journal.enabled = bool(rc.journal)
        self.checkpointer = Checkpointer(
            self.journal,
            db,
            self.path,
            logger,
            node=node,
            metrics=metrics,
            interval_sec=rc.checkpoint_interval_sec,
        )
        matchmaker.journal = self.journal
        matchmaker.checkpointer = self.checkpointer
        # Failed unpublished-row settlement retries on the checkpoint
        # cadence: the stale row must be reconciled before a truncation
        # round would preserve it past its tickets' republication.
        self._unsettled: dict | None = None
        self.checkpointer.pre_hook = self._retry_settlement
        self.held = HeldTickets(
            matchmaker,
            os.path.join(base, f"{node}-held-tickets.json"),
            self.logger,
        )

    async def recover(self) -> dict:
        """Warm restart before the matchmaker starts: rebuild the pool
        from snapshot + journal tail. Journaling is suspended for the
        duration — replayed tickets' records are already durable."""
        self.journal.suspended = True
        try:
            with trace_api.root_span(
                "recovery.warm_restart", node=self.node
            ):
                stats = await recover(
                    self.matchmaker,
                    self.db,
                    self.path,
                    self.node,
                    self.logger,
                    journal=self.journal,
                    rank_engine=self.checkpointer.rank_engine,
                )
        finally:
            self.journal.suspended = False
        await self._settle_unpublished(stats)
        if self.metrics is not None:
            try:
                self.metrics.mm_recovery_duration.set(stats["duration_s"])
                self.metrics.mm_recovery_tickets.set(stats["tickets"])
            except Exception:
                pass
        if stats["tickets"] or stats["replayed_rows"]:
            self.logger.info(
                "warm restart recovered matchmaker state",
                tickets=stats["tickets"],
                checkpoint_lsn=stats["checkpoint_lsn"],
                replayed_rows=stats["replayed_rows"],
                repooled_unpublished=stats["repooled_unpublished"],
                duration_ms=round(stats["duration_s"] * 1000, 1),
            )
        return stats

    async def _settle_unpublished(self, stats: dict) -> None:
        """Consume the `unpublished` rows replay re-pooled: re-journal
        the tickets as fresh ADD records (they are ordinary pool
        members again) and delete the old rows — as ONE atomic write
        unit, so no failure ordering can leave a stale unpublished row
        alongside durable re-adds (that stale row would survive every
        later truncation and re-pool an already-republished cohort
        after a future crash). A crash before the unit commits replays
        the old rows; after, the new adds — either way idempotent,
        never doubled."""
        lsns = stats.get("unpublished_lsns") or []
        if not lsns or not self.journal.enabled:
            return
        store = self.matchmaker.store
        now = time.time()
        stmts = []
        top_lsn = 0
        for tid in stats.get("repooled_ids", ()):
            t = store.get(tid)
            if t is None:
                continue
            top_lsn = self.journal.reserve_lsn()
            stmts.append(
                (
                    JOURNAL_UPSERT,
                    (
                        top_lsn,
                        OP_ADD,
                        json.dumps(
                            ticket_payload(t), separators=(",", ":")
                        ),
                        self.node,
                        now,
                    ),
                )
            )
        marks = ",".join("?" for _ in lsns)
        stmts.append(
            (
                "DELETE FROM matchmaker_journal"
                f" WHERE node = ? AND lsn IN ({marks})",
                (self.node, *lsns),
            )
        )
        try:
            await self.db.submit_write(stmts)
            if top_lsn:
                self.journal.durable_lsn = max(
                    self.journal.durable_lsn, top_lsn
                )
            self._unsettled = None
        except Exception as e:
            # Remember the unit for the checkpoint-cadence retry: left
            # unreconciled, the stale row would survive truncation and
            # could re-pool an already-republished cohort after a
            # LATER crash.
            self._unsettled = {
                "unpublished_lsns": list(lsns),
                "repooled_ids": list(stats.get("repooled_ids", ())),
            }
            self.logger.warn(
                "unpublished-row settlement failed; will retry on the"
                " checkpoint cadence",
                error=str(e),
            )

    async def _retry_settlement(self) -> None:
        if self._unsettled is not None:
            await self._settle_unpublished(self._unsettled)

    async def shutdown(self, final_checkpoint: bool = True) -> None:
        """Drain-to-durable tail of a graceful stop: flush the journal,
        then write one final checkpoint so the next boot replays
        nothing. A pristine plane (no tickets ever journaled or
        checkpointed) skips the file write entirely — short-lived
        servers (tests, probes) must not litter data_dir with empty
        snapshots."""
        try:
            await self.journal.flush()
        except Exception as e:
            self.logger.warn("shutdown journal flush failed", error=str(e))
        dirty = (
            len(self.matchmaker.store)
            or self.journal.lsn
            or self.checkpointer.checkpoints
        )
        if final_checkpoint and dirty:
            try:
                await self.checkpointer.checkpoint(self.matchmaker)
            except Exception as e:
                self.logger.warn(
                    "shutdown checkpoint failed", error=str(e)
                )
            # The checkpoint may run after matchmaker.stop()'s
            # wait_idle already joined the backend's worker threads:
            # join whatever it started too before the process exits.
            wait_idle = getattr(
                self.matchmaker.backend, "wait_idle", None
            )
            if wait_idle is not None:
                wait_idle(timeout=10.0)

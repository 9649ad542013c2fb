"""Async database engine over SQLite.

The port's copy of the JAX package's `storage/db.py`: the same engine
(WAL, one `BEGIN IMMEDIATE … COMMIT` per drained batch, per-unit
SAVEPOINTs, zero-row guards, supervised drains), over the port's own
`faults`, `overload` and `tracing` modules. What follows is that
module's description.

Plays the role of the reference's connection manager (reference
server/db.go:35 DbConnect: multi-DSN connect, ping, version probe) for an
embedded engine. Writes and transactions run on ONE dedicated executor
thread (the writer connection lives on that thread only) and transactions
hold an asyncio lock for their duration — the same serialised-writer
discipline the reference gets from Postgres transactions.

Reads scale past the writer thread (the reference's pgx pool
db.go:35): WAL mode permits any number of readers concurrent with the
single writer, so file-backed databases get a pool of read-only
connections — one per reader thread — and non-transactional fetch_one /
fetch_all run there WITHOUT the writer lock. WAL readers observe the
last committed snapshot, so a fetch never sees another task's open
transaction; read-your-committed-writes holds because every write path
commits before returning. `:memory:` databases (tests) cannot share
state across connections and quietly keep the single-threaded path.
Concurrent pool fetches are COALESCED (ReadCoalescer): the dominant
cost of a sub-ms WAL read is the asyncio→thread round trip, so a chunk
of queued fetches shares one executor hop per reader thread.

Group-commit write pipeline (the batched write surface the reference
leans on Postgres' batched WAL flush for, server/db.go:35): concurrent
auto-commit writes — ``execute``, ``execute_many``, ``submit_write`` —
are enqueued as atomic UNITS and drained by the writer thread in
batches, one ``BEGIN IMMEDIATE … COMMIT`` per drain. Each unit runs
inside its own SAVEPOINT so a failing statement rolls back only its own
unit (the rest of the batch commits untouched) and its error surfaces
to exactly the caller that enqueued it. A unit statement may be marked
as a GUARD: if a guarded statement matches zero rows, the whole unit is
rolled back to its savepoint and the caller gets `WriteConflictError` —
the seam optimistic-concurrency callers (wallet, leaderboard) retry on.
Per-call futures resolve only after the shared COMMIT, so durability
and read-your-committed-writes semantics are exactly the per-commit
path's. Explicit ``tx()`` blocks still take the exclusive writer lock;
the batcher drains and parks while a transaction is open.

Durability semantics: the engine runs WAL mode with synchronous=NORMAL,
so the atomicity unit a crash preserves is the COMMIT — with group
commit, one commit covers a whole batch, so after a crash either every
unit of a group is visible or none of it is (commit-batch atomicity).
A resolved await is therefore "committed to the WAL" exactly as before;
group commit changes only how many logical writes share that commit.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import sqlite3
import threading
import time
from typing import Any, Iterable, Sequence

from .. import faults, overload
from .. import tracing as trace_api
from ..faults import jittered_backoff
from .migrations import MIGRATIONS

READ_POOL_SIZE = 4
READ_BATCH_MAX = 64
WRITE_BATCH_MAX = 256
WRITE_QUEUE_DEPTH = 4096
WRITE_DRAIN_DEADLINE_MS = 0
# Self-healing drain supervision (module docstring + faults.py): a
# crashed drain loop fails its pending futures and restarts with
# full-jitter backoff in [0, base*2^n] capped at DRAIN_BACKOFF_MAX_S;
# after DB_DRAIN_RESTART_MAX consecutive crashes the batcher fails
# fast (submits rejected) until a reconnect builds a fresh one.
DB_DRAIN_RESTART_MAX = 8
DRAIN_BACKOFF_BASE_S = 0.02
DRAIN_BACKOFF_MAX_S = 1.0
# Retry budget the optimistic-concurrency callers of the guarded write
# surface (wallet, storage, leaderboard) share before falling back to
# their exclusive-transaction paths (guaranteed progress).
OCC_RETRIES = 8


class DatabaseError(Exception):
    pass


class WriteConflictError(DatabaseError):
    """A guarded statement in a batched write unit matched no rows; the
    unit was rolled back to its savepoint and nothing from it committed.
    Optimistic-concurrency callers re-read and retry on this."""


class _WriteUnit:
    __slots__ = ("stmts", "guards", "future", "deadline", "trace")

    def __init__(self, stmts, guards, future, deadline=None, trace=None):
        self.stmts = stmts
        self.guards = guards
        self.future = future
        # The submitting request's overload.Deadline (None when the
        # caller carries none): the drain drops the unit instead of
        # committing a write nobody is waiting for.
        self.deadline = deadline
        # The submitting request's (trace_id, span_id), if it ran
        # inside an active trace: the group-commit span records every
        # batched unit as a span link, so "which requests shared this
        # commit" reads off one span.
        self.trace = trace


class _GroupAborted(Exception):
    """A failing statement took the WHOLE group transaction down with it
    (SQLITE_FULL/IOERR/NOMEM auto-rollback), not just its savepoint —
    nothing committed, so the batch re-runs unit-by-unit."""


class WriteBatcher:
    """Engine-agnostic group-commit queue.

    FIFO pending units, one lazily-spawned drainer task per burst. The
    drainer takes the owning engine's writer lock once per batch, hands
    the batch to ``db._run_write_group(units)`` (the SQLite engine
    executes it on the writer thread), and resolves each unit's future
    after the shared commit. Backpressure: a bounded semaphore caps queued
    units; submitters park when the queue is full.
    """

    def __init__(self, db, batch_max: int, queue_depth: int,
                 drain_deadline_ms: int,
                 drain_restart_max: int = DB_DRAIN_RESTART_MAX):
        self._db = db
        self.batch_max = max(1, batch_max)
        self.queue_depth = max(1, queue_depth)
        self.drain_deadline_s = max(0, drain_deadline_ms) / 1000.0
        self.drain_restart_max = max(0, drain_restart_max)
        self._queue: collections.deque[_WriteUnit] = collections.deque()
        self._sem = asyncio.Semaphore(self.queue_depth)
        self._drain_task: asyncio.Task | None = None
        # Self-healing supervision state: the batch the drainer popped
        # but has not yet resolved (a crash must fail these futures, not
        # abandon them), the consecutive-crash streak, the earliest
        # moment a restarted drainer may run (jittered backoff), and the
        # fail-fast latch once the restart budget is exhausted.
        self._inflight: list[_WriteUnit] | None = None
        self._crash_streak = 0
        self._resume_at = 0.0
        self._broken = False
        self.drain_restarts = 0  # ledger total (tests/bench)
        # Observability (read by bench.py and exported via bound Metrics).
        # units_committed counts only units whose results were OK —
        # guard-conflicted/failed units rolled back to their savepoints
        # land in units_conflicted instead, so committed throughput is
        # not overstated exactly when contention is high.
        self.group_commits = 0
        self.units_committed = 0
        self.units_conflicted = 0
        self.units_expired = 0  # deadline-dropped before execution
        self.batch_size_counts: collections.Counter = collections.Counter()

    def stats(self) -> dict:
        return {
            "group_commits": self.group_commits,
            "units_committed": self.units_committed,
            "units_conflicted": self.units_conflicted,
            "units_expired": self.units_expired,
            "batch_sizes": dict(self.batch_size_counts),
            "drain_restarts": self.drain_restarts,
        }

    @property
    def depth(self) -> int:
        return len(self._queue)

    async def write_unit(self, stmts, guards) -> list[int]:
        """Engine-facing entry for one atomic write unit: a group-commit
        submit."""
        if not self._db._connected():
            raise DatabaseError("database not connected")
        if guards is None:
            guards = (False,) * len(stmts)
        return await self.submit(stmts, guards)

    async def submit(self, stmts, guards) -> list[int]:
        if self._broken:
            raise DatabaseError(
                "write pipeline disabled after repeated drain crashes;"
                " reconnect to recover"
            )
        if getattr(self._db, "_closing", False):
            raise DatabaseError("database closing")
        # Deadline propagation (overload.py): an already-expired caller
        # short-circuits BEFORE taking a queue slot — the 504 is going
        # out either way, so the write must not occupy the pipeline.
        deadline = overload.current_deadline()
        if deadline is not None and deadline.expired():
            self._note_expired()
            raise overload.DeadlineExceeded(
                "caller deadline expired before write submit"
            )
        await self._sem.acquire()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        sp = trace_api.current_span()
        self._queue.append(
            _WriteUnit(
                stmts, guards, fut, deadline,
                trace=(
                    (sp.trace_id, sp.span_id) if sp is not None else None
                ),
            )
        )
        metrics = self._db.metrics
        if metrics is not None:
            metrics.db_write_queue_depth.set(len(self._queue))
        self._kick(loop)
        if sp is None:
            return await fut
        # submit→commit as a real span on the caller's trace: queue
        # wait and the shared drain are where a "slow write" hides.
        with trace_api.span("db.write", units=len(stmts)):
            return await fut

    def _kick(self, loop) -> None:
        if self._drain_task is None or self._drain_task.done():
            self._drain_task = loop.create_task(self._drain_loop())

    async def _drain_loop(self):
        """Supervision shell: the drain body's per-batch error handling
        already maps engine errors onto the affected futures; anything
        that still escapes (a drainer bug, an injected `db.drain`
        fault) must NEVER leave a caller awaiting forever — the crash
        handler fails the popped batch and every queued unit with
        DatabaseError and schedules a backoff'd restart."""
        try:
            await self._drain_batches()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._note_crash(e)
        finally:
            self._inflight = None
            self._drain_task = None
            if self._queue and not self._broken:
                self._kick(asyncio.get_running_loop())

    async def _drain_batches(self):
        if self._resume_at:
            # Crash-restart backoff: the replacement drainer waits out
            # the jittered delay before touching the engine again.
            delay = self._resume_at - time.monotonic()
            self._resume_at = 0.0
            if delay > 0:
                await asyncio.sleep(delay)
        while self._queue:
            if (
                self.drain_deadline_s > 0
                and len(self._queue) < self.batch_max
            ):
                # Bounded linger so a trickle of writers can coalesce
                # into one commit (off by default: commit latency
                # already provides natural batching under load).
                await asyncio.sleep(self.drain_deadline_s)
            async with self._db._lock:
                batch: list[_WriteUnit] = []
                while self._queue and len(batch) < self.batch_max:
                    unit = self._queue.popleft()
                    self._sem.release()
                    if unit.future.done():  # caller gone: skip
                        continue
                    if (
                        unit.deadline is not None
                        and unit.deadline.expired()
                    ):
                        # The caller's deadline passed while the unit
                        # queued (stalled drain, deep backlog): dead
                        # work — drop it instead of committing a write
                        # nobody awaits anymore.
                        unit.future.set_exception(
                            overload.DeadlineExceeded(
                                "caller deadline expired in write queue"
                            )
                        )
                        self._note_expired()
                        continue
                    batch.append(unit)
                if not batch:
                    continue
                self._inflight = batch
                # Chaos: armed `db.drain` crashes/stalls the drainer in
                # its worst window — batch popped, futures unresolved —
                # proving the supervision above, not the happy path.
                faults.fire("db.drain")
                if not self._db._connected():
                    err = DatabaseError("database not connected")
                    for u in batch:
                        u.future.set_exception(err)
                    self._inflight = None
                    continue
                t0 = time.perf_counter()
                try:
                    results = await self._db._run_write_group(batch)
                except Exception as e:
                    err = (
                        e if isinstance(e, DatabaseError)
                        else DatabaseError(str(e))
                    )
                    for u in batch:
                        if not u.future.done():
                            u.future.set_exception(err)
                    self._inflight = None
                    continue
            ok_count = sum(1 for ok, _ in results if ok)
            self._note(batch, ok_count, time.perf_counter() - t0)
            for unit, (ok, payload) in zip(batch, results):
                if unit.future.done():
                    continue
                if ok:
                    unit.future.set_result(payload)
                else:
                    unit.future.set_exception(payload)
            self._inflight = None
            self._crash_streak = 0  # a full drain round heals the streak

    def _note_crash(self, exc: Exception):
        """Drain-loop crash: fail the in-flight batch + queue NOW (never
        a hang), count the restart, back off with full jitter, and trip
        the fail-fast latch once the restart budget is spent (a fresh
        batcher from reconnect() resets it)."""
        self._crash_streak += 1
        self.drain_restarts += 1
        err = DatabaseError(f"write drain crashed: {exc}")
        inflight, self._inflight = self._inflight, None
        for u in inflight or ():
            if not u.future.done():
                u.future.set_exception(err)
        self.fail_pending(err)
        metrics = self._db.metrics
        if metrics is not None:
            metrics.db_drain_restarts.labels(loop="write").inc()
        tracing = self._db.tracing
        if tracing is not None:
            tracing.record_breaker(
                kind="db_write_drain",
                crash=str(exc),
                streak=self._crash_streak,
            )
        if self._crash_streak > self.drain_restart_max:
            self._broken = True
        else:
            self._resume_at = time.monotonic() + jittered_backoff(
                self._crash_streak, DRAIN_BACKOFF_BASE_S,
                DRAIN_BACKOFF_MAX_S,
            )

    def _note_expired(self) -> None:
        """Count a deadline-dropped write unit (`request_deadline_exceeded`
        stage=db) — observability only, never the failure path itself."""
        self.units_expired += 1
        metrics = self._db.metrics
        if metrics is not None:
            try:
                metrics.request_deadline_exceeded.labels(stage="db").inc()
            except Exception:
                pass

    def _note(self, batch: list[_WriteUnit], ok_count: int,
              dt: float) -> None:
        batch_len = len(batch)
        self.group_commits += 1
        self.units_committed += ok_count
        self.units_conflicted += batch_len - ok_count
        self.batch_size_counts[batch_len] += 1
        metrics = self._db.metrics
        if metrics is not None:
            metrics.db_write_batch_size.observe(batch_len)
            metrics.db_group_commits.inc()
            metrics.db_write_queue_depth.set(len(self._queue))
        tracing = self._db.tracing
        if tracing is not None:
            tracing.record_db_drain(
                batch=batch_len,
                drain_s=dt,
                queue_depth=len(self._queue),
            )
        # Group-commit span: one root span per drain that carried at
        # least one traced unit, every batched unit attached as a span
        # link — "which requests shared this commit" is one span read.
        # Untraced drains (the bench writeload) skip it entirely.
        links = [
            {"trace_id": u.trace[0], "span_id": u.trace[1]}
            for u in batch
            if u.trace is not None
        ]
        if links:
            now = time.time()
            trace_api.emit_trace(
                "db.group_commit",
                start_ts=now - dt,
                end_ts=now,
                links=links,
                batch=batch_len,
                ok=ok_count,
            )

    async def flush(self):
        """Wait until every queued unit has been drained."""
        while self._drain_task is not None:
            task = self._drain_task
            try:
                await task
            except Exception:
                pass

    def fail_pending(self, exc: Exception):
        while self._queue:
            unit = self._queue.popleft()
            self._sem.release()
            if not unit.future.done():
                unit.future.set_exception(exc)


class _ReadOp:
    __slots__ = ("fn", "future")

    def __init__(self, fn, future):
        self.fn = fn
        self.future = future


class ReadCoalescer:
    """Coalesce concurrent reader-pool fetches into shared executor
    round trips — the read-side twin of the write batcher. The dominant
    cost of a sub-millisecond WAL read is the asyncio→thread→asyncio
    hop, not SQLite; under N concurrent readers one chunk of up to
    ``batch_max`` fetches pays ONE hop per reader thread. One lazily
    spawned drain task per reader connection keeps the whole pool busy;
    per-fetch errors resolve per-caller. Sequential awaits from one
    task still serialize, so read-your-committed-writes is unchanged.
    """

    def __init__(self, db, batch_max: int = READ_BATCH_MAX):
        self._db = db
        self.batch_max = max(1, batch_max)
        self._queue: collections.deque[_ReadOp] = collections.deque()
        self._workers: dict[int, asyncio.Task | None] = {}
        # Self-healing supervision (same discipline as WriteBatcher):
        # chunks popped but unresolved per worker, crash backoff, and a
        # restart ledger. Reads are idempotent so there is no fail-fast
        # latch — a crashed worker fails its futures and the next run()
        # re-kicks after the backoff.
        self._inflight: dict[int, list[_ReadOp]] = {}
        self._crash_streak = 0
        self._resume_at = 0.0
        self.drain_restarts = 0

    async def run(self, fn):
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._queue.append(_ReadOp(fn, fut))
        self._kick(loop)
        return await fut

    def _kick(self, loop) -> None:
        for i in range(len(self._db._readers)):
            task = self._workers.get(i)
            if task is None or task.done():
                self._workers[i] = loop.create_task(self._drain(i))
                return  # one fresh worker per kick; queue growth re-kicks

    async def _drain(self, idx: int):
        """Supervision shell around `_drain_chunks`: an escape (worker
        bug, injected `db.read` fault) fails the popped chunk + queued
        reads with DatabaseError — never a hang — counts a restart, and
        backs off before the next worker touches the pool."""
        try:
            await self._drain_chunks(idx)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._note_crash(idx, e)
        finally:
            self._inflight.pop(idx, None)
            self._workers[idx] = None
            if self._queue:  # a run() raced this worker's shutdown
                self._kick(asyncio.get_running_loop())

    def _note_crash(self, idx: int, exc: Exception):
        self._crash_streak += 1
        self.drain_restarts += 1
        err = DatabaseError(f"read drain crashed: {exc}")
        for op in self._inflight.pop(idx, ()):
            if not op.future.done():
                op.future.set_exception(err)
        self.fail_pending(err)
        self._resume_at = time.monotonic() + jittered_backoff(
            self._crash_streak, DRAIN_BACKOFF_BASE_S, DRAIN_BACKOFF_MAX_S
        )
        metrics = self._db.metrics
        if metrics is not None:
            metrics.db_drain_restarts.labels(loop="read").inc()
        tracing = self._db.tracing
        if tracing is not None:
            tracing.record_breaker(
                kind="db_read_drain",
                crash=str(exc),
                streak=self._crash_streak,
            )

    async def _drain_chunks(self, idx: int):
        loop = asyncio.get_running_loop()
        if self._resume_at:
            delay = self._resume_at - time.monotonic()
            self._resume_at = 0.0
            if delay > 0:
                await asyncio.sleep(delay)
        while self._queue:
            pool = len(self._db._readers)
            if idx >= pool:
                return  # pool shrank (close): failed by fail_pending
            ex, conn = self._db._readers[idx]
            # Spread a burst over the WHOLE pool: cap this chunk at
            # its fair share (ceil(queue/pool)) so 64 queued reads
            # land ~16-per-connection, not 64 serialized on one.
            limit = min(
                self.batch_max,
                max(1, -(-len(self._queue) // pool)),
            )
            batch: list[_ReadOp] = []
            while self._queue and len(batch) < limit:
                op = self._queue.popleft()
                if not op.future.done():
                    batch.append(op)
            if not batch:
                return
            self._inflight[idx] = batch
            # Chaos: armed `db.read` crashes/stalls this worker with
            # the chunk popped — the supervision shell must fail the
            # futures, never abandon them.
            faults.fire("db.read")

            def _chunk():
                # Gauge per FETCH, not per chunk: the chunk queues
                # on one connection, so true concurrency is the
                # number of busy reader threads, not burst size.
                out = []
                gauge = None
                wedged = False
                for op in batch:
                    g = self._db._note_reads(1)
                    try:
                        try:
                            out.append((True, op.fn(conn)))
                        except Exception as e:
                            if isinstance(e, sqlite3.ProgrammingError):
                                # "Cannot operate on a closed
                                # database" and kin: the CONNECTION
                                # is wedged, not the query — flag it
                                # for an in-place reopen.
                                wedged = True
                            out.append((False, e))
                    finally:
                        self._db._note_reads(-1)
                    if g is not None:
                        gauge = g
                return out, gauge, wedged

            try:
                results, gauge, wedged = await loop.run_in_executor(
                    ex, _chunk
                )
            except Exception as e:
                # Executor shut down mid-drain (close racing reads):
                # resolve the popped futures instead of abandoning
                # their callers to await forever.
                err = (
                    e if isinstance(e, DatabaseError)
                    else DatabaseError(str(e))
                )
                for op in batch:
                    if not op.future.done():
                        op.future.set_exception(err)
                self._inflight.pop(idx, None)
                continue
            metrics = self._db.metrics
            if metrics is not None and gauge is not None:
                metrics.db_peak_concurrent_reads.set(gauge)
            for op, (ok, payload) in zip(batch, results):
                if op.future.done():
                    continue
                if ok:
                    op.future.set_result(payload)
                elif isinstance(payload, sqlite3.Error):
                    op.future.set_exception(
                        self._db._map_sqlite_error(payload)
                    )
                else:
                    op.future.set_exception(payload)
            self._inflight.pop(idx, None)
            self._crash_streak = 0
            if wedged and not getattr(self._db, "_closing", False):
                # Self-heal the wedged connection in place: the ops
                # already failed to their callers (reads retry
                # cheaply); the REOPEN is what restores the pool for
                # everyone after.
                await self._db._reopen_reader(idx)

    def fail_pending(self, exc: Exception):
        """Resolve every still-queued read with `exc` (close path: the
        pool is gone, so no worker will ever pick them up)."""
        while self._queue:
            op = self._queue.popleft()
            if not op.future.done():
                op.future.set_exception(exc)


def _apply_unit_stmts(conn: sqlite3.Connection, stmts, guards) -> list[int]:
    """Run one unit's statements on `conn`, enforcing zero-row guards.
    THE definition of unit/guard semantics for the SQLite engine — the
    in-tx, savepoint, and solo-commit paths all share it so they cannot
    drift."""
    counts = []
    for (sql, params), guarded in zip(stmts, guards):
        count = conn.execute(sql, params).rowcount
        if guarded and count == 0:
            raise WriteConflictError("guarded statement matched no rows")
        counts.append(count)
    return counts


def _normalize_unit(
    stmts: Sequence, guards: Sequence[bool] | None
) -> tuple[list[tuple[str, tuple]], tuple[bool, ...]]:
    norm = [(sql, tuple(params)) for sql, params in stmts]
    if guards is None:
        g = (False,) * len(norm)
    else:
        g = tuple(bool(x) for x in guards)
        if len(g) != len(norm):
            raise ValueError("guards must match statements 1:1")
    return norm, g


class GroupCommitObservability:
    """Observability surface of the engine: optional Metrics/Tracing
    sinks plus the group-commit counters the batcher keeps (shared with
    the Postgres engine that `storage/__init__.py` names as a later
    item)."""

    metrics = None
    tracing = None

    def bind_observability(self, metrics=None, tracing=None) -> None:
        """Attach a Metrics and/or Tracing sink: group-commit batch-size
        histogram, queue-depth gauge, commit counter, peak-reads gauge,
        and a per-drain tracing breadcrumb."""
        if metrics is not None:
            self.metrics = metrics
        if tracing is not None:
            self.tracing = tracing

    def write_batch_stats(self) -> dict:
        """Group-commit counters for benches/tests: commits, units, and
        the batch-size distribution."""
        return self._batcher.stats()

    async def drain_writes(self, timeout_s: float | None = None) -> bool:
        """Graceful-stop seam (shared by both engines): wait —
        deadline-bounded — until every queued write unit has drained
        through its group commit, so a clean shutdown COMMITS the queue
        instead of `close()` rejecting it. Returns False when the
        deadline expired with units still queued (close() then rejects
        the remainder loudly, the pre-drain behavior)."""
        batcher = self._batcher
        if timeout_s is None:
            await batcher.flush()
            return True
        deadline = time.monotonic() + max(0.0, timeout_s)
        while batcher.depth or (
            batcher._drain_task is not None
            and not batcher._drain_task.done()
        ):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return batcher.depth == 0
            try:
                await asyncio.wait_for(batcher.flush(), remaining)
            except asyncio.TimeoutError:
                return batcher.depth == 0
        return True


class Database(GroupCommitObservability):
    def __init__(
        self,
        path: str | list[str] = ":memory:",
        read_pool_size: int = READ_POOL_SIZE,
        write_batch_max: int = WRITE_BATCH_MAX,
        write_queue_depth: int = WRITE_QUEUE_DEPTH,
        write_drain_deadline_ms: int = WRITE_DRAIN_DEADLINE_MS,
        db_drain_restart_max: int = DB_DRAIN_RESTART_MAX,
    ):
        # Multi-address failover seam (reference DbConnect db.go:35 tries
        # each DSN in order): the first address that opens wins.
        self.addresses = [path] if isinstance(path, str) else list(path)
        self.path = self.addresses[0]
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="nakama-db"
        )
        self._conn: sqlite3.Connection | None = None
        self._lock = asyncio.Lock()
        # Task currently holding an open Transaction; Database-level ops
        # issued by that same task join the transaction instead of
        # deadlocking on the non-reentrant lock.
        self._tx_owner: asyncio.Task | None = None
        # Reader pool (file-backed only): per-connection single threads.
        self._read_pool_size = max(0, read_pool_size)
        self._readers: list[
            tuple[concurrent.futures.ThreadPoolExecutor, sqlite3.Connection]
        ] = []
        # Observability for tests/metrics: peak concurrent reader calls.
        self._read_gauge_lock = threading.Lock()
        self._reads_in_flight = 0
        self.peak_concurrent_reads = 0
        # Group-commit write pipeline (module docstring): auto-commit
        # writes coalesce into shared commits.
        self._write_knobs = (
            write_batch_max, write_queue_depth, write_drain_deadline_ms,
            db_drain_restart_max,
        )
        self._batcher = WriteBatcher(self, *self._write_knobs)
        self._read_coalescer = ReadCoalescer(self)
        # Shutdown-under-load latch: set first thing in close() so new
        # submits reject immediately and queued-but-undrained units fail
        # with DatabaseError instead of hanging their awaiters.
        self._closing = False

    # ------------------------------------------------------------ lifecycle

    async def connect(self, migrate: bool = True) -> None:
        def _open(path: str):
            conn = sqlite3.connect(path, check_same_thread=False)
            try:
                conn.row_factory = sqlite3.Row
                conn.execute("PRAGMA journal_mode=WAL")
                conn.execute("PRAGMA foreign_keys=ON")
                conn.execute("PRAGMA synchronous=NORMAL")
            except sqlite3.Error:
                conn.close()  # don't leak the handle during failover
                raise
            return conn

        if self._executor._shutdown:  # re-connect after close()
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="nakama-db"
            )
        # Fresh batcher + coalescer per connect: their
        # asyncio primitives bind to the loop they first run on, and a
        # reconnect may be on a new loop. This also resets the drain
        # supervisors' crash streaks and the fail-fast latch.
        self._batcher = WriteBatcher(self, *self._write_knobs)
        self._read_coalescer = ReadCoalescer(self)
        self._closing = False
        last_error: Exception | None = None
        for path in self.addresses:
            try:
                self._conn = await self._run(_open, path)
                self.path = path
                break
            except sqlite3.Error as e:
                last_error = e
        else:
            raise DatabaseError(
                f"no database address reachable: {last_error}"
            )
        if migrate:
            await self.migrate()
        await self._open_readers()

    async def _open_readers(self) -> None:
        """Read-only WAL connections, one per reader thread. Memory
        databases have per-connection state — no pool for them. (Match
        the exact memory forms, not a substring: a file path merely
        CONTAINING 'memory' must still get its pool.)"""
        p = self.path
        if p == ":memory:" or p.startswith("file::memory:") or (
            "mode=memory" in p
        ):
            return

        loop = asyncio.get_running_loop()
        for i in range(self._read_pool_size):
            ex = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"nakama-db-r{i}"
            )
            try:
                conn = await loop.run_in_executor(ex, self._open_ro_conn)
            except sqlite3.Error:
                ex.shutdown(wait=False)
                break  # reads fall back to the writer path
            self._readers.append((ex, conn))

    def _open_ro_conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(
            f"file:{self.path}?mode=ro", uri=True,
            check_same_thread=False,
        )
        conn.row_factory = sqlite3.Row
        return conn

    async def _reopen_reader(self, idx: int) -> None:
        """Self-heal one wedged reader connection in place (called by
        the coalescer when a chunk hit connection-level errors): close
        the dead handle on its own executor thread and open a fresh
        read-only connection there. Best-effort — a failed reopen
        leaves the old handle in place and the next wedged chunk
        retries it."""
        if idx >= len(self._readers):
            return
        ex, conn = self._readers[idx]
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(ex, conn.close)
        except Exception:
            pass
        try:
            fresh = await loop.run_in_executor(ex, self._open_ro_conn)
        except (sqlite3.Error, RuntimeError):
            return
        if idx < len(self._readers) and self._readers[idx][0] is ex:
            self._readers[idx] = (ex, fresh)
        if self.tracing is not None:
            self.tracing.record_breaker(
                kind="db_reader_reopen", reader=idx
            )

    async def close(self) -> None:
        # Shutdown under load: queued-but-undrained units REJECT with
        # DatabaseError now (their awaiters resolve immediately), new
        # submits reject via the closing latch, and only the batch the
        # drainer already popped rides its commit to completion — so
        # close() is bounded by one group commit, not the whole queue.
        self._closing = True
        self._batcher.fail_pending(DatabaseError("database closing"))
        await self._batcher.flush()
        # Take the lock so we never close under an open transaction.
        async with self._lock:
            if self._conn is not None:
                conn = self._conn
                self._conn = None
                await self._run(conn.close)
        self._batcher.fail_pending(DatabaseError("database closed"))
        self._executor.shutdown(wait=False)
        readers, self._readers = self._readers, []
        loop = asyncio.get_running_loop()
        for ex, conn in readers:
            try:
                await loop.run_in_executor(ex, conn.close)
            except Exception:
                pass
            ex.shutdown(wait=False)
        self._read_coalescer.fail_pending(DatabaseError("database closed"))

    async def migrate(self) -> list[str]:
        """Apply embedded migrations in order; returns names applied
        (reference migrate.StartupCheck, main.go:133)."""

        def _migrate(conn: sqlite3.Connection) -> list[str]:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS migration_info ("
                " version INTEGER PRIMARY KEY, name TEXT NOT NULL,"
                " applied_at REAL NOT NULL DEFAULT (strftime('%s','now')))"
            )
            done = {
                row[0]
                for row in conn.execute("SELECT version FROM migration_info")
            }
            applied = []
            for version, name, statements in MIGRATIONS:
                if version in done:
                    continue
                for stmt in statements:
                    conn.execute(stmt)
                conn.execute(
                    "INSERT INTO migration_info (version, name) VALUES (?, ?)",
                    (version, name),
                )
                applied.append(name)
            conn.commit()
            return applied

        return await self._with_conn(_migrate)

    async def migrate_down(self, limit: int = 1) -> list[str]:
        """Revert the newest `limit` applied migrations (reference
        migrate/migrate.go:108 `down`): derived DROPs run newest-first,
        then the migration_info rows are removed."""
        from .migrations import down_statements

        by_version = {v: (name, stmts) for v, name, stmts in MIGRATIONS}

        def _down(conn: sqlite3.Connection) -> list[str]:
            rows = conn.execute(
                "SELECT version FROM migration_info"
                " ORDER BY version DESC LIMIT ?",
                (limit,),
            ).fetchall()
            reverted = []
            for (version,) in rows:
                entry = by_version.get(version)
                if entry is None:  # unknown to this binary: leave it
                    continue
                name, stmts = entry
                for stmt in down_statements(version, stmts):
                    conn.execute(stmt)
                conn.execute(
                    "DELETE FROM migration_info WHERE version = ?",
                    (version,),
                )
                reverted.append(name)
            conn.commit()
            return reverted

        return await self._with_conn(_down)

    # ----------------------------------------------------------- operations

    async def execute(self, sql: str, params: Iterable[Any] = ()) -> int:
        """Run one statement; returns affected row count. Inside this task's
        open ``tx()`` it joins the transaction; otherwise auto-commits —
        through the group-commit pipeline when it is enabled, so
        concurrent callers share one WAL commit."""
        in_tx = asyncio.current_task() is self._tx_owner

        if in_tx:
            def _exec(conn: sqlite3.Connection) -> int:
                return conn.execute(sql, tuple(params)).rowcount

            return await self._with_conn(_exec)
        counts = await self._write_unit([(sql, tuple(params))], None)
        return counts[0]

    async def execute_many(
        self, sql: str, params_seq: Iterable[Iterable[Any]]
    ) -> int:
        """Run one statement for each parameter tuple as ONE atomic unit
        (all rows commit together or none do); returns total affected
        rows. Batched with other writers' units into a shared commit."""
        stmts = [(sql, tuple(p)) for p in params_seq]
        if not stmts:
            return 0
        if asyncio.current_task() is self._tx_owner:
            def _exec(conn: sqlite3.Connection) -> int:
                return sum(
                    conn.execute(s, p).rowcount for s, p in stmts
                )

            return await self._with_conn(_exec)
        return sum(await self._write_unit(stmts, None))

    async def submit_write(
        self,
        stmts: Sequence,
        guards: Sequence[bool] | None = None,
    ) -> list[int]:
        """Enqueue one atomic write unit: a list of ``(sql, params)``
        statements applied together inside the next group commit.
        Returns per-statement rowcounts after the shared commit.

        ``guards[i]=True`` marks statement i as a guard: if it matches
        zero rows the unit rolls back to its savepoint (nothing from the
        unit commits) and the call raises `WriteConflictError` — the
        optimistic-concurrency seam wallet/leaderboard retry loops use.
        Inside this task's open ``tx()`` the statements join the
        transaction directly (a guard failure raises and the enclosing
        transaction rolls back as a whole)."""
        norm, g = _normalize_unit(stmts, guards)
        if asyncio.current_task() is self._tx_owner:
            return await self._with_conn(
                lambda conn: _apply_unit_stmts(conn, norm, g)
            )
        return await self._write_unit(norm, g)

    async def _write_unit(self, stmts, guards) -> list[int]:
        return await self._batcher.write_unit(stmts, guards)

    async def fetch_all(
        self, sql: str, params: Iterable[Any] = ()
    ) -> list[dict]:
        def _fetch(conn: sqlite3.Connection) -> list[dict]:
            return [
                dict(row)
                for row in conn.execute(sql, tuple(params)).fetchall()
            ]

        if asyncio.current_task() is self._tx_owner:
            return await self._with_conn(_fetch)
        if self._readers:
            return await self._run_reader(_fetch)
        # Single-connection fallback: lock so reads never observe another
        # task's open transaction on the shared connection.
        async with self._lock:
            return await self._with_conn(_fetch)

    async def fetch_one(
        self, sql: str, params: Iterable[Any] = ()
    ) -> dict | None:
        def _fetch(conn: sqlite3.Connection):
            row = conn.execute(sql, tuple(params)).fetchone()
            return dict(row) if row is not None else None

        if asyncio.current_task() is self._tx_owner:
            return await self._with_conn(_fetch)
        if self._readers:
            return await self._run_reader(_fetch)
        async with self._lock:
            return await self._with_conn(_fetch)

    def tx(self) -> "Transaction":
        """``async with db.tx() as tx:`` — serialised read-modify-write
        transaction (the reference's ExecuteInTx, server/db.go)."""
        return Transaction(self)

    # ------------------------------------------------------------ internals

    def _connected(self) -> bool:
        return self._conn is not None

    @staticmethod
    def _map_sqlite_error(e: sqlite3.Error) -> DatabaseError:
        if isinstance(e, sqlite3.IntegrityError) and (
            "UNIQUE constraint failed" in str(e)
        ):
            return UniqueViolationError(str(e))
        return DatabaseError(str(e))

    async def _run_write_group(self, units: list[_WriteUnit]) -> list:
        """Execute a batch of write units as ONE transaction on the writer
        thread; returns ``[(ok, rowcounts | exception), ...]`` unit-wise.
        Caller (the batcher / per-commit fallback) holds the writer lock."""
        conn = self._conn

        def _unit_in_savepoint(unit: _WriteUnit, i: int):
            sp = f"nk_gc_{i}"
            conn.execute(f"SAVEPOINT {sp}")
            try:
                counts = _apply_unit_stmts(conn, unit.stmts, unit.guards)
            except (sqlite3.Error, WriteConflictError) as e:
                try:
                    conn.execute(f"ROLLBACK TO {sp}")
                    conn.execute(f"RELEASE {sp}")
                except sqlite3.Error:
                    # SQLITE_FULL/IOERR/NOMEM auto-rolled-back the whole
                    # transaction and the savepoint with it; every prior
                    # unit's work is gone too — re-run the batch solo.
                    raise _GroupAborted(e) from e
                if isinstance(e, WriteConflictError):
                    return (False, e)
                return (False, self._map_sqlite_error(e))
            conn.execute(f"RELEASE {sp}")
            return (True, counts)

        def _unit_solo(unit: _WriteUnit):
            # Fallback when the group's own BEGIN/COMMIT failed: retry
            # each unit with its own commit so one poisoned unit can't
            # take the whole batch down with it.
            try:
                counts = _apply_unit_stmts(conn, unit.stmts, unit.guards)
                conn.commit()
                return (True, counts)
            except (sqlite3.Error, WriteConflictError) as e:
                if conn.in_transaction:
                    conn.rollback()
                if isinstance(e, WriteConflictError):
                    return (False, e)
                return (False, self._map_sqlite_error(e))

        def _group():
            try:
                conn.execute("BEGIN IMMEDIATE")
            except sqlite3.Error:
                return [_unit_solo(u) for u in units]
            try:
                results = []
                for i, u in enumerate(units):
                    try:
                        results.append(_unit_in_savepoint(u, i))
                    except _GroupAborted:
                        # Nothing committed (the auto-rollback undid
                        # prior units too): restart the batch solo.
                        return [_unit_solo(x) for x in units]
            except BaseException:
                # Never leave the connection inside the dead group
                # transaction: a later solo commit would resurrect its
                # partial work after callers were told they failed.
                try:
                    if conn.in_transaction:
                        conn.rollback()
                except sqlite3.Error:
                    pass
                raise
            try:
                conn.commit()
            except sqlite3.Error:
                try:
                    conn.rollback()
                except sqlite3.Error:
                    pass
                return [_unit_solo(u) for u in units]
            return results

        return await self._run(_group)

    async def _run(self, fn, *args):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, fn, *args)

    def _note_reads(self, delta: int):
        """Adjust the in-flight reader-fetch count; returns the new peak
        when it advanced (the caller exports it to metrics), else None."""
        with self._read_gauge_lock:
            self._reads_in_flight += delta
            if self._reads_in_flight > self.peak_concurrent_reads:
                self.peak_concurrent_reads = self._reads_in_flight
                return self.peak_concurrent_reads
        return None

    async def _run_reader(self, fn):
        """Run a read on the pool via the coalescer — no writer lock;
        WAL isolation guarantees a committed snapshot."""
        try:
            return await self._read_coalescer.run(fn)
        except sqlite3.Error as e:
            raise DatabaseError(str(e)) from e

    async def _with_conn(self, fn):
        if self._conn is None:
            raise DatabaseError("database not connected")
        in_tx = asyncio.current_task() is self._tx_owner

        def _call(conn: sqlite3.Connection):
            try:
                return fn(conn)
            except sqlite3.Error:
                # A failed auto-commit statement leaves the connection inside
                # python-sqlite3's implicit transaction; roll it back so the
                # next BEGIN IMMEDIATE doesn't see a nested transaction.
                # Explicit tx() blocks roll back in Transaction.__aexit__.
                if not in_tx and conn.in_transaction:
                    conn.rollback()
                raise

        try:
            return await self._run(_call, self._conn)
        except sqlite3.IntegrityError as e:
            # Only genuine uniqueness conflicts map to UniqueViolationError
            # (reference server/db_error.go checks pg code 23505); FK /
            # NOT NULL / CHECK violations are plain database errors.
            if "UNIQUE constraint failed" in str(e):
                raise UniqueViolationError(str(e)) from e
            raise DatabaseError(str(e)) from e
        except sqlite3.Error as e:
            raise DatabaseError(str(e)) from e


class UniqueViolationError(DatabaseError):
    """Constraint conflict — the reference maps pg unique_violation the same
    way (server/db_error.go)."""


class Transaction:
    """Holds the database lock for its scope; all statements inside are one
    SQLite transaction, rolled back on exception."""

    def __init__(self, db: Database):
        self._db = db

    async def __aenter__(self) -> "Transaction":
        await self._db._lock.acquire()
        try:
            await self._db._with_conn(
                lambda conn: conn.execute("BEGIN IMMEDIATE")
            )
        except BaseException:
            self._db._lock.release()
            raise
        self._db._tx_owner = asyncio.current_task()
        return self

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        try:
            if exc_type is None:
                await self._db._with_conn(lambda conn: conn.commit())
            else:
                await self._db._with_conn(lambda conn: conn.rollback())
        finally:
            self._db._tx_owner = None
            self._db._lock.release()
        return False

    async def execute(self, sql: str, params: Iterable[Any] = ()) -> int:
        def _exec(conn: sqlite3.Connection) -> int:
            return conn.execute(sql, tuple(params)).rowcount

        return await self._db._with_conn(_exec)

    async def fetch_all(
        self, sql: str, params: Iterable[Any] = ()
    ) -> list[dict]:
        def _fetch(conn: sqlite3.Connection) -> list[dict]:
            return [
                dict(row) for row in conn.execute(sql, tuple(params)).fetchall()
            ]

        return await self._db._with_conn(_fetch)

    async def fetch_one(
        self, sql: str, params: Iterable[Any] = ()
    ) -> dict | None:
        def _fetch(conn: sqlite3.Connection):
            row = conn.execute(sql, tuple(params)).fetchone()
            return dict(row) if row is not None else None

        return await self._db._with_conn(_fetch)


async def migrate_status(db: Database) -> list[dict]:
    """`nakama migrate status` equivalent (reference migrate/migrate.go)."""
    return await db.fetch_all(
        "SELECT version, name, applied_at FROM migration_info ORDER BY version"
    )

"""The port's SQLite group-commit engine held against the JAX package's.

The same write and read sequences go through `nakama_tpu.storage.db`
and `nakama_tpu_torch.storage.db` on files of their own: the rows, the
rowcounts, the errors and the schema must be identical, with group
commit on and off. The port's engine is then driven alone through what
its users rely on: zero-row guards, SAVEPOINT isolation between the
units of one drain, a crashed drain that fails its callers and restarts
(and latches after `db_drain_restart_max`), `drain_writes` before
`close()`, a crashed reader, caller deadlines, and the metrics and
tracing bound with `bind_observability`.
"""

from __future__ import annotations

import asyncio

import pytest

from nakama_tpu.storage import db as jdb
from nakama_tpu_torch import faults, overload
from nakama_tpu_torch.metrics import Metrics
from nakama_tpu_torch.storage import db as tdb
from nakama_tpu_torch.storage import make_database, migrate_status
from nakama_tpu_torch.storage.migrations import MIGRATIONS
from nakama_tpu_torch.tracing import Tracing


@pytest.fixture(autouse=True)
def _clean_fault_plane():
    faults.disarm()
    faults.PLANE.fired.clear()
    yield
    faults.disarm()
    faults.PLANE.fired.clear()


async def _open(mod, path, **kw):
    db = mod.Database(path, read_pool_size=2, **kw)
    await db.connect()
    await db.execute(
        "CREATE TABLE IF NOT EXISTS kv"
        " (k TEXT PRIMARY KEY, v INTEGER NOT NULL)"
    )
    return db


async def _script(mod, db) -> list:
    """One sequence of writes and reads; every outcome recorded."""
    out = []

    async def step(coro):
        try:
            out.append(("ok", await coro))
        except Exception as e:
            out.append(("err", type(e).__name__))

    await step(db.execute("INSERT INTO kv (k, v) VALUES (?, ?)", ("a", 1)))
    await step(db.execute_many(
        "INSERT INTO kv (k, v) VALUES (?, ?)", [(f"b{i}", i) for i in range(5)]
    ))
    # A duplicate key: the unit fails, nothing of it commits.
    await step(db.execute_many(
        "INSERT INTO kv (k, v) VALUES (?, ?)", [("c", 1), ("a", 2)]
    ))
    await step(db.submit_write(
        [("UPDATE kv SET v = v + 10 WHERE k = ?", ("b1",)),
         ("UPDATE kv SET v = 0 WHERE k = ?", ("missing",))],
        guards=[False, True],
    ))
    await step(db.submit_write(
        [("UPDATE kv SET v = v + 10 WHERE k = ?", ("b2",)),
         ("DELETE FROM kv WHERE k = ?", ("b3",))],
        guards=[True, True],
    ))
    # Concurrent units share drains; each sees only its own outcome.
    results = await asyncio.gather(
        *[db.execute("UPDATE kv SET v = v + 1 WHERE k = ?", (f"b{i % 5}",))
          for i in range(20)],
        db.execute("INSERT INTO kv (k, v) VALUES (?, ?)", ("b0", 0)),
        return_exceptions=True,
    )
    out.append([
        type(r).__name__ if isinstance(r, Exception) else r for r in results
    ])
    async with db.tx() as tx:
        row = await tx.fetch_one("SELECT v FROM kv WHERE k = ?", ("b4",))
        await tx.execute(
            "UPDATE kv SET v = ? WHERE k = ?", (row["v"] * 2, "b4")
        )
    await step(db.fetch_all("SELECT k, v FROM kv ORDER BY k"))
    await step(db.fetch_one("SELECT COUNT(*) AS n FROM kv"))
    await step(db.fetch_one("SELECT v FROM kv WHERE k = ?", ("nope",)))
    await step(db.fetch_all("SELECT * FROM no_such_table"))
    return out


async def test_same_sequence_same_rows_in_both_engines(tmp_path):
    outs = []
    for mod in (jdb, tdb):
        db = await _open(mod, str(tmp_path / f"{mod.__name__}.db"))
        outs.append(await _script(mod, db))
        await db.close()
    assert outs[0] == outs[1]
    rows = outs[1][-4][1]
    assert {r["k"] for r in rows} == {"a", "b0", "b1", "b2", "b4"}


async def test_schema_identical_after_connect(tmp_path):
    schemas = []
    for mod in (jdb, tdb):
        db = mod.Database(str(tmp_path / f"{mod.__name__}.db"), read_pool_size=1)
        await db.connect()
        schemas.append(await db.fetch_all(
            "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name"
        ))
        applied = await (
            jdb.migrate_status(db) if mod is jdb else migrate_status(db)
        )
        assert [r["version"] for r in applied] == [v for v, _, _ in MIGRATIONS]
        await db.close()
    assert schemas[0] == schemas[1]
    names = {r["name"] for r in schemas[1]}
    assert {"matchmaker_journal", "matchmaker_checkpoint"} <= names


async def test_migrate_down_then_up_in_both_engines(tmp_path):
    for mod in (jdb, tdb):
        db = mod.Database(str(tmp_path / f"{mod.__name__}.db"), read_pool_size=1)
        await db.connect()
        assert await db.migrate_down(1) == ["matchmaker-journal"]
        tables = {
            r["name"] for r in await db.fetch_all(
                "SELECT name FROM sqlite_master WHERE type = 'table'"
            )
        }
        assert "matchmaker_journal" not in tables
        assert await db.migrate() == ["matchmaker-journal"]
        await db.close()


async def test_either_engine_reads_the_others_file(tmp_path):
    path = str(tmp_path / "shared.db")
    a = await _open(jdb, path)
    await a.execute_many(
        "INSERT INTO kv (k, v) VALUES (?, ?)", [("x", 1), ("y", 2)]
    )
    await a.close()
    b = await _open(tdb, path)
    assert await b.fetch_all("SELECT k, v FROM kv ORDER BY k") == [
        {"k": "x", "v": 1}, {"k": "y", "v": 2}
    ]
    await b.execute("UPDATE kv SET v = 7 WHERE k = ?", ("x",))
    await b.close()
    c = await _open(jdb, path)
    assert (await c.fetch_one("SELECT v FROM kv WHERE k = 'x'"))["v"] == 7
    await c.close()


async def test_guard_conflict_rolls_back_the_whole_unit(tmp_path):
    db = await _open(tdb, str(tmp_path / "g.db"))
    await db.execute("INSERT INTO kv (k, v) VALUES ('a', 1)")
    with pytest.raises(tdb.WriteConflictError):
        await db.submit_write(
            [("UPDATE kv SET v = 99 WHERE k = 'a'", ()),
             ("UPDATE kv SET v = 0 WHERE k = 'ghost'", ())],
            guards=[False, True],
        )
    assert (await db.fetch_one("SELECT v FROM kv WHERE k = 'a'"))["v"] == 1
    assert db.write_batch_stats()["units_conflicted"] == 1
    with pytest.raises(ValueError):
        await db.submit_write([("SELECT 1", ())], guards=[True, False])
    await db.close()


async def test_failing_unit_leaves_its_batch_mates_committed(tmp_path):
    """Units of one drain: a failing statement rolls back its own
    SAVEPOINT only; the others commit in the shared COMMIT."""
    db = await _open(tdb, str(tmp_path / "s.db"))
    await db.execute("INSERT INTO kv (k, v) VALUES ('dup', 0)")
    before = db.write_batch_stats()["group_commits"]
    results = await asyncio.gather(
        *[db.execute("INSERT INTO kv (k, v) VALUES (?, ?)", (f"k{i}", i))
          for i in range(10)],
        db.execute_many(
            "INSERT INTO kv (k, v) VALUES (?, ?)", [("z1", 1), ("dup", 1)]
        ),
        return_exceptions=True,
    )
    assert results[:10] == [1] * 10
    assert isinstance(results[10], tdb.UniqueViolationError)
    keys = {r["k"] for r in await db.fetch_all("SELECT k FROM kv")}
    assert keys == {"dup", *(f"k{i}" for i in range(10))}
    stats = db.write_batch_stats()
    # The eleven units shared fewer commits than one per unit.
    assert stats["group_commits"] - before < 11
    await db.close()


async def test_drain_crash_fails_callers_restarts_then_latches(tmp_path):
    db = tdb.Database(
        str(tmp_path / "d.db"), read_pool_size=1, db_drain_restart_max=2
    )
    await db.connect()
    await db.execute("CREATE TABLE kv (k TEXT PRIMARY KEY, v INTEGER)")
    metrics = Metrics()
    tracing = Tracing()
    db.bind_observability(metrics, tracing)
    faults.arm("db.drain", "raise", count=1)
    with pytest.raises(tdb.DatabaseError, match="write drain crashed"):
        await db.execute("INSERT INTO kv VALUES ('a', 1)")
    # The supervisor restarted: the next write commits (after backoff).
    assert await db.execute("INSERT INTO kv VALUES ('b', 2)") == 1
    assert db._batcher.drain_restarts == 1
    assert metrics.snapshot()[
        "nakama_db_drain_restarts_total{loop=write}"
    ] == 1
    assert tracing.recent_breaker_events()[-1]["kind"] == "db_write_drain"
    # Past the restart budget the pipeline fails fast until reconnect.
    faults.arm("db.drain", "raise")
    for _ in range(3):
        with pytest.raises(tdb.DatabaseError):
            await db.execute("INSERT INTO kv VALUES ('c', 3)")
    faults.disarm()
    assert db._batcher._broken
    with pytest.raises(tdb.DatabaseError, match="reconnect"):
        await db.execute("INSERT INTO kv VALUES ('c', 3)")
    await db.close()
    await db.connect()
    assert await db.execute("INSERT INTO kv VALUES ('c', 3)") == 1
    await db.close()


async def test_read_drain_crash_fails_reads_then_heals(tmp_path):
    db = tdb.Database(str(tmp_path / "r.db"), read_pool_size=1)
    await db.connect()
    await db.execute("CREATE TABLE kv (k TEXT PRIMARY KEY, v INTEGER)")
    await db.execute("INSERT INTO kv VALUES ('a', 1)")
    faults.arm("db.read", "raise", count=1)
    with pytest.raises(tdb.DatabaseError, match="read drain crashed"):
        await db.fetch_one("SELECT v FROM kv WHERE k = 'a'")
    assert (await db.fetch_one("SELECT v FROM kv WHERE k = 'a'"))["v"] == 1
    assert db._read_coalescer.drain_restarts == 1
    # A wedged reader connection fails its reads, then is reopened in
    # place on its own thread.
    ex, conn = db._readers[0]
    conn.close()
    with pytest.raises(tdb.DatabaseError, match="closed"):
        await db.fetch_one("SELECT v FROM kv WHERE k = 'a'")
    for _ in range(200):  # the reopen follows the failed chunk
        if db._readers[0][1] is not conn:
            break
        await asyncio.sleep(0.01)
    assert db._readers[0][1] is not conn
    assert (await db.fetch_one("SELECT v FROM kv WHERE k = 'a'"))["v"] == 1
    await db.close()


async def test_drain_writes_commits_the_backlog_before_close(tmp_path):
    path = str(tmp_path / "w.db")
    db = await _open(tdb, path)
    faults.arm("db.drain", "stall", stall_s=0.05, count=1)
    pending = [
        asyncio.ensure_future(
            db.execute("INSERT INTO kv VALUES (?, ?)", (f"k{i}", i))
        )
        for i in range(50)
    ]
    await asyncio.sleep(0)
    assert await db.drain_writes(timeout_s=10.0)
    await db.close()
    assert all(p.done() and p.result() == 1 for p in pending)
    db2 = await _open(tdb, path)
    assert (await db2.fetch_one("SELECT COUNT(*) AS n FROM kv"))["n"] == 50
    await db2.close()


async def test_close_rejects_what_was_not_drained(tmp_path):
    db = await _open(tdb, str(tmp_path / "c.db"))
    faults.arm("db.drain", "stall", stall_s=0.1, count=1)
    pending = [
        asyncio.ensure_future(db.execute("INSERT INTO kv VALUES (?, 1)", (f"k{i}",)))
        for i in range(600)
    ]
    await asyncio.sleep(0.01)
    await db.close()
    done = await asyncio.gather(*pending, return_exceptions=True)
    assert any(isinstance(r, tdb.DatabaseError) for r in done)
    with pytest.raises(tdb.DatabaseError):
        await db.execute("INSERT INTO kv VALUES ('late', 1)")


async def test_expired_caller_deadline_takes_no_queue_slot(tmp_path):
    db = await _open(tdb, str(tmp_path / "e.db"))
    metrics = Metrics()
    db.bind_observability(metrics)
    with overload.deadline_scope(overload.Deadline(0.0)):
        with pytest.raises(overload.DeadlineExceeded):
            await db.execute("INSERT INTO kv VALUES ('a', 1)")
    assert db._batcher.depth == 0
    assert db.write_batch_stats()["units_expired"] == 1
    snap = metrics.snapshot()
    assert snap["nakama_request_deadline_exceeded_total{stage=db}"] == 1
    assert await db.fetch_one("SELECT v FROM kv WHERE k = 'a'") is None
    await db.close()


async def test_bound_observability_records_every_drain(tmp_path):
    db = await _open(tdb, str(tmp_path / "o.db"))
    metrics = Metrics()
    tracing = Tracing()
    db.bind_observability(metrics, tracing)
    before = db.write_batch_stats()["group_commits"]
    await asyncio.gather(*[
        db.execute("INSERT INTO kv VALUES (?, 1)", (f"k{i}",)) for i in range(16)
    ])
    snap = metrics.snapshot()
    commits = db.write_batch_stats()["group_commits"] - before
    assert snap["nakama_db_group_commits_total"] == commits
    assert snap["nakama_db_write_batch_size_count"] == commits
    assert snap["nakama_db_write_batch_size_sum"] == 16
    assert tracing.ledger_totals()["db_drains"] == commits
    assert sum(d["batch"] for d in tracing.recent_db_drains(64)) == 16
    await db.close()


def test_postgres_address_raises_instead_of_opening_sqlite():
    """A postgres:// address opens the Postgres engine, never a SQLite
    file of that name (`test_torch_pg.py` holds the engine itself)."""
    from nakama_tpu_torch.storage.pg import PostgresDatabase

    db = make_database(["postgres://u@h/db"])
    assert isinstance(db, PostgresDatabase) and not isinstance(db, tdb.Database)
    assert db.addresses == ["postgres://u@h/db"]
    assert isinstance(make_database(":memory:"), tdb.Database)

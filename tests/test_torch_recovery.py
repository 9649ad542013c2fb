"""The port's crash-recovery plane held against the JAX package's.

The same numpy-seeded ticket sequence (explicit ids and creation times,
the mixed pool of `test_torch_slice.py`: squads, parties, host-only
regex queries, embeddings) goes through each package's `LocalMatchmaker`
with a `TicketJournal` over its own file database: the journal rows —
LSN, op, payload, node; `created_at` is a wall-clock stamp and is left
out — must be identical, for published, unpublished and partially held
matches. A checkpoint plus a journal tail written by either package
recovers in the other with the same pool and the same groups in the
next interval. The port alone: tail replay, idempotence, the re-pool and
settlement of unpublished matches, and the `journal.append`,
`journal.replay` and `checkpoint.write` faults degrading without
wedging anything.

Pools: capacity 2048, 64-wide blocks, fn = fs = 8, the two-stage path
with the native assembler (`test_torch_snapshot.py`'s configuration).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from nakama_tpu import faults as jfaults
from nakama_tpu import recovery as jrec
from nakama_tpu.matchmaker import MatchmakerPresence as JaxPresence
from nakama_tpu.matchmaker.local import PartialPublish as JaxPartial
from nakama_tpu.storage import db as jdb
from nakama_tpu_torch import faults as tfaults
from nakama_tpu_torch import recovery as trec
from nakama_tpu_torch.config import RecoveryConfig
from nakama_tpu_torch.logger import test_logger as quiet_logger
from nakama_tpu_torch.matchmaker import MatchmakerPresence
from nakama_tpu_torch.matchmaker.local import PartialPublish
from nakama_tpu_torch.metrics import Metrics
from nakama_tpu_torch.storage import db as tdb
from test_torch_slice import add_ticket, groups, ticket_stream
from test_torch_snapshot import make

PKG = {
    "jax": (jrec, jdb, JaxPresence, True),
    "port": (trec, tdb, MatchmakerPresence, False),
}


@pytest.fixture(autouse=True)
def _clean_fault_planes():
    for f in (jfaults, tfaults):
        f.disarm()
        f.PLANE.fired.clear()
    yield
    for f in (jfaults, tfaults):
        f.disarm()
        f.PLANE.fired.clear()


async def open_db(pkg, path):
    db = PKG[pkg][1].Database(str(path), read_pool_size=1)
    await db.connect()
    return db


def live_ids(mm) -> list[str]:
    return sorted(mm.store.ticket_at[s].ticket for s in mm.store.live_slots())


def attach(pkg, mm, db, **kw):
    rec = PKG[pkg][0]
    mm.journal = rec.TicketJournal(db, quiet_logger(), **kw)
    return mm.journal


def populate(pkg, mm, seed: int, n: int = 120, start: int = 0):
    """Adds, one interval, more adds, a few cancellations."""
    presence = PKG[pkg][2]
    rng = np.random.default_rng(seed)
    for spec in ticket_stream(rng, n, "mixed", start):
        add_ticket(mm, spec, presence)
    batch = mm.process()
    for spec in ticket_stream(rng, n // 2, "mixed", start + n):
        add_ticket(mm, spec, presence)
    mm.remove([f"t{i}" for i in range(start + 3, start + n, 11)])
    return batch


async def journal_rows(db) -> list[tuple]:
    rows = await db.fetch_all(
        "SELECT lsn, op, payload, node FROM matchmaker_journal ORDER BY lsn"
    )
    return [(r["lsn"], r["op"], json.loads(r["payload"]), r["node"]) for r in rows]


def publisher(mode: str):
    """on_matched for a scenario: deliver, fail, or hold some cohorts."""
    def on_matched(batch):
        if mode == "unpublished":
            raise RuntimeError("session gone")
        if mode == "partial":
            held = frozenset(
                t.ticket for i in range(0, len(batch), 2)
                for t in batch.tickets(i)
            )
            jax = type(batch).__module__.startswith("nakama_tpu.")
            raise (JaxPartial if jax else PartialPublish)(held)
    return on_matched


@pytest.mark.parametrize("mode", ["published", "unpublished", "partial"])
async def test_same_ops_give_the_same_journal_rows(tmp_path, mode):
    rows = {}
    for pkg in PKG:
        db = await open_db(pkg, tmp_path / f"{pkg}.db")
        mm = make(PKG[pkg][3])
        mm.on_matched = publisher(mode)
        journal = attach(pkg, mm, db, flush_max=64)
        populate(pkg, mm, seed=21)
        mm.process()
        assert await journal.flush()
        rows[pkg] = await journal_rows(db)
        mm.stop()
        await db.close()
    assert rows["port"] == rows["jax"]
    ops = [r[1] for r in rows["port"]]
    assert {"add", "remove"} <= set(ops)
    want = {"published": {"matched"}, "unpublished": {"unpublished"},
            "partial": {"matched", "unpublished"}}[mode]
    assert want <= set(ops)


@pytest.mark.parametrize("src", ["jax", "port"])
async def test_checkpoint_and_tail_recover_in_either_package(tmp_path, src):
    """One package writes the database + checkpoint file; each package
    recovers from them: both pools hold the source's live tickets, and
    both form the same groups in their next interval."""
    db = await open_db(src, tmp_path / "r.db")
    mm = make(PKG[src][3])
    journal = attach(src, mm, db)
    populate(src, mm, seed=5)
    ckpt = PKG[src][0].Checkpointer(
        journal, db, str(tmp_path / "r.ckpt"), quiet_logger(), interval_sec=1
    )
    stats = await ckpt.checkpoint(mm)
    assert stats is not None and stats["lsn"] == journal.lsn
    # The tail past the checkpoint: adds, an interval, cancellations.
    populate(src, mm, seed=6, n=60, start=1000)
    assert await journal.flush()
    want_ids = live_ids(mm)
    mm.stop()
    await db.close()

    got = {}
    for dst in PKG:
        db = await open_db(dst, tmp_path / "r.db")
        fresh = make(PKG[dst][3])
        out = await PKG[dst][0].recover(
            fresh, db, str(tmp_path / "r.ckpt"), "local", quiet_logger()
        )
        assert out["checkpoint_lsn"] == stats["lsn"]
        assert out["replayed_rows"] > 0 and out["removed"] > 0
        assert live_ids(fresh) == want_ids
        got[dst] = groups([fresh.process()])
        fresh.stop()
        await db.close()
    assert got["port"] and got["port"] == got["jax"]


@pytest.mark.parametrize("src", ["jax", "port"])
async def test_the_leaderboard_section_recovers_in_either_package(
    tmp_path, src
):
    """One package checkpoints its pool with its rank engine's boards as
    the `leaderboard_device` section; each package's `recover()` hands
    the section to its own engine, and both engines then answer the
    source's ranks."""
    from test_torch_leaderboard import engines

    (jc, je), (pc, pe) = engines()
    cache, engine = {"jax": (jc, je), "port": (pc, pe)}[src]
    rng = np.random.default_rng(3)
    owners = [f"c{i}" for i in range(60)]
    for owner in owners:
        cache.insert("ck", 0.0, 1, owner, int(rng.integers(0, 8)), 0)
        engine.record_upsert("ck", 0.0, 1, owner)
    path = str(tmp_path / "r.ckpt")
    db = await open_db(src, tmp_path / "r.db")
    mm = make(PKG[src][3])
    journal = attach(src, mm, db)
    populate(src, mm, seed=5)
    ckpt = PKG[src][0].Checkpointer(
        journal, db, path, quiet_logger(), interval_sec=1
    )
    if src == "jax":
        ckpt.extra_providers["leaderboard_device"] = je.snapshot_state
    else:
        ckpt.rank_engine = pe
    assert await ckpt.checkpoint(mm) is not None
    want = cache.get_many("ck", 0.0, owners)
    mm.stop()
    await db.close()
    (_, je2), (_, pe2) = engines()
    for dst, restored in (("jax", je2), ("port", pe2)):
        db = await open_db(dst, tmp_path / "r.db")
        fresh = make(PKG[dst][3])
        kw = ({"extras": {"leaderboard_device": je2.restore_state}}
              if dst == "jax" else {"rank_engine": pe2})
        await PKG[dst][0].recover(
            fresh, db, path, "local", quiet_logger(), **kw
        )
        fresh.stop()
        await db.close()
        assert restored.flush_all()
        assert restored.get_many("ck", 0.0, owners) == want


async def test_recover_is_idempotent(tmp_path):
    db = await open_db("port", tmp_path / "i.db")
    mm = make(False)
    journal = attach("port", mm, db)
    populate("port", mm, seed=8)
    ckpt = trec.Checkpointer(journal, db, str(tmp_path / "i.ckpt"),
                             quiet_logger())
    await ckpt.checkpoint(mm)
    populate("port", mm, seed=9, n=40, start=500)
    await journal.flush()
    pools = []
    for _ in range(2):
        fresh = make(False)
        await trec.recover(fresh, db, str(tmp_path / "i.ckpt"), "local",
                           quiet_logger())
        pools.append(live_ids(fresh))
        fresh.stop()
    assert pools[0] == pools[1] == live_ids(mm)
    mm.stop()
    await db.close()


async def test_unpublished_match_repools_then_settles(tmp_path):
    """A match whose publish failed journals `unpublished` with full
    payloads; a checkpoint's truncation keeps the row; the recovery
    plane re-pools the tickets, then settles the row into fresh adds in
    one unit, so a second recovery re-pools nothing twice."""
    db = await open_db("port", tmp_path / "u.db")
    mm = make(False)
    metrics = Metrics()
    plane = trec.RecoveryPlane(
        RecoveryConfig(recovery_dir=str(tmp_path)), db, mm, quiet_logger(),
        metrics=metrics,
    )
    mm.on_matched = publisher("unpublished")
    batch = populate("port", mm, seed=3)
    failed = {t.ticket for i in range(len(batch)) for t in batch.tickets(i)}
    assert failed
    mm.on_matched = None
    await plane.checkpointer.checkpoint(mm)
    await plane.journal.flush()
    ops = [r[1] for r in await journal_rows(db)]
    assert ops == ["unpublished"]
    want = sorted(set(live_ids(mm)) | failed)
    mm.stop()

    fresh = make(False)
    plane2 = trec.RecoveryPlane(
        RecoveryConfig(recovery_dir=str(tmp_path)), db, fresh, quiet_logger(),
        metrics=metrics,
    )
    stats = await plane2.recover()
    assert stats["repooled_unpublished"] == len(failed)
    assert live_ids(fresh) == want
    ops = [r[1] for r in await journal_rows(db)]
    assert "unpublished" not in ops and ops.count("add") == len(failed)
    snap = metrics.snapshot()
    assert snap["nakama_matchmaker_recovery_tickets"] == len(want)
    # Graceful stop: flush + final checkpoint; the next boot replays nothing.
    await plane2.shutdown()
    again = make(False)
    out = await trec.recover(again, db, plane2.path, "local", quiet_logger())
    assert out["replayed_rows"] == 0 and live_ids(again) == want
    for m in (fresh, again):
        m.stop()
    await db.close()


async def test_journal_append_raise_degrades_then_heals(tmp_path):
    db = await open_db("port", tmp_path / "a.db")
    metrics = Metrics()
    mm = make(False)
    journal = attach("port", mm, db, metrics=metrics)
    tfaults.arm("journal.append", "raise")
    populate("port", mm, seed=1, n=40)
    assert not await journal.flush()
    assert journal.degraded and journal.pending == journal.lsn
    assert metrics.snapshot()["nakama_matchmaker_journal_degraded"] == 1
    # The interval path keeps serving while the journal is degraded.
    mm.process()
    tfaults.disarm()
    assert await journal.flush()
    assert not journal.degraded and journal.durable_lsn == journal.lsn
    assert metrics.snapshot()["nakama_matchmaker_journal_degraded"] == 0
    assert len(await journal_rows(db)) == journal.lsn
    mm.stop()
    await db.close()


async def test_journal_append_drop_tears_batches_without_wedging(tmp_path):
    db = await open_db("port", tmp_path / "d.db")
    mm = make(False)
    journal = attach("port", mm, db, flush_max=16)
    tfaults.arm("journal.append", "drop", count=2)
    populate("port", mm, seed=2, n=40)
    assert await journal.flush()
    assert journal.dropped == 32 and journal.pending == 0
    assert len(await journal_rows(db)) == journal.lsn - 32
    assert tfaults.PLANE.fired["journal.append"] == 2
    mm.stop()
    await db.close()


@pytest.mark.parametrize("mode", ["raise", "drop"])
async def test_checkpoint_write_fault_keeps_the_previous_checkpoint(
    tmp_path, mode
):
    db = await open_db("port", tmp_path / "c.db")
    metrics = Metrics()
    mm = make(False)
    journal = attach("port", mm, db)
    ckpt = trec.Checkpointer(journal, db, str(tmp_path / "c.ckpt"),
                             quiet_logger(), metrics=metrics)
    populate("port", mm, seed=4, n=60)
    first = await ckpt.checkpoint(mm)
    populate("port", mm, seed=5, n=40, start=700)
    tfaults.arm("checkpoint.write", mode, count=1)
    assert await ckpt.checkpoint(mm) is None
    snap = metrics.snapshot()
    assert snap["nakama_matchmaker_checkpoints_total{outcome=failed}"] == 1
    assert snap["nakama_matchmaker_checkpoint_lsn"] == first["lsn"]
    fresh = make(False)
    out = await trec.recover(fresh, db, str(tmp_path / "c.ckpt"), "local",
                             quiet_logger())
    assert out["checkpoint_lsn"] == first["lsn"]
    assert live_ids(fresh) == live_ids(mm)
    for m in (mm, fresh):
        m.stop()
    await db.close()


@pytest.mark.parametrize("mode", ["raise", "drop"])
async def test_replay_fault_boots_on_the_snapshot_alone(tmp_path, mode):
    db = await open_db("port", tmp_path / "p.db")
    mm = make(False)
    journal = attach("port", mm, db)
    ckpt = trec.Checkpointer(journal, db, str(tmp_path / "p.ckpt"),
                             quiet_logger())
    populate("port", mm, seed=6, n=60)
    await ckpt.checkpoint(mm)
    at_checkpoint = live_ids(mm)
    populate("port", mm, seed=7, n=30, start=900)
    await journal.flush()
    tfaults.arm("journal.replay", mode, count=1)
    fresh = make(False)
    out = await trec.recover(fresh, db, str(tmp_path / "p.ckpt"), "local",
                             quiet_logger())
    assert live_ids(fresh) == at_checkpoint
    assert out["reinserted"] == 0
    # Not wedged: a second boot replays the tail.
    again = make(False)
    await trec.recover(again, db, str(tmp_path / "p.ckpt"), "local",
                       quiet_logger())
    assert live_ids(again) == live_ids(mm)
    for m in (mm, fresh, again):
        m.stop()
    await db.close()


def card_fault(*_args, **_kw):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


class OutOfMemoryError(RuntimeError):
    """Named as torch's: `faults.degrades` admits it by name."""


async def test_card_error_in_snapshot_raises_out_of_the_checkpoint(tmp_path):
    """A failed read-back of the pool from the card is not a storage
    failure: the checkpoint raises it instead of logging a WARN."""
    db = await open_db("port", tmp_path / "s.db")
    mm = make(False)
    journal = attach("port", mm, db)
    ckpt = trec.Checkpointer(journal, db, str(tmp_path / "s.ckpt"),
                             quiet_logger())
    populate("port", mm, seed=10, n=40)
    mm.snapshot_state = card_fault
    with pytest.raises(RuntimeError, match="CUDA error"):
        await ckpt.checkpoint(mm)
    assert ckpt.checkpoints == 0 and not ckpt._running
    mm.stop()
    await db.close()


async def test_card_error_in_a_gap_checkpoint_ends_the_service(tmp_path):
    """In the running loop the same error ends the service, as a failed
    kernel launch does (`test_torch_service.py`), and `stop()` re-raises
    it; the pool is untouched."""
    from test_torch_service import make as make_service
    from test_torch_service import until

    db = await open_db("port", tmp_path / "g.db")
    mm, got = make_service(False)
    journal = attach("port", mm, db)
    mm.checkpointer = trec.Checkpointer(
        journal, db, str(tmp_path / "g.ckpt"), quiet_logger()
    )
    mm.checkpointer._last -= 60
    mm.snapshot_state = card_fault
    mm.pause()
    mm.start()
    populate_rng = np.random.default_rng(13)
    for spec in ticket_stream(populate_rng, 12, "1v1", 0):
        add_ticket(mm, spec, MatchmakerPresence)
    await until(lambda: mm.error is not None)
    with pytest.raises(RuntimeError, match="CUDA error"):
        mm.stop()
    assert not got and int(mm.store.active.sum()) == 12
    assert mm.checkpointer.checkpoints == 0
    await db.close()


async def _checkpoint_and_tail(tmp_path, name):
    """A checkpoint plus a durable journal tail; returns the source
    matchmaker, its pool at the checkpoint, and the database."""
    db = await open_db("port", tmp_path / f"{name}.db")
    mm = make(False)
    journal = attach("port", mm, db)
    ckpt = trec.Checkpointer(journal, db, str(tmp_path / f"{name}.ckpt"),
                             quiet_logger())
    populate("port", mm, seed=11, n=60)
    await ckpt.checkpoint(mm)
    at_checkpoint = live_ids(mm)
    populate("port", mm, seed=12, n=40, start=600)
    await journal.flush()
    return mm, at_checkpoint, db


@pytest.mark.parametrize("call", ["restore_state", "insert"])
async def test_card_error_in_recover_raises(tmp_path, call):
    """The pool's copy to the card (restore_state) and the tail's
    re-insert both put tickets on the card: an error there raises out of
    recover() instead of booting a node on an empty or partial pool."""
    mm, _, db = await _checkpoint_and_tail(tmp_path, call)
    fresh = make(False)
    setattr(fresh, call, card_fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        await trec.recover(fresh, db, str(tmp_path / f"{call}.ckpt"),
                           "local", quiet_logger())
    for m in (mm, fresh):
        m.stop()
    await db.close()


async def test_memory_pressure_in_restore_degrades_to_the_journal(tmp_path):
    """Device memory pressure is the one card error the ladder admits:
    the restore degrades to a journal-only replay, as in the JAX
    package, and the snapshot-only tickets are lost, loudly."""
    mm, at_checkpoint, db = await _checkpoint_and_tail(tmp_path, "m")

    def oom(_snap):
        raise OutOfMemoryError("CUDA out of memory")

    fresh = make(False)
    fresh.restore_state = oom
    out = await trec.recover(fresh, db, str(tmp_path / "m.ckpt"), "local",
                             quiet_logger())
    assert out["checkpoint_lsn"] == 0 and out["reinserted"] > 0
    assert live_ids(fresh) == sorted(set(live_ids(mm)) - set(at_checkpoint))
    for m in (mm, fresh):
        m.stop()
    await db.close()


def test_payload_round_trip_matches_jax():
    mm = make(False)
    jmm = make(True)
    rng = np.random.default_rng(11)
    for spec in ticket_stream(rng, 30, "mixed", 0):
        add_ticket(mm, spec, MatchmakerPresence)
        add_ticket(jmm, spec, JaxPresence)
    for tid in live_ids(mm):
        p = trec.ticket_payload(mm.store.get(tid))
        assert p == jrec.ticket_payload(jmm.store.get(tid))
        ex = trec.payload_to_extract(p)
        jex = jrec.payload_to_extract(p)
        for field in ("ticket", "query", "min_count", "max_count",
                      "count_multiple", "session_id", "party_id",
                      "string_properties", "numeric_properties",
                      "created_at", "intervals"):
            assert getattr(ex, field) == getattr(jex, field), field
        assert [vars(x) for x in ex.presences] == [
            vars(x) for x in jex.presences
        ]
        assert (ex.embedding is None) == (jex.embedding is None)
        if ex.embedding is not None:
            assert np.array_equal(ex.embedding, jex.embedding)
    mm.stop()
    jmm.stop()


async def test_first_checkpoint_waits_a_full_interval(tmp_path):
    db = await open_db("port", tmp_path / "f.db")
    mm = make(False)
    journal = attach("port", mm, db)
    ckpt = trec.Checkpointer(journal, db, str(tmp_path / "f.ckpt"),
                             quiet_logger(), interval_sec=60)
    assert not ckpt.due()
    assert await ckpt.maybe_checkpoint(mm) is None
    ckpt._last -= 61
    assert ckpt.due()
    assert (await ckpt.maybe_checkpoint(mm))["lsn"] == 0
    mm.stop()
    await db.close()


async def test_a_drain_kicked_inside_a_request_ignores_its_deadline(tmp_path):
    """A journal drain kicked by an add inside a socket envelope's
    deadline scope: the port's drain drops the request's deadline and
    the records reach the database; the JAX package's drain inherits it,
    and a deadline that passes before its unit commits degrades the
    journal (a fault of the reference, ROADMAP.md §C)."""
    import asyncio

    from nakama_tpu import overload as joverload
    from nakama_tpu_torch import overload as toverload

    state = {}
    for pkg, ov in (("jax", joverload), ("port", toverload)):
        db = await open_db(pkg, tmp_path / f"{pkg}.db")
        rec = jrec if pkg == "jax" else trec
        journal = rec.TicketJournal(db, quiet_logger())
        with ov.deadline_scope(ov.Deadline(0.0)):  # already expired
            journal.record_remove(["t-1", "t-2"])
        for _ in range(100):
            if journal.degraded or journal.durable_lsn == journal.lsn:
                break
            await asyncio.sleep(0.01)
        state[pkg] = (journal.degraded, journal.durable_lsn)
        await db.close()
    assert state == {"jax": (True, 0), "port": (False, 1)}

"""The port's leaderboards (`nakama_tpu_torch/leaderboard/`,
`utils/cronexpr.py`) held against the JAX package's: cron next-times
over seeded expressions, the host rank cache, `Leaderboards` and
`Tournaments` over each package's own database, each device program of
`leaderboard/cuda.py` against `nakama_tpu/leaderboard/tpu.py` on CPU
JAX (keys with ties and PAD_KEY rows, C in {8, 1000, 4096}, B in
{1, 3}), `DeviceRankEngine(device="cpu")` against the JAX engine under
a seeded write/delete stream (the staleness contract included), a JAX
`snapshot_state` restored in the port, and the breaker: injected
faults and CUDA out-of-memory degrade to the oracle, any other error
raises.

Stated tolerance: none — ranks, permutations, windows, sweeps, rows and
next-times must be equal."""

import calendar
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import quiet_logger

from nakama_tpu.config import LeaderboardConfig as JaxLeaderboardConfig
from nakama_tpu.leaderboard import DeviceRankEngine as JaxEngine
from nakama_tpu.leaderboard import Leaderboards as JaxLeaderboards
from nakama_tpu.leaderboard import LeaderboardRankCache as JaxCache
from nakama_tpu.leaderboard import Tournaments as JaxTournaments
from nakama_tpu.leaderboard import tpu as jax_b8
from nakama_tpu.storage.db import Database as JaxDatabase
from nakama_tpu.utils import cronexpr as jax_cron
from nakama_tpu_torch import faults
from nakama_tpu_torch.config import LeaderboardConfig
from nakama_tpu_torch.leaderboard import (
    DeviceRankEngine,
    LeaderboardRankCache,
    Leaderboards,
    Tournaments,
)
from nakama_tpu_torch.leaderboard import cuda as b8
from nakama_tpu_torch.logger import test_logger as port_logger
from nakama_tpu_torch.storage.db import Database
from nakama_tpu_torch.utils import cronexpr

# One tournament start for both runs of the shared script.
T0 = float(int(time.time()) - 100)
ENGINE = dict(
    device_min_board_size=0,
    device_flush_dirty_threshold=16,
    device_flush_interval_sec=3600.0,
    device_breaker_threshold=2,
    device_breaker_cooldown_ms=40,
)


def engines(**overrides):
    """A JAX engine and a port engine (on the CPU), each over its own
    package's rank cache."""
    kw = {**ENGINE, **overrides}
    jc, pc = JaxCache(), LeaderboardRankCache()
    je = JaxEngine(JaxLeaderboardConfig(**kw), quiet_logger(), oracle=jc)
    pe = DeviceRankEngine(
        LeaderboardConfig(**kw), port_logger(), oracle=pc, device="cpu"
    )
    return (jc, je), (pc, pe)


# ------------------------------------------------------------ cronexpr


def _cron_exprs(rng: random.Random, n: int) -> list[str]:
    def field(lo, hi):
        kind = rng.randrange(5)
        if kind == 0:
            return "*"
        if kind == 1:
            return str(rng.randint(lo, hi))
        if kind == 2:
            a = rng.randint(lo, hi)
            return f"{a}-{rng.randint(a, hi)}"
        if kind == 3:
            return f"*/{rng.randint(1, max(1, (hi - lo) // 2))}"
        return ",".join(str(v) for v in sorted(rng.sample(range(lo, hi + 1), 3)))

    out = ["@daily", "@weekly", "@monthly", "@hourly", "@yearly",
           "30 9 * jan-mar mon,fri", "0 0 29 2 *"]
    for _ in range(n):
        out.append(" ".join((field(0, 59), field(0, 23), field(1, 28),
                             field(1, 12), field(0, 6))))
    return out


def test_cron_next_times_match_the_jax_package():
    rng = random.Random(7)
    starts = [float(calendar.timegm((2026, m, d, h, mi, 0)))
              for m, d, h, mi in ((1, 1, 0, 0), (2, 28, 23, 59),
                                  (7, 30, 10, 30), (12, 31, 23, 59))]
    for expr in _cron_exprs(rng, 40):
        js, ps = jax_cron.parse(expr), cronexpr.parse(expr)
        for t in starts:
            assert ps.next(t) == js.next(t), (expr, t)
            assert cronexpr.next_after(expr, t) == jax_cron.next_after(expr, t)
    for bad in ("61 * * * *", "* * *", "* * * * 9", "a b c d e"):
        with pytest.raises(jax_cron.CronError) as want:
            jax_cron.parse(bad)
        with pytest.raises(cronexpr.CronError) as got:
            cronexpr.parse(bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------- rank cache


def test_rank_cache_matches_the_jax_package():
    rng = random.Random(3)
    caches = (JaxCache(["hidden"]), LeaderboardRankCache(["hidden"]))
    owners = [f"o{i}" for i in range(60)]
    for step in range(600):
        board = rng.choice(["a", "b", "hidden"])
        owner = rng.choice(owners)
        if rng.random() < 0.2:
            answers = [c.delete(board, 0.0, owner) for c in caches]
        else:
            score, sub = rng.randrange(8), rng.randrange(3)
            answers = [c.insert(board, 0.0, board == "a", owner, score, sub)
                       for c in caches]
        assert answers[0] == answers[1], step
    for board in ("a", "b", "hidden"):
        views = [(
            c.get_many(board, 0.0, owners + ["none"]),
            c.rank_window(board, 0.0, 3, 20), c.standings(board, 0.0),
            c.count(board, 0.0), c.keys_for(board, 0.0, owners),
            c.items(board, 0.0),
        ) for c in caches]
        assert views[0] == views[1]
    entries = [(f"r{i}", i % 4, 0, 100 - i) for i in range(30)]
    for c in caches:
        c.restore_board("r", 5.0, 1, entries)
        c.insert("r", 5.0, 1, "r7", 3, 0)  # identical re-submit keeps seq
    assert caches[0].standings("r", 5.0) == caches[1].standings("r", 5.0)
    assert caches[0].trim_expired(6.0) == caches[1].trim_expired(6.0) == 1


# ------------------------------------------------- Leaderboards / tournaments


def _strip(obj):
    """Drop wall-clock fields, which differ between two runs; a
    `Leaderboard` compares as its dict."""
    if hasattr(obj, "as_dict"):
        obj = obj.as_dict()
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("create_time", "update_time")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


async def _leaderboard_script(db, lb_cls, t_cls, engine):
    await db.connect()
    lb = lb_cls(quiet_logger(), db, engine.oracle, device_engine=engine)
    await lb.load()
    t = t_cls(lb)
    out = []

    async def step(coro):
        try:
            out.append(_strip(await coro))
        except Exception as e:  # the error class name and text must agree
            out.append((type(e).__name__, str(e), getattr(e, "code", None)))

    rng = random.Random(11)
    for spec in (("best", "desc"), ("set", "asc"), ("incr", "desc"),
                 ("decr", "asc")):
        await step(lb.create(f"lb-{spec[0]}", operator=spec[0],
                             sort_order=spec[1]))
    await step(lb.create("lb-best", operator="best"))  # exists
    await step(lb.create("auth", authoritative=True))
    for i in range(80):
        board = rng.choice(["lb-best", "lb-set", "lb-incr", "lb-decr"])
        await step(lb.record_write(board, f"u{rng.randrange(30)}",
                                   username=f"n{i}", score=rng.randrange(50),
                                   subscore=rng.randrange(3),
                                   metadata={"i": i}))
    await step(lb.create("lb-ties", operator="set"))
    for i in range(20):  # two scores: ties order by write time
        await step(lb.record_write("lb-ties", f"u{(i * 7) % 20}",
                                   score=i % 2))
    ties = [f"u{i}" for i in range(20)]
    for cursor in ("", "6"):
        await step(lb.records_list("lb-ties", owner_ids=ties, limit=6,
                                   cursor=cursor))
    await step(lb.record_write("auth", "u1", score=3,
                               caller_authoritative=False))
    await step(lb.record_write("missing", "u1", score=3))
    for board in ("lb-best", "lb-set", "lb-incr", "lb-decr"):
        page = await lb.records_list(board, limit=7)
        out.append(_strip(page))
        await step(lb.records_list(board, limit=7, cursor=page.get("next_cursor", "")))
        await step(lb.records_list(board, owner_ids=["u1", "u2", "u99"]))
        everyone = [f"u{i}" for i in range(30)]  # ties on score
        await step(lb.records_list(board, owner_ids=everyone, limit=7))
        await step(lb.records_list(board, owner_ids=everyone, limit=7,
                                   cursor="7"))
        await step(lb.records_haystack(board, "u5", limit=5))
        await step(lb.record_delete(board, "u5"))
        await step(lb.records_haystack(board, "u6", limit=4))
    await step(t.create("cup", duration=3600, max_size=3, join_required=True,
                        max_num_score=2, sort_order="desc", start_time=T0))
    for owner in ("p1", "p1", "p2", "p3", "p4"):
        await step(t.join("cup", owner))
    for owner, score in (("p1", 5), ("p1", 9), ("p1", 11), ("p2", 7),
                         ("p5", 1)):
        await step(t.record_write("cup", owner, score=score))
    await step(t.records_list("cup"))
    await step(t.records_haystack("cup", "p2", limit=3))
    await step(t.record_delete("cup", "p2", caller_authoritative=False))
    out.append(_strip(t.list()))
    out.append(sorted(d.id for d in lb.list()))
    await db.close()
    return out


async def test_leaderboards_and_tournaments_answer_as_the_jax_package():
    """The same operations over each package's own database (with each
    package's device engine, on the CPU, behind the boards) give the
    same rows and answers."""
    (jc, je), (pc, pe) = engines(device_min_board_size=8)
    want = await _leaderboard_script(
        JaxDatabase(":memory:"), JaxLeaderboards, JaxTournaments, je)
    got = await _leaderboard_script(
        Database(":memory:"), Leaderboards, Tournaments, pe)
    assert got == want
    assert pe.device_reads > 0 and je.device_reads > 0


# -------------------------------------------------------- B8 programs


def _board_keys(rng, b, c):
    """[B, C, 3] int32 keys: a live prefix with many ties on (k0, k1),
    unique seqs per board, then PAD_KEY rows."""
    keys = np.full((b, c, 3), b8.PAD_KEY, dtype=np.int32)
    for i in range(b):
        live = int(rng.integers(0, c + 1))
        keys[i, :live, 0] = rng.integers(-5, 5, size=live)
        keys[i, :live, 1] = rng.integers(0, 3, size=live)
        keys[i, :live, 2] = rng.permutation(live) + 1
        keys[i] = keys[i, rng.permutation(c)]
    return keys


@pytest.mark.parametrize("c", [8, 1000, 4096])
@pytest.mark.parametrize("b", [1, 3])
def test_b8_programs_match_the_jax_programs(b, c):
    rng = np.random.default_rng(c * 10 + b)
    keys = _board_keys(rng, b, c)
    sk_j, perm_j = jax_b8.sort_boards(jnp.asarray(keys))
    sk_p, perm_p = b8.sort_boards(torch.from_numpy(keys))
    np.testing.assert_array_equal(perm_p.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(sk_p.numpy(), np.asarray(sk_j))
    np.testing.assert_array_equal(
        b8.rank_of_slots(perm_p).numpy(),
        np.asarray(jax_b8.rank_of_slots(perm_j)),
    )
    iters = b8.n_search_iters(c)
    assert iters == jax_b8.n_search_iters(c)
    for i in range(b):
        board = keys[i]
        # Present keys, keys between and beyond them, and PAD_KEY.
        q = np.concatenate([
            board[rng.integers(0, c, size=16)],
            np.stack([rng.integers(-6, 6, 16), rng.integers(0, 4, 16),
                      rng.integers(0, c + 2, 16)], axis=1),
            np.full((2, 3), b8.PAD_KEY),
        ]).astype(np.int32)
        np.testing.assert_array_equal(
            b8.lex_ranks(sk_p[i], torch.from_numpy(q), iters).numpy(),
            np.asarray(jax_b8.lex_ranks(sk_j[i], jnp.asarray(q), iters)),
        )
        for start, limit in ((0, min(c, 8)), (c // 3, 1), (c - 1, 1)):
            np.testing.assert_array_equal(
                b8.window_slots(perm_p[i], start, limit).numpy(),
                np.asarray(jax_b8.window_slots(perm_j[i], jnp.int32(start),
                                               limit)),
            )
    u = max(1, c // 4)
    idx = rng.choice(c, size=u, replace=False)
    rows = _board_keys(rng, 1, u)[0]
    got = b8.scatter_keys(torch.from_numpy(keys[0].copy()),
                          torch.from_numpy(idx), torch.from_numpy(rows))
    want = jax_b8.scatter_keys(jnp.asarray(keys[0]),
                               jnp.asarray(idx.astype(np.int32)),
                               jnp.asarray(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert b8.pad_pow2(c) == jax_b8.pad_pow2(c)
    assert b8.board_device_bytes(c) == jax_b8.board_device_bytes(c)


# ------------------------------------------------------ DeviceRankEngine


def _views(engine, oracle, boards, owners):
    out = []
    for board in boards:
        out.append(engine.get_many(board, 0.0, owners))
        for start in (0, 5, 40):
            out.append(engine.rank_window(board, 0.0, start, 12))
        out.append(engine.percentile(board, 0.0, owners[3]))
    out.append(engine.sweep_many([(b, 0.0) for b in boards]))
    return out


def test_device_rank_engine_answers_as_the_jax_engine():
    """A seeded write/delete stream through both engines. Between
    flushes both serve the same stale ranks (the staleness contract:
    below the dirty threshold and inside the flush interval, a read
    ranks current oracle keys against the last flush); past the
    threshold a read flushes, and both agree with the oracle again."""
    (jc, je), (pc, pe) = engines()
    rng = random.Random(5)
    owners = [f"p{i}" for i in range(90)]
    boards = ["up", "down"]
    for owner in owners:
        for board, order in (("up", 0), ("down", 1)):
            score = rng.randrange(40)
            for cache, engine in ((jc, je), (pc, pe)):
                cache.insert(board, 0.0, order, owner, score, 0)
                engine.record_upsert(board, 0.0, order, owner)
    assert je.flush_all() and pe.flush_all()
    stale = 0
    for round_ in range(6):
        for _ in range(rng.choice([5, 30])):  # under / over the threshold
            board = rng.choice(boards)
            owner = rng.choice(owners)
            delete = rng.random() < 0.25
            score = rng.randrange(40)
            for cache, engine in ((jc, je), (pc, pe)):
                if delete:
                    cache.delete(board, 0.0, owner)
                    engine.record_delete(board, 0.0, owner)
                else:
                    cache.insert(board, 0.0, board == "down", owner, score, 1)
                    engine.record_upsert(board, 0.0, board == "down", owner)
        want = _views(je, jc, boards, owners + ["nobody"])
        got = _views(pe, pc, boards, owners + ["nobody"])
        assert got == want, round_
        stale += got[0] != pc.get_many("up", 0.0, owners + ["nobody"])
    assert 0 < stale < 6  # some rounds read a stale flush, some flushed
    assert pe.flushes == je.flushes
    for key in ("device_reads", "fallbacks", "sweeps", "flushes"):
        assert pe.stats()[key] == je.stats()[key]
    assert pe.flush_all() and je.flush_all()
    for board in boards:
        assert pe.get_many(board, 0.0, owners) == pc.get_many(board, 0.0, owners)
    # Out-of-range keys flip a board host-only in both.
    for cache, engine in ((jc, je), (pc, pe)):
        cache.insert("big", 0.0, 0, "x", 2**40, 0)
        engine.record_upsert("big", 0.0, 0, "x")
    assert pe.get_many("big", 0.0, ["x"]) is je.get_many("big", 0.0, ["x"]) is None


def test_a_jax_snapshot_restores_in_the_port():
    (jc, je), (pc, pe) = engines()
    rng = random.Random(9)
    owners = [f"s{i}" for i in range(50)]
    for owner in owners:
        jc.insert("snap", 0.0, 1, owner, rng.randrange(6), 0)
        je.record_upsert("snap", 0.0, 1, owner)
    for owner in owners[:10]:
        jc.delete("snap", 0.0, owner)
        je.record_delete("snap", 0.0, owner)
    snap = je.snapshot_state()
    (jc2, je2), (pc2, pe2) = engines()
    assert je2.restore_state(snap) == pe2.restore_state(snap) == 1
    assert pe2.snapshot_state() == je2.snapshot_state() == snap
    for engine in (je2, pe2):
        assert engine.flush_all()
    assert pe2.get_many("snap", 0.0, owners) == je2.get_many("snap", 0.0, owners)
    assert pe2.sweep_many([("snap", 0.0)]) == je2.sweep_many([("snap", 0.0)])
    assert pe2.rank_window("snap", 0.0, 0, 50) == je2.rank_window(
        "snap", 0.0, 0, 50)
    assert pe2.restore_state(None) == pe2.restore_state({"version": 99}) == 0


def test_only_injected_faults_and_out_of_memory_degrade(monkeypatch):
    """The JAX engine serves any failure from the oracle; the port's
    breaker takes only an injected fault or CUDA out-of-memory, and any
    other error raises out of the read."""
    _, (pc, pe) = engines()
    owners = [f"f{i}" for i in range(30)]
    for i, owner in enumerate(owners):
        pc.insert("f", 0.0, 1, owner, i % 7, 0)
        pe.record_upsert("f", 0.0, 1, owner)
    assert pe.flush_all()
    want = pc.get_many("f", 0.0, owners)
    try:
        faults.arm("leaderboard.rank", "raise")
        assert pe.get_many("f", 0.0, owners) is None
        assert pe.get_many("f", 0.0, owners) is None
        assert pe.breaker.state == "open"
    finally:
        faults.disarm()
    pe.breaker._clock = lambda: 1e12  # the cooldown has passed
    assert pe.get_many("f", 0.0, owners) == want
    assert pe.breaker.state == "closed"
    # Drop modes: a dropped read or flush serves host-side, no failure.
    with faults.armed_ctx("leaderboard.rank", mode="drop", count=1):
        assert pe.get_many("f", 0.0, owners) is None
    pc.insert("f", 0.0, 1, "f0", 99, 0)
    pe.record_upsert("f", 0.0, 1, "f0")
    pe._boards[("f", 0.0)].sorted_valid = False
    with faults.armed_ctx("leaderboard.flush", mode="drop", count=1):
        assert pe.get_many("f", 0.0, owners) is None  # nothing sorted yet
    assert pe.breaker.failures == 3
    assert pe.get_many("f", 0.0, owners) == pc.get_many("f", 0.0, owners)
    real = b8.lex_ranks

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(b8, "lex_ranks", oom)
    assert pe.get_many("f", 0.0, owners) is None
    assert pe.breaker.failures == 4 and pe.breaker.state == "closed"
    for err in (RuntimeError("CUDA error: an illegal memory access"),
                ValueError("a bug")):
        def broken(*a, err=err, **kw):
            raise err

        monkeypatch.setattr(b8, "lex_ranks", broken)
        with pytest.raises(type(err)):
            pe.get_many("f", 0.0, owners)
        monkeypatch.setattr(b8, "sort_boards", broken)
        pe._boards[("f", 0.0)].sorted_valid = False
        with pytest.raises(type(err)):
            pe.flush_all()
        monkeypatch.undo()
    assert pe.breaker.failures == 4
    monkeypatch.setattr(b8, "lex_ranks", real)
    assert pe.get_many("f", 0.0, owners) == pc.get_many("f", 0.0, owners)
    # The JAX engine absorbs the same card error.
    (jc, je), _ = engines()
    jc.insert("f", 0.0, 1, "a", 1, 0)
    je.record_upsert("f", 0.0, 1, "a")
    monkeypatch.setattr(jax_b8, "lex_ranks", broken)
    assert je.get_many("f", 0.0, ["a"]) is None


class Left:
    """A request deadline with a fixed time left (no clock in the test)."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def remaining(self) -> float:
        return self.seconds

    def expired(self) -> bool:
        return self.seconds <= 0


def test_a_near_expired_deadline_still_reads_on_the_card(monkeypatch):
    """With 1 ms left a read still runs the engine's `lex_ranks` and
    answers the oracle's ranks, where the JAX engine serves it from its
    oracle (less than its 5 ms read budget left); an expired deadline
    fails the read with `DeadlineExceeded`, as storage does."""
    from nakama_tpu import overload as joverload
    from nakama_tpu_torch import overload as toverload

    (jc, je), (pc, pe) = engines()
    owners = [f"d{i}" for i in range(40)]
    for i, owner in enumerate(owners):
        for cache, engine in ((jc, je), (pc, pe)):
            cache.insert("dl", 0.0, 1, owner, i % 9, 0)
            engine.record_upsert("dl", 0.0, 1, owner)
    assert je.flush_all() and pe.flush_all()
    calls = []
    real = b8.lex_ranks
    monkeypatch.setattr(
        b8, "lex_ranks", lambda *a: calls.append(len(a[1])) or real(*a))
    with toverload.deadline_scope(Left(0.001)):
        assert pe.get_many("dl", 0.0, owners) == pc.get_many("dl", 0.0, owners)
    assert calls == [len(owners)] and pe.fallbacks == 0
    with joverload.deadline_scope(Left(0.001)):
        assert je.get_many("dl", 0.0, owners) is None
    with toverload.deadline_scope(Left(0.0)):
        with pytest.raises(toverload.DeadlineExceeded):
            pe.get_many("dl", 0.0, owners)
    assert calls == [len(owners)] and pe.fallbacks == 0


def test_lex_ranks_takes_its_plain_version_for_cpu_tensors():
    """On the CPU `lex_ranks` is its plain version and launches nothing;
    the hand kernel's wrapper refuses CPU tensors."""
    from nakama_tpu_torch import kernels

    rng = np.random.default_rng(1)
    sk, _ = b8.sort_boards(torch.from_numpy(_board_keys(rng, 1, 64)))
    q = sk[0, rng.integers(0, 64, size=9)].contiguous()
    before = kernels.LEX_RANKS.launches
    got = b8.lex_ranks(sk[0], q, b8.n_search_iters(64))
    assert torch.equal(got, b8.lex_ranks_plain(sk[0], q, b8.n_search_iters(64)))
    assert kernels.LEX_RANKS.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernels.lex_ranks(sk[0], q, 8)


def test_the_engine_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DeviceRankEngine(LeaderboardConfig(), port_logger(),
                         oracle=LeaderboardRankCache())

"""Mixed write-workload driver: ONE definition of the
storage + wallet + leaderboard write triple that concurrent writers
run against either engine. The port's copy of the JAX package's
`storage/workload.py`, over the port's `core/` and `leaderboard/`.
"""

from __future__ import annotations

WORKLOAD_USERS = 64


def workload_user_ids(n: int = WORKLOAD_USERS) -> list[str]:
    return [f"00000000-0000-4000-8000-{i:012d}" for i in range(n)]


async def setup_mixed_workload(db, log, leaderboard_id: str, config=None):
    """Seed the users and leaderboard the mixed writers target; returns
    ``(users, wallets, leaderboards)`` ready for `run_mixed_writer`.

    ``config`` (a full server Config) threads the leaderboard section
    through the shared rank-cache factory so workload-driven boards
    honor ``blacklist_rank_cache`` exactly like server-driven ones — a
    bare ``LeaderboardRankCache()`` here used to silently ignore it."""
    from ..core.wallet import Wallets
    from ..leaderboard.core import Leaderboards
    from ..leaderboard.rank_cache import (
        LeaderboardRankCache,
        rank_cache_from_config,
    )

    users = workload_user_ids()
    for i, uid in enumerate(users):
        await db.execute(
            "INSERT INTO users (id, username, create_time, update_time)"
            " VALUES (?, ?, 0, 0)",
            (uid, f"w{i}"),
        )
    wallets = Wallets(log, db)
    rank_cache = (
        rank_cache_from_config(config.leaderboard)
        if config is not None
        else LeaderboardRankCache()
    )
    lbs = Leaderboards(log, db, rank_cache)
    await lbs.create(leaderboard_id, sort_order="desc")
    return users, wallets, lbs


async def run_mixed_writer(
    db,
    users,
    wallets,
    lbs,
    leaderboard_id: str,
    writer_index: int,
    n_writers: int,
    should_stop,
    counts: list,
    key_space: int = 512,
    per_iter=None,
):
    """One concurrent mixed writer: a storage OCC write, a wallet
    update, and a leaderboard score submit per round (3 logical writes).
    Writers stride the index space (``i += n_writers``) so wallet
    guards contend on the engine, not on one row. ``counts[0]`` is the
    shared write counter; ``per_iter`` (optional) runs each round."""
    from ..core.storage import StorageOpWrite, storage_write_objects

    i = writer_index
    while not should_stop():
        if per_iter is not None:
            per_iter()
        uid = users[i % len(users)]
        await storage_write_objects(
            db,
            None,
            [
                StorageOpWrite(
                    collection="wl",
                    key=f"k{i % key_space}",
                    user_id=uid,
                    value='{"n": %d}' % i,
                )
            ],
        )
        await wallets.update_wallets(
            [{"user_id": uid, "changeset": {"gold": 1}, "metadata": {}}],
            True,
        )
        await lbs.record_write(
            leaderboard_id, uid, f"w{i % len(users)}", score=i
        )
        counts[0] += 3
        i += n_writers

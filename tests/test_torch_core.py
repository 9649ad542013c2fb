"""The port's `core/` held against the JAX package's.

Each test feeds the same numpy-seeded sequence of operations to the JAX
`nakama_tpu.core` and to `nakama_tpu_torch.core`, each over its own
SQLite file under `tmp_path`, and compares everything that comes back —
results, errors (type, message, code), rows left in the tables and the
envelopes routed to live sockets — after normalising the random ids the
services mint (in order of first appearance) and the times. Users are
seeded with fixed ids, so orders that follow user ids are the same in
both runs. Storage and wallets are also raced: 256 writers of one
version, 256 wallet changesets on one user.

Stated tolerance: none — these are exact host computations.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import re

import numpy as np

from fixtures import quiet_logger
from nakama_tpu_torch.logger import test_logger as port_logger

PKGS = ("nakama_tpu", "nakama_tpu_torch")
USERS = [f"00000000-0000-0000-0000-{i:012d}" for i in range(6)]
_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}-[0-9a-f]{12}")
_TIME_CURSOR = re.compile(r"^\d+(\.\d+)?(e[-+]?\d+)?\|")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def logger(pkg: str):
    return quiet_logger() if pkg == "nakama_tpu" else port_logger()


class Router:
    """Records what a service routes to a stream."""

    def __init__(self):
        self.sent: list = []

    def send_to_stream(self, stream, envelope):
        self.sent.append((stream.as_dict(), envelope))


class Normal:
    """Random ids (uuid4) named by first appearance; times as <time>."""

    def __init__(self):
        self.names: dict[str, str] = {}

    def _id(self, m) -> str:
        return self.names.setdefault(m.group(0), f"<id{len(self.names)}>")

    def __call__(self, obj):
        if isinstance(obj, dict):
            return {
                k: "<time>" if k.endswith("_time") and v else self(v)
                for k, v in obj.items()
            }
        if isinstance(obj, (list, tuple)):
            return [self(v) for v in obj]
        if isinstance(obj, str):
            return _UUID.sub(self._id, _TIME_CURSOR.sub("<time>|", obj))
        return obj


async def outcome(coro):
    """The result of `coro`, or its error as (type, message, code)."""
    try:
        return ["ok", await coro]
    except Exception as e:
        return ["error", type(e).__name__, str(e), getattr(e, "code", None)]


async def open_db(pkg: str, path) -> object:
    db = mod(pkg, "storage.db").Database(str(path), read_pool_size=2)
    await db.connect()
    for i, uid in enumerate(USERS):
        await db.execute(
            "INSERT INTO users (id, username, create_time, update_time)"
            " VALUES (?, ?, 1, 1)", (uid, f"user{i}"))
        await db.execute(
            "INSERT INTO user_device (id, user_id) VALUES (?, ?)",
            (f"device-of-user{i}", uid))
    return db


async def tables(db) -> dict:
    """Every row of the tables `core/` writes, in a fixed order."""
    out = {}
    for table, order in (
        ("users", "id"), ("user_device", "id"), ("user_tombstone", "user_id"),
        ("user_edge", "source_id, destination_id"),
        ("groups", "name"), ("group_edge", "source_id, destination_id"),
        ("storage", "collection, key, user_id"),
        ("notification", "create_time, subject, user_id"),
        ("message", "create_time, content"),
        ("wallet_ledger", "user_id, create_time, changeset"),
    ):
        rows = await db.fetch_all(f"SELECT * FROM {table} ORDER BY {order}")
        out[table] = [
            {k: (v.hex() if isinstance(v, bytes) else v)
             for k, v in r.items() if k not in ("password", "position")}
            for r in rows
        ]
    return out


async def both(tmp_path, script) -> tuple:
    """`script(pkg, db)` on each package's database; the normalised
    records of the JAX run and the port's."""
    runs = []
    for pkg in PKGS:
        db = await open_db(pkg, tmp_path / f"{pkg}.db")
        try:
            record = await script(pkg, db)
            record.append(await tables(db))
        finally:
            await db.close()
        runs.append(Normal()(json.loads(json.dumps(record, default=plain))))
    return runs[0], runs[1]


def plain(obj):
    """A service's dataclass (storage objects and acks) as a dict."""
    return obj.as_dict() if hasattr(obj, "as_dict") else vars(obj)


# ---------------------------------------------------------------- storage


async def test_storage_matches_jax(tmp_path):
    def plan():
        rng = np.random.default_rng(21)
        ops = []
        for step in range(60):
            owner = USERS[int(rng.integers(0, 3))]
            caller = [owner, USERS[int(rng.integers(0, 3))], None][
                int(rng.choice(3, p=[0.7, 0.15, 0.15]))]
            value = json.dumps({"v": int(rng.integers(0, 5))})
            if rng.random() < 0.05:
                value = ["[1]", "nope"][int(rng.integers(0, 2))]
            ops.append({
                "collection": f"c{int(rng.integers(0, 2))}",
                "key": f"k{int(rng.integers(0, 5))}",
                "user_id": "" if rng.random() < 0.1 else owner,
                "value": value,
                "version": ["", "*", "stale", "current"][int(rng.integers(0, 4))],
                "permission_read": int(rng.integers(0, 3 + (rng.random() < 0.05))),
                "permission_write": int(rng.integers(0, 2)),
                "caller": caller, "batch": int(rng.integers(1, 3)),
            })
        return ops

    async def script(pkg, db):
        core = mod(pkg, "core.storage")
        record = []
        for op in plan():
            row = await db.fetch_one(
                "SELECT version FROM storage WHERE collection = ? AND key = ?"
                " AND user_id = ?", (op["collection"], op["key"], op["user_id"]))
            version = {"stale": "0" * 32,
                       "current": row["version"] if row else "f" * 32}.get(
                op["version"], op["version"])
            writes = [core.StorageOpWrite(
                op["collection"], f"{op['key']}{'x' * j}", op["user_id"],
                op["value"], version, op["permission_read"], op["permission_write"])
                for j in range(op["batch"])]
            record.append(await outcome(core.storage_write_objects(
                db, op["caller"], writes)))
        # One object through each version rule: stale, if-absent over an
        # existing object, current, and the version it had before.
        acks = await core.storage_write_objects(db, USERS[0], [
            core.StorageOpWrite("fixed", "k", USERS[0], '{"a": 1}')])
        for version in ("0" * 32, "*", acks[0].version, acks[0].version, ""):
            record.append(await outcome(core.storage_write_objects(db, USERS[0], [
                core.StorageOpWrite("fixed", "k", USERS[0], '{"a": 2}', version)])))
        for caller in (None, *USERS[:3]):
            record.append(await outcome(core.storage_read_objects(db, caller, [
                core.StorageOpRead(c, k, u) for c in ("c0", "c1")
                for k in ("k0", "k1", "k2x") for u in ("", *USERS[:3])])))
            for collection in ("c0", "c1"):
                for owner in (None, USERS[1]):
                    cursor, pages = "", []
                    while True:
                        objects, cursor = await core.storage_list_objects(
                            db, caller, collection, user_id=owner, limit=2,
                            cursor=cursor)
                        pages.append([objects, cursor])
                        if not cursor:
                            break
                    record.append(pages)
        record.append(await outcome(core.storage_list_objects(
            db, None, "c0", cursor="garbage")))
        deletes = [
            (USERS[0], [core.StorageOpDelete("c0", "k1", USERS[0], "0" * 32)]),
            (USERS[0], [core.StorageOpDelete("c0", "k1", USERS[1])]),
            (USERS[1], [core.StorageOpDelete("c1", f"k{i}", USERS[1])
                        for i in range(5)]),
            (None, [core.StorageOpDelete("c0", f"k{i}", USERS[2])
                    for i in range(5)]),
            (USERS[2], [core.StorageOpDelete("c0", "none", USERS[2], "v")]),
        ]
        for caller, ops in deletes:
            record.append(await outcome(core.storage_delete_objects(db, caller, ops)))
        return record

    want, got = await both(tmp_path, script)
    assert got == want
    # The script met every answer: acks, version and permission refusals,
    # invalid values.
    flat = json.dumps(want)
    for text in ("version check failed", "write permission denied",
                 "cannot write system-owned objects", "value must be",
                 "invalid permission values", "invalid cursor"):
        assert text in flat


async def test_storage_writers_racing_one_version_match_jax(tmp_path):
    """256 writers with the version they read: exactly one wins, in
    either package; 256 if-absent inserts of one key: one wins."""
    async def script(pkg, db):
        core = mod(pkg, "core.storage")
        acks = await core.storage_write_objects(db, USERS[0], [
            core.StorageOpWrite("race", "k", USERS[0], '{"n": -1}')])

        async def write(i, version):
            return await outcome(core.storage_write_objects(db, USERS[0], [
                core.StorageOpWrite("race", "k", USERS[0], json.dumps({"n": i}),
                                    version)]))

        racing = await asyncio.gather(*(write(i, acks[0].version)
                                        for i in range(256)))
        inserts = await asyncio.gather(*(outcome(core.storage_write_objects(
            db, USERS[1], [core.StorageOpWrite("race", "new", USERS[1],
                                               json.dumps({"n": i}), "*")]))
            for i in range(256)))
        return [sorted(r[0] for r in racing), sorted(r[0] for r in inserts),
                sorted({r[2] for r in racing + inserts if r[0] == "error"})]

    want, got = await both(tmp_path, script)
    assert got[:3] == want[:3]
    assert got[0].count("ok") == got[1].count("ok") == 1
    assert got[2] == ["version check failed"]


# ---------------------------------------------------------------- account


async def test_account_matches_jax(tmp_path):
    async def script(pkg, db):
        core = mod(pkg, "core.account")
        storage = mod(pkg, "core.storage")
        record = []
        for kw in ({"display_name": "Ada", "timezone": "UTC", "lang_tag": "fr",
                    "location": "here", "avatar_url": "u", "metadata": {"a": 1}},
                   {"username": "bad name"}, {"username": "user2"},
                   {"username": "renamed"}, {}):
            record.append(await outcome(core.update_account(db, USERS[1], **kw)))
        record.append(await outcome(core.update_account(
            db, "00000000-0000-0000-0000-999999999999", display_name="x")))
        record.append(await outcome(core.get_account(db, USERS[1])))
        record.append(await core.get_users(
            db, user_ids=USERS[:4], usernames=["renamed", "user3", "nobody"]))
        await storage.storage_write_objects(db, None, [
            storage.StorageOpWrite("c", "k", USERS[3], '{"x": 1}')])
        await db.execute(
            "INSERT INTO leaderboard_record (leaderboard_id, owner_id, username,"
            " score, subscore, num_score, metadata, create_time, update_time,"
            " expiry_time, max_num_score) VALUES ('b', ?, 'u', 5, 0, 1, '{}',"
            " 1, 1, 0, 0)", (USERS[3],))
        record.append(await core.export_account(db, USERS[3]))
        await core.ban_users(db, USERS[4:6])
        await core.unban_users(db, USERS[5:6])
        record.append(len(await core.users_get_random(db, 10)))
        record.append(await outcome(core.delete_account(db, USERS[3], recorded=True)))
        record.append(await outcome(core.delete_account(db, USERS[2])))
        record.append(await outcome(core.get_account(db, USERS[3])))
        record.append(await db.fetch_all("SELECT * FROM leaderboard_record"))
        return record

    want, got = await both(tmp_path, script)
    assert got == want
    # The deleted account is gone, its board record with it.
    assert want[-3][0] == "error" and want[-2] == []


async def test_link_matches_jax(tmp_path):
    async def script(pkg, db):
        link = mod(pkg, "core.link")
        u, v = USERS[0], USERS[1]
        steps = [
            link.link_custom(db, u, "custom-one"), link.link_custom(db, v, "custom-one"),
            link.link_custom(db, u, "abc"),
            link.link_email(db, u, "One@Example.com", "password1"),
            link.link_email(db, v, "one@example.com", "password2"),
            link.link_email(db, u, "bad", "password1"),
            link.link_device(db, u, "device-extra-1"),
            link.link_device(db, u, "device-extra-1"),
            link.link_device(db, u, "device-of-user1"), link.link_device(db, u, "short"),
            link.unlink_custom(db, u), link.unlink_custom(db, u),
            link.unlink_email(db, u), link.unlink_device(db, u, "device-extra-1"),
            link.unlink_device(db, u, "device-of-user0"),
            link.unlink_device(db, v, "device-of-user0"),
            link.unlink_email(db, u),
        ]
        return [await outcome(s) for s in steps]

    want, got = await both(tmp_path, script)
    assert got == want
    assert ["error", "AuthError", "cannot unlink last auth method",
            "failed_precondition"] in want


# ----------------------------------------------------------------- wallet


async def test_wallet_matches_jax(tmp_path):
    async def script(pkg, db):
        wallet = mod(pkg, "core.wallet")
        storage = mod(pkg, "core.storage")
        wallets = wallet.Wallets(logger(pkg), db)
        rng = np.random.default_rng(8)
        record = []
        for _ in range(24):
            updates = [{"user_id": USERS[int(i)],
                        "changeset": {"coins": int(rng.integers(-6, 10)),
                                      "gems": int(rng.integers(-1, 3))},
                        "metadata": {"r": int(rng.integers(0, 9))}}
                       for i in rng.choice(3, size=int(rng.integers(1, 3)),
                                           replace=False)]
            record.append(await outcome(wallets.update_wallets(updates)))
        for bad in ({"coins": 1.5}, {"coins": True}):
            record.append(await outcome(wallets.update_wallets(
                [{"user_id": USERS[0], "changeset": bad}])))
        record.append(await outcome(wallets.update_wallets(
            [{"user_id": "nobody", "changeset": {"coins": 1}}])))
        # One user twice in a call (the transaction path); its two ledger
        # rows share a time, so they go to a user whose ledger is not
        # listed (a listing orders them by their random ids).
        record.append(await outcome(wallets.update_wallets(
            [{"user_id": USERS[3], "changeset": {"coins": 1}},
             {"user_id": USERS[3], "changeset": {"coins": 2}}])))
        record.append(await outcome(wallets.update_wallets(
            [{"user_id": USERS[1], "changeset": {"coins": 5}}], update_ledger=False)))
        record.append([await wallets.get(u) for u in USERS[:4]])
        cursor, pages = "", []
        while True:
            items, cursor = await wallets.list_ledger(USERS[0], limit=4, cursor=cursor)
            pages.append(items)
            if not cursor:
                break
        record.append(pages)
        record.append(await outcome(wallets.ledger_update(pages[0][0]["id"], {"m": 1})))
        record.append(await outcome(wallets.ledger_update("nope", {})))
        record.append(await outcome(wallets.list_ledger(USERS[0], cursor="x")))
        record.append(await outcome(wallet.multi_update(
            db, wallets,
            wallet_updates=[{"user_id": USERS[2], "changeset": {"coins": 3}}],
            storage_writes=[storage.StorageOpWrite("m", "k", USERS[2], '{"a": 1}')],
            account_updates=[{"user_id": USERS[2], "display_name": "Multi",
                              "evil; DROP": "x"}])))
        record.append(await outcome(wallet.multi_update(
            db, wallets,
            wallet_updates=[{"user_id": USERS[2], "changeset": {"coins": -10**6}}],
            storage_writes=[storage.StorageOpWrite("m", "k2", USERS[2], '{"a": 2}')])))
        return record

    want, got = await both(tmp_path, script)
    assert got == want
    assert "insufficient_funds" in json.dumps(want)


async def test_wallet_changesets_racing_on_one_user_sum_exactly(tmp_path):
    """256 concurrent changesets on one wallet (some refused for going
    negative): the balance is the sum of the accepted ones, and the
    ledger holds exactly those, in either package."""
    deltas = np.random.default_rng(3).integers(-3, 8, size=256).tolist()

    async def script(pkg, db):
        wallets = mod(pkg, "core.wallet").Wallets(logger(pkg), db)
        await wallets.update_wallets([{"user_id": USERS[0],
                                       "changeset": {"coins": 20}}])
        results = await asyncio.gather(*(outcome(wallets.update_wallets(
            [{"user_id": USERS[0], "changeset": {"coins": d}}])) for d in deltas))
        accepted = [d for d, r in zip(deltas, results) if r[0] == "ok"]
        ledger = await db.fetch_all(
            "SELECT changeset FROM wallet_ledger WHERE user_id = ?", (USERS[0],))
        balance = (await wallets.get(USERS[0]))["coins"]
        assert balance == 20 + sum(accepted) >= 0
        assert sorted(json.loads(r["changeset"])["coins"] for r in ledger) == sorted(
            [20] + accepted)
        assert all(r[0] == "ok" or r[3] == "insufficient_funds" for r in results)
        return [len(accepted)]

    await both(tmp_path, script)


# ---------------------------------------------------------- notifications


async def test_notifications_match_jax(tmp_path):
    async def script(pkg, db):
        router = Router()
        notes = mod(pkg, "core.notification").Notifications(logger(pkg), db, router)
        record = [await outcome(notes.send(USERS[0], "", {}, 1))]
        record.append(await notes.send(USERS[0], "hello", {"a": 1}, 5,
                                       sender_id=USERS[1], persistent=True))
        record.append(await notes.send(USERS[0], "ephemeral", {}, 6))
        record.append(await notes.send_many([
            {"id": f"00000000-0000-4000-8000-{i:012d}", "user_id": USERS[i % 3],
             "subject": f"s{i}", "content": {"i": i}, "code": i,
             "persistent": i % 2 == 0} for i in range(9)]))
        record.append(await notes.send_all("to all", {"b": 2}, 7, persistent=True,
                                           batch_size=4))
        cursor, pages = "", []
        for _ in range(5):
            page = await notes.list(USERS[0], limit=2, cursor=cursor)
            pages.append(page)
            if not page["notifications"]:
                break
            cursor = page["cacheable_cursor"]
        record.append(pages)
        record.append(await outcome(notes.list(USERS[0], cursor="bad")))
        first = pages[0]["notifications"][0]["id"]
        await notes.delete(USERS[1], [first])
        record.append(len((await notes.list(USERS[0]))["notifications"]))
        await notes.delete(USERS[0], [first, "nope"])
        await notes.delete(USERS[0], [])
        record.append(len((await notes.list(USERS[0]))["notifications"]))
        record.append(router.sent)
        return record

    want, got = await both(tmp_path, script)
    assert got == want


# ---------------------------------------------------------------- friends


async def test_friends_match_jax(tmp_path):
    async def script(pkg, db):
        router = Router()
        log = logger(pkg)
        notes = mod(pkg, "core.notification").Notifications(log, db, router)
        friends = mod(pkg, "core.friend").Friends(log, db, notes)
        a, b, c, d = USERS[:4]
        steps = [
            ("add", a, b), ("add", a, b), ("add", b, a), ("add", b, a),
            ("add", a, a), ("add", a, "00000000-0000-0000-0000-999999999999"),
            ("add", c, a), ("block", a, c), ("add", c, a), ("add", a, c),
            ("delete", a, c), ("unblock", a, c), ("add", a, c),
            ("block", d, a), ("add", a, d), ("delete", a, b), ("add", a, d),
            ("block", a, a), ("add", b, d), ("add", d, b), ("delete", d, b),
            ("unblock", d, a),
        ]
        record = []
        for op, user, other in steps:
            if op == "add":
                coro = friends.add(user, f"name-{user[-1]}", other)
            elif op == "block":
                coro = friends.block(user, f"name-{user[-1]}", other)
            elif op == "delete":
                coro = friends.delete(user, other)
            else:
                coro = friends.unblock(user, other)
            record.append([op, await outcome(coro)])
            record.append(["states", [[await friends.state_of(x, y)
                                       for y in USERS[:4]] for x in USERS[:4]]])
        for user in USERS[:4]:
            record.append(await friends.list(user))
            record.append(await friends.list(user, limit=1, cursor="1"))
            record.append(await friends.list(user, state=1))
        record.append(await outcome(friends.list(a, cursor="x")))
        record.append(router.sent)
        return record

    want, got = await both(tmp_path, script)
    assert got == want
    states = {s for step in want if isinstance(step, list) and step[0] == "states"
              for row in step[1] for s in row}
    assert states == {None, 0, 1, 2, 3}


# ----------------------------------------------------------------- groups


async def test_groups_match_jax(tmp_path):
    async def script(pkg, db):
        groups = mod(pkg, "core.group").Groups(logger(pkg), db)
        a, b, c, d, e, f = USERS
        record = []
        g1 = await groups.create(a, "Guild", description="d", max_count=3,
                                 metadata={"t": 1})
        g2 = await groups.create(b, "Closed", open=False)
        record += [g1, g2]
        record.append(await outcome(groups.create(c, "Guild")))
        record.append(await outcome(groups.create(c, "")))
        record.append(await outcome(groups.create(c, "Zero", max_count=0)))
        gid, cid = g1["id"], g2["id"]
        steps = [
            groups.join(gid, b), groups.join(gid, c), groups.join(gid, d),
            groups.join(gid, b), groups.join(cid, a), groups.join(cid, a),
            groups.users_add(cid, [a], caller_id=c), groups.users_add(cid, [a], caller_id=b),
            groups.users_add(cid, [c, d], caller_id=b),
            groups.users_promote(gid, [b, c], caller_id=a),
            groups.users_promote(gid, [b], caller_id=a),
            groups.users_demote(gid, [b], caller_id=c),
            groups.users_demote(gid, [a], caller_id=a),
            groups.users_kick(gid, [c, a], caller_id=b),
            groups.users_ban(gid, [c, a], caller_id=b), groups.join(gid, c),
            groups.join(gid, e), groups.users_kick(gid, [d], caller_id=e),
            groups.leave(gid, a), groups.leave(gid, b), groups.leave(gid, f),
            groups.leave(gid, a),
            groups.update(gid, caller_id=d, description="x"),
            groups.update(gid, caller_id=a, description="new", open=False,
                          max_count=5, metadata={"t": 2}, bogus=1),
            groups.update(gid, name="Renamed"), groups.update(gid),
            groups.join(gid, f), groups.users_add(gid, [f], caller_id=a),
            groups.delete(cid, caller_id=a), groups.delete(cid, caller_id=b),
            groups.join(cid, a), groups.get("nope"),
        ]
        for step in steps:
            record.append(await outcome(step))
            record.append(await groups.users_list(gid))
        for user in USERS:
            record.append(await groups.user_groups_list(user))
        record.append(await groups.users_list(gid, limit=1, cursor="1", state=2))
        record.append(await groups.list(name="Ren%"))
        record.append(await groups.list(limit=1))
        record.append(await groups.list(open=False, lang_tag="en"))
        record.append(await groups.get_many([gid, cid, "nope"]))
        record.append(len(await groups.get_random(5)))
        return record

    want, got = await both(tmp_path, script)
    assert got == want
    flat = json.dumps(want)
    for text in ("group is full", "banned from group", "must be a group admin",
                 "cannot leave as the last superadmin", "must be the group superadmin"):
        assert text in flat


# --------------------------------------------------------------- channels


async def test_channels_match_jax(tmp_path):
    a, b = USERS[2], USERS[1]
    for pkg in PKGS:
        channel = mod(pkg, "core.channel")
        ids = [channel.stream_to_channel_id(channel.channel_to_stream(t, target, a))
               for t, target in ((1, "lobby"), (2, "g-1"), (3, b))]
        assert ids == ["2...lobby", "3.g-1..", f"4.{b}.{a}."]
        assert [channel.channel_id_to_stream(i) for i in ids] == [
            channel.channel_to_stream(t, target, a)
            for t, target in ((1, "lobby"), (2, "g-1"), (3, b))]

    async def script(pkg, db):
        router = Router()
        channel = mod(pkg, "core.channel")
        chans = channel.Channels(logger(pkg), db, router)
        record = []
        for t, target in ((1, "lobby"), (1, ""), (1, "a.b"), (1, "x" * 65),
                          (2, "g"), (2, ""), (3, b), (3, a), (3, ""), (7, "x")):
            record.append(await outcome(_build(channel, t, target, a)))
        for bad in ("", "2..lobby", "9...x", "2.s..lobby", "3...", "3.g.c.",
                    "4.a..", "4.a.b.l", "x...y", "0.a.b.c"):
            record.append(await outcome(_parse(channel, bad)))
        dm = f"4.{b}.{a}."
        sent = []
        for i in range(5):
            m = await chans.message_send(dm, {"n": i}, sender_id=[a, b][i % 2],
                                         sender_username=f"u{i % 2}",
                                         persist=i != 3)
            sent.append(m)
            await asyncio.sleep(0.002)
        record.append(sent)
        record.append(await outcome(chans.message_send(dm, ["not", "dict"])))
        record.append(await outcome(chans.message_send("bad", {})))
        record.append(await outcome(chans.message_update(
            dm, sent[0]["message_id"], {"n": 10}, sender_id=a)))
        record.append(await outcome(chans.message_update(
            dm, sent[0]["message_id"], {"n": 11}, sender_id=b)))
        record.append(await outcome(chans.message_update(dm, "nope", {}, sender_id=a)))
        record.append(await outcome(chans.message_remove(
            dm, sent[1]["message_id"], sender_id=a)))
        record.append(await outcome(chans.message_remove(
            "2...lobby", sent[1]["message_id"], sender_id=b)))
        record.append(await outcome(chans.message_remove(
            dm, sent[1]["message_id"], sender_id=b)))
        record.append(await outcome(chans.message_remove(
            dm, sent[2]["message_id"], authoritative=True)))
        for forward in (True, False):
            cursor, pages = "", []
            while True:
                page = await chans.messages_list(dm, limit=1, forward=forward,
                                                 cursor=cursor)
                pages.append(page)
                cursor = page["next_cursor"]
                if not cursor:
                    break
            record.append(pages)
        record.append(await chans.messages_list("2...lobby"))
        record.append(await outcome(chans.messages_list(dm, cursor="bad")))
        record.append(chans.channel_id_build(a, b, 3))
        record.append(router.sent)
        return record

    want, got = await both(tmp_path, script)
    assert got == want
    assert "cannot update another user's message" in json.dumps(want)


async def _build(channel, t, target, sender):
    return channel.stream_to_channel_id(channel.channel_to_stream(t, target, sender))


async def _parse(channel, channel_id):
    return channel.channel_id_to_stream(channel_id).as_dict()

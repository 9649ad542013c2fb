"""Account + user core (reference server/core_account.go 534 LoC,
core_user.go 331 LoC): account fetch with devices/wallet, profile update,
delete-with-tombstone, batch user get. The port's copy of the JAX
package's `core/account.py`."""

from __future__ import annotations

import json
import time

from ..storage.db import Database, UniqueViolationError
from .authenticate import AuthError, _USERNAME_RE


async def get_account(db: Database, user_id: str) -> dict:
    """Full own-account view (reference GetAccount core_account.go)."""
    row = await db.fetch_one("SELECT * FROM users WHERE id = ?", (user_id,))
    if row is None:
        raise AuthError("account not found", "not_found")
    devices = await db.fetch_all(
        "SELECT id FROM user_device WHERE user_id = ?", (user_id,)
    )
    return {
        "user": _row_to_user(row),
        "wallet": row["wallet"],
        "email": row["email"] or "",
        "devices": [{"id": d["id"]} for d in devices],
        "custom_id": row["custom_id"] or "",
        "verify_time": row["verify_time"],
        "disable_time": row["disable_time"],
    }


async def update_account(
    db: Database,
    user_id: str,
    username: str | None = None,
    display_name: str | None = None,
    timezone: str | None = None,
    location: str | None = None,
    lang_tag: str | None = None,
    avatar_url: str | None = None,
    metadata: dict | None = None,
) -> None:
    """Partial profile update (reference UpdateAccounts core_account.go):
    None leaves a field untouched."""
    sets: list[str] = []
    params: list = []
    if username is not None:
        if not _USERNAME_RE.match(username):
            raise AuthError("invalid username")
        sets.append("username = ?")
        params.append(username)
    for col, val in (
        ("display_name", display_name),
        ("timezone", timezone),
        ("location", location),
        ("lang_tag", lang_tag),
        ("avatar_url", avatar_url),
    ):
        if val is not None:
            sets.append(f"{col} = ?")
            params.append(val)
    if metadata is not None:
        sets.append("metadata = ?")
        params.append(json.dumps(metadata))
    if not sets:
        return
    sets.append("update_time = ?")
    params.append(time.time())
    params.append(user_id)
    try:
        n = await db.execute(
            f"UPDATE users SET {', '.join(sets)} WHERE id = ?", params
        )
    except UniqueViolationError as e:
        raise AuthError("username already in use", "already_exists") from e
    if n == 0:
        raise AuthError("account not found", "not_found")


async def delete_account(
    db: Database, user_id: str, recorded: bool = False
) -> None:
    """Delete account + owned rows; optionally leave a tombstone so the id
    can be recognised as deleted (reference DeleteAccount core_account.go,
    user_tombstone table)."""
    async with db.tx() as tx:
        if recorded:
            await tx.execute(
                "INSERT OR REPLACE INTO user_tombstone (user_id, create_time)"
                " VALUES (?, ?)",
                (user_id, time.time()),
            )
        for sql in (
            "DELETE FROM user_device WHERE user_id = ?",
            "DELETE FROM user_edge WHERE source_id = ? OR destination_id = ?",
            "DELETE FROM notification WHERE user_id = ?",
            "DELETE FROM storage WHERE user_id = ?",
            "DELETE FROM wallet_ledger WHERE user_id = ?",
            "DELETE FROM group_edge WHERE source_id = ? OR destination_id = ?",
            "DELETE FROM leaderboard_record WHERE owner_id = ?",
            "DELETE FROM users WHERE id = ?",
        ):
            await tx.execute(
                sql, (user_id, user_id) if sql.count("?") == 2 else (user_id,)
            )


async def export_account(db: Database, user_id: str) -> dict:
    """Everything the server holds about one user in one JSON document
    (reference ExportAccount, core_account.go: account + storage objects +
    wallet ledger + friends + groups + messages + leaderboard records)."""
    account = await get_account(db, user_id)
    objects = await db.fetch_all(
        "SELECT collection, key, value, version, read, write, create_time,"
        " update_time FROM storage WHERE user_id = ?",
        (user_id,),
    )
    ledger = await db.fetch_all(
        "SELECT id, changeset, metadata, create_time FROM wallet_ledger"
        " WHERE user_id = ? ORDER BY create_time",
        (user_id,),
    )
    friends = await db.fetch_all(
        "SELECT destination_id, state, update_time FROM user_edge"
        " WHERE source_id = ?",
        (user_id,),
    )
    groups = await db.fetch_all(
        "SELECT source_id AS group_id, state, update_time FROM group_edge"
        " WHERE destination_id = ?",
        (user_id,),
    )
    messages = await db.fetch_all(
        "SELECT id, code, content, create_time, stream_mode,"
        " stream_subject, stream_subcontext, stream_label FROM message"
        " WHERE sender_id = ? ORDER BY create_time",
        (user_id,),
    )
    records = await db.fetch_all(
        "SELECT leaderboard_id, score, subscore, num_score, metadata,"
        " create_time, update_time, expiry_time FROM leaderboard_record"
        " WHERE owner_id = ?",
        (user_id,),
    )
    return {
        "account": account,
        "objects": [dict(r) for r in objects],
        "wallet_ledgers": [dict(r) for r in ledger],
        "friends": [dict(r) for r in friends],
        "groups": [dict(r) for r in groups],
        "messages": [dict(r) for r in messages],
        "leaderboard_records": [dict(r) for r in records],
    }


async def get_users(
    db: Database,
    user_ids: list[str] | None = None,
    usernames: list[str] | None = None,
) -> list[dict]:
    """Batch fetch by ids and/or usernames (reference GetUsers
    core_user.go)."""
    out: list[dict] = []
    if user_ids:
        marks = ", ".join("?" for _ in user_ids)
        out.extend(
            await db.fetch_all(
                f"SELECT * FROM users WHERE id IN ({marks})", user_ids
            )
        )
    if usernames:
        marks = ", ".join("?" for _ in usernames)
        out.extend(
            await db.fetch_all(
                f"SELECT * FROM users WHERE username IN ({marks})", usernames
            )
        )
    seen: set[str] = set()
    users = []
    for row in out:
        if row["id"] in seen:
            continue
        seen.add(row["id"])
        users.append(_row_to_user(row))
    return users


def _row_to_user(row: dict) -> dict:
    """Public user view — identity columns redacted to booleans the way the
    reference's api.User exposes facebook_id etc. only as linkage flags."""
    return {
        "id": row["id"],
        "username": row["username"],
        "display_name": row["display_name"] or "",
        "avatar_url": row["avatar_url"] or "",
        "lang_tag": row["lang_tag"] or "en",
        "location": row["location"] or "",
        "timezone": row["timezone"] or "",
        "metadata": row["metadata"],
        "edge_count": row["edge_count"],
        "create_time": row["create_time"],
        "update_time": row["update_time"],
        "facebook_id": row["facebook_id"] or "",
        "google_id": row["google_id"] or "",
        "gamecenter_id": row["gamecenter_id"] or "",
        "steam_id": row["steam_id"] or "",
        "apple_id": row["apple_id"] or "",
    }


async def ban_users(db: Database, user_ids: list[str]) -> None:
    """Set disable_time so every auth path rejects the account (reference
    BanUsers, core_user.go; callers also ban the session cache + disconnect
    live sessions — see nk.users_ban_id)."""
    now = time.time()
    for uid in user_ids:
        await db.execute(
            "UPDATE users SET disable_time = ? WHERE id = ?", (now, uid)
        )


async def unban_users(db: Database, user_ids: list[str]) -> None:
    """Clear disable_time (reference UnbanUsers, core_user.go)."""
    for uid in user_ids:
        await db.execute(
            "UPDATE users SET disable_time = 0 WHERE id = ?", (uid,)
        )


async def users_get_random(db: Database, count: int) -> list[dict]:
    """Random user sample (reference UsersGetRandom, core_user.go:
    TABLESAMPLE equivalent — SQLite random ordering at these counts)."""
    rows = await db.fetch_all(
        "SELECT * FROM users WHERE disable_time = 0"
        " ORDER BY RANDOM() LIMIT ?",
        (max(0, min(int(count), 1000)),),
    )
    return [_row_to_user(r) for r in rows]

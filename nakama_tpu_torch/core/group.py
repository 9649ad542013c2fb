"""Groups: roles, open/closed join flows, edge counts, cursored listings.

Parity: reference server/core_group.go (2,290 LoC): `groups` rows with
edge_count/max_count, `group_edge` rows keyed (group→user) with role
states SUPERADMIN(0)/ADMIN(1)/MEMBER(2)/JOIN_REQUEST(3)/BANNED(4); open
groups admit joins directly, closed groups create join requests that
admins accept; the last superadmin cannot leave; kicks/promotes/demotes
are admin-gated; edge_count is maintained transactionally against
max_count. The port's copy of the JAX package's `core/group.py`.
"""

from __future__ import annotations

import json
import time
import uuid

from ..storage.db import Database

SUPERADMIN = 0
ADMIN = 1
MEMBER = 2
JOIN_REQUEST = 3
BANNED = 4

_MEMBER_STATES = (SUPERADMIN, ADMIN, MEMBER)


class GroupError(Exception):
    def __init__(self, message: str, code: str = "invalid"):
        super().__init__(message)
        self.code = code


class Groups:
    def __init__(self, logger, db: Database):
        self.logger = logger.with_fields(subsystem="group")
        self.db = db

    # ------------------------------------------------------------ helpers

    async def _group(self, tx, group_id: str) -> dict:
        row = await tx.fetch_one(
            "SELECT * FROM groups WHERE id = ? AND disable_time = 0",
            (group_id,),
        )
        if row is None:
            raise GroupError("group not found", "not_found")
        return row

    async def _edge_state(self, tx, group_id, user_id) -> int | None:
        row = await tx.fetch_one(
            "SELECT state FROM group_edge WHERE source_id = ?"
            " AND destination_id = ?",
            (group_id, user_id),
        )
        return None if row is None else row["state"]

    async def _set_edge(self, tx, group_id, user_id, state, now):
        await tx.execute(
            "INSERT INTO group_edge (source_id, destination_id, state,"
            " position, update_time) VALUES (?, ?, ?, ?, ?)"
            " ON CONFLICT (source_id, destination_id) DO UPDATE SET"
            " state = ?, update_time = ?",
            (group_id, user_id, state, int(now * 1e9), now, state, now),
        )

    async def _bump_count(self, tx, group_id: str, delta: int, now: float):
        await tx.execute(
            "UPDATE groups SET edge_count = edge_count + ?, update_time = ?"
            " WHERE id = ?",
            (delta, now, group_id),
        )

    async def _require_admin(self, tx, group_id, user_id):
        state = await self._edge_state(tx, group_id, user_id)
        if state not in (SUPERADMIN, ADMIN):
            raise GroupError(
                "must be a group admin", "permission_denied"
            )
        return state

    # --------------------------------------------------------------- CRUD

    async def create(
        self,
        creator_id: str,
        name: str,
        *,
        description: str = "",
        avatar_url: str = "",
        lang_tag: str = "en",
        metadata: dict | None = None,
        open: bool = True,
        max_count: int = 100,
    ) -> dict:
        if not name:
            raise GroupError("group name required")
        if max_count < 1:
            raise GroupError("max_count must be >= 1")
        group_id = str(uuid.uuid4())
        now = time.time()
        async with self.db.tx() as tx:
            existing = await tx.fetch_one(
                "SELECT id FROM groups WHERE name = ?", (name,)
            )
            if existing is not None:
                raise GroupError(
                    "group name already in use", "already_exists"
                )
            await tx.execute(
                "INSERT INTO groups (id, creator_id, name, description,"
                " avatar_url, lang_tag, metadata, state, edge_count,"
                " max_count, create_time, update_time)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, 1, ?, ?, ?)",
                (
                    group_id, creator_id, name, description, avatar_url,
                    lang_tag, json.dumps(metadata or {}),
                    0 if open else 1, max_count, now, now,
                ),
            )
            await self._set_edge(tx, group_id, creator_id, SUPERADMIN, now)
        return await self.get(group_id)

    async def get(self, group_id: str) -> dict:
        async with self.db.tx() as tx:
            return self._row_to_group(await self._group(tx, group_id))

    async def get_random(self, count: int) -> list[dict]:
        """Random open-group sample (reference GroupsGetRandom,
        core_group.go)."""
        rows = await self.db.fetch_all(
            "SELECT * FROM groups WHERE disable_time = 0"
            " ORDER BY RANDOM() LIMIT ?",
            (max(0, min(int(count), 1000)),),
        )
        return [self._row_to_group(r) for r in rows]

    async def get_many(self, group_ids: list[str]) -> list[dict]:
        out = []
        for gid in group_ids:
            try:
                out.append(await self.get(gid))
            except GroupError:
                pass
        return out

    async def update(
        self, group_id: str, caller_id: str = "", **fields
    ):
        """Admin-gated field update (reference UpdateGroup). caller_id ''
        = system caller."""
        allowed = {
            "name", "description", "avatar_url", "lang_tag", "metadata",
            "open", "max_count",
        }
        now = time.time()
        async with self.db.tx() as tx:
            await self._group(tx, group_id)
            if caller_id:
                await self._require_admin(tx, group_id, caller_id)
            sets, params = [], []
            for key, value in fields.items():
                if value is None or key not in allowed:
                    continue
                if key == "metadata":
                    sets.append("metadata = ?")
                    params.append(json.dumps(value))
                elif key == "open":
                    sets.append("state = ?")
                    params.append(0 if value else 1)
                else:
                    sets.append(f"{key} = ?")
                    params.append(value)
            if not sets:
                return
            sets.append("update_time = ?")
            params.append(now)
            params.append(group_id)
            await tx.execute(
                f"UPDATE groups SET {', '.join(sets)} WHERE id = ?",
                params,
            )

    async def delete(self, group_id: str, caller_id: str = ""):
        """Superadmin-only (reference DeleteGroup)."""
        async with self.db.tx() as tx:
            await self._group(tx, group_id)
            if caller_id:
                state = await self._edge_state(tx, group_id, caller_id)
                if state != SUPERADMIN:
                    raise GroupError(
                        "must be the group superadmin", "permission_denied"
                    )
            await tx.execute(
                "DELETE FROM group_edge WHERE source_id = ?", (group_id,)
            )
            await tx.execute(
                "DELETE FROM groups WHERE id = ?", (group_id,)
            )

    # --------------------------------------------------------------- join

    async def join(self, group_id: str, user_id: str, username: str = ""):
        """Open group → member; closed → join request (reference
        JoinGroup)."""
        now = time.time()
        async with self.db.tx() as tx:
            group = await self._group(tx, group_id)
            state = await self._edge_state(tx, group_id, user_id)
            if state in _MEMBER_STATES:
                return
            if state == BANNED:
                raise GroupError("banned from group", "permission_denied")
            if state == JOIN_REQUEST:
                return
            if group["state"] == 0:  # open
                if group["edge_count"] >= group["max_count"]:
                    raise GroupError("group is full")
                await self._set_edge(tx, group_id, user_id, MEMBER, now)
                await self._bump_count(tx, group_id, 1, now)
            else:
                await self._set_edge(
                    tx, group_id, user_id, JOIN_REQUEST, now
                )

    async def leave(self, group_id: str, user_id: str):
        """The last superadmin cannot leave (reference LeaveGroup)."""
        now = time.time()
        async with self.db.tx() as tx:
            await self._group(tx, group_id)
            state = await self._edge_state(tx, group_id, user_id)
            if state is None or state == BANNED:
                return
            if state == SUPERADMIN:
                others = await tx.fetch_one(
                    "SELECT COUNT(*) AS n FROM group_edge"
                    " WHERE source_id = ? AND state = ?"
                    " AND destination_id != ?",
                    (group_id, SUPERADMIN, user_id),
                )
                if not others["n"]:
                    raise GroupError(
                        "cannot leave as the last superadmin", "invalid"
                    )
            await tx.execute(
                "DELETE FROM group_edge WHERE source_id = ?"
                " AND destination_id = ?",
                (group_id, user_id),
            )
            if state in _MEMBER_STATES:
                await self._bump_count(tx, group_id, -1, now)

    async def users_add(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        """Admin accepts join requests / directly adds users (reference
        AddGroupUsers)."""
        now = time.time()
        async with self.db.tx() as tx:
            group = await self._group(tx, group_id)
            if caller_id:
                await self._require_admin(tx, group_id, caller_id)
            for uid in user_ids:
                state = await self._edge_state(tx, group_id, uid)
                if state in _MEMBER_STATES:
                    continue
                if group["edge_count"] >= group["max_count"]:
                    raise GroupError("group is full")
                await self._set_edge(tx, group_id, uid, MEMBER, now)
                await self._bump_count(tx, group_id, 1, now)
                group = await self._group(tx, group_id)

    async def users_kick(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        """Kick members / decline join requests; superadmins are immune
        (reference KickGroupUsers)."""
        now = time.time()
        async with self.db.tx() as tx:
            await self._group(tx, group_id)
            if caller_id:
                await self._require_admin(tx, group_id, caller_id)
            for uid in user_ids:
                state = await self._edge_state(tx, group_id, uid)
                if state is None or state == SUPERADMIN:
                    continue
                await tx.execute(
                    "DELETE FROM group_edge WHERE source_id = ?"
                    " AND destination_id = ?",
                    (group_id, uid),
                )
                if state in _MEMBER_STATES:
                    await self._bump_count(tx, group_id, -1, now)

    async def users_ban(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        now = time.time()
        async with self.db.tx() as tx:
            await self._group(tx, group_id)
            if caller_id:
                await self._require_admin(tx, group_id, caller_id)
            for uid in user_ids:
                state = await self._edge_state(tx, group_id, uid)
                if state == SUPERADMIN:
                    continue
                was_member = state in _MEMBER_STATES
                await self._set_edge(tx, group_id, uid, BANNED, now)
                if was_member:
                    await self._bump_count(tx, group_id, -1, now)

    async def users_promote(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        """MEMBER→ADMIN, ADMIN→SUPERADMIN (reference PromoteGroupUsers)."""
        now = time.time()
        async with self.db.tx() as tx:
            await self._group(tx, group_id)
            if caller_id:
                await self._require_admin(tx, group_id, caller_id)
            for uid in user_ids:
                state = await self._edge_state(tx, group_id, uid)
                if state in (ADMIN, MEMBER):
                    await self._set_edge(
                        tx, group_id, uid, state - 1, now
                    )

    async def users_demote(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        now = time.time()
        async with self.db.tx() as tx:
            await self._group(tx, group_id)
            if caller_id:
                await self._require_admin(tx, group_id, caller_id)
            for uid in user_ids:
                state = await self._edge_state(tx, group_id, uid)
                if state in (SUPERADMIN, ADMIN):
                    others = await tx.fetch_one(
                        "SELECT COUNT(*) AS n FROM group_edge"
                        " WHERE source_id = ? AND state = ?"
                        " AND destination_id != ?",
                        (group_id, SUPERADMIN, uid),
                    )
                    if state == SUPERADMIN and not others["n"]:
                        continue  # keep at least one superadmin
                    await self._set_edge(
                        tx, group_id, uid, state + 1, now
                    )

    # ------------------------------------------------------------ queries

    async def users_list(
        self, group_id: str, limit: int = 100, state: int | None = None,
        cursor: str = "",
    ) -> dict:
        limit = max(1, min(int(limit), 1000))
        offset = int(cursor) if cursor else 0
        params: list = [group_id]
        where = "WHERE e.source_id = ?"
        if state is not None:
            where += " AND e.state = ?"
            params.append(int(state))
        rows = await self.db.fetch_all(
            "SELECT e.destination_id, e.state, u.username, u.display_name"
            " FROM group_edge e JOIN users u ON u.id = e.destination_id"
            f" {where} ORDER BY e.state, e.position LIMIT ? OFFSET ?",
            (*params, limit + 1, offset),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        return {
            "group_users": [
                {
                    "user": {
                        "id": r["destination_id"],
                        "username": r["username"],
                        "display_name": r["display_name"] or "",
                    },
                    "state": r["state"],
                }
                for r in rows
            ],
            "cursor": str(offset + limit) if has_more else "",
        }

    async def user_groups_list(
        self, user_id: str, limit: int = 100, state: int | None = None,
        cursor: str = "",
    ) -> dict:
        limit = max(1, min(int(limit), 1000))
        offset = int(cursor) if cursor else 0
        params: list = [user_id]
        where = "WHERE e.destination_id = ? AND g.disable_time = 0"
        if state is not None:
            where += " AND e.state = ?"
            params.append(int(state))
        rows = await self.db.fetch_all(
            "SELECT g.*, e.state AS edge_state FROM group_edge e"
            " JOIN groups g ON g.id = e.source_id"
            f" {where} ORDER BY e.position LIMIT ? OFFSET ?",
            (*params, limit + 1, offset),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        return {
            "user_groups": [
                {"group": self._row_to_group(r), "state": r["edge_state"]}
                for r in rows
            ],
            "cursor": str(offset + limit) if has_more else "",
        }

    async def list(
        self, name: str | None = None, limit: int = 100, cursor: str = "",
        open: bool | None = None, lang_tag: str | None = None,
    ) -> dict:
        """Browse/search groups (reference ListGroups; name supports a
        trailing-% prefix search like the reference's ILIKE)."""
        limit = max(1, min(int(limit), 100))
        offset = int(cursor) if cursor else 0
        where = "WHERE disable_time = 0"
        params: list = []
        if name:
            where += " AND name LIKE ?"
            params.append(name.replace("*", "%"))
        if open is not None:
            where += " AND state = ?"
            params.append(0 if open else 1)
        if lang_tag:
            where += " AND lang_tag = ?"
            params.append(lang_tag)
        rows = await self.db.fetch_all(
            f"SELECT * FROM groups {where} ORDER BY name LIMIT ? OFFSET ?",
            (*params, limit + 1, offset),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        return {
            "groups": [self._row_to_group(r) for r in rows],
            "cursor": str(offset + limit) if has_more else "",
        }

    @staticmethod
    def _row_to_group(r: dict) -> dict:
        return {
            "id": r["id"],
            "creator_id": r["creator_id"],
            "name": r["name"],
            "description": r["description"] or "",
            "avatar_url": r["avatar_url"] or "",
            "lang_tag": r["lang_tag"] or "en",
            "metadata": json.loads(r["metadata"] or "{}"),
            "open": r["state"] == 0,
            "edge_count": r["edge_count"],
            "max_count": r["max_count"],
            "create_time": r["create_time"],
            "update_time": r["update_time"],
        }

"""Friend graph on `user_edge` — mutual-edge transactions.

Parity: reference server/core_friend.go (506 LoC): states FRIEND(0) /
INVITE_SENT(1) / INVITE_RECEIVED(2) / BLOCKED(3); every relationship is a
PAIR of edges (source→dest and dest→source) written in one transaction;
add on a received invite upgrades both edges to FRIEND; blocking
overwrites whatever was there one-way and deletes the reverse edge.

The port's copy of the JAX package's `core/friend.py`, the Facebook and
Steam friend imports (`import_by_provider_ids`) included; an import of
more than one friend gives each edge its own position (the JAX import
fails on the edge key there).
"""

from __future__ import annotations

import time

from ..storage.db import Database

FRIEND = 0
INVITE_SENT = 1
INVITE_RECEIVED = 2
BLOCKED = 3


class FriendError(Exception):
    def __init__(self, message: str, code: str = "invalid"):
        super().__init__(message)
        self.code = code


class Friends:
    def __init__(self, logger, db: Database, notifications=None):
        self.logger = logger.with_fields(subsystem="friend")
        self.db = db
        self.notifications = notifications

    async def _edge(self, tx, source: str, dest: str):
        return await tx.fetch_one(
            "SELECT state FROM user_edge WHERE source_id = ?"
            " AND destination_id = ?",
            (source, dest),
        )

    async def _user_exists(self, tx, user_id: str) -> bool:
        return (
            await tx.fetch_one(
                "SELECT 1 FROM users WHERE id = ?", (user_id,)
            )
            is not None
        )

    async def _set_edge(self, tx, source, dest, state, now, seq: int = 0):
        """`seq` tells apart the edges one source gains at one `now` (the
        position is part of the key)."""
        await tx.execute(
            "INSERT INTO user_edge (source_id, destination_id, state,"
            " position, update_time) VALUES (?, ?, ?, ?, ?)"
            " ON CONFLICT (source_id, destination_id) DO UPDATE SET"
            " state = ?, update_time = ?",
            (source, dest, state, int(now * 1e9) + seq, now, state, now),
        )

    async def _del_edge(self, tx, source, dest):
        await tx.execute(
            "DELETE FROM user_edge WHERE source_id = ?"
            " AND destination_id = ?",
            (source, dest),
        )

    # ------------------------------------------------------------ mutation

    async def add(self, user_id: str, username: str, friend_id: str):
        """Send an invite, or accept one if the other side already invited
        (reference AddFriends → addFriend core_friend.go)."""
        if user_id == friend_id:
            raise FriendError("cannot friend yourself")
        now = time.time()
        async with self.db.tx() as tx:
            if not await self._user_exists(tx, friend_id):
                raise FriendError("user not found", "not_found")
            mine = await self._edge(tx, user_id, friend_id)
            theirs = await self._edge(tx, friend_id, user_id)
            if theirs is not None and theirs["state"] == BLOCKED:
                # Blocked: silently ignored (reference behaviour — no
                # information leak about being blocked).
                return
            if mine is not None and mine["state"] == BLOCKED:
                raise FriendError("user is blocked", "invalid")
            if mine is not None and mine["state"] == FRIEND:
                return  # already friends
            if theirs is not None and theirs["state"] == INVITE_SENT:
                # They invited me: accept -> mutual FRIEND.
                await self._set_edge(tx, user_id, friend_id, FRIEND, now)
                await self._set_edge(tx, friend_id, user_id, FRIEND, now)
                accepted = True
            else:
                await self._set_edge(
                    tx, user_id, friend_id, INVITE_SENT, now
                )
                await self._set_edge(
                    tx, friend_id, user_id, INVITE_RECEIVED, now
                )
                accepted = False
        if self.notifications is not None:
            try:
                if accepted:
                    await self.notifications.send(
                        friend_id,
                        subject=f"{username} accepted your friend invite",
                        content={"username": username},
                        code=-3,  # reference NotificationCodeFriendAccept
                        sender_id=user_id,
                        persistent=True,
                    )
                else:
                    await self.notifications.send(
                        friend_id,
                        subject=f"{username} wants to add you as a friend",
                        content={"username": username},
                        code=-2,  # reference NotificationCodeFriendRequest
                        sender_id=user_id,
                        persistent=True,
                    )
            except Exception as e:
                self.logger.error("friend notification", error=str(e))

    async def import_by_provider_ids(
        self,
        user_id: str,
        username: str,
        provider_column: str,
        provider_ids: list[str],
        reset: bool = False,
    ) -> int:
        """Social-graph bootstrap (reference importFriendsByUID,
        core_friend.go: ImportFacebookFriends / ImportSteamFriends):
        provider friend ids resolve to users with that id linked, and
        each becomes a DIRECT mutual friend (no invite round-trip — both
        sides proved the relationship to the provider). `reset` first
        deletes existing non-blocked friend edges, matching the
        reference's reset semantics. Returns the number imported."""
        assert provider_column in ("facebook_id", "steam_id")
        now = time.time()
        imported = 0
        async with self.db.tx() as tx:
            if reset:
                rows = await tx.fetch_all(
                    "SELECT destination_id, state FROM user_edge"
                    " WHERE source_id = ?",
                    (user_id,),
                )
                for r in rows:
                    if r["state"] == BLOCKED:
                        continue
                    await self._del_edge(tx, user_id, r["destination_id"])
                    theirs = await self._edge(
                        tx, r["destination_id"], user_id
                    )
                    if theirs is not None and theirs["state"] != BLOCKED:
                        await self._del_edge(
                            tx, r["destination_id"], user_id
                        )
            if not provider_ids:
                return 0
            placeholders = ",".join("?" for _ in provider_ids)
            rows = await tx.fetch_all(
                f"SELECT id FROM users WHERE {provider_column}"
                f" IN ({placeholders})",
                tuple(str(p) for p in provider_ids),
            )
            for r in rows:
                fid = r["id"]
                if fid == user_id:
                    continue
                mine = await self._edge(tx, user_id, fid)
                theirs = await self._edge(tx, fid, user_id)
                if (mine is not None and mine["state"] == BLOCKED) or (
                    theirs is not None and theirs["state"] == BLOCKED
                ):
                    continue
                if mine is not None and mine["state"] == FRIEND:
                    continue
                # Each imported edge of `user_id` gets a position of its
                # own (the JAX package's import gives every edge of one
                # import the same position and fails its key past one
                # friend).
                await self._set_edge(tx, user_id, fid, FRIEND, now, imported)
                await self._set_edge(tx, fid, user_id, FRIEND, now, imported)
                imported += 1
        self.logger.info(
            "friends imported",
            provider=provider_column,
            count=imported,
        )
        return imported

    async def delete(self, user_id: str, friend_id: str):
        """Remove friendship/invite both ways; a block I placed stays
        (reference DeleteFriends)."""
        async with self.db.tx() as tx:
            mine = await self._edge(tx, user_id, friend_id)
            if mine is None:
                return
            if mine["state"] == BLOCKED:
                # delete-friend does not unblock; explicit in reference.
                return
            await self._del_edge(tx, user_id, friend_id)
            theirs = await self._edge(tx, friend_id, user_id)
            if theirs is not None and theirs["state"] != BLOCKED:
                await self._del_edge(tx, friend_id, user_id)

    async def block(self, user_id: str, username: str, friend_id: str):
        """One-way BLOCKED edge; the reverse edge is removed (reference
        BlockFriends)."""
        if user_id == friend_id:
            raise FriendError("cannot block yourself")
        now = time.time()
        async with self.db.tx() as tx:
            if not await self._user_exists(tx, friend_id):
                raise FriendError("user not found", "not_found")
            await self._set_edge(tx, user_id, friend_id, BLOCKED, now)
            theirs = await self._edge(tx, friend_id, user_id)
            if theirs is not None and theirs["state"] != BLOCKED:
                await self._del_edge(tx, friend_id, user_id)

    async def unblock(self, user_id: str, friend_id: str):
        async with self.db.tx() as tx:
            mine = await self._edge(tx, user_id, friend_id)
            if mine is not None and mine["state"] == BLOCKED:
                await self._del_edge(tx, user_id, friend_id)

    # ------------------------------------------------------------- queries

    async def list(
        self,
        user_id: str,
        limit: int = 100,
        state: int | None = None,
        cursor: str = "",
    ) -> dict:
        """Cursored listing with user hydration (reference ListFriends)."""
        limit = max(1, min(int(limit), 1000))
        params: list = [user_id]
        where = "WHERE e.source_id = ?"
        if state is not None:
            where += " AND e.state = ?"
            params.append(int(state))
        offset = 0
        if cursor:
            try:
                offset = max(0, int(cursor))
            except ValueError:
                raise FriendError("invalid cursor")
        rows = await self.db.fetch_all(
            "SELECT e.destination_id, e.state, e.update_time, u.username,"
            " u.display_name, u.avatar_url FROM user_edge e"
            " JOIN users u ON u.id = e.destination_id"
            f" {where} ORDER BY e.state, e.position LIMIT ? OFFSET ?",
            (*params, limit + 1, offset),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        return {
            "friends": [
                {
                    "user": {
                        "id": r["destination_id"],
                        "username": r["username"],
                        "display_name": r["display_name"] or "",
                        "avatar_url": r["avatar_url"] or "",
                    },
                    "state": r["state"],
                    "update_time": r["update_time"],
                }
                for r in rows
            ],
            "cursor": str(offset + limit) if has_more else "",
        }

    async def state_of(self, user_id: str, friend_id: str) -> int | None:
        row = await self.db.fetch_one(
            "SELECT state FROM user_edge WHERE source_id = ?"
            " AND destination_id = ?",
            (user_id, friend_id),
        )
        return None if row is None else row["state"]

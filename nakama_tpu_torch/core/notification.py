"""Notifications: persistent + ephemeral, routed over the notifications
stream.

Parity: reference server/core_notification.go — `NotificationSend` (:52)
persists (when persistent) then routes a `notifications` envelope to the
user's StreamModeNotifications presences (every socket tracks it at
accept, api/socket.py); `NotificationSendAll` (:88) targets every user;
listing pages by (create_time, id) cacheable cursors; deletes are
owner-scoped. The port's copy of the JAX package's
`core/notification.py`: it routes through the port's
`realtime/message_router.py`.
"""

from __future__ import annotations

import json
import time
import uuid

from ..realtime import Stream, StreamMode


class NotificationError(Exception):
    def __init__(self, message: str, code: str = "invalid"):
        super().__init__(message)
        self.code = code


class Notifications:
    def __init__(self, logger, db, router=None):
        self.logger = logger.with_fields(subsystem="notification")
        self.db = db
        self.router = router

    def _route(self, user_id: str, payload: list[dict]):
        if self.router is None:
            return
        self.router.send_to_stream(
            Stream(StreamMode.NOTIFICATIONS, subject=user_id),
            {"notifications": {"notifications": payload}},
        )

    async def send(
        self,
        user_id: str,
        subject: str,
        content: dict,
        code: int,
        sender_id: str = "",
        persistent: bool = False,
    ) -> dict:
        return (
            await self.send_many(
                [
                    {
                        "user_id": user_id,
                        "subject": subject,
                        "content": content,
                        "code": code,
                        "sender_id": sender_id,
                        "persistent": persistent,
                    }
                ]
            )
        )[0]

    async def send_many(self, notifications: list[dict]) -> list[dict]:
        """Batch send: one insert pass for the persistent subset, then one
        route per target user (reference NotificationSend batches rows
        then routes per user)."""
        now = time.time()
        out: list[dict] = []
        by_user: dict[str, list[dict]] = {}
        persist_rows = []
        for n in notifications:
            if not n.get("subject"):
                raise NotificationError("notification subject required")
            record = {
                "id": n.get("id") or str(uuid.uuid4()),
                "user_id": n["user_id"],
                "subject": n["subject"],
                "content": n.get("content") or {},
                "code": int(n.get("code", 0)),
                "sender_id": n.get("sender_id", ""),
                "persistent": bool(n.get("persistent", False)),
                "create_time": now,
            }
            out.append(record)
            by_user.setdefault(record["user_id"], []).append(record)
            if record["persistent"]:
                persist_rows.append(record)
        if persist_rows:
            params = [
                (
                    r["id"], r["user_id"], r["subject"],
                    json.dumps(r["content"]), r["code"],
                    r["sender_id"], r["create_time"],
                )
                for r in persist_rows
            ]
            sql = (
                "INSERT INTO notification (id, user_id, subject,"
                " content, code, sender_id, create_time)"
                " VALUES (?, ?, ?, ?, ?, ?, ?)"
            )
            # One atomic unit inside a shared group commit
            # (storage/db.py execute_many): all rows or none, without
            # the exclusive writer lock.
            await self.db.execute_many(sql, params)
        for user_id, records in by_user.items():
            self._route(user_id, records)
        return out

    async def send_all(
        self, subject: str, content: dict, code: int,
        persistent: bool = False, batch_size: int = 1000,
    ) -> int:
        """Deliver to EVERY user account, paginated so a broadcast never
        materializes the whole user table or holds one giant transaction
        (reference NotificationSendAll processes in batches,
        core_notification.go:88)."""
        total = 0
        last_id = ""
        while True:
            rows = await self.db.fetch_all(
                "SELECT id FROM users WHERE disable_time = 0 AND id > ?"
                " ORDER BY id LIMIT ?",
                (last_id, batch_size),
            )
            if not rows:
                break
            last_id = rows[-1]["id"]
            await self.send_many(
                [
                    {
                        "user_id": r["id"],
                        "subject": subject,
                        "content": content,
                        "code": code,
                        "persistent": persistent,
                    }
                    for r in rows
                ]
            )
            total += len(rows)
        return total

    async def list(
        self, user_id: str, limit: int = 100, cursor: str = ""
    ) -> dict:
        """Cacheable-cursor listing (reference NotificationList)."""
        limit = max(1, min(int(limit), 100))
        params: list = [user_id]
        where = "WHERE user_id = ?"
        if cursor:
            try:
                c_time, c_id = cursor.split("|", 1)
                c_time = float(c_time)
            except ValueError:
                raise NotificationError("invalid cursor")
            where += " AND (create_time > ? OR (create_time = ? AND id > ?))"
            params.extend([c_time, c_time, c_id])
        rows = await self.db.fetch_all(
            f"SELECT * FROM notification {where}"
            " ORDER BY create_time, id LIMIT ?",
            (*params, limit),
        )
        notifications = [
            {
                "id": r["id"],
                "subject": r["subject"],
                "content": json.loads(r["content"] or "{}"),
                "code": r["code"],
                "sender_id": r["sender_id"] or "",
                "create_time": r["create_time"],
                "persistent": True,
            }
            for r in rows
        ]
        cacheable = (
            f"{rows[-1]['create_time']}|{rows[-1]['id']}" if rows else cursor
        )
        return {
            "notifications": notifications,
            "cacheable_cursor": cacheable,
        }

    async def delete(self, user_id: str, ids: list[str]):
        if not ids:
            return
        async with self.db.tx() as tx:
            for nid in ids:
                await tx.execute(
                    "DELETE FROM notification WHERE id = ? AND user_id = ?",
                    (nid, user_id),
                )

"""Chat channels: id building/parsing, message persistence, history.

Parity: reference server/core_channel.go — `ChannelIdToStream` (:506)
maps the three channel types (room / group / direct message) onto
presence streams; `ChannelMessageSend` (:293) persists to the `message`
table when the channel is persistent and fans out over the stream;
history listing pages by (create_time, id) cursors in either direction.
Channel ids are "<mode>.<subject>.<subcontext>.<label>" exactly like the
reference's four-dot form (StreamToChannelId core_channel.go:480).
The port's copy of the JAX package's `core/channel.py`: it routes
through the port's `realtime/message_router.py`.
"""

from __future__ import annotations

import json
import time
import uuid

from ..realtime import Stream, StreamMode

CHANNEL_TYPE_ROOM = 1
CHANNEL_TYPE_GROUP = 2
CHANNEL_TYPE_DM = 3

# Message codes (reference ChannelMessageTypeChat etc.)
MSG_CHAT = 0
MSG_CHAT_UPDATE = 1
MSG_CHAT_REMOVE = 2
MSG_GROUP_JOIN = 3
MSG_GROUP_ADD = 4
MSG_GROUP_LEAVE = 5
MSG_GROUP_KICK = 6
MSG_GROUP_PROMOTE = 7
MSG_GROUP_BAN = 8
MSG_GROUP_DEMOTE = 9


class ChannelError(Exception):
    def __init__(self, message: str, code: str = "invalid"):
        super().__init__(message)
        self.code = code


def channel_to_stream(
    channel_type: int, target: str, sender_id: str = ""
) -> Stream:
    """Build the stream for a channel join (reference BuildChannelId →
    ChannelIdToStream validation, core_channel.go:437-478)."""
    if channel_type == CHANNEL_TYPE_ROOM:
        if not target or len(target) > 64 or "." in target:
            raise ChannelError("invalid room name")
        return Stream(StreamMode.CHANNEL, label=target)
    if channel_type == CHANNEL_TYPE_GROUP:
        if not target:
            raise ChannelError("invalid group id")
        return Stream(StreamMode.GROUP, subject=target)
    if channel_type == CHANNEL_TYPE_DM:
        if not target or not sender_id:
            raise ChannelError("invalid user ids")
        if target == sender_id:
            raise ChannelError("cannot message yourself")
        lo, hi = sorted((sender_id, target))
        return Stream(StreamMode.DM, subject=lo, subcontext=hi)
    raise ChannelError("invalid channel type")


def stream_to_channel_id(stream: Stream) -> str:
    return (
        f"{int(stream.mode)}.{stream.subject}."
        f"{stream.subcontext}.{stream.label}"
    )


def channel_id_to_stream(channel_id: str) -> Stream:
    """Parse the four-dot channel id (reference ChannelIdToStream
    core_channel.go:506)."""
    parts = (channel_id or "").split(".")
    if len(parts) != 4:
        raise ChannelError("invalid channel id")
    mode_s, subject, subcontext, label = parts
    try:
        mode = StreamMode(int(mode_s))
    except ValueError:
        raise ChannelError("invalid channel id")
    if mode not in (StreamMode.CHANNEL, StreamMode.GROUP, StreamMode.DM):
        raise ChannelError("invalid channel id")
    if mode == StreamMode.CHANNEL and (subject or subcontext or not label):
        raise ChannelError("invalid channel id")
    if mode == StreamMode.GROUP and (not subject or subcontext or label):
        raise ChannelError("invalid channel id")
    if mode == StreamMode.DM and (not subject or not subcontext or label):
        raise ChannelError("invalid channel id")
    return Stream(mode, subject=subject, subcontext=subcontext, label=label)


class Channels:
    """Message persistence + fan-out over the router (the realtime
    pipeline, the runtime `nk` facade, and the console all come through
    here)."""

    def __init__(self, logger, db, router=None):
        self.logger = logger.with_fields(subsystem="channel")
        self.db = db
        self.router = router

    async def message_send(
        self,
        channel_id: str,
        content: dict,
        sender_id: str = "",
        sender_username: str = "",
        persist: bool = True,
        code: int = MSG_CHAT,
    ) -> dict:
        """Persist + route one message (reference ChannelMessageSend
        core_channel.go:293)."""
        stream = channel_id_to_stream(channel_id)
        if not isinstance(content, dict):
            raise ChannelError("content must be a JSON object")
        now = time.time()
        message = {
            "channel_id": channel_id,
            "message_id": str(uuid.uuid4()),
            "code": code,
            "sender_id": sender_id,
            "username": sender_username,
            "content": json.dumps(content),
            "create_time": now,
            "update_time": now,
            "persistent": bool(persist),
        }
        if persist:
            await self.db.execute(
                "INSERT INTO message (id, code, sender_id, username,"
                " stream_mode, stream_subject, stream_subcontext,"
                " stream_label, content, create_time, update_time)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (
                    message["message_id"], code, sender_id, sender_username,
                    int(stream.mode), stream.subject, stream.subcontext,
                    stream.label, message["content"], now, now,
                ),
            )
        if self.router is not None:
            self.router.send_to_stream(
                stream, {"channel_message": message}
            )
        return message

    async def message_update(
        self,
        channel_id: str,
        message_id: str,
        content: dict,
        sender_id: str = "",
        sender_username: str = "",
    ) -> dict:
        """Reference ChannelMessageUpdate: only the original sender may
        update, and only persisted messages can be."""
        stream = channel_id_to_stream(channel_id)
        row = await self.db.fetch_one(
            "SELECT sender_id FROM message WHERE id = ?", (message_id,)
        )
        if row is None:
            raise ChannelError("message not found", "not_found")
        if row["sender_id"] != sender_id:
            raise ChannelError(
                "cannot update another user's message", "permission_denied"
            )
        now = time.time()
        await self.db.execute(
            "UPDATE message SET content = ?, code = ?, update_time = ?"
            " WHERE id = ?",
            (json.dumps(content), MSG_CHAT_UPDATE, now, message_id),
        )
        message = {
            "channel_id": channel_id,
            "message_id": message_id,
            "code": MSG_CHAT_UPDATE,
            "sender_id": sender_id,
            "username": sender_username,
            "content": json.dumps(content),
            "update_time": now,
            "persistent": True,
        }
        if self.router is not None:
            self.router.send_to_stream(
                stream, {"channel_message": message}
            )
        return message

    async def message_remove(
        self,
        channel_id: str,
        message_id: str,
        sender_id: str = "",
        sender_username: str = "",
        authoritative: bool = False,
    ) -> dict:
        """`authoritative` (console/runtime callers) skips the sender
        gate but still requires the message to belong to this channel —
        and still broadcasts MSG_CHAT_REMOVE to live subscribers."""
        stream = channel_id_to_stream(channel_id)
        row = await self.db.fetch_one(
            "SELECT sender_id FROM message WHERE id = ?"
            " AND stream_mode = ? AND stream_subject = ?"
            " AND stream_subcontext = ? AND stream_label = ?",
            (
                message_id, int(stream.mode), stream.subject,
                stream.subcontext, stream.label,
            ),
        )
        if row is None:
            raise ChannelError("message not found", "not_found")
        if not authoritative and row["sender_id"] != sender_id:
            raise ChannelError(
                "cannot remove another user's message", "permission_denied"
            )
        await self.db.execute(
            "DELETE FROM message WHERE id = ?", (message_id,)
        )
        now = time.time()
        message = {
            "channel_id": channel_id,
            "message_id": message_id,
            "code": MSG_CHAT_REMOVE,
            "sender_id": sender_id,
            "username": sender_username,
            "update_time": now,
            "persistent": True,
        }
        if self.router is not None:
            self.router.send_to_stream(
                stream, {"channel_message": message}
            )
        return message

    async def messages_list(
        self,
        channel_id: str,
        limit: int = 100,
        forward: bool = True,
        cursor: str = "",
    ) -> dict:
        """History with bidirectional cursors (reference
        ChannelMessagesList core_channel.go:94-290). Forward = oldest
        first."""
        stream = channel_id_to_stream(channel_id)
        limit = max(1, min(int(limit), 100))
        direction = "ASC" if forward else "DESC"
        params: list = [
            int(stream.mode), stream.subject, stream.subcontext,
            stream.label,
        ]
        where = (
            "WHERE stream_mode = ? AND stream_subject = ?"
            " AND stream_subcontext = ? AND stream_label = ?"
        )
        if cursor:
            try:
                c_time, c_id = cursor.split("|", 1)
                c_time = float(c_time)
            except ValueError:
                raise ChannelError("invalid cursor")
            op = ">" if forward else "<"
            where += (
                f" AND (create_time {op} ? OR"
                f" (create_time = ? AND id {op} ?))"
            )
            params.extend([c_time, c_time, c_id])
        rows = await self.db.fetch_all(
            f"SELECT * FROM message {where}"
            f" ORDER BY create_time {direction}, id {direction} LIMIT ?",
            (*params, limit + 1),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        messages = [
            {
                "channel_id": channel_id,
                "message_id": r["id"],
                "code": r["code"],
                "sender_id": r["sender_id"],
                "username": r["username"],
                "content": r["content"],
                "create_time": r["create_time"],
                "update_time": r["update_time"],
                "persistent": True,
            }
            for r in rows
        ]
        next_cursor = ""
        if has_more and rows:
            last = rows[-1]
            next_cursor = f"{last['create_time']}|{last['id']}"
        prev_cursor = ""
        if cursor and rows:
            first = rows[0]
            prev_cursor = f"{first['create_time']}|{first['id']}"
        return {
            "messages": messages,
            "next_cursor": next_cursor,
            "prev_cursor": prev_cursor,
        }

    # nk-facade helper (reference nk.channel_id_build).
    def channel_id_build(
        self, sender_id: str, target: str, chan_type: int
    ) -> str:
        return stream_to_channel_id(
            channel_to_stream(chan_type, target, sender_id)
        )

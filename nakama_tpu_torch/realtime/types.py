"""Presence/stream data model.

Parity with the reference's stream-keyed presence system (reference
server/tracker.go:29-124): 8 stream modes, streams keyed by
(mode, subject, subcontext, label), presences keyed by (stream, session),
and presence metadata carried to clients in presence events.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class StreamMode(enum.IntEnum):
    """Reference server/tracker.go:34-43."""

    NOTIFICATIONS = 0
    STATUS = 1
    CHANNEL = 2
    GROUP = 3
    DM = 4
    MATCH_RELAYED = 5
    MATCH_AUTHORITATIVE = 6
    PARTY = 7


@dataclass(frozen=True)
class Stream:
    mode: StreamMode
    subject: str = ""
    subcontext: str = ""
    label: str = ""

    def as_dict(self) -> dict:
        out: dict = {"mode": int(self.mode)}
        if self.subject:
            out["subject"] = self.subject
        if self.subcontext:
            out["subcontext"] = self.subcontext
        if self.label:
            out["label"] = self.label
        return out


@dataclass(frozen=True)
class PresenceID:
    node: str
    session_id: str


@dataclass(frozen=True)
class PresenceMeta:
    format: str = "json"
    hidden: bool = False
    persistence: bool = True
    username: str = ""
    status: str = ""
    reason: int = 0


@dataclass(frozen=True)
class Presence:
    id: PresenceID
    stream: Stream
    user_id: str
    meta: PresenceMeta

    def as_dict(self) -> dict:
        out = {
            "user_id": self.user_id,
            "session_id": self.id.session_id,
            "username": self.meta.username,
        }
        if self.meta.persistence:
            out["persistence"] = True
        if self.meta.status:
            out["status"] = self.meta.status
        return out


@dataclass
class PresenceEvent:
    """One batched join/leave delta on a stream (reference
    server/tracker.go:219-232 event loop payloads)."""

    stream: Stream
    joins: list[Presence] = field(default_factory=list)
    leaves: list[Presence] = field(default_factory=list)

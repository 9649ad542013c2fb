"""Status registry: follow/unfollow user online status.

Parity with the reference StatusRegistry (reference
server/status_registry.go:35-326): per-session follow sets, a reverse index
user→following sessions, and status presence event fan-out to followers when
followed users appear/disappear/change on the status stream.
"""

from __future__ import annotations

from ..logger import Logger
from .session_registry import LocalSessionRegistry
from .types import Presence, Stream, StreamMode


class LocalStatusRegistry:
    def __init__(
        self, logger: Logger, session_registry: LocalSessionRegistry
    ):
        self.logger = logger.with_fields(subsystem="status_registry")
        self.sessions = session_registry
        self._by_session: dict[str, set[str]] = {}  # session -> user_ids
        self._by_user: dict[str, set[str]] = {}  # user -> session_ids

    def follow(self, session_id: str, user_ids: set[str]):
        followed = self._by_session.setdefault(session_id, set())
        for uid in user_ids:
            followed.add(uid)
            self._by_user.setdefault(uid, set()).add(session_id)

    def unfollow(self, session_id: str, user_ids: set[str]):
        followed = self._by_session.get(session_id)
        if followed is None:
            return
        for uid in user_ids:
            followed.discard(uid)
            sessions = self._by_user.get(uid)
            if sessions is not None:
                sessions.discard(session_id)
                if not sessions:
                    del self._by_user[uid]
        if not followed:
            del self._by_session[session_id]

    def unfollow_all(self, session_id: str):
        followed = self._by_session.pop(session_id, None)
        if not followed:
            return
        for uid in followed:
            sessions = self._by_user.get(uid)
            if sessions is not None:
                sessions.discard(session_id)
                if not sessions:
                    del self._by_user[uid]

    def status_listener(self):
        """Tracker listener for StreamMode.STATUS events: routes
        status_presence_event envelopes to followers."""

        def on_event(joins: list[Presence], leaves: list[Presence]):
            by_follower: dict[str, tuple[list, list]] = {}
            for p, is_join in [(p, True) for p in joins] + [
                (p, False) for p in leaves
            ]:
                for session_id in self._by_user.get(p.user_id, ()):
                    entry = by_follower.setdefault(session_id, ([], []))
                    entry[0 if is_join else 1].append(
                        {
                            "user_id": p.user_id,
                            "username": p.meta.username,
                            "status": p.meta.status,
                        }
                    )
            for session_id, (j, l) in by_follower.items():
                session = self.sessions.get(session_id)
                if session is not None:
                    session.send(
                        {"status_presence_event": {"joins": j, "leaves": l}}
                    )

        return on_event

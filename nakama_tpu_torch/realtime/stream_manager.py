"""Stream manager: validated stream membership on behalf of users.

Parity with the reference StreamManager (reference
server/stream_manager.go:29-114): join/update/leave arbitrary streams for a
(user, session) pair with session-existence validation — used by party
accept flows and the runtime's StreamUserJoin APIs.
"""

from __future__ import annotations

from ..logger import Logger
from .session_registry import LocalSessionRegistry
from .tracker import LocalTracker
from .types import PresenceMeta, Stream


class LocalStreamManager:
    def __init__(
        self,
        logger: Logger,
        session_registry: LocalSessionRegistry,
        tracker: LocalTracker,
    ):
        self.logger = logger.with_fields(subsystem="stream_manager")
        self.sessions = session_registry
        self.tracker = tracker

    def user_join(
        self,
        stream: Stream,
        user_id: str,
        session_id: str,
        hidden: bool = False,
        persistence: bool = True,
        status: str = "",
    ) -> tuple[bool, bool]:
        """Returns (success, newly_joined)."""
        session = self.sessions.get(session_id)
        if session is None or session.user_id != user_id:
            return False, False
        return self.tracker.track(
            session_id,
            stream,
            user_id,
            PresenceMeta(
                format=session.format,
                hidden=hidden,
                persistence=persistence,
                username=session.username,
                status=status,
            ),
        )

    def user_update(
        self,
        stream: Stream,
        user_id: str,
        session_id: str,
        hidden: bool = False,
        persistence: bool = True,
        status: str = "",
    ) -> bool:
        session = self.sessions.get(session_id)
        if session is None or session.user_id != user_id:
            return False
        return self.tracker.update(
            session_id,
            stream,
            user_id,
            PresenceMeta(
                format=session.format,
                hidden=hidden,
                persistence=persistence,
                username=session.username,
                status=status,
            ),
        )

    def user_leave(self, stream: Stream, user_id: str, session_id: str):
        session = self.sessions.get(session_id)
        if session is None or session.user_id != user_id:
            return
        self.tracker.untrack(session_id, stream)

"""Session registry: live socket sessions by id.

Parity with the reference SessionRegistry (reference
server/session_registry.go:61-174) including single-session enforcement
driven by the session cache.
"""

from __future__ import annotations

from typing import Protocol

from ..logger import Logger
from ..metrics import Metrics


class Session(Protocol):
    """What the realtime layer needs from a connected socket session
    (reference Session interface, server/session_registry.go:30-59)."""

    @property
    def id(self) -> str: ...

    @property
    def user_id(self) -> str: ...

    @property
    def username(self) -> str: ...

    @property
    def format(self) -> str: ...

    def send(self, envelope: dict) -> bool:
        """Enqueue an envelope; False if the session queue is full/closed."""

    async def close(self, reason: str = "") -> None: ...


class LocalSessionRegistry:
    def __init__(self, logger: Logger, metrics: Metrics | None = None):
        self.logger = logger.with_fields(subsystem="session_registry")
        self.metrics = metrics
        self._sessions: dict[str, Session] = {}

    def __len__(self) -> int:
        return len(self._sessions)

    def get(self, session_id: str) -> Session | None:
        return self._sessions.get(session_id)

    def add(self, session: Session):
        self._sessions[session.id] = session
        if self.metrics:
            self.metrics.sessions.set(len(self._sessions))

    def remove(self, session_id: str):
        self._sessions.pop(session_id, None)
        if self.metrics:
            self.metrics.sessions.set(len(self._sessions))

    async def disconnect(self, session_id: str, reason: str = "") -> bool:
        session = self._sessions.get(session_id)
        if session is None:
            return False
        await session.close(reason)
        return True

    def all(self) -> list[Session]:
        return list(self._sessions.values())

    async def single_session(
        self, tracker, session_cache, user_id: str, keep_session_id: str
    ):
        """Disconnect the user's other sessions (reference
        SingleSession, server/session_registry.go:128-151)."""
        for session in list(self._sessions.values()):
            if session.user_id == user_id and session.id != keep_session_id:
                token_id = getattr(session, "token_id", "")
                if token_id:
                    session_cache.remove_session(user_id, token_id)
                await session.close("concurrent session")

"""Realtime in-memory state: sessions, presence tracking, routing.

The reference's L2 layer (SURVEY.md §2.3) re-expressed on a single asyncio
loop: the reference guards shared maps with mutexes across goroutines
(server/tracker.go:192-193); here every mutation happens on the event loop,
and the async boundaries are explicit queues (tracker event pump, session
outgoing queues) exactly where the reference has channels.
"""

from .types import (
    Presence,
    PresenceID,
    PresenceMeta,
    Stream,
    StreamMode,
)
from .session_registry import LocalSessionRegistry, Session
from .session_cache import LocalSessionCache
from .login_attempt_cache import LocalLoginAttemptCache
from .tracker import LocalTracker
from .status_registry import LocalStatusRegistry
from .stream_manager import LocalStreamManager
from .message_router import LocalMessageRouter

__all__ = [
    "Stream",
    "StreamMode",
    "Presence",
    "PresenceID",
    "PresenceMeta",
    "Session",
    "LocalSessionRegistry",
    "LocalSessionCache",
    "LocalLoginAttemptCache",
    "LocalTracker",
    "LocalStatusRegistry",
    "LocalStreamManager",
    "LocalMessageRouter",
]

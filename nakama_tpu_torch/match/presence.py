"""Match presence list + join markers.

Parity with the reference MatchPresenceList and join-marker tracking
(reference server/match_presence.go:1-239): the authoritative set of
presences in a match, and deadline markers that reserve a slot between an
accepted join attempt and the actual stream join — expired reservations are
kicked (config join_marker_deadline_ms, server/config.go:899).
"""

from __future__ import annotations

import time

from ..realtime import Presence, PresenceID


class MatchPresenceList:
    def __init__(self):
        self._presences: dict[PresenceID, Presence] = {}

    def __len__(self) -> int:
        return len(self._presences)

    def join(self, presences: list[Presence]) -> list[Presence]:
        joined = []
        for p in presences:
            if p.id not in self._presences:
                self._presences[p.id] = p
                joined.append(p)
        return joined

    def leave(self, presences: list[Presence]) -> list[Presence]:
        left = []
        for p in presences:
            if self._presences.pop(p.id, None) is not None:
                left.append(p)
        return left

    def contains(self, pid: PresenceID) -> bool:
        return pid in self._presences

    def list(self) -> list[Presence]:
        return list(self._presences.values())

    def presence_ids(self) -> list[PresenceID]:
        return list(self._presences.keys())


class JoinMarkerList:
    def __init__(self, deadline_ms: int, tick_rate: int):
        # Deadline in ticks, mirroring the reference's tick-based expiry.
        self._deadline_ticks = max(
            1, int(deadline_ms / 1000 * max(1, tick_rate))
        )
        self._markers: dict[str, int] = {}  # session_id -> expiry tick

    def add(self, session_id: str, current_tick: int):
        self._markers[session_id] = current_tick + self._deadline_ticks

    def mark(self, session_id: str):
        """The session completed its join; clear the marker."""
        self._markers.pop(session_id, None)

    def clear_expired(self, current_tick: int) -> list[str]:
        expired = [
            sid for sid, t in self._markers.items() if t <= current_tick
        ]
        for sid in expired:
            del self._markers[sid]
        return expired

    def __len__(self) -> int:
        return len(self._markers)

"""Match core protocol: the contract user match logic implements.

Parity with the reference RuntimeMatchCore (reference server/runtime.go:
294-309) in idiomatic Python: a class with init/join-attempt/join/leave/
loop/terminate/signal/get-state methods, driven by the match handler's tick
loop. State is any Python object threaded through calls; returning None from
loop/terminate ends the match.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Protocol

from ..realtime import Presence


@dataclass
class MatchMessage:
    """One relayed client message for the match loop (reference
    runtime.MatchData)."""

    sender: Presence
    op_code: int
    data: bytes
    reliable: bool = True
    receive_time_ms: int = 0


class MatchDispatcher:
    """Broadcast surface handed to user match code (reference
    runtime.MatchDispatcher): sends to match presences, deferred until
    end-of-tick, plus label updates and kicks."""

    def __init__(self, handler):
        self._handler = handler

    def broadcast_message(
        self,
        op_code: int,
        data: bytes | str,
        presences: list[Presence] | None = None,
        sender: Presence | None = None,
        reliable: bool = True,
    ):
        self._handler.broadcast(op_code, data, presences, sender, reliable)

    def match_kick(self, presences: list[Presence]):
        self._handler.kick(presences)

    def match_label_update(self, label: str):
        self._handler.update_label(label)


class MatchCore(Protocol):
    """User match logic contract."""

    def match_init(
        self, ctx: dict, params: dict
    ) -> tuple[Any, int, str]:
        """Returns (state, tick_rate 1..60, label)."""

    def match_join_attempt(
        self,
        ctx: dict,
        dispatcher: MatchDispatcher,
        tick: int,
        state: Any,
        presence: Presence,
        metadata: dict,
    ) -> tuple[Any, bool, str]:
        """Returns (state, allow, reject_reason)."""

    def match_join(
        self, ctx, dispatcher, tick: int, state, presences: list[Presence]
    ) -> Any: ...

    def match_leave(
        self, ctx, dispatcher, tick: int, state, presences: list[Presence]
    ) -> Any: ...

    def match_loop(
        self, ctx, dispatcher, tick: int, state, messages: list[MatchMessage]
    ) -> Any:
        """Returns the new state, or None to end the match."""

    def match_terminate(
        self, ctx, dispatcher, tick: int, state, grace_seconds: int
    ) -> Any: ...

    def match_signal(
        self, ctx, dispatcher, tick: int, state, data: str
    ) -> tuple[Any, str]: ...


@dataclass
class MatchLabel:
    """Live match directory entry."""

    match_id: str
    node: str
    label: str = ""
    tick_rate: int = 1
    handler_name: str = ""
    create_time: float = 0.0
    size: int = 0
    extra: dict = field(default_factory=dict)

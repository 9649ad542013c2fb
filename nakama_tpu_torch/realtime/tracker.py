"""Presence tracker.

Parity with the reference Tracker (reference server/tracker.go:126-1297):
the double index byStream/bySession (:192-193), track/untrack/update with
allow-if-not-already-tracked semantics, listing and counting, and the async
event pump (:219-232) that batches joins/leaves per stream and fans them out
to registered listeners (match registry, party registry) and to clients as
stream presence events.

The pump is an asyncio task fed by a bounded queue; every public mutation is
synchronous on the event loop (no locks needed where the reference takes a
RWMutex).
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable

from ..logger import Logger
from ..metrics import Metrics
from .types import (
    Presence,
    PresenceEvent,
    PresenceID,
    PresenceMeta,
    Stream,
    StreamMode,
)

PresenceListener = Callable[[list[Presence], list[Presence]], None]


class LocalTracker:
    def __init__(
        self,
        logger: Logger,
        node: str = "local",
        metrics: Metrics | None = None,
        event_queue_size: int = 1024,
    ):
        self.logger = logger.with_fields(subsystem="tracker")
        self.node = node
        self.metrics = metrics
        self._by_stream: dict[Stream, dict[PresenceID, Presence]] = {}
        self._by_session: dict[str, dict[Stream, Presence]] = {}
        self._queue: asyncio.Queue[PresenceEvent] = asyncio.Queue(
            maxsize=event_queue_size
        )
        self._pump_task: asyncio.Task | None = None
        self._listeners: dict[StreamMode, list[PresenceListener]] = {}
        self._event_router: Callable[[PresenceEvent], None] | None = None
        self._stopped = False

    # ----------------------------------------------------------- lifecycle

    def start(self):
        self._pump_task = asyncio.get_running_loop().create_task(self._pump())

    def stop(self):
        self._stopped = True
        if self._pump_task is not None:
            self._pump_task.cancel()
            self._pump_task = None

    def add_listener(self, mode: StreamMode, listener: PresenceListener):
        """Register a join/leave listener for a stream mode (the reference
        wires match and party registries this way, main.go:153,162-163)."""
        self._listeners.setdefault(mode, []).append(listener)

    def set_event_router(self, router: Callable[[PresenceEvent], None]):
        """The client-facing fan-out for stream presence events."""
        self._event_router = router

    # ------------------------------------------------------------ tracking

    def track(
        self,
        session_id: str,
        stream: Stream,
        user_id: str,
        meta: PresenceMeta,
        allow_if_first_for_session: bool = False,
    ) -> tuple[bool, bool]:
        """Track a presence. Returns (success, newly_tracked) — tracking an
        existing (session, stream) pair succeeds without a new event
        (reference Track, server/tracker.go:258-319)."""
        pid = PresenceID(self.node, session_id)
        by_session = self._by_session.setdefault(session_id, {})
        if stream in by_session:
            return True, False
        p = Presence(id=pid, stream=stream, user_id=user_id, meta=meta)
        by_session[stream] = p
        self._by_stream.setdefault(stream, {})[pid] = p
        self._emit(PresenceEvent(stream=stream, joins=[p]))
        self._update_gauge()
        return True, True

    def untrack(self, session_id: str, stream: Stream):
        by_session = self._by_session.get(session_id)
        if not by_session:
            return
        p = by_session.pop(stream, None)
        if p is None:
            return
        if not by_session:
            del self._by_session[session_id]
        presences = self._by_stream.get(stream)
        if presences is not None:
            presences.pop(p.id, None)
            if not presences:
                del self._by_stream[stream]
        self._emit(PresenceEvent(stream=stream, leaves=[p]))
        self._update_gauge()

    def untrack_all(self, session_id: str, reason: int = 0):
        by_session = self._by_session.pop(session_id, None)
        if not by_session:
            return
        for stream, p in by_session.items():
            presences = self._by_stream.get(stream)
            if presences is not None:
                presences.pop(p.id, None)
                if not presences:
                    del self._by_stream[stream]
            self._emit(PresenceEvent(stream=stream, leaves=[p]))
        self._update_gauge()

    def update(
        self,
        session_id: str,
        stream: Stream,
        user_id: str,
        meta: PresenceMeta,
    ) -> bool:
        """Update presence meta in place: emits a leave+join pair for the
        changed presence (reference Update, server/tracker.go:428-489)."""
        by_session = self._by_session.get(session_id)
        if by_session is None or stream not in by_session:
            return self.track(session_id, stream, user_id, meta)[0]
        old = by_session[stream]
        p = Presence(id=old.id, stream=stream, user_id=user_id, meta=meta)
        by_session[stream] = p
        self._by_stream[stream][p.id] = p
        self._emit(PresenceEvent(stream=stream, joins=[p], leaves=[old]))
        return True

    # ------------------------------------------------------------- queries

    def get_local_by_session(self, session_id: str) -> dict[Stream, Presence]:
        return dict(self._by_session.get(session_id, {}))

    def list_by_stream(
        self, stream: Stream, include_hidden: bool = True
    ) -> list[Presence]:
        out = list(self._by_stream.get(stream, {}).values())
        if not include_hidden:
            out = [p for p in out if not p.meta.hidden]
        return out

    def list_presence_ids_by_stream(self, stream: Stream) -> list[PresenceID]:
        return list(self._by_stream.get(stream, {}).keys())

    def count_by_stream(self, stream: Stream) -> int:
        return len(self._by_stream.get(stream, ()))

    def count(self) -> int:
        return sum(len(v) for v in self._by_session.values())

    def get_by_stream_user(
        self, stream: Stream, session_id: str
    ) -> Presence | None:
        return self._by_stream.get(stream, {}).get(
            PresenceID(self.node, session_id)
        )

    # ---------------------------------------------------------- event pump

    def _emit(self, event: PresenceEvent):
        if self._stopped:
            return
        try:
            self._queue.put_nowait(event)
        except asyncio.QueueFull:
            self.logger.error("presence event queue full, dropping event")
        event._enqueued_at = time.perf_counter()  # type: ignore[attr-defined]

    async def _pump(self):
        while True:
            event = await self._queue.get()
            try:
                self._process_event(event)
            except Exception as e:
                self.logger.error("presence event error", error=str(e))
            if self.metrics is not None:
                enq = getattr(event, "_enqueued_at", None)
                if enq is not None:
                    self.metrics.presence_event_time.observe(
                        time.perf_counter() - enq
                    )

    def _process_event(self, event: PresenceEvent):
        """Dispatch one batched event (reference processEvent,
        server/tracker.go:901-1012)."""
        for listener in self._listeners.get(event.stream.mode, ()):
            listener(event.joins, event.leaves)
        if self._event_router is not None:
            self._event_router(event)

    async def drain(self):
        """Test helper: wait until all queued events are processed."""
        while not self._queue.empty():
            await asyncio.sleep(0)
        await asyncio.sleep(0)

    def _update_gauge(self):
        if self.metrics is not None:
            self.metrics.presences.set(self.count())

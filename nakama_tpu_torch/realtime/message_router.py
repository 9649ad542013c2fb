"""Message router: envelope fan-out to presences and streams.

Parity with the reference MessageRouter (reference
server/message_router.go:33-110): send to explicit presence IDs or to every
presence on a stream, honoring hidden presences for presence events, with a
deferred-send queue the match loop flushes per tick.
"""

from __future__ import annotations

from ..logger import Logger
from ..metrics import Metrics
from .session_registry import LocalSessionRegistry
from .tracker import LocalTracker
from .types import PresenceEvent, PresenceID, Stream, StreamMode


def _chat_channel_id(stream: Stream) -> str | None:
    """The channel id for a chat-mode stream, or None for irregular
    shapes. ONE rule set: build the id and let channel_id_to_stream — the
    parser every client echo goes through — accept or reject it."""
    # Imported here: core/channel.py imports this package.
    from ..core.channel import (
        ChannelError,
        channel_id_to_stream,
        stream_to_channel_id,
    )

    channel_id = stream_to_channel_id(stream)
    try:
        channel_id_to_stream(channel_id)
    except ChannelError:
        return None
    return channel_id


class LocalMessageRouter:
    def __init__(
        self,
        logger: Logger,
        session_registry: LocalSessionRegistry,
        tracker: LocalTracker,
        metrics: Metrics | None = None,
    ):
        self.logger = logger.with_fields(subsystem="router")
        self.sessions = session_registry
        self.tracker = tracker
        self.metrics = metrics
        self._deferred: list[tuple[list[PresenceID], dict]] = []

    def send_to_presence_ids(
        self, presence_ids: list[PresenceID], envelope: dict
    ):
        for pid in presence_ids:
            session = self.sessions.get(pid.session_id)
            if session is None:
                continue
            if not session.send(envelope):
                if self.metrics:
                    self.metrics.outgoing_dropped.inc()

    def send_to_stream(self, stream: Stream, envelope: dict):
        self.send_to_presence_ids(
            self.tracker.list_presence_ids_by_stream(stream), envelope
        )

    def send_deferred(self, presence_ids: list[PresenceID], envelope: dict):
        """Queue for the end-of-tick flush (reference SendDeferred,
        message_router.go:106)."""
        self._deferred.append((presence_ids, envelope))

    def flush_deferred(self):
        deferred, self._deferred = self._deferred, []
        for presence_ids, envelope in deferred:
            self.send_to_presence_ids(presence_ids, envelope)

    def route_presence_event(self, event: PresenceEvent):
        """Client-facing presence events: joins/leaves on a stream are
        delivered to the stream's remaining presences, hidden presences
        excluded from the payload. The envelope variant SPECIALIZES by
        stream mode exactly as the reference does (tracker.go:1060-1117):
        chat streams emit channel_presence_event with their identity
        fields, match streams match_presence_event, party streams
        party_presence_event; everything else the generic stream event."""
        joins = [p.as_dict() for p in event.joins if not p.meta.hidden]
        leaves = [p.as_dict() for p in event.leaves if not p.meta.hidden]
        if not joins and not leaves:
            return
        stream = event.stream
        mode = stream.mode
        channel_id = (
            _chat_channel_id(stream)
            if mode in (StreamMode.CHANNEL, StreamMode.GROUP, StreamMode.DM)
            else None
        )
        if channel_id is not None:
            # Irregular chat-mode streams (not built by the channel
            # core) fall through to the generic event below rather than
            # emitting a channel id no client could echo back (the
            # reference logs + skips, tracker.go:1062).
            body: dict = {
                "channel_id": channel_id,
                "joins": joins,
                "leaves": leaves,
            }
            if mode == StreamMode.CHANNEL:
                body["room_name"] = stream.label
            elif mode == StreamMode.GROUP:
                body["group_id"] = stream.subject
            else:
                body["user_id_one"] = stream.subject
                body["user_id_two"] = stream.subcontext
            envelope = {"channel_presence_event": body}
        elif mode in (
            StreamMode.MATCH_RELAYED, StreamMode.MATCH_AUTHORITATIVE
        ):
            envelope = {
                "match_presence_event": {
                    "match_id": stream.subject,
                    "joins": joins,
                    "leaves": leaves,
                }
            }
        elif mode == StreamMode.PARTY:
            envelope = {
                "party_presence_event": {
                    "party_id": stream.subject,
                    "joins": joins,
                    "leaves": leaves,
                }
            }
        else:
            envelope = {
                "stream_presence_event": {
                    "stream": stream.as_dict(),
                    "joins": joins,
                    "leaves": leaves,
                }
            }
        self.send_to_stream(event.stream, envelope)

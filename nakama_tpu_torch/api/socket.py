"""WebSocket acceptor: auth, session creation, presence bootstrap.

Parity with the reference socket acceptor (reference server/socket_ws.go:
29-139): token auth from the query string against the session cache,
format negotiation, session registration, initial tracking of the
notifications stream (and the status stream when `status=true`), optional
single-socket enforcement, then the blocking consume loop.

The port's copy of the JAX package's `api/socket.py`, over a `wsproto`
connection. It accepts `format=json` and `format=protobuf` (the port's
own rtapi codec, protocol.py; such a socket is sent binary frames) and
closes any other format with 4000 "unsupported format". One difference
by design: a session
that the server's stop closed (kind "shutdown", code 1012 with a
Retry-After hint) keeps its tickets, which the restarted server holds
for the player's next session (`recovery.HeldTickets`); the JAX
acceptor removes them, and a graceful stop loses the tickets of every
connected player. The runtime's session start and end events fire
through `on_session_start`/`on_session_end`, as in the JAX acceptor.
"""

from __future__ import annotations

import urllib.parse
from typing import Any

from ..config import Config
from ..logger import Logger
from ..metrics import Metrics
from ..realtime import (
    LocalSessionCache,
    LocalSessionRegistry,
    LocalStatusRegistry,
    LocalTracker,
    PresenceMeta,
    Stream,
    StreamMode,
)
from . import protocol, session_token
from .session_ws import WebSocketSession


class SocketAcceptor:
    def __init__(
        self,
        config: Config,
        logger: Logger,
        session_registry: LocalSessionRegistry,
        session_cache: LocalSessionCache,
        tracker: LocalTracker,
        status_registry: LocalStatusRegistry,
        pipeline,
        metrics: Metrics | None = None,
        matchmaker=None,
        held=None,
        on_session_start=None,
        on_session_end=None,
    ):
        self.config = config
        self.logger = logger.with_fields(subsystem="socket")
        self.sessions = session_registry
        self.session_cache = session_cache
        self.tracker = tracker
        self.status_registry = status_registry
        self.pipeline = pipeline
        self.metrics = metrics
        self.matchmaker = matchmaker
        self.held = held
        self.on_session_start = on_session_start
        self.on_session_end = on_session_end

    async def handle(self, ws: Any):
        """Serve one upgraded `/ws` connection (`wsproto.WebSocket`)."""
        query = urllib.parse.parse_qs(
            urllib.parse.urlsplit(ws.path or "/ws").query
        )
        token = (query.get("token") or [""])[0]
        fmt = (query.get("format") or ["json"])[0]
        status = (query.get("status") or ["true"])[0].lower() in (
            "true",
            "1",
        )
        if fmt not in protocol.SUPPORTED_FORMATS:
            await ws.close(4000, "unsupported format")
            return
        try:
            claims = session_token.parse(
                self.config.session.encryption_key, token
            )
        except session_token.TokenError:
            await ws.close(4001, "invalid token")
            return
        if not self.session_cache.is_valid_session(
            claims.user_id, claims.token_id
        ):
            await ws.close(4001, "session not valid")
            return

        session = WebSocketSession(
            ws,
            user_id=claims.user_id,
            username=claims.username,
            vars=claims.vars,
            format=fmt,
            expiry=claims.expires_at,
            logger=self.logger,
            outgoing_queue_size=self.config.socket.outgoing_queue_size,
            on_close=self._session_closed,
            metrics=self.metrics,
        )
        session.token_id = claims.token_id  # for token invalidation

        if self.config.session.single_socket:
            await self.sessions.single_session(
                self.tracker, self.session_cache, claims.user_id, session.id
            )

        self.sessions.add(session)
        # Every session receives its notifications stream; sockets opened
        # with status=true also appear online (socket_ws.go:109-126).
        self.tracker.track(
            session.id,
            Stream(StreamMode.NOTIFICATIONS, subject=claims.user_id),
            claims.user_id,
            PresenceMeta(format=fmt, username=claims.username, hidden=True),
        )
        if status:
            self.tracker.track(
                session.id,
                Stream(StreamMode.STATUS, subject=claims.user_id),
                claims.user_id,
                PresenceMeta(format=fmt, username=claims.username),
            )
        if self.held is not None:
            # A player back after a graceful restart: the tickets the
            # stop kept return to the pool under this session.
            self.held.reown(session)
        if self.on_session_start is not None:
            self.on_session_start(session)
        await session.consume(self.pipeline.process)

    async def _session_closed(self, session: WebSocketSession):
        if self.matchmaker is not None and session.close_kind != "shutdown":
            # A disconnected player must leave the matchmaking pool or peers
            # get matched with a ghost (reference session close path). A
            # server stop is no disconnect: its tickets stay for the final
            # checkpoint and are held for the player's return.
            self.matchmaker.remove_session_all(session.id)
        self.tracker.untrack_all(session.id)
        self.status_registry.unfollow_all(session.id)
        self.sessions.remove(session.id)
        if self.on_session_end is not None:
            self.on_session_end(session)

"""WebSocket session: per-connection read loop + buffered writer.

Parity with the reference sessionWS (reference server/session_ws.go:77-523):
a bounded outgoing queue drained by a writer task (overflow closes the
session with "queue full"), a read loop dispatching each envelope into the
pipeline, ping/pong liveness (the transport's keepalive, `wsproto`:
`socket.ping_period_ms` / `socket.pong_wait_ms`), and a close path that
untracks all presences, unfollows statuses, deregisters the session, and
fires the session-end callback. The port's copy of the JAX package's
`api/session_ws.py`; the session records the kind it closed with
(`close_kind`), which the acceptor reads. Its one encode and one decode
site go through `protocol.py` in the socket's format: a `format=protobuf`
session sends binary frames, reads a text frame as the bytes of its
text (as the JAX decode does), closes on a frame that is not an
Envelope, and closes with 1011 when an outgoing envelope cannot be
encoded.
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import Any, Callable

from .. import tracing as trace_api
from ..logger import Logger
from . import protocol


class WebSocketSession:
    def __init__(
        self,
        ws: Any,
        *,
        user_id: str,
        username: str,
        vars: dict[str, str],
        format: str,
        expiry: float,
        logger: Logger,
        outgoing_queue_size: int = 64,
        on_close: Callable[["WebSocketSession"], Any] | None = None,
        metrics: Any = None,
    ):
        self._id = str(uuid.uuid4())
        self.ws = ws
        self._user_id = user_id
        self._username = username
        self.vars = vars
        self._format = format
        self.expiry = expiry
        self.logger = logger.with_fields(
            subsystem="session", sid=self._id, uid=user_id
        )
        self._outgoing: asyncio.Queue[dict | None] = asyncio.Queue(
            maxsize=outgoing_queue_size
        )
        self._writer_task: asyncio.Task | None = None
        self._closed = False
        self._on_close = on_close
        self._metrics = metrics
        # Per-session overflow ledger: envelopes dropped on a full
        # outgoing queue (each one also counts in the
        # session_outgoing_overflow_total{kind="drop"} metric; the
        # close it triggers counts under kind="close").
        self.overflow_drops = 0
        self._overflow_closing = False
        # The `kind` of the close that ended the session ("shutdown"
        # when the server's stop closed it).
        self.close_kind = ""

    # ------------------------------------------------------------ identity

    @property
    def id(self) -> str:
        return self._id

    @property
    def user_id(self) -> str:
        return self._user_id

    @property
    def username(self) -> str:
        return self._username

    @property
    def format(self) -> str:
        return self._format

    # ------------------------------------------------------------- sending

    def send(self, envelope: dict) -> bool:
        if self._closed:
            return False
        try:
            self._outgoing.put_nowait(envelope)
            return True
        except asyncio.QueueFull:
            self.overflow_drops += 1
            # When the drop happens inside a traced envelope (a chat
            # send or relayed match-data fan-out runs in the SENDER's
            # envelope span; matchmaker-task publishes carry no span
            # and no-op here), the trace records WHICH session
            # swallowed the message — log lines alone can't join that
            # back to the request.
            trace_api.add_event(
                "session.overflow_drop",
                session_id=self._id,
                dropped=self.overflow_drops,
            )
            self._note_overflow("drop")
            if self._overflow_closing:
                return False  # close already scheduled; just count
            self._overflow_closing = True
            self.logger.warn(
                "session outgoing queue full, closing",
                dropped=self.overflow_drops,
            )
            self._note_overflow("close")
            # Deadline-bounded overflow close: the writer is already
            # failing to keep up, so waiting the full flush grace for
            # it would just stack more queued work behind a dead
            # consumer — bound the flush to a short budget.
            asyncio.get_running_loop().create_task(
                self.close(
                    "outgoing queue full",
                    flush_timeout=0.25,
                    code=1008,
                    kind="overflow",
                )
            )
            return False

    def _note_overflow(self, kind: str) -> None:
        if self._metrics is not None:
            try:
                self._metrics.session_outgoing_overflow.labels(
                    kind=kind
                ).inc()
            except Exception:
                pass

    async def _writer(self):
        try:
            while True:
                envelope = await self._outgoing.get()
                if envelope is None:
                    return
                await self.ws.send(
                    protocol.encode(envelope, self._format)
                )
        except Exception:
            await self.close("write error", code=1011, kind="error")

    # ------------------------------------------------------------ consume

    async def consume(self, process: Callable[["WebSocketSession", dict], Any]):
        """Blocking read loop (reference session_ws.go:173). `process` is the
        pipeline entry; returning False from it closes the session."""
        self._writer_task = asyncio.get_running_loop().create_task(
            self._writer()
        )
        try:
            async for raw in self.ws:
                try:
                    envelope = protocol.decode(raw, self._format)
                except protocol.ProtocolError:
                    self.logger.debug("malformed envelope, closing")
                    break
                result = process(self, envelope)
                if asyncio.iscoroutine(result):
                    result = await result
                if result is False:
                    break
        except Exception as e:
            self.logger.debug("read loop ended", error=str(e))
        finally:
            await self.close("connection closed")

    async def close(
        self,
        reason: str = "",
        flush_timeout: float = 1.0,
        code: int = 1000,
        kind: str = "normal",
        retry_after_sec: float | None = None,
    ):
        """Close the session with a STRUCTURED close: `code` is the
        WebSocket close code the client sees (1000 normal; the server
        shutdown path sends 1012 Service Restart), `kind` the low-
        cardinality reason bucket for the sessions_closed metric, and
        `retry_after_sec` — when set — is delivered as a best-effort
        final envelope so clients know to reconnect after a restart
        instead of backing off blind."""
        if self._closed:
            return
        self._closed = True
        self.close_kind = kind
        if retry_after_sec is not None:
            # Ahead of the writer-drain below so it flushes with any
            # queued traffic; a full queue just drops the hint (the
            # close code still signals restart). rtapi's
            # Notification.content is a Struct, so a protobuf session
            # gets the object; the JSON wire keeps its JSON string.
            content = {
                "reason": reason,
                "retry_after_sec": float(retry_after_sec),
            }
            if self._format != "protobuf":
                content = json.dumps(content)
            try:
                self._outgoing.put_nowait(
                    {
                        "notifications": {
                            "notifications": [
                                {
                                    "subject": "server_restart",
                                    "code": -2,
                                    "content": content,
                                    "persistent": False,
                                }
                            ]
                        }
                    }
                )
            except asyncio.QueueFull:
                pass
        if self._metrics is not None:
            try:
                self._metrics.sessions_closed.labels(kind).inc()
            except Exception:
                pass
        if self._writer_task is not None:
            if asyncio.current_task() is self._writer_task:
                # close() reached from the writer's own error path: the
                # task cannot await itself — it is already unwinding, so
                # just drop the handle.
                self._writer_task = None
            else:
                # Let queued messages flush briefly, then stop the
                # writer. `flush_timeout` bounds the grace — the
                # overflow close path passes a short budget because a
                # writer that overflowed its queue has already proven
                # it cannot drain in time.
                try:
                    self._outgoing.put_nowait(None)
                except asyncio.QueueFull:
                    self._writer_task.cancel()
                try:
                    await asyncio.wait_for(
                        self._writer_task, timeout=flush_timeout
                    )
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    self._writer_task.cancel()
                self._writer_task = None
        try:
            await self.ws.close(code, reason)
        except Exception:
            pass
        if self._on_close is not None:
            cb = self._on_close
            self._on_close = None
            result = cb(self)
            if asyncio.iscoroutine(result):
                await result

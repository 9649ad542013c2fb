"""HTTP/1.1 and WebSocket (RFC 6455) over asyncio streams, standard library
only.

The JAX package serves its REST API and `/ws` through `aiohttp`, and its
tests drive `/ws` with the `websockets` library; the port keeps neither
(the machine that runs it has neither), so this module is the port's
transport in their place. It has no counterpart in the JAX package.

Server side (`HttpServer`):
- HTTP/1.1 requests with keep-alive (closed after `idle_timeout_s` of
  silence between requests), `Content-Length` bodies only, 413 above
  `max_request_size` (or, with `oversize_to_handler`, the request handed
  on unread and marked `body_too_large`, as `aiohttp` hands a handler a
  request whose body it then refuses to read; the answer closes the
  connection, after at most `_DISCARD_MAX` bytes of the body, each read
  within `idle_timeout_s`, are discarded so the peer reads the answer
  and not a reset), JSON responses (`json_response`);
- the WebSocket upgrade (`HttpRequest.accept_websocket`: the
  `Sec-WebSocket-Accept` handshake, no extensions or subprotocols).

Both sides (`WebSocket`):
- frames: client frames must be masked and server frames must not be
  (1002 otherwise); fragmented messages are reassembled from their
  continuation frames, with control frames allowed between fragments;
  text messages must be UTF-8 (1007 otherwise); a message above
  `max_message_size` closes with 1009;
- the closing handshake (a close frame is answered with one carrying
  the same code, and `close()` waits briefly for the peer's answer);
- keepalive on the server: a ping every `ping_period_s`, and the
  connection dropped after `pong_wait_s` without any frame from the
  peer;
- sends wait on `writer.drain()`, so a slow reader pushes back on its
  writer.

Client side, for the smoke run and the tests: `request()` (one HTTP
request on its own connection) and `connect()` (a WebSocket client).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import struct
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA
_DATA_OPS = (OP_CONT, OP_TEXT, OP_BINARY)
_CONTROL_OPS = (OP_CLOSE, OP_PING, OP_PONG)

CLOSE_NORMAL = 1000
CLOSE_PROTOCOL_ERROR = 1002
CLOSE_NO_STATUS = 1005
CLOSE_ABNORMAL = 1006
CLOSE_INVALID_DATA = 1007
CLOSE_TOO_BIG = 1009

# Whole messages a WebSocket's reader queues before it stops reading.
_QUEUE_MAX = 16
# Listen backlog: connections the kernel queues before the server
# accepts them. asyncio's default (100) drops a burst of players'
# connects, and each dropped SYN is retried only after 1, 2, 4 s.
LISTEN_BACKLOG = 4096
# Longest request head (request line + headers) the server reads.
MAX_HEAD_BYTES = 65_536
# Bytes of an oversized or refused frame discarded before the
# connection is dropped, so the peer can still read our close frame
# instead of a reset.
_DISCARD_MAX = 1 << 20

REASONS = {
    101: "Switching Protocols", 200: "OK", 204: "No Content",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class ConnectionClosed(Exception):
    """The WebSocket is closed; `code`/`reason` are the close frame's
    (1006 when the connection ended without one)."""

    def __init__(self, code: int, reason: str = ""):
        super().__init__(f"websocket closed: {code} {reason}".rstrip())
        self.code = code
        self.reason = reason


class HttpError(Exception):
    """A request the server refuses before any handler runs."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def accept_key(key: str) -> str:
    """`Sec-WebSocket-Accept` for a `Sec-WebSocket-Key` (RFC 6455 §4.2.2)."""
    digest = hashlib.sha1((key + WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


# ------------------------------------------------------------------ HTTP


class Headers(dict):
    """Request or response headers, keyed by lower-case name."""

    def get(self, name: str, default: Any = None) -> Any:
        return super().get(name.lower(), default)


def _parse_head(head: bytes) -> tuple[str, str, str, Headers]:
    try:
        text = head.decode("latin-1")
    except UnicodeDecodeError as e:  # pragma: no cover - latin-1 decodes all
        raise HttpError(400, "bad request head") from e
    lines = text.split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, "bad request line")
    headers = Headers()
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise HttpError(400, "bad header line")
        key = name.lower()
        value = value.strip()
        prev = dict.get(headers, key)
        dict.__setitem__(
            headers, key, value if prev is None else f"{prev}, {value}"
        )
    return parts[0], parts[1], parts[2], headers


@dataclass
class HttpRequest:
    method: str
    target: str  # path and query as sent
    version: str
    headers: Headers
    body: bytes = b""
    remote: str = ""
    _reader: asyncio.StreamReader | None = field(default=None, repr=False)
    _writer: asyncio.StreamWriter | None = field(default=None, repr=False)
    websocket: "WebSocket | None" = field(default=None, repr=False)
    # The body was above the server's `max_request_size` and dropped.
    body_too_large: bool = False

    @property
    def path(self) -> str:
        return urllib.parse.urlsplit(self.target).path

    @property
    def query(self) -> dict[str, str]:
        """Query parameters, the first value of each."""
        qs = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.target).query, keep_blank_values=True
        )
        return {k: v[0] for k, v in qs.items()}

    def query_all(self, name: str) -> list[str]:
        """Every value of one query parameter, in order."""
        qs = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.target).query, keep_blank_values=True
        )
        return qs.get(name, [])

    def json(self) -> Any:
        return json.loads(self.body)

    async def accept_websocket(
        self,
        *,
        max_message_size: int,
        ping_period_s: float = 0.0,
        pong_wait_s: float = 0.0,
    ) -> "WebSocket":
        """Answer the upgrade (101 + `Sec-WebSocket-Accept`) and return
        the server side of the connection. Raises HttpError(400) for a
        request that is no valid WebSocket handshake."""
        h = self.headers
        key = h.get("sec-websocket-key", "")
        try:
            key_ok = len(base64.b64decode(key, validate=True)) == 16
        except ValueError:
            key_ok = False
        if (
            self.method != "GET"
            or h.get("upgrade", "").lower() != "websocket"
            or "upgrade" not in h.get("connection", "").lower()
            or h.get("sec-websocket-version", "") != "13"
            or not key_ok
        ):
            raise HttpError(400, "invalid websocket handshake")
        self._writer.write(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
            ).encode()
        )
        await self._writer.drain()
        self.websocket = WebSocket(
            self._reader,
            self._writer,
            is_client=False,
            max_message_size=max_message_size,
            ping_period_s=ping_period_s,
            pong_wait_s=pong_wait_s,
            path=self.target,
        )
        return self.websocket


@dataclass
class HttpResponse:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json; charset=utf-8"
    headers: dict[str, str] = field(default_factory=dict)

    def encode(self, close: bool) -> bytes:
        lines = [
            f"HTTP/1.1 {self.status} {REASONS.get(self.status, 'Unknown')}",
            f"Content-Type: {self.content_type}",
            f"Content-Length: {len(self.body)}",
        ]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        if close:
            lines.append("Connection: close")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + self.body


def json_response(
    obj: Any, status: int = 200, headers: dict[str, str] | None = None
) -> HttpResponse:
    return HttpResponse(
        status, json.dumps(obj).encode(), headers=dict(headers or {})
    )


Handler = Callable[[HttpRequest], Awaitable["HttpResponse | None"]]


class HttpServer:
    """An HTTP/1.1 listener over one handler coroutine: `handler(request)`
    returns the response, or None once it took the connection over with
    `request.accept_websocket` (the connection then closes when the
    handler returns)."""

    def __init__(
        self,
        handler: Handler,
        *,
        max_request_size: int,
        idle_timeout_s: float = 60.0,
        logger=None,
        oversize_to_handler: bool = False,
    ):
        self.handler = handler
        self.max_request_size = max_request_size
        self.oversize_to_handler = oversize_to_handler
        self.idle_timeout_s = idle_timeout_s
        self.logger = logger
        self._server: asyncio.base_events.Server | None = None
        # Connection task -> state: "idle" (waiting for a request) or
        # "busy" (a request in its handler, an upgraded one included).
        self._conns: dict[asyncio.Task, str] = {}
        self.port: int | None = None

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(
            self._on_connection, host, port, limit=MAX_HEAD_BYTES,
            backlog=LISTEN_BACKLOG,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        """Stop listening and drop idle keep-alive connections. Requests
        in their handlers finish, and upgraded WebSocket connections
        stay open until their sessions close them (the server closes
        them with its own code); `wait_closed` waits for both."""
        if self._server is None:
            return
        self._server.close()
        for task, state in list(self._conns.items()):
            if state == "idle":
                task.cancel()

    async def wait_closed(self, timeout: float = 5.0) -> None:
        """Wait for the connections left after `stop`; cancel what is
        still open after `timeout` seconds."""
        conns = list(self._conns)
        if conns:
            _, pending = await asyncio.wait(conns, timeout=timeout)
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _on_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns[task] = "idle"
        try:
            await self._serve(reader, writer)
        except asyncio.CancelledError:
            pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception as e:  # a connection must never take the listener down
            if self.logger is not None:
                self.logger.error("http connection error", error=str(e))
        finally:
            self._conns.pop(task, None)
            writer.close()

    async def _serve(self, reader, writer) -> None:
        task = asyncio.current_task()
        peer = writer.get_extra_info("peername")
        remote = peer[0] if isinstance(peer, tuple) else ""
        while True:
            self._conns[task] = "idle"
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), self.idle_timeout_s
                )
            except (asyncio.TimeoutError, asyncio.IncompleteReadError):
                return
            except asyncio.LimitOverrunError:
                await self._refuse(writer, 400, "request head too large")
                return
            try:
                method, target, version, headers = _parse_head(head[:-4])
                if "chunked" in headers.get("transfer-encoding", "").lower():
                    raise HttpError(400, "chunked request bodies are not supported")
                try:
                    length = int(headers.get("content-length", "0") or 0)
                except ValueError:
                    raise HttpError(400, "bad content-length") from None
                if length < 0:
                    raise HttpError(400, "bad content-length")
                too_large = length > self.max_request_size
                if too_large and not self.oversize_to_handler:
                    raise HttpError(413, "request body too large")
            except HttpError as e:
                await self._refuse(writer, e.status, str(e))
                return
            self._conns[task] = "busy"
            body = b""
            if length and not too_large:
                body = await reader.readexactly(length)
            request = HttpRequest(
                method, target, version, headers, body, remote, reader,
                writer, body_too_large=too_large,
            )
            conn = headers.get("connection", "").lower()
            close = too_large or "close" in conn or (
                version == "HTTP/1.0" and "keep-alive" not in conn
            )
            try:
                response = await self.handler(request)
            except HttpError as e:
                await self._refuse(writer, e.status, str(e))
                return
            if request.websocket is not None or response is None:
                return
            writer.write(response.encode(close))
            await writer.drain()
            if too_large:
                await self._discard(reader, length)
            if close:
                return

    async def _discard(self, reader, length: int) -> None:
        """Read and drop what the peer still sends of an unread body:
        at most `_DISCARD_MAX` bytes and no more than the declared
        `length`, each read within `idle_timeout_s`."""
        left = min(length, _DISCARD_MAX)
        while left > 0:
            try:
                chunk = await asyncio.wait_for(
                    reader.read(min(left, 1 << 16)), self.idle_timeout_s
                )
            except asyncio.TimeoutError:
                return
            if not chunk:
                return
            left -= len(chunk)

    @staticmethod
    async def _refuse(writer, status: int, message: str) -> None:
        resp = json_response(
            {"error": message, "message": message, "code": 3}, status
        )
        writer.write(resp.encode(close=True))
        try:
            await writer.drain()
        except ConnectionError:
            pass


# ------------------------------------------------------------- WebSocket


def _mask(data: bytes, key: bytes) -> bytes:
    if not data:
        return data
    n = len(data)
    k = int.from_bytes((key * (n // 4 + 1))[:n], "little")
    return (int.from_bytes(data, "little") ^ k).to_bytes(n, "little")


def encode_frame(opcode: int, payload: bytes, *, mask: bool, fin: bool = True) -> bytes:
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    bit = 0x80 if mask else 0
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        return bytes(head) + key + _mask(payload, key)
    return bytes(head) + payload


def _close_payload(code: int, reason: str) -> bytes:
    if code == CLOSE_NO_STATUS:
        return b""
    return struct.pack("!H", code) + reason.encode()[:123]


class _Fail(Exception):
    """A protocol violation by the peer: close with `code`."""

    def __init__(self, code: int, reason: str, discard: int = 0):
        super().__init__(reason)
        self.code = code
        self.reason = reason
        self.discard = discard


class WebSocket:
    """One end of a WebSocket connection. A reader task parses frames,
    answers pings and close frames, and queues whole messages (`str` for
    text, `bytes` for binary) for `recv()` / `async for`."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        *,
        is_client: bool,
        max_message_size: int,
        ping_period_s: float = 0.0,
        pong_wait_s: float = 0.0,
        close_timeout_s: float = 1.0,
        path: str = "",
    ):
        self._reader = reader
        self._writer = writer
        self.is_client = is_client
        self.max_message_size = max_message_size
        self.ping_period_s = ping_period_s
        self.pong_wait_s = pong_wait_s
        self.close_timeout_s = close_timeout_s
        self.path = path
        # The reader holds at _QUEUE_MAX queued messages, so a peer that
        # sends faster than its messages are consumed waits on TCP; the
        # close always fits behind them.
        self._messages: asyncio.Queue = asyncio.Queue()
        self._room = asyncio.Event()
        self._room.set()
        self._close_sent = False
        self._done = asyncio.Event()
        self.close_code: int | None = None
        self.close_reason = ""
        self.last_seen = time.monotonic()
        loop = asyncio.get_running_loop()
        self._reader_task = loop.create_task(self._read_loop())
        self._ping_task = (
            loop.create_task(self._keepalive()) if ping_period_s > 0 else None
        )

    # --------------------------------------------------------------- send

    async def _write(self, opcode: int, payload: bytes, fin: bool = True) -> None:
        self._writer.write(
            encode_frame(opcode, payload, mask=self.is_client, fin=fin)
        )
        await self._writer.drain()

    async def send(self, data: str | bytes) -> None:
        if self._close_sent or self._done.is_set():
            raise ConnectionClosed(self.close_code or CLOSE_ABNORMAL, self.close_reason)
        if isinstance(data, str):
            await self._write(OP_TEXT, data.encode())
        else:
            await self._write(OP_BINARY, bytes(data))

    async def ping(self, payload: bytes = b"") -> None:
        await self._write(OP_PING, payload)

    # --------------------------------------------------------------- recv

    async def recv(self) -> str | bytes:
        item = await self._messages.get()
        if self._messages.qsize() < _QUEUE_MAX:
            self._room.set()
        if isinstance(item, ConnectionClosed):
            self._messages.put_nowait(item)  # every later recv sees it too
            raise item
        return item

    def __aiter__(self):
        return self

    async def __anext__(self) -> str | bytes:
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None

    # -------------------------------------------------------------- close

    async def close(self, code: int = CLOSE_NORMAL, reason: str = "") -> None:
        """Send a close frame, wait up to `close_timeout_s` for the
        peer's, then drop the connection."""
        if not self._close_sent and not self._done.is_set():
            self._close_sent = True
            try:
                await self._write(OP_CLOSE, _close_payload(code, reason))
            except (ConnectionError, RuntimeError):
                pass
            try:
                await asyncio.wait_for(self._done.wait(), self.close_timeout_s)
            except asyncio.TimeoutError:
                pass
        await self._teardown(code, reason)

    async def _teardown(self, code: int, reason: str) -> None:
        if self.close_code is None:
            self.close_code, self.close_reason = code, reason
        self._finish()
        current = asyncio.current_task()
        for task in (self._reader_task, self._ping_task):
            if task is not None and task is not current and not task.done():
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
        self._writer.close()

    def _finish(self) -> None:
        if self._done.is_set():
            return
        self._done.set()
        closed = ConnectionClosed(
            self.close_code if self.close_code is not None else CLOSE_ABNORMAL,
            self.close_reason,
        )
        self._messages.put_nowait(closed)

    # -------------------------------------------------------------- reader

    async def _read_frame(self) -> tuple[bool, int, bytes]:
        b0, b1 = await self._reader.readexactly(2)
        fin, opcode = bool(b0 & 0x80), b0 & 0x0F
        masked, n = bool(b1 & 0x80), b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", await self._reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self._reader.readexactly(8))
        key = await self._reader.readexactly(4) if masked else b""
        if b0 & 0x70:
            raise _Fail(CLOSE_PROTOCOL_ERROR, "reserved bits set", n)
        if opcode not in _DATA_OPS and opcode not in _CONTROL_OPS:
            raise _Fail(CLOSE_PROTOCOL_ERROR, "unknown opcode", n)
        if masked == self.is_client:
            raise _Fail(
                CLOSE_PROTOCOL_ERROR,
                "masked server frame" if self.is_client else "unmasked client frame",
                n,
            )
        if opcode in _CONTROL_OPS and (not fin or n > 125):
            raise _Fail(CLOSE_PROTOCOL_ERROR, "bad control frame", n)
        if opcode in _DATA_OPS and n > self.max_message_size:
            raise _Fail(CLOSE_TOO_BIG, "message too big", n)
        payload = await self._reader.readexactly(n) if n else b""
        return fin, opcode, _mask(payload, key) if masked else payload

    async def _read_loop(self) -> None:
        parts: list[bytes] = []
        size = 0
        msg_op = 0
        try:
            while True:
                fin, opcode, payload = await self._read_frame()
                self.last_seen = time.monotonic()
                if opcode == OP_PING:
                    if not self._close_sent:
                        await self._write(OP_PONG, payload)
                    continue
                if opcode == OP_PONG:
                    continue
                if opcode == OP_CLOSE:
                    await self._on_close_frame(payload)
                    return
                if opcode == OP_CONT:
                    if not parts and msg_op == 0:
                        raise _Fail(CLOSE_PROTOCOL_ERROR, "unexpected continuation")
                elif msg_op != 0:
                    raise _Fail(CLOSE_PROTOCOL_ERROR, "expected continuation")
                else:
                    msg_op = opcode
                size += len(payload)
                if size > self.max_message_size:
                    raise _Fail(CLOSE_TOO_BIG, "message too big")
                parts.append(payload)
                if not fin:
                    continue
                data = b"".join(parts)
                op, parts, size, msg_op = msg_op, [], 0, 0
                if self._close_sent:
                    continue  # closing: late data is dropped
                if op == OP_TEXT:
                    try:
                        message: str | bytes = data.decode("utf-8")
                    except UnicodeDecodeError:
                        raise _Fail(CLOSE_INVALID_DATA, "invalid utf-8") from None
                else:
                    message = data
                if self._messages.qsize() >= _QUEUE_MAX:
                    self._room.clear()
                    await self._room.wait()
                self._messages.put_nowait(message)
        except _Fail as e:
            await self._fail(e)
        except (asyncio.IncompleteReadError, ConnectionError):
            if self.close_code is None:
                self.close_code = CLOSE_ABNORMAL
        finally:
            self._finish()
            self._writer.close()

    async def _on_close_frame(self, payload: bytes) -> None:
        if len(payload) == 1:
            raise _Fail(CLOSE_PROTOCOL_ERROR, "bad close frame")
        if len(payload) >= 2:
            (code,) = struct.unpack("!H", payload[:2])
            try:
                reason = payload[2:].decode("utf-8")
            except UnicodeDecodeError:
                raise _Fail(CLOSE_INVALID_DATA, "invalid utf-8") from None
        else:
            code, reason = CLOSE_NO_STATUS, ""
        if self.close_code is None:
            self.close_code, self.close_reason = code, reason
        if not self._close_sent:
            self._close_sent = True
            try:
                await self._write(OP_CLOSE, _close_payload(code, ""))
            except ConnectionError:
                pass

    async def _fail(self, e: _Fail) -> None:
        """Close with the violation's code; skip what is left of the
        offending frame (bounded) so the peer reads our close frame
        rather than a reset, then wait briefly for its close."""
        if self.close_code is None:
            self.close_code, self.close_reason = e.code, e.reason
        if not self._close_sent:
            self._close_sent = True
            try:
                await self._write(OP_CLOSE, _close_payload(e.code, e.reason))
            except ConnectionError:
                return
        try:
            if 0 < e.discard <= _DISCARD_MAX:
                await asyncio.wait_for(
                    self._reader.readexactly(e.discard), self.close_timeout_s
                )
            deadline = time.monotonic() + self.close_timeout_s
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                _, opcode, _ = await asyncio.wait_for(self._read_frame(), left)
                if opcode == OP_CLOSE:
                    return
        except (_Fail, asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError):
            return

    async def _keepalive(self) -> None:
        """Ping every `ping_period_s`; drop a peer silent for
        `pong_wait_s` (no frame of any kind)."""
        while not self._done.is_set():
            await asyncio.sleep(self.ping_period_s)
            if self._done.is_set() or self._close_sent:
                return
            if self.pong_wait_s > 0 and (
                time.monotonic() - self.last_seen > self.pong_wait_s
            ):
                self.close_code = CLOSE_ABNORMAL
                self.close_reason = "pong timeout"
                self._finish()
                self._writer.close()
                return
            try:
                await self.ping()
            except ConnectionError:
                return


# ---------------------------------------------------------------- client


@dataclass
class HttpResult:
    status: int
    headers: Headers
    body: bytes

    def json(self) -> Any:
        return json.loads(self.body)


async def _read_response_head(reader) -> tuple[int, Headers]:
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head[:-4].decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers = Headers()
    for line in lines[1:]:
        name, _, value = line.partition(":")
        dict.__setitem__(headers, name.strip().lower(), value.strip())
    return status, headers


async def request(
    host: str,
    port: int,
    method: str,
    path: str,
    *,
    headers: dict[str, str] | None = None,
    body: Any = None,
) -> HttpResult:
    """One HTTP/1.1 request on its own connection. A dict or list `body`
    is sent as JSON; bytes as they are."""
    if body is None:
        data = b""
    elif isinstance(body, (bytes, bytearray)):
        data = bytes(body)
    else:
        data = json.dumps(body).encode()
    lines = [f"{method} {path} HTTP/1.1", f"Host: {host}:{port}",
             "Connection: close", f"Content-Length: {len(data)}"]
    if body is not None and not isinstance(body, (bytes, bytearray)):
        lines.append("Content-Type: application/json")
    lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + data)
        await writer.drain()
        status, rh = await _read_response_head(reader)
        length = rh.get("content-length")
        payload = (
            await reader.readexactly(int(length)) if length is not None
            else await reader.read()
        )
        return HttpResult(status, rh, payload)
    finally:
        writer.close()


async def connect(
    host: str,
    port: int,
    path: str = "/ws",
    *,
    headers: dict[str, str] | None = None,
    max_message_size: int = 1 << 20,
) -> WebSocket:
    """Open a WebSocket client connection. Raises HttpError with the
    server's status if it refuses the upgrade."""
    key = base64.b64encode(os.urandom(16)).decode()
    lines = [
        f"GET {path} HTTP/1.1", f"Host: {host}:{port}", "Upgrade: websocket",
        "Connection: Upgrade", f"Sec-WebSocket-Key: {key}",
        "Sec-WebSocket-Version: 13",
    ]
    lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
        await writer.drain()
        status, rh = await _read_response_head(reader)
        if status != 101:
            length = int(rh.get("content-length", "0") or 0)
            body = await reader.readexactly(length) if length else b""
            raise HttpError(status, body.decode(errors="replace"))
        if rh.get("sec-websocket-accept") != accept_key(key):
            raise HttpError(400, "bad Sec-WebSocket-Accept")
    except BaseException:
        writer.close()
        raise
    return WebSocket(
        reader, writer, is_client=True, max_message_size=max_message_size,
        path=path,
    )

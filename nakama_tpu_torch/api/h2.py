"""HTTP/2 (RFC 9113), the server side, over `asyncio` streams.

The transport of the port's gRPC front door (`api/grpc_server.py`),
where the JAX package has grpcio's C core. Cleartext with prior
knowledge (`h2c`), as a gRPC listener on an insecure port speaks it:

- **Handshake.** The server's SETTINGS goes out as the connection
  opens, with a WINDOW_UPDATE that opens the connection's window as far
  as each stream's; then the client's preface and its SETTINGS, which is
  acknowledged. Setting ids this side does not know are ignored (grpcio
  sends 0xFE03).
- **Headers.** HEADERS with CONTINUATION, the PADDED and PRIORITY flags;
  header blocks decoded by `hpack.Decoder` in arrival order (a refused
  block is COMPRESSION_ERROR). A stream opens on its HEADERS and its
  handler (`handler(stream)`) runs in a task of its own.
- **Data and flow control.** DATA, padded or not, counted against the
  connection's and the stream's windows as received; WINDOW_UPDATE goes
  back as the data is taken in, once half a window has been consumed.
  Outgoing DATA waits for the client's window at both levels and is cut
  at its SETTINGS_MAX_FRAME_SIZE: a response larger than the window
  waits for WINDOW_UPDATE (or a larger SETTINGS_INITIAL_WINDOW_SIZE).
- **Control frames.** PING is acknowledged. RST_STREAM cancels that
  stream's task and nothing else. GOAWAY goes out on `stop()` (then the
  streams in flight finish within the grace, later ones are refused)
  and on a connection error, with its code.
- **Errors.** A connection error (a bad preface, a frame too large, a
  frame on the wrong stream, a window overflow, a malformed header
  block) sends GOAWAY and closes; a stream error (DATA on a closed
  stream, a zero WINDOW_UPDATE on a stream) resets that stream alone.

Counters (`frames_in`, `frames_out`, `bytes_in`, `bytes_out`) are kept
per server, for the frames and bytes a request costs.
"""

from __future__ import annotations

import asyncio
import struct

from . import hpack

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_HEADER_LIST_SIZE = 0x6

NO_ERROR = 0x0
PROTOCOL_ERROR = 0x1
INTERNAL_ERROR = 0x2
FLOW_CONTROL_ERROR = 0x3
STREAM_CLOSED = 0x5
FRAME_SIZE_ERROR = 0x6
REFUSED_STREAM = 0x7
CANCEL = 0x8
COMPRESSION_ERROR = 0x9

DEFAULT_WINDOW = 65_535
MAX_WINDOW = (1 << 31) - 1
DEFAULT_MAX_FRAME = 16_384
# This server's receive window, each stream's and the connection's (a
# 4 MiB gRPC message fits one), its concurrent streams and the largest
# header block it reads.
WINDOW = 1 << 22
MAX_STREAMS = 1024
MAX_HEADER_BLOCK = 64 << 10
_HEAD = struct.Struct(">I")


class H2Error(Exception):
    """A connection error: GOAWAY with `code`, then close."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class StreamError(Exception):
    """A stream error: RST_STREAM with `code`; the connection goes on."""

    def __init__(self, stream_id: int, code: int, message: str):
        super().__init__(message)
        self.stream_id = stream_id
        self.code = code


def frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    n = len(payload)
    return (bytes(((n >> 16) & 0xFF, (n >> 8) & 0xFF, n & 0xFF, ftype, flags))
            + _HEAD.pack(stream_id & MAX_WINDOW) + payload)


def settings_payload(settings: dict) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in settings.items())


class Stream:
    """One request stream: its headers, its body once the client ends
    it, and the calls that answer it."""

    def __init__(self, conn: "Connection", stream_id: int, send_window: int):
        self.conn = conn
        self.id = stream_id
        self.headers: list[tuple[str, str]] = []
        self._body = bytearray()
        # Bytes of DATA past `max_body`, dropped unbuffered (their
        # windows are still given back).
        self.overflow = 0
        self.ended = asyncio.Event()  # the client's END_STREAM
        self.send_window = send_window
        self.recv_consumed = 0  # taken in since the last WINDOW_UPDATE
        self.closed = False  # our END_STREAM or a reset
        self.headers_sent = False  # the response's HEADERS went out
        self.task: asyncio.Task | None = None

    def header(self, name: str, default: str = "") -> str:
        for n, v in self.headers:
            if n == name:
                return v
        return default

    async def body(self) -> bytes:
        await self.ended.wait()
        return bytes(self._body)

    async def send_headers(self, headers, end_stream: bool = False) -> None:
        await self.conn.send_headers(self, headers, end_stream)

    async def send_data(self, data: bytes, end_stream: bool = False) -> None:
        await self.conn.send_data(self, data, end_stream)


class Connection:
    def __init__(self, server: "H2Server", reader, writer):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.streams: dict[int, Stream] = {}
        self.tasks: set[asyncio.Task] = set()
        self.decoder = hpack.Decoder(hpack.DEFAULT_TABLE_SIZE)
        self.encoder = hpack.Encoder(hpack.DEFAULT_TABLE_SIZE)
        # The client's settings (what our sends obey).
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.send_window = DEFAULT_WINDOW
        # Our receive side.
        self.recv_window = WINDOW  # after the opening WINDOW_UPDATE
        self.recv_consumed = 0
        self.last_stream_id = 0  # the highest stream the client opened
        self.goaway_sent = False
        self.goaway_received = False
        self.closed = False
        self._window_waiters: list[asyncio.Future] = []

    # -------------------------------------------------------------- writes

    def _write(self, data: bytes, frames: int = 1) -> None:
        if self.closed or self.writer.is_closing():
            raise ConnectionError("connection closed")
        self.server.frames_out += frames
        self.server.bytes_out += len(data)
        self.writer.write(data)

    async def _drain(self) -> None:
        try:
            await self.writer.drain()
        except (ConnectionError, RuntimeError) as e:
            # RuntimeError: the transport closed under a waiting drain.
            self.lost()
            raise ConnectionError("connection lost") from e

    async def send_headers(self, stream: Stream, headers, end_stream: bool) -> None:
        if stream.closed:
            raise ConnectionError(f"stream {stream.id} is closed")
        # Encoded and written with no await between: the peer's decoder
        # must see the blocks in the order this encoder made them.
        block = self.encoder.encode(headers)
        size = self.peer_max_frame
        chunks = [block[i:i + size] for i in range(0, len(block), size)] or [b""]
        out = bytearray()
        for i, chunk in enumerate(chunks):
            flags = FLAG_END_HEADERS if i == len(chunks) - 1 else 0
            if i == 0:
                if end_stream:
                    flags |= FLAG_END_STREAM
                out += frame(HEADERS, flags, stream.id, chunk)
            else:
                out += frame(CONTINUATION, flags, stream.id, chunk)
        self._write(bytes(out), len(chunks))
        stream.headers_sent = True
        if end_stream:
            self._close_stream(stream)
        await self._drain()

    async def send_data(self, stream: Stream, data: bytes, end_stream: bool) -> None:
        view = memoryview(data)
        while True:
            if stream.closed:
                raise ConnectionError(f"stream {stream.id} is closed")
            if not len(view):
                if end_stream:
                    self._write(frame(DATA, FLAG_END_STREAM, stream.id))
                    self._close_stream(stream)
                    await self._drain()
                return
            room = min(self.send_window, stream.send_window, self.peer_max_frame)
            if room <= 0:
                await self._wait_window()
                continue
            chunk = view[:room]
            view = view[room:]
            self.send_window -= len(chunk)
            stream.send_window -= len(chunk)
            last = end_stream and not len(view)
            self._write(frame(DATA, FLAG_END_STREAM if last else 0, stream.id,
                              bytes(chunk)))
            if last:
                self._close_stream(stream)
            await self._drain()
            if last:
                return

    async def _wait_window(self) -> None:
        if self.closed:
            raise ConnectionError("connection closed")
        fut = asyncio.get_running_loop().create_future()
        self._window_waiters.append(fut)
        await fut

    def _window_opened(self) -> None:
        waiters, self._window_waiters = self._window_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    def reset(self, stream_id: int, code: int) -> None:
        stream = self.streams.get(stream_id)
        if stream is not None:
            self._close_stream(stream)
        try:
            self._write(frame(RST_STREAM, 0, stream_id, _HEAD.pack(code)))
        except ConnectionError:
            pass

    def goaway(self, code: int = NO_ERROR, message: str = "") -> None:
        if self.goaway_sent or self.closed:
            return
        self.goaway_sent = True
        payload = (_HEAD.pack(self.last_stream_id) + _HEAD.pack(code)
                   + message.encode("utf-8", "replace")[:256])
        try:
            self._write(frame(GOAWAY, 0, 0, payload))
        except ConnectionError:
            pass

    def _close_stream(self, stream: Stream) -> None:
        stream.closed = True
        self.streams.pop(stream.id, None)

    def lost(self) -> None:
        """The connection is gone: every stream's task is cancelled and
        every sender waiting for a window wakes to an error."""
        if self.closed:
            return
        self.closed = True
        for fut in self._window_waiters:
            if not fut.done():
                fut.set_exception(ConnectionError("connection lost"))
        self._window_waiters = []
        for stream in list(self.streams.values()):
            stream.closed = True
            stream.ended.set()
            if stream.task is not None:
                stream.task.cancel()
        self.streams.clear()
        self.writer.close()

    # --------------------------------------------------------------- reads

    async def serve(self) -> None:
        server = self.server
        try:
            self._write(
                frame(SETTINGS, 0, 0, settings_payload(server.settings))
                + frame(WINDOW_UPDATE, 0, 0, _HEAD.pack(WINDOW - DEFAULT_WINDOW)),
                2)
            await self._drain()
            preface = await self.reader.readexactly(len(PREFACE))
            if preface != PREFACE:
                raise H2Error(PROTOCOL_ERROR, "bad connection preface")
            first = True
            while True:
                head = await self.reader.readexactly(9)
                length = (head[0] << 16) | (head[1] << 8) | head[2]
                ftype, flags = head[3], head[4]
                stream_id = _HEAD.unpack_from(head, 5)[0] & MAX_WINDOW
                if length > DEFAULT_MAX_FRAME:
                    raise H2Error(FRAME_SIZE_ERROR, f"frame of {length} bytes")
                payload = await self.reader.readexactly(length) if length else b""
                server.frames_in += 1
                server.bytes_in += 9 + length
                if first and ftype != SETTINGS:
                    raise H2Error(PROTOCOL_ERROR, "the preface's SETTINGS is missing")
                first = False
                try:
                    if ftype == HEADERS:
                        await self._on_headers(flags, stream_id, payload)
                    else:
                        self._on_frame(ftype, flags, stream_id, payload)
                except StreamError as e:
                    self.reset(e.stream_id, e.code)
                await self._drain()
                if self.goaway_received and not self.streams:
                    return
        except H2Error as e:
            self.goaway(e.code, str(e))
            try:
                await self.writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self.lost()

    async def _on_headers(self, flags: int, stream_id: int, payload: bytes) -> None:
        if stream_id == 0:
            raise H2Error(PROTOCOL_ERROR, "HEADERS on stream 0")
        payload = self._unpad(flags, payload)
        if flags & FLAG_PRIORITY:
            if len(payload) < 5:
                raise H2Error(FRAME_SIZE_ERROR, "short PRIORITY fields")
            payload = payload[5:]
        block = bytearray(payload)
        end_stream = bool(flags & FLAG_END_STREAM)
        while not flags & FLAG_END_HEADERS:
            head = await self.reader.readexactly(9)
            length = (head[0] << 16) | (head[1] << 8) | head[2]
            ftype, flags = head[3], head[4]
            sid = _HEAD.unpack_from(head, 5)[0] & MAX_WINDOW
            if length > DEFAULT_MAX_FRAME:
                raise H2Error(FRAME_SIZE_ERROR, f"frame of {length} bytes")
            self.server.frames_in += 1
            self.server.bytes_in += 9 + length
            if ftype != CONTINUATION or sid != stream_id:
                raise H2Error(PROTOCOL_ERROR, "a header block was interrupted")
            block += await self.reader.readexactly(length) if length else b""
            if len(block) > MAX_HEADER_BLOCK:
                raise H2Error(PROTOCOL_ERROR, "header block too large")
        try:
            headers = self.decoder.decode(bytes(block))
        except hpack.HpackError as e:
            raise H2Error(COMPRESSION_ERROR, str(e)) from e
        stream = self.streams.get(stream_id)
        if stream is not None:
            # Trailers: the client's request ends here.
            if not end_stream:
                raise StreamError(stream_id, PROTOCOL_ERROR, "trailers without END_STREAM")
            stream.ended.set()
            return
        if stream_id % 2 == 0:
            raise H2Error(PROTOCOL_ERROR, f"even stream id {stream_id}")
        if stream_id <= self.last_stream_id:
            raise StreamError(stream_id, STREAM_CLOSED, "HEADERS on a closed stream")
        self.last_stream_id = stream_id
        if self.goaway_sent or self.server.stopping:
            raise StreamError(stream_id, REFUSED_STREAM, "the server is stopping")
        if len(self.streams) >= MAX_STREAMS:
            raise StreamError(stream_id, REFUSED_STREAM, "too many streams")
        stream = Stream(self, stream_id, self.peer_initial_window)
        stream.headers = headers
        if end_stream:
            stream.ended.set()
        self.streams[stream_id] = stream
        task = asyncio.get_running_loop().create_task(self._run(stream))
        stream.task = task
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    async def _run(self, stream: Stream) -> None:
        try:
            await self.server.handler(stream)
        except asyncio.CancelledError:
            raise
        except ConnectionError:
            pass  # the stream was reset or the connection lost
        except Exception as e:  # the handler's own failure: reset, log
            self.server.logger.error("http2 stream handler failed",
                                     error=repr(e))
            if not stream.closed and not self.closed:
                self.reset(stream.id, INTERNAL_ERROR)
        finally:
            if not stream.closed and not self.closed:
                # The handler returned without ending its stream.
                self.reset(stream.id, CANCEL)

    def _unpad(self, flags: int, payload: bytes) -> bytes:
        if not flags & FLAG_PADDED:
            return payload
        if not payload:
            raise H2Error(FRAME_SIZE_ERROR, "padded frame without a pad length")
        pad = payload[0]
        if pad >= len(payload):
            raise H2Error(PROTOCOL_ERROR, "padding past the frame")
        return payload[1:len(payload) - pad]

    def _on_frame(self, ftype: int, flags: int, stream_id: int, payload: bytes) -> None:
        if ftype == DATA:
            self._on_data(flags, stream_id, payload)
        elif ftype == SETTINGS:
            if stream_id:
                raise H2Error(PROTOCOL_ERROR, "SETTINGS on a stream")
            if flags & FLAG_ACK:
                if payload:
                    raise H2Error(FRAME_SIZE_ERROR, "SETTINGS ACK with a payload")
                return
            self._on_settings(payload)
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise H2Error(FRAME_SIZE_ERROR, "WINDOW_UPDATE of a bad size")
            inc = _HEAD.unpack(payload)[0] & MAX_WINDOW
            if stream_id == 0:
                if inc == 0:
                    raise H2Error(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                self.send_window += inc
                if self.send_window > MAX_WINDOW:
                    raise H2Error(FLOW_CONTROL_ERROR, "connection window overflow")
            else:
                stream = self.streams.get(stream_id)
                if inc == 0:
                    raise StreamError(stream_id, PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                if stream is not None:
                    stream.send_window += inc
                    if stream.send_window > MAX_WINDOW:
                        raise StreamError(stream_id, FLOW_CONTROL_ERROR,
                                          "stream window overflow")
            self._window_opened()
        elif ftype == PING:
            if stream_id:
                raise H2Error(PROTOCOL_ERROR, "PING on a stream")
            if len(payload) != 8:
                raise H2Error(FRAME_SIZE_ERROR, "PING of a bad size")
            if not flags & FLAG_ACK:
                self._write(frame(PING, FLAG_ACK, 0, payload))
        elif ftype == RST_STREAM:
            if stream_id == 0:
                raise H2Error(PROTOCOL_ERROR, "RST_STREAM on stream 0")
            if len(payload) != 4:
                raise H2Error(FRAME_SIZE_ERROR, "RST_STREAM of a bad size")
            stream = self.streams.pop(stream_id, None)
            if stream is not None:
                stream.closed = True
                stream.ended.set()
                if stream.task is not None:
                    stream.task.cancel()
                self._window_opened()  # a sender waiting on it wakes
        elif ftype == GOAWAY:
            if stream_id:
                raise H2Error(PROTOCOL_ERROR, "GOAWAY on a stream")
            self.goaway_received = True
        elif ftype == PRIORITY:
            if len(payload) != 5:
                raise StreamError(stream_id, FRAME_SIZE_ERROR, "PRIORITY of a bad size")
        elif ftype == PUSH_PROMISE:
            raise H2Error(PROTOCOL_ERROR, "PUSH_PROMISE from a client")
        elif ftype == CONTINUATION:
            raise H2Error(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        # Any other type is an extension: ignored.

    def _on_settings(self, payload: bytes) -> None:
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "SETTINGS of a bad size")
        for off in range(0, len(payload), 6):
            key, value = struct.unpack_from(">HI", payload, off)
            if key == SETTINGS_HEADER_TABLE_SIZE:
                self.encoder.resize(min(value, hpack.DEFAULT_TABLE_SIZE))
            elif key == SETTINGS_ENABLE_PUSH:
                if value > 1:
                    raise H2Error(PROTOCOL_ERROR, "ENABLE_PUSH above 1")
            elif key == SETTINGS_INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise H2Error(FLOW_CONTROL_ERROR, "INITIAL_WINDOW_SIZE too large")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for stream in self.streams.values():
                    stream.send_window += delta
                    if stream.send_window > MAX_WINDOW:
                        raise H2Error(FLOW_CONTROL_ERROR, "stream window overflow")
            elif key == SETTINGS_MAX_FRAME_SIZE:
                if not DEFAULT_MAX_FRAME <= value <= (1 << 24) - 1:
                    raise H2Error(PROTOCOL_ERROR, "MAX_FRAME_SIZE out of range")
                self.peer_max_frame = value
            # MAX_CONCURRENT_STREAMS (this side pushes nothing),
            # MAX_HEADER_LIST_SIZE and unknown ids: nothing to do.
        self._write(frame(SETTINGS, FLAG_ACK, 0))
        self._window_opened()

    def _on_data(self, flags: int, stream_id: int, payload: bytes) -> None:
        if stream_id == 0:
            raise H2Error(PROTOCOL_ERROR, "DATA on stream 0")
        size = len(payload)  # padding counts against the windows
        if size > self.recv_window:
            raise H2Error(FLOW_CONTROL_ERROR, "DATA past the connection window")
        self.recv_window -= size
        self._consumed(size)
        stream = self.streams.get(stream_id)
        if stream is None or stream.ended.is_set():
            if stream_id > self.last_stream_id:
                raise H2Error(PROTOCOL_ERROR, f"DATA on idle stream {stream_id}")
            raise StreamError(stream_id, STREAM_CLOSED, "DATA on a closed stream")
        data = self._unpad(flags, payload)
        room = self.server.max_body - len(stream._body)
        if len(data) > room:
            stream.overflow += len(data) - max(room, 0)
            data = data[:max(room, 0)]
        stream._body += data
        if flags & FLAG_END_STREAM:
            stream.ended.set()
        else:
            stream.recv_consumed += size
            if stream.recv_consumed >= WINDOW // 2:
                self._write(frame(WINDOW_UPDATE, 0, stream_id,
                                  _HEAD.pack(stream.recv_consumed)))
                stream.recv_consumed = 0

    def _consumed(self, size: int) -> None:
        self.recv_consumed += size
        if self.recv_consumed >= WINDOW // 2:
            self._write(frame(WINDOW_UPDATE, 0, 0, _HEAD.pack(self.recv_consumed)))
            self.recv_window += self.recv_consumed
            self.recv_consumed = 0


class H2Server:
    """An HTTP/2 listener: `handler(stream)` serves each request stream
    (`Stream.headers`, `await stream.body()`, `send_headers`,
    `send_data`)."""

    def __init__(self, handler, logger, max_body: int):
        self.handler = handler
        self.logger = logger
        # Body bytes a stream buffers; past it they are counted in
        # `Stream.overflow` and dropped.
        self.max_body = max_body
        self.settings = {
            SETTINGS_MAX_CONCURRENT_STREAMS: MAX_STREAMS,
            SETTINGS_INITIAL_WINDOW_SIZE: WINDOW,
            SETTINGS_MAX_FRAME_SIZE: DEFAULT_MAX_FRAME,
            SETTINGS_MAX_HEADER_LIST_SIZE: MAX_HEADER_BLOCK,
            SETTINGS_ENABLE_PUSH: 0,
        }
        self.connections: set[Connection] = set()
        self._conn_tasks: set[asyncio.Task] = set()
        self._server: asyncio.base_events.Server | None = None
        self.stopping = False
        self.frames_in = self.frames_out = 0
        self.bytes_in = self.bytes_out = 0

    async def start(self, host: str, port: int) -> int:
        """Listen; the bound port. A failed bind raises `OSError`."""
        self._server = await asyncio.start_server(self._accept, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def _accept(self, reader, writer) -> None:
        conn = Connection(self, reader, writer)
        if self.stopping:
            writer.close()
            return
        self.connections.add(conn)
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            await conn.serve()
        finally:
            self.connections.discard(conn)
            self._conn_tasks.discard(task)

    async def stop(self, grace: float = 1.0) -> None:
        """GOAWAY to every connection, the streams in flight given
        `grace` seconds to finish (new ones refused), then every
        connection closed."""
        self.stopping = True
        if self._server is not None:
            self._server.close()
        for conn in list(self.connections):
            conn.goaway(NO_ERROR)
            try:
                await conn.writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        pending = [t for conn in self.connections for t in conn.tasks]
        if pending:
            await asyncio.wait(pending, timeout=grace)
        for conn in list(self.connections):
            conn.lost()
        if self._conn_tasks:
            await asyncio.wait(list(self._conn_tasks), timeout=grace)
        for task in list(self._conn_tasks):
            task.cancel()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

"""The port's gRPC front door (`nakama_tpu_torch/api/grpc_server.py` over
`api/h2.py`, `api/hpack.py` and `proto/`) held against the JAX
package's (`nakama_tpu/api/grpc_server.py`: grpcio, `json_format`,
`api_pb2`):

- HPACK: RFC 7541 Appendix C.2-C.6 decoded and re-encoded byte for
  byte, with and without Huffman; the Huffman table's Kraft sum is
  exactly 1 and its codes canonical; every byte value round-trips;
  malformed blocks are refused.
- HTTP/2, with a raw client on the port's own framing
  (`chip_smoke.GrpcClient` and hand-built frames) against a gateway over
  a stub REST listener: a request split at every byte boundary;
  CONTINUATION, padded and PRIORITY frames; a response larger than the
  client's 65,535-byte window stalls until WINDOW_UPDATE, then
  completes; a reset stream leaves its connection serving; `stop()`
  sends GOAWAY and lets the call in flight finish; the loopback call
  carries the client's deadline and a cursor's `+/= ` intact.
- Schema and codec: the port's reading of its `api.proto` equals
  `api_pb2.DESCRIPTOR` field for field and the service's 80 methods;
  seeded instances of all 78 messages (int64 at its limits, wrappers at
  zero, Structs) encode to `SerializeToString()`'s bytes, decode to
  `MessageToDict`'s dicts and parse as `ParseDict(...,
  ignore_unknown_fields=True)`.
- Routes: the port's `ROUTES` equal the JAX `ROUTES` row for row.
- One `grpc.aio` script on both servers (the runtime modules and store
  fetchers of `test_torch_server.py`): the flows of
  `tests/test_grpc_api.py`, an unknown method, bytes that do not
  decode, a gzip request, a cursor holding `+/=`, metadata holding
  every printable byte, a client deadline and `traceparent`; answers,
  status codes and the `traceparent` trailer's presence equal once ids
  and times are normalised.
- `socket.grpc_port` 0 and -1, a failed bind.

Stated tolerance: none — every compared value must be equal."""

import asyncio
import base64
import socket
import urllib.parse
import zlib
from fractions import Fraction

import grpc
import numpy as np
import pytest
from google.protobuf import json_format, struct_pb2, wrappers_pb2

import chip_smoke
import provider_fakes as F
import test_torch_server as S
from test_torch_protocol import Gen

from nakama_tpu.api import grpc_server as jax_grpc
from nakama_tpu.proto import api_pb2 as P
from nakama_tpu_torch import config as port_config
from nakama_tpu_torch import proto
from nakama_tpu_torch.api import grpc_server as port_grpc
from nakama_tpu_torch.api import h2, hpack
from nakama_tpu_torch.api.wsproto import HttpServer, json_response
from nakama_tpu_torch.logger import test_logger as port_logger
from nakama_tpu_torch.proto import schema as port_schema

HOST = "127.0.0.1"
API = port_schema.api()
SERVICE = API.services["nakama_tpu.api.NakamaApi"]
MESSAGES = sorted(n for n, m in API.messages.items()
                  if n.startswith("nakama_tpu.api.") and not m.map_entry)


def hx(text: str) -> bytes:
    return bytes.fromhex("".join(text.split()))


# ------------------------------------------------------------------- HPACK

C_REQUESTS = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com"), ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]
C_RESPONSES = [
    [(":status", "302"), ("cache-control", "private"),
     ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
     ("location", "https://www.example.com")],
    [(":status", "307"), ("cache-control", "private"),
     ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
     ("location", "https://www.example.com")],
    [(":status", "200"), ("cache-control", "private"),
     ("date", "Mon, 21 Oct 2013 20:13:22 GMT"),
     ("location", "https://www.example.com"), ("content-encoding", "gzip"),
     ("set-cookie", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")],
]
# RFC 7541 Appendix C: (section, table size, Huffman, headers, blocks).
APPENDIX_C = [
    ("C.3", 4096, False, C_REQUESTS, [
        "8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
        "8286 84be 5808 6e6f 2d63 6163 6865",
        "8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661"
        " 6c75 65"]),
    ("C.4", 4096, True, C_REQUESTS, [
        "8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff",
        "8286 84be 5886 a8eb 1064 9cbf",
        "8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf"]),
    ("C.5", 256, False, C_RESPONSES, [
        "4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63"
        " 7420 3230 3133 2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073"
        " 3a2f 2f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
        "4803 3330 37c1 c0bf",
        "88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133"
        " 3a32 3220 474d 54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48"
        " 514b 425a 584f 5157 454f 5049 5541 5851 5745 4f49 553b 206d 6178"
        " 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e 3d31"]),
    ("C.6", 256, True, C_RESPONSES, [
        "4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504"
        " 0b81 66e0 82a6 2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae"
        " 43d3",
        "4883 640e ffc1 c0bf",
        "88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff"
        " c05a 839b d9ab 77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af"
        " 2708 7f36 72c1 ab27 0fb5 291f 9587 3160 65c0 03ed 4ee5 b106 3d50"
        " 07"]),
]
# Appendix C.2: one representation each, on an empty table.
APPENDIX_C2 = [
    ("C.2.1", ("custom-key", "custom-header"),
     "400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572", 55),
    ("C.2.2", (":path", "/sample/path", hpack.NO_INDEX),
     "040c 2f73 616d 706c 652f 7061 7468", 0),
    ("C.2.3", ("password", "secret", hpack.NEVER_INDEX),
     "1008 7061 7373 776f 7264 0673 6563 7265 74", 0),
    ("C.2.4", (":method", "GET"), "82", 0),
]


@pytest.mark.parametrize("section,header,block,size", APPENDIX_C2,
                         ids=[c[0] for c in APPENDIX_C2])
def test_hpack_appendix_c2_representations(section, header, block, size):
    dec = hpack.Decoder()
    assert dec.decode(hx(block)) == [header[:2]]
    assert dec.table.size == size
    enc = hpack.Encoder()
    assert enc.encode([header], huffman=False) == hx(block)
    assert enc.table.size == size


@pytest.mark.parametrize("section,table,huffman,lists,blocks", APPENDIX_C,
                         ids=[c[0] for c in APPENDIX_C])
def test_hpack_appendix_c_sequences(section, table, huffman, lists, blocks):
    dec, enc = hpack.Decoder(table), hpack.Encoder(table)
    for headers, block in zip(lists, blocks):
        assert dec.decode(hx(block)) == headers
        assert enc.encode(headers, huffman=huffman) == hx(block)
        assert enc.table.entries == dec.table.entries
    # C.5/C.6's third response evicts down to these three entries.
    if table == 256:
        assert dec.table.size == 215 and len(dec.table.entries) == 3


def test_huffman_table_kraft_sum_and_canonical_codes():
    assert len(hpack.HUFFMAN) == 257
    assert sum(Fraction(1, 1 << bits) for _, bits in hpack.HUFFMAN) == 1
    order = sorted(range(257), key=lambda s: (hpack.HUFFMAN[s][1], s))
    code, prev = 0, hpack.HUFFMAN[order[0]][1]
    for sym in order:
        bits = hpack.HUFFMAN[sym][1]
        code <<= bits - prev
        prev = bits
        assert hpack.HUFFMAN[sym][0] == code, sym
        code += 1
    assert hpack.HUFFMAN[256] == (0x3FFFFFFF, 30)  # EOS


def test_huffman_round_trips_every_byte_value():
    rng = np.random.default_rng(14)
    cases = [bytes(range(256)), bytes(range(255, -1, -1)), b""]
    cases += [rng.integers(0, 256, int(rng.integers(1, 64)),
                           dtype=np.uint8).tobytes() for _ in range(64)]
    for raw in cases:
        coded = hpack.huffman_encode(raw)
        assert len(coded) == hpack.huffman_length(raw)
        assert hpack.huffman_decode(coded) == raw
    # And through a whole header block, Huffman-coded and indexed.
    text = bytes(range(256)).decode("latin-1")
    enc, dec = hpack.Encoder(), hpack.Decoder()
    for _ in range(2):  # the second time from the dynamic table
        assert dec.decode(enc.encode([("x-all", text)])) == [("x-all", text)]


@pytest.mark.parametrize("block", [
    "80",                  # index 0
    "be",                  # index 62 on an empty dynamic table
    "ff 80 80 80 80 10",   # an integer over 2^32
    "40 85 f2 b2 4a 87 ff",  # a truncated Huffman string
    "00 81 00 01 61",      # Huffman padding of zeros (not EOS's ones)
    "00 81 ff 81 01",      # padding of 8 bits
    "00 84 ff ff ff ff",   # EOS inside a string
    "3f e2 1f",            # a size update to 4,097
    "82 20",               # a size update after a header field
    "40 0a 63 75",         # a literal running past the block
], ids=["index0", "past-table", "big-int", "truncated", "zero-padding",
        "long-padding", "eos", "update-over", "update-late", "short"])
def test_hpack_refuses_malformed_blocks(block):
    with pytest.raises(hpack.HpackError):
        hpack.Decoder().decode(hx(block))


def test_hpack_encoder_follows_the_peers_table_size():
    enc, dec = hpack.Encoder(), hpack.Decoder()
    dec.decode(enc.encode([("a", "1"), ("b", "2")]))
    enc.resize(0)
    enc.resize(64)
    block = enc.encode([("c", "3")])
    # The smallest size since the last block, then the last one.
    assert block[:2] == bytes((0x20, 0x3F)) and block[2] == 64 - 31
    assert dec.decode(block) == [("c", "3")]
    assert dec.table.entries == enc.table.entries == [("c", "3")]


# ------------------------------------------------------------- the framer


class StubRest:
    """A REST listener that answers every call with `answer` (status,
    JSON body) after `delay` seconds, recording each request."""

    def __init__(self, answer=(200, {}), delay: float = 0.0):
        self.answer, self.delay = answer, delay
        self.requests: list = []
        self.entered = asyncio.Event()
        self.http = HttpServer(self._handle, max_request_size=1 << 20)

    async def _handle(self, request):
        self.requests.append(request)
        self.entered.set()
        if self.delay:
            await asyncio.sleep(self.delay)
        status, body = self.answer
        return json_response(body, status, {"traceparent": "00-" + "a" * 32
                                            + "-" + "b" * 16 + "-01"})


async def gateway(stub: StubRest):
    rest_port = await stub.http.start(HOST, 0)
    gw = port_grpc.GrpcGateway(port_logger(), HOST, rest_port)
    await gw.start(HOST, 0)
    return gw


async def stop(gw, stub):
    await gw.stop()
    await stub.http.stop()
    await stub.http.wait_closed()


def request_bytes(method: str, message: bytes = b"", sid: int = 1,
                  padded: bool = False, continuation: bool = False,
                  encoding: str = "") -> bytes:
    headers = [(":method", "POST"), (":scheme", "http"),
               (":path", chip_smoke.GRPC_SERVICE + method),
               (":authority", "smoke"), ("te", "trailers"),
               ("content-type", "application/grpc"),
               ("authorization", "Bearer t")]
    if encoding:
        headers.append(("grpc-encoding", encoding))
    block = hpack.Encoder().encode(headers)
    flag = b"\x01" if encoding else b"\x00"
    body = flag + len(message).to_bytes(4, "big") + message
    out = h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0)
    if continuation:
        # HEADERS padded with PRIORITY fields, then two CONTINUATIONs.
        a, b = len(block) // 3, 2 * len(block) // 3
        first = bytes((4,)) + bytes(5) + block[:a] + bytes(4)
        out += h2.frame(h2.HEADERS, h2.FLAG_PADDED | h2.FLAG_PRIORITY, sid, first)
        out += h2.frame(h2.CONTINUATION, 0, sid, block[a:b])
        out += h2.frame(h2.CONTINUATION, h2.FLAG_END_HEADERS, sid, block[b:])
    else:
        out += h2.frame(h2.HEADERS, h2.FLAG_END_HEADERS, sid, block)
    if padded:
        body = bytes((7,)) + body + bytes(7)
        return out + h2.frame(h2.DATA, h2.FLAG_END_STREAM | h2.FLAG_PADDED, sid, body)
    return out + h2.frame(h2.DATA, h2.FLAG_END_STREAM, sid, body)


async def read_answer(reader, sid: int = 1) -> dict:
    """Frames until `sid` ends: its header lists and DATA."""
    dec = hpack.Decoder()
    out = {"blocks": [], "data": b"", "types": []}
    while True:
        head = await asyncio.wait_for(reader.readexactly(9), 5)
        n = int.from_bytes(head[:3], "big")
        payload = await reader.readexactly(n) if n else b""
        ftype, flags, stream = head[3], head[4], int.from_bytes(head[5:9], "big")
        out["types"].append(ftype)
        if ftype == h2.HEADERS:
            out["blocks"].append(dict(dec.decode(payload)))
        elif ftype == h2.DATA and stream == sid:
            out["data"] += payload
        if stream == sid and flags & h2.FLAG_END_STREAM:
            return out


async def test_a_request_split_at_every_byte_boundary():
    stub = StubRest()
    gw = await gateway(stub)
    try:
        raw = request_bytes("NoSuchRpc")
        for cut in range(len(raw) + 1):
            reader, writer = await asyncio.open_connection(HOST, gw.port)
            writer.write(raw[:cut])
            await writer.drain()
            await asyncio.sleep(0)
            writer.write(raw[cut:])
            got = await read_answer(reader)
            assert got["blocks"][-1]["grpc-status"] == "12", cut
            writer.close()
        # A served call, its bytes written one at a time.
        reader, writer = await asyncio.open_connection(HOST, gw.port)
        for i in range(len(raw := request_bytes("Healthcheck"))):
            writer.write(raw[i:i + 1])
            await writer.drain()
        got = await read_answer(reader)
        assert got["blocks"][-1]["grpc-status"] == "0"
        assert got["data"] == bytes(5)  # one empty message
        writer.close()
        assert len(stub.requests) == 1
    finally:
        await stop(gw, stub)


@pytest.mark.parametrize("padded,continuation", [(True, False), (False, True),
                                                 (True, True)])
async def test_continuation_priority_and_padded_frames(padded, continuation):
    stub = StubRest()
    gw = await gateway(stub)
    try:
        reader, writer = await asyncio.open_connection(HOST, gw.port)
        writer.write(request_bytes("Healthcheck", padded=padded,
                                   continuation=continuation))
        got = await read_answer(reader)
        assert got["blocks"][0][":status"] == "200"
        assert got["blocks"][-1]["grpc-status"] == "0"
        assert stub.requests[0].headers.get("Authorization") == "Bearer t"
        writer.close()
    finally:
        await stop(gw, stub)


async def test_a_response_past_the_window_waits_for_window_update():
    big = {"objects": [{"collection": "c", "key": f"k{i}", "value": "v" * 4000}
                       for i in range(40)]}  # ~160 KB once encoded
    stub = StubRest(answer=(200, big))
    gw = await gateway(stub)
    c = await chip_smoke.GrpcClient(HOST, gw.port, hold_window=True).connect()
    try:
        sid = c.start_call("ReadStorageObjects", {}, "ReadStorageObjectsRequest")
        st = c.streams[sid]
        # The client's default window: 65,535 bytes of DATA, then a stall.
        for _ in range(500):
            if len(st["data"]) >= h2.DEFAULT_WINDOW:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.2)
        assert not st["done"].done()
        assert len(st["data"]) == h2.DEFAULT_WINDOW
        for _ in range(10):
            c.release_window(sid)
            await asyncio.sleep(0.02)
            if st["done"].done():
                break
        reply = await asyncio.wait_for(c.reply(sid, "StorageObjects"), 5)
        assert reply.status == 0 and reply.body == big
        # Another call on the same connection is served.
        c.hold_window = False
        again = await c.call("Healthcheck", {}, "Empty", "Empty")
        assert again.status == 0
    finally:
        await c.close()
        await stop(gw, stub)


async def test_a_reset_stream_leaves_its_connection_serving():
    stub = StubRest(delay=0.2)
    gw = await gateway(stub)
    c = await chip_smoke.GrpcClient(HOST, gw.port).connect()
    try:
        sid = c.start_call("Healthcheck", {}, "Empty")
        await stub.entered.wait()
        c.reset(sid)
        stub.delay = 0
        replies = await asyncio.gather(*(
            c.call("Healthcheck", {}, "Empty", "Empty") for _ in range(8)))
        assert [r.status for r in replies] == [0] * 8
        assert c.goaway is None
    finally:
        await c.close()
        await stop(gw, stub)


async def test_stop_sends_goaway_and_the_call_in_flight_completes():
    stub = StubRest(delay=0.3)
    gw = await gateway(stub)
    c = await chip_smoke.GrpcClient(HOST, gw.port).connect()
    try:
        sid = c.start_call("Healthcheck", {}, "Empty")
        await stub.entered.wait()
        stopping = asyncio.get_running_loop().create_task(gw.stop())
        reply = await asyncio.wait_for(c.reply(sid, "Empty"), 10)
        await stopping
        assert reply.status == 0
        assert c.goaway == (sid, h2.NO_ERROR)
    finally:
        await c.close()
        await stub.http.stop()


async def read_frames(reader, until) -> list:
    """(type, flags, stream, payload) frames until `until(frame)`."""
    frames = []
    while True:
        head = await asyncio.wait_for(reader.readexactly(9), 5)
        n = int.from_bytes(head[:3], "big")
        payload = await reader.readexactly(n) if n else b""
        frames.append((head[3], head[4], int.from_bytes(head[5:9], "big"), payload))
        if until(frames[-1]):
            return frames


async def test_settings_ping_and_unknown_setting_ids():
    stub = StubRest()
    gw = await gateway(stub)
    try:
        reader, writer = await asyncio.open_connection(HOST, gw.port)
        # grpcio's own setting id (0xFE03) among the client's SETTINGS.
        writer.write(h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0, h2.settings_payload(
            {0xFE03: 1, h2.SETTINGS_INITIAL_WINDOW_SIZE: 1 << 20}))
            + h2.frame(h2.PING, 0, 0, b"pingpong"))
        frames = await read_frames(reader, lambda f: f[0] == h2.PING)
        kinds = [(f[0], f[1]) for f in frames]
        # The server's SETTINGS first, then its window, the ACK, the PING's.
        assert kinds[0] == (h2.SETTINGS, 0)
        assert (h2.SETTINGS, h2.FLAG_ACK) in kinds
        assert frames[-1] == (h2.PING, h2.FLAG_ACK, 0, b"pingpong")
        writer.close()
    finally:
        await stop(gw, stub)


@pytest.mark.parametrize("bad,code", [
    (b"GET / HTTP/1.1\r\nHost: x\r\n\r\n", h2.PROTOCOL_ERROR),
    (h2.PREFACE + h2.frame(h2.PING, 0, 0, b"ping"), h2.PROTOCOL_ERROR),
    (h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0)
     + h2.frame(h2.HEADERS, h2.FLAG_END_HEADERS, 1, b"\x80"), h2.COMPRESSION_ERROR),
    (h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0)
     + h2.frame(h2.DATA, 0, 3, b"x"), h2.PROTOCOL_ERROR),
    (h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0)
     + h2.frame(h2.PING, 0, 0, b"x" * 20000), h2.FRAME_SIZE_ERROR),
    (h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0)
     + h2.frame(h2.WINDOW_UPDATE, 0, 0, (h2.MAX_WINDOW).to_bytes(4, "big")),
     h2.FLOW_CONTROL_ERROR),
], ids=["http1", "no-settings", "hpack", "idle-data", "frame-size", "window"])
async def test_connection_errors_answer_goaway(bad, code):
    stub = StubRest()
    gw = await gateway(stub)
    try:
        reader, writer = await asyncio.open_connection(HOST, gw.port)
        writer.write(bad)
        frames = await read_frames(reader, lambda f: f[0] == h2.GOAWAY)
        assert int.from_bytes(frames[-1][3][4:8], "big") == code
        assert await asyncio.wait_for(reader.read(), 5) == b""  # closed
        assert not stub.requests
    finally:
        await stop(gw, stub)


async def test_a_client_gone_mid_request_leaves_no_task_and_stop_does_not_hang():
    stub = StubRest()
    gw = await gateway(stub)
    raw = request_bytes("Healthcheck")
    # HEADERS only: the request's body never ends.
    reader, writer = await asyncio.open_connection(HOST, gw.port)
    writer.write(raw[:raw.rindex(h2.frame(h2.DATA, h2.FLAG_END_STREAM, 1, bytes(5)))])
    await writer.drain()
    for _ in range(100):
        if any(c.streams for c in gw._server.connections):
            break
        await asyncio.sleep(0.01)
    task = next(iter(next(iter(gw._server.connections)).tasks))
    writer.close()
    await asyncio.wait_for(asyncio.gather(task, return_exceptions=True), 5)
    assert task.cancelled() and not gw._server.connections
    # An idle connection open at stop(): GOAWAY, then closed; no hang.
    reader, writer = await asyncio.open_connection(HOST, gw.port)
    writer.write(h2.PREFACE + h2.frame(h2.SETTINGS, 0, 0))
    await writer.drain()
    await asyncio.sleep(0.05)
    await asyncio.wait_for(stop(gw, stub), 5)
    frames = await read_frames(reader, lambda f: f[0] == h2.GOAWAY)
    assert int.from_bytes(frames[-1][3][4:8], "big") == h2.NO_ERROR
    writer.close()


async def test_a_deadline_that_passes_answers_deadline_exceeded():
    stub = StubRest(delay=0.5)
    gw = await gateway(stub)
    c = await chip_smoke.GrpcClient(HOST, gw.port).connect()
    try:
        r = await c.call("Healthcheck", {}, "Empty", "Empty", timeout_ms=100)
        assert (r.status, r.message) == (4, "Deadline Exceeded")
        assert int(stub.requests[0].headers.get("grpc-timeout")[:-1]) <= 100
        stub.delay = 0
        assert (await c.call("Healthcheck", {}, "Empty", "Empty")).status == 0
    finally:
        await c.close()
        await stop(gw, stub)


async def test_loopback_carries_deadline_cursor_and_errors():
    stub = StubRest()
    gw = await gateway(stub)
    c = await chip_smoke.GrpcClient(HOST, gw.port).connect()
    try:
        cursor = "a+b/c=d e%"
        r = await c.call("ListStorageObjects", {"collection": "saves", "cursor": cursor,
                                                "limit": 3},
                         "ListStorageObjectsRequest", "StorageObjectList",
                         timeout_ms=2500)
        assert r.status == 0 and r.traceparent
        req = stub.requests[-1]
        assert req.path == "/v2/storage/saves"
        assert req.query == {"cursor": cursor, "limit": "3"}
        sent = req.headers.get("grpc-timeout")
        assert sent.endswith("m") and 0 < int(sent[:-1]) <= 2500
        # A REST error body maps to its code; a bare status to its own.
        stub.answer = (401, {"error": "x", "message": "no", "code": 16})
        r = await c.call("Healthcheck", {}, "Empty", "Empty")
        assert (r.status, r.message, len(r.headers)) == (16, "no", 5)
        stub.answer = (405, "not json")
        r = await c.call("Healthcheck", {}, "Empty", "Empty")
        assert (r.status, r.message) == (3, "HTTP 405")
        # Past 4 MiB: RESOURCE_EXHAUSTED, the REST side never called.
        n = len(stub.requests)
        big = {"id": "x", "payload": "p" * (4 << 20)}
        r = await c.call("RpcFunc", big, "Rpc", "Rpc")
        assert r.status == 8 and "larger than max" in r.message
        assert len(stub.requests) == n
    finally:
        await c.close()
        await stop(gw, stub)


# -------------------------------------------------------- schema and codec


def _descriptors():
    out = {}

    def walk(d):
        out[d.full_name] = d
        for nested in d.nested_types:
            walk(nested)

    for file in (P.DESCRIPTOR, struct_pb2.DESCRIPTOR, wrappers_pb2.DESCRIPTOR):
        for d in file.message_types_by_name.values():
            walk(d)
    return out


def test_schema_equals_the_compiled_descriptor_and_service():
    descriptors = _descriptors()
    want = {n for n in descriptors if n.startswith("nakama_tpu.api.")}
    assert {n for n in API.messages if n.startswith("nakama_tpu.api.")} == want
    assert len(MESSAGES) == 78
    for name, msg in API.messages.items():
        d = descriptors[name]
        assert msg.map_entry == d.GetOptions().map_entry, name
        mine = [(f.name, f.number, f.type, f.label, f.type_name, f.is_map,
                 f.oneof) for f in msg.fields]
        theirs = [
            (f.name, f.number, f.type,
             port_schema.LABEL_REPEATED if f.is_repeated
             else port_schema.LABEL_OPTIONAL,
             (f.message_type or f.enum_type).full_name
             if f.message_type or f.enum_type else "",
             bool(f.message_type and f.message_type.GetOptions().map_entry),
             f.containing_oneof.name if f.containing_oneof else "")
            for f in d.fields
        ]
        assert mine == theirs, name
        assert msg.oneofs == {o.name: [f.name for f in o.fields]
                              for o in d.oneofs}, name
    svc = P.DESCRIPTOR.services_by_name["NakamaApi"]
    assert [(m.name, m.input.full_name, m.output.full_name)
            for m in SERVICE.methods.values()] == [
        (m.name, m.input_type.full_name, m.output_type.full_name)
        for m in svc.methods]
    assert len(SERVICE.methods) == 80


class ApiGen(Gen):
    """`test_torch_protocol.Gen` with int64 (as numbers and as strings)
    and the wrappers (bare values, zero one time in three)."""

    def scalar(self, ftype: int):
        if ftype == port_schema.TYPE_INT64:
            n = int(self.pick([0, 1, -1, -(1 << 63), (1 << 63) - 1,
                               int(self.rng.integers(-1 << 40, 1 << 40))]))
            return str(n) if self.rng.random() < 0.5 else n
        return super().scalar(ftype)

    def message(self, msg, depth: int = 0):
        if msg.full_name in port_schema.WRAPPERS:
            ftype = msg.by_name["value"].type
            if self.rng.random() < 0.34:
                return {port_schema.TYPE_STRING: "", port_schema.TYPE_BOOL: False,
                        port_schema.TYPE_BYTES: ""}.get(ftype, 0)
            return self.scalar(ftype)
        return super().message(msg, depth)


def _has_struct(msg, seen=()) -> bool:
    for f in msg.fields:
        if f.type != port_schema.TYPE_MESSAGE or f.type_name in seen:
            continue
        if f.type_name == "google.protobuf.Struct" or _has_struct(
                f.message, seen + (msg.full_name,)):
            return True
    return False


@pytest.mark.parametrize("name", MESSAGES)
def test_seeded_messages_encode_decode_and_parse_as_json_format(name):
    msg = API.messages[name]
    short = name.rsplit(".", 1)[1]
    cls = getattr(P, short)
    gen = ApiGen(seed=MESSAGES.index(name) + 100)
    for n in range(6):
        js = gen.message(msg) if n else {}
        js = {**js, "zz_unknown": {"x": 1}} if n % 2 else js
        want = json_format.ParseDict(js, cls(), ignore_unknown_fields=True)
        wire = want.SerializeToString()
        mine = proto.encode_message(short, js)
        expect = json_format.MessageToDict(want, preserving_proto_field_name=True)
        assert proto.decode_message(short, wire) == expect, (js, wire.hex())
        if _has_struct(msg):
            # A Struct is a map: upb does not write its keys in insertion
            # order. Each side reads the other's bytes to the same dict.
            assert json_format.MessageToDict(
                cls.FromString(mine), preserving_proto_field_name=True) == expect
        else:
            assert mine == wire, (js, mine.hex(), wire.hex())
        # The dict round-trips through the port's codec.
        assert proto.decode_message(short, proto.encode_message(short, expect)) == expect


def test_int64_and_wrappers_on_the_wire():
    for v in (-1, -(1 << 63), (1 << 63) - 1, 1 << 40):
        js = {"leaderboard_id": "b", "score": str(v), "subscore": v}
        wire = proto.encode_message("WriteLeaderboardRecordRequest", js)
        want = json_format.ParseDict(js, P.WriteLeaderboardRecordRequest())
        assert wire == want.SerializeToString()
        if v < 0:
            assert len(wire) == 3 + 2 * 11  # two ten-byte varints
        assert proto.decode_message("WriteLeaderboardRecordRequest", wire)[
            "subscore"] == str(v)
    # A wrapper at zero is present: state 0 filters, no state does not.
    assert proto.decode_message("ListFriendsRequest", proto.encode_message(
        "ListFriendsRequest", {"state": 0})) == {"state": 0}
    assert proto.encode_message("ListFriendsRequest", {"state": 0}) == b"\x12\x00"
    assert proto.decode_message("ListFriendsRequest", b"") == {}
    for bad in ({"score": 1.5}, {"score": str(1 << 63)}, {"score": True}):
        with pytest.raises(proto.EncodeError):
            proto.encode_message("WriteLeaderboardRecordRequest", bad)
        with pytest.raises(json_format.ParseError):
            json_format.ParseDict(bad, P.WriteLeaderboardRecordRequest())


# ------------------------------------------------------------------ routes


def test_routes_equal_the_jax_routes():
    assert list(port_grpc.ROUTES) == list(jax_grpc.ROUTES)
    assert set(port_grpc.ROUTES) == set(SERVICE.methods)
    rng = np.random.default_rng(7)
    for name, spec in port_grpc.ROUTES.items():
        theirs = jax_grpc.ROUTES[name]
        assert (spec.verb, spec.body, spec.path_fields) == (
            theirs.verb, theirs.body, theirs.path_fields), name
        assert spec.request == theirs.request.DESCRIPTOR.name, name
        assert spec.response == theirs.response.DESCRIPTOR.name, name
        assert SERVICE.methods[name].input.full_name == theirs.request.DESCRIPTOR.full_name
        assert callable(spec.path) == callable(theirs.path), name
        assert (spec.transform is None) == (theirs.transform is None), name
        for _ in range(4):
            d = {f: f"id-{int(rng.integers(1000))}" for f in spec.path_fields
                 if rng.random() < 0.8}
            d["account"] = {"id": f"dev-{int(rng.integers(1000))}"}
            if callable(spec.path):
                assert spec.path(dict(d)) == theirs.path(dict(d)), name
            else:
                assert spec.path == theirs.path
            if spec.transform is not None:
                assert spec.transform(dict(d)) == theirs.transform(dict(d))
    assert port_grpc.STATUS == {c.name: c.value[0] for c in grpc.StatusCode}


# ---------------------------------------------------- the shared grpc script


def traceparent_of(metadata) -> str:
    return next((v for k, v in metadata or () if k == "traceparent"), "")


class Rpc:
    """One `grpc.aio` channel to a server's gateway; each call's outcome
    (its answer as a dict, or its status and details, and whether a
    `traceparent` trailer came back) appended to `out`."""

    def __init__(self, port: int, norm: S.Normaliser, out: list):
        self.channel = grpc.aio.insecure_channel(f"{HOST}:{port}")
        self.norm, self.out = norm, out

    async def __call__(self, method, request, response=P.Empty, auth="",
                       metadata=(), serialize=None, **kw):
        fn = self.channel.unary_unary(
            chip_smoke.GRPC_SERVICE + method,
            request_serializer=serialize or (lambda m: m.SerializeToString()),
            response_deserializer=response.FromString)
        meta = (("authorization", auth),) if auth else ()
        call = fn(request, metadata=meta + tuple(metadata), **kw)
        try:
            msg = await call
        except grpc.aio.AioRpcError as e:
            tp = traceparent_of(e.trailing_metadata())
            self.out.append([method, e.code().name, e.details() or "", bool(tp)])
            return None
        tp = traceparent_of(await call.trailing_metadata())
        body = json_format.MessageToDict(msg, preserving_proto_field_name=True)
        self.out.append([method, "OK", body, bool(tp)])
        self.last_traceparent = tp
        return msg

    async def close(self):
        await self.channel.close()


def basic(key="defaultkey") -> str:
    return "Basic " + base64.b64encode(f"{key}:".encode()).decode()


def auth_request(device: str, username: str = "", create=None):
    req = P.AuthenticateRequest(username=username)
    req.account.update({"id": device})
    if create is not None:
        req.create.value = create
    return req


async def grpc_script(server, cursors: list) -> list:
    """The script's normalised answers; each storage cursor it sent is
    appended to `cursors`."""
    norm = S.Normaliser()
    out: list = []
    c = Rpc(server.grpc_port, norm, out)
    try:
        await c("Healthcheck", P.Empty())
        sessions = []
        for i in range(3):
            s = await c("AuthenticateDevice", auth_request(
                f"device-grpc-{i:06d}", f"grpcuser{i}"), P.Session, auth=basic())
            sessions.append(f"Bearer {s.token}")
        users = []
        for i, bearer in enumerate(sessions):
            account = await c("GetAccount", P.Empty(), P.Account, auth=bearer)
            norm.learn(account.user.id, f"user{i}")
            users.append(account.user.id)
        a = sessions[0]
        await c("UpdateAccount", P.UpdateAccountRequest(display_name="G. RPC"),
                auth=a)
        await c("GetAccount", P.Empty(), P.Account, auth=a)
        # Storage: write, read, then list page by page (a cursor that
        # holds `+`, `/` or `=`).
        w = P.WriteStorageObjectsRequest()
        for k in ("slot1", "~~~~a", "???b", "stamped"):
            w.objects.add(collection="saves", key=k, value='{"hp": 10}',
                          permission_read=2, permission_write=1)
        await c("WriteStorageObjects", w, P.StorageObjectAcks, auth=a)
        r = P.ReadStorageObjectsRequest()
        r.object_ids.add(collection="saves", key="slot1")
        r.object_ids.add(collection="saves", key="stamped")
        await c("ReadStorageObjects", r, P.StorageObjects, auth=a)
        cursor, pages = "", 0
        while True:
            page = await c("ListStorageObjects", P.ListStorageObjectsRequest(
                collection="saves", limit=1, cursor=cursor), P.StorageObjectList,
                auth=a)
            cursor = page.cursor
            pages += 1
            if not cursor:
                break
            cursors.append(cursor)
        out.append(["pages", pages])
        # Auth errors.
        await c("AuthenticateDevice", auth_request("device-grpc-x1"), P.Session,
                auth=basic("wrongkey"))
        await c("GetAccount", P.Empty(), P.Account)
        await c("AuthenticateDevice", auth_request("device-grpc-nope", create=False),
                P.Session, auth=basic())
        printable = "".join(map(chr, range(0x20, 0x7F)))
        await c("GetAccount", P.Empty(), P.Account, auth="Bearer " + printable)
        await c("GetAccount", P.Empty(), P.Account, auth=a,
                metadata=(("x-printable", printable),))
        # The runtime's rpcs, friends.
        await c("RpcFunc", P.Rpc(id="py_echo", payload="hello"), P.Rpc, auth=a)
        await c("RpcFunc", P.Rpc(id="lua_echo", payload="x+y/z="), P.Rpc, auth=a)
        await c("RpcFunc", P.Rpc(id="py_raises", payload="no"), P.Rpc, auth=a)
        await c("RpcFunc", P.Rpc(id="nope"), P.Rpc, auth=a)
        await c("AddFriends", P.AddFriendsRequest(usernames=["grpcuser1"]), auth=a)
        await c("ListFriends", P.ListFriendsRequest(limit=10), P.FriendList, auth=a)
        only = P.ListFriendsRequest(limit=10)
        only.state.value = 0
        await c("ListFriends", only, P.FriendList, auth=a)
        only.state.value = 1
        await c("ListFriends", only, P.FriendList, auth=sessions[1])
        # Subscriptions through the store fetcher.
        await c("ValidateSubscriptionApple", P.ValidateSubscriptionRequest(
            receipt=F.apple_receipt(["sub1"]), persist=True),
            P.ValidateSubscriptionResponse, auth=a)
        await c("GetSubscription", P.GetSubscriptionRequest(
            original_transaction_id="orig-sub1"), P.ValidatedSubscription, auth=a)
        await c("ListSubscriptions", P.Empty(), P.SubscriptionList, auth=a)
        # Tournaments, an empty path id.
        await server.tournaments.create(
            "grpc-cup", title="gRPC Cup", category=3, duration=3600,
            join_required=False, authoritative=False)
        await c("ListTournaments", P.ListTournamentsRequest(), P.TournamentList,
                auth=a)
        await c("JoinTournament", P.JoinTournamentRequest(tournament_id="grpc-cup"),
                auth=a)
        await c("WriteTournamentRecord", P.WriteTournamentRecordRequest(
            tournament_id="grpc-cup", score=99), P.LeaderboardRecord, auth=a)
        await c("ListTournamentRecords", P.ListTournamentRecordsRequest(
            tournament_id="grpc-cup"), P.LeaderboardRecordList, auth=a)
        await c("ListTournamentRecordsAroundOwner",
                P.ListTournamentRecordsAroundOwnerRequest(
                    tournament_id="grpc-cup", owner_id=users[0], limit=3),
                P.LeaderboardRecordList, auth=a)
        await c("DeleteTournamentRecord", P.DeleteTournamentRecordRequest(
            tournament_id="grpc-cup"), auth=a)
        await c("JoinTournament", P.JoinTournamentRequest(tournament_id=""), auth=a)
        # Groups with wrapper updates.
        g = await c("CreateGroup", P.CreateGroupRequest(
            name="r4-group", description="before"), P.Group, auth=a)
        norm.learn(g.id, "group0")
        upd = P.UpdateGroupRequest(group_id=g.id)
        upd.description.value = "after"
        upd.open.value = False
        await c("UpdateGroup", upd, auth=a)
        await c("ListGroups", P.ListGroupsRequest(name="r4-group"), P.GroupList,
                auth=a)
        await c("JoinGroup", P.GroupIdRequest(group_id=g.id), auth=sessions[1])
        await c("ListGroupUsers", P.ListGroupUsersRequest(group_id=g.id, limit=10),
                P.GroupUserList, auth=a)
        # A leaderboard and its haystack; int64 scores past 32 bits.
        await server.leaderboards.create("r4-lb", sort_order="desc")
        for i, bearer in enumerate(sessions):
            await c("WriteLeaderboardRecord", P.WriteLeaderboardRecordRequest(
                leaderboard_id="r4-lb", score=(1 << 40) - i, subscore=-i),
                P.LeaderboardRecord, auth=bearer)
        await c("ListLeaderboardRecordsAroundOwner",
                P.ListLeaderboardRecordsAroundOwnerRequest(
                    leaderboard_id="r4-lb", owner_id=users[1], limit=3),
                P.LeaderboardRecordList, auth=sessions[1])
        await c("ListLeaderboardRecords", P.ListLeaderboardRecordsRequest(
            leaderboard_id="r4-lb", limit=2), P.LeaderboardRecordList, auth=a)
        # Channel history, forward and (a wrapper false) backward.
        channel_id = server.channels.channel_id_build("", "r4room", 1)
        for n in range(4):
            await server.channels.message_send(
                channel_id, {"n": n}, sender_id=users[0],
                sender_username="grpcuser0")
        hist = await c("ListChannelMessages", P.ListChannelMessagesRequest(
            channel_id=channel_id, limit=10), P.ChannelMessageList, auth=a)
        for k, m in enumerate(hist.messages):
            norm.learn(m.message_id, f"msg{k}")
        req = P.ListChannelMessagesRequest(channel_id=channel_id, limit=2)
        req.forward.value = False
        await c("ListChannelMessages", req, P.ChannelMessageList, auth=a)
        # The wire's own cases: an unknown method, bytes that do not
        # decode, a gzip request, a deadline, the client's traceparent.
        await c("NoSuchRpc", P.Empty(), auth=a)
        await c("GetAccount", b"\xff\xff\xff", P.Account, auth=a,
                serialize=lambda b: b)
        await c("AuthenticateDevice", auth_request("device-grpc-gz"), P.Session,
                auth=basic(), compression=grpc.Compression.Gzip)
        await c("GetAccount", P.Empty(), P.Account, auth=a, timeout=10)
        tid = "4bf92f3577b34da6a3ce929d0e0e4736"
        await c("GetAccount", P.Empty(), P.Account, auth=a,
                metadata=(("traceparent", f"00-{tid}-00f067aa0ba902b7-01"),))
        out.append(["trace continued", c.last_traceparent.split("-")[1] == tid])
        await c("DeleteAccount", P.Empty(), auth=sessions[2])
        await c("GetAccount", P.Empty(), P.Account, auth=sessions[2])
    finally:
        await c.close()
    # Normalised once every id is known.
    return [[a[0], a[1], clock(norm(a[2])) if a[1] == "OK" else norm.text(a[2]),
             a[3]] if len(a) == 4 else a for a in out]


def clock(obj):
    """Times read from the clock (a tournament's start and ends) masked;
    the stores' own times (1.7e9, 4e9) kept."""
    if isinstance(obj, dict):
        return {k: clock(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [clock(v) for v in obj]
    if isinstance(obj, float) and 1.75e9 < obj < 2.5e9:
        return "<clock>"
    return obj


async def test_one_grpc_script_same_answers_on_both_servers(tmp_path):
    answers, cursors = {}, {}
    seen: list = []
    for key, make in (("jax", S.jax_server), ("torch", S.torch_server)):
        server = await make(tmp_path / key, S.runtime_dir(tmp_path / f"rt-{key}"))
        if key == "torch":
            middleware = server.api._overload_middleware

            async def recording(request, handler):
                seen.append((request.target, dict(request.headers)))
                return await middleware(request, handler)

            server.api._overload_middleware = recording
        try:
            answers[key] = await grpc_script(server, cursors.setdefault(key, []))
        finally:
            await server.stop()
    jax_answers, port_answers = answers["jax"], answers["torch"]
    assert len(jax_answers) == len(port_answers)
    for mine, theirs in zip(port_answers, jax_answers):
        if mine[0] == "GetAccount" and mine[1] == "UNKNOWN":
            # Bytes that do not decode: grpc.aio names its exception's
            # class in the details; the port gives the parse error alone.
            assert theirs[:2] == mine[:2] and theirs[3] == mine[3]
            assert theirs[2].endswith(mine[2]), (mine, theirs)
            continue
        assert mine == theirs
    statuses = {a[1] for a in port_answers if len(a) == 4}
    assert {"OK", "UNAUTHENTICATED", "NOT_FOUND", "UNIMPLEMENTED", "UNKNOWN",
            "INTERNAL"} <= statuses, statuses
    # A traceparent trailer on every answer the REST layer traced: all
    # but the health check (outside the traced middleware, as in the
    # JAX server) and the two the gateway answers itself.
    missing = [a[:2] for a in port_answers if len(a) == 4 and not a[3]]
    assert missing == [["Healthcheck", "OK"], ["NoSuchRpc", "UNIMPLEMENTED"],
                       ["GetAccount", "UNKNOWN"]], missing
    # The port's loopback: the client's 10 s deadline as the time left
    # (grpcio's own header rounds 10 s up by as much as 1%: the raw
    # client's exact header is checked in
    # `test_loopback_carries_deadline_cursor_and_errors`).
    timeouts = [h["grpc-timeout"] for _, h in seen if "grpc-timeout" in h]
    assert len(timeouts) == 1 and timeouts[0].endswith("m")
    assert 0 < int(timeouts[0][:-1]) <= 10_100
    # Every cursor reached the REST handler intact, `+/=` included.
    sent = cursors["torch"]
    assert len(sent) == 3 and any(set("+/=") & set(c) for c in sent), sent
    got = [urllib.parse.parse_qs(urllib.parse.urlsplit(t).query).get("cursor")
           for t, _ in seen]
    assert [c[0] for c in got if c] == sent


# ------------------------------------------------------- config, lifecycle


def _free_pair() -> int:
    """A port p with p and p - 1 free."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind((HOST, 0))
            p = s.getsockname()[1]
        try:
            with socket.socket() as a, socket.socket() as b:
                a.bind((HOST, p))
                b.bind((HOST, p - 1))
            return p
        except OSError:
            continue
    raise AssertionError("no free pair of ports")


@pytest.mark.parametrize("grpc_port", [0, -1, "main-1"])
async def test_grpc_port_zero_and_minus_one(tmp_path, grpc_port):
    flags = S.FLAGS + ["--data_dir", str(tmp_path)]
    if grpc_port == "main-1":
        main = _free_pair()
        flags += ["--socket.port", str(main), "--console.port", "0",
                  "--socket.grpc_port", "0"]
    else:
        flags += ["--socket.grpc_port", str(grpc_port)]
    from nakama_tpu_torch.matchmaker.cuda import CudaBackend
    from nakama_tpu_torch.server import NakamaServer

    cfg = port_config.parse_args(flags)
    log = port_logger()
    server = NakamaServer(cfg, log, matchmaker_backend=CudaBackend(
        cfg.matchmaker, log, device="cpu"))
    await server.start()
    try:
        if grpc_port == -1:
            assert server.grpc is None and server.grpc_port is None
        else:
            want = server.port - 1 if grpc_port == "main-1" else None
            assert server.grpc_port and server.grpc_port != server.port
            assert want is None or server.grpc_port == want
            c = await chip_smoke.GrpcClient(HOST, server.grpc_port).connect()
            assert (await c.call("Healthcheck", {}, "Empty", "Empty")).status == 0
            await c.close()
    finally:
        await server.stop()
    assert server.grpc is None


async def test_a_failed_bind_raises_oserror():
    with socket.socket() as taken:
        taken.bind((HOST, 0))
        taken.listen()
        gw = port_grpc.GrpcGateway(port_logger(), HOST, 1)
        with pytest.raises(OSError, match="failed to bind"):
            await gw.start(HOST, taken.getsockname()[1])
        assert gw.port is None


def test_the_loopback_pool_survives_a_closed_loop():
    """A server stopped on a later event loop (as `chip_smoke.py`'s
    phases run, one `asyncio.run` each) closes its loopback pool while
    an earlier, closed loop's pool still holds idle connections."""
    from nakama_tpu_torch.utils import httpfetch

    async def serve_and_fetch():
        stub = StubRest()
        port = await stub.http.start(HOST, 0)
        status, _ = await httpfetch.fetch(f"http://{HOST}:{port}/x")
        assert status == 200
        await stub.http.stop()
        return port

    port = asyncio.run(serve_and_fetch())  # leaves an idle connection

    async def later():
        return httpfetch.close_idle("http", HOST, port)

    assert asyncio.run(later()) == 0


def test_percent_encoding_and_timeouts():
    assert port_grpc.percent_encode("a b%c\né") == "a b%25c%0A%C3%A9"
    assert port_grpc.parse_timeout("250m") == 0.25
    assert port_grpc.parse_timeout("3S") == 3.0
    assert port_grpc.parse_timeout("123456789m") is None  # 9 digits
    assert port_grpc.parse_timeout("5x") is None


GROUP = proto.encode_message("GroupIdRequest", {"group_id": "g+1"})


@pytest.mark.parametrize("encoding,message,want", [
    ("gzip", zlib.compress(GROUP, wbits=16 + zlib.MAX_WBITS), "0"),
    ("deflate", zlib.compress(GROUP), "0"),
    ("snappy", GROUP, "12"),
    ("gzip", b"not gzip", "13"),
    ("deflate", zlib.compress(b"\x00" * ((4 << 20) + 1)), "8"),
], ids=["gzip", "deflate", "unsupported", "corrupt", "too-large"])
async def test_compressed_requests(encoding, message, want):
    stub = StubRest()
    gw = await gateway(stub)
    try:
        reader, writer = await asyncio.open_connection(HOST, gw.port)
        writer.write(request_bytes("JoinGroup", message, encoding=encoding))
        got = await read_answer(reader)
        assert got["blocks"][-1]["grpc-status"] == want
        if want == "0":
            assert stub.requests[0].path == "/v2/group/g+1/join"
        writer.close()
    finally:
        await stop(gw, stub)

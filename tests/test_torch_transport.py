"""The port's standard-library transport (`nakama_tpu_torch/api/wsproto.py`)
held against the libraries the JAX package serves and tests with: the
port's server against the `websockets` client (fragmented text,
interleaved pings, keepalive, 1009 above the size limit, the acceptor's
4000 for an unknown format, 4001 and the shutdown's 1012), its HTTP side
against raw sockets (keep-alive, 413, a refused handshake), the port's
client against the JAX `ApiServer` (`aiohttp`), and one script of a
`format=protobuf` client and a JSON client matched together and
relaying match data both ways, on the port's server and on the JAX
server, with the same answers once ids are normalised."""

import asyncio
import base64
import json
import re
import time

import pytest
import websockets

from fixtures import quiet_logger

from nakama_tpu import config as jax_config
from nakama_tpu.config import Config as JaxConfig
from nakama_tpu.server import NakamaServer as JaxServer
from nakama_tpu_torch.api import protocol, wsproto
from nakama_tpu_torch.config import parse_args
from nakama_tpu_torch.logger import test_logger as port_logger
from nakama_tpu_torch.server import NakamaServer

HOST = "127.0.0.1"


def basic(key="defaultkey"):
    return {
        "Authorization": "Basic " + base64.b64encode(f"{key}:".encode()).decode()
    }


async def port_server(data_dir):
    cfg = parse_args(
        ["--socket.port", "0", "--matchmaker.backend", "cpu",
         "--data_dir", str(data_dir),
         "--matchmaker.interval_sec", "100",
         "--matchmaker.pool_capacity", "2048"]
    )
    server = NakamaServer(cfg, port_logger())
    await server.start()
    return server


async def token_for(port, device_id="device-transport-1"):
    r = await wsproto.request(
        HOST, port, "POST", "/v2/account/authenticate/device",
        headers=basic(), body={"account": {"id": device_id}},
    )
    assert r.status == 200, r.body
    return r.json()["token"]


async def recv_key(ws, key, timeout=5.0):
    """The next envelope carrying `key` (others are skipped)."""
    async def loop():
        while True:
            env = json.loads(await ws.recv())
            if key in env:
                return env
    return await asyncio.wait_for(loop(), timeout)


async def send_fragments(ws, parts: list[str]) -> None:
    """One text message sent as several masked frames, as a client that
    fragments does."""
    for i, part in enumerate(parts):
        ws._writer.write(wsproto.encode_frame(
            wsproto.OP_TEXT if i == 0 else wsproto.OP_CONT, part.encode(),
            mask=True, fin=i == len(parts) - 1,
        ))
    await ws._writer.drain()


# ------------------------------------------------ the port's server side


async def echo_server(max_message_size=64, **ws_kw):
    async def handler(request):
        if request.path != "/ws":
            return wsproto.json_response({"n": len(request.body)})
        ws = await request.accept_websocket(
            max_message_size=max_message_size, **ws_kw
        )
        async for message in ws:
            await ws.send(message)
        return None

    srv = wsproto.HttpServer(handler, max_request_size=100, idle_timeout_s=5)
    return srv, await srv.start(HOST, 0)


async def test_websockets_client_fragments_pings_and_1009():
    srv, port = await echo_server(max_message_size=64)
    try:
        async with websockets.connect(f"ws://{HOST}:{port}/ws") as ws:
            # A fragmented text message (a multi-byte character split
            # across fragments) comes back whole.
            await ws.send(["ab", "cd", "é€"])
            assert await ws.recv() == "abcdé€"
            # Our ping between messages is answered.
            pong = await ws.ping(b"x")
            await asyncio.wait_for(pong, 5)
            await ws.send(b"\x00\x01")
            assert await ws.recv() == b"\x00\x01"
            # One message over the limit closes with 1009.
            await ws.send("y" * 65)
            try:
                await asyncio.wait_for(ws.recv(), 5)
                raise AssertionError("oversized message was accepted")
            except websockets.ConnectionClosed as e:
                assert e.rcvd is not None and e.rcvd.code == 1009
        # Fragments whose sum passes the limit close with 1009 too.
        async with websockets.connect(f"ws://{HOST}:{port}/ws") as ws:
            await ws.send(["z" * 40, "z" * 40])
            try:
                await asyncio.wait_for(ws.recv(), 5)
                raise AssertionError("oversized fragmented message accepted")
            except websockets.ConnectionClosed as e:
                assert e.rcvd is not None and e.rcvd.code == 1009
    finally:
        await srv.stop()
        await srv.wait_closed()


async def test_control_frames_between_fragments_and_protocol_errors():
    srv, port = await echo_server(max_message_size=1024)
    try:
        reader, writer = await asyncio.open_connection(HOST, port)
        key = base64.b64encode(b"0123456789abcdef").decode()
        writer.write(
            (
                "GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        head = await reader.readuntil(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 101")
        assert wsproto.accept_key(key).encode() in head
        enc = wsproto.encode_frame
        # text fragment, ping, continuation (final): the pong comes
        # first, then the whole message.
        writer.write(enc(wsproto.OP_TEXT, b"he", mask=True, fin=False))
        writer.write(enc(wsproto.OP_PING, b"p", mask=True))
        writer.write(enc(wsproto.OP_CONT, b"llo", mask=True))
        await writer.drain()
        first = await reader.readexactly(3)
        assert first == bytes([0x80 | wsproto.OP_PONG, 1]) + b"p"
        second = await reader.readexactly(7)
        assert second == bytes([0x80 | wsproto.OP_TEXT, 5]) + b"hello"
        # An unmasked client frame is a protocol error: close 1002.
        writer.write(enc(wsproto.OP_TEXT, b"bad", mask=False))
        await writer.drain()
        frame = await reader.readexactly(4)
        assert frame[0] == 0x80 | wsproto.OP_CLOSE
        assert int.from_bytes(frame[2:4], "big") == 1002
        writer.close()
        # Invalid UTF-8 in a text message: close 1007.
        reader, writer = await asyncio.open_connection(HOST, port)
        writer.write(
            (
                "GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        await reader.readuntil(b"\r\n\r\n")
        writer.write(enc(wsproto.OP_TEXT, b"\xff\xfe", mask=True))
        await writer.drain()
        frame = await reader.readexactly(4)
        assert frame[0] == 0x80 | wsproto.OP_CLOSE
        assert int.from_bytes(frame[2:4], "big") == 1007
        writer.close()
    finally:
        await srv.stop()
        await srv.wait_closed()


async def test_http_keep_alive_413_and_refused_upgrade():
    srv, port = await echo_server()
    try:
        reader, writer = await asyncio.open_connection(HOST, port)
        for body in (b"abc", b"defgh"):
            writer.write(
                b"POST /x HTTP/1.1\r\nHost: x\r\nContent-Length: "
                + str(len(body)).encode() + b"\r\n\r\n" + body
            )
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            assert head.startswith(b"HTTP/1.1 200")
            length = int(
                [h for h in head.split(b"\r\n") if h.lower().startswith(b"content-length")][0]
                .split(b":")[1]
            )
            assert json.loads(await reader.readexactly(length)) == {"n": len(body)}
        writer.close()
        big = await wsproto.request(HOST, port, "POST", "/x", body=b"x" * 101)
        assert big.status == 413
        assert big.json()["message"] == "request body too large"
        refused = await wsproto.request(HOST, port, "GET", "/ws")
        assert refused.status == 400
    finally:
        await srv.stop()
        await srv.wait_closed()


async def test_an_oversized_body_is_answered_unread_and_closes():
    """With `oversize_to_handler`, a request whose declared body is above
    the limit reaches the handler at once, unread and marked
    `body_too_large`; the answer closes the connection. A peer that
    never sends the body still gets its answer, and the server drops the
    connection after `idle_timeout_s`; a peer that sends far more than
    the discard cap is cut off after the cap."""
    seen = []

    async def handler(request):
        seen.append((request.body_too_large, request.body))
        return wsproto.json_response({"too_large": request.body_too_large})

    srv = wsproto.HttpServer(
        handler, max_request_size=100, idle_timeout_s=0.5,
        oversize_to_handler=True,
    )
    port = await srv.start(HOST, 0)

    async def answer(reader):
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 2)
        assert head.startswith(b"HTTP/1.1 200")
        assert b"connection: close" in head.lower()
        length = int([h for h in head.split(b"\r\n")
                      if h.lower().startswith(b"content-length")][0].split(b":")[1])
        return json.loads(await reader.readexactly(length))

    try:
        # Declares 10 MB and sends nothing of it.
        reader, writer = await asyncio.open_connection(HOST, port)
        writer.write(b"POST /x HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: 10000000\r\n\r\n")
        await writer.drain()
        assert await answer(reader) == {"too_large": True}
        t0 = time.perf_counter()
        assert await asyncio.wait_for(reader.read(), 5) == b""
        assert time.perf_counter() - t0 < 3
        writer.close()
        # Sends its declared 10 MB: cut off after the discard cap.
        reader, writer = await asyncio.open_connection(HOST, port)
        writer.write(b"POST /x HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: 10000000\r\n\r\n")
        sent = 0
        try:
            while sent < 10_000_000:
                writer.write(b"x" * 65_536)
                await asyncio.wait_for(writer.drain(), 5)
                sent += 65_536
        except (ConnectionError, asyncio.TimeoutError):
            pass
        assert sent < 10_000_000
        writer.close()
        # Under the limit: read, handed on, kept alive.
        ok = await wsproto.request(HOST, port, "POST", "/x", body=b"x" * 100)
        assert ok.json() == {"too_large": False}
        assert seen == [(True, b""), (True, b""), (False, b"x" * 100)]
    finally:
        await srv.stop()
        await srv.wait_closed()


async def test_keepalive_pings_and_silent_peer_is_dropped():
    srv, port = await echo_server(ping_period_s=0.1, pong_wait_s=1.0)
    try:
        async with websockets.connect(
            f"ws://{HOST}:{port}/ws", ping_interval=None
        ) as ws:
            # The library answers the server's pings: still open after
            # more than one pong window.
            await asyncio.sleep(1.5)
            await ws.send("alive")
            assert await ws.recv() == "alive"
        # A raw peer that never answers is dropped after pong_wait.
        reader, writer = await asyncio.open_connection(HOST, port)
        key = base64.b64encode(b"fedcba9876543210").decode()
        writer.write(
            (
                "GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        await reader.readuntil(b"\r\n\r\n")
        got = await asyncio.wait_for(reader.read(), 5)  # pings, then EOF
        assert got and got[0] == 0x80 | wsproto.OP_PING
        writer.close()
    finally:
        await srv.stop()
        await srv.wait_closed()


async def test_acceptor_close_codes_4000_4001_and_shutdown_1012(tmp_path):
    server = await port_server(tmp_path)
    port = server.port
    try:
        token = await token_for(port)
        async with websockets.connect(
            f"ws://{HOST}:{port}/ws?token={token}&format=xml"
        ) as ws:
            with pytest.raises(websockets.ConnectionClosed) as e:
                await asyncio.wait_for(ws.recv(), 5)
            assert (e.value.rcvd.code, e.value.rcvd.reason) == (
                4000, "unsupported format")
        async with websockets.connect(f"ws://{HOST}:{port}/ws?token=bad") as ws:
            with pytest.raises(websockets.ConnectionClosed) as e:
                await asyncio.wait_for(ws.recv(), 5)
            assert (e.value.rcvd.code, e.value.rcvd.reason) == (
                4001, "invalid token")
        ws = await websockets.connect(f"ws://{HOST}:{port}/ws?token={token}")
        await ws.send(json.dumps({"cid": "1", "ping": {}}))
        assert (await recv_key(ws, "pong"))["cid"] == "1"
        await ws.send(["{\"cid\": \"2\", ", "\"ping\": {}}"])
        assert (await recv_key(ws, "pong"))["cid"] == "2"
    finally:
        await server.stop()
    # The stop's structured close: the Retry-After notification, then 1012.
    note = await recv_key(ws, "notifications")
    assert note["notifications"]["notifications"][0]["subject"] == "server_restart"
    try:
        await asyncio.wait_for(ws.recv(), 5)
        raise AssertionError("socket still open after stop")
    except websockets.ConnectionClosed as e:
        assert (e.rcvd.code, e.rcvd.reason) == (1012, "server shutting down")


async def test_a_protobuf_client_gets_the_restart_notification_then_1012(
        tmp_path):
    """The stop's `server_restart` notification reaches a `format=protobuf`
    socket (its content an object: rtapi's Notification.content is a
    Struct), then the 1012 close; a JSON socket's content stays the JSON
    string of the same object."""
    server = await port_server(tmp_path)
    port = server.port
    sockets = {}
    try:
        for fmt in ("protobuf", "json"):
            token = await token_for(port, f"device-restart-{fmt}")
            ws = await wsproto.connect(HOST, port, f"/ws?token={token}&format={fmt}")
            await ws.send(protocol.encode({"cid": "p", "ping": {}}, fmt))
            while "pong" not in protocol.decode(await ws.recv(), fmt):
                pass
            sockets[fmt] = ws
    finally:
        await server.stop()
    notes = {}
    for fmt, ws in sockets.items():
        while fmt not in notes:
            raw = await asyncio.wait_for(ws.recv(), 5)
            assert isinstance(raw, bytes if fmt == "protobuf" else str)
            env = protocol.decode(raw, fmt)
            if "notifications" in env:
                notes[fmt] = env["notifications"]["notifications"][0]
        with pytest.raises(wsproto.ConnectionClosed) as e:
            await asyncio.wait_for(ws.recv(), 5)
        assert e.value.code == 1012
    pb, js = notes["protobuf"], notes["json"]
    assert pb["subject"] == js["subject"] == "server_restart"
    assert pb["code"] == js["code"] == -2
    assert isinstance(js["content"], str)
    assert pb["content"] == json.loads(js["content"])
    assert pb["content"]["reason"] == "server shutting down"


# ---------------------------------------- the port's client, JAX server


async def test_port_client_against_the_jax_api_server(tmp_path):
    config = JaxConfig()
    config.data_dir = str(tmp_path)
    config.socket.port = 0
    config.matchmaker.backend = "cpu"
    config.matchmaker.interval_sec = 100
    server = JaxServer(config, quiet_logger())
    await server.start()
    try:
        r = await wsproto.request(
            HOST, server.port, "POST",
            "/v2/account/authenticate/device?username=jaxclient",
            headers=basic(), body={"account": {"id": "device-jax-client"}},
        )
        assert r.status == 200 and r.json()["created"] is True
        token = r.json()["token"]
        bad = await wsproto.request(
            HOST, server.port, "POST", "/v2/account/authenticate/device",
            headers=basic("wrong"), body={"account": {"id": "device-jax-client"}},
        )
        assert bad.status == 401 and bad.json()["code"] == 16
        ws = await wsproto.connect(HOST, server.port, f"/ws?token={token}")
        await ws.send(json.dumps({"cid": "a", "ping": {}}))
        assert (await recv_key(ws, "pong"))["cid"] == "a"
        # aiohttp reassembles the port client's fragments.
        await send_fragments(ws, ['{"cid": "b",', ' "ping": {}}'])
        assert (await recv_key(ws, "pong"))["cid"] == "b"
        await ws.send(json.dumps({
            "cid": "c",
            "matchmaker_add": {"min_count": 2, "max_count": 2, "query": "*"},
        }))
        ticket = (await recv_key(ws, "matchmaker_ticket"))["matchmaker_ticket"]
        assert ticket["ticket"]
        await ws.close()
        assert ws.close_code == 1000
        await asyncio.sleep(0.05)
        assert len(server.matchmaker) == 0  # the session's ticket left
        ws = await wsproto.connect(HOST, server.port, "/ws?token=nope")
        try:
            await asyncio.wait_for(ws.recv(), 5)
            raise AssertionError("bad token accepted")
        except wsproto.ConnectionClosed as e:
            assert e.code == 4001
    finally:
        await server.stop()


# ------------------------------ format=protobuf beside format=json


MIXED_FLAGS = ["--socket.port", "0", "--matchmaker.backend", "cpu",
               "--matchmaker.interval_sec", "100",
               "--matchmaker.interval_pipelining", "false",
               "--matchmaker.pool_capacity", "2048"]
_ID = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}(\.[\w-]+)?")


class Ids:
    """Random ids named by first appearance; tokens masked."""

    def __init__(self):
        self.names: dict[str, str] = {}

    def __call__(self, obj):
        if isinstance(obj, dict):
            return {k: "<token>" if k == "token" else self(v)
                    for k, v in obj.items()}
        if isinstance(obj, list):
            return [self(v) for v in obj]
        if isinstance(obj, str):
            return _ID.sub(
                lambda m: self.names.setdefault(
                    m.group(0), f"<id{len(self.names)}>"), obj)
        return obj


class Client:
    """One player socket in `fmt`, every envelope kept in arrival order;
    a protobuf socket must send binary frames only."""

    def __init__(self, ws, fmt: str):
        self.ws, self.fmt, self.seen = ws, fmt, []

    async def send(self, env: dict):
        await self.ws.send(protocol.encode(env, self.fmt))

    async def take(self, key: str, timeout: float = 5.0) -> dict:
        async def loop():
            while True:
                raw = await self.ws.recv()
                if self.fmt == "protobuf":
                    assert isinstance(raw, bytes), raw
                env = protocol.decode(raw, self.fmt)
                self.seen.append(env)
                if key in env:
                    return env
        return await asyncio.wait_for(loop(), timeout)


def _by_user(env: dict) -> dict:
    """A matched envelope's users in username order."""
    body = env.get("matchmaker_matched")
    if body is not None:
        body["users"] = sorted(
            body["users"], key=lambda u: u["presence"]["username"])
    return env


async def mixed_script(server) -> dict:
    port = server.port
    raw = bytes(range(250, 256)) + "é".encode()  # not UTF-8 text
    clients = {}
    for name, fmt in (("pb", "protobuf"), ("js", "json")):
        r = await wsproto.request(
            HOST, port, "POST", f"/v2/account/authenticate/device?username={name}",
            headers=basic(), body={"account": {"id": f"device-mixed-{name}"}})
        token = r.json()["token"]
        ws = await wsproto.connect(HOST, port, f"/ws?token={token}&format={fmt}")
        clients[name] = Client(ws, fmt)
    pb, js = clients["pb"], clients["js"]
    add = {"cid": "mm", "matchmaker_add": {
        "min_count": 2, "max_count": 2, "query": "+properties.mode:duel",
        "string_properties": {"mode": "duel"},
        "numeric_properties": {"rank": -3.5}}}
    for c in (pb, js):
        await c.send(add)
        await c.take("matchmaker_ticket")
    server.matchmaker.process()
    matched = {n: _by_user(await c.take("matchmaker_matched"))
               for n, c in clients.items()}
    assert (matched["pb"]["matchmaker_matched"]["token"]
            == matched["js"]["matchmaker_matched"]["token"])
    token = matched["pb"]["matchmaker_matched"]["token"]
    for c in (pb, js):
        await c.send({"cid": "join", "match_join": {"token": token}})
        await c.take("match")
    mid = pb.seen[-1]["match"]["match_id"]
    # Relay both ways: the raw bytes arrive byte for byte.
    await pb.send({"match_data_send": {
        "match_id": mid, "op_code": 7, "data": base64.b64encode(raw).decode()}})
    got_js = await js.take("match_data")
    assert base64.b64decode(got_js["match_data"]["data"]) == raw
    await js.send({"match_data_send": {
        "match_id": mid, "op_code": 8,
        "data": base64.urlsafe_b64encode(raw[::-1]).decode().rstrip("=")}})
    got_pb = await pb.take("match_data")
    assert base64.b64decode(got_pb["match_data"]["data"]) == raw[::-1]
    # A payload that is not base64 is refused in the pipeline; the
    # protobuf recipient's socket lives on.
    await js.send({"cid": "bad", "match_data_send": {
        "match_id": mid, "op_code": 9, "data": "!!"}})
    await js.take("error")
    await pb.send({"cid": "alive", "ping": {}})
    await pb.take("pong")
    # A text frame on the protobuf socket is read as its bytes (this
    # envelope's bytes are all ASCII).
    await pb.ws.send(protocol.encode(
        {"cid": "txt", "matchmaker_remove": {"ticket": "nope"}},
        "protobuf").decode())
    await pb.take("error")
    for c in (pb, js):
        await c.ws.close()
    ids = Ids()
    return {n: ids([_by_user(e) for e in c.seen]) for n, c in clients.items()}


async def test_protobuf_and_json_clients_match_and_relay_as_on_the_jax_server(
        tmp_path):
    cfg = parse_args(MIXED_FLAGS + ["--data_dir", str(tmp_path / "port")])
    server = NakamaServer(cfg, port_logger())
    await server.start()
    try:
        port_seen = await mixed_script(server)
    finally:
        await server.stop()
    jcfg = jax_config.parse_args(MIXED_FLAGS + ["--data_dir", str(tmp_path / "jax")])
    jserver = JaxServer(jcfg, quiet_logger())
    await jserver.start()
    try:
        jax_seen = await mixed_script(jserver)
    finally:
        await jserver.stop()
    assert port_seen == jax_seen
    assert [next(k for k in e if k != "cid") for e in port_seen["pb"]] == [
        "stream_presence_event", "matchmaker_ticket", "matchmaker_matched",
        "match", "match_presence_event", "match_presence_event",
        "match_data", "pong", "error"]

"""The port's server (`nakama_tpu_torch/server.py` over `api/`,
`realtime/`, `core/`) held against the JAX package's
`NakamaServer`: both run the same seeded script — HTTP auth (device,
email, custom), refresh and logout, health, socket pings, matchmaker
adds and removes, malformed envelopes, status follows, one interval
driven by hand — and must give the same HTTP bodies, the same envelopes
once random ids are normalised away, identical matched groups by device
id and match-token claims identical apart from ids and expiry. The port
runs `CudaBackend(device="cpu")` (the kernels' plain versions), the JAX
server its host oracle; the tickets come in unique pairs plus a few
that fit no one, so the groups do not depend on arrival order or the
backend. Then the rest of `core/` over REST and the socket (accounts,
links, storage, friends and their notifications, groups, chat channels
and their history, an account delete before a board listing), then
the runtime: both servers load the same directory of Python, Lua and JS
modules (`RT_MODULES`, each server its own copy) and must give the same
answers to rpcs over the socket and over HTTP (by session and by
`http_key`, POST and GET), to before-hooks that change or reject
realtime messages and requests, to `/v2/event`, and to a
`matchmaker_matched` hook that sends a pair into a JS match that echoes
their data; the modules' own counts (events, session events, after
hooks, the shutdown hook) must agree after the stop. Then the 27
social and IAP routes, each server with its package's
`StubSocialClient` and one store fetcher (`provider_fakes`): social
sign-in, link and unlink for the six providers, the friend imports,
purchases and subscriptions of the three stores. With no runtime
loaded, `rpc` answers as the JAX server's. Also: parsed
`/metrics` scrapes, `Config.check()` and
`parse_args`, and `python -m nakama_tpu_torch` in a subprocess (JAX
never imported, also after it loads the modules and serves an rpc;
SIGTERM exits 0; a restart recovers the unmatched tickets).

Stated tolerance: none — every compared value must be equal."""

import asyncio
import base64
import importlib
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.parse

import numpy as np
import pytest

import provider_fakes as F
from fixtures import quiet_logger
from test_torch_metrics import parse

from nakama_tpu import config as jax_config
from nakama_tpu.api import session_token as jax_token
from nakama_tpu.server import NakamaServer as JaxServer
from nakama_tpu_torch import config as port_config
from nakama_tpu_torch.api import session_token as port_token
from nakama_tpu_torch.api import wsproto
from nakama_tpu_torch.logger import test_logger as port_logger
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from nakama_tpu_torch.server import NakamaServer

HOST = "127.0.0.1"
SOCIAL = ("apple", "facebook", "facebookinstantgame", "gamecenter", "google",
          "steam")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = [
    "--socket.port", "0", "--metrics.prometheus_port", "-1",
    "--matchmaker.interval_sec", "100",
    "--matchmaker.interval_pipelining", "false",
    "--matchmaker.pool_capacity", "2048",
    "--matchmaker.candidates_per_ticket", "8",
    "--matchmaker.numeric_fields", "8", "--matchmaker.string_fields", "8",
    "--matchmaker.big_pool_threshold", "64",
]


def basic(key="defaultkey"):
    return {
        "Authorization": "Basic " + base64.b64encode(f"{key}:".encode()).decode()
    }


def bearer(token):
    return {"Authorization": f"Bearer {token}"}


def runtime_flags(runtime_dir) -> list:
    return [] if runtime_dir is None else ["--runtime.path", str(runtime_dir)]


def with_providers(server, key: str):
    """The social and IAP sections the fakes answer to, the package's
    `StubSocialClient` and the stores' fetcher (no request leaves the
    process; the refund scheduler stays off: no package name)."""
    F.configure(server.config)
    server.config.iap.google_package_name = ""
    server.social = F.stub_social(importlib.import_module(
        ("nakama_tpu" if key == "jax" else "nakama_tpu_torch") + ".social.client"))
    server.purchases._fetch = F.store_fetch()
    server.google_refund_scheduler._fetch = F.store_fetch()
    return server


async def jax_server(data_dir, runtime_dir=None):
    cfg = jax_config.parse_args(
        FLAGS + ["--matchmaker.backend", "cpu", "--data_dir", str(data_dir)]
        + runtime_flags(runtime_dir))
    server = with_providers(JaxServer(cfg, quiet_logger()), "jax")
    await server.start()
    return server


async def torch_server(data_dir, runtime_dir=None):
    cfg = port_config.parse_args(
        FLAGS + ["--data_dir", str(data_dir)] + runtime_flags(runtime_dir))
    log = port_logger()
    backend = CudaBackend(
        cfg.matchmaker, log, device="cpu", row_block=8, col_block=64,
        big_row_block=8, big_col_block=64,
    )
    server = with_providers(
        NakamaServer(cfg, log, matchmaker_backend=backend), "torch")
    await server.start()
    return server


def ticket_plan(seed: int, n_pairs: int, n_single: int):
    """(device id, properties, query) per client: unique pairs (each pair
    shares a mode and a rank window only its partner meets) and singles
    that fit no one."""
    rng = np.random.default_rng(seed)
    plan = []
    for p in range(n_pairs):
        rank = float(rng.integers(0, 1000))
        for side in range(2):
            plan.append((
                f"device-pair-{p}-{side}",
                {"string_properties": {"mode": f"p{p}"},
                 "numeric_properties": {"rank": rank + side}},
                f"+properties.mode:p{p} +properties.rank:>={rank - 5}"
                f" +properties.rank:<={rank + 5}",
            ))
    for s in range(n_single):
        plan.append((
            f"device-single-{s}",
            {"string_properties": {"mode": f"s{s}"},
             "numeric_properties": {"rank": 0.0}},
            f"+properties.mode:nobody{s}",
        ))
    order = rng.permutation(len(plan))
    return [plan[i] for i in order]


CURSOR_KEYS = ("cursor", "cacheable_cursor", "next_cursor", "prev_cursor")


class Normaliser:
    """Replaces a server's random ids with stable names."""

    def __init__(self):
        self.names: dict[str, str] = {}

    def learn(self, value: str, name: str):
        self.names[value] = name

    def text(self, value: str) -> str:
        """`value` with every known id inside it replaced, the longest
        first (a channel id holds user ids)."""
        for raw in sorted(self.names, key=len, reverse=True):
            value = value.replace(raw, self.names[raw])
        return value

    def cursor(self, value: str):
        """A history cursor (`<time>|<id>`) with its time and id
        normalised, a storage cursor (base64 JSON of the last key and
        owner) decoded with its owner normalised; any other as it is."""
        if "|" in value:
            tail = value.split("|", 1)[1]
            return "<time>|" + self.names.get(tail, tail)
        try:
            decoded = json.loads(base64.b64decode(value, validate=True))
        except ValueError:
            return value
        return {"storage_cursor": self(decoded)}

    def __call__(self, obj):
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                if k in ("token", "refresh_token") and isinstance(v, str):
                    out[k] = "<token>"
                elif k in ("create_time", "update_time", "receive_time_ms"):
                    out[k] = "<time>"
                elif k == "purchase_time" and isinstance(v, float) and v > 1.75e9:
                    # A subscription row's: the clock's (a store's own
                    # purchase times stay).
                    out[k] = "<time>"
                elif k in CURSOR_KEYS and isinstance(v, str) and v:
                    out[k] = self.cursor(v)
                elif k == "payload" and isinstance(v, str):
                    # An rpc's answer: a string that may hold ids.
                    out[k] = self.text(v)
                else:
                    out[k] = self(v)
            if "user_id_one" in out:
                # A DM's two users come in the order of their raw ids.
                pair = sorted((out["user_id_one"], out["user_id_two"]))
                out["user_id_one"], out["user_id_two"] = pair
            return out
        if isinstance(obj, list):
            return [self(v) for v in obj]
        if isinstance(obj, str):
            return self.names.get(obj, obj)
        return obj


class EchoMatch:
    """An authoritative match that echoes each message back to every
    presence with op_code + 1 (a Python handler: the runtime that
    registers Lua/JS ones is a later slice)."""

    def match_init(self, ctx, params):
        return {}, 20, json.dumps({"mode": params.get("mode", "duel")})

    def match_join_attempt(self, ctx, dispatcher, tick, state, presence, md):
        return state, True, ""

    def match_join(self, ctx, dispatcher, tick, state, presences):
        return state

    def match_leave(self, ctx, dispatcher, tick, state, presences):
        return state

    def match_loop(self, ctx, dispatcher, tick, state, messages):
        for m in messages:
            dispatcher.broadcast_message(m.op_code + 1, m.data, sender=m.sender)
        return state

    def match_terminate(self, ctx, dispatcher, tick, state, grace):
        return state

    def match_signal(self, ctx, dispatcher, tick, state, data):
        return state, data


# One tournament start for both servers.
T0 = float(int(time.time()) - 100)


async def recv_until(ws, key, log, timeout=10.0):
    async def loop():
        while True:
            env = json.loads(await ws.recv())
            log.append(env)
            if key in env:
                return env
    return await asyncio.wait_for(loop(), timeout)


async def run_script(server, key: str) -> dict:
    """The shared script; returns what a client sees, ids normalised."""
    port = server.port
    norm = Normaliser()
    out: dict = {"http": [], "ws": {}, "matched": {}, "claims": {},
                 "play": []}
    server.match_registry.register("echo", EchoMatch)
    await server.leaderboards.create("arena", sort_order="desc")
    await server.leaderboards.create("locked", authoritative=True)
    await server.tournaments.create(
        "cup", duration=3600, start_time=T0, join_required=True,
        max_num_score=2)

    async def call(method, path, headers=None, body=None, shown=None):
        """One request; logged as `shown` (a path whose query holds a
        cursor) or by its path, normalised at the end (ids learned from
        an answer name it too)."""
        r = await wsproto.request(HOST, port, method, path, headers=headers, body=body)
        try:
            payload = r.json()
        except ValueError:
            payload = r.body.decode()
        out["http"].append((method, path, shown, r.status, payload))
        return r.status, payload

    await call("GET", "/healthcheck")
    await call("GET", "/v2/healthcheck")
    await call("GET", "/")
    # Bodies above socket.max_request_size_bytes: a JSON route refuses
    # it at its parse, a route that reads no body answers as usual.
    oversized = b'{"account": {"id": "' + b"x" * 300_000 + b'"}}'
    await call("POST", "/v2/account/authenticate/device", basic(), oversized)
    await call("POST", "/v2/account/authenticate/device", basic("wrong"),
               oversized)
    await call("GET", "/v2/healthcheck", None, oversized)
    await call("POST", "/v2/account/authenticate/device", basic("wrong"),
               {"account": {"id": "device-abcdef"}})
    await call("POST", "/v2/account/authenticate/device", basic(),
               {"account": {"id": "short"}})
    await call("POST", "/v2/account/authenticate/device?create=false", basic(),
               {"account": {"id": "device-nobody-here"}})
    await call("POST", "/v2/account/authenticate/email", basic(),
               {"account": {"email": "a@b.cc", "password": "x"}})
    _, first = await call("POST", "/v2/account/authenticate/email?username=mail1",
                          basic(), {"account": {"email": "mail1@example.com",
                                                "password": "password1"}})
    await call("POST", "/v2/account/authenticate/email", basic(),
               {"account": {"email": "mail1@example.com", "password": "password2"}})
    await call("POST", "/v2/account/authenticate/email", basic(),
               {"account": {"email": "mail1@example.com", "password": "password1"}})
    await call("POST", "/v2/account/authenticate/custom", basic(),
               {"account": {"id": "abc"}})
    _, c1 = await call("POST", "/v2/account/authenticate/custom?username=cust1",
                       basic(), {"account": {"id": "custom-id-1"}})
    _, c2 = await call("POST", "/v2/account/authenticate/custom", basic(),
                       {"account": {"id": "custom-id-1"}})
    assert c1["token"] and c2["token"]
    mail_claims = port_token.parse("defaultencryptionkey", first["token"])
    norm.learn(mail_claims.user_id, "user:mail1")
    custom_uid = port_token.parse("defaultencryptionkey", c1["token"]).user_id
    assert port_token.parse("defaultencryptionkey", c2["token"]).user_id == custom_uid
    norm.learn(custom_uid, "user:cust1")
    # Refresh rotates the used refresh token; logout kills the session.
    await call("POST", "/v2/account/session/refresh", basic(),
               {"token": first["refresh_token"]})
    await call("POST", "/v2/account/session/refresh", basic(),
               {"token": first["refresh_token"]})
    await call("POST", "/v2/account/session/refresh", basic(), {"token": "x.y.z"})
    await call("POST", "/v2/session/logout", None, {})
    await call("POST", "/v2/session/logout", bearer(c1["token"]),
               {"refresh_token": c1["refresh_token"]})
    await call("POST", "/v2/account/session/refresh", basic(),
               {"token": c1["refresh_token"]})

    plan = ticket_plan(11, n_pairs=4, n_single=2)
    clients = {}
    tokens = {}
    for device, props, query in plan:
        status, body = await call(
            "POST", f"/v2/account/authenticate/device?username={device}",
            basic(), {"account": {"id": device}},
        )
        again_status, again = await call(
            "POST", "/v2/account/authenticate/device", basic(),
            {"account": {"id": device}},
        )
        assert body["created"] is True and again["created"] is False
        claims = port_token.parse("defaultencryptionkey", body["token"])
        assert port_token.parse("defaultencryptionkey", again["token"]).user_id == claims.user_id
        norm.learn(claims.user_id, f"user:{device}")
        tokens[device] = (body["token"], claims.user_id)
        ws = await wsproto.connect(HOST, port, f"/ws?token={body['token']}")
        log: list = []
        clients[device] = (ws, log, props, query)
        # The socket's own STATUS presence names its session id.
        event = await recv_until(ws, "stream_presence_event", log)
        norm.learn(event["stream_presence_event"]["joins"][0]["session_id"],
                   f"session:{device}")

    # A logged-out session's token is refused at the socket.
    dead = await wsproto.connect(HOST, port, f"/ws?token={c1['token']}")
    with pytest.raises(wsproto.ConnectionClosed) as closed:
        await asyncio.wait_for(dead.recv(), 10)
    out["logout_close"] = (closed.value.code, closed.value.reason)

    devices = [d for d, _, _ in plan]
    first_ws, first_log, _, _ = clients[devices[0]]
    malformed = [
        {"cid": "m1"},
        {"cid": "m2", "ping": {}, "pong": {}},
        {"cid": "m3", "no_such_message": {}},
        {"cid": "m4", "matchmaker_add": {"min_count": 1, "max_count": 2}},
        {"cid": "m5", "matchmaker_add": {"min_count": 4, "max_count": 2}},
        {"cid": "m6", "matchmaker_add": {"min_count": 2, "max_count": 2,
                                          "query": "+properties.mode:"}},
        {"cid": "m7", "matchmaker_remove": {"ticket": "no-such-ticket"}},
        {"cid": "m8", "matchmaker_remove": {}},
        {"cid": "m10", "matchmaker_add": {"min_count": 2, "max_count": 4,
                                           "count_multiple": 3}},
    ]
    for env in malformed:
        await first_ws.send(json.dumps(env))
        await recv_until(first_ws, "error", first_log)
    # A channel join without a type.
    await first_ws.send(json.dumps({"cid": "m9", "channel_join": {"target": "r"}}))
    err = await recv_until(first_ws, "error", [])
    out["channel_join"] = err["error"]
    await first_ws.send(json.dumps({"cid": "p1", "ping": {}}))
    await recv_until(first_ws, "pong", first_log)
    # A ticket added and removed again by its owner.
    await first_ws.send(json.dumps({"cid": "r1", "matchmaker_add": {
        "min_count": 2, "max_count": 2, "query": "+properties.mode:never"}}))
    removable = (await recv_until(first_ws, "matchmaker_ticket", first_log))
    norm.learn(removable["matchmaker_ticket"]["ticket"], "ticket:removed")
    await first_ws.send(json.dumps({"cid": "r2", "matchmaker_remove": {
        "ticket": removable["matchmaker_ticket"]["ticket"]}}))
    await recv_until(first_ws, "cid", first_log)
    # Status follow (an existing user and an unknown one), update,
    # unfollow.
    second = devices[1]
    second_uid = [v for v, n in norm.names.items() if n == f"user:{second}"][0]
    await first_ws.send(json.dumps({"cid": "s1", "status_follow": {
        "user_ids": [second_uid, "00000000-0000-0000-0000-000000000000"]}}))
    status = await recv_until(first_ws, "status", first_log)
    out["status_follow"] = norm(status)
    await first_ws.send(json.dumps({"cid": "s2", "status_update": {"status": "hi"}}))
    await recv_until(first_ws, "cid", first_log)
    await first_ws.send(json.dumps({"cid": "s3", "status_unfollow": {
        "user_ids": [second_uid]}}))
    await recv_until(first_ws, "cid", first_log)

    for device, (ws, log, props, query) in clients.items():
        await ws.send(json.dumps({"cid": f"add-{device}", "matchmaker_add": {
            "min_count": 2, "max_count": 2, "query": query, **props}}))
        ack = await recv_until(ws, "matchmaker_ticket", log)
        norm.learn(ack["matchmaker_ticket"]["ticket"], f"ticket:{device}")
    assert len(server.matchmaker) == len(plan)
    server.matchmaker.process()
    for device, (ws, log, _, _) in clients.items():
        if device.startswith("device-pair"):
            env = await recv_until(ws, "matchmaker_matched", log)
            body = env["matchmaker_matched"]
            claims = port_token.parse("defaultencryptionkey", body["token"])
            out["claims"][device] = {
                "user_id": ",".join(sorted(
                    norm(part.split(":")[0]) + ":" + part.split(":")[1]
                    for part in claims.user_id.split(",")
                )),
                "username": claims.username,
                "kind": claims.vars["kind"],
                "node": claims.vars["node"],
                "mid_node": claims.vars["mid"].rsplit(".", 1)[1],
                "ttl_s": round(claims.expires_at) - round(claims.expires_at - 30),
            }
            users = sorted(norm(body["users"]), key=lambda u: u["presence"]["user_id"])
            out["matched"][device] = {
                "ticket": norm(body["ticket"]), "self": norm(body["self"]),
                "users": users,
            }
    await play(server, norm, out, clients, tokens, call)
    await social(server, key, norm, clients, tokens, call)
    await runtime_leg(server, norm, out, clients, tokens, call)
    out["providers"] = await providers_leg(server, norm, tokens, call)
    out["http"] = [(method, shown or norm.text(path), status, norm(payload))
                   for method, path, shown, status, payload in out["http"]]
    for device, (ws, log, _, _) in clients.items():
        out["ws"][device] = [
            norm(e) for e in log
            if not {"stream_presence_event", "match_presence_event",
                    "party_presence_event", "match_data", "match",
                    "party", "party_data"} & set(e)
        ]
        await ws.close()
    await asyncio.sleep(0.05)
    store = server.matchmaker.store
    out["pool_after"] = sorted(
        norm(store.ticket_at[s].ticket) for s in store.live_slots()
    )
    scrape = await wsproto.request(HOST, server.metrics_port if key == "torch"
                                   else server.console.metrics_port,
                                   "GET", "/metrics")
    assert scrape.status == 200
    out["metrics"] = parse(scrape.body)
    return out


def _sorted_presences(env):
    """A `match`/`party` envelope with its presence list in user order."""
    env = json.loads(json.dumps(env))
    for key in ("match", "party"):
        if key in env and "presences" in env[key]:
            env[key]["presences"].sort(key=lambda p: p["user_id"])
    return env


async def play(server, norm, out, clients, tokens, call):
    """The matched players play: every pair redeems its match token and
    relays data; one pair plays an authoritative `echo` match found
    through `GET /v2/match`; two players party up and matchmake as a
    party; then leaderboard and tournament records over HTTP."""
    pairs = {}
    for device, matched in out["claims"].items():
        pairs.setdefault(matched["user_id"], []).append(device)
    plays = out["play"]
    for users in sorted(pairs):
        a, b = sorted(pairs[users])
        mids = set()
        for device in (a, b):
            ws, log, _, _ = clients[device]
            env = [e for e in log if "matchmaker_matched" in e][0]
            token = env["matchmaker_matched"]["token"]
            mid = port_token.parse("defaultencryptionkey", token).vars["mid"]
            norm.learn(mid, f"match:{a}")
            mids.add(mid)
            await ws.send(json.dumps({"cid": "j", "match_join": {"token": token}}))
            plays.append(_sorted_presences(norm(await recv_until(ws, "match", log))))
        assert len(mids) == 1
        ws_a, log_a = clients[a][:2]
        ws_b, log_b = clients[b][:2]
        data = base64.b64encode(a.encode()).decode()
        await ws_a.send(json.dumps({"match_data_send": {
            "match_id": mid, "op_code": 4, "data": data}}))
        plays.append(norm(await recv_until(ws_b, "match_data", log_b)))
        await ws_b.send(json.dumps({"cid": "l", "match_leave": {"match_id": mid}}))
        plays.append(norm(await recv_until(ws_b, "cid", log_b)))
    a, b = sorted(d for d in clients if d.startswith("device-pair"))[:2]
    (ws_a, log_a), (ws_b, log_b) = clients[a][:2], clients[b][:2]
    await ws_a.send(json.dumps({"cid": "c", "match_create": {
        "name": "echo", "params": {"mode": "duel"}}}))
    created = await recv_until(ws_a, "match", log_a)
    mid = created["match"]["match_id"]
    norm.learn(mid, "match:echo")
    plays.append(norm(created))
    await ws_b.send(json.dumps({"cid": "j", "match_join": {"match_id": mid}}))
    plays.append(_sorted_presences(norm(await recv_until(ws_b, "match", log_b))))
    await ws_b.send(json.dumps({"cid": "x", "match_create": {"name": "nope"}}))
    plays.append(norm(await recv_until(ws_b, "error", log_b)))
    await ws_a.send(json.dumps({"match_data_send": {
        "match_id": mid, "op_code": 6, "data": "aGk="}}))
    for ws, log in ((ws_a, log_a), (ws_b, log_b)):
        plays.append(norm(await recv_until(ws, "match_data", log)))
    for query in ("?query=%2Blabel.mode%3Aduel", "?limit=1", "?min_size=3"):
        await call("GET", f"/v2/match{query}", bearer(tokens[a][0]))
    await call("GET", "/v2/match")
    # A party of two matchmakes as one ticket.
    await ws_a.send(json.dumps({"cid": "p1", "party_create": {"open": True}}))
    party = await recv_until(ws_a, "party", log_a)
    pid = party["party"]["party_id"]
    norm.learn(pid, "party:ab")
    plays.append(norm(party))
    await ws_b.send(json.dumps({"cid": "p2", "party_join": {"party_id": pid}}))
    plays.append(_sorted_presences(norm(await recv_until(ws_b, "party", log_b))))
    await ws_a.send(json.dumps({"cid": "p3", "party_matchmaker_add": {
        "party_id": pid, "min_count": 2, "max_count": 2, "query": "*"}}))
    ticket = await recv_until(ws_a, "party_matchmaker_ticket", log_a)
    norm.learn(ticket["party_matchmaker_ticket"]["ticket"], "ticket:party")
    plays.append(norm(ticket))
    pooled = server.matchmaker.store.party_tickets(pid)
    plays.append(sorted(norm(e.presence.user_id) for t in pooled
                        for e in t.entries))
    await ws_b.send(json.dumps({"cid": "p4", "party_data_send": {
        "party_id": pid, "op_code": 1, "data": "eA=="}}))
    plays.append(norm(await recv_until(ws_a, "party_data", log_a)))
    await ws_a.send(json.dumps({"cid": "p5", "party_close": {"party_id": pid}}))
    plays.append(norm(await recv_until(ws_a, "cid", log_a)))
    plays.append(len(server.matchmaker.store.party_tickets(pid)))
    # Leaderboards and tournaments.
    writers = sorted(tokens)[:6]
    for i, device in enumerate(writers):
        token, _ = tokens[device]
        await call("POST", "/v2/leaderboard/arena", bearer(token),
                   {"record": {"score": (i * 7) % 5, "subscore": i}})
        await call("POST", "/v2/tournament/cup/join", bearer(token), {})
        await call("POST", "/v2/tournament/cup", bearer(token),
                   {"score": 10 - i, "metadata": {"i": i}})
    token, uid = tokens[writers[2]]
    await call("POST", "/v2/leaderboard/arena", bearer(token), {"score": 1})
    await call("POST", "/v2/leaderboard/locked", bearer(token), {"score": 1})
    await call("POST", "/v2/leaderboard/none", bearer(token), {"score": 1})
    await call("POST", "/v2/leaderboard/arena", None, {"score": 1})
    await call("GET", "/v2/leaderboard/arena?limit=4", bearer(token))
    await call("GET", f"/v2/leaderboard/arena?owner_ids={uid}"
               f"&owner_ids={tokens[writers[0]][1]}", bearer(token))
    await call("GET", f"/v2/leaderboard/arena/owner/{uid}?limit=3",
               bearer(token))
    await call("DELETE", "/v2/leaderboard/arena", bearer(token))
    await call("GET", "/v2/leaderboard/arena", bearer(token))
    await call("GET", "/v2/tournament", bearer(token))
    await call("GET", "/v2/tournament/cup?limit=3", bearer(token))
    await call("GET", f"/v2/tournament/cup/owner/{uid}?limit=2", bearer(token))
    await call("POST", "/v2/tournament/cup", bearer(tokens[writers[-1]][0]),
               {"score": 99})
    await call("DELETE", "/v2/tournament/cup", bearer(token))
    await call("GET", "/v2/tournament/cup", bearer(token))
    await call("GET", "/v2/leaderboard/arena?limit=x", bearer(token))


def _q(path: str, cursor: str) -> str:
    return f"{path}cursor={urllib.parse.quote(cursor)}"


async def social(server, key, norm, clients, tokens, call):
    """The rest of `core/` over REST and the socket: accounts and
    users, device/email/custom links, storage (owner, public and
    system-owned objects, versions, cursors to the end), friends with
    their notifications on the socket, groups, chat in a room, a DM and
    a group channel with its history, a wallet written in-process (no
    route writes one), and an account delete followed by the board's
    listing and a haystack."""
    core = importlib.import_module(
        ("nakama_tpu" if key == "jax" else "nakama_tpu_torch") + ".core.storage")
    devs = sorted(tokens)
    a, b, c, d, e = devs[:5]
    auth = {dv: bearer(tokens[dv][0]) for dv in devs}
    uid = {dv: tokens[dv][1] for dv in devs}
    ws = {dv: clients[dv][:2] for dv in devs}

    async def wait(dv, want):
        sock, log = ws[dv]
        return await recv_until(sock, want, log)

    async def envelope(dv, body, want):
        await ws[dv][0].send(json.dumps(body))
        return await wait(dv, want)

    # Accounts and users; a wallet written in-process.
    await server.wallets.update_wallets(
        [{"user_id": uid[a], "changeset": {"coins": 10, "gems": 2},
          "metadata": {"why": "seed"}}])
    await call("GET", "/v2/account", auth[a])
    await call("GET", "/v2/account")
    await call("PUT", "/v2/account", auth[a], {
        "display_name": "Ada", "timezone": "UTC", "location": "here",
        "lang_tag": "fr", "avatar_url": "http://a/1.png"})
    await call("PUT", "/v2/account", auth[a], {"username": "bad name!"})
    await call("PUT", "/v2/account", auth[a], {"username": b})
    await call("GET", "/v2/account", auth[a])
    # (One id: rows fetched by several come in the order of their random
    # ids.)
    await call("GET", f"/v2/user?ids={uid[b]}&usernames={d}&usernames={c}"
               f"&usernames=nobody&usernames={b}"
               "&ids=00000000-0000-0000-0000-000000000000", auth[a])
    # Links: device, email, custom; the last method stays.
    await call("POST", "/v2/account/link/custom", auth[a], {"id": "custom-a-link"})
    await call("POST", "/v2/account/link/custom", auth[b], {"id": "custom-a-link"})
    await call("POST", "/v2/account/link/custom", auth[a], {"id": "abc"})
    await call("POST", "/v2/account/link/email", auth[a],
               {"email": "a-link@example.com", "password": "password9"})
    await call("POST", "/v2/account/link/email", auth[a],
               {"email": "a-link@example.com", "password": "short"})
    await call("POST", "/v2/account/link/device", auth[a], {"id": "device-extra-a"})
    await call("POST", "/v2/account/link/device", auth[a], {"id": b})
    await call("GET", "/v2/account", auth[a])
    await call("POST", "/v2/account/unlink/custom", auth[a], {})
    await call("POST", "/v2/account/unlink/custom", auth[a], {})
    await call("POST", "/v2/account/unlink/email", auth[a], {})
    await call("POST", "/v2/account/unlink/device", auth[a], {"id": "device-extra-a"})
    await call("POST", "/v2/account/unlink/device", auth[a], {"id": a})
    await call("POST", "/v2/account/unlink/email", auth[a], {})
    # Storage: writes with versions and permissions, reads, listings.
    _, acks = await call("PUT", "/v2/storage", auth[a], {"objects": [
        {"collection": "saves", "key": "slot1", "value": {"hp": 10}},
        {"collection": "saves", "key": "slot2", "value": '{"hp": 20}',
         "permission_read": 2},
        {"collection": "saves", "key": "slot3", "value": {"x": 1},
         "permission_read": 0, "permission_write": 0}]})
    version = acks["acks"][0]["version"]
    for obj in ({"key": "slot1", "value": {"hp": 11}, "version": "*"},
                {"key": "slot1", "value": {"hp": 11}, "version": "0" * 32},
                {"key": "slot1", "value": {"hp": 11}, "version": version},
                {"key": "slot3", "value": {"x": 2}},
                {"key": "new", "value": {"y": 1}, "version": version},
                {"key": "bad", "value": "not json"},
                {"key": "bad", "value": "[1]"},
                {"key": "bad", "value": {}, "permission_read": 3},
                {"key": "", "value": {}}):
        await call("PUT", "/v2/storage", auth[a],
                   {"objects": [{"collection": "saves", **obj}]})
    # (b's object has a key of its own: a listing orders by key, then by
    # the owner's random id.)
    await call("PUT", "/v2/storage", auth[b], {"objects": [
        {"collection": "saves", "key": "shared", "value": {"hp": 5},
         "permission_read": 2}, {"collection": "saves", "key": "mine",
                                 "value": {"hp": 6}}]})
    ids = [{"collection": "saves", "key": k, "user_id": u}
           for k, u in (("slot1", uid[a]), ("slot2", uid[a]), ("slot3", uid[a]),
                        ("shared", uid[b]), ("mine", uid[b]), ("gone", uid[a]))]
    await call("POST", "/v2/storage", auth[a], {"object_ids": ids})
    await call("POST", "/v2/storage", auth[b], {"object_ids": ids})
    await call("POST", "/v2/storage", auth[b], {"object_ids": [
        {"collection": "saves", "key": "mine"}]})
    _, page = await call("GET", "/v2/storage/saves?limit=2", auth[a])
    await call("GET", _q("/v2/storage/saves?limit=2&", page["cursor"]), auth[a],
               shown="/v2/storage/saves?limit=2&cursor=<page 1>")
    await call("GET", f"/v2/storage/saves/{uid[a]}", auth[b])
    await call("GET", f"/v2/storage/saves?user_id={uid[b]}", auth[a])
    await call("GET", "/v2/storage/saves?cursor=garbage", auth[a])
    await core.storage_write_objects(server.db, None, [
        core.StorageOpWrite("public", f"k{i:02d}", "", json.dumps({"i": i}),
                            permission_read=2, permission_write=0)
        for i in range(7)])
    cursor, n = "", 0
    while True:
        path = "/v2/storage/public?limit=3&"
        _, page = await call("GET", _q(path, cursor), auth[c],
                             shown=f"{path}cursor=<page {n}>")
        cursor, n = page["cursor"], n + 1
        if not cursor:
            break
    await call("PUT", "/v2/storage/delete", auth[a], {"object_ids": [
        {"collection": "saves", "key": "slot2", "version": "0" * 32}]})
    await call("PUT", "/v2/storage/delete", auth[a], {"object_ids": [
        {"collection": "saves", "key": "slot2"}, {"collection": "saves", "key": "gone"}]})
    await call("PUT", "/v2/storage/delete", auth[a], {"object_ids": [
        {"collection": "saves", "key": "slot3"}]})
    await call("PUT", "/v2/storage/delete", auth[a], {"object_ids": [
        {"collection": "saves", "key": "gone", "version": version}]})
    await call("GET", "/v2/storage/saves", auth[a])
    # Friends; each request's notification reaches the partner's socket.
    await call("POST", f"/v2/friend?ids={uid[b]}", auth[a])
    note = await wait(b, "notifications")
    norm.learn(note["notifications"]["notifications"][0]["id"], "note:invite")
    await call("GET", "/v2/friend", auth[a])
    await call("GET", "/v2/friend", auth[b])
    await call("POST", f"/v2/friend?usernames={a}", auth[b])
    note = await wait(a, "notifications")
    norm.learn(note["notifications"]["notifications"][0]["id"], "note:accept")
    await call("GET", "/v2/friend?state=0", auth[a])
    await call("POST", f"/v2/friend?ids={uid[a]}", auth[a])
    await call("POST", "/v2/friend?ids=00000000-0000-0000-0000-000000000000", auth[a])
    await call("POST", f"/v2/friend/block?ids={uid[c]}", auth[a])
    await call("POST", f"/v2/friend?ids={uid[a]}", auth[c])
    await call("POST", f"/v2/friend?ids={uid[c]}", auth[a])
    await call("GET", "/v2/friend", auth[c])
    await call("DELETE", f"/v2/friend?ids={uid[c]}", auth[a])
    await call("DELETE", f"/v2/friend?ids={uid[b]}", auth[a])
    await call("GET", "/v2/friend?limit=1", auth[a])
    await call("GET", "/v2/friend?limit=1&cursor=1", auth[a])
    await call("GET", "/v2/friend", auth[b])
    await call("POST", f"/v2/friend?ids={uid[d]}", auth[b])
    note = await wait(d, "notifications")
    norm.learn(note["notifications"]["notifications"][0]["id"], "note:second")
    # Notifications: listed, paged by the cacheable cursor, deleted.
    _, listed = await call("GET", "/v2/notification?limit=1", auth[b])
    await call("GET", _q("/v2/notification?limit=1&", listed["cacheable_cursor"]),
               auth[b], shown="/v2/notification?limit=1&cursor=<page 1>")
    await call("GET", "/v2/notification", auth[d])
    await call("DELETE", f"/v2/notification?ids={listed['notifications'][0]['id']}",
               auth[a])
    await call("GET", "/v2/notification", auth[b])
    await call("DELETE", f"/v2/notification?ids={listed['notifications'][0]['id']}",
               auth[b])
    await call("GET", "/v2/notification", auth[b])
    # Groups: open and closed, max_count, roles, requests, listings.
    _, g1 = await call("POST", "/v2/group", auth[a], {
        "name": "Guild", "description": "d", "max_count": 3,
        "metadata": {"tier": 1}})
    norm.learn(g1["id"], "group:guild")
    await call("POST", "/v2/group", auth[b], {"name": "Guild"})
    await call("POST", "/v2/group", auth[b], {"name": ""})
    _, g2 = await call("POST", "/v2/group", auth[c], {"name": "Closed", "open": False})
    norm.learn(g2["id"], "group:closed")
    guild, closed = f"/v2/group/{g1['id']}", f"/v2/group/{g2['id']}"
    for dv in (b, d, e):
        await call("POST", f"{guild}/join", auth[dv])
    await call("GET", f"{guild}/user", auth[e])
    await call("POST", f"{closed}/join", auth[a])
    await call("POST", f"{closed}/join", auth[a])
    await call("GET", f"{closed}/user?state=3", auth[c])
    await call("POST", f"{closed}/add?user_ids={uid[d]}", auth[a])
    await call("POST", f"{closed}/add?user_ids={uid[a]}", auth[c])
    await call("POST", f"{guild}/promote?user_ids={uid[b]}", auth[a])
    await call("POST", f"{guild}/promote?user_ids={uid[b]}", auth[a])
    await call("POST", f"{guild}/demote?user_ids={uid[b]}", auth[a])
    await call("POST", f"{guild}/kick?user_ids={uid[d]}&user_ids={uid[a]}", auth[b])
    await call("POST", f"{guild}/ban?user_ids={uid[d]}", auth[a])
    await call("POST", f"{guild}/join", auth[d])
    await call("POST", f"{guild}/join", auth[e])
    await call("POST", f"{guild}/kick?user_ids={uid[a]}", auth[d])
    await call("GET", f"{guild}/user", auth[e])
    await call("POST", f"{guild}/leave", auth[a])
    await call("POST", f"{guild}/leave", auth[b])
    await call("PUT", guild, auth[a], {"description": "new", "max_count": 5,
                                       "open": False})
    await call("PUT", guild, auth[b], {"description": "mine"})
    await call("GET", "/v2/group?name=Gu%25", auth[e])
    await call("GET", "/v2/group?limit=1", auth[e])
    await call("GET", "/v2/group?limit=1&cursor=1", auth[e])
    await call("GET", "/v2/group?open=false", auth[e])
    await call("GET", f"/v2/user/{uid[a]}/group", auth[e])
    await call("GET", f"/v2/user/{uid[a]}/group?state=2", auth[e])
    await call("GET", "/v2/group/00000000-0000-0000-0000-000000000000/user", auth[e])
    await call("POST", "/v2/group/00000000-0000-0000-0000-000000000000/join", auth[e])
    await call("DELETE", closed, auth[a])
    await call("DELETE", closed, auth[c])
    await call("GET", f"/v2/user/{uid[a]}/group", auth[e])
    # Chat: a room, a DM with history, a group channel; bad envelopes.
    await envelope(a, {"cid": "ch1", "channel_join": {"type": 1, "target": "lobby"}},
                   "channel")
    await envelope(b, {"cid": "ch2", "channel_join": {"type": 1, "target": "lobby",
                                                        "hidden": False}}, "channel")
    await wait(a, "channel_presence_event")
    dm = await envelope(a, {"cid": "ch3", "channel_join": {"type": 3,
                                                           "target": uid[b]}}, "channel")
    dm_id = dm["channel"]["id"]
    norm.learn(dm_id, "channel:dm")
    await envelope(b, {"cid": "ch4", "channel_join": {"type": 3, "target": uid[a]}},
                   "channel")
    await wait(a, "channel_presence_event")
    sent = []
    for i, (dv, other) in enumerate(((a, b), (b, a), (a, b))):
        ack = await envelope(dv, {"cid": f"m{i}", "channel_message_send": {
            "channel_id": dm_id, "content": {"n": i}}}, "channel_message_ack")
        norm.learn(ack["channel_message_ack"]["message_id"], f"message:{i}")
        sent.append(ack["channel_message_ack"]["message_id"])
        await wait(other, "channel_message")
    await envelope(a, {"cid": "u1", "channel_message_update": {
        "channel_id": dm_id, "message_id": sent[0], "content": '{"n": 10}'}},
        "channel_message_ack")
    await wait(b, "channel_message")
    await envelope(b, {"cid": "u2", "channel_message_update": {
        "channel_id": dm_id, "message_id": sent[0], "content": {"n": 11}}}, "error")
    await envelope(b, {"cid": "r1", "channel_message_remove": {
        "channel_id": dm_id, "message_id": sent[2]}}, "error")
    await envelope(a, {"cid": "r2", "channel_message_remove": {
        "channel_id": dm_id, "message_id": sent[2]}}, "channel_message_ack")
    await wait(b, "channel_message")
    await envelope(a, {"cid": "r3", "channel_message_remove": {
        "channel_id": dm_id, "message_id": sent[2]}}, "error")
    group = await envelope(e, {"cid": "g1", "channel_join": {
        "type": 2, "target": g1["id"]}}, "channel")
    group_id = group["channel"]["id"]
    norm.learn(group_id, "channel:guild")
    ack = await envelope(e, {"cid": "g2", "channel_message_send": {
        "channel_id": group_id, "content": {"hello": "guild"}}}, "channel_message_ack")
    norm.learn(ack["channel_message_ack"]["message_id"], "message:guild")
    for dv, env in (
        (d, {"cid": "b1", "channel_join": {"type": 2, "target": g1["id"]}}),
        (a, {"cid": "b2", "channel_join": {"type": 9, "target": "x"}}),
        (a, {"cid": "b3", "channel_join": {"type": 3, "target": uid[a]}}),
        (a, {"cid": "b4", "channel_join": {"type": 1, "target": "a.b"}}),
        (c, {"cid": "b5", "channel_message_send": {"channel_id": dm_id,
                                                   "content": {}}}),
        (a, {"cid": "b6", "channel_message_send": {"channel_id": dm_id,
                                                   "content": "not json"}}),
        (a, {"cid": "b7", "channel_message_send": {"channel_id": "1.2",
                                                   "content": {}}}),
        (a, {"cid": "b8", "channel_leave": {"channel_id": "9..."}}),
    ):
        await envelope(dv, env, "error")
    await envelope(a, {"cid": "l1", "channel_leave": {"channel_id": "2...lobby"}},
                   "cid")
    await wait(b, "channel_presence_event")
    history = f"/v2/channel/{dm_id}"
    _, page = await call("GET", f"{history}?limit=1", auth[a])
    await call("GET", _q(f"{history}?limit=1&", page["next_cursor"]), auth[b],
               shown=f"{norm.text(history)}?limit=1&cursor=<next 1>")
    await call("GET", f"{history}?forward=false", auth[b])
    await call("GET", history, auth[c])
    await call("GET", f"/v2/channel/{group_id}", auth[e])
    await call("GET", f"/v2/channel/{group_id}", auth[c])
    await call("GET", "/v2/channel/2...lobby", auth[c])
    await call("GET", "/v2/channel/bad", auth[c])
    # An account delete: its board record leaves the listing.
    await call("DELETE", "/v2/account", auth[e])
    await call("GET", "/v2/account", auth[e])
    await call("GET", f"/v2/user?ids={uid[e]}", auth[a])
    await call("GET", "/v2/leaderboard/arena", auth[a])
    await call("GET", f"/v2/leaderboard/arena/owner/{uid[a]}?limit=4", auth[a])
    await call("GET", f"{guild}/user", auth[a])
    await call("GET", "/v2/account", auth[a])


# The runtime's modules: Python, Lua and JS, each server loading its own
# copy. Every hook acts on marked requests only, so the rest of the
# script runs as it does without them.
RT_MODULES = {
    "a_rt.lua": """
local matched_calls = 0
nk.register_matchmaker_matched(function(ctx, entries)
  matched_calls = matched_calls + 1
  nk.metrics_counter_add("rt_matched_calls", nil, 1)
  for _, e in ipairs(entries) do
    if e.string_properties.arena == "js" then
      return nk.match_create("arena", {from = "lua", size = #entries})
    end
  end
  return ""
end)
nk.register_rpc(function(ctx, payload)
  return json.encode({payload = payload, user = ctx.user_id,
                      matched_calls = matched_calls})
end, "lua_echo")
nk.register_rpc(function(ctx, payload) return 42 end, "lua_bad_return")
nk.register_rt_before(function(ctx, env)
  if env.status == "rt-reject" then return nil end
  if env.status == "rt-upper" then env.status = "RT-UPPER" end
  return env
end, "status_update")
nk.register_req_before(function(ctx, body)
  for _, id in ipairs(body.ids or {}) do
    if id == "00000000-0000-0000-0000-00000000dead" then return nil end
  end
  return body
end, "addfriends")
""",
    "b_arena.js": """
function InitModule(ctx, logger, nk, initializer) {
  initializer.registerMatch("arena", {
    matchInit: function(ctx, params) {
      return {state: {joins: 0}, tickRate: 10,
              label: JSON.stringify({arena: "js", from: params.from,
                                     size: params.size})};
    },
    matchJoinAttempt: function(ctx, d, tick, state, presence, metadata) {
      return {state: state, accept: true};
    },
    matchJoin: function(ctx, d, tick, state, presences) {
      state.joins += presences.length;
      return {state: state};
    },
    matchLeave: function(ctx, d, tick, state, presences) {
      return {state: state};
    },
    matchLoop: function(ctx, d, tick, state, messages) {
      for (var i = 0; i < messages.length; i++) {
        var m = messages[i];
        d.broadcastMessage(m.opCode + 1, m.data, [m.sender]);
      }
      return {state: state};
    },
    matchTerminate: function(ctx, d, tick, state, grace) {
      return {state: state};
    },
    matchSignal: function(ctx, d, tick, state, data) {
      return {state: state, data: data};
    }
  });
  initializer.registerRpc("js_echo", function(ctx, payload) {
    return JSON.stringify({payload: payload, user: ctx.userId || ""});
  });
  initializer.registerRpc("js_throws", function(ctx, payload) {
    throw {message: "js says no"};
  });
  initializer.registerReqBefore("CreateGroup", function(ctx, body) {
    if (body.name === "rt-forbidden") { return null; }
    if (body.name === "rt-group") { body.description = "set by hook"; }
    return body;
  });
  initializer.registerReqBefore("WriteLeaderboardRecord", function(ctx, body) {
    var rec = body.record || body;
    if (rec.metadata && rec.metadata.hook) {
      if (rec.score < 0) { return null; }
      rec.score = rec.score * 10 + 1;
    }
    return body;
  });
}
""",
    "c_hooks.py": '''
import json

COUNTS = {"events": [], "session_start": 0, "session_end": 0,
          "after_auth": 0, "after_update": 0, "shutdown": 0}


def _bump(key):
    COUNTS[key] += 1


def init_module(ctx, logger, nk, initializer):
    def py_echo(ctx, payload):
        return json.dumps({"payload": payload, "user": ctx.user_id,
                           "mode": ctx.execution_mode,
                           "query": ctx.query_params})

    def py_raises(ctx, payload):
        raise ValueError("py says no: " + payload)

    async def counts(ctx, payload):
        return json.dumps(COUNTS, sort_keys=True)

    def matchmaker_add(ctx, key, body):
        if "banned" in body.get("query", ""):
            return None
        props = body.get("string_properties") or {}
        if props.get("mode") == "rt-arena":
            body["string_properties"] = {**props, "arena": "js"}
        return body

    def auth_custom(ctx, body):
        account = body.get("account") or {}
        if account.get("id") == "custom-rt-reject":
            return None
        if account.get("id") == "custom-rt-rename":
            body["username"] = "renamed-by-hook"
        return body

    def update_account(ctx, body):
        if body.get("display_name") == "reject":
            return None
        if body.get("display_name") == "shout":
            body["display_name"] = "SHOUT"
        return body

    def storage(ctx, body):
        objects = body.get("objects") or body.get("object_ids") or []
        if any(o.get("key") == "forbidden" for o in objects):
            return None
        for o in objects:
            if o.get("key") == "stamped":
                o["value"] = {"stamped": True, "was": o.get("value")}
        return body

    initializer.register_rpc("py_echo", py_echo)
    initializer.register_rpc("py_raises", py_raises)
    initializer.register_rpc("counts", counts)
    initializer.register_before_rt("MatchmakerAdd", matchmaker_add)
    initializer.register_before_req("AuthenticateCustom", auth_custom)
    initializer.register_after_req(
        "authenticate_custom", lambda ctx, body, out: _bump("after_auth"))
    initializer.register_before_req("UpdateAccount", update_account)
    initializer.register_after_req(
        "UpdateAccount", lambda ctx, body, out: _bump("after_update"))
    initializer.register_before_req("ReadStorageObjects", storage)
    initializer.register_before_req("WriteStorageObjects", storage)
    initializer.register_event(
        lambda ctx, e: COUNTS["events"].append(
            [e["name"], e["properties"], e.get("external", False),
             ctx.username]))
    initializer.register_event_session_start(
        lambda ctx, t: _bump("session_start"))
    initializer.register_event_session_end(
        lambda ctx, reason: _bump("session_end"))
    initializer.register_shutdown(lambda ctx: _bump("shutdown"))
''',
}


def runtime_dir(path):
    path.mkdir(parents=True)
    for name, text in RT_MODULES.items():
        (path / name).write_text(text)
    return path


async def runtime_leg(server, norm, out, clients, tokens, call):
    """The runtime's rpcs, hooks, events and matched hook, as a client
    sees them (`out["runtime"]`; HTTP answers go to `out["http"]`)."""
    rt = out["runtime"] = []
    devs = sorted(tokens)
    ws, log = clients[devs[0]][:2]
    auth = bearer(tokens[devs[0]][0])
    # rpc over the socket.
    for i, (rid, payload) in enumerate((
        ("py_echo", "hello"), ("PY_ECHO", ""), ("lua_echo", '{"n": 1}'),
        ("js_echo", "x"), ("nope", "x"), ("py_raises", "now"),
        ("js_throws", ""), ("lua_bad_return", ""),
    )):
        await ws.send(json.dumps({"cid": f"rpc{i}", "rpc": {
            "id": rid, "payload": payload}}))
        rt.append(norm(await recv_until(ws, "cid", log)))
    # rpc over HTTP: by session and by http_key, POST and GET.
    await call("POST", "/v2/rpc/py_echo", auth, "by session")
    await call("POST", "/v2/rpc/js_echo", auth, {"not": "a string"})
    await call("POST", "/v2/rpc/lua_echo?http_key=defaulthttpkey", None, "k")
    await call("GET", "/v2/rpc/py_echo?http_key=defaulthttpkey&payload=q1"
               "&extra=a&extra=b")
    await call("GET", "/v2/rpc/js_echo?payload=q2", auth)
    await call("POST", "/v2/rpc/py_echo?http_key=wrong", None, "x")
    await call("POST", "/v2/rpc/py_echo", None, "x")
    await call("POST", "/v2/rpc/nope", auth, "x")
    await call("POST", "/v2/rpc/py_raises", auth, "x")
    await call("POST", "/v2/rpc/js_throws", auth, "x")
    # Before-hooks on realtime messages: changed, rejected, unchanged.
    for status in ("rt-upper", "rt-reject", "plain"):
        await ws.send(json.dumps({"cid": f"st-{status}", "status_update": {
            "status": status}}))
        await ws.send(json.dumps({"cid": f"after-{status}", "ping": {}}))
        await recv_until(ws, "pong", log)
    # Before- and after-hooks on requests.
    for account in ("custom-rt-reject", "custom-rt-rename", "custom-rt-plain"):
        await call("POST", "/v2/account/authenticate/custom", basic(),
                   {"account": {"id": account}})
    for name in ("reject", "shout"):
        await call("PUT", "/v2/account", auth, {"display_name": name})
    await call("GET", "/v2/account", auth)
    await call("PUT", "/v2/storage", auth, {"objects": [
        {"collection": "rt", "key": "forbidden", "value": {"a": 1}}]})
    await call("PUT", "/v2/storage", auth, {"objects": [
        {"collection": "rt", "key": "stamped", "value": {"a": 1}}]})
    await call("POST", "/v2/storage", auth, {"object_ids": [
        {"collection": "rt", "key": "stamped"}]})
    await call("POST", "/v2/storage", auth, {"object_ids": [
        {"collection": "rt", "key": "forbidden"}]})
    await call("POST", "/v2/friend?ids=00000000-0000-0000-0000-00000000dead",
               auth)
    for name in ("rt-forbidden", "rt-group"):
        _, group = await call("POST", "/v2/group", auth, {"name": name})
        if isinstance(group, dict) and "id" in group:
            norm.learn(group["id"], f"group:{name}")
    for score in (3, -1):
        await call("POST", "/v2/leaderboard/arena", auth, {"record": {
            "score": score, "metadata": {"hook": True}}})
    await call("GET", "/v2/leaderboard/arena?limit=3", auth)
    # Custom events.
    await call("POST", "/v2/event", auth, {"name": "rt-evt",
                                           "properties": {"a": "1"}})
    await call("POST", "/v2/event", None, {"name": "no-session"})
    # The matched hook: a pair whose tickets the matchmaker_add hook
    # stamps is sent into the JS `arena` match, which echoes their data.
    pair = {}
    for device in ("device-rt-a", "device-rt-b"):
        _, body = await call(
            "POST", f"/v2/account/authenticate/device?username={device}",
            basic(), {"account": {"id": device}})
        claims = port_token.parse("defaultencryptionkey", body["token"])
        norm.learn(claims.user_id, f"user:{device}")
        sock = await wsproto.connect(HOST, server.port,
                                     f"/ws?token={body['token']}")
        pair[device] = (sock, [])
    for device, (sock, plog) in pair.items():
        event = await recv_until(sock, "stream_presence_event", plog)
        norm.learn(event["stream_presence_event"]["joins"][0]["session_id"],
                   f"session:{device}")
        await sock.send(json.dumps({"cid": "banned", "matchmaker_add": {
            "min_count": 2, "max_count": 2, "query": "+properties.banned:x"}}))
        await sock.send(json.dumps({"cid": "add", "matchmaker_add": {
            "min_count": 2, "max_count": 2, "query": "+properties.mode:rt-arena",
            "string_properties": {"mode": "rt-arena"},
            "numeric_properties": {"skill": 1.5}}}))
        ack = await recv_until(sock, "matchmaker_ticket", plog)
        norm.learn(ack["matchmaker_ticket"]["ticket"], f"ticket:{device}")
    server.matchmaker.process()
    mids = set()
    for device, (sock, plog) in pair.items():
        body = (await recv_until(sock, "matchmaker_matched", plog))[
            "matchmaker_matched"]
        mids.add(body["match_id"])
        norm.learn(body["match_id"], "match:arena")
        body["users"].sort(key=lambda u: norm(u["presence"]["user_id"]))
        rt.append(norm(body))
    assert len(mids) == 1
    mid = mids.pop()
    for device, (sock, plog) in pair.items():
        await sock.send(json.dumps({"cid": "j", "match_join": {"match_id": mid}}))
        rt.append(_sorted_presences(norm(await recv_until(sock, "match", plog))))
    await call("GET", "/v2/match?query=%2Blabel.arena%3Ajs", auth)
    for i, (device, (sock, plog)) in enumerate(pair.items()):
        await sock.send(json.dumps({"match_data_send": {
            "match_id": mid, "op_code": 3 + i,
            "data": base64.b64encode(device.encode()).decode()}}))
        rt.append(norm(await recv_until(sock, "match_data", plog)))
    await ws.send(json.dumps({"cid": "lua", "rpc": {"id": "lua_echo"}}))
    rt.append(norm(await recv_until(ws, "cid", log)))
    for sock, plog in pair.values():
        rt.append([norm(e) for e in plog if "match_presence_event" not in e])
        await sock.close()
    # Events are queued: read the module's counts once the event and the
    # pair's session ends are in.
    await ws.send(json.dumps({"cid": "counts", "rpc": {"id": "counts"}}))
    for _ in range(200):
        env = await recv_until(ws, "cid", [])
        counts = json.loads(env["rpc"]["payload"])
        if counts["events"] and counts["session_end"] >= 2:
            break
        await asyncio.sleep(0.01)
        await ws.send(json.dumps({"cid": "counts", "rpc": {"id": "counts"}}))
    rt.append(norm(counts))


# The social and IAP routes (27), answered by the server's social client
# and `Purchases` (501 on the port before these slices).
PROVIDER_ROUTES = (
    [("POST", f"/v2/account/authenticate/{p}") for p in SOCIAL]
    + [("POST", f"/v2/account/{kind}/{p}") for kind in ("link", "unlink")
       for p in SOCIAL]
    + [("POST", "/v2/friend/facebook"), ("POST", "/v2/friend/steam")]
    + [("POST", f"/v2/iap/purchase/{s}") for s in ("apple", "google", "huawei")]
    + [("GET", "/v2/iap/subscription"), ("POST", "/v2/iap/subscription/apple"),
       ("POST", "/v2/iap/subscription/google"),
       ("GET", "/v2/iap/subscription/{original_transaction_id}")]
)


def social_account(provider: str, i: int) -> dict:
    """The credentials of player `i` for `provider` that the fakes
    accept (`provider_fakes.stub_social`)."""
    if provider == "facebookinstantgame":
        return {"signed_player_info": F.instant_info(f"ig-{i}")}
    if provider == "gamecenter":
        return {**F.gamecenter_account(f"gc-player-{i}"),
                "public_key_url": F.GAMECENTER_URL}
    return {"token": f"{provider}-token-{i}"}


async def providers_leg(server, norm, tokens, call) -> list:
    """Every social and IAP route through the same script on both
    servers: social sign-in (created, again, refused), link (taken,
    refused) and unlink for each provider, the friend imports, the
    purchases and subscriptions of the three stores (validated, seen
    before, refused, listed, read by owner), and the routes' answers
    with no receipt or session. Returns the status of each route the
    script reached."""
    devs = sorted(tokens)
    a, b = devs[:2]
    auth = {dv: bearer(tokens[dv][0]) for dv in devs}
    hit = []

    async def req(method, path, headers=None, body=None, route=None):
        status, payload = await call(method, path, headers, body)
        hit.append((route or path, status))
        if isinstance(payload, dict) and payload.get("token"):
            # A sign-in: name its user and a generated username.
            claims = port_token.parse("defaultencryptionkey", payload["token"])
            name = f"user:{path.rsplit('/', 1)[-1]}:{len(norm.names)}"
            if claims.user_id not in norm.names:
                norm.learn(claims.user_id, name)
                norm.learn(claims.username, name + ":username")
        return status, payload

    for p in SOCIAL:
        route = f"/v2/account/authenticate/{p}"
        await req("POST", route + "?username=", basic(),
                  {"account": social_account(p, 0)}, route)
        await req("POST", route, basic(), {"account": social_account(p, 0)})
        await req("POST", route + "?create=false", basic(),
                  {"account": social_account(p, 3)}, route)
        await req("POST", route, basic(), {"account": {"token": "bogus"}})
        await req("POST", route, basic("wrong"), {"account": social_account(p, 0)})
        link = f"/v2/account/link/{p}"
        await req("POST", link, auth[a], social_account(p, 1))
        await req("POST", link, auth[b], social_account(p, 1))
        await req("POST", link, auth[b], social_account(p, 0))
        await req("POST", link, auth[b], {"token": "bogus", "player_id": "x"})
        await req("POST", link, None, social_account(p, 2))
    await call("GET", "/v2/account", auth[a])
    for p in SOCIAL:
        await req("POST", f"/v2/account/unlink/{p}", auth[a], {})
    await call("GET", "/v2/account", auth[a])
    # Friend imports: the Facebook player's app friends (one of them
    # linked above), then Steam's (a steam account linked first).
    status, fb = await call("POST", "/v2/account/authenticate/facebook", basic(),
                            {"account": {"token": "facebook-token-0"}})
    fb_auth = bearer(fb["token"])
    await req("POST", "/v2/account/link/facebook", auth[b],
              {"token": "facebook-token-1"})
    await req("POST", "/v2/friend/facebook", fb_auth,
              {"account": {"token": "facebook-token-0"}})
    await req("POST", "/v2/friend/facebook", fb_auth, {"token": "bogus"})
    await req("POST", "/v2/friend/steam", auth[a], {})
    await req("POST", "/v2/account/link/steam", auth[b], {"token": "steam-token-1"})
    _, st = await call("POST", "/v2/account/authenticate/steam", basic(),
                       {"account": {"token": "steam-token-0"}})
    await req("POST", "/v2/friend/steam?reset=true", bearer(st["token"]), {},
              "/v2/friend/steam")
    await call("GET", "/v2/friend", fb_auth)
    await call("GET", "/v2/friend", bearer(st["token"]))
    # Purchases and subscriptions.
    for store, receipt, bad in (
        ("apple", F.apple_receipt(["t1", "t2"]), F.apple_receipt(["t3"], status=21003)),
        ("google", F.google_receipt("gems", "tok-1"), F.google_receipt("g", "bad-token")),
        ("huawei", F.huawei_receipt("coins", "hw-1"), F.huawei_receipt("c", "hw-bad")),
    ):
        path = f"/v2/iap/purchase/{store}"
        await req("POST", path, auth[a], {"receipt": receipt})
        await req("POST", path, auth[a], {"receipt": receipt})
        await req("POST", path, auth[b], {"purchase": receipt, "persist": False})
        await req("POST", path, auth[a], {"receipt": bad})
        await req("POST", path, auth[a], {})
        await req("POST", path, None, {"receipt": receipt})
    for store, receipt in (("apple", F.apple_receipt(["s1", "s2"])),
                           ("google", F.google_receipt("vip", "sub-tok"))):
        path = f"/v2/iap/subscription/{store}"
        await req("POST", path, auth[a], {"receipt": receipt})
        await req("POST", path, auth[b], {"receipt": receipt})
        await req("POST", path, auth[b], {"receipt": receipt, "persist": "false"})
        await req("POST", path, auth[a], {"receipt": ""})
    route = "/v2/iap/subscription/{original_transaction_id}"
    await req("GET", "/v2/iap/subscription/orig-s2", auth[a], None, route)
    await req("GET", "/v2/iap/subscription/sub-tok", auth[b], None, route)
    await req("GET", "/v2/iap/subscription/missing", auth[a], None, route)
    await req("GET", "/v2/iap/subscription?limit=1", auth[a], None,
              "/v2/iap/subscription")
    await req("GET", "/v2/iap/subscription", None)
    return hit


async def test_same_script_same_answers_as_the_jax_server(tmp_path):
    jax = await jax_server(tmp_path / "jax", runtime_dir(tmp_path / "jax-rt"))
    # Each server's Python module (the second load replaces the first in
    # sys.modules under the same name).
    jax_module = sys.modules["nakama_runtime_c_hooks"]
    try:
        want = await run_script(jax, "jax")
    finally:
        await jax.stop()
    jax_threads = set(threading.enumerate())
    port = await torch_server(
        tmp_path / "torch", runtime_dir(tmp_path / "torch-rt"))
    port_module = sys.modules["nakama_runtime_c_hooks"]
    assert port_module is not jax_module
    try:
        got = await run_script(port, "torch")
    finally:
        await port.stop()
    assert got["http"] == want["http"]
    assert got["logout_close"] == want["logout_close"] == (4001, "session not valid")
    assert got["status_follow"] == want["status_follow"]
    assert got["ws"] == want["ws"]
    assert got["matched"] == want["matched"]
    assert len(got["matched"]) == 8
    assert got["claims"] == want["claims"]
    assert got["pool_after"] == want["pool_after"]
    assert got["channel_join"] == want["channel_join"] == {
        "code": 3, "message": "invalid channel type"}
    assert got["play"] == want["play"]
    relays = [p for p in got["play"] if isinstance(p, dict) and "match_data" in p]
    assert len(relays) == 4 + 2  # each pair's relay, the echo to both
    assert got["play"][-1] == 0  # the closed party's ticket left the pool
    # The runtime: rpcs, hooks, the matched hook's JS match and its echo.
    assert got["runtime"] == want["runtime"]
    echoes = [e["match_data"] for e in got["runtime"]
              if isinstance(e, dict) and "match_data" in e]
    # Each player's data back to it alone, op_code + 1 (a broadcast with
    # no sender).
    assert [(e["op_code"], base64.b64decode(e["data"])) for e in echoes] == [
        (4, b"device-rt-a"), (5, b"device-rt-b")]
    # The modules' counts after the stop: every session's start and end,
    # the event, the after hooks, the shutdown hook once.
    assert port_module.COUNTS == jax_module.COUNTS
    counts = port_module.COUNTS
    # (after_auth: the script's two successful custom authenticates
    # before the runtime leg's two.)
    assert counts["shutdown"] == 1 and counts["after_auth"] == 4
    assert counts["after_update"] == 2
    assert counts["session_start"] == counts["session_end"] == 12
    assert [e[0] for e in counts["events"]] == ["rt-evt"]
    # The port stops its guest modules' worker threads (the JAX server's
    # stay until the process exits: ROADMAP.md §C).
    assert not [t for t in threading.enumerate() if t not in jax_threads
                and t.name.startswith(("lua-", "js-"))]
    # The social and IAP routes: all 27 reached, none answered 501, the
    # same statuses (the bodies are in `http`).
    assert got["providers"] == want["providers"]
    reached = {(m, p) for m, p in PROVIDER_ROUTES
               if any(r == p for r, _ in got["providers"])}
    assert len(PROVIDER_ROUTES) == len(reached) == 27
    assert not [r for r in got["providers"] if r[1] == 501]
    assert {200, 400, 401, 404, 409} <= {st for _, st in got["providers"]}
    # The scrapes: the same families and the same unlabeled series
    # (values differ with each server's own components and timings, and
    # labeled series appear with the backend's activity: the JAX
    # server's host oracle records no device transfers).
    assert set(got["metrics"][0]) == set(want["metrics"][0])
    unlabeled = [{s[0] for s in m["metrics"][2] if not s[1]} for m in (got, want)]
    assert unlabeled[0] == unlabeled[1]
    assert "nakama_matchmaker_tickets" in unlabeled[0]


def test_check_and_parse_args_agree_on_the_shared_sections():
    shared = [
        "logger", "metrics", "session", "socket", "database", "matchmaker",
        "match", "tracker", "runtime", "console", "leaderboard", "overload",
        "tracing", "recovery", "devobs", "iap", "social", "satori",
    ]
    argv = [
        "--name", "node-7", "--data_dir", "/tmp/x", "--shutdown_grace_sec", "5",
        "--logger.format", "logfmt", "--metrics.prometheus_port", "-1",
        "--session.token_expiry_sec", "120", "--socket.port", "0",
        "--socket.grpc_port", "7349",
        "--socket.max_message_size_bytes", "8192",
        "--database.address", "a.db,b.db", "--matchmaker.interval_sec", "1",
        "--matchmaker.backend", "cpu", "--tracker.event_queue_size", "64", "--overload.rate_limit_rps", "2.5",
        "--tracing.sample_rate", "1.5", "--recovery.checkpoint_interval_sec", "9",
        "--devobs.warmup_intervals", "1", "--match.input_queue_size", "64",
        "--match.max_empty_sec", "30", "--session.single_match", "true",
        "--leaderboard.blacklist_rank_cache", "a,b",
        "--leaderboard.device_min_board_size", "100",
        "--leaderboard.device_flush_interval_sec", "0.5",
        "--runtime.path", "/tmp/modules", "--runtime.env", "a=1,b=x",
        "--runtime.http_key", "k2", "--runtime.event_queue_workers", "2",
        "--console.port", "7400", "--console.username", "ops",
        "--devobs.capture_max_ms", "2500",
        "--iap.google_refund_poll_sec", "60", "--iap.apple_shared_password", "pw",
        "--social.steam_app_id", "480", "--satori.url", "https://s.test",
    ]
    port = port_config.parse_args(argv)
    jax = jax_config.parse_args(argv)
    pd = port_config.config_to_dict(port)
    jd = jax_config.config_to_dict(jax)
    assert pd["socket"]["grpc_port"] == jd["socket"]["grpc_port"] == 7349
    for name in ("name", "data_dir", "shutdown_grace_sec"):
        assert pd[name] == jd[name]
    for section in shared:
        common = set(pd[section]) & set(jd[section])
        assert {k: pd[section][k] for k in common} == {
            k: jd[section][k] for k in common}
        # The port adds no field of its own; the JAX fields it drops
        # are the ones its config docstring names.
        assert set(pd[section]) <= set(jd[section])
    assert port.check() == jax.check()
    for capture in (["--devobs.capture_max_ms", "60001"],
                    ["--console.password", "s3cret"]):
        assert port_config.parse_args(capture).check() == (
            jax_config.parse_args(capture).check())
    for bad in (["--name", "a.b"], ["--matchmaker.interval_sec", "0"],
                ["--socket.port", "7351"]):
        with pytest.raises(ValueError) as p_err:
            port_config.parse_args(bad).check()
        with pytest.raises(ValueError) as j_err:
            jax_config.parse_args(bad).check()
        assert str(p_err.value) == str(j_err.value)
    for bad in (["--cluster.enabled", "true"], ["--socket.prot", "1"]):
        with pytest.raises(ValueError, match="unknown config flag"):
            port_config.parse_args(bad)
    with pytest.raises(ValueError, match="expected an integer"):
        port_config.parse_args(["--socket.port", "x"])


def test_tokens_parse_across_packages():
    token, claims = port_token.generate("k", "u1", "name", 60, vars={"a": "b"})
    back = jax_token.parse("k", token)
    assert (back.user_id, back.username, back.vars, back.token_id) == (
        "u1", "name", {"a": "b"}, claims.token_id)
    token, claims = jax_token.generate("k", "u2", "n2", 60)
    assert port_token.parse("k", token).user_id == "u2"
    with pytest.raises(port_token.TokenError):
        port_token.parse("other", token)


# ------------------------------------------------- python -m, subprocess


def _start(tmp, extra=()):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO
    cmd = [
        sys.executable, "-X", "importtime", "-m", "nakama_tpu_torch",
        "--matchmaker.backend", "cpu", "--socket.port", "0",
        "--matchmaker.interval_sec", "1", "--matchmaker.pool_capacity", "2048",
        "--database.address", os.path.join(tmp, "server.db"),
        "--data_dir", tmp, "--logger.level", "info", *extra,
    ]
    # stderr (the -X importtime report, ~100 KB) goes to a file: a pipe
    # nobody reads while the server boots would block the child.
    err = open(os.path.join(tmp, f"stderr-{time.monotonic_ns()}.txt"), "w+")
    proc = subprocess.Popen(
        cmd, cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
    )
    proc.err_file = err
    return proc


def _stderr(proc) -> str:
    proc.err_file.seek(0)
    return proc.err_file.read()


def _boot_lines(proc, until_msg: str, timeout: float = 60.0) -> list[dict]:
    """JSON log lines on stdout up to the one whose msg is `until_msg`
    (a thread reads the pipe, so no line waits in a buffer)."""
    if not hasattr(proc, "lines"):
        proc.lines = queue.Queue()

        def pump():
            for raw in proc.stdout:
                proc.lines.put(raw)
            proc.lines.put(None)

        threading.Thread(target=pump, daemon=True).start()
    lines = []
    end = time.monotonic() + timeout
    while True:
        try:
            raw = proc.lines.get(timeout=max(0.01, end - time.monotonic()))
        except queue.Empty:
            raw = None
        if raw is None:
            break
        try:
            rec = json.loads(raw)
        except ValueError:
            continue
        lines.append(rec)
        if rec.get("msg") == until_msg:
            return lines
    proc.kill()
    err = [ln for ln in _stderr(proc).splitlines()
           if not ln.startswith("import time:")]
    raise AssertionError(f"no {until_msg!r} line; stderr: {err[-30:]}")


def _stop(proc) -> tuple[int, str]:
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return proc.returncode, _stderr(proc)


# Packages the port must never import: JAX and the JAX package, and the
# libraries the JAX server needs that the card's machine lacks (PyYAML
# only when a --config file is given).
_FOREIGN = ("jax", "nakama_tpu", "aiohttp", "websockets", "google.protobuf",
            "prometheus_client", "grpc", "yaml", "cryptography")


def _foreign_imports(importtime: str) -> list[str]:
    bad = []
    for line in importtime.splitlines():
        if not line.startswith("import time:"):
            continue
        name = line.rsplit("|", 1)[-1].strip()
        if any(name == f or name.startswith(f + ".") for f in _FOREIGN):
            bad.append(name)
    return bad


async def _client(port, device):
    r = await wsproto.request(
        HOST, port, "POST", "/v2/account/authenticate/device", headers=basic(),
        body={"account": {"id": device}},
    )
    return await wsproto.connect(HOST, port, f"/ws?token={r.json()['token']}")


def test_python_m_serves_matches_and_recovers_on_restart(tmp_path):
    tmp = str(tmp_path)
    modules = runtime_dir(tmp_path / "modules")
    proc = _start(tmp, ("--runtime.path", str(modules)))
    try:
        lines = _boot_lines(proc, "server listening")
        port = lines[-1]["port"]
        loaded = [r for r in lines if r.get("msg") == "runtime modules loaded"]
        assert loaded and loaded[0]["modules"] == 3 and loaded[0]["rpcs"] == 7

        async def drive():
            # The runtime's Python, Lua and JS rpcs, by http_key.
            for rid in ("py_echo", "lua_echo", "js_echo"):
                r = await wsproto.request(
                    HOST, port, "POST",
                    f"/v2/rpc/{rid}?http_key=defaulthttpkey", body="hi")
                assert r.status == 200, r.body
                assert json.loads(r.json()["payload"])["payload"] == "hi"
            a = await _client(port, "device-sub-a1")
            b = await _client(port, "device-sub-b1")
            lonely = [await _client(port, f"device-sub-l{i}") for i in range(2)]
            for ws in (a, b):
                await ws.send(json.dumps({"matchmaker_add": {
                    "min_count": 2, "max_count": 2,
                    "query": "+properties.mode:duo",
                    "string_properties": {"mode": "duo"}}}))
            for i, ws in enumerate(lonely):
                await ws.send(json.dumps({"matchmaker_add": {
                    "min_count": 2, "max_count": 2,
                    "query": f"+properties.mode:none{i}",
                    "string_properties": {"mode": f"alone{i}"}}}))
            for ws in (a, b, *lonely):
                await recv_until(ws, "matchmaker_ticket", [])
            got = [await recv_until(ws, "matchmaker_matched", [], timeout=20)
                   for ws in (a, b)]
            return got, (a, b, *lonely)

        async def first_leg():
            got, sockets = await drive()
            proc.send_signal(signal.SIGTERM)
            closes = []
            for ws in sockets[2:]:
                with pytest.raises(wsproto.ConnectionClosed) as e:
                    while True:
                        await asyncio.wait_for(ws.recv(), 20)
                closes.append(e.value.code)
            return got, closes

        got, closes = asyncio.run(first_leg())
        assert len(got) == 2
        assert {u["presence"]["username"] for u in
                got[0]["matchmaker_matched"]["users"]} == {
            u["presence"]["username"] for u in got[1]["matchmaker_matched"]["users"]}
        assert closes == [1012, 1012]
        proc.wait(timeout=60)
        err = _stderr(proc)
        assert proc.returncode == 0, err[-2000:]
        assert _foreign_imports(err) == []
        assert "nakama_tpu_torch.server" in err  # importtime did record
    finally:
        if proc.poll() is None:
            proc.kill()
    proc = _start(tmp)
    try:
        lines = _boot_lines(proc, "server listening")
        boot = [r for r in lines if r.get("msg") == "crash recovery enabled"]
        assert boot and boot[0]["recovered_tickets"] == 2
        assert boot[0]["held_tickets"] == 2
        code, err = _stop(proc)
        assert code == 0, err[-2000:]
        assert _foreign_imports(err) == []
    finally:
        if proc.poll() is None:
            proc.kill()


async def test_rpc_without_a_runtime_answers_as_the_jax_server(tmp_path):
    """No module loaded: `/v2/rpc` is 501 "runtime not loaded", the
    socket's `rpc` is BAD_INPUT "runtime not available", `/v2/event`
    answers `{}`, as on the JAX server."""
    answers = []
    for make, name in ((jax_server, "jax"), (torch_server, "torch")):
        server = await make(tmp_path / name)
        try:
            got = []
            r = await wsproto.request(
                HOST, server.port, "POST", "/v2/account/authenticate/device",
                headers=basic(), body={"account": {"id": "device-no-runtime"}})
            token = r.json()["token"]
            for method, path, body in (
                ("POST", "/v2/rpc/x", "p"), ("GET", "/v2/rpc/x?payload=p", None),
                ("POST", "/v2/rpc/x?http_key=defaulthttpkey", "p"),
                ("POST", "/v2/event", {"name": "e"}),
            ):
                r = await wsproto.request(HOST, server.port, method, path,
                                          headers=bearer(token), body=body)
                got.append((method, path, r.status, r.json()))
            ws = await wsproto.connect(HOST, server.port, f"/ws?token={token}")
            await ws.send(json.dumps({"cid": "r", "rpc": {"id": "x"}}))
            got.append(await recv_until(ws, "cid", []))
            await ws.close()
            answers.append(got)
        finally:
            await server.stop()
    assert answers[0] == answers[1]
    assert answers[1][0][2:] == (501, {"error": "runtime not loaded",
                                       "message": "runtime not loaded",
                                       "code": 12})
    assert answers[1][-1] == {"cid": "r", "error": {
        "code": 3, "message": "runtime not available"}}


async def test_a_graceful_stop_keeps_connected_players_tickets(tmp_path):
    """Difference by design (ROADMAP.md §C): a stop closes each session
    with 1012 (kind "shutdown"); the JAX acceptor's close path removes
    the session's tickets, so the final checkpoint and the restart have
    lost every connected player's ticket. The port keeps them and its
    restart holds them out of the pool: a live player is not matched
    with a held ticket, a player who comes back gets their ticket again
    under the new session and is told of its match, and what nobody
    claims is released. The JAX server's sessions are closed as `stop()`
    closes them, before the stop itself: over aiohttp, a JAX stop with a
    live socket first waits out its listener's shutdown."""
    add = {"matchmaker_add": {
        "min_count": 2, "max_count": 2, "query": "+properties.mode:x",
        "string_properties": {"mode": "x"}}}

    async def player(server, device):
        r = await wsproto.request(
            HOST, server.port, "POST", "/v2/account/authenticate/device",
            headers=basic(), body={"account": {"id": device}},
        )
        return await wsproto.connect(
            HOST, server.port, f"/ws?token={r.json()['token']}")

    recovered, pooled, servers = {}, {}, {}
    for name, make, parse_args in (
        ("jax", lambda c: JaxServer(c, quiet_logger()), jax_config.parse_args),
        ("torch", lambda c: NakamaServer(c, port_logger()), port_config.parse_args),
    ):
        data = tmp_path / name
        data.mkdir()
        cfg = parse_args(FLAGS + [
            "--matchmaker.backend", "cpu", "--data_dir", str(data),
            "--database.address", str(data / "server.db"),
        ])
        server = make(cfg)
        await server.start()
        try:
            sockets = [await player(server, f"device-stop-{name}-{i}")
                       for i in range(2)]
            tickets = []
            for ws in sockets:
                await ws.send(json.dumps(add))
                ack = await recv_until(ws, "matchmaker_ticket", [])
                tickets.append(ack["matchmaker_ticket"]["ticket"])
            assert len(server.matchmaker) == 2
            if name == "jax":
                for session in server.session_registry.all():
                    await session.close(
                        "server shutting down", code=1012, kind="shutdown",
                        retry_after_sec=3.0,
                    )
        finally:
            await server.stop()
        for ws in sockets:
            with pytest.raises(wsproto.ConnectionClosed) as closed:
                while True:
                    await asyncio.wait_for(ws.recv(), 10)
            assert closed.value.code == 1012
        pooled[name] = len(server.matchmaker)
        again = make(cfg)
        await again.start()
        # The JAX server keeps no recover() result; its pool is all.
        recovered[name] = (
            again.recovered["tickets"] if name == "torch" else len(again.matchmaker))
        servers[name] = again
    try:
        assert pooled == recovered == {"jax": 0, "torch": 2}
        again = servers["torch"]
        held = again.recovery.held
        assert len(again.matchmaker) == 0 and held.ticket_ids() == set(tickets)
        assert again._release_held is not None
        # A live player whose ticket would match a held one stays
        # unmatched: the held player is not there.
        live = await player(again, "device-stop-live")
        await live.send(json.dumps(add))
        await recv_until(live, "matchmaker_ticket", [])
        assert len(again.matchmaker.process()) == 0
        # The first player comes back: their ticket returns under the new
        # session, and both are told of the match.
        back = await player(again, "device-stop-torch-0")
        assert len(again.matchmaker) == 2 and held.ticket_ids() == {tickets[1]}
        assert len(again.matchmaker.process()) == 1
        got = [await recv_until(ws, "matchmaker_matched", []) for ws in (live, back)]
        assert got[1]["matchmaker_matched"]["ticket"] == tickets[0]
        assert {u["presence"]["session_id"]
                for u in got[0]["matchmaker_matched"]["users"]} == {
            s.id for s in again.session_registry.all()}
        # The second player never comes back: the window's end drops it.
        held.release()
        assert len(held) == 0 and len(again.matchmaker) == 0
        await live.close()
        await back.close()
    finally:
        for server in servers.values():
            await server.stop()
    assert not os.path.exists(held.path)


@pytest.mark.parametrize("plane", ["overload", "recovery"])
async def test_a_server_without_the_plane_still_serves(tmp_path, plane):
    """`overload.enabled false` builds no admission, deadlines or ladder;
    `recovery.enabled false` no journal and no checkpoint. Either way
    the server authenticates, acknowledges and matches."""
    cfg = port_config.parse_args(FLAGS + [
        "--matchmaker.backend", "cpu", "--data_dir", str(tmp_path),
        "--database.address", str(tmp_path / "server.db"),
        f"--{plane}.enabled", "false",
    ])
    server = NakamaServer(cfg, port_logger())
    assert getattr(server, plane) is None
    await server.start()
    try:
        sockets = []
        for i in range(2):
            r = await wsproto.request(
                HOST, server.port, "POST", "/v2/account/authenticate/device",
                headers=basic(), body={"account": {"id": f"device-{plane}-{i}"}},
            )
            assert r.status == 200
            ws = await wsproto.connect(
                HOST, server.port, f"/ws?token={r.json()['token']}")
            await ws.send(json.dumps({"matchmaker_add": {
                "min_count": 2, "max_count": 2, "query": "*"}}))
            await recv_until(ws, "matchmaker_ticket", [])
            sockets.append(ws)
        assert len(server.matchmaker.process()) == 1
        for ws in sockets:
            await recv_until(ws, "matchmaker_matched", [])
            await ws.close()
    finally:
        await server.stop()
    assert (server.recovered is None) == (plane == "recovery")
    ckpts = [f for f in os.listdir(tmp_path) if f.endswith(".ckpt")]
    assert bool(ckpts) == (plane == "overload")


def test_cli_subcommands_answer_as_the_jax_cli(tmp_path, capsys):
    """`--version`, `check` and `migrate up|status` of `python -m
    nakama_tpu_torch` print what the JAX package's CLI prints (`check`
    with and without the console's default password)."""
    from nakama_tpu import __main__ as jax_main
    from nakama_tpu_torch import __main__ as port_main

    outputs = {}
    for name, cli in (("jax", jax_main), ("torch", port_main)):
        db = str(tmp_path / f"{name}.db")
        seen = []
        for argv in (
            ["--version"],
            ["check", "--socket.server_key", "k2", "--database.address", db,
             "--console.password", "pw2"],
            ["migrate", "status", "--database.address", db],
            ["migrate", "up", "--database.address", db],
            ["migrate", "status", "--database.address", db],
            ["check", "--socket.server_key", "k2", "--database.address", db],
        ):
            assert cli.main(argv) == 0
            seen.append(capsys.readouterr().out)
        outputs[name] = seen
    assert outputs["torch"] == outputs["jax"]
    assert "config ok (1 warnings)" in outputs["torch"][1]  # the session key
    assert "applied" in outputs["torch"][4] and "pending" in outputs["torch"][2]
    assert "console.password is the insecure default" in outputs["torch"][5]


def test_cuda_backend_without_a_card_raises_at_construction():
    """The server reaches stage 1 only through CudaBackend: with the
    default backend and no CUDA device, construction raises (no quiet
    fallback to the host oracle)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_config.parse_args(["--socket.port", "0"])
    assert cfg.matchmaker.backend == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        NakamaServer(cfg, port_logger())


def test_yaml_config_needs_pyyaml_only_when_given(tmp_path, monkeypatch):
    path = tmp_path / "c.yml"
    path.write_text("socket:\n  port: 7777\nmatchmaker:\n  backend: cpu\n")
    cfg = port_config.parse_args(["--config", str(path), "--socket.port", "7778"])
    assert (cfg.socket.port, cfg.matchmaker.backend) == (7778, "cpu")
    (tmp_path / "bad.yml").write_text("cluster:\n  enabled: true\n")
    with pytest.raises(ValueError, match="unknown config key: cluster"):
        port_config.parse_args(["--config", str(tmp_path / "bad.yml")])
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML absent
    with pytest.raises(RuntimeError, match="PyYAML"):
        port_config.parse_args(["--config", str(path)])
    assert port_config.parse_args(["--socket.port", "1"]).socket.port == 1


def test_setup_logging_writes_the_jax_formats(tmp_path, monkeypatch):
    from nakama_tpu import logger as jax_logger
    from nakama_tpu_torch import logger as port_log

    # The node name is process-wide, set by whichever server was built
    # last in this process: the same one for both packages here.
    for mod in (jax_logger, port_log):
        monkeypatch.setattr(mod, "_NODE_NAME", "node-log")
    lines = {}
    for name, mod, cfg_mod in (("jax", jax_logger, jax_config),
                               ("torch", port_log, port_config)):
        out = []
        for fmt in ("json", "logfmt", "stackdriver", "text"):
            path = tmp_path / f"{name}-{fmt}.log"
            cfg = cfg_mod.LoggerConfig(
                format=fmt, stdout=False, file=str(path), rotation=True,
                level="warn",
            )
            log = mod.setup_logging(cfg)
            log.info("dropped")
            log.with_fields(subsystem="t").warn("kept", n=1, s="a b")
            for line in path.read_text().splitlines():
                out.append(re.sub(r'("ts": |ts=|"timestamp": ")[0-9T:.+\-]+', "TS", line))
        lines[name] = out
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 4


# ---------------------------------------------- held tickets (ROADMAP §C)


async def _player(server, device):
    r = await wsproto.request(
        HOST, server.port, "POST", "/v2/account/authenticate/device",
        headers=basic(), body={"account": {"id": device}},
    )
    return await wsproto.connect(
        HOST, server.port, f"/ws?token={r.json()['token']}")


def _held_cfg(data, extra=()):
    return port_config.parse_args(FLAGS + [
        "--matchmaker.backend", "cpu", "--data_dir", str(data),
        "--database.address", str(data / "server.db"), *extra,
    ])


async def _stop_with_tickets(cfg, adds) -> list[str]:
    """A server whose players each add one ticket (device, query),
    stopped gracefully with the players still connected."""
    server = NakamaServer(cfg, port_logger())
    await server.start()
    tickets = []
    try:
        for device, mode in adds:
            ws = await _player(server, device)
            await ws.send(json.dumps({"matchmaker_add": {
                "min_count": 2, "max_count": 2,
                "query": f"+properties.mode:{mode}",
                "string_properties": {"mode": f"not-{mode}"}}}))
            ack = await recv_until(ws, "matchmaker_ticket", [])
            tickets.append(ack["matchmaker_ticket"]["ticket"])
    finally:
        await server.stop()
    return tickets


async def test_held_tickets_survive_a_sigkill_during_the_hold(tmp_path):
    """A SIGKILL while a restart holds its players' tickets loses none
    of them: the next start holds the same tickets again, for what
    remains of the window (the held-tickets file stays until every
    ticket is reowned or released)."""
    tickets = await _stop_with_tickets(
        _held_cfg(tmp_path), [("device-hold-0", "a"), ("device-hold-1", "b")])
    held_file = tmp_path / "nakama-tpu-held-tickets.json"
    assert held_file.exists()
    proc = _start(str(tmp_path), ["--matchmaker.max_intervals", "30"])
    try:
        lines = _boot_lines(proc, "server listening")
        boot = [r for r in lines if r.get("msg") == "crash recovery enabled"]
        assert boot[0]["held_tickets"] == 2
        t_hold = time.time()
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    again = NakamaServer(_held_cfg(tmp_path), port_logger())
    await again.start()
    try:
        held = again.recovery.held
        assert held.ticket_ids() == set(tickets)
        assert len(again.matchmaker) == 0
        # The window began at the killed start: 30 intervals of 1 s.
        assert 0 < held.remaining_s() <= 30 - (time.time() - t_hold) + 1
        back = await _player(again, "device-hold-0")
        assert held.ticket_ids() == {tickets[1]}
        assert [t.ticket for t in again.matchmaker.store.session_tickets(
            again.session_registry.all()[0].id)] == [tickets[0]]
        await back.close()
    finally:
        await again.stop()


async def test_a_returning_player_stays_within_max_tickets(tmp_path):
    """`max_tickets` holds for tickets handed back after a restart: the
    player who returns and adds again has one ticket in the pool and
    gets the answer a JAX session at its quota gets."""
    add = {"cid": "again", "matchmaker_add": {
        "min_count": 2, "max_count": 2, "query": "+properties.mode:q",
        "string_properties": {"mode": "z"}}}
    data = tmp_path / "jax"
    data.mkdir()
    jax = JaxServer(jax_config.parse_args(FLAGS + [
        "--matchmaker.backend", "cpu", "--data_dir", str(data),
        "--matchmaker.max_tickets", "1"]), quiet_logger())
    await jax.start()
    try:
        ws = await _player(jax, "device-quota-0")
        for _ in range(2):
            await ws.send(json.dumps(add))
        want = await recv_until(ws, "error", [])
        # The error names the session at its quota.
        assert want["error"]["message"] == jax.session_registry.all()[0].id
        want["error"]["message"] = "<session>"
        await ws.close()
    finally:
        await jax.stop()
    data = tmp_path / "torch"
    data.mkdir()
    cfg = _held_cfg(data, ["--matchmaker.max_tickets", "1"])
    # The player's ticket was added from two devices before the stop.
    tickets = await _stop_with_tickets(
        cfg, [("device-quota-0", "q"), ("device-quota-0", "r")])
    again = NakamaServer(cfg, port_logger())
    await again.start()
    try:
        assert again.recovery.held.ticket_ids() == set(tickets)
        ws = await _player(again, "device-quota-0")
        await ws.send(json.dumps(add))
        got = await recv_until(ws, "error", [])
        session = again.session_registry.all()[0]
        assert got["error"]["message"] == session.id
        got["error"]["message"] = "<session>"
        pooled = again.matchmaker.store.session_tickets(session.id)
        assert len(pooled) == 1 and pooled[0].ticket in tickets
        assert len(again.recovery.held) == 0
        await ws.close()
    finally:
        await again.stop()
    assert got == want

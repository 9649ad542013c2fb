"""The port's admin console (`nakama_tpu_torch/console/`, on the port's
`wsproto` HttpServer) held against the JAX package's (on `aiohttp`).
One console script runs against each server's console listener, the
port's server over `CudaBackend(device="cpu")` and its
`DeviceRankEngine(device="cpu")`, the JAX server over its device
backend and rank engine on CPU JAX, and the status codes and bodies
must be equal once random ids, times and tokens are normalised, group
by group: auth, lockout and roles; status, config redaction and
runtime; accounts; storage and its import; groups and members; channel
browse and deletes; leaderboards and records (ranks from the rank
engines); the matchmaker view; the endpoint list and call; purchases
and subscriptions (validated through one store fetcher,
`provider_fakes`) and the routes of components the port has not ported
yet (cluster, fleet and soak `{"enabled": false}` on both); the bulk
wipes. The config view compares the sections and fields
the port has. On the port alone: the device view lists the `torch`
devices, a capture on the CPU writes a `torch.profiler` trace (one at a
time, clamped, refused to read-only users), and the static page names
every console route.

Stated tolerance: none — every compared value must be equal."""

import asyncio
import base64
import glob
import json
import os
import re

import pytest

import provider_fakes as F
from fixtures import quiet_logger

from nakama_tpu import config as jax_config
from nakama_tpu.matchmaker.tpu import TpuBackend
from nakama_tpu.server import NakamaServer as JaxServer
from nakama_tpu_torch import config as port_config
from nakama_tpu_torch import tracing as port_tracing
from nakama_tpu_torch.api import wsproto
from nakama_tpu_torch.console import server as console_module
from nakama_tpu_torch.console.ui import PAGE
from nakama_tpu_torch.logger import test_logger as port_logger
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from nakama_tpu_torch.server import NakamaServer

HOST = "127.0.0.1"
FLAGS = [
    "--socket.port", "0", "--metrics.prometheus_port", "0",
    "--matchmaker.interval_sec", "100",
    "--matchmaker.interval_pipelining", "false",
    "--matchmaker.pool_capacity", "2048",
    "--matchmaker.candidates_per_ticket", "8",
    "--matchmaker.numeric_fields", "8", "--matchmaker.string_fields", "8",
    "--matchmaker.big_pool_threshold", "1000000",
    "--leaderboard.device_min_board_size", "0",
    "--leaderboard.device_flush_dirty_threshold", "1",
    "--devobs.capture_max_ms", "300",
]
_ID = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}(\.[\w-]+)?")
TIME_KEYS = {"create_time", "update_time", "disable_time", "uptime_sec",
             "edge_count_time", "expiry_time", "ts", "start_time",
             "end_time"}
GROUPS = ("auth", "status", "accounts", "storage", "groups", "channels",
          "leaderboards", "matchmaker", "explorer", "later", "wipe")


def init_module(ctx, logger, nk, initializer):
    initializer.register_rpc("console_echo", lambda c, payload: "echo:" + payload)


class Ids:
    """Random ids named by first appearance; times and tokens masked."""

    def __init__(self):
        self.names: dict[str, str] = {}

    def __call__(self, obj):
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                if k in ("token", "refresh_token") and isinstance(v, str):
                    out[k] = "<token>"
                elif k in TIME_KEYS and v:
                    out[k] = "<time>"
                elif k == "purchase_time" and isinstance(v, float) and v > 1.75e9:
                    # A subscription row's: the clock's (a store's own
                    # purchase times stay).
                    out[k] = "<time>"
                elif k in ("next_cursor", "prev_cursor") and "|" in v:
                    out[k] = "<time>|" + self(v.split("|", 1)[1])
                else:
                    out[k] = self(v)
            return out
        if isinstance(obj, list):
            return [self(v) for v in obj]
        if isinstance(obj, str):
            return _ID.sub(
                lambda m: self.names.setdefault(
                    m.group(0), f"<id{len(self.names)}>"), obj)
        return obj


class Script:
    """One console script against one server: every answer kept under
    its group and step name."""

    def __init__(self, server):
        self.server = server
        self.out: dict[str, dict] = {g: {} for g in GROUPS}
        self.group = ""
        self.admin = ""

    async def http(self, port, method, path, body=None, token=None,
                   headers=None):
        h = dict(headers or {})
        if token:
            h["Authorization"] = f"Bearer {token}"
        r = await wsproto.request(HOST, port, method, path, headers=h, body=body)
        try:
            parsed = json.loads(r.body) if r.body else None
        except ValueError:
            parsed = r.body.decode(errors="replace")
        return r.status, parsed

    async def call(self, name, method, path, body=None, token="<admin>",
                   keep=True):
        """A console request, kept under `name` in the current group."""
        token = self.admin if token == "<admin>" else token
        status, parsed = await self.http(
            self.server.console_port, method, path, body, token)
        if keep:
            self.out[self.group][name] = [status, parsed]
        return status, parsed

    async def api(self, method, path, body=None, token=None, basic=False):
        headers = None
        if basic:
            headers = {"Authorization": "Basic " + base64.b64encode(
                b"defaultkey:").decode()}
        return await self.http(self.server.port, method, path, body, token,
                               headers)

    async def device_user(self, device, username):
        status, body = await self.api(
            "POST", f"/v2/account/authenticate/device?username={username}",
            {"account": {"id": device}}, basic=True)
        assert status == 200, body
        token = body["token"]
        status, acct = await self.api("GET", "/v2/account", token=token)
        return acct["user"]["id"], token


async def run_script(server) -> dict:
    s = Script(server)
    call = s.call

    # ---------------------------------------------------- auth and roles
    s.group = "auth"
    await call("no_token", "GET", "/v2/console/status", token="")
    await call("garbage_token", "GET", "/v2/console/status", token="x.y.z")
    await call("bad_password", "POST", "/v2/console/authenticate",
               {"username": "admin", "password": "wrong"}, token="")
    await call("bad_body", "POST", "/v2/console/authenticate", "not json",
               token="")
    status, body = await call("login", "POST", "/v2/console/authenticate",
                              {"username": "admin", "password": "password"},
                              token="")
    s.admin = body["token"]
    await call("viewer_create", "POST", "/v2/console/user",
               {"username": "viewer", "password": "longenough", "role": 4})
    await call("viewer_again", "POST", "/v2/console/user",
               {"username": "viewer", "password": "longenough", "role": 4})
    await call("short_password", "POST", "/v2/console/user",
               {"username": "v2", "password": "short"})
    await call("bad_role", "POST", "/v2/console/user",
               {"username": "v3", "password": "longenough", "role": 9})
    await call("maintainer_create", "POST", "/v2/console/user",
               {"username": "maint", "password": "longenough", "role": 3})
    _, body = await call("viewer_login", "POST", "/v2/console/authenticate",
                         {"username": "viewer", "password": "longenough"},
                         token="")
    viewer = body["token"]
    _, body = await call("maint_login", "POST", "/v2/console/authenticate",
                         {"username": "maint", "password": "longenough"},
                         token="")
    maint = body["token"]
    await call("viewer_reads", "GET", "/v2/console/runtime", token=viewer)
    await call("viewer_write", "POST", "/v2/console/storage",
               {"collection": "x", "key": "y", "value": {}}, token=viewer)
    await call("viewer_user_create", "POST", "/v2/console/user",
               {"username": "v4", "password": "longenough"}, token=viewer)
    await call("maint_user_create", "POST", "/v2/console/user",
               {"username": "v5", "password": "longenough"}, token=maint)
    await call("users", "GET", "/v2/console/user")
    await call("viewer_logout", "POST", "/v2/console/authenticate/logout",
               token=viewer)
    await call("revoked", "GET", "/v2/console/runtime", token=viewer)
    for n in range(7):
        await call(f"lockout_{n}", "POST", "/v2/console/authenticate",
                   {"username": "locker", "password": "wrong"}, token="")
    await call("user_delete", "DELETE", "/v2/console/user/maint")
    await call("user_delete_missing", "DELETE", "/v2/console/user/maint")
    await call("not_found", "GET", "/v2/console/nope")
    await call("wrong_method", "PUT", "/v2/console/status")

    # --------------------------------------- status, config and runtime
    s.group = "status"
    _, body = await call("status", "GET", "/v2/console/status", keep=False)
    body.pop("slo_burn_rates")  # burn rates of the requests so far
    s.out["status"]["status"] = [200, body]
    await call("runtime", "GET", "/v2/console/runtime")
    _, body = await call("overload", "GET", "/v2/console/overload",
                         keep=False)
    s.out["status"]["overload"] = [200, {k: body[k] for k in ("enabled",)}]
    _, body = await call("traces", "GET", "/v2/console/traces?n=4",
                         keep=False)
    s.out["status"]["traces"] = sorted(body)
    await call("traces_bad_n", "GET", "/v2/console/traces?n=x")
    await call("trace_missing", "GET", "/v2/console/traces/abc")
    _, config = await call("config", "GET", "/v2/console/config", keep=False)
    s.out["status"]["config"] = config
    status, page = await s.http(server.console_port, "GET", "/")
    s.out["status"]["ui"] = [status, "nakama-tpu console" in page]

    # ---------------------------------------------------------- accounts
    s.group = "accounts"
    alice, alice_tok = await s.device_user("device-console-alice", "alice")
    bob, bob_tok = await s.device_user("device-console-bob", "bob")
    carol, carol_tok = await s.device_user("device-console-carol", "carol")
    await call("list_filter", "GET", "/v2/console/account?filter=ali")
    await call("list", "GET", "/v2/console/account?limit=10")
    await call("get", "GET", f"/v2/console/account/{alice}")
    await call("get_missing", "GET", "/v2/console/account/nobody")
    await call("update", "POST", f"/v2/console/account/{alice}",
               {"display_name": "Alice A", "metadata": {"tier": "gold"},
                "wallet": {"coins": 250}})
    await call("update_missing", "POST", "/v2/console/account/nobody",
               {"display_name": "x"})
    await call("update_bad_wallet", "POST", f"/v2/console/account/{alice}",
               {"wallet": [1]})
    await call("update_bad_body", "POST", f"/v2/console/account/{alice}",
               "nope")
    await call("get_after", "GET", f"/v2/console/account/{alice}")
    await server.wallets.update_wallets(
        [{"user_id": alice, "changeset": {"coins": 10},
          "metadata": {"why": "console"}}])
    _, wallet = await call("wallet", "GET",
                           f"/v2/console/account/{alice}/wallet")
    _, ledger = await call("ledger", "GET",
                           f"/v2/console/account/{alice}/walletledger")
    ledger_id = ledger["items"][0]["id"]
    await call("ledger_delete", "DELETE",
               f"/v2/console/account/{alice}/walletledger/{ledger_id}")
    await call("ledger_delete_again", "DELETE",
               f"/v2/console/account/{alice}/walletledger/{ledger_id}")
    await call("ban", "POST", f"/v2/console/account/{bob}/ban")
    s.out["accounts"]["banned_auth"] = (await s.api(
        "POST", "/v2/account/authenticate/device",
        {"account": {"id": "device-console-bob"}}, basic=True))[0]
    await call("banned_get", "GET", f"/v2/console/account/{bob}")
    await call("unban", "POST", f"/v2/console/account/{bob}/unban")
    s.out["accounts"]["unbanned_auth"] = (await s.api(
        "POST", "/v2/account/authenticate/device",
        {"account": {"id": "device-console-bob"}}, basic=True))[0]
    await call("export", "GET", f"/v2/console/account/{alice}/export")
    await call("export_missing", "GET", "/v2/console/account/nobody/export")
    await s.api("POST", f"/v2/friend?ids={bob}", token=alice_tok)
    await call("friends", "GET", f"/v2/console/account/{alice}/friend")
    await call("friend_delete", "DELETE",
               f"/v2/console/account/{alice}/friend/{bob}")
    await call("friends_after", "GET", f"/v2/console/account/{alice}/friend")
    await call("unlink_email_none", "POST",
               f"/v2/console/account/{carol}/unlink/email")
    await s.api("POST", "/v2/account/link/email",
                {"email": "carol@example.com", "password": "longenough"},
                token=carol_tok)
    await call("unlink_email", "POST",
               f"/v2/console/account/{carol}/unlink/email")
    await s.api("POST", "/v2/account/link/custom", {"id": "carol-custom-id"},
                token=carol_tok)
    await call("unlink_device_no_id", "POST",
               f"/v2/console/account/{carol}/unlink/device")
    await call("unlink_device", "POST",
               f"/v2/console/account/{carol}/unlink/device",
               {"device_id": "device-console-carol"})
    await call("unlink_custom_last", "POST",
               f"/v2/console/account/{carol}/unlink/custom")
    await call("unlink_unknown", "POST",
               f"/v2/console/account/{carol}/unlink/myspace")
    await call("get_carol", "GET", f"/v2/console/account/{carol}")
    await call("delete", "DELETE", f"/v2/console/account/{carol}")
    await call("get_deleted", "GET", f"/v2/console/account/{carol}")
    await call("list_after", "GET", "/v2/console/account")

    # ----------------------------------------------------------- storage
    s.group = "storage"
    await call("write_system", "POST", "/v2/console/storage",
               {"collection": "cfg", "key": "motd", "user_id": "",
                "value": {"text": "hi"}})
    await call("write_user", "POST", "/v2/console/storage",
               {"collection": "saves", "key": "s1", "user_id": alice,
                "value": '{"hp": 3}', "permission_read": 2})
    await call("write_bad", "POST", "/v2/console/storage",
               {"collection": "", "key": "", "value": {}})
    await call("write_bad_body", "POST", "/v2/console/storage", [1])
    await call("list_cfg", "GET", "/v2/console/storage?collection=cfg")
    await call("list_user", "GET", f"/v2/console/storage?user_id={alice}")
    await call("get", "GET", f"/v2/console/storage/saves/s1/{alice}")
    await call("get_missing", "GET", f"/v2/console/storage/saves/s9/{alice}")
    rows = [{"collection": "imp", "key": f"k{i}", "user_id": alice,
             "value": {"i": i}, "permission_read": i % 3}
            for i in range(4)]
    await call("import_json", "POST", "/v2/console/storage/import",
               json.dumps(rows).encode())
    csv_text = ("collection,key,user_id,value,permission_read\n"
                f"impcsv,a,{alice},\"{{\"\"x\"\": 1}}\",0\n"
                f"impcsv,b,{bob},\"{{\"\"x\"\": 2}}\",\n")
    await call("import_csv", "POST", "/v2/console/storage/import",
               csv_text.encode())
    await call("import_object", "POST", "/v2/console/storage/import",
               b'{"collection": "x"}')
    await call("import_non_objects", "POST", "/v2/console/storage/import",
               b"[1, 2]")
    await call("import_empty", "POST", "/v2/console/storage/import",
               b"collection,key\n")
    await call("import_bad_json", "POST", "/v2/console/storage/import",
               b"[{")
    await call("import_bad_perm", "POST", "/v2/console/storage/import",
               json.dumps([{"collection": "y", "key": "z",
                            "permission_read": "x"}]).encode())
    await call("list_imp", "GET", "/v2/console/storage?collection=imp&limit=2")
    await call("list_impcsv", "GET", "/v2/console/storage?collection=impcsv")
    await call("collections", "GET", "/v2/console/storage/collections")
    await call("delete", "DELETE", f"/v2/console/storage/imp/k0/{alice}")
    await call("list_imp_after", "GET", "/v2/console/storage?collection=imp")
    await call("delete_all", "DELETE", "/v2/console/storage")
    await call("collections_after", "GET", "/v2/console/storage/collections")

    # ------------------------------------------------------------ groups
    s.group = "groups"
    _, group = await s.api("POST", "/v2/group",
                           {"name": "guild", "open": True}, token=alice_tok)
    gid = group["id"]
    await call("list", "GET", "/v2/console/group")
    await call("list_named", "GET", "/v2/console/group?name=gui")
    await call("get", "GET", f"/v2/console/group/{gid}")
    await call("get_missing", "GET", "/v2/console/group/nogroup")
    await call("update", "POST", f"/v2/console/group/{gid}",
               {"description": "edited", "max_count": 50})
    await call("update_bad_body", "POST", f"/v2/console/group/{gid}", "x")
    await call("get_after", "GET", f"/v2/console/group/{gid}")
    await call("add_none", "POST", f"/v2/console/group/{gid}/member",
               {"user_ids": []})
    await call("add", "POST", f"/v2/console/group/{gid}/member",
               {"user_ids": [bob]})
    await call("members", "GET", f"/v2/console/group/{gid}/member")
    await call("promote", "POST",
               f"/v2/console/group/{gid}/member/{bob}/promote")
    await call("members_promoted", "GET", f"/v2/console/group/{gid}/member")
    await call("demote", "POST", f"/v2/console/group/{gid}/member/{bob}/demote")
    await call("export", "GET", f"/v2/console/group/{gid}/export")
    await call("account_groups", "GET", f"/v2/console/account/{bob}/group")
    await call("kick", "DELETE", f"/v2/console/group/{gid}/member/{bob}")
    await call("members_after", "GET", f"/v2/console/group/{gid}/member")
    await call("members_missing", "GET", "/v2/console/group/nogroup/member")
    await call("delete", "DELETE", f"/v2/console/group/{gid}")
    await call("delete_again", "DELETE", f"/v2/console/group/{gid}")

    # ---------------------------------------------------------- channels
    s.group = "channels"
    ws = await wsproto.connect(HOST, server.port, f"/ws?token={alice_tok}")

    async def answer(env, key):
        await ws.send(json.dumps(env))
        while True:
            got = json.loads(await asyncio.wait_for(ws.recv(), 5))
            if got.get("cid") == env["cid"]:
                assert key in got, got
                return got[key]

    channel = (await answer({"cid": "j", "channel_join": {
        "type": 1, "target": "lobby", "persistence": True}}, "channel"))["id"]
    sent = []
    for n in range(3):
        ack = await answer({"cid": f"m{n}", "channel_message_send": {
            "channel_id": channel, "content": {"n": n}}}, "channel_message_ack")
        sent.append(ack["message_id"])
    quoted = channel.replace("#", "%23")
    await call("browse", "GET", f"/v2/console/channel/{quoted}")
    await call("browse_back", "GET",
               f"/v2/console/channel/{quoted}?forward=false&limit=2")
    await call("browse_bad", "GET", "/v2/console/channel/bogus")
    await call("delete", "DELETE",
               f"/v2/console/channel/{quoted}/message/{sent[0]}")
    await call("delete_again", "DELETE",
               f"/v2/console/channel/{quoted}/message/{sent[0]}")
    await call("delete_bad_channel", "DELETE",
               f"/v2/console/channel/bogus/message/{sent[1]}")
    await call("bulk_bad_before", "DELETE", "/v2/console/message",
               {"before": "x"})
    await call("bulk_ids", "DELETE", "/v2/console/message",
               {"ids": [sent[1], "nope"]})
    await call("bulk_before", "DELETE", "/v2/console/message",
               {"before": 1.0})
    await call("browse_after", "GET", f"/v2/console/channel/{quoted}")
    await ws.close()

    # ------------------------------------------------------ leaderboards
    s.group = "leaderboards"
    await server.leaderboards.create("ranked", sort_order="desc",
                                     operator="best")
    players = []
    for n in range(6):
        uid, tok = await s.device_user(f"device-lb-{n}", f"lb{n}")
        players.append(uid)
        status, _ = await s.api("POST", "/v2/leaderboard/ranked",
                                {"score": [50, 70, 70, 10, 90, 30][n],
                                 "subscore": n % 2}, token=tok)
        assert status == 200
    await call("list", "GET", "/v2/console/leaderboard")
    await call("detail", "GET", "/v2/console/leaderboard/ranked/detail")
    await call("detail_missing", "GET", "/v2/console/leaderboard/none/detail")
    await call("records", "GET", "/v2/console/leaderboard/ranked?limit=100")
    await call("records_2", "GET", "/v2/console/leaderboard/ranked?limit=2")
    await call("records_missing", "GET", "/v2/console/leaderboard/none")
    _, stats = await call("device", "GET", "/v2/console/leaderboard/device",
                          keep=False)
    s.out["leaderboards"]["device"] = [
        (b["board_id"], b["entries"], b["dirty"]) for b in stats["boards"]]
    await call("record_delete", "DELETE",
               f"/v2/console/leaderboard/ranked/owner/{players[4]}")
    await call("record_delete_again", "DELETE",
               f"/v2/console/leaderboard/ranked/owner/{players[4]}")
    await call("record_delete_board", "DELETE",
               f"/v2/console/leaderboard/none/owner/{players[4]}")
    await call("records_after", "GET", "/v2/console/leaderboard/ranked")

    # -------------------------------------------------------- matchmaker
    s.group = "matchmaker"
    sockets = []
    for n, (uid, tok) in enumerate([(alice, alice_tok), (bob, None)]):
        if tok is None:
            _, tok = await s.device_user("device-console-bob", "bob")
        w = await wsproto.connect(HOST, server.port, f"/ws?token={tok}")
        sockets.append(w)
        await w.send(json.dumps({"cid": "mm", "matchmaker_add": {
            "min_count": 2, "max_count": 2, "query": "+properties.mode:duel",
            "string_properties": {"mode": "duel"}}}))
        while "matchmaker_ticket" not in json.loads(
                await asyncio.wait_for(w.recv(), 5)):
            pass
    _, before = await call("before", "GET", "/v2/console/matchmaker",
                           keep=False)
    server.matchmaker.process()
    _, after = await call("after", "GET", "/v2/console/matchmaker?n=8",
                          keep=False)
    backend = {"TpuBackend": "device", "CudaBackend": "device"}
    for name, view in (("before", before), ("after", after)):
        s.out["matchmaker"][name] = {
            "tickets": view["tickets"], "active": view["active"],
            "backend": backend.get(view["backend"], view["backend"]),
            "intervals": [{k: c.get(k) for k in ("actives", "matched_entries")}
                          for c in view["intervals"]],
            "keys": sorted(view),
        }
    await call("matches", "GET", "/v2/console/match")
    await call("match_state_missing", "GET", "/v2/console/match/nope/state")
    for w in sockets:
        await w.close()

    # ---------------------------------------------------------- explorer
    s.group = "explorer"
    await call("endpoints", "GET", "/v2/console/api/endpoints")
    await call("rpc", "POST", "/v2/console/api/endpoints/rpc/console_echo",
               b"hello")
    await call("rpc_missing", "POST", "/v2/console/api/endpoints/rpc/nope")
    for name, body in (
        ("call_as_user", {"method": "GET", "path": "/v2/account",
                          "user_id": alice}),
        ("call_server_key", {"method": "POST",
                             "path": "/v2/account/authenticate/device",
                             "query": {"username": "explorer"},
                             "body": {"account": {"id": "device-explorer"}}}),
        ("call_no_auth", {"method": "GET", "path": "/v2/account",
                          "server_key_auth": False}),
        ("call_console", {"path": "/v2/console/status"}),
        ("call_unknown_user", {"path": "/v2/account", "user_id": "nobody"}),
        ("call_bad_body", None),
    ):
        status, out = await call(name, "POST", "/v2/console/api/endpoints/call",
                                 body if body is not None else "x", keep=False)
        if isinstance(out, dict) and isinstance(out.get("body"), str):
            out = {**out, "body": json.loads(out["body"])}
        s.out["explorer"][name] = [status, out]

    # -------------------------------------- routes of later components
    s.group = "later"
    for path in ("/v2/console/cluster", "/v2/console/fleet",
                 "/v2/console/fleet/traces", "/v2/console/fleet/traces/abc",
                 "/v2/console/soak"):
        await call(path, "GET", path)
    await call("reshard", "POST", "/v2/console/fleet/reshard", {"plan": 1})
    await call("reshard_viewer", "POST", "/v2/console/fleet/reshard",
               {"plan": 1}, token=viewer)
    # Purchases and subscriptions validated through the stores' fetcher
    # (`provider_fakes`), then the console's listings.
    purchases = s.server.purchases
    await purchases.validate_apple("buyer-1", F.apple_receipt(["c1", "c2"]))
    await purchases.validate_google("buyer-2", F.google_receipt("gems", "c3"))
    await purchases.validate_huawei("buyer-1", F.huawei_receipt("coins", "c4"))
    await purchases.validate_subscription_apple(
        "buyer-1", F.apple_receipt(["cs1"]))
    await purchases.validate_subscription_google(
        "buyer-2", F.google_receipt("vip", "cs2"))
    await call("/v2/console/purchase", "GET", "/v2/console/purchase")
    await call("purchase_user", "GET",
               "/v2/console/purchase?user_id=buyer-1&limit=1")
    await call("/v2/console/subscription", "GET", "/v2/console/subscription")
    await call("subscription_user", "GET",
               "/v2/console/subscription?user_id=buyer-2")
    await call("purchase_viewer", "GET", "/v2/console/purchase", token=viewer)

    # ------------------------------------------------------------- wipes
    s.group = "wipe"
    await call("delete_accounts", "DELETE", "/v2/console/account")
    await call("list", "GET", "/v2/console/account")
    await call("delete_all", "DELETE", "/v2/console/all")
    await call("leaderboards", "GET", "/v2/console/leaderboard")
    await call("status_after", "GET", "/v2/console/runtime")
    return s.out


def with_stores(server):
    """The IAP section the stores' fetcher answers to, and that fetcher
    (the refund scheduler stays off: no package name)."""
    F.configure(server.config)
    server.config.iap.google_package_name = ""
    server.purchases._fetch = F.store_fetch()
    server.google_refund_scheduler._fetch = F.store_fetch()
    return server


async def _jax(tmp):
    cfg = jax_config.parse_args(FLAGS + ["--data_dir", str(tmp)])
    server = with_stores(
        JaxServer(cfg, quiet_logger(), runtime_modules=[init_module]))
    backend = TpuBackend(cfg.matchmaker, quiet_logger())
    server.matchmaker.backend = backend
    backend.attach(server.matchmaker.store)
    await server.start()
    return server


async def _port(tmp):
    cfg = port_config.parse_args(FLAGS + ["--data_dir", str(tmp)])
    log = port_logger()
    backend = CudaBackend(cfg.matchmaker, log, device="cpu", row_block=8,
                          col_block=64, big_row_block=8, big_col_block=64)
    server = with_stores(NakamaServer(cfg, log, matchmaker_backend=backend,
                                      runtime_modules=[init_module]))
    await server.start()
    return server


class HeldSleep:
    """`asyncio` for the console module, with `sleep` held until
    `release` is set."""

    def __init__(self):
        self.release = asyncio.Event()
        self.waiting = False

    def __getattr__(self, name):
        return getattr(asyncio, name)

    async def sleep(self, seconds):
        self.waiting = True
        await self.release.wait()


async def _port_only(server) -> dict:
    """The device view and a capture on the CPU, on the port's console."""
    s = Script(server)
    _, body = await s.http(server.console_port, "POST",
                           "/v2/console/authenticate",
                           {"username": "admin", "password": "password"})
    s.admin = body["token"]
    s.group = "auth"
    out = s.out["auth"]
    await s.call("device", "GET", "/v2/console/device?n=5")
    await s.call("device_bad_n", "GET", "/v2/console/device?n=x")
    # The first capture's window is held open until the second request
    # has its answer.
    held = HeldSleep()
    console_module.asyncio = held
    try:
        first = asyncio.ensure_future(s.call(
            "capture", "POST", "/v2/console/device/capture",
            {"duration_ms": 200}))
        while not held.waiting:
            await asyncio.sleep(0.01)
        await s.call("capture_busy", "POST", "/v2/console/device/capture", {})
        held.release.set()
        await first
    finally:
        console_module.asyncio = asyncio
    await s.call("capture_clamped", "POST", "/v2/console/device/capture",
                 {"duration_ms": 10})
    await s.call("capture_bad", "POST", "/v2/console/device/capture",
                 {"duration_ms": "x"})
    await s.call("viewer_create", "POST", "/v2/console/user",
                 {"username": "ro", "password": "longenough", "role": 4})
    _, body = await s.call("ro_login", "POST", "/v2/console/authenticate",
                           {"username": "ro", "password": "longenough"},
                           token="")
    await s.call("capture_read_only", "POST", "/v2/console/device/capture",
                 {}, token=body["token"])
    return out


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    async def both():
        jax = await _jax(tmp_path_factory.mktemp("jax"))
        try:
            jax_out = Ids()(await run_script(jax))
        finally:
            await jax.stop()
        port = await _port(tmp_path_factory.mktemp("port"))
        try:
            port_out = Ids()(await run_script(port))
            port_only = await _port_only(port)
            endpoints = list(port.api.routes)
            routes = list(port.console.routes)
        finally:
            await port.stop()
        return jax_out, port_out, port_only, endpoints, routes

    return asyncio.run(both())


def _project(jax, port):
    """`jax` cut down to the keys `port` has, at every depth (the port's
    config drops the sections and fields it has no code for)."""
    if isinstance(port, dict) and isinstance(jax, dict):
        return {k: _project(jax[k], v) for k, v in port.items() if k in jax}
    return jax


@pytest.mark.parametrize("group", GROUPS)
def test_the_same_console_script_gives_the_same_answers(answers, group):
    jax_out, port_out, *_ = answers
    want, got = dict(jax_out[group]), dict(port_out[group])
    if group == "status":
        # The port's config tree is the JAX tree cut to the sections and
        # fields the port has, redactions included.
        config = got.pop("config")
        want_config = _project(want.pop("config"), config)
        for tree in (config, want_config):
            tree["data_dir"] = "<each server's own>"
        # The port's default backend is its CUDA one.
        assert config["matchmaker"].pop("backend") == "cuda"
        assert want_config["matchmaker"].pop("backend") == "auto"
        assert config == want_config
        assert set(config) == {
            "name", "data_dir", "shutdown_grace_sec", "logger", "metrics",
            "session", "socket", "database", "matchmaker", "match",
            "tracker", "runtime", "console", "leaderboard", "iap", "social",
            "satori", "overload", "tracing", "recovery", "devobs"}
        for section, key in (("session", "encryption_key"),
                             ("socket", "server_key"),
                             ("console", "password"),
                             ("console", "signing_key")):
            assert config[section][key] == "<redacted>"
    if group == "later":
        # The purchases and subscriptions, listed alike.
        status, body = got["/v2/console/purchase"]
        assert status == 200 and len(body["validated_purchases"]) == 4
        assert len(got["/v2/console/subscription"][1]["subscriptions"]) == 2
    assert got == want


def test_the_rank_engines_served_the_record_listing(answers):
    _, port_out, *_ = answers
    status, body = port_out["leaderboards"]["records"]
    ranks = [(r["username"], r["score"], r["rank"]) for r in body["records"]]
    assert status == 200 and ranks == [
        ("lb4", 90, 1), ("lb1", 70, 2), ("lb2", 70, 3), ("lb0", 50, 4),
        ("lb5", 30, 5), ("lb3", 10, 6)]
    assert port_out["leaderboards"]["device"] == [("ranked", 6, 0)]


def test_the_device_view_and_a_cpu_capture(answers):
    *_, port_only, _, _ = answers
    status, view = port_only["device"]
    assert status == 200
    assert view["mesh"] == {"devices": [], "mesh": None}
    assert {"kernels", "memory", "transfers", "timeline", "warmup"} <= set(view)
    assert len(view["timeline"]) <= 5
    assert port_only["device_bad_n"] == [400, {"error": "n must be an integer"}]
    status, cap = port_only["capture"]
    assert status == 200 and cap["duration_ms"] == 200
    traces = glob.glob(os.path.join(cap["path"], "*.json"))
    assert len(traces) == 1
    share = port_tracing.busy_share(traces[0], "device_trace")
    assert share["device_events"] == 0 and share["window_us"] > 0
    assert port_only["capture_busy"] == [
        409, {"error": "a device capture is already running"}]
    assert port_only["capture_clamped"][1]["duration_ms"] == 50
    assert port_only["capture_bad"] == [
        400, {"error": "duration_ms must be an integer"}]
    assert port_only["capture_read_only"] == [
        403, {"error": "read-only console user"}]


def test_the_page_names_every_console_route_and_the_endpoints_all_api_routes(
        answers):
    *_, endpoints, routes = answers
    ui = {(m.group(1), m.group(2)) for m in re.finditer(
        r"\['(GET|POST|PUT|DELETE)',\s*'(/v2/console[^']*)'\]", PAGE)}
    served = {(m, p) for m, p in routes if p.startswith("/v2/console")}
    assert ui == served
    assert len(endpoints) == len(set(endpoints)) == 85

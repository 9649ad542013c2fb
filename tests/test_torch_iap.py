"""The port's IAP validators, purchases, refund scheduler and outbound
HTTP client held against the JAX package's:

- every Apple, Google and Huawei receipt and subscription validates to
  the same result or error through one injected store fetcher
  (`provider_fakes.store_fetch`), with the same requests;
- `_google_service_jwt` is byte-equal for the same key (PKCS#8 and
  PKCS#1 PEM) at the same clock: the port signs with `utils/rsa.py`,
  the JAX package with `cryptography`;
- `Purchases` over each package's SQLite engine persists the same
  purchase, receipt and subscription rows and answers the same
  (`seen_before`, another user's subscription, listings);
- one `GoogleRefundScheduler.poll_once` marks the same rows refunded and
  calls the purchase-notification hook alike;
- the port's `utils/httpfetch.fetch` returns what the JAX helper
  (`aiohttp`) returns from a local server: plain HTTP with a
  Content-Length, chunked and close-delimited bodies, gzip, redirects
  (301/302/303/307/308, relative and absolute, and too many), POST
  bodies and headers, a kept-alive connection the server closed, and
  TLS with a self-signed certificate trusted in the test (each client's
  default context patched here).

Stated tolerance: none — every compared value must be equal."""

import asyncio
import datetime
import gzip
import ipaddress
import json
import ssl
import time

import numpy as np
import pytest

import provider_fakes as F
from fixtures import quiet_logger

from nakama_tpu import iap as jax_iap
from nakama_tpu.config import Config as JaxConfig
from nakama_tpu.core.purchase import Purchases as JaxPurchases
from nakama_tpu.iap import client as jax_iap_client
from nakama_tpu.iap.refund import GoogleRefundScheduler as JaxRefunds
from nakama_tpu.storage.db import Database as JaxDatabase
from nakama_tpu.utils import httpfetch as jax_httpfetch
from nakama_tpu_torch import iap as port_iap
from nakama_tpu_torch.config import Config
from nakama_tpu_torch.core.purchase import Purchases
from nakama_tpu_torch.iap import client as port_iap_client
from nakama_tpu_torch.iap.refund import GoogleRefundScheduler
from nakama_tpu_torch.logger import test_logger as port_logger
from nakama_tpu_torch.storage.db import Database
from nakama_tpu_torch.utils import httpfetch


def outcome(value):
    if isinstance(value, BaseException):
        return ("raised", type(value).__name__, str(value),
                getattr(value, "code", None))
    if isinstance(value, list):
        return [outcome(v) for v in value]
    if hasattr(value, "__dataclass_fields__"):
        return {k: getattr(value, k) for k in value.__dataclass_fields__}
    return value


VALIDATIONS = [
    ("apple", lambda m, f: m.validate_receipt_apple(
        F.APPLE_PASSWORD, F.apple_receipt(["t1", "t2"]), f)),
    ("apple sandbox", lambda m, f: m.validate_receipt_apple(
        F.APPLE_PASSWORD, F.apple_receipt(["t3"], sandbox=True), f)),
    ("apple status", lambda m, f: m.validate_receipt_apple(
        F.APPLE_PASSWORD, F.apple_receipt(["t4"], status=21003), f)),
    ("apple empty", lambda m, f: m.validate_receipt_apple(
        F.APPLE_PASSWORD, F.apple_receipt([]), f)),
    ("apple no password", lambda m, f: m.validate_receipt_apple(
        "", F.apple_receipt(["t1"]), f)),
    ("apple wrong password", lambda m, f: m.validate_receipt_apple(
        "nope", F.apple_receipt(["t1"]), f)),
    ("apple sub", lambda m, f: m.validate_subscription_apple(
        F.APPLE_PASSWORD, F.apple_receipt(["s1", "s2"]), f)),
    ("apple sub empty", lambda m, f: m.validate_subscription_apple(
        F.APPLE_PASSWORD, F.apple_receipt([]), f)),
    ("google", lambda m, f: m.validate_receipt_google(
        F.GOOGLE_EMAIL, F.PEM, F.google_receipt("gems", "tok-1"), f)),
    ("google pkcs1", lambda m, f: m.validate_receipt_google(
        F.GOOGLE_EMAIL, F.PEM_PKCS1, F.google_receipt("gems", "tok/../x"), f)),
    ("google pending", lambda m, f: m.validate_receipt_google(
        F.GOOGLE_EMAIL, F.PEM, F.google_receipt("gems", "pending-token"), f)),
    ("google missing", lambda m, f: m.validate_receipt_google(
        F.GOOGLE_EMAIL, F.PEM, F.google_receipt("gems", "bad-token"), f)),
    ("google not json", lambda m, f: m.validate_receipt_google(
        F.GOOGLE_EMAIL, F.PEM, "not json", f)),
    ("google fields", lambda m, f: m.validate_receipt_google(
        F.GOOGLE_EMAIL, F.PEM, json.dumps({"productId": "x"}), f)),
    ("google unconfigured", lambda m, f: m.validate_receipt_google(
        "", F.PEM, F.google_receipt("gems", "tok-1"), f)),
    ("google sub", lambda m, f: m.validate_subscription_google(
        F.GOOGLE_EMAIL, F.PEM, F.google_receipt("vip", "sub-tok"), f)),
    ("google sub missing", lambda m, f: m.validate_subscription_google(
        F.GOOGLE_EMAIL, F.PEM, F.google_receipt("vip", "bad-token"), f)),
    ("huawei", lambda m, f: m.validate_receipt_huawei(
        F.HUAWEI_ID, F.HUAWEI_SECRET, F.huawei_receipt("coins", "hw-1"), f)),
    ("huawei rejected", lambda m, f: m.validate_receipt_huawei(
        F.HUAWEI_ID, F.HUAWEI_SECRET, F.huawei_receipt("coins", "hw-bad"), f)),
    ("huawei secret", lambda m, f: m.validate_receipt_huawei(
        F.HUAWEI_ID, "wrong", F.huawei_receipt("coins", "hw-1"), f)),
    ("huawei unconfigured", lambda m, f: m.validate_receipt_huawei(
        "", "", F.huawei_receipt("coins", "hw-1"), f)),
]


async def test_every_receipt_and_subscription_validates_the_same():
    seen = {}
    for name, call in VALIDATIONS:
        got = []
        for mod in (jax_iap, port_iap):
            calls = []
            try:
                value = await call(mod, F.store_fetch(calls))
            except Exception as e:
                value = e
            got.append((outcome(value), calls))
        assert got[0] == got[1], name
        seen[name] = got[1][0]
    assert [p["transaction_id"] for p in seen["apple"]] == ["t1", "t2"]
    assert seen["apple sandbox"][0]["environment"] == port_iap.ENV_SANDBOX
    assert seen["google"][0]["transaction_id"] == "GPA.tok-1"
    assert seen["google sub"]["original_transaction_id"] == "sub-tok"
    assert seen["huawei"][0]["transaction_id"] == "HW.hw-1"
    assert seen["google pending"][:3] == (
        "raised", "IAPError", "google purchase not in purchased state")


def test_google_service_jwt_is_byte_equal(monkeypatch):
    rng = np.random.default_rng(8)
    for _ in range(3):
        now = 1_600_000_000 + int(rng.integers(0, 10**8))
        monkeypatch.setattr(time, "time", lambda: now + 0.5)
        for pem in (F.PEM, F.PEM_PKCS1):
            email = f"svc{int(rng.integers(1000))}@example.iam.gserviceaccount.com"
            want = jax_iap_client._google_service_jwt(email, pem)
            assert port_iap_client._google_service_jwt(email, pem) == want
    errors = []
    for mod in (jax_iap_client, port_iap_client):
        with pytest.raises(Exception) as e:
            mod._google_service_jwt(F.GOOGLE_EMAIL, "not a pem")
        errors.append(isinstance(e.value, ValueError))
    assert errors == [True, True]


# -------------------------------------------------------------- purchases


async def purchases_script(key: str) -> dict:
    if key == "jax":
        db, cfg, cls, log = JaxDatabase(":memory:"), JaxConfig(), JaxPurchases, quiet_logger()
    else:
        db, cfg, cls, log = Database(":memory:"), Config(), Purchases, port_logger()
    F.configure(cfg)
    await db.connect()
    p = cls(log, db, cfg, fetch=F.store_fetch())
    out = []

    async def step(name, coro):
        try:
            value = await coro
        except Exception as e:
            value = e
        out.append((name, outcome(value)))

    try:
        await step("apple", p.validate_apple("u1", F.apple_receipt(["t1", "t2"])))
        await step("apple again", p.validate_apple("u1", F.apple_receipt(["t1", "t2"])))
        await step("apple other user", p.validate_apple("u2", F.apple_receipt(["t2", "t5"])))
        await step("apple dry", p.validate_apple(
            "u3", F.apple_receipt(["t9"]), persist=False))
        await step("google", p.validate_google("u2", F.google_receipt("gems", "tok-1")))
        await step("huawei", p.validate_huawei("u1", F.huawei_receipt("coins", "hw-1")))
        await step("huawei bad", p.validate_huawei("u1", F.huawei_receipt("c", "hw-bad")))
        await step("sub apple", p.validate_subscription_apple(
            "u1", F.apple_receipt(["s1", "s2"])))
        await step("sub apple other", p.validate_subscription_apple(
            "u2", F.apple_receipt(["s1", "s2"])))
        await step("sub google", p.validate_subscription_google(
            "u2", F.google_receipt("vip", "sub-tok")))
        await step("sub google dry", p.validate_subscription_google(
            "u3", F.google_receipt("vip", "sub-tok-2"), persist=False))
        await step("list", p.list())
        await step("list u1", p.list(user_id="u1", limit=1))
        await step("list_purchases", p.list_purchases("", limit=2, cursor="1"))
        await step("by txn", p.get_by_transaction("t2"))
        await step("by product", p.get_subscription_by_product("u2", "vip"))
        await step("subs", p.list_subscriptions(""))
        await step("subs u1", p.list_subscriptions("u1"))
        tables = {}
        for table, order in (("purchase", "transaction_id"),
                             ("purchase_receipt", "transaction_id"),
                             ("subscription", "original_transaction_id")):
            tables[table] = await db.fetch_all(
                f"SELECT * FROM {table} ORDER BY {order}")
        out.append(("tables", tables))
    finally:
        await db.close()
    return mask_times(out)


def mask_times(value):
    """The clock's times (a row's create and update time, a subscription's
    purchase time); the stores' own times stay."""
    if isinstance(value, dict):
        return {k: "<time>" if k in ("create_time", "update_time",
                                     "purchase_time")
                and isinstance(v, float) and v > 1.75e9 else mask_times(v)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [mask_times(v) for v in value]
    return value


async def test_purchases_persist_the_same_rows():
    want = await purchases_script("jax")
    got = await purchases_script("torch")
    assert got == want
    steps = dict(got)
    assert [p["seen_before"] for p in steps["apple again"]] == [True, True]
    assert [p["user_id"] for p in steps["apple other user"]] == ["u1", "u2"]
    assert steps["sub apple other"][:3] == [
        "raised", "IAPError", "subscription belongs to another user"]
    assert len(steps["tables"]["purchase"]) == 5
    assert len(steps["tables"]["subscription"]) == 2


async def refund_poll(key: str) -> list:
    if key == "jax":
        db, cfg, cls, log = JaxDatabase(":memory:"), JaxConfig(), JaxRefunds, quiet_logger()
        purchases = JaxPurchases
    else:
        db, cfg, cls, log = Database(":memory:"), Config(), GoogleRefundScheduler, port_logger()
        purchases = Purchases
    F.configure(cfg)
    await db.connect()
    hooked = []

    class Runtime:
        def purchase_notification(self, store):
            async def hook(ctx, payload):
                hooked.append((store, ctx, payload["transaction_id"]))
            return hook

        def context(self, mode):
            return mode

    try:
        p = purchases(log, db, cfg, fetch=F.store_fetch())
        await p.validate_google("u1", F.google_receipt("gems", "refund-1"))
        await p.validate_google("u1", F.google_receipt("gems", "kept-2"))
        calls = []
        scheduler = cls(log, db, cfg, runtime=Runtime(), fetch=F.store_fetch(calls))
        first = await scheduler.poll_once()
        second = await scheduler.poll_once()
        rows = await db.fetch_all(
            "SELECT transaction_id, refund_time > 0 AS refunded FROM purchase"
            " ORDER BY transaction_id")
        unconfigured = cls(log, db, type(cfg)())
        return [first, second, rows, hooked, calls, scheduler.configured,
                unconfigured.configured]
    finally:
        await db.close()


async def test_one_refund_poll_gives_the_same_result():
    got = await refund_poll("torch")
    assert got == await refund_poll("jax")
    assert got[:2] == [1, 0]
    assert got[2] == [{"transaction_id": "GPA.kept-2", "refunded": 0},
                      {"transaction_id": "GPA.refund-1", "refunded": 1}]
    assert got[3] == [("google", "refund", "GPA.refund-1")]


# --------------------------------------------------------------- httpfetch


class LocalHttp:
    """A small HTTP/1.1 server for the fetch comparison: each path names
    a way to frame the answer."""

    def __init__(self, ssl_context=None):
        self.ssl = ssl_context
        self.port = None
        self.requests: list = []
        self.writers: set = set()

    async def start(self):
        self._server = await asyncio.start_server(
            self._client, "127.0.0.1", 0, ssl=self.ssl)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self):
        # The clients' kept-alive connections end with the server.
        for w in self.writers:
            w.transport.abort()
        self._server.close()
        await self._server.wait_closed()

    async def _client(self, r, w):
        self.writers.add(w)
        try:
            while True:
                head = await r.readuntil(b"\r\n\r\n")
                lines = head.decode().split("\r\n")
                method, target, _ = lines[0].split(" ")
                headers = {k.lower(): v for k, v in
                           (x.split(": ", 1) for x in lines[1:] if x)}
                body = await r.readexactly(int(headers.get("content-length", 0)))
                self.requests.append((method, target, body,
                                      headers.get("x-probe")))
                if not await self._answer(w, method, target, headers, body):
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        w.close()

    async def _answer(self, w, method, target, headers, body) -> bool:
        path, _, query = target.partition("?")
        echo = json.dumps({"method": method, "query": query,
                           "body": body.decode(errors="replace"),
                           "probe": headers.get("x-probe")}).encode()
        if path == "/length":
            w.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n" % len(echo)
                    + echo)
        elif path == "/chunked":
            w.write(b"HTTP/1.1 201 Created\r\nTransfer-Encoding: chunked\r\n\r\n")
            for i in range(0, len(echo), 7):
                part = echo[i:i + 7]
                w.write(b"%x;ext=1\r\n" % len(part) + part + b"\r\n")
            w.write(b"0\r\nX-Trailer: t\r\n\r\n")
        elif path == "/close":
            w.write(b"HTTP/1.1 404 Not Found\r\n\r\n" + echo)
            await w.drain()
            return False
        elif path == "/gzip":
            data = gzip.compress(echo)
            w.write(b"HTTP/1.1 200 OK\r\nContent-Encoding: gzip\r\n"
                    b"Content-Length: %d\r\n\r\n" % len(data) + data)
        elif path.startswith("/redirect/"):
            code, hops = path.split("/")[2:4]
            hops = int(hops)
            location = (f"/redirect/{code}/{hops - 1}" if hops > 1
                        else "/length?from=" + code)
            if hops == 2:
                location = f"http://127.0.0.1:{self.port}{location}" \
                    if not self.ssl else location
            w.write(f"HTTP/1.1 {code} Moved\r\nLocation: {location}\r\n"
                    "Content-Length: 0\r\n\r\n".encode())
        elif path == "/loop":
            w.write(b"HTTP/1.1 302 Found\r\nLocation: /loop\r\n"
                    b"Content-Length: 0\r\n\r\n")
        elif path == "/bye":
            w.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\nConnection: close"
                    b"\r\n\r\nok")
            await w.drain()
            return False
        else:
            w.write(b"HTTP/1.1 204 No Content\r\n\r\n")
        await w.drain()
        return True


async def fetch_script(fetch, base: str) -> list:
    out = []
    calls = [
        (f"{base}/length?a=1&b=%20", "GET", None, None),
        (f"{base}/length", "POST", {"X-Probe": "p1", "Content-Type": "x"}, b"body"),
        (f"{base}/chunked?q=2", "GET", None, None),
        (f"{base}/close", "GET", None, None),
        (f"{base}/gzip", "PUT", None, b"zip me"),
        (f"{base}/empty", "DELETE", None, None),
        (f"{base}/bye", "GET", None, None),
        (f"{base}/length?after=bye", "GET", None, None),
    ] + [
        (f"{base}/redirect/{code}/3", method, None, b"payload")
        for code in (301, 302, 303, 307, 308) for method in ("GET", "POST")
    ] + [(f"{base}/loop", "GET", None, None)]
    for url, method, headers, body in calls:
        try:
            status, data = await fetch(url, method=method, headers=headers,
                                       body=body)
            out.append((status, data))
        except Exception as e:
            # aiohttp's TooManyRedirects, the port's FetchError.
            out.append(("raised",
                        "redirect" in (type(e).__name__ + str(e)).lower()))
    return out


def tls_contexts(tmp_path):
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.x509.oid import NameOID

    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "127.0.0.1")])
    cert = x509.CertificateBuilder().subject_name(name).issuer_name(
        name).public_key(F.KEY.public_key()).serial_number(5).not_valid_before(
        datetime.datetime(2020, 1, 1)).not_valid_after(
        datetime.datetime(2040, 1, 1)).add_extension(
        x509.SubjectAlternativeName([x509.IPAddress(
            ipaddress.ip_address("127.0.0.1"))]), critical=False).add_extension(
        x509.BasicConstraints(ca=True, path_length=None), critical=True).sign(
        F.KEY, hashes.SHA256())
    cert_path, key_path = tmp_path / "cert.pem", tmp_path / "key.pem"
    cert_path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_path.write_text(F.PEM)
    server = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
    server.load_cert_chain(cert_path, key_path)
    client = ssl.create_default_context()
    client.load_verify_locations(cert_path)
    return server, client


async def test_fetch_returns_what_the_aiohttp_helper_returns(tmp_path, monkeypatch):
    import aiohttp.connector

    server_ctx, client_ctx = tls_contexts(tmp_path)
    monkeypatch.setattr(httpfetch, "_ssl_context", lambda: client_ctx)
    monkeypatch.setattr(aiohttp.connector, "_SSL_CONTEXT_VERIFIED", client_ctx)
    results = {}
    for scheme, ctx in (("http", None), ("https", server_ctx)):
        server = LocalHttp(ctx)
        await server.start()
        base = f"{scheme}://127.0.0.1:{server.port}"
        try:
            for name, fetch in (("jax", jax_httpfetch.fetch),
                                ("torch", httpfetch.fetch)):
                server.requests.clear()
                results[scheme, name] = (await fetch_script(fetch, base),
                                         list(server.requests))
        finally:
            await server.stop()
    session = jax_httpfetch._sessions.pop(id(asyncio.get_running_loop()), None)
    if session is not None:
        await session.close()
    for scheme in ("http", "https"):
        got, want = results[scheme, "torch"], results[scheme, "jax"]
        assert got[0] == want[0], scheme
        # The same requests reached the server (the JAX helper sends a
        # body-less GET with no Content-Length either).
        assert got[1] == want[1], scheme
    answers = results["https", "torch"][0]
    assert json.loads(answers[0][1])["query"] == "a=1&b=%20"
    assert answers[2][0] == 201 and answers[3][0] == 404
    assert json.loads(answers[4][1])["body"] == "zip me"
    assert answers[-1] == ("raised", True)

"""Fakes of the outbound providers for the social and IAP parity tests:
an RSA key, JWKS and Game Center certificates made with `cryptography`
(the port itself never imports it), the routers that answer the social
providers' and the stores' URLs in-process, and a seeded
`StubSocialClient` for each package."""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
import struct
import urllib.parse

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, padding, rsa
from cryptography.x509.oid import NameOID

KEY = rsa.generate_private_key(public_exponent=65537, key_size=2048)
OTHER_KEY = rsa.generate_private_key(public_exponent=65537, key_size=2048)
PEM = KEY.private_bytes(
    serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
    serialization.NoEncryption(),
).decode()
PEM_PKCS1 = KEY.private_bytes(
    serialization.Encoding.PEM, serialization.PrivateFormat.TraditionalOpenSSL,
    serialization.NoEncryption(),
).decode()

APPLE_BUNDLE = "com.example.game"
STEAM_APP = 480
STEAM_KEY = "steam-publisher-key"
FB_INSTANT_SECRET = "fb-instant-secret"
GAMECENTER_URL = "https://static.gc.apple.com/public-key/gc-prod-10.cer"
GOOGLE_EMAIL = "svc@example.iam.gserviceaccount.com"
APPLE_PASSWORD = "apple-shared"
HUAWEI_ID, HUAWEI_SECRET = "hw-client", "hw-secret"


def b64u(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def jwks(key=KEY, kid="k1") -> dict:
    n = key.public_key().public_numbers()
    return {"keys": [{
        "kty": "RSA", "kid": kid, "alg": "RS256",
        "n": b64u(n.n.to_bytes((n.n.bit_length() + 7) // 8, "big")),
        "e": b64u(n.e.to_bytes((n.e.bit_length() + 7) // 8, "big")),
    }]}


def sign_jwt(claims: dict, key=KEY, kid="k1", alg="RS256") -> str:
    header = {"alg": alg, "kid": kid, "typ": "JWT"}
    signing = b64u(json.dumps(header).encode()) + "." + b64u(
        json.dumps(claims).encode())
    sig = key.sign(signing.encode(), padding.PKCS1v15(), hashes.SHA256())
    return signing + "." + b64u(sig)


def certificate(key, name="gc") -> bytes:
    subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, name)])
    return x509.CertificateBuilder().subject_name(subject).issuer_name(
        subject).public_key(key.public_key()).serial_number(7).not_valid_before(
        datetime.datetime(2020, 1, 1)).not_valid_after(
        datetime.datetime(2040, 1, 1)).sign(key, hashes.SHA256()).public_bytes(
        serialization.Encoding.DER)


GC_CERT = certificate(KEY)
EC_CERT = certificate(ec.generate_private_key(ec.SECP256R1()), "ec")


def gamecenter_account(player: str, key=KEY, url=GAMECENTER_URL,
                       bundle=APPLE_BUNDLE, ts=1_700_000_000) -> dict:
    salt = hashlib.sha256(player.encode()).digest()[:8]
    payload = player.encode() + bundle.encode() + struct.pack(">Q", ts) + salt
    sig = key.sign(payload, padding.PKCS1v15(), hashes.SHA256())
    return {"player_id": player, "bundle_id": bundle, "timestamp_seconds": ts,
            "salt": base64.b64encode(salt).decode(),
            "signature": base64.b64encode(sig).decode(),
            "public_key_url": url}


def instant_info(player: str, secret=FB_INSTANT_SECRET) -> str:
    payload = b64u(json.dumps({"player_id": player}).encode())
    sig = hmac.new(secret.encode(), payload.encode(), hashlib.sha256).digest()
    return b64u(sig) + "." + payload


# ------------------------------------------------------------ social router


def social_routes() -> dict:
    """URL prefix → (status, body) of every social provider the tests
    call; Facebook tokens `fb-<id>` are live, `fb-dead` is refused."""
    return {
        "https://www.googleapis.com/oauth2/v3/certs": (200, json.dumps(jwks()).encode()),
        "https://appleid.apple.com/auth/keys": (200, json.dumps(jwks()).encode()),
        GAMECENTER_URL: (200, GC_CERT),
        "https://static.gc.apple.com/public-key/ec.cer": (200, EC_CERT),
        "https://static.gc.apple.com/public-key/junk.cer": (200, b"not a certificate"),
        "https://static.gc.apple.com/public-key/missing.cer": (404, b"gone"),
    }


def social_answer(url: str) -> tuple[int, bytes]:
    for prefix, response in social_routes().items():
        if url == prefix or url.startswith(prefix + "?"):
            return response
    parts = urllib.parse.urlsplit(url)
    q = dict(urllib.parse.parse_qsl(parts.query))
    if parts.path == "/v11.0/me":
        token = q.get("access_token", "")
        if token == "fb-badjson":
            return 200, b"{not json"
        if token.startswith("fb-") and token != "fb-dead":
            return 200, json.dumps({"id": token[3:], "name": f"FB {token[3:]}",
                                    "email": f"{token[3:]}@fb.test"}).encode()
        return 401, b'{"error": "invalid token"}'
    if parts.path == "/v11.0/me/friends":
        page = int(q.get("page", "0"))
        ids = [{"id": f"fbf{page}{i}"} for i in range(3)]
        nxt = ({"next": "https://graph.facebook.com/v11.0/me/friends?"
                + urllib.parse.urlencode({"access_token": q.get("access_token", ""),
                                          "page": page + 1})}
               if page < 1 else {})
        return 200, json.dumps({"data": ids, "paging": nxt}).encode()
    if parts.path.endswith("/AuthenticateUserTicket/v1/"):
        if q.get("ticket", "").startswith("steam-"):
            return 200, json.dumps({"response": {"params": {
                "result": "OK", "steamid": q["ticket"][6:]}}}).encode()
        return 200, json.dumps({"response": {"error": {"errorcode": 3}}}).encode()
    if parts.path.endswith("/GetFriendList/v1/"):
        return 200, json.dumps({"friendslist": {"friends": [
            {"steamid": f"{q.get('steamid')}-f{i}"} for i in range(2)]}}).encode()
    return 404, b"not found"


def social_fetch(calls: list | None = None):
    async def fetch(url):
        if calls is not None:
            calls.append(url)
        return social_answer(url)

    return fetch


# -------------------------------------------------------------- store router


def apple_receipt(txns: list[str], sandbox=False, status=0) -> str:
    return base64.b64encode(json.dumps(
        {"txns": txns, "sandbox": sandbox, "status": status}).encode()).decode()


def google_receipt(product: str, token: str, package="com.example.game") -> str:
    return json.dumps({"packageName": package, "productId": product,
                       "purchaseToken": token})


def huawei_receipt(product: str, token: str) -> str:
    return json.dumps({"productId": product, "purchaseToken": token})


VOIDED = ["GPA.refund-1", "GPA.unknown-9"]


def store_answer(url, method="GET", headers=None, body=None) -> tuple[int, bytes]:
    """The stores' answers, a pure function of the request."""
    parts = urllib.parse.urlsplit(url)
    if parts.netloc in ("buy.itunes.apple.com", "sandbox.itunes.apple.com"):
        req = json.loads(body)
        if req["password"] != APPLE_PASSWORD:
            return 200, b'{"status": 21004}'
        data = json.loads(base64.b64decode(req["receipt-data"]))
        if data["sandbox"] and parts.netloc == "buy.itunes.apple.com":
            return 200, b'{"status": 21007}'
        rows = [{"transaction_id": t, "original_transaction_id": f"orig-{t}",
                 "product_id": f"product.{t}",
                 "purchase_date_ms": str(1_700_000_000_000 + i * 1000),
                 "expires_date_ms": str(4_000_000_000_000 + i * 1000)}
                for i, t in enumerate(data["txns"])]
        return 200, json.dumps({"status": data["status"],
                                "receipt": {"in_app": rows},
                                "latest_receipt_info": rows}).encode()
    if url == "https://oauth2.googleapis.com/token":
        assert b"assertion=" in body
        return 200, b'{"access_token": "google-at"}'
    if parts.netloc == "androidpublisher.googleapis.com":
        if headers.get("Authorization") != "Bearer google-at":
            return 401, b"{}"
        if parts.path.endswith("/voidedpurchases"):
            page = dict(urllib.parse.parse_qsl(parts.query)).get("token")
            if page is None:
                return 200, json.dumps({
                    "voidedPurchases": [{"orderId": VOIDED[0]}],
                    "tokenPagination": {"nextPageToken": "p2"}}).encode()
            return 200, json.dumps({"voidedPurchases": [
                {"orderId": VOIDED[1]}, {"kind": "no-order"}]}).encode()
        token = urllib.parse.unquote(parts.path.rsplit("/", 1)[1])
        if token == "bad-token":
            return 404, b"{}"
        if "/subscriptions/" in parts.path:
            return 200, json.dumps({"startTimeMillis": "1700000000000",
                                    "expiryTimeMillis": "4000000000000",
                                    "purchaseType": 0}).encode()
        return 200, json.dumps({
            "purchaseState": 1 if token == "pending-token" else 0,
            "orderId": f"GPA.{token}", "purchaseTimeMillis": "1700000001000",
            "purchaseType": 1}).encode()
    if url.startswith("https://oauth-login.cloud.huawei.com/"):
        form = dict(urllib.parse.parse_qsl(body.decode()))
        if form["client_secret"] != HUAWEI_SECRET:
            return 401, b"{}"
        return 200, b'{"access_token": "hw-at"}'
    if parts.netloc == "orders-drru.iap.cloud.huawei.ru":
        req = json.loads(body)
        ok = req["purchaseToken"] != "hw-bad"
        inner = {"orderId": f"HW.{req['purchaseToken']}",
                 "productId": req["productId"], "purchaseTime": 1700000002000}
        return 200, json.dumps({"responseCode": "0" if ok else "5",
                                "purchaseTokenData": json.dumps(inner)}).encode()
    return 404, b"not found"


def store_fetch(calls: list | None = None):
    async def fetch(url, method="GET", headers=None, body=None):
        if calls is not None:
            calls.append((method, url))
        return store_answer(url, method, headers or {}, body)

    return fetch


def configure(config) -> None:
    """The IAP and social sections the fakes answer to."""
    config.iap.apple_shared_password = APPLE_PASSWORD
    config.iap.google_client_email = GOOGLE_EMAIL
    config.iap.google_private_key = PEM
    config.iap.google_package_name = "com.example.game"
    config.iap.huawei_client_id = HUAWEI_ID
    config.iap.huawei_client_secret = HUAWEI_SECRET
    config.social.apple_bundle_id = APPLE_BUNDLE
    config.social.steam_app_id = STEAM_APP
    config.social.steam_publisher_key = STEAM_KEY
    config.social.facebook_instant_app_secret = FB_INSTANT_SECRET


def stub_social(module):
    """A StubSocialClient of `module` (either package's social.client)
    that knows the tokens the shared scripts present."""
    stub = module.StubSocialClient()
    for provider in ("google", "apple", "steam", "facebook"):
        for i in range(4):
            stub.register(provider, f"{provider}-token-{i}", module.SocialProfile(
                provider=provider, id=f"{provider}-id-{i}",
                username=f"{provider}user{i}", display_name=f"{provider} {i}",
                avatar_url=f"https://a.test/{provider}/{i}.png"))
    for i in range(4):
        stub.register("gamecenter", f"gc-player-{i}", module.SocialProfile(
            provider="gamecenter", id=f"gc-player-{i}"))
    stub.register_friends("facebook", "facebook-token-0",
                          ["facebook-id-1", "facebook-id-2", "nobody"])
    stub.register_friends("steam", "steam-id-0", ["steam-id-1", "steam-id-3"])
    return stub

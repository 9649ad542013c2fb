"""Receipt validation against the store backends.

Parity: reference iap/iap.go — Apple verifyReceipt with the
production→sandbox 21007 fallback (:150-166), Google service-account JWT
+ androidpublisher products.get (:396), Huawei order verification with
client-credential token (:798). Network goes through an injectable
``fetch(url, method, headers, body) -> (status, bytes)`` so validation
logic is testable offline; signing uses the standard RS256 JWT grant the
reference builds for Google.

The port's copy of the JAX package's `iap/client.py`; the grant is
signed by the port's `utils/rsa.py` (PKCS#1 v1.5 is deterministic, so
the JWT equals the JAX one byte for byte for the same key and clock).
"""

from __future__ import annotations

import base64
import json
import time
from dataclasses import dataclass, field

STORE_APPLE = 0
STORE_GOOGLE = 1
STORE_HUAWEI = 2

ENV_UNKNOWN = 0
ENV_SANDBOX = 1
ENV_PRODUCTION = 2

APPLE_PROD_URL = "https://buy.itunes.apple.com/verifyReceipt"
APPLE_SANDBOX_URL = "https://sandbox.itunes.apple.com/verifyReceipt"
APPLE_SANDBOX_STATUS = 21007  # prod endpoint got a sandbox receipt

GOOGLE_TOKEN_URL = "https://oauth2.googleapis.com/token"
GOOGLE_PUBLISHER_URL = "https://androidpublisher.googleapis.com"

HUAWEI_TOKEN_URL = "https://oauth-login.cloud.huawei.com/oauth2/v3/token"
HUAWEI_ORDER_URL = (
    "https://orders-drru.iap.cloud.huawei.ru/applications/purchases/tokens"
    "/verify"
)


class IAPError(Exception):
    def __init__(self, message: str, code: str = "invalid"):
        super().__init__(message)
        self.code = code


@dataclass
class ValidatedPurchase:
    store: int
    transaction_id: str
    product_id: str
    purchase_time: float
    environment: int = ENV_UNKNOWN
    raw_response: dict = field(default_factory=dict)


def _default_fetch(url, method="GET", headers=None, body=None):
    from ..utils.httpfetch import fetch

    return fetch(url, method=method, headers=headers, body=body)


# ---------------------------------------------------------------- apple


async def _apple_verify_receipt(
    shared_password: str, receipt: str, fetch
) -> tuple[dict, int]:
    """POST the base64 receipt to verifyReceipt; status 21007 retries
    against the sandbox endpoint (reference iap.go:150-166). The one
    Apple call path shared by purchase and subscription validation —
    returns (response, environment)."""
    if not shared_password:
        raise IAPError("apple shared password not configured")
    fetch = fetch or _default_fetch
    payload = json.dumps(
        {"receipt-data": receipt, "password": shared_password}
    ).encode()

    async def call(url):
        status, body = await fetch(
            url,
            method="POST",
            headers={"Content-Type": "application/json"},
            body=payload,
        )
        if status != 200:
            raise IAPError(f"apple verifyReceipt failed: HTTP {status}")
        try:
            return json.loads(body)
        except ValueError as e:
            raise IAPError("apple returned invalid JSON") from e

    data = await call(APPLE_PROD_URL)
    environment = ENV_PRODUCTION
    if data.get("status") == APPLE_SANDBOX_STATUS:
        data = await call(APPLE_SANDBOX_URL)
        environment = ENV_SANDBOX
    if data.get("status") != 0:
        raise IAPError(f"apple receipt invalid: status {data.get('status')}")
    return data, environment


async def validate_receipt_apple(
    shared_password: str, receipt: str, fetch=None
) -> list[ValidatedPurchase]:
    data, environment = await _apple_verify_receipt(
        shared_password, receipt, fetch
    )
    in_app = (data.get("receipt") or {}).get("in_app") or []
    if not in_app:
        raise IAPError("apple receipt contains no purchases")
    out = []
    for item in in_app:
        out.append(
            ValidatedPurchase(
                store=STORE_APPLE,
                transaction_id=item.get("transaction_id", ""),
                product_id=item.get("product_id", ""),
                purchase_time=float(item.get("purchase_date_ms", 0)) / 1000,
                environment=environment,
                raw_response=data,
            )
        )
    return out


@dataclass
class ValidatedSubscription:
    store: int
    original_transaction_id: str
    product_id: str
    purchase_time: float
    expire_time: float
    environment: int = ENV_UNKNOWN
    raw_response: dict | None = None


async def validate_subscription_apple(
    shared_password: str, receipt: str, fetch=None
) -> ValidatedSubscription:
    """Auto-renewable subscription via verifyReceipt's
    latest_receipt_info (reference iap.go:625 ValidateSubscription
    ReceiptApple): newest expiry wins across renewal rows."""
    data, environment = await _apple_verify_receipt(
        shared_password, receipt, fetch
    )
    latest = data.get("latest_receipt_info") or []
    if not latest:
        raise IAPError("apple receipt contains no subscription")
    newest = max(
        latest, key=lambda i: float(i.get("expires_date_ms", 0))
    )
    return ValidatedSubscription(
        store=STORE_APPLE,
        original_transaction_id=newest.get(
            "original_transaction_id", ""
        ),
        product_id=newest.get("product_id", ""),
        purchase_time=float(newest.get("purchase_date_ms", 0)) / 1000,
        expire_time=float(newest.get("expires_date_ms", 0)) / 1000,
        environment=environment,
        raw_response=data,
    )


async def validate_subscription_google(
    client_email: str,
    private_key_pem: str,
    receipt: str,
    fetch=None,
) -> ValidatedSubscription:
    """Play subscription via androidpublisher subscriptions.get
    (reference iap.go:646 ValidateSubscriptionReceiptGoogle)."""
    if not client_email or not private_key_pem:
        raise IAPError("google IAP credentials not configured")
    fetch = fetch or _default_fetch
    try:
        purchase = json.loads(receipt)
    except ValueError:
        raise IAPError("google receipt must be the purchase JSON")
    package = purchase.get("packageName", "")
    product_id = purchase.get("productId", "")
    token = purchase.get("purchaseToken", "")
    if not (package and product_id and token):
        raise IAPError("google receipt missing fields")

    access_token = await google_access_token(
        client_email, private_key_pem, fetch
    )
    import urllib.parse as _up

    url = (
        f"{GOOGLE_PUBLISHER_URL}/androidpublisher/v3/applications/"
        f"{_up.quote(package, safe='')}/purchases/subscriptions/"
        f"{_up.quote(product_id, safe='')}/tokens/"
        f"{_up.quote(token, safe='')}"
    )
    status, body = await fetch(
        url, headers={"Authorization": f"Bearer {access_token}"}
    )
    if status != 200:
        raise IAPError(f"google subscription lookup failed: HTTP {status}")
    data = json.loads(body)
    expiry_ms = float(data.get("expiryTimeMillis", 0))
    if not expiry_ms:
        raise IAPError("google subscription has no expiry")
    return ValidatedSubscription(
        store=STORE_GOOGLE,
        # The purchaseToken is the STABLE subscription identity; orderId
        # grows a new ..N suffix every renewal, which would fork a fresh
        # row per renewal cycle (the reference keys on the token too).
        original_transaction_id=token,
        product_id=product_id,
        purchase_time=float(data.get("startTimeMillis", 0)) / 1000,
        expire_time=expiry_ms / 1000,
        environment=(
            ENV_SANDBOX
            if data.get("purchaseType") == 0
            else ENV_PRODUCTION
        ),
        raw_response=data,
    )


# --------------------------------------------------------------- google


def _google_service_jwt(client_email: str, private_key_pem: str) -> str:
    """RS256 service-account grant JWT (reference iap.go Google auth)."""
    from ..utils import rsa

    def b64u(data: bytes) -> str:
        return base64.urlsafe_b64encode(data).rstrip(b"=").decode()

    now = int(time.time())
    header = {"alg": "RS256", "typ": "JWT"}
    claims = {
        "iss": client_email,
        "scope": "https://www.googleapis.com/auth/androidpublisher",
        "aud": GOOGLE_TOKEN_URL,
        "iat": now,
        "exp": now + 3600,
    }
    signing = (
        b64u(json.dumps(header).encode())
        + "."
        + b64u(json.dumps(claims).encode())
    )
    key = rsa.load_pem_private_key(private_key_pem)
    sig = key.sign(signing.encode())
    return signing + "." + b64u(sig)


async def google_access_token(
    client_email: str, private_key_pem: str, fetch=None
) -> str:
    """Service-account JWT grant → androidpublisher access token (shared
    by receipt validation and the refund scheduler)."""
    fetch = fetch or _default_fetch
    grant = _google_service_jwt(client_email, private_key_pem)
    status, body = await fetch(
        GOOGLE_TOKEN_URL,
        method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded"},
        body=(
            "grant_type=urn%3Aietf%3Aparams%3Aoauth%3A"
            f"grant-type%3Ajwt-bearer&assertion={grant}"
        ).encode(),
    )
    if status != 200:
        raise IAPError(f"google token grant failed: HTTP {status}")
    access_token = json.loads(body).get("access_token", "")
    if not access_token:
        raise IAPError("google token grant returned no access token")
    return access_token


async def validate_receipt_google(
    client_email: str,
    private_key_pem: str,
    receipt: str,
    fetch=None,
) -> list[ValidatedPurchase]:
    """receipt = the Play purchase JSON (packageName/productId/
    purchaseToken); validated via androidpublisher products.get after a
    service-account token grant (reference iap.go:396)."""
    if not client_email or not private_key_pem:
        raise IAPError("google IAP credentials not configured")
    fetch = fetch or _default_fetch
    try:
        purchase = json.loads(receipt)
    except ValueError:
        raise IAPError("google receipt must be the purchase JSON")
    package = purchase.get("packageName", "")
    product_id = purchase.get("productId", "")
    token = purchase.get("purchaseToken", "")
    if not (package and product_id and token):
        raise IAPError("google receipt missing fields")

    access_token = await google_access_token(
        client_email, private_key_pem, fetch
    )

    import urllib.parse as _up

    # Client-controlled path components MUST be escaped or a crafted
    # purchaseToken steers the service-account-authenticated GET to an
    # attacker-chosen googleapis path.
    url = (
        f"{GOOGLE_PUBLISHER_URL}/androidpublisher/v3/applications/"
        f"{_up.quote(package, safe='')}/purchases/products/"
        f"{_up.quote(product_id, safe='')}/tokens/"
        f"{_up.quote(token, safe='')}"
    )
    status, body = await fetch(
        url, headers={"Authorization": f"Bearer {access_token}"}
    )
    if status != 200:
        raise IAPError(f"google purchase lookup failed: HTTP {status}")
    data = json.loads(body)
    if data.get("purchaseState") != 0:
        raise IAPError("google purchase not in purchased state")
    return [
        ValidatedPurchase(
            store=STORE_GOOGLE,
            transaction_id=data.get("orderId", token),
            product_id=product_id,
            purchase_time=float(data.get("purchaseTimeMillis", 0)) / 1000,
            environment=(
                ENV_SANDBOX
                if data.get("purchaseType") == 0
                else ENV_PRODUCTION
            ),
            raw_response=data,
        )
    ]


# --------------------------------------------------------------- huawei


async def validate_receipt_huawei(
    client_id: str,
    client_secret: str,
    purchase_data: str,
    fetch=None,
) -> list[ValidatedPurchase]:
    """Huawei order verification (reference iap.go:798): client-credential
    token then purchase-token verify."""
    if not client_id or not client_secret:
        raise IAPError("huawei IAP credentials not configured")
    fetch = fetch or _default_fetch
    try:
        purchase = json.loads(purchase_data)
    except ValueError:
        raise IAPError("huawei receipt must be the purchase JSON")
    import urllib.parse

    status, body = await fetch(
        HUAWEI_TOKEN_URL,
        method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded"},
        body=urllib.parse.urlencode(
            {
                "grant_type": "client_credentials",
                "client_id": client_id,
                "client_secret": client_secret,
            }
        ).encode(),
    )
    if status != 200:
        raise IAPError(f"huawei token grant failed: HTTP {status}")
    access_token = json.loads(body).get("access_token", "")
    auth = base64.b64encode(
        f"APPAT:{access_token}".encode()
    ).decode()
    status, body = await fetch(
        HUAWEI_ORDER_URL,
        method="POST",
        headers={
            "Authorization": f"Basic {auth}",
            "Content-Type": "application/json",
        },
        body=json.dumps(
            {
                "purchaseToken": purchase.get("purchaseToken", ""),
                "productId": purchase.get("productId", ""),
            }
        ).encode(),
    )
    if status != 200:
        raise IAPError(f"huawei verify failed: HTTP {status}")
    data = json.loads(body)
    if str(data.get("responseCode")) != "0":
        raise IAPError("huawei purchase rejected")
    inner = json.loads(data.get("purchaseTokenData") or "{}")
    return [
        ValidatedPurchase(
            store=STORE_HUAWEI,
            transaction_id=inner.get("orderId", ""),
            product_id=inner.get("productId", ""),
            purchase_time=float(inner.get("purchaseTime", 0)) / 1000,
            environment=ENV_PRODUCTION,
            raw_response=data,
        )
    ]

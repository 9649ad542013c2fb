"""Session + refresh JWTs (HS256), stdlib-only.

Parity with the reference's token scheme (reference server/core_session.go):
HS256-signed tokens carrying token id, user id, username, vars, and expiry;
validity additionally gated by the in-memory session cache so logout/ban
invalidates live tokens.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import uuid
from dataclasses import dataclass, field


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(data: str) -> bytes:
    return base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))


_HEADER = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())


class TokenError(ValueError):
    pass


@dataclass
class SessionClaims:
    token_id: str
    user_id: str
    username: str
    expires_at: float
    vars: dict[str, str] = field(default_factory=dict)


def generate(
    key: str,
    user_id: str,
    username: str,
    expiry_sec: int,
    vars: dict[str, str] | None = None,
    token_id: str | None = None,
) -> tuple[str, SessionClaims]:
    claims = SessionClaims(
        token_id=token_id or str(uuid.uuid4()),
        user_id=user_id,
        username=username,
        expires_at=time.time() + expiry_sec,
        vars=vars or {},
    )
    payload = {
        "tid": claims.token_id,
        "uid": claims.user_id,
        "usn": claims.username,
        "exp": int(claims.expires_at),
        "vrs": claims.vars,
    }
    signing_input = _HEADER + "." + _b64(json.dumps(payload).encode())
    sig = hmac.new(
        key.encode(), signing_input.encode(), hashlib.sha256
    ).digest()
    return signing_input + "." + _b64(sig), claims


def parse(key: str, token: str) -> SessionClaims:
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
    except ValueError as e:
        raise TokenError("malformed token") from e
    signing_input = header_b64 + "." + payload_b64
    expected = hmac.new(
        key.encode(), signing_input.encode(), hashlib.sha256
    ).digest()
    if not hmac.compare_digest(expected, _unb64(sig_b64)):
        raise TokenError("bad signature")
    try:
        payload = json.loads(_unb64(payload_b64))
    except (ValueError, UnicodeDecodeError) as e:
        raise TokenError("bad payload") from e
    exp = float(payload.get("exp", 0))
    if exp < time.time():
        raise TokenError("expired")
    return SessionClaims(
        token_id=str(payload.get("tid", "")),
        user_id=str(payload.get("uid", "")),
        username=str(payload.get("usn", "")),
        expires_at=exp,
        vars=dict(payload.get("vrs") or {}),
    )

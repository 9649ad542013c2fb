"""Token-verification primitives for the social providers.

Parity: the crypto halves of reference social/social.go — RS256 id_token
verification against a provider JWKS (Google :370, Apple :700, Facebook
Limited Login :225) and the GameCenter RSA-SHA256 signature check over
player/bundle/timestamp/salt (:520). Network fetches go through an
injectable fetcher so the logic is testable offline and cacheable like
the reference's JWKS cache.

The port's copy of the JAX package's `social/verify.py`, over the
port's own `utils/rsa.py` instead of `cryptography`, with the same
results and errors.
"""

from __future__ import annotations

import base64
import json
import struct
import time

from ..utils import rsa


class VerifyError(Exception):
    pass


def _unb64(data: str) -> bytes:
    return base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))


def jwk_to_public_key(jwk: dict) -> rsa.PublicKey:
    """RSA JWK {n, e} → public key object."""
    if jwk.get("kty") != "RSA":
        raise VerifyError(f"unsupported JWK kty {jwk.get('kty')!r}")
    return rsa.jwk_public_key(jwk)


def decode_jwt_unverified(token: str) -> tuple[dict, dict, bytes, bytes]:
    """(header, claims, signing_input, signature) without verification."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_unb64(header_b64))
        claims = json.loads(_unb64(payload_b64))
        signature = _unb64(sig_b64)
    except (ValueError, TypeError) as e:
        raise VerifyError("malformed JWT") from e
    if not isinstance(header, dict) or not isinstance(claims, dict):
        raise VerifyError("malformed JWT")
    return header, claims, f"{header_b64}.{payload_b64}".encode(), signature


def verify_id_token(
    token: str,
    jwks: dict,
    *,
    issuers: tuple[str, ...],
    audience: str | None = None,
    now: float | None = None,
) -> dict:
    """Verify an RS256 id_token against a JWKS document ({"keys": [...]})
    and check iss/aud/exp; returns the claims (reference Google/Apple
    id_token paths)."""
    header, claims, signing_input, signature = decode_jwt_unverified(token)
    if header.get("alg") != "RS256":
        raise VerifyError(f"unsupported JWT alg {header.get('alg')!r}")
    kid = header.get("kid")
    keys = jwks.get("keys", [])
    candidates = [k for k in keys if kid is None or k.get("kid") == kid]
    if not candidates:
        raise VerifyError("no matching JWKS key")
    for jwk in candidates:
        try:
            jwk_to_public_key(jwk).verify(signature, signing_input)
            break
        except rsa.InvalidSignature:
            continue
    else:
        raise VerifyError("JWT signature verification failed")
    if claims.get("iss") not in issuers:
        raise VerifyError(f"unexpected issuer {claims.get('iss')!r}")
    if audience:
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise VerifyError("token audience mismatch")
    exp = claims.get("exp")
    if exp is not None and float(exp) < (now or time.time()):
        raise VerifyError("token expired")
    return claims


def verify_gamecenter_signature(
    cert_der: bytes,
    player_id: str,
    bundle_id: str,
    timestamp: int,
    salt: bytes,
    signature: bytes,
) -> None:
    """GameCenter: RSA-SHA256 over playerId|bundleId|timestamp_be64|salt
    with the public key from Apple's signature certificate (reference
    social.go:520 CheckGameCenterID). A certificate whose key is not RSA
    raises TypeError, as the JAX verifier's PKCS#1 v1.5 call on such a
    key does."""
    try:
        key = rsa.load_der_certificate_public_key(cert_der)
    except rsa.RSAError as e:
        if str(e) == "the key is not an RSA key":
            raise TypeError(
                "gamecenter certificate key is not RSA: PKCS#1 v1.5"
                " verification does not apply") from e
        raise VerifyError("invalid gamecenter certificate") from e
    payload = (
        player_id.encode()
        + bundle_id.encode()
        + struct.pack(">Q", int(timestamp))
        + salt
    )
    try:
        key.verify(signature, payload)
    except rsa.InvalidSignature as e:
        raise VerifyError("gamecenter signature mismatch") from e

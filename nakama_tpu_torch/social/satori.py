"""Satori LiveOps client.

Parity: reference internal/satori/satori.go (:21-123) — a thin HTTPS
client for Heroic's LiveOps service exposed to runtimes via
`nk.get_satori()`: authenticate (identity JWT signed with the api key),
event publishing, and experiment/flag/live-event reads. Network rides
the shared pooled fetcher; an unconfigured client raises cleanly so
runtime code can feature-gate on it (reference returns ErrSatoriConfigurationInvalid).
The port's copy of the JAX package's `social/satori.py`."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse


class SatoriError(Exception):
    pass


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


class SatoriClient:
    def __init__(
        self,
        url: str = "",
        api_key_name: str = "",
        api_key: str = "",
        signing_key: str = "",
        fetch=None,
    ):
        self.url = url.rstrip("/")
        self.api_key_name = api_key_name
        self.api_key = api_key
        self.signing_key = signing_key
        if fetch is None:
            from ..utils.httpfetch import fetch as fetch_default

            fetch = fetch_default
        self._fetch = fetch

    @property
    def configured(self) -> bool:
        return bool(
            self.url and self.api_key_name
            and (self.signing_key or self.api_key)
        )

    def _require(self):
        if not self.configured:
            raise SatoriError("satori is not configured")

    def _token(self, identity_id: str) -> str:
        """HS256 identity JWT the reference's generateToken builds."""
        header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        now = int(time.time())
        claims = _b64(
            json.dumps(
                {
                    "sid": identity_id,
                    "iid": identity_id,
                    "api": self.api_key_name,
                    "iat": now,
                    "exp": now + 3600,
                }
            ).encode()
        )
        signing = f"{header}.{claims}"
        sig = hmac.new(
            self.signing_key.encode(), signing.encode(), hashlib.sha256
        ).digest()
        return f"{signing}.{_b64(sig)}"

    async def _call(
        self, path: str, identity_id: str, method="GET", body=None,
        query: dict | None = None,
    ):
        self._require()
        url = self.url + path
        if query:
            url += "?" + urllib.parse.urlencode(query, doseq=True)
        status, data = await self._fetch(
            url,
            method=method,
            headers={
                "Authorization": f"Bearer {self._token(identity_id)}",
                "Content-Type": "application/json",
            },
            body=json.dumps(body).encode() if body is not None else None,
        )
        if status >= 400:
            raise SatoriError(f"satori {path} failed: HTTP {status}")
        try:
            return json.loads(data) if data else {}
        except ValueError as e:
            raise SatoriError("satori returned invalid JSON") from e

    # ------------------------------------------------------------- surface

    async def authenticate(self, identity_id: str) -> dict:
        """Authenticate presents the API KEY via basic auth (reference
        satori.go Authenticate); the per-identity JWT covers the rest."""
        self._require()
        auth = base64.b64encode(f"{self.api_key}:".encode()).decode()
        status, data = await self._fetch(
            self.url + "/v1/authenticate",
            method="POST",
            headers={
                "Authorization": f"Basic {auth}",
                "Content-Type": "application/json",
            },
            body=json.dumps({"id": identity_id}).encode(),
        )
        if status >= 400:
            raise SatoriError(f"satori authenticate failed: HTTP {status}")
        try:
            return json.loads(data) if data else {}
        except ValueError as e:
            raise SatoriError("satori returned invalid JSON") from e

    async def events_publish(
        self, identity_id: str, events: list[dict]
    ) -> dict:
        return await self._call(
            "/v1/event", identity_id, method="POST",
            body={"events": events},
        )

    async def experiments_list(
        self, identity_id: str, names: list[str] | None = None
    ) -> dict:
        return await self._call(
            "/v1/experiment", identity_id,
            query={"names": names or []},
        )

    async def flags_list(
        self, identity_id: str, names: list[str] | None = None
    ) -> dict:
        return await self._call(
            "/v1/flag", identity_id, query={"names": names or []}
        )

    async def live_events_list(
        self, identity_id: str, names: list[str] | None = None
    ) -> dict:
        return await self._call(
            "/v1/live-event", identity_id, query={"names": names or []}
        )

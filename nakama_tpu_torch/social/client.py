"""Social provider verification clients.

The reference's `social.Client` (reference social/social.go) verifies
provider tokens and fetches profiles over HTTPS: Facebook Graph +
Limited-Login JWKS (:225), Facebook Instant signed payloads (:310), Google
id_token (:370), GameCenter signature check (:520), Steam web API (:610),
Apple Sign-In JWKS (:700). Here the same surface is an async interface;
`HttpSocialClient` is the production seam (its network behind an
injectable fetcher, by default the port's standard-library
`utils/httpfetch.py`), and `StubSocialClient` provides deterministic
offline verification:
- Facebook Instant payloads are HMAC-SHA256 checked against the configured
  app secret exactly like the reference (social.go:310-368);
- GameCenter inputs are shape-validated;
- bearer-style tokens map to profiles via a programmable table.

The port's copy of the JAX package's `social/client.py`.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
from dataclasses import dataclass


class SocialError(Exception):
    pass


@dataclass
class SocialProfile:
    provider: str
    id: str
    username: str = ""
    display_name: str = ""
    avatar_url: str = ""
    lang_tag: str = "en"
    email: str = ""


class SocialClient:
    """Interface; one async verify method per provider, plus friend-list
    fetchers for the social-graph import flows (reference social.go
    GetFacebookFriends / GetSteamFriends)."""

    async def verify_facebook(self, token: str) -> SocialProfile:
        raise SocialError("facebook verification unavailable")

    async def fetch_facebook_friends(self, token: str) -> list[str]:
        """Provider ids of the token-holder's friends who also use the
        app (Graph /me/friends only returns app users)."""
        raise SocialError("facebook friends unavailable")

    async def fetch_steam_friends(
        self, publisher_key: str, steam_id: str
    ) -> list[str]:
        raise SocialError("steam friends unavailable")

    async def verify_facebook_instant(
        self, app_secret: str, signed_player_info: str
    ) -> SocialProfile:
        """Signed-payload check, no network needed (reference
        social.go:310-368): payload is `sig.b64(json)` where sig =
        HMAC-SHA256(app_secret, payload-part)."""
        if not app_secret:
            # An empty secret would make the HMAC forgeable by anyone —
            # unconfigured must mean unavailable, not open.
            raise SocialError("facebook instant app secret not configured")
        try:
            sig_part, payload_part = signed_player_info.split(".", 1)
            expected = base64.urlsafe_b64decode(
                sig_part + "=" * (-len(sig_part) % 4)
            )
        except ValueError as e:
            raise SocialError("malformed signed player info") from e
        actual = hmac.new(
            app_secret.encode(), payload_part.encode(), hashlib.sha256
        ).digest()
        if not hmac.compare_digest(expected, actual):
            raise SocialError("signed player info signature mismatch")
        try:
            data = json.loads(
                base64.urlsafe_b64decode(
                    payload_part + "=" * (-len(payload_part) % 4)
                )
            )
        except ValueError as e:
            raise SocialError("malformed signed player info") from e
        if not isinstance(data, dict):
            raise SocialError("malformed signed player info")
        player_id = data.get("player_id", "")
        if not player_id:
            raise SocialError("missing player_id")
        return SocialProfile(provider="facebook_instant_game", id=player_id)

    async def verify_google(self, token: str) -> SocialProfile:
        raise SocialError("google verification unavailable")

    async def verify_gamecenter(
        self,
        player_id: str,
        bundle_id: str,
        timestamp: int,
        salt: str,
        signature: str,
        public_key_url: str,
    ) -> SocialProfile:
        raise SocialError("gamecenter verification unavailable")

    async def verify_steam(
        self, app_id: int, publisher_key: str, token: str
    ) -> SocialProfile:
        raise SocialError("steam verification unavailable")

    async def verify_apple(self, bundle_id: str, token: str) -> SocialProfile:
        raise SocialError("apple verification unavailable")


class HttpSocialClient(SocialClient):
    """Production verifier: the reference's HTTPS flows (social.go) with
    the network behind an injectable async `fetch(url) -> (status, bytes)`
    so tests run offline and deployments can add caching/proxies. JWKS
    documents are cached per URL with a TTL like the reference's in-client
    JWKS caching."""

    GOOGLE_JWKS = "https://www.googleapis.com/oauth2/v3/certs"
    GOOGLE_ISSUERS = ("https://accounts.google.com", "accounts.google.com")
    APPLE_JWKS = "https://appleid.apple.com/auth/keys"
    APPLE_ISSUERS = ("https://appleid.apple.com",)
    FACEBOOK_GRAPH = "https://graph.facebook.com/v11.0/me"
    FACEBOOK_FRIENDS = "https://graph.facebook.com/v11.0/me/friends"
    STEAM_AUTH = (
        "https://partner.steam-api.com/ISteamUserAuth/"
        "AuthenticateUserTicket/v1/"
    )
    STEAM_FRIENDS = (
        "https://partner.steam-api.com/ISteamUser/GetFriendList/v1/"
    )

    def __init__(self, fetch=None, jwks_ttl_sec: float = 3600.0):
        if fetch is None:
            fetch = _default_fetch
        self._fetch = fetch
        self._jwks_cache: dict[str, tuple[float, dict]] = {}
        self._jwks_ttl = jwks_ttl_sec

    async def _jwks(self, url: str) -> dict:
        import time as _time

        cached = self._jwks_cache.get(url)
        if cached is not None and cached[0] > _time.monotonic():
            return cached[1]
        status, body = await self._fetch(url)
        if status != 200:
            raise SocialError(f"JWKS fetch failed: HTTP {status}")
        try:
            jwks = json.loads(body)
        except ValueError as e:
            raise SocialError("JWKS fetch returned invalid JSON") from e
        self._jwks_cache[url] = (
            _time.monotonic() + self._jwks_ttl, jwks
        )
        return jwks

    async def verify_google(self, token: str) -> SocialProfile:
        """Google Sign-In id_token (reference social.go:370 CheckGoogleToken:
        JWKS signature + issuer check)."""
        from .verify import VerifyError, verify_id_token

        try:
            claims = verify_id_token(
                token,
                await self._jwks(self.GOOGLE_JWKS),
                issuers=self.GOOGLE_ISSUERS,
            )
        except VerifyError as e:
            raise SocialError(str(e)) from e
        if not claims.get("sub"):
            raise SocialError("google token missing subject")
        return SocialProfile(
            provider="google",
            id=claims["sub"],
            username=claims.get("given_name", ""),
            display_name=claims.get("name", ""),
            avatar_url=claims.get("picture", ""),
            email=claims.get("email", ""),
        )

    async def verify_apple(self, bundle_id: str, token: str) -> SocialProfile:
        """Sign in with Apple id_token (reference social.go:700
        CheckAppleToken: JWKS + iss + aud=bundle id)."""
        from .verify import VerifyError, verify_id_token

        if not bundle_id:
            raise SocialError("apple bundle id not configured")
        try:
            claims = verify_id_token(
                token,
                await self._jwks(self.APPLE_JWKS),
                issuers=self.APPLE_ISSUERS,
                audience=bundle_id,
            )
        except VerifyError as e:
            raise SocialError(str(e)) from e
        if not claims.get("sub"):
            raise SocialError("apple token missing subject")
        return SocialProfile(
            provider="apple",
            id=claims["sub"],
            email=claims.get("email", ""),
        )

    async def verify_facebook(self, token: str) -> SocialProfile:
        """Facebook Graph profile fetch (reference social.go:225
        GetFacebookProfile)."""
        import urllib.parse

        url = (
            f"{self.FACEBOOK_GRAPH}?fields=id,name,email,picture"
            f"&access_token={urllib.parse.quote(token, safe='')}"
        )
        status, body = await self._fetch(url)
        if status != 200:
            raise SocialError(f"facebook token rejected: HTTP {status}")
        try:
            data = json.loads(body)
        except ValueError as e:
            raise SocialError("facebook graph returned invalid JSON") from e
        if not data.get("id"):
            raise SocialError("facebook token rejected")
        return SocialProfile(
            provider="facebook",
            id=data["id"],
            display_name=data.get("name", ""),
            email=data.get("email", ""),
        )

    async def fetch_facebook_friends(self, token: str) -> list[str]:
        """Paginated Graph friends walk (reference social.go:283
        GetFacebookFriends follows paging.next)."""
        import urllib.parse

        url = (
            f"{self.FACEBOOK_FRIENDS}"
            f"?access_token={urllib.parse.quote(token, safe='')}"
        )
        ids: list[str] = []
        for _ in range(32):  # runaway-paging guard
            status, body = await self._fetch(url)
            if status != 200:
                raise SocialError(
                    f"facebook friends fetch failed: HTTP {status}"
                )
            try:
                data = json.loads(body)
            except ValueError as e:
                raise SocialError(
                    "facebook graph returned invalid JSON"
                ) from e
            ids.extend(
                str(f["id"]) for f in data.get("data", []) if f.get("id")
            )
            url = (data.get("paging") or {}).get("next") or ""
            if not url:
                break
        else:
            import logging

            logging.getLogger("nakama_tpu_torch.social").warning(
                "facebook friends import truncated at 32 pages"
                " (%d ids fetched); remaining friends skipped",
                len(ids),
            )
        return ids

    async def fetch_steam_friends(
        self, publisher_key: str, steam_id: str
    ) -> list[str]:
        """ISteamUser friend list (reference social.go:653
        GetSteamFriends)."""
        import urllib.parse

        if not publisher_key:
            raise SocialError("steam not configured")
        q = urllib.parse.urlencode(
            {
                "key": publisher_key,
                "steamid": steam_id,
                "relationship": "friend",
            }
        )
        status, body = await self._fetch(f"{self.STEAM_FRIENDS}?{q}")
        if status != 200:
            raise SocialError(f"steam friends fetch failed: HTTP {status}")
        try:
            data = json.loads(body)
        except ValueError as e:
            raise SocialError("steam returned invalid JSON") from e
        friends = (data.get("friendslist") or {}).get("friends") or []
        return [str(f["steamid"]) for f in friends if f.get("steamid")]

    async def verify_steam(
        self, app_id: int, publisher_key: str, token: str
    ) -> SocialProfile:
        """Steam session-ticket auth (reference social.go:610
        CheckSteamToken via ISteamUserAuth)."""
        import urllib.parse

        if not app_id or not publisher_key:
            raise SocialError("steam not configured")
        q = urllib.parse.urlencode(
            {"key": publisher_key, "appid": app_id, "ticket": token}
        )
        url = f"{self.STEAM_AUTH}?{q}"
        status, body = await self._fetch(url)
        if status != 200:
            raise SocialError(f"steam auth failed: HTTP {status}")
        try:
            data = json.loads(body)
        except ValueError as e:
            raise SocialError("steam returned invalid JSON") from e
        params = (data.get("response") or {}).get("params") or {}
        if params.get("result") != "OK" or not params.get("steamid"):
            raise SocialError("steam ticket rejected")
        return SocialProfile(provider="steam", id=str(params["steamid"]))

    async def verify_gamecenter(
        self,
        player_id: str,
        bundle_id: str,
        timestamp: int,
        salt: str,
        signature: str,
        public_key_url: str,
    ) -> SocialProfile:
        """GameCenter signature verification (reference social.go:520):
        the certificate URL must be an Apple HTTPS host, then RSA-SHA256
        over playerId|bundleId|timestamp|salt."""
        import urllib.parse

        from .verify import VerifyError, verify_gamecenter_signature

        if not (player_id and bundle_id and salt and signature):
            raise SocialError("incomplete gamecenter credentials")
        parsed = urllib.parse.urlsplit(public_key_url)
        host = parsed.hostname or ""
        if parsed.scheme != "https" or not (
            host == "apple.com" or host.endswith(".apple.com")
        ):
            raise SocialError("invalid gamecenter public key url")
        status, cert_der = await self._fetch(public_key_url)
        if status != 200:
            raise SocialError(
                f"gamecenter certificate fetch failed: HTTP {status}"
            )
        try:
            verify_gamecenter_signature(
                cert_der,
                player_id,
                bundle_id,
                timestamp,
                base64.b64decode(salt),
                base64.b64decode(signature),
            )
        except (VerifyError, ValueError) as e:
            raise SocialError(str(e)) from e
        return SocialProfile(provider="gamecenter", id=player_id)


def _default_fetch(url: str):
    from ..utils.httpfetch import fetch

    return fetch(url)


class StubSocialClient(SocialClient):
    """Offline deterministic verifier for tests/dev: `register(provider,
    token, profile)` then the matching verify_* accepts that token."""

    def __init__(self):
        self._known: dict[tuple[str, str], SocialProfile] = {}
        self._friends: dict[tuple[str, str], list[str]] = {}

    def register(self, provider: str, token: str, profile: SocialProfile):
        self._known[(provider, token)] = profile

    def register_friends(
        self, provider: str, key: str, provider_ids: list[str]
    ):
        """key = access token for facebook, steam_id for steam."""
        self._friends[(provider, key)] = list(provider_ids)

    async def fetch_facebook_friends(self, token: str) -> list[str]:
        return list(self._friends.get(("facebook", token), []))

    async def fetch_steam_friends(
        self, publisher_key: str, steam_id: str
    ) -> list[str]:
        return list(self._friends.get(("steam", steam_id), []))

    def _lookup(self, provider: str, token: str) -> SocialProfile:
        profile = self._known.get((provider, token))
        if profile is None:
            raise SocialError(f"invalid {provider} token")
        return profile

    async def verify_facebook(self, token: str) -> SocialProfile:
        return self._lookup("facebook", token)

    async def verify_google(self, token: str) -> SocialProfile:
        return self._lookup("google", token)

    async def verify_steam(
        self, app_id: int, publisher_key: str, token: str
    ) -> SocialProfile:
        return self._lookup("steam", token)

    async def verify_apple(self, bundle_id: str, token: str) -> SocialProfile:
        return self._lookup("apple", token)

    async def verify_gamecenter(
        self,
        player_id: str,
        bundle_id: str,
        timestamp: int,
        salt: str,
        signature: str,
        public_key_url: str,
    ) -> SocialProfile:
        if not player_id or not bundle_id or not salt or not signature:
            raise SocialError("incomplete gamecenter credentials")
        return self._lookup("gamecenter", player_id)

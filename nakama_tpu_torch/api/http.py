"""HTTP request/response API + the /ws socket on one port.

Parity with the reference ApiServer (reference server/api.go:87-226):
the JAX package's `api/http.py` routes `/`, `/healthcheck` and
`/v2/healthcheck`, `/ws`, the nine `/v2/account/authenticate/*`
providers (server-key Basic auth; the six social ones verified by the
server's social client), `/v2/account/session/refresh` and
`/v2/session/logout`, the account, user, link and unlink routes,
storage, friends with the Facebook and Steam imports, groups,
notifications, channel history, `/v2/match`, the leaderboard and
tournament record routes, the IAP purchase and subscription routes
(`Purchases`), and `/v2/rpc/{id}` (GET and POST) and `/v2/event` into
the runtime, behind the same overload middleware (admission classes,
exempt paths, 429 + Retry-After, 504, the `traceparent` echo) and with
the same error bodies (`{"error", "message", "code"}`) and status codes
(`_map_error`); a path it does not route is 404, a method it does not
route on a known path 405. The runtime's before- and after-request
hooks run where the JAX server runs them (`_hooked`, `_after`): every
authenticate, `updateaccount`, `readstorageobjects`,
`writestorageobjects`, `addfriends`, `importfacebookfriends`,
`importsteamfriends`, `creategroup` and `writeleaderboardrecord`; with
no hook registered a request passes through unchanged.

It runs over `wsproto` (the port's standard-library HTTP/1.1 and
WebSocket transport), not `aiohttp`. The metrics listener serves the
registry's exposition at `/metrics` on the metrics section's
`prometheus_port` (0 = off, -1 = an ephemeral port), as the JAX
console's does.
"""

from __future__ import annotations

import asyncio
import base64
import json
import re
import time
import urllib.parse
from typing import Any

from .. import overload
from .. import tracing as trace_api
from ..core import account as core_account
from ..core import authenticate as core_auth
from ..core import link as core_link
from ..core import storage as core_storage
from ..core.authenticate import AuthError
from ..core.channel import ChannelError, channel_id_to_stream
from ..core.friend import FriendError
from ..core.group import ADMIN, MEMBER, SUPERADMIN, GroupError
from ..core.notification import NotificationError
from ..core.storage import (
    StorageError,
    StorageOpDelete,
    StorageOpRead,
    StorageOpWrite,
    StoragePermissionError,
    StorageVersionError,
)
from ..core.wallet import WalletError
from ..iap import IAPError
from ..leaderboard import LeaderboardError
from ..realtime import StreamMode
from ..social.client import SocialError
from . import session_token
from .wsproto import HttpRequest, HttpResponse, HttpServer, json_response

GRPC_UNAUTHENTICATED = 16
GRPC_PERMISSION_DENIED = 7
GRPC_NOT_FOUND = 5
GRPC_ALREADY_EXISTS = 6
GRPC_INVALID_ARGUMENT = 3
GRPC_DEADLINE_EXCEEDED = 4
GRPC_RESOURCE_EXHAUSTED = 8
GRPC_INTERNAL = 13
GRPC_UNIMPLEMENTED = 12

_AUTH_CODE_TO_HTTP = {
    "not_found": (404, GRPC_NOT_FOUND),
    "already_exists": (409, GRPC_ALREADY_EXISTS),
    "unauthenticated": (401, GRPC_UNAUTHENTICATED),
    "permission_denied": (403, GRPC_PERMISSION_DENIED),
}

_PROVIDERS = (
    "device", "email", "custom", "apple", "facebook", "facebookinstantgame",
    "gamecenter", "google", "steam",
)


def _pattern(path: str) -> re.Pattern:
    return re.compile("^" + re.sub(r"\{[^}]+\}", "[^/]+", path) + "$")


class ApiError(Exception):
    def __init__(self, message: str, status: int, grpc_code: int):
        super().__init__(message)
        self.status = status
        self.grpc_code = grpc_code


def _error_response(
    message: str, status: int, grpc_code: int, headers: dict | None = None
) -> HttpResponse:
    return json_response(
        {"error": message, "message": message, "code": grpc_code},
        status=status,
        headers=headers,
    )


def _text_response(status: int, text: str) -> HttpResponse:
    return HttpResponse(
        status, text.encode(), content_type="text/plain; charset=utf-8"
    )


# Paths outside admission control: health/index must answer even under
# SHED (that's how operators see the server is alive), and /ws is a
# long-lived upgrade — holding a permit for a connection's lifetime
# would exhaust the pool, so realtime admission is per-envelope in the
# pipeline instead.
_OVERLOAD_EXEMPT = frozenset({"/", "/healthcheck", "/v2/healthcheck", "/ws"})


class ApiServer:
    """Routes + auth middleware over the NakamaServer's components."""

    def __init__(self, server):
        self.server = server
        self.config = server.config
        self.logger = server.logger.with_fields(subsystem="api")
        sc = self.config.socket
        self._http = HttpServer(
            self._handle,
            max_request_size=sc.max_request_size_bytes,
            idle_timeout_s=sc.idle_timeout_ms / 1000.0,
            logger=self.logger,
            # An oversized request reaches the handler unread; its JSON parse
            # refuses it as the JAX server's does (400 "invalid JSON
            # body"); a route that reads no body answers as usual.
            oversize_to_handler=True,
        )
        self._metrics_http: HttpServer | None = None
        self.port: int | None = None
        self.metrics_port: int | None = None
        routes: list[tuple[str, str, Any]] = [
            ("GET", "/", self._h_index),
            ("GET", "/healthcheck", self._h_healthcheck),
            ("GET", "/v2/healthcheck", self._h_healthcheck),
            ("GET", "/ws", self._h_ws),
            ("POST", "/v2/account/session/refresh", self._h_session_refresh),
            ("POST", "/v2/session/logout", self._h_session_logout),
        ]
        for provider in _PROVIDERS:
            routes += [
                ("POST", f"/v2/account/authenticate/{provider}",
                 self._make_authenticate(provider)),
                ("POST", f"/v2/account/link/{provider}",
                 self._make_link(provider, linking=True)),
                ("POST", f"/v2/account/unlink/{provider}",
                 self._make_link(provider, linking=False)),
            ]
        routes += [
            ("GET", "/v2/account", self._h_account_get),
            ("PUT", "/v2/account", self._h_account_update),
            ("DELETE", "/v2/account", self._h_account_delete),
            ("GET", "/v2/user", self._h_users_get),
            ("POST", "/v2/storage", self._h_storage_read),
            ("PUT", "/v2/storage", self._h_storage_write),
            ("PUT", "/v2/storage/delete", self._h_storage_delete),
            ("GET", "/v2/storage/{collection}", self._h_storage_list),
            ("GET", "/v2/storage/{collection}/{user_id}",
             self._h_storage_list),
            ("GET", "/v2/match", self._h_match_list),
            ("GET", "/v2/leaderboard/{id}", self._h_lb_records_list),
            ("POST", "/v2/leaderboard/{id}", self._h_lb_record_write),
            ("DELETE", "/v2/leaderboard/{id}", self._h_lb_record_delete),
            ("GET", "/v2/leaderboard/{id}/owner/{owner_id}",
             self._h_lb_haystack),
            ("GET", "/v2/tournament", self._h_tournament_list),
            ("GET", "/v2/tournament/{id}", self._h_t_records_list),
            ("POST", "/v2/tournament/{id}", self._h_t_record_write),
            ("POST", "/v2/tournament/{id}/join", self._h_t_join),
            ("DELETE", "/v2/tournament/{id}", self._h_t_record_delete),
            ("GET", "/v2/tournament/{id}/owner/{owner_id}",
             self._h_lb_haystack),
            ("GET", "/v2/channel/{channel_id}", self._h_channel_messages),
            ("GET", "/v2/friend", self._h_friend_list),
            ("POST", "/v2/friend", self._h_friend_add),
            ("DELETE", "/v2/friend", self._h_friend_delete),
            ("POST", "/v2/friend/block", self._h_friend_block),
            ("POST", "/v2/friend/facebook", self._h_friend_import_facebook),
            ("POST", "/v2/friend/steam", self._h_friend_import_steam),
            ("GET", "/v2/group", self._h_group_list),
            ("POST", "/v2/group", self._h_group_create),
            ("PUT", "/v2/group/{group_id}", self._h_group_update),
            ("DELETE", "/v2/group/{group_id}", self._h_group_delete),
            ("GET", "/v2/group/{group_id}/user", self._h_group_users),
            ("GET", "/v2/user/{user_id}/group", self._h_user_groups),
        ]
        routes += [
            ("POST", f"/v2/group/{{group_id}}/{action}",
             self._make_group_action(action))
            for action in ("join", "leave", "add", "kick", "ban", "promote",
                           "demote")
        ]
        routes += [
            ("GET", "/v2/notification", self._h_notification_list),
            ("DELETE", "/v2/notification", self._h_notification_delete),
            ("POST", "/v2/rpc/{id}", self._h_rpc),
            ("GET", "/v2/rpc/{id}", self._h_rpc),
            ("POST", "/v2/event", self._h_event),
        ]
        routes += [
            ("POST", f"/v2/iap/purchase/{store}", self._make_iap_validate(store))
            for store in ("apple", "google", "huawei")
        ]
        routes.append(("GET", "/v2/iap/subscription", self._h_subscription_list))
        routes += [
            ("POST", f"/v2/iap/subscription/{store}",
             self._make_subscription_validate(store))
            for store in ("apple", "google")
        ]
        routes.append(("GET", "/v2/iap/subscription/{original_transaction_id}",
                       self._h_subscription_get))
        # (method, path template) of every route: the console's endpoint
        # list.
        self.routes = [(m, p) for m, p, _ in routes]
        self._routes = [(m, _pattern(p), h) for m, p, h in routes]

    # ----------------------------------------------------------- lifecycle

    async def start(self, host: str, port: int) -> int:
        self.port = await self._http.start(host, port)
        metrics_cfg = self.config.metrics
        want = metrics_cfg.prometheus_port
        if want:
            # Prometheus exposition on its own internal listener (the
            # reference serves scrape on a dedicated port and treats 0
            # as disabled); -1 binds an ephemeral port.
            self._metrics_http = HttpServer(
                self._handle_metrics, max_request_size=0, logger=self.logger
            )
            self.metrics_port = await self._metrics_http.start(
                host, 0 if want < 0 else want
            )
        return self.port

    async def stop(self):
        """Stop both listeners; requests in flight finish, and open
        sockets stay until the server closes their sessions
        (`wait_closed`)."""
        if self._metrics_http is not None:
            await self._metrics_http.stop()
        await self._http.stop()

    async def wait_closed(self):
        if self._metrics_http is not None:
            await self._metrics_http.wait_closed()
            self._metrics_http = None
        await self._http.wait_closed()

    async def _handle_metrics(self, request: HttpRequest) -> HttpResponse:
        if request.path != "/metrics":
            return _text_response(404, "404: Not Found")
        return HttpResponse(
            200,
            self.server.metrics.scrape(),
            content_type="text/plain; version=0.0.4; charset=utf-8",
        )

    # ------------------------------------------------------------- routing

    def _route(self, request: HttpRequest):
        path = request.path
        known = False
        for method, pattern, handler in self._routes:
            if pattern.match(path):
                known = True
                if method == request.method:
                    return handler
        if known:
            return lambda _req: _async(
                _text_response(405, "405: Method Not Allowed")
            )
        return lambda _req: _async(_text_response(404, "404: Not Found"))

    async def _handle(self, request: HttpRequest) -> HttpResponse | None:
        handler = self._route(request)
        if request.path in _OVERLOAD_EXEMPT:
            return await handler(request)
        return await self._overload_middleware(request, handler)

    # ------------------------------------------------------------ overload

    def _rate_key(self, request: HttpRequest) -> str:
        """Rate-limiter key: client IP + the tail of the presented
        credential, so one NATed IP's users don't share a bucket but an
        unauthenticated flood from one address still does."""
        return f"{request.remote}|{request.headers.get('Authorization', '')[-16:]}"

    async def _overload_middleware(self, request: HttpRequest, handler):
        """The request-plane front door: one trace root span per
        request (W3C `traceparent` ingested from the request and
        emitted on every response — including 429/504 rejections, whose
        traces are error-status and therefore always tail-kept), the
        overload triad (overload.py) inside it, and the api-latency SLO
        observation on the way out."""
        ov = getattr(self.server, "overload", None)
        if not trace_api.TRACES.enabled:
            return await self._normalized(request, handler, ov)
        t0 = time.perf_counter()
        with trace_api.root_span(
            f"http {request.method} {request.path}",
            traceparent=request.headers.get("traceparent", ""),
            **{"http.method": request.method, "http.path": request.path},
        ) as root:
            resp = await self._normalized(request, handler, ov)
            if root is not None:
                root.set_attribute("http.status", resp.status)
                if resp.status in (429, 504) or resp.status >= 500:
                    root.set_status("error", f"http {resp.status}")
                resp.headers["traceparent"] = trace_api.current_traceparent()
            slo = getattr(self.server, "slo", None)
            if slo is not None:
                slo.observe(
                    "api_latency", (time.perf_counter() - t0) * 1000
                )
            return resp

    async def _normalized(self, request: HttpRequest, handler, ov):
        """Every request resolves to a RESPONSE here: a raw escape
        becomes the API's standard JSON 500, so the outage still gets
        its error trace, traceparent echo and SLO observation."""
        try:
            return await self._admitted(request, handler, ov)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.logger.error(
                "unhandled error in request middleware", error=str(e)
            )
            return _error_response("internal error", 500, GRPC_INTERNAL)

    async def _admitted(self, request: HttpRequest, handler, ov):
        """The overload triad (overload.py): deadline from
        `grpc-timeout`/`X-Request-Timeout` (else the per-class
        default), token-bucket rate limit, prioritized admission, and
        the deadline carried via contextvar into storage/matchmaker
        checkpoints. A request presenting a credential and not a GET is
        the RPC class; everything else the list class (realtime
        envelopes are classed in the pipeline)."""
        if ov is None:
            return await handler(request)
        cls = (
            overload.RPC
            if request.method != "GET"
            and (
                request.headers.get("Authorization")
                or request.query.get("http_key")
            )
            else overload.LIST
        )
        ocfg = self.config.overload
        default_ms = (
            ocfg.deadline_list_ms if cls == overload.LIST
            else ocfg.deadline_rpc_ms
        ) or ocfg.deadline_default_ms
        try:
            deadline = overload.deadline_from_headers(
                request.headers, default_ms
            )
        except ValueError as e:
            return _error_response(str(e), 400, GRPC_INVALID_ARGUMENT)
        limiter = ov.rate_limiter
        if limiter is not None and not limiter.allow(self._rate_key(request)):
            e = ov.admission.reject(cls, "rate_limited")
            return _error_response(
                str(e), 429, GRPC_RESOURCE_EXHAUSTED,
                headers={"Retry-After": str(int(e.retry_after_sec))},
            )
        try:
            with trace_api.span(
                "admission", **{"class": overload.CLASS_NAMES[cls]}
            ):
                await ov.admission.admit(cls, deadline)
        except overload.AdmissionRejected as e:
            return _error_response(
                str(e), 429, GRPC_RESOURCE_EXHAUSTED,
                headers={"Retry-After": str(int(e.retry_after_sec))},
            )
        except overload.DeadlineExceeded as e:
            self._note_deadline()
            return _error_response(str(e), 504, GRPC_DEADLINE_EXCEEDED)
        token = overload.set_deadline(deadline)
        try:
            if deadline.explicit:
                # A client-supplied timeout is ENFORCED: the handler is
                # cancelled at expiry and the caller gets their 504.
                try:
                    return await asyncio.wait_for(
                        handler(request), max(0.0, deadline.remaining())
                    )
                except asyncio.TimeoutError:
                    self._note_deadline()
                    return _error_response(
                        "deadline exceeded", 504, GRPC_DEADLINE_EXCEEDED
                    )
            return await handler(request)
        finally:
            overload.reset_deadline(token)
            ov.admission.release()

    def _note_deadline(self):
        metrics = getattr(self.server, "metrics", None)
        if metrics is not None:
            metrics.request_deadline_exceeded.labels(stage="http").inc()

    # ---------------------------------------------------------------- auth

    def _check_server_key(self, request: HttpRequest):
        """Basic auth with the server key (reference api.go:101
        securityInterceptorFunc for authenticate methods)."""
        header = request.headers.get("Authorization", "")
        if header.startswith("Basic "):
            try:
                decoded = base64.b64decode(header[6:]).decode()
            except Exception:
                decoded = ""
            key = decoded.split(":", 1)[0]
            if key == self.config.socket.server_key:
                return
        raise ApiError(
            "server key required", 401, GRPC_UNAUTHENTICATED
        )

    def _session(self, request: HttpRequest) -> session_token.SessionClaims:
        header = request.headers.get("Authorization", "")
        token = header[7:] if header.startswith("Bearer ") else ""
        if not token:
            token = request.query.get("token", "")
        if not token:
            raise ApiError(
                "auth token required", 401, GRPC_UNAUTHENTICATED
            )
        try:
            claims = session_token.parse(
                self.config.session.encryption_key, token
            )
        except session_token.TokenError as e:
            raise ApiError(str(e), 401, GRPC_UNAUTHENTICATED)
        if not self.server.session_cache.is_valid_session(
            claims.user_id, claims.token_id
        ):
            raise ApiError(
                "session invalidated", 401, GRPC_UNAUTHENTICATED
            )
        return claims

    def _issue_tokens(
        self, user_id: str, username: str, vars: dict | None = None
    ) -> dict:
        sc = self.config.session
        token, claims = session_token.generate(
            sc.encryption_key,
            user_id,
            username,
            sc.token_expiry_sec,
            vars=vars or {},
        )
        refresh, rclaims = session_token.generate(
            sc.refresh_encryption_key,
            user_id,
            username,
            sc.refresh_token_expiry_sec,
            vars=vars or {},
        )
        self.server.session_cache.add(
            user_id,
            claims.expires_at,
            claims.token_id,
            rclaims.expires_at,
            rclaims.token_id,
        )
        return {"token": token, "refresh_token": refresh}

    def _id(self, request: HttpRequest, index: int = 2) -> str:
        """A path segment, percent-decoded: index 2 is the one after
        `/v2/<kind>/` (`{id}`, `{collection}`, `{group_id}`, `{user_id}`,
        `{channel_id}`), 3 the storage owner, 4 `{owner_id}`."""
        return urllib.parse.unquote(request.path.split("/")[index + 1])

    async def _json(self, request: HttpRequest) -> dict:
        if request.body_too_large:
            raise ApiError(
                "invalid JSON body", 400, GRPC_INVALID_ARGUMENT
            )
        if not request.body:
            return {}
        try:
            body = request.json()
        except ValueError:
            raise ApiError(
                "invalid JSON body", 400, GRPC_INVALID_ARGUMENT
            )
        return body if isinstance(body, dict) else {}

    async def _hooked(self, method: str, ctx_claims, body: dict) -> dict:
        """Run the before-request hook and return the body it gives back;
        a None from the hook rejects the request with 403 (reference
        api_*.go: a nil return from a before hook aborts with 404/403)."""
        runtime = self.server.runtime
        if runtime is None:
            return body
        fn = runtime.before_req(method)
        if fn is None:
            return body
        ctx = runtime.context(mode="before")
        if ctx_claims is not None:
            ctx.user_id = ctx_claims.user_id
            ctx.username = ctx_claims.username
            ctx.vars = ctx_claims.vars
        result = fn(ctx, body)
        if asyncio.iscoroutine(result):
            result = await result
        if result is None:
            raise ApiError(
                "rejected by before hook", 403, GRPC_PERMISSION_DENIED
            )
        return result

    async def _after(self, method: str, ctx_claims, body: dict, result):
        runtime = self.server.runtime
        if runtime is None:
            return
        fn = runtime.after_req(method)
        if fn is None:
            return
        ctx = runtime.context(mode="after")
        if ctx_claims is not None:
            ctx.user_id = ctx_claims.user_id
            ctx.username = ctx_claims.username
        try:
            out = fn(ctx, body, result)
            if asyncio.iscoroutine(out):
                await out
        except Exception as e:
            self.logger.error(
                "after hook error", method=method, error=str(e)
            )

    # ------------------------------------------------------------- basics

    async def _h_index(self, request):
        return json_response({"name": self.config.name})

    async def _h_healthcheck(self, request):
        # DB reachability is the health signal (reference Healthcheck).
        try:
            await self.server.db.fetch_one("SELECT 1")
        except Exception as e:
            return _error_response(str(e), 500, GRPC_INTERNAL)
        return json_response({})

    async def _h_ws(self, request: HttpRequest):
        sc = self.config.socket
        ws = await request.accept_websocket(
            max_message_size=sc.max_message_size_bytes,
            ping_period_s=sc.ping_period_ms / 1000.0,
            pong_wait_s=sc.pong_wait_ms / 1000.0,
        )
        await self.server.acceptor.handle(ws)
        return None

    # ----------------------------------------------------- authentication

    def _make_authenticate(self, provider: str):
        async def handler(request: HttpRequest):
            try:
                self._check_server_key(request)
                body = await self._json(request)
                method = f"authenticate{provider}"
                body = await self._hooked(method, None, body)
                create = _parse_bool(
                    request.query.get("create", body.get("create", True))
                )
                username = request.query.get(
                    "username", body.get("username", "")
                )
                account = body.get("account", body)
                db = self.server.db
                if provider == "device":
                    user_id, uname, created = (
                        await core_auth.authenticate_device(
                            db, account.get("id", ""), username, create
                        )
                    )
                elif provider == "email":
                    user_id, uname, created = (
                        await core_auth.authenticate_email(
                            db,
                            account.get("email", ""),
                            account.get("password", ""),
                            username,
                            create,
                        )
                    )
                elif provider == "custom":
                    user_id, uname, created = (
                        await core_auth.authenticate_custom(
                            db, account.get("id", ""), username, create
                        )
                    )
                else:
                    user_id, uname, created = await self._social_auth(
                        provider, account, username, create
                    )
                result = {
                    "created": created,
                    **self._issue_tokens(
                        user_id, uname, body.get("vars") or {}
                    ),
                }
                await self._after(method, None, body, result)
                return json_response(result)
            except Exception as e:
                return self._map_error(e)

        return handler

    async def _social_auth(self, provider, account, username, create):
        """Per-provider dispatch into the social authenticate cores
        (each has its own credential shape — reference api_authenticate.go
        handlers)."""
        social = self.server.social
        if social is None:
            raise ApiError(
                f"{provider} authentication not configured",
                501,
                GRPC_UNIMPLEMENTED,
            )
        db = self.server.db
        sc = self.config.social
        token = account.get("token", "")
        if provider == "facebook":
            return await core_auth.authenticate_facebook(
                db, social, token, username, create
            )
        if provider == "facebookinstantgame":
            return await core_auth.authenticate_facebook_instant(
                db,
                social,
                sc.facebook_instant_app_secret,
                account.get("signed_player_info", ""),
                username,
                create,
            )
        if provider == "google":
            return await core_auth.authenticate_google(
                db, social, token, username, create
            )
        if provider == "apple":
            return await core_auth.authenticate_apple(
                db, social, sc.apple_bundle_id, token, username, create
            )
        if provider == "steam":
            return await core_auth.authenticate_steam(
                db,
                social,
                sc.steam_app_id,
                sc.steam_publisher_key,
                token,
                username,
                create,
            )
        if provider == "gamecenter":
            return await core_auth.authenticate_gamecenter(
                db,
                social,
                account.get("player_id", ""),
                account.get("bundle_id", ""),
                int(account.get("timestamp_seconds", 0)),
                account.get("salt", ""),
                account.get("signature", ""),
                account.get("public_key_url", ""),
                username,
                create,
            )
        raise ApiError("unknown provider", 400, GRPC_INVALID_ARGUMENT)

    async def _h_session_refresh(self, request: HttpRequest):
        try:
            self._check_server_key(request)
            body = await self._json(request)
            sc = self.config.session
            try:
                claims = session_token.parse(
                    sc.refresh_encryption_key, body.get("token", "")
                )
            except session_token.TokenError as e:
                raise ApiError(str(e), 401, GRPC_UNAUTHENTICATED)
            cache = self.server.session_cache
            if not cache.is_valid_refresh(claims.user_id, claims.token_id):
                raise ApiError(
                    "refresh token invalidated", 401, GRPC_UNAUTHENTICATED
                )
            # Rotation kills only the USED refresh token; live sessions on
            # other devices keep working and short-lived session tokens
            # age out naturally (reference SessionRefresh semantics).
            cache.remove_refresh(claims.user_id, claims.token_id)
            vars = dict(claims.vars)
            vars.update(body.get("vars") or {})
            result = {
                "created": False,
                **self._issue_tokens(claims.user_id, claims.username, vars),
            }
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_session_logout(self, request: HttpRequest):
        """Invalidate the presented session (+ the refresh token in the
        body, if given) — NOT every device's sessions (reference
        SessionLogout api_account.go)."""
        try:
            claims = self._session(request)
            cache = self.server.session_cache
            cache.remove_session(claims.user_id, claims.token_id)
            body = await self._json(request)
            refresh = body.get("refresh_token", "")
            if refresh:
                try:
                    rclaims = session_token.parse(
                        self.config.session.refresh_encryption_key, refresh
                    )
                    cache.remove_refresh(
                        rclaims.user_id, rclaims.token_id
                    )
                except session_token.TokenError:
                    pass
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    # ------------------------------------------------------------ account

    async def _h_account_get(self, request: HttpRequest):
        try:
            claims = self._session(request)
            account = await core_account.get_account(
                self.server.db, claims.user_id
            )
            return json_response(account)
        except Exception as e:
            return self._map_error(e)

    async def _h_account_update(self, request: HttpRequest):
        try:
            claims = self._session(request)
            body = await self._json(request)
            body = await self._hooked("updateaccount", claims, body)
            await core_account.update_account(
                self.server.db,
                claims.user_id,
                username=body.get("username"),
                display_name=body.get("display_name"),
                timezone=body.get("timezone"),
                location=body.get("location"),
                lang_tag=body.get("lang_tag"),
                avatar_url=body.get("avatar_url"),
            )
            await self._after("updateaccount", claims, body, {})
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    async def _h_account_delete(self, request: HttpRequest):
        """Deletes the account's rows, its board records included, in
        SQL; as in the JAX server, neither the rank cache nor the rank
        engine is told."""
        try:
            claims = self._session(request)
            await core_account.delete_account(
                self.server.db, claims.user_id, recorded=True
            )
            self.server.session_cache.remove_all(claims.user_id)
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    async def _h_users_get(self, request: HttpRequest):
        try:
            self._session(request)
            users = await core_account.get_users(
                self.server.db,
                user_ids=request.query_all("ids"),
                usernames=request.query_all("usernames"),
            )
            return json_response({"users": users})
        except Exception as e:
            return self._map_error(e)

    # ------------------------------------------------------- link/unlink

    def _make_link(self, provider: str, linking: bool):
        """Reference api_link.go: device, email and custom; the social
        providers verify with the server's social client to link and
        clear their column to unlink."""
        async def handler(request: HttpRequest):
            try:
                claims = self._session(request)
                body = await self._json(request)
                db = self.server.db
                uid = claims.user_id
                if provider == "device":
                    if linking:
                        await core_link.link_device(db, uid, body.get("id", ""))
                    else:
                        await core_link.unlink_device(
                            db, uid, body.get("id", "")
                        )
                elif provider == "email":
                    if linking:
                        await core_link.link_email(
                            db,
                            uid,
                            body.get("email", ""),
                            body.get("password", ""),
                        )
                    else:
                        await core_link.unlink_email(db, uid)
                elif provider == "custom":
                    if linking:
                        await core_link.link_custom(db, uid, body.get("id", ""))
                    else:
                        await core_link.unlink_custom(db, uid)
                elif not linking:
                    core_name = (
                        "facebook_instant"
                        if provider == "facebookinstantgame"
                        else provider
                    )
                    fn = getattr(core_link, f"unlink_{core_name}", None)
                    if fn is None:
                        raise ApiError(
                            f"{provider} unlink not available",
                            501,
                            GRPC_UNIMPLEMENTED,
                        )
                    await fn(db, uid)
                else:
                    await self._social_link(provider, uid, body)
                return json_response({})
            except Exception as e:
                return self._map_error(e)

        return handler

    async def _social_link(self, provider: str, uid: str, body: dict):
        """Per-provider social link dispatch (reference api_link.go)."""
        social = self.server.social
        if social is None:
            raise ApiError(
                f"{provider} linking not configured", 501, GRPC_UNIMPLEMENTED
            )
        db = self.server.db
        sc = self.config.social
        token = body.get("token", "")
        if provider == "facebook":
            await core_link.link_facebook(db, social, uid, token)
        elif provider == "facebookinstantgame":
            await core_link.link_facebook_instant(
                db,
                social,
                uid,
                sc.facebook_instant_app_secret,
                body.get("signed_player_info", ""),
            )
        elif provider == "google":
            await core_link.link_google(db, social, uid, token)
        elif provider == "apple":
            await core_link.link_apple(
                db, social, uid, sc.apple_bundle_id, token
            )
        elif provider == "steam":
            await core_link.link_steam(
                db, social, uid, sc.steam_app_id, sc.steam_publisher_key,
                token,
            )
        elif provider == "gamecenter":
            await core_link.link_gamecenter(
                db,
                social,
                uid,
                body.get("player_id", ""),
                body.get("bundle_id", ""),
                int(body.get("timestamp_seconds", 0)),
                body.get("salt", ""),
                body.get("signature", ""),
                body.get("public_key_url", ""),
            )
        else:
            raise ApiError(
                f"{provider} linking not available", 501, GRPC_UNIMPLEMENTED
            )

    # ------------------------------------------------------------ storage

    async def _h_storage_read(self, request: HttpRequest):
        try:
            claims = self._session(request)
            body = await self._json(request)
            body = await self._hooked("readstorageobjects", claims, body)
            ops = [
                StorageOpRead(
                    collection=o.get("collection", ""),
                    key=o.get("key", ""),
                    user_id=o.get("user_id") or claims.user_id,
                )
                for o in body.get("object_ids", [])
            ]
            objects = await core_storage.storage_read_objects(
                self.server.db, claims.user_id, ops
            )
            return json_response({"objects": [o.as_dict() for o in objects]})
        except Exception as e:
            return self._map_error(e)

    async def _h_storage_write(self, request: HttpRequest):
        try:
            claims = self._session(request)
            body = await self._json(request)
            body = await self._hooked("writestorageobjects", claims, body)
            ops = []
            for o in body.get("objects", []):
                value = o.get("value", "")
                if not isinstance(value, str):
                    value = json.dumps(value)
                ops.append(
                    StorageOpWrite(
                        collection=o.get("collection", ""),
                        key=o.get("key", ""),
                        user_id=claims.user_id,
                        value=value,
                        version=o.get("version", ""),
                        permission_read=int(o.get("permission_read", 1)),
                        permission_write=int(o.get("permission_write", 1)),
                    )
                )
            acks = await core_storage.storage_write_objects(
                self.server.db, claims.user_id, ops
            )
            return json_response(
                {
                    "acks": [
                        {
                            "collection": a.collection,
                            "key": a.key,
                            "user_id": a.user_id,
                            "version": a.version,
                        }
                        for a in acks
                    ]
                }
            )
        except Exception as e:
            return self._map_error(e)

    async def _h_storage_delete(self, request: HttpRequest):
        try:
            claims = self._session(request)
            body = await self._json(request)
            ops = [
                StorageOpDelete(
                    collection=o.get("collection", ""),
                    key=o.get("key", ""),
                    user_id=claims.user_id,
                    version=o.get("version", ""),
                )
                for o in body.get("object_ids", [])
            ]
            await core_storage.storage_delete_objects(
                self.server.db, claims.user_id, ops
            )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    async def _h_storage_list(self, request: HttpRequest):
        """`GET /v2/storage/{collection}[/{user_id}]`; without the path's
        owner, the `user_id` query value."""
        try:
            claims = self._session(request)
            user_id = (
                self._id(request, 3) if request.path.count("/") > 3
                else request.query.get("user_id", "")
            )
            objects, cursor = await core_storage.storage_list_objects(
                self.server.db,
                claims.user_id,
                self._id(request),
                user_id=user_id or None,
                limit=_limit(request.query),
                cursor=request.query.get("cursor", ""),
            )
            return json_response(
                {"objects": [o.as_dict() for o in objects], "cursor": cursor}
            )
        except Exception as e:
            return self._map_error(e)

    # ---------------------------------------------------------------- iap

    def _make_iap_validate(self, store: str):
        async def handler(request: HttpRequest):
            try:
                claims = self._session(request)
                body = await self._json(request)
                receipt = body.get("receipt", body.get("purchase", ""))
                if not receipt:
                    raise ApiError(
                        "receipt required", 400, GRPC_INVALID_ARGUMENT
                    )
                fn = getattr(self.server.purchases, f"validate_{store}")
                try:
                    validated = await fn(
                        claims.user_id,
                        receipt,
                        persist=_parse_bool(body.get("persist", True)),
                    )
                except IAPError as e:
                    raise ApiError(str(e), 400, GRPC_INVALID_ARGUMENT)
                return json_response({"validated_purchases": validated})
            except Exception as e:
                return self._map_error(e)

        return handler

    def _make_subscription_validate(self, store: str):
        """ValidateSubscriptionApple/Google (reference apigrpc.proto:678,
        :694; iap.go:625-646)."""

        async def handler(request: HttpRequest):
            try:
                claims = self._session(request)
                body = await self._json(request)
                receipt = body.get("receipt", "")
                if not receipt:
                    raise ApiError(
                        "receipt required", 400, GRPC_INVALID_ARGUMENT
                    )
                fn = getattr(
                    self.server.purchases,
                    f"validate_subscription_{store}",
                )
                try:
                    sub = await fn(
                        claims.user_id,
                        receipt,
                        persist=_parse_bool(body.get("persist", True)),
                    )
                except IAPError as e:
                    raise ApiError(str(e), 400, GRPC_INVALID_ARGUMENT)
                return json_response({"validated_subscription": sub})
            except Exception as e:
                return self._map_error(e)

        return handler

    async def _h_subscription_get(self, request: HttpRequest):
        """GetSubscription (reference apigrpc.proto:344): by original
        transaction id, owner-gated."""
        try:
            claims = self._session(request)
            sub = await self.server.purchases.get_subscription(
                self._id(request, 3)
            )
            if sub is None or sub.get("user_id") != claims.user_id:
                raise ApiError(
                    "subscription not found", 404, GRPC_NOT_FOUND
                )
            return json_response(sub)
        except Exception as e:
            return self._map_error(e)

    async def _h_subscription_list(self, request: HttpRequest):
        try:
            claims = self._session(request)
            q = request.query
            result = await self.server.purchases.list_subscriptions(
                claims.user_id,
                limit=_limit(q),
                cursor=q.get("cursor", ""),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    # ------------------------------------------------------ notifications

    async def _h_notification_list(self, request: HttpRequest):
        try:
            claims = self._session(request)
            q = request.query
            result = await self.server.notifications.list(
                claims.user_id,
                limit=_limit(q),
                cursor=q.get("cacheable_cursor", q.get("cursor", "")),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_notification_delete(self, request: HttpRequest):
        try:
            claims = self._session(request)
            await self.server.notifications.delete(
                claims.user_id, request.query_all("ids")
            )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    # ----------------------------------------------------------- friends

    async def _resolve_target_ids(self, request: HttpRequest) -> list[str]:
        """ids= and usernames= query params to user ids (reference
        fetchIds in api_friend.go)."""
        ids = request.query_all("ids")
        usernames = request.query_all("usernames")
        if usernames:
            users = await core_account.get_users(
                self.server.db, usernames=usernames
            )
            ids.extend(u["id"] for u in users)
        return ids

    async def _h_friend_import_facebook(self, request: HttpRequest):
        """ImportFacebookFriends (reference apigrpc.proto:354): verify the
        Graph token, fetch its app-friend list, import as direct mutual
        friends."""
        try:
            claims = self._session(request)
            body = await self._json(request)
            body = await self._hooked(
                "importfacebookfriends", claims, body
            )
            social = self.server.social
            if social is None:
                raise ApiError(
                    "facebook not configured", 501, GRPC_UNIMPLEMENTED
                )
            account = body.get("account", body)
            token = account.get("token", "")
            await social.verify_facebook(token)  # token must be live
            friend_ids = await social.fetch_facebook_friends(token)
            imported = await self.server.friends.import_by_provider_ids(
                claims.user_id,
                claims.username,
                "facebook_id",
                friend_ids,
                reset=_parse_bool(
                    request.query.get("reset", body.get("reset", False))
                ),
            )
            result = {"imported": imported}
            await self._after(
                "importfacebookfriends", claims, body, result
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_friend_import_steam(self, request: HttpRequest):
        """ImportSteamFriends (reference apigrpc.proto:362): resolve the
        caller's linked steam id, fetch the Steam friend list with the
        publisher key, import as direct mutual friends."""
        try:
            claims = self._session(request)
            body = await self._json(request)
            body = await self._hooked("importsteamfriends", claims, body)
            social = self.server.social
            if social is None:
                raise ApiError(
                    "steam not configured", 501, GRPC_UNIMPLEMENTED
                )
            row = await self.server.db.fetch_one(
                "SELECT steam_id FROM users WHERE id = ?",
                (claims.user_id,),
            )
            steam_id = (row or {}).get("steam_id") or ""
            if not steam_id:
                raise ApiError(
                    "no steam account linked", 400, GRPC_INVALID_ARGUMENT
                )
            friend_ids = await social.fetch_steam_friends(
                self.config.social.steam_publisher_key, steam_id
            )
            imported = await self.server.friends.import_by_provider_ids(
                claims.user_id,
                claims.username,
                "steam_id",
                friend_ids,
                reset=_parse_bool(
                    request.query.get("reset", body.get("reset", False))
                ),
            )
            result = {"imported": imported}
            await self._after("importsteamfriends", claims, body, result)
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_friend_list(self, request: HttpRequest):
        try:
            claims = self._session(request)
            q = request.query
            result = await self.server.friends.list(
                claims.user_id,
                limit=_limit(q),
                state=int(q["state"]) if "state" in q else None,
                cursor=q.get("cursor", ""),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_friend_add(self, request: HttpRequest):
        try:
            claims = self._session(request)
            ids = await self._resolve_target_ids(request)
            body = await self._hooked("addfriends", claims, {"ids": ids})
            for fid in body.get("ids", []):
                await self.server.friends.add(
                    claims.user_id, claims.username, fid
                )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    async def _h_friend_delete(self, request: HttpRequest):
        try:
            claims = self._session(request)
            for fid in await self._resolve_target_ids(request):
                await self.server.friends.delete(claims.user_id, fid)
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    async def _h_friend_block(self, request: HttpRequest):
        try:
            claims = self._session(request)
            for fid in await self._resolve_target_ids(request):
                await self.server.friends.block(
                    claims.user_id, claims.username, fid
                )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    # ------------------------------------------------------------- groups

    async def _h_group_create(self, request: HttpRequest):
        try:
            claims = self._session(request)
            body = await self._json(request)
            body = await self._hooked("creategroup", claims, body)
            group = await self.server.groups.create(
                claims.user_id,
                body.get("name", ""),
                description=body.get("description", ""),
                avatar_url=body.get("avatar_url", ""),
                lang_tag=body.get("lang_tag", "en"),
                metadata=body.get("metadata"),
                open=bool(body.get("open", True)),
                max_count=int(body.get("max_count", 100)),
            )
            return json_response(group)
        except Exception as e:
            return self._map_error(e)

    async def _h_group_list(self, request: HttpRequest):
        try:
            self._session(request)
            q = request.query
            result = await self.server.groups.list(
                name=q.get("name") or None,
                limit=_limit(q),
                cursor=q.get("cursor", ""),
                open=_parse_bool(q["open"]) if "open" in q else None,
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_group_update(self, request: HttpRequest):
        try:
            claims = self._session(request)
            body = await self._json(request)
            await self.server.groups.update(
                self._id(request),
                caller_id=claims.user_id,
                name=body.get("name"),
                description=body.get("description"),
                avatar_url=body.get("avatar_url"),
                lang_tag=body.get("lang_tag"),
                metadata=body.get("metadata"),
                open=body.get("open"),
                max_count=body.get("max_count"),
            )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    async def _h_group_delete(self, request: HttpRequest):
        try:
            claims = self._session(request)
            await self.server.groups.delete(
                self._id(request), caller_id=claims.user_id
            )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    def _make_group_action(self, action: str):
        async def handler(request: HttpRequest):
            try:
                claims = self._session(request)
                groups = self.server.groups
                gid = self._id(request)
                if action == "join":
                    await groups.join(gid, claims.user_id, claims.username)
                elif action == "leave":
                    await groups.leave(gid, claims.user_id)
                else:
                    fn = getattr(groups, f"users_{action}")
                    await fn(
                        gid, request.query_all("user_ids"),
                        caller_id=claims.user_id,
                    )
                return json_response({})
            except Exception as e:
                return self._map_error(e)

        return handler

    async def _h_group_users(self, request: HttpRequest):
        try:
            self._session(request)
            q = request.query
            result = await self.server.groups.users_list(
                self._id(request),
                limit=_limit(q),
                state=int(q["state"]) if "state" in q else None,
                cursor=q.get("cursor", ""),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_user_groups(self, request: HttpRequest):
        try:
            self._session(request)
            q = request.query
            result = await self.server.groups.user_groups_list(
                self._id(request),
                limit=_limit(q),
                state=int(q["state"]) if "state" in q else None,
                cursor=q.get("cursor", ""),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    # ----------------------------------------------------------- channels

    async def _h_channel_messages(self, request: HttpRequest):
        """Chat history (reference ListChannelMessages, api_channel.go:
        group channels require membership, DMs require being a
        participant; rooms are open)."""
        try:
            claims = self._session(request)
            channel_id = self._id(request)
            stream = channel_id_to_stream(channel_id)
            if stream.mode == StreamMode.DM:
                if claims.user_id not in (stream.subject, stream.subcontext):
                    raise ApiError(
                        "not a participant in this conversation",
                        403,
                        GRPC_PERMISSION_DENIED,
                    )
            elif stream.mode == StreamMode.GROUP:
                row = await self.server.db.fetch_one(
                    "SELECT state FROM group_edge WHERE source_id = ?"
                    " AND destination_id = ?",
                    (stream.subject, claims.user_id),
                )
                state = None if row is None else row["state"]
                if state not in (SUPERADMIN, ADMIN, MEMBER):
                    raise ApiError(
                        "must be a group member", 403, GRPC_PERMISSION_DENIED
                    )
            q = request.query
            result = await self.server.channels.messages_list(
                channel_id,
                limit=_limit(q),
                forward=_parse_bool(q.get("forward", "true")),
                cursor=q.get("cursor", ""),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    # ------------------------------------------------------------- matches

    async def _h_match_list(self, request: HttpRequest):
        try:
            self._session(request)
            q = request.query
            limit = _limit(q, default=10)
            matches = self.server.match_registry.list_matches(
                limit,
                label=q.get("label") or None,
                min_size=int(q["min_size"]) if "min_size" in q else None,
                max_size=int(q["max_size"]) if "max_size" in q else None,
                query=q.get("query") or None,
            )
            return json_response({"matches": matches})
        except Exception as e:
            return self._map_error(e)

    # ----------------------------------------- leaderboards / tournaments

    async def _h_lb_record_write(self, request: HttpRequest):
        """Reference WriteLeaderboardRecord (api_leaderboard.go): client
        writes are refused on authoritative boards."""
        try:
            claims = self._session(request)
            body = await self._json(request)
            body = await self._hooked(
                "writeleaderboardrecord", claims, body
            )
            record = body.get("record", body)
            result = await self.server.leaderboards.record_write(
                self._id(request),
                claims.user_id,
                claims.username,
                int(record.get("score", 0)),
                int(record.get("subscore", 0)),
                record.get("metadata"),
                override_operator=record.get("operator"),
                caller_authoritative=False,
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_lb_records_list(self, request: HttpRequest):
        try:
            self._session(request)
            q = request.query
            result = await self.server.leaderboards.records_list(
                self._id(request),
                limit=_limit(q),
                cursor=q.get("cursor", ""),
                owner_ids=request.query_all("owner_ids") or None,
                expiry_override=(
                    float(q["expiry"]) if "expiry" in q else None
                ),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_t_record_delete(self, request: HttpRequest):
        """Reference DeleteTournamentRecord (apigrpc.proto:300): the
        caller deletes their own current-window record; authoritative
        tournaments reject client deletes (core_tournament.go:661)."""
        try:
            claims = self._session(request)
            await self.server.tournaments.record_delete(
                self._id(request),
                claims.user_id,
                caller_authoritative=False,
            )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    async def _h_lb_record_delete(self, request: HttpRequest):
        try:
            claims = self._session(request)
            await self.server.leaderboards.record_delete(
                self._id(request),
                claims.user_id,
                caller_authoritative=False,
            )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    async def _h_lb_haystack(self, request: HttpRequest):
        """Around-owner window (reference
        ListLeaderboardRecordsAroundOwner)."""
        try:
            self._session(request)
            result = await self.server.leaderboards.records_haystack(
                self._id(request),
                self._id(request, 4),
                limit=_limit(request.query),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_tournament_list(self, request: HttpRequest):
        try:
            self._session(request)
            q = request.query
            categories = [int(c) for c in request.query_all("category")]
            return json_response(
                {
                    "tournaments": self.server.tournaments.list(
                        categories=categories or None,
                        active_only=_parse_bool(q.get("active", "false")),
                    )
                }
            )
        except Exception as e:
            return self._map_error(e)

    async def _h_t_records_list(self, request: HttpRequest):
        try:
            self._session(request)
            q = request.query
            result = await self.server.tournaments.records_list(
                self._id(request),
                limit=_limit(q),
                cursor=q.get("cursor", ""),
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_t_record_write(self, request: HttpRequest):
        try:
            claims = self._session(request)
            body = await self._json(request)
            record = body.get("record", body)
            result = await self.server.tournaments.record_write(
                self._id(request),
                claims.user_id,
                claims.username,
                int(record.get("score", 0)),
                int(record.get("subscore", 0)),
                record.get("metadata"),
                caller_authoritative=False,
            )
            return json_response(result)
        except Exception as e:
            return self._map_error(e)

    async def _h_t_join(self, request: HttpRequest):
        try:
            claims = self._session(request)
            await self.server.tournaments.join(
                self._id(request), claims.user_id, claims.username
            )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    # ------------------------------------------------------------- errors

    # ---------------------------------------------------------------- rpc

    async def _h_rpc(self, request: HttpRequest):
        """HTTP RPC (reference api.go:217 /v2/rpc/{id} hijack): bearer
        session auth, or the runtime http_key for server-to-server calls."""
        try:
            rpc_id = self._id(request).lower()
            runtime = self.server.runtime
            if runtime is None:
                raise ApiError("runtime not loaded", 501, GRPC_UNIMPLEMENTED)
            fn = runtime.rpc(rpc_id)
            if fn is None:
                raise ApiError(
                    f"RPC function not found: {rpc_id}",
                    404,
                    GRPC_NOT_FOUND,
                )
            http_key = request.query.get("http_key", "")
            if http_key:
                if http_key != self.config.runtime.http_key:
                    raise ApiError(
                        "invalid http key", 401, GRPC_UNAUTHENTICATED
                    )
                ctx = runtime.context(mode="rpc")
            else:
                claims = self._session(request)
                ctx = runtime.context(
                    mode="rpc",
                    user_id=claims.user_id,
                    username=claims.username,
                    vars=claims.vars,
                )
            ctx.query_params = {
                k: request.query_all(k) for k in request.query
            }
            if request.method == "POST":
                payload = request.body.decode()
                # grpc-gateway unwraps a JSON-string body ("\"x\"" -> x).
                if payload.startswith('"') and payload.endswith('"'):
                    try:
                        payload = json.loads(payload)
                    except ValueError:
                        pass
            else:
                payload = request.query.get("payload", "")
            try:
                result = fn(ctx, payload)
                if asyncio.iscoroutine(result):
                    result = await result
            except Exception as e:
                raise ApiError(str(e), 500, GRPC_INTERNAL)
            return json_response({"id": rpc_id, "payload": result or ""})
        except Exception as e:
            return self._map_error(e)

    async def _h_event(self, request: HttpRequest):
        try:
            claims = self._session(request)
            body = await self._json(request)
            runtime = self.server.runtime
            if runtime is not None:
                ctx = runtime.context(
                    mode="event",
                    user_id=claims.user_id,
                    username=claims.username,
                )
                runtime.fire_event(
                    ctx,
                    {
                        "name": body.get("name", ""),
                        "properties": body.get("properties") or {},
                        "external": True,
                    },
                )
            return json_response({})
        except Exception as e:
            return self._map_error(e)

    def _map_error(self, e: Exception) -> HttpResponse:
        if isinstance(e, ApiError):
            return _error_response(str(e), e.status, e.grpc_code)
        if isinstance(e, overload.DeadlineExceeded):
            # A checkpoint deep in the stack (matchmaker add, storage
            # submit/drain) short-circuited on the caller's deadline.
            self._note_deadline()
            return _error_response(str(e), 504, GRPC_DEADLINE_EXCEEDED)
        if isinstance(e, overload.AdmissionRejected):
            return _error_response(
                str(e), 429, GRPC_RESOURCE_EXHAUSTED,
                headers={"Retry-After": str(int(e.retry_after_sec))},
            )
        if isinstance(e, SocialError):
            # Failed provider verification = unauthenticated (the auth
            # path maps it via core_auth._verify; link paths raise raw).
            return _error_response(str(e), 401, GRPC_UNAUTHENTICATED)
        if isinstance(
            e,
            (AuthError, ChannelError, FriendError, GroupError,
             LeaderboardError, NotificationError, WalletError),
        ):
            status, code = _AUTH_CODE_TO_HTTP.get(
                getattr(e, "code", ""), (400, GRPC_INVALID_ARGUMENT)
            )
            return _error_response(str(e), status, code)
        if isinstance(e, StorageVersionError):
            return _error_response(str(e), 409, GRPC_ALREADY_EXISTS)
        if isinstance(e, StoragePermissionError):
            return _error_response(str(e), 403, GRPC_PERMISSION_DENIED)
        if isinstance(e, StorageError):
            return _error_response(str(e), 400, GRPC_INVALID_ARGUMENT)
        if isinstance(e, (ValueError, KeyError)):
            # Malformed client input (unparsable ints, bad cursors).
            return _error_response(str(e), 400, GRPC_INVALID_ARGUMENT)
        self.logger.error("api handler error", error=str(e))
        return _error_response("internal error", 500, GRPC_INTERNAL)


async def _async(value):
    return value


def _parse_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    return str(value).lower() in ("true", "1", "yes", "")


def _limit(q, default: int = 100, hi: int = 1000) -> int:
    """Clamp a `limit` query param to [1, hi]. A negative or huge limit
    must never reach storage/leaderboard unvalidated, and a non-numeric
    one is the client's 400, not our 500."""
    raw = q.get("limit", default)
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise ApiError(
            f"limit must be an integer, got {raw!r}",
            400,
            GRPC_INVALID_ARGUMENT,
        )
    return max(1, min(hi, value))

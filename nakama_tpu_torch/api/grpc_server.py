"""gRPC front door — transcodes every NakamaApi rpc onto the REST stack.

The port's copy of the JAX package's `api/grpc_server.py`. The design
is the JAX gateway's: this server is REST-first and derives gRPC
through this gateway (the reference is gRPC-first and derives REST
through grpc-gateway, reference server/api.go:148-208). Each rpc is one
`RouteSpec` row mapping the typed request onto the REST route over a
loopback call; the auth interceptors, runtime before/after hooks,
deadlines, tracing and error mapping all run once, in the REST layer,
for both protocols.

Where the JAX gateway stands on grpcio, `google.protobuf` and `aiohttp`,
this one stands on the port's own parts: `api/h2.py` (HTTP/2 with
`api/hpack.py`), `proto/` (the codec over the port's copy of
`api.proto`, `json_format`'s mapping both ways) and
`utils/httpfetch.py` (the loopback, kept alive in the loop's pool).

On the wire, as grpcio's server answers: a request is one
length-prefixed message, `gzip`- or `deflate`-compressed where its flag
says so, at most 4 MiB (past it: RESOURCE_EXHAUSTED). A success is
HEADERS (`:status` 200, `content-type: application/grpc`), one DATA and
trailers (`grpc-status` 0, `traceparent` where the REST answer carried
one); an error is one Trailers-Only HEADERS with `grpc-status`, a
percent-encoded `grpc-message` and the `traceparent`. An unknown method
is UNIMPLEMENTED; bytes that do not decode as the request message are
UNKNOWN with the parse error, as grpc.aio's server answers them (its
details also name the exception's class); a transcode failure is
INTERNAL and logged.

Auth passes through the grpc `authorization` metadata key verbatim
(Basic server-key for authenticate rpcs, Bearer session elsewhere —
reference apigrpc SecurityInterceptor, server/api.go:101). The client's
`grpc-timeout` rides the loopback call as the time left, in whole
milliseconds, where `overload.deadline_from_headers` enforces it; the
client's `traceparent` rides it too, so the REST middleware continues
the caller's trace.
"""

from __future__ import annotations

import asyncio
import json
import re
import urllib.parse
import zlib
from dataclasses import dataclass
from typing import Callable

from .. import proto
from ..logger import Logger
from ..utils import httpfetch
from . import h2, hpack

SERVICE = "nakama_tpu.api.NakamaApi"
# grpcio's default limit on a received message.
MAX_RECEIVE_MESSAGE = 4 << 20
STOP_GRACE_S = 1.0

# The 17 gRPC status codes (grpc.StatusCode): name -> number.
STATUS = {
    "OK": 0, "CANCELLED": 1, "UNKNOWN": 2, "INVALID_ARGUMENT": 3,
    "DEADLINE_EXCEEDED": 4, "NOT_FOUND": 5, "ALREADY_EXISTS": 6,
    "PERMISSION_DENIED": 7, "RESOURCE_EXHAUSTED": 8,
    "FAILED_PRECONDITION": 9, "ABORTED": 10, "OUT_OF_RANGE": 11,
    "UNIMPLEMENTED": 12, "INTERNAL": 13, "UNAVAILABLE": 14,
    "DATA_LOSS": 15, "UNAUTHENTICATED": 16,
}
_CODES = frozenset(STATUS.values())
# A REST status with no JSON body -> the gRPC status it maps to.
_HTTP_STATUS = {
    400: STATUS["INVALID_ARGUMENT"],
    404: STATUS["NOT_FOUND"],
    405: STATUS["INVALID_ARGUMENT"],
    429: STATUS["RESOURCE_EXHAUSTED"],
    504: STATUS["DEADLINE_EXCEEDED"],
}
_TIMEOUT = re.compile(r"^(\d{1,8})([HMSmun])$")
_TIMEOUT_UNIT = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
                 "n": 1e-9}


@dataclass
class RouteSpec:
    verb: str
    path: str | Callable[[dict], str]
    # Message names in api.proto.
    request: str
    response: str
    # body("json"): the request's JSON mapping becomes the JSON body;
    # body("query"): fields become query-string params; body("rpc"): the
    # payload is the body; body(None): bare.
    body: str | None = "json"
    # Fields consumed by the path template, removed from the body.
    path_fields: tuple = ()
    # Rewrites applied to the dict before dispatch.
    transform: Callable[[dict], dict] | None = None


def _flatten_account(body: dict) -> dict:
    """Link/unlink REST bodies are the provider account fields directly."""
    return body.get("account") or {}


ROUTES: dict[str, RouteSpec] = {
    "Healthcheck": RouteSpec("GET", "/v2/healthcheck", "Empty", "Empty",
                             body=None),
    "SessionRefresh": RouteSpec(
        "POST", "/v2/account/session/refresh",
        "SessionRefreshRequest", "Session",
    ),
    "SessionLogout": RouteSpec(
        "POST", "/v2/session/logout",
        "SessionLogoutRequest", "Empty",
    ),
    "GetAccount": RouteSpec("GET", "/v2/account", "Empty", "Account",
                            body=None),
    "UpdateAccount": RouteSpec(
        "PUT", "/v2/account", "UpdateAccountRequest", "Empty",
    ),
    "DeleteAccount": RouteSpec("DELETE", "/v2/account", "Empty", "Empty",
                               body=None),
    "GetUsers": RouteSpec(
        "GET", "/v2/user", "GetUsersRequest", "Users", body="query",
    ),
    "ReadStorageObjects": RouteSpec(
        "POST", "/v2/storage",
        "ReadStorageObjectsRequest", "StorageObjects",
    ),
    "WriteStorageObjects": RouteSpec(
        "PUT", "/v2/storage",
        "WriteStorageObjectsRequest", "StorageObjectAcks",
    ),
    "DeleteStorageObjects": RouteSpec(
        "PUT", "/v2/storage/delete",
        "DeleteStorageObjectsRequest", "Empty",
    ),
    "ListStorageObjects": RouteSpec(
        "GET",
        lambda d: (
            f"/v2/storage/{d.get('collection', '')}"
            + (f"/{d['user_id']}" if d.get("user_id") else "")
        ),
        "ListStorageObjectsRequest", "StorageObjectList",
        body="query",
        path_fields=("collection", "user_id"),
    ),
    "Event": RouteSpec("POST", "/v2/event", "EventRequest", "Empty"),
    "ListMatches": RouteSpec(
        "GET", "/v2/match", "ListMatchesRequest", "MatchList",
        body="query",
    ),
    "ListFriends": RouteSpec(
        "GET", "/v2/friend", "ListFriendsRequest", "FriendList",
        body="query",
    ),
    "AddFriends": RouteSpec(
        "POST", "/v2/friend", "AddFriendsRequest", "Empty", body="query",
    ),
    "DeleteFriends": RouteSpec(
        "DELETE", "/v2/friend", "AddFriendsRequest", "Empty", body="query",
    ),
    "BlockFriends": RouteSpec(
        "POST", "/v2/friend/block", "AddFriendsRequest", "Empty",
        body="query",
    ),
    "ListGroups": RouteSpec(
        "GET", "/v2/group", "ListGroupsRequest", "GroupList", body="query",
    ),
    "CreateGroup": RouteSpec(
        "POST", "/v2/group", "CreateGroupRequest", "Group",
    ),
    "DeleteGroup": RouteSpec(
        "DELETE", lambda d: f"/v2/group/{d.get('group_id', '')}",
        "GroupIdRequest", "Empty", body=None,
        path_fields=("group_id",),
    ),
    "ListGroupUsers": RouteSpec(
        "GET", lambda d: f"/v2/group/{d.get('group_id', '')}/user",
        "ListGroupUsersRequest", "GroupUserList",
        body="query", path_fields=("group_id",),
    ),
    "ListUserGroups": RouteSpec(
        "GET", lambda d: f"/v2/user/{d.get('user_id', '')}/group",
        "ListUserGroupsRequest", "UserGroupList",
        body="query", path_fields=("user_id",),
    ),
    "ListLeaderboardRecords": RouteSpec(
        "GET", lambda d: f"/v2/leaderboard/{d.get('leaderboard_id', '')}",
        "ListLeaderboardRecordsRequest", "LeaderboardRecordList",
        body="query", path_fields=("leaderboard_id",),
    ),
    "WriteLeaderboardRecord": RouteSpec(
        "POST", lambda d: f"/v2/leaderboard/{d.get('leaderboard_id', '')}",
        "WriteLeaderboardRecordRequest", "LeaderboardRecord",
        path_fields=("leaderboard_id",),
    ),
    "DeleteLeaderboardRecord": RouteSpec(
        "DELETE", lambda d: f"/v2/leaderboard/{d.get('leaderboard_id', '')}",
        "DeleteLeaderboardRecordRequest", "Empty", body=None,
        path_fields=("leaderboard_id",),
    ),
    "ListLeaderboardRecordsAroundOwner": RouteSpec(
        "GET",
        lambda d: (
            f"/v2/leaderboard/{d.get('leaderboard_id', '')}"
            f"/owner/{d.get('owner_id', '')}"
        ),
        "ListLeaderboardRecordsAroundOwnerRequest", "LeaderboardRecordList",
        body="query", path_fields=("leaderboard_id", "owner_id"),
    ),
    "ListTournamentRecordsAroundOwner": RouteSpec(
        "GET",
        lambda d: (
            f"/v2/tournament/{d.get('tournament_id', '')}"
            f"/owner/{d.get('owner_id', '')}"
        ),
        "ListTournamentRecordsAroundOwnerRequest", "LeaderboardRecordList",
        body="query", path_fields=("tournament_id", "owner_id"),
    ),
    "DeleteTournamentRecord": RouteSpec(
        "DELETE", lambda d: f"/v2/tournament/{d.get('tournament_id', '')}",
        "DeleteTournamentRecordRequest", "Empty", body=None,
        path_fields=("tournament_id",),
    ),
    "ListChannelMessages": RouteSpec(
        "GET", lambda d: f"/v2/channel/{d.get('channel_id', '')}",
        "ListChannelMessagesRequest", "ChannelMessageList",
        body="query", path_fields=("channel_id",),
    ),
    "UpdateGroup": RouteSpec(
        "PUT", lambda d: f"/v2/group/{d.get('group_id', '')}",
        "UpdateGroupRequest", "Empty",
        path_fields=("group_id",),
    ),
    "ListTournaments": RouteSpec(
        "GET", "/v2/tournament", "ListTournamentsRequest",
        "TournamentList", body="query",
    ),
    "JoinTournament": RouteSpec(
        "POST",
        lambda d: f"/v2/tournament/{d.get('tournament_id', '')}/join",
        "JoinTournamentRequest", "Empty", body=None,
        path_fields=("tournament_id",),
    ),
    "WriteTournamentRecord": RouteSpec(
        "POST", lambda d: f"/v2/tournament/{d.get('tournament_id', '')}",
        "WriteTournamentRecordRequest", "LeaderboardRecord",
        path_fields=("tournament_id",),
    ),
    "ListTournamentRecords": RouteSpec(
        "GET", lambda d: f"/v2/tournament/{d.get('tournament_id', '')}",
        "ListTournamentRecordsRequest", "LeaderboardRecordList",
        body="query", path_fields=("tournament_id",),
    ),
    "ListNotifications": RouteSpec(
        "GET", "/v2/notification",
        "ListNotificationsRequest", "NotificationList", body="query",
    ),
    "DeleteNotifications": RouteSpec(
        "DELETE", "/v2/notification",
        "DeleteNotificationsRequest", "Empty", body="query",
    ),
    "ListSubscriptions": RouteSpec(
        "GET", "/v2/iap/subscription", "Empty", "SubscriptionList",
        body=None,
    ),
}

for _provider in (
    "device", "email", "custom", "apple", "facebook",
    "facebookinstantgame", "gamecenter", "google", "steam",
):
    _cap = _provider.capitalize()
    ROUTES[f"Authenticate{_cap}"] = RouteSpec(
        "POST", f"/v2/account/authenticate/{_provider}",
        "AuthenticateRequest", "Session",
    )
    ROUTES[f"Link{_cap}"] = RouteSpec(
        "POST", f"/v2/account/link/{_provider}", "LinkRequest", "Empty",
        transform=_flatten_account,
    )
    ROUTES[f"Unlink{_cap}"] = RouteSpec(
        "POST", f"/v2/account/unlink/{_provider}", "LinkRequest", "Empty",
        transform=_flatten_account,
    )
for _action, _msg, _name in (
    ("join", "GroupIdRequest", "JoinGroup"),
    ("leave", "GroupIdRequest", "LeaveGroup"),
    ("add", "GroupUsersRequest", "AddGroupUsers"),
    ("kick", "GroupUsersRequest", "KickGroupUsers"),
    ("ban", "GroupUsersRequest", "BanGroupUsers"),
    ("promote", "GroupUsersRequest", "PromoteGroupUsers"),
    ("demote", "GroupUsersRequest", "DemoteGroupUsers"),
):
    ROUTES[_name] = RouteSpec(
        "POST",
        (lambda action: lambda d: (
            f"/v2/group/{d.get('group_id', '')}/{action}"
        ))(_action),
        _msg, "Empty", body="query", path_fields=("group_id",),
    )
for _store in ("apple", "google", "huawei"):
    ROUTES[f"ValidatePurchase{_store.capitalize()}"] = RouteSpec(
        "POST", f"/v2/iap/purchase/{_store}",
        "ValidatePurchaseRequest", "PurchaseList",
    )
for _store in ("apple", "google"):
    ROUTES[f"ValidateSubscription{_store.capitalize()}"] = RouteSpec(
        "POST", f"/v2/iap/subscription/{_store}",
        "ValidateSubscriptionRequest", "ValidateSubscriptionResponse",
    )
ROUTES["GetSubscription"] = RouteSpec(
    "GET",
    lambda d: (
        f"/v2/iap/subscription/{d.get('original_transaction_id', '')}"
    ),
    "GetSubscriptionRequest", "ValidatedSubscription", body=None,
    path_fields=("original_transaction_id",),
)
ROUTES["ImportFacebookFriends"] = RouteSpec(
    "POST", "/v2/friend/facebook",
    "ImportFacebookFriendsRequest", "ImportFriendsResponse",
)
ROUTES["ImportSteamFriends"] = RouteSpec(
    "POST", "/v2/friend/steam",
    "ImportSteamFriendsRequest", "ImportFriendsResponse",
)
ROUTES["RpcFunc"] = RouteSpec(
    "POST", lambda d: f"/v2/rpc/{d.get('id', '')}",
    "Rpc", "Rpc", body="rpc", path_fields=("id",),
)


def percent_encode(message: str) -> str:
    """`grpc-message` as the gRPC spec encodes it: UTF-8, every octet
    outside 0x20-0x7E and `%` itself as %XX."""
    return "".join(
        chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
        for b in message.encode("utf-8"))


def parse_timeout(value: str) -> float | None:
    """A `grpc-timeout` header in seconds; None where there is none (or
    it does not parse, which grpcio also ignores)."""
    m = _TIMEOUT.match(value)
    if m is None:
        return None
    return int(m.group(1)) * _TIMEOUT_UNIT[m.group(2)]


def loopback_request(spec: RouteSpec, body: dict) -> tuple[str, bytes | None, str]:
    """The REST call for one rpc's request (its JSON mapping): (path with
    query, body bytes, content type)."""
    if spec.transform is not None:
        body = spec.transform(body)
    path = spec.path(body) if callable(spec.path) else spec.path
    for f in spec.path_fields:
        body.pop(f, None)
    params: list[tuple[str, str]] = []
    data = None
    content_type = ""
    if spec.body == "query":
        for k, v in body.items():
            if isinstance(v, list):
                params.extend((k, str(x)) for x in v)
            elif isinstance(v, bool):
                params.append((k, "true" if v else "false"))
            else:
                params.append((k, str(v)))
    elif spec.body == "rpc":
        data = json.dumps(body.get("payload", "")).encode()
        content_type = "text/plain; charset=utf-8"
        if body.get("http_key"):
            params.append(("http_key", body["http_key"]))
    elif spec.body == "json":
        data = json.dumps(body).encode()
        content_type = "application/json"
    target = urllib.parse.quote(path, safe="/%:@!$&'()*+,;=-._~")
    if params:
        # Form-encoded, so that `+`, `/`, `=` and spaces in a cursor
        # reach the REST handler's `parse_qs` intact.
        target += "?" + urllib.parse.urlencode(params)
    return target, data, content_type


class GrpcGateway:
    """The NakamaApi service over the port's HTTP/2, by loopback onto the
    REST port."""

    def __init__(self, logger: Logger, rest_host: str, rest_port: int):
        self.logger = logger.with_fields(subsystem="grpc")
        self._rest = (rest_host, rest_port)
        self._base = f"http://{rest_host}:{rest_port}"
        self._server: h2.H2Server | None = None
        self.port: int | None = None
        # Calls answered, by status code.
        self.statuses: dict[int, int] = {}

    def stats(self) -> dict:
        s = self._server
        return {
            "calls": sum(self.statuses.values()),
            "statuses": dict(self.statuses),
            "frames_in": s.frames_in if s else 0,
            "frames_out": s.frames_out if s else 0,
            "bytes_in": s.bytes_in if s else 0,
            "bytes_out": s.bytes_out if s else 0,
        }

    # ------------------------------------------------------------ handlers

    async def _handle(self, stream: h2.Stream) -> None:
        loop = asyncio.get_running_loop()
        timeout = parse_timeout(stream.header("grpc-timeout"))
        deadline = None if timeout is None else loop.time() + timeout
        path = stream.header(":path")
        if not stream.header("content-type").startswith("application/grpc"):
            await stream.send_headers(
                [(":status", "415"), ("content-type", "application/grpc"),
                 ("grpc-status", str(STATUS["INTERNAL"])),
                 ("grpc-message", "invalid gRPC request content-type",
                  hpack.NO_INDEX)], end_stream=True)
            return
        service, _, name = path.lstrip("/").rpartition("/")
        spec = ROUTES.get(name) if service == SERVICE else None
        if spec is None:
            await self._status(stream, STATUS["UNIMPLEMENTED"],
                               "Method not found!")
            return
        try:
            if deadline is None:
                await self._unary(stream, name, spec, None)
            else:
                await asyncio.wait_for(
                    self._unary(stream, name, spec, deadline),
                    max(0.0, deadline - loop.time()))
        except asyncio.TimeoutError:
            await self._status(stream, STATUS["DEADLINE_EXCEEDED"],
                               "Deadline Exceeded")

    async def _unary(self, stream, name: str, spec: RouteSpec, deadline) -> None:
        raw = await stream.body()
        status, message = self._read_message(stream, raw)
        if status:
            await self._status(stream, status, message)
            return
        try:
            request = proto.decode_message(spec.request, message)
        except proto.ProtocolError as e:
            # grpc.aio's server answers UNKNOWN with the parse error.
            self.logger.warn("grpc request does not decode", rpc=name,
                             error=str(e))
            full_name = proto.schema.api().message(spec.request).full_name
            await self._status(stream, STATUS["UNKNOWN"],
                               f"Error parsing message with type '{full_name}'")
            return
        try:
            payload, traceparent = await self._call(
                spec, request, stream.header("authorization"), deadline,
                stream.header("traceparent"))
        except _ApiStatusError as e:
            await self._status(stream, e.code, e.message, e.traceparent)
            return
        except Exception as e:  # transcode/transport failure
            self.logger.error("grpc transcode error", rpc=name, error=str(e))
            await self._status(stream, STATUS["INTERNAL"], str(e))
            return
        self.statuses[0] = self.statuses.get(0, 0) + 1
        await stream.send_headers(
            [(":status", "200"), ("content-type", "application/grpc")])
        await stream.send_data(
            b"\x00" + len(payload).to_bytes(4, "big") + payload)
        trailers = [("grpc-status", "0")]
        if traceparent:
            trailers.append(("traceparent", traceparent, hpack.NO_INDEX))
        await stream.send_headers(trailers, end_stream=True)

    def _read_message(self, stream, raw: bytes) -> tuple[int, bytes]:
        """The request's one message: (0, bytes), or (status, message) of
        the error that answers it."""
        if stream.overflow or (len(raw) >= 5 and int.from_bytes(
                raw[1:5], "big") > MAX_RECEIVE_MESSAGE):
            size = (int.from_bytes(raw[1:5], "big") if len(raw) >= 5
                    else len(raw) + stream.overflow)
            return (STATUS["RESOURCE_EXHAUSTED"],
                    f"Received message larger than max ({size} vs."
                    f" {MAX_RECEIVE_MESSAGE})")
        if len(raw) < 5 or len(raw) != 5 + int.from_bytes(raw[1:5], "big"):
            return STATUS["INTERNAL"], "Failed to read the request message"
        data = raw[5:]
        if not raw[0] & 1:
            return 0, data
        encoding = stream.header("grpc-encoding", "identity")
        if encoding not in ("gzip", "deflate"):
            return (STATUS["UNIMPLEMENTED"],
                    f"Compression algorithm '{encoding}' is not supported")
        inflate = zlib.decompressobj(
            16 + zlib.MAX_WBITS if encoding == "gzip" else zlib.MAX_WBITS)
        try:
            data = inflate.decompress(data, MAX_RECEIVE_MESSAGE + 1)
        except zlib.error:
            return STATUS["INTERNAL"], "Failed to decompress the request message"
        if len(data) > MAX_RECEIVE_MESSAGE:
            return (STATUS["RESOURCE_EXHAUSTED"],
                    f"Received message larger than max (>{MAX_RECEIVE_MESSAGE}"
                    f" vs. {MAX_RECEIVE_MESSAGE})")
        return 0, data

    async def _status(self, stream, code: int, message: str = "",
                      traceparent: str = "") -> None:
        """A Trailers-Only answer (trailers alone where the response's
        HEADERS already went out: a deadline that passed mid-answer)."""
        self.statuses[code] = self.statuses.get(code, 0) + 1
        headers = [] if stream.headers_sent else [
            (":status", "200"), ("content-type", "application/grpc")]
        headers.append(("grpc-status", str(code)))
        if message:
            headers.append(("grpc-message", percent_encode(message),
                            hpack.NO_INDEX))
        if traceparent:
            headers.append(("traceparent", traceparent, hpack.NO_INDEX))
        await stream.send_headers(headers, end_stream=True)

    async def _call(self, spec: RouteSpec, request: dict, auth: str,
                    deadline: float | None = None, traceparent: str = ""):
        """The REST call for one request: (response message bytes, the
        response's traceparent); `_ApiStatusError` for a REST error."""
        target, data, content_type = loopback_request(spec, request)
        headers = {}
        if content_type:
            headers["Content-Type"] = content_type
        if auth:
            headers["Authorization"] = auth
        if deadline is not None:
            # The time left, in whole milliseconds, at least 1 (as the
            # JAX gateway computes it from `time_remaining()`).
            remaining = deadline - asyncio.get_running_loop().time()
            headers["grpc-timeout"] = f"{max(1, int(remaining * 1000))}m"
        if traceparent:
            headers["traceparent"] = traceparent
        status, resp_headers, raw = await httpfetch.fetch_response(
            self._base + target, spec.verb, headers, data)
        resp_tp = resp_headers.get("traceparent", "")
        try:
            payload = json.loads(raw) if raw.strip() else None
        except ValueError:
            # Router-level errors (an empty path segment's plain-text
            # 404) carry no JSON body; map the HTTP status instead of
            # surfacing a parser error.
            payload = None
        if status >= 400 or payload is None:
            if isinstance(payload, dict):
                code = payload.get("code", STATUS["INTERNAL"])
                if isinstance(code, bool) or code not in _CODES:
                    code = STATUS["INTERNAL"]
                message = payload.get("message", "")
            else:
                code = _HTTP_STATUS.get(status, STATUS["INTERNAL"])
                message = f"HTTP {status}"
            raise _ApiStatusError(code, str(message), traceparent=resp_tp)
        return proto.encode_message(spec.response, payload or {}), resp_tp

    # ----------------------------------------------------------- lifecycle

    async def start(self, host: str, port: int) -> int:
        """Listen; the bound port. A failed bind raises `OSError`."""
        self._server = h2.H2Server(self._handle, self.logger,
                                   MAX_RECEIVE_MESSAGE + 5)
        try:
            self.port = await self._server.start(host, port)
        except OSError as e:
            self._server = None
            raise OSError(f"grpc gateway failed to bind {host}:{port}: {e}") from e
        self.logger.info("grpc gateway listening", port=self.port)
        return self.port

    async def stop(self) -> None:
        """GOAWAY to every client; calls in flight get 1 s to finish (new
        ones are refused); then the connections and the loopback pool
        close."""
        if self._server is not None:
            await self._server.stop(STOP_GRACE_S)
        httpfetch.close_idle("http", *self._rest)


class _ApiStatusError(Exception):
    """REST error carried to the handler, answered with the mapped status
    (plus the response's traceparent, echoed as trailing metadata)."""

    def __init__(self, code: int, message: str, traceparent: str = ""):
        super().__init__(message)
        self.code = code
        self.message = message
        self.traceparent = traceparent

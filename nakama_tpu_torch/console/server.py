"""Admin console: a second HTTP listener with its own auth.

Parity: reference server/console.go:167 StartConsoleServer — separate
port, own JWT signing key, authentication against the configured root
admin (config console.username/password) or `console_user` rows with
role-based access and login-attempt lockout (console_authenticate.go:73),
logout revocation, and the operator surface of the console_*.go
handlers: account browse/edit (profile + metadata + wallet
replacement)/ban/export/delete, friends, groups, wallet ledger and
unlink, storage browse/write/delete + bulk CSV/JSON import, group
browse + members with promote/demote, channel message browse + deletes,
match listing + live state, the matchmaker's interval breadcrumbs,
leaderboards with records ranked by the rank engine, console-user
management, a redacted config view + warnings, runtime info, the
trace store, an RPC and endpoint explorer, delete-all, and a status
snapshot.

The port's copy of the JAX package's `console/server.py`, route for
route with the same status codes and bodies, served on the port's own
`wsproto` HttpServer instead of `aiohttp`. The device view lists the
`torch` devices (`devobs.describe_devices`, no mesh: the port runs on
one card) and the capture is a `torch.profiler` trace
(`Tracing.device_trace`). The port has no cluster, fleet or soak engine
yet: those routes answer `{"enabled": false}`, as the JAX console
answers with none, and the reshard POST its 400.
The metrics listener stays on the API server (`api/http.py`).
"""

from __future__ import annotations

import asyncio
import base64
import csv
import dataclasses
import io
import json
import os
import re
import time
import urllib.parse
import uuid

from ..api import session_token, wsproto
from ..api.wsproto import HttpRequest, HttpResponse, HttpServer, json_response
from ..core import account as core_account
from ..core import authenticate as core_auth
from ..core import link as core_link
from ..core.channel import ChannelError
from ..core.group import GroupError
from ..core.storage import (
    StorageOpDelete,
    StorageOpWrite,
    storage_delete_objects,
    storage_write_objects,
)
from ..leaderboard import LeaderboardError
from ..storage.db import UniqueViolationError

ROLE_ADMIN = 1
ROLE_DEVELOPER = 2
ROLE_MAINTAINER = 3
ROLE_READONLY = 4

_REDACTED_KEYS = (
    "password", "key", "secret", "private", "token",
)


class _Refused(Exception):
    """An auth refusal: answered as `{"error": message}` with `status`."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class _Request:
    """One console request: the transport's request plus the path
    parameters of its route (`match_info`)."""

    def __init__(self, raw: HttpRequest, match_info: dict[str, str]):
        self.raw = raw
        self.match_info = match_info
        self.query = raw.query
        self.headers = raw.headers
        self.remote = raw.remote

    def text(self) -> str:
        return self.raw.body.decode("utf-8")

    def json(self):
        return json.loads(self.text())

    @property
    def content_type(self) -> str:
        ctype = self.headers.get("content-type", "application/octet-stream")
        return ctype.split(";", 1)[0].strip().lower()


def _err(status: int, message: str) -> HttpResponse:
    return json_response({"error": message}, status=status)


def _text(status: int, text: str, ctype: str = "text/plain") -> HttpResponse:
    return HttpResponse(
        status, text.encode(), content_type=f"{ctype}; charset=utf-8"
    )


def _pattern(path: str) -> re.Pattern:
    return re.compile(
        "^" + re.sub(r"\{([^}]+)\}", r"(?P<\1>[^/]+)", path) + "$"
    )


class ConsoleServer:
    def __init__(self, server):
        self.server = server
        self.config = server.config
        self.logger = server.logger.with_fields(subsystem="console")
        self._http = HttpServer(
            self._handle,
            max_request_size=self.config.console.max_message_size_bytes,
            logger=self.logger,
        )
        self.port: int | None = None
        self._started_at = time.time()
        # Console tokens revoked by AuthenticateLogout before expiry.
        self._revoked: set[str] = set()
        self._capture_busy = False

        routes = [
            ("POST", "/v2/console/authenticate", self._h_authenticate),
            ("GET", "/v2/console/status", self._h_status),
            ("GET", "/v2/console/overload", self._h_overload),
            ("GET", "/v2/console/traces", self._h_traces),
            ("GET", "/v2/console/traces/{trace_id}", self._h_trace_get),
            ("GET", "/v2/console/config", self._h_config),
            ("GET", "/v2/console/runtime", self._h_runtime),
            ("GET", "/", self._h_ui),
            ("GET", "/v2/console/account", self._h_account_list),
            ("GET", "/v2/console/account/{id}", self._h_account_get),
            ("POST", "/v2/console/account/{id}", self._h_account_update),
            ("GET", "/v2/console/account/{id}/wallet",
             self._h_account_wallet),
            ("POST", "/v2/console/account/{id}/ban", self._h_account_ban),
            ("POST", "/v2/console/account/{id}/unban",
             self._h_account_unban),
            ("DELETE", "/v2/console/account/{id}", self._h_account_delete),
            ("GET", "/v2/console/account/{id}/export",
             self._h_account_export),
            ("GET", "/v2/console/storage", self._h_storage_list),
            ("POST", "/v2/console/storage", self._h_storage_write),
            ("POST", "/v2/console/storage/import", self._h_storage_import),
            ("GET", "/v2/console/storage/{collection}/{key}/{user_id}",
             self._h_storage_get),
            ("DELETE", "/v2/console/storage/{collection}/{key}/{user_id}",
             self._h_storage_delete),
            ("GET", "/v2/console/match", self._h_match_list),
            ("GET", "/v2/console/matchmaker", self._h_matchmaker),
            ("GET", "/v2/console/cluster", self._h_not_enabled),
            ("GET", "/v2/console/fleet", self._h_not_enabled),
            ("POST", "/v2/console/fleet/reshard", self._h_fleet_reshard),
            ("GET", "/v2/console/fleet/traces", self._h_not_enabled),
            ("GET", "/v2/console/fleet/traces/{trace_id}",
             self._h_not_enabled),
            ("GET", "/v2/console/soak", self._h_not_enabled),
            ("GET", "/v2/console/device", self._h_device),
            ("POST", "/v2/console/device/capture", self._h_device_capture),
            ("GET", "/v2/console/match/{id}/state", self._h_match_state),
            ("GET", "/v2/console/leaderboard", self._h_leaderboard_list),
            ("GET", "/v2/console/leaderboard/device",
             self._h_leaderboard_device),
            ("GET", "/v2/console/leaderboard/{id}",
             self._h_leaderboard_records),
            ("GET", "/v2/console/channel/{channel_id}",
             self._h_channel_messages),
            ("DELETE", "/v2/console/channel/{channel_id}/message/{message_id}",
             self._h_channel_message_delete),
            ("DELETE", "/v2/console/leaderboard/{id}/owner/{owner_id}",
             self._h_leaderboard_record_delete),
            ("GET", "/v2/console/group", self._h_group_list),
            ("GET", "/v2/console/group/{id}/member", self._h_group_members),
            ("GET", "/v2/console/purchase", self._h_purchase_list),
            ("GET", "/v2/console/user", self._h_console_user_list),
            ("POST", "/v2/console/user", self._h_console_user_create),
            ("DELETE", "/v2/console/user/{username}",
             self._h_console_user_delete),
            ("POST", "/v2/console/api/endpoints/rpc/{id}", self._h_call_rpc),
            ("POST", "/v2/console/authenticate/logout",
             self._h_authenticate_logout),
            ("GET", "/v2/console/api/endpoints", self._h_list_endpoints),
            ("POST", "/v2/console/api/endpoints/call", self._h_call_endpoint),
            ("DELETE", "/v2/console/all", self._h_delete_all_data),
            ("DELETE", "/v2/console/account", self._h_delete_accounts),
            ("GET", "/v2/console/account/{id}/friend",
             self._h_account_friends),
            ("DELETE", "/v2/console/account/{id}/friend/{friend_id}",
             self._h_account_friend_delete),
            ("GET", "/v2/console/account/{id}/group", self._h_account_groups),
            ("GET", "/v2/console/account/{id}/walletledger",
             self._h_wallet_ledger),
            ("DELETE", "/v2/console/account/{id}/walletledger/{ledger_id}",
             self._h_wallet_ledger_delete),
            ("POST", "/v2/console/account/{id}/unlink/{provider}",
             self._h_account_unlink),
            ("GET", "/v2/console/storage/collections", self._h_collections),
            ("DELETE", "/v2/console/storage", self._h_storage_delete_all),
            ("DELETE", "/v2/console/message", self._h_messages_delete),
            ("GET", "/v2/console/subscription", self._h_subscription_list),
            ("GET", "/v2/console/group/{id}", self._h_group_get),
            ("POST", "/v2/console/group/{id}", self._h_group_update),
            ("DELETE", "/v2/console/group/{id}", self._h_group_delete),
            ("GET", "/v2/console/group/{id}/export", self._h_group_export),
            ("POST", "/v2/console/group/{id}/member",
             self._h_group_member_add),
            ("DELETE", "/v2/console/group/{id}/member/{user_id}",
             self._h_group_member_kick),
            ("POST", "/v2/console/group/{id}/member/{user_id}/promote",
             self._h_group_member_promote),
            ("POST", "/v2/console/group/{id}/member/{user_id}/demote",
             self._h_group_member_demote),
            ("GET", "/v2/console/leaderboard/{id}/detail",
             self._h_leaderboard_get),
        ]
        # (method, path template) of every route, in routing order.
        self.routes = [(m, p) for m, p, _ in routes]
        self._routes = [(m, _pattern(p), h) for m, p, h in routes]

    # ----------------------------------------------------------- lifecycle

    async def start(self, host: str, port: int) -> int:
        self.port = await self._http.start(host, port)
        return self.port

    async def stop(self):
        await self._http.stop()
        await self._http.wait_closed()

    # ------------------------------------------------------------- routing

    async def _handle(self, raw: HttpRequest) -> HttpResponse:
        path = raw.path
        known = False
        for method, pattern, handler in self._routes:
            m = pattern.match(path)
            if m is None:
                continue
            known = True
            if method != raw.method:
                continue
            try:
                return await handler(_Request(raw, m.groupdict()))
            except _Refused as e:
                return _err(e.status, e.message)
            except Exception as e:  # the aiohttp console's unhandled 500
                self.logger.error(
                    "console handler error", path=path, error=repr(e)
                )
                return _text(
                    500,
                    "500 Internal Server Error\n\n"
                    "Server got itself in trouble",
                )
        if known:
            return _text(405, "405: Method Not Allowed")
        return _text(404, "404: Not Found")

    # ---------------------------------------------------------------- auth

    async def _h_authenticate(self, request: _Request):
        """Root admin from config, else console_user rows; failures feed
        the login-attempt lockout (reference console_authenticate.go:73)."""
        try:
            body = request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        username = body.get("username", "")
        password = body.get("password", "")
        attempts = self.server.login_attempt_cache
        client_ip = request.remote or ""
        if not attempts.allow(f"console:{username}", client_ip):
            return _err(429, "too many attempts, locked out")
        role = None
        if (
            username == self.config.console.username
            and password == self.config.console.password
        ):
            role = ROLE_ADMIN
        else:
            row = await self.server.db.fetch_one(
                "SELECT id, password, role, disable_time FROM console_user"
                " WHERE username = ?",
                (username,),
            )
            if (
                row is not None
                and not row["disable_time"]
                and core_auth.check_password(row["password"], password)
            ):
                role = row["role"]
        if role is None:
            attempts.add_failure(f"console:{username}", client_ip)
            return _err(401, "invalid credentials")
        attempts.reset(f"console:{username}")
        token, _ = session_token.generate(
            self.config.console.signing_key,
            username,
            username,
            self.config.console.token_expiry_sec,
            vars={"role": str(role)},
        )
        return json_response({"token": token, "role": role})

    def _auth(self, request: _Request, write: bool = False) -> int:
        header = request.headers.get("authorization", "")
        token = header[7:] if header.startswith("Bearer ") else ""
        if token in self._revoked:
            raise _Refused(401, "token revoked")
        try:
            claims = session_token.parse(
                self.config.console.signing_key, token
            )
        except session_token.TokenError:
            raise _Refused(401, "console auth required") from None
        role = int(claims.vars.get("role", ROLE_READONLY))
        if write and role > ROLE_MAINTAINER:
            raise _Refused(403, "read-only console user")
        return role

    # -------------------------------------------------------------- status

    async def _h_ui(self, request: _Request):
        """Embedded operator UI (reference embeds an Angular build,
        console/ui.go:24; here one static page over the JSON API)."""
        from .ui import PAGE

        return _text(200, PAGE, "text/html")

    async def _h_status(self, request: _Request):
        self._auth(request)
        s = self.server
        return json_response(
            {
                "name": self.config.name,
                "uptime_sec": time.time() - self._started_at,
                "sessions": len(s.session_registry.all()),
                "presences": s.tracker.count(),
                "matches": len(s.match_registry),
                "matchmaker_tickets": len(s.matchmaker),
                "overload_state": (
                    s.overload.stats()["state"]
                    if s.overload is not None
                    else "disabled"
                ),
                "slo_burn_rates": (
                    s.slo.sample() if s.slo is not None else {}
                ),
                "config_warnings": self.config.check(),
            }
        )

    async def _h_overload(self, request: _Request):
        """Overload-plane dashboard: ladder state + per-signal levels,
        admission stats, and the recent transition ledger."""
        self._auth(request)
        ov = self.server.overload
        if ov is None:
            return json_response({"enabled": False})
        return json_response(
            {
                "enabled": True,
                **ov.stats(),
                "recent_transitions": (
                    self.server._overload_tracing.recent_overload_events()
                ),
            }
        )

    async def _h_traces(self, request: _Request):
        """Kept-trace browser: newest-first summaries from the
        tail-sampled in-process store, plus the sampling posture and
        SLO burn snapshot."""
        self._auth(request)
        from ..tracing import TRACES

        raw = request.query.get("n", 32)
        try:
            n = min(256, max(1, int(raw)))
        except (TypeError, ValueError):
            return _err(400, f"n must be an integer, got {raw!r}")
        slo = self.server.slo
        return json_response(
            {
                "traces": TRACES.list(n),
                **TRACES.stats(),
                "slo": slo.snapshot() if slo is not None else {},
            }
        )

    async def _h_trace_get(self, request: _Request):
        self._auth(request)
        from ..tracing import TRACES

        trace = TRACES.get(request.match_info["trace_id"])
        if trace is None:
            return _err(404, "trace not found (dropped or evicted)")
        return json_response(trace)

    async def _h_config(self, request: _Request):
        """Config tree with secret redaction (reference
        console_config.go)."""
        self._auth(request)

        def scrub(obj):
            if dataclasses.is_dataclass(obj):
                out = {}
                for f in dataclasses.fields(obj):
                    value = getattr(obj, f.name)
                    if any(k in f.name.lower() for k in _REDACTED_KEYS) and (
                        isinstance(value, str) and value
                    ):
                        out[f.name] = "<redacted>"
                    else:
                        out[f.name] = scrub(value)
                return out
            if isinstance(obj, dict):
                return {k: scrub(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [scrub(v) for v in obj]
            return obj

        return json_response(scrub(self.config))

    async def _h_runtime(self, request: _Request):
        self._auth(request)
        runtime = self.server.runtime
        return json_response(
            {
                "loaded": runtime is not None,
                "modules": list(runtime.modules) if runtime else [],
                "rpcs": runtime.rpc_ids() if runtime else [],
                "matches": runtime.match_names() if runtime else [],
            }
        )

    # ------------------------------------------------------------ accounts

    async def _h_account_list(self, request: _Request):
        self._auth(request)
        q = request.query
        limit = max(1, min(int(q.get("limit", 50)), 100))
        filter_ = q.get("filter", "")
        params: list = []
        where = "WHERE 1=1"
        if filter_:
            where += " AND (id = ? OR username LIKE ?)"
            params.extend([filter_, f"{filter_}%"])
        rows = await self.server.db.fetch_all(
            f"SELECT id, username, display_name, create_time, disable_time"
            f" FROM users {where} ORDER BY create_time DESC LIMIT ?",
            (*params, limit),
        )
        total = await self.server.db.fetch_one(
            "SELECT COUNT(*) AS n FROM users"
        )
        return json_response(
            {"users": [dict(r) for r in rows], "total_count": total["n"]}
        )

    async def _h_account_get(self, request: _Request):
        self._auth(request)
        try:
            account = await core_account.get_account(
                self.server.db, request.match_info["id"]
            )
        except core_auth.AuthError:
            return _err(404, "account not found")
        account["wallet"] = await self.server.wallets.get(
            request.match_info["id"]
        )
        return json_response(account)

    async def _h_account_update(self, request: _Request):
        """Operator account edit (reference console_account.go
        UpdateAccount): profile fields, metadata, wallet replacement —
        each optional, absent leaves untouched."""
        self._auth(request, write=True)
        user_id = request.match_info["id"]
        try:
            body = request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        # Existence check up front: a wallet-only body would otherwise
        # slip past update_account's no-op early return and the 0-row
        # UPDATE, 200-ing an edit that never landed.
        exists = await self.server.db.fetch_one(
            "SELECT 1 FROM users WHERE id = ?", (user_id,)
        )
        if exists is None:
            return _err(404, "account not found")
        # Validate everything before the first write — a rejected wallet
        # must not leave a half-applied profile edit.
        wallet = body.get("wallet")
        if "wallet" in body and not isinstance(wallet, dict):
            return _err(400, "wallet must be a JSON object")
        try:
            await core_account.update_account(
                self.server.db,
                user_id,
                username=body.get("username"),
                display_name=body.get("display_name"),
                timezone=body.get("timezone"),
                location=body.get("location"),
                lang_tag=body.get("lang_tag"),
                avatar_url=body.get("avatar_url"),
                metadata=body.get("metadata"),
            )
            if "wallet" in body:
                await self.server.db.execute(
                    "UPDATE users SET wallet = ? WHERE id = ?",
                    (json.dumps(wallet), user_id),
                )
        except Exception as e:
            # Existence was pre-checked: anything raised here is bad
            # input (e.g. invalid username), not not-found.
            return _err(400, str(e))
        return json_response({})

    async def _h_account_wallet(self, request: _Request):
        """Wallet + ledger page (reference console_account.go
        GetWalletLedger)."""
        self._auth(request)
        user_id = request.match_info["id"]
        wallet = await self.server.wallets.get(user_id)
        items, cursor = await self.server.wallets.list_ledger(
            user_id,
            limit=int(request.query.get("limit", 100)),
            cursor=request.query.get("cursor", ""),
        )
        return json_response(
            {"wallet": wallet, "ledger": items, "cursor": cursor}
        )

    async def _h_account_ban(self, request: _Request):
        self._auth(request, write=True)
        user_id = request.match_info["id"]
        await self.server.db.execute(
            "UPDATE users SET disable_time = ? WHERE id = ?",
            (time.time(), user_id),
        )
        self.server.session_cache.ban([user_id])
        return json_response({})

    async def _h_account_unban(self, request: _Request):
        self._auth(request, write=True)
        user_id = request.match_info["id"]
        await self.server.db.execute(
            "UPDATE users SET disable_time = 0 WHERE id = ?", (user_id,)
        )
        self.server.session_cache.unban([user_id])
        return json_response({})

    async def _h_account_export(self, request: _Request):
        """GDPR-style account export (reference ExportAccount via
        console_account.go)."""
        self._auth(request)
        try:
            export = await core_account.export_account(
                self.server.db, request.match_info["id"]
            )
        except core_auth.AuthError:
            return _err(404, "account not found")
        return json_response(export)

    async def _h_account_delete(self, request: _Request):
        self._auth(request, write=True)
        await core_account.delete_account(
            self.server.db, request.match_info["id"], recorded=True
        )
        return json_response({})

    # ------------------------------------------------------------- storage

    async def _h_storage_list(self, request: _Request):
        self._auth(request)
        q = request.query
        limit = max(1, min(int(q.get("limit", 50)), 100))
        params: list = []
        where = "WHERE 1=1"
        if q.get("collection"):
            where += " AND collection = ?"
            params.append(q["collection"])
        if q.get("user_id"):
            where += " AND user_id = ?"
            params.append(q["user_id"])
        rows = await self.server.db.fetch_all(
            f"SELECT collection, key, user_id, version, update_time"
            f" FROM storage {where} ORDER BY collection, key LIMIT ?",
            (*params, limit),
        )
        return json_response({"objects": [dict(r) for r in rows]})

    async def _h_storage_get(self, request: _Request):
        self._auth(request)
        row = await self.server.db.fetch_one(
            "SELECT * FROM storage WHERE collection = ? AND key = ?"
            " AND user_id = ?",
            (
                request.match_info["collection"],
                request.match_info["key"],
                request.match_info["user_id"],
            ),
        )
        if row is None:
            return _err(404, "object not found")
        return json_response(dict(row))

    async def _h_storage_write(self, request: _Request):
        """Operator storage write (reference console_storage.go
        WriteStorageObject): system-caller semantics, any owner."""
        self._auth(request, write=True)
        try:
            body = request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        value = body.get("value", "")
        if not isinstance(value, str):
            value = json.dumps(value)
        try:
            acks = await storage_write_objects(
                self.server.db,
                None,  # system caller: permission/ownership bypass
                [
                    StorageOpWrite(
                        collection=body.get("collection", ""),
                        key=body.get("key", ""),
                        user_id=body.get("user_id", ""),
                        value=value,
                        version=body.get("version", ""),
                        permission_read=int(body.get("permission_read", 1)),
                        permission_write=int(
                            body.get("permission_write", 1)
                        ),
                    )
                ],
            )
        except Exception as e:
            return _err(400, str(e))
        return json_response(dataclasses.asdict(acks[0]))

    async def _h_storage_delete(self, request: _Request):
        self._auth(request, write=True)
        try:
            await storage_delete_objects(
                self.server.db,
                None,
                [
                    StorageOpDelete(
                        collection=request.match_info["collection"],
                        key=request.match_info["key"],
                        user_id=request.match_info["user_id"],
                    )
                ],
            )
        except Exception as e:
            return _err(400, str(e))
        return json_response({})

    async def _h_storage_import(self, request: _Request):
        """Bulk storage import, JSON array or CSV (reference
        console_storage_import.go). JSON: a list of objects with
        collection/key/user_id/value[/permission_read/permission_write].
        CSV: a header row naming those columns. Rows import in ONE
        transaction — an import either lands whole or not at all."""
        self._auth(request, write=True)
        raw = request.text()
        ctype = request.content_type
        rows: list[dict] = []
        try:
            if "csv" in ctype or (not raw.lstrip().startswith(("[", "{"))):
                rows = [dict(rec) for rec in csv.DictReader(io.StringIO(raw))]
            else:
                data = json.loads(raw)
                if not isinstance(data, list):
                    return _err(400, "JSON import must be an array")
                rows = data
        except Exception as e:
            return _err(400, f"unparseable import: {e}")
        ops = []
        try:
            for rec in rows:
                if not isinstance(rec, dict):
                    return _err(400, "import rows must be objects")
                value = rec.get("value", "")
                if not isinstance(value, str):
                    value = json.dumps(value)

                def perm(key: str) -> int:
                    # "" (CSV empty cell) and absent mean default 1;
                    # an explicit 0 must survive (private objects).
                    raw = rec.get(key)
                    if raw is None or raw == "":
                        return 1
                    return int(raw)

                ops.append(
                    StorageOpWrite(
                        collection=rec.get("collection", ""),
                        key=rec.get("key", ""),
                        user_id=rec.get("user_id", "") or "",
                        value=value,
                        permission_read=perm("permission_read"),
                        permission_write=perm("permission_write"),
                    )
                )
        except (TypeError, ValueError) as e:
            return _err(400, f"bad import row: {e}")
        if not ops:
            return _err(400, "no rows to import")
        try:
            acks = await storage_write_objects(self.server.db, None, ops)
        except Exception as e:
            return _err(400, str(e))
        return json_response({"imported": len(acks)})

    # ------------------------------------------------------------- matches

    async def _h_match_list(self, request: _Request):
        self._auth(request)
        matches = self.server.match_registry.list_matches(
            int(request.query.get("limit", 100))
        )
        return json_response({"matches": matches})

    async def _h_matchmaker(self, request: _Request):
        """Matchmaker observability: pool gauges, the per-interval device
        timing breadcrumbs (B1's stage and its kernel clocks among
        them), and the per-cohort delivery ledger with its per-stage
        attribution."""
        self._auth(request)
        mm = self.server.matchmaker
        tracing = getattr(mm.backend, "tracing", None)
        n = int(request.query.get("n", 32))
        return json_response(
            {
                "tickets": len(mm),
                "active": mm.store.n_active,
                "backend": type(mm.backend).__name__,
                "intervals": tracing.recent(n) if tracing is not None else [],
                "deliveries": (
                    tracing.recent_deliveries(n) if tracing is not None
                    else []
                ),
                "delivery_stages": (
                    tracing.delivery_stage_stats() if tracing is not None
                    else {}
                ),
                "ledger_totals": (
                    tracing.ledger_totals() if tracing is not None else {}
                ),
            }
        )

    async def _h_not_enabled(self, request: _Request):
        """Cluster posture, the fleet pane, fleet traces and the soak
        posture: the port has no cluster, fleet or soak engine yet, and
        answers as the JAX console does without one."""
        self._auth(request)
        return json_response({"enabled": False})

    async def _h_fleet_reshard(self, request: _Request):
        """Operator reshard plans go to the fleet collector's planner,
        which only a clustered node runs."""
        self._auth(request, write=True)
        return _err(
            400,
            "reshard planner not running here (needs"
            " cluster.reshard.enabled and the collector role)",
        )

    async def _h_purchase_list(self, request: _Request):
        self._auth(request)
        return json_response(
            await self.server.purchases.list(
                user_id=request.query.get("user_id") or None,
                limit=int(request.query.get("limit", 100)),
            )
        )

    async def _h_subscription_list(self, request: _Request):
        """Validated subscriptions, store-wide or per user (reference
        ListSubscriptions, console.proto:330)."""
        self._auth(request)
        q = request.query
        result = await self.server.purchases.list_subscriptions(
            q.get("user_id", ""),
            limit=int(q.get("limit", 100)),
            cursor=q.get("cursor", ""),
        )
        return json_response(result)

    async def _h_device(self, request: _Request):
        """Device telemetry dashboard (devobs.py): per-kernel clocks +
        build-watch counters, memory by owner with the backend
        cross-check, transfer counters per call site, the devices the
        process sees, and the recent kernel-event timeline."""
        self._auth(request)
        from ..devobs import DEVOBS, describe_devices

        try:
            n = min(256, max(1, int(request.query.get("n", 64))))
        except (TypeError, ValueError):
            return _err(400, "n must be an integer")
        return json_response(
            {
                **DEVOBS.stats(),
                "mesh": describe_devices(),
                "timeline": DEVOBS.recent_timeline(n),
            }
        )

    async def _h_device_capture(self, request: _Request):
        """On-demand bounded `torch.profiler` capture
        (`Tracing.device_trace`): one capture at a time; duration
        clamped to config.devobs.capture_max_ms; a Chrome trace lands
        under data_dir/device_captures/<time>/."""
        self._auth(request, write=True)
        try:
            body = request.json()
        except Exception:
            body = {}
        try:
            duration_ms = int(body.get("duration_ms", 1000))
        except (TypeError, ValueError):
            return _err(400, "duration_ms must be an integer")
        cap = self.config.devobs.capture_max_ms
        duration_ms = min(max(50, duration_ms), cap)
        if self._capture_busy:
            return _err(409, "a device capture is already running")
        tracing = getattr(self.server.matchmaker.backend, "tracing", None)
        if tracing is None:
            from ..tracing import Tracing

            tracing = Tracing(logger=self.logger)
        out_dir = os.path.join(
            self.config.data_dir,
            "device_captures",
            time.strftime("%Y%m%d-%H%M%S"),
        )
        os.makedirs(out_dir, exist_ok=True)
        self._capture_busy = True
        try:
            with tracing.device_trace(out_dir):
                # The profiler records process-wide: whatever device
                # work runs inside this bounded window is the capture.
                await asyncio.sleep(duration_ms / 1000.0)
        except Exception as e:
            return _err(503, f"device capture failed: {e}")
        finally:
            self._capture_busy = False
        self.logger.info(
            "device capture written", path=out_dir, duration_ms=duration_ms
        )
        return json_response({"path": out_dir, "duration_ms": duration_ms})

    async def _h_match_state(self, request: _Request):
        """Live authoritative match state (reference console match view
        via MatchRegistry GetState, match_registry.go:123)."""
        self._auth(request)
        state = self.server.match_registry.get_state(request.match_info["id"])
        if state is None:
            return _err(404, "match not found")
        state_json, tick, presence_count = state
        return json_response(
            {"state": state_json, "tick": tick, "presences": presence_count}
        )

    # -------------------------------------------------------- leaderboards

    async def _h_leaderboard_list(self, request: _Request):
        self._auth(request)
        return json_response(
            {
                "leaderboards": [
                    lb.as_dict()
                    for lb in self.server.leaderboards.list(
                        with_tournaments=True
                    )
                ]
            }
        )

    async def _h_leaderboard_device(self, request: _Request):
        """Device rank-engine dashboard: breaker state, adopted boards
        with their staging/flush posture, read/fallback ledger."""
        self._auth(request)
        engine = self.server.leaderboards.device
        if engine is None:
            return json_response({"enabled": False, "boards": []})
        return json_response(engine.stats())

    async def _h_leaderboard_records(self, request: _Request):
        """Records with their ranks: from the rank engine on the card
        (`lex_ranks`) for an adopted board, else the host rank cache."""
        self._auth(request)
        try:
            result = await self.server.leaderboards.records_list(
                request.match_info["id"],
                limit=int(request.query.get("limit", 100)),
            )
        except Exception as e:
            return _err(404, str(e))
        return json_response(result)

    async def _h_leaderboard_record_delete(self, request: _Request):
        """Operator record removal (reference console.proto
        DeleteLeaderboardRecord) — authoritative caller."""
        self._auth(request, write=True)
        try:
            deleted = await self.server.leaderboards.record_delete(
                request.match_info["id"],
                request.match_info["owner_id"],
                caller_authoritative=True,
            )
        except LeaderboardError as e:
            return _err(404, str(e))
        if not deleted:
            return _err(404, "record not found")
        return json_response({})

    async def _h_leaderboard_get(self, request: _Request):
        """One board definition (reference GetLeaderboard)."""
        self._auth(request)
        lb = self.server.leaderboards.get(request.match_info["id"])
        if lb is None:
            return _err(404, "leaderboard not found")
        return json_response(lb.as_dict())

    # ------------------------------------------------------------ channels

    async def _h_channel_messages(self, request: _Request):
        """Message browse for any channel (reference console.proto
        ListChannelMessages)."""
        self._auth(request)
        from ..api.http import _parse_bool

        try:
            result = await self.server.channels.messages_list(
                request.match_info["channel_id"],
                limit=int(request.query.get("limit", 100)),
                forward=_parse_bool(request.query.get("forward", True)),
                cursor=request.query.get("cursor", ""),
            )
        except ChannelError as e:
            return _err(400, str(e))
        return json_response(result)

    async def _h_channel_message_delete(self, request: _Request):
        """Operator message removal through the channel core: the message
        must belong to the named channel and live subscribers get the
        removal broadcast — only the sender gate is bypassed."""
        self._auth(request, write=True)
        try:
            await self.server.channels.message_remove(
                request.match_info["channel_id"],
                request.match_info["message_id"],
                authoritative=True,
            )
        except ChannelError as e:
            status = 404 if e.code == "not_found" else 400
            return _err(status, str(e))
        return json_response({})

    async def _h_messages_delete(self, request: _Request):
        """Bulk chat-message deletion by id, or everything before a
        timestamp (reference DeleteChannelMessages)."""
        self._auth(request, write=True)
        try:
            body = request.json()
        except Exception:
            body = {}
        ids = body.get("ids") or []
        before = body.get("before")
        if before is not None:
            try:
                before = float(before)
            except (TypeError, ValueError):
                return _err(400, "before must be epoch seconds")
        total = 0
        if ids:
            # Chunked IN-clause: one write transaction per chunk, not one
            # per id.
            ids = [str(m) for m in ids]
            for i in range(0, len(ids), 256):
                chunk = ids[i : i + 256]
                marks = ",".join("?" * len(chunk))
                total += await self.server.db.execute(
                    f"DELETE FROM message WHERE id IN ({marks})",
                    tuple(chunk),
                )
        if before is not None:
            total += await self.server.db.execute(
                "DELETE FROM message WHERE create_time < ?", (before,)
            )
        return json_response({"total": total})

    # -------------------------------------------------------------- groups

    async def _h_group_list(self, request: _Request):
        """Group browse (reference console_group.go ListGroups)."""
        self._auth(request)
        q = request.query
        result = await self.server.groups.list(
            name=q.get("name") or None,
            limit=int(q.get("limit", 100)),
            cursor=q.get("cursor", ""),
        )
        return json_response(result)

    async def _h_group_members(self, request: _Request):
        self._auth(request)
        try:
            result = await self.server.groups.users_list(
                request.match_info["id"],
                limit=int(request.query.get("limit", 100)),
                cursor=request.query.get("cursor", ""),
            )
        except GroupError as e:
            return _err(404, str(e))
        return json_response(result)

    async def _h_group_get(self, request: _Request):
        self._auth(request)
        try:
            group = await self.server.groups.get(request.match_info["id"])
        except Exception:
            return _err(404, "group not found")
        return json_response(group)

    async def _h_group_update(self, request: _Request):
        """Operator group edit (reference console UpdateGroup)."""
        self._auth(request, write=True)
        try:
            body = request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        try:
            await self.server.groups.update(
                request.match_info["id"],
                caller_id="",  # console is authoritative
                name=body.get("name"),
                description=body.get("description"),
                avatar_url=body.get("avatar_url"),
                lang_tag=body.get("lang_tag"),
                metadata=body.get("metadata"),
                open=body.get("open"),
                max_count=body.get("max_count"),
            )
        except Exception as e:
            return _err(400, str(e))
        return json_response({})

    async def _h_group_delete(self, request: _Request):
        self._auth(request, write=True)
        try:
            await self.server.groups.delete(
                request.match_info["id"], caller_id=""
            )
        except Exception as e:
            return _err(404, str(e))
        return json_response({})

    async def _h_group_export(self, request: _Request):
        """Group + full member list in one document (reference
        ExportGroup)."""
        self._auth(request)
        gid = request.match_info["id"]
        try:
            group = await self.server.groups.get(gid)
        except Exception:
            return _err(404, "group not found")
        # Full member list: walk every page (an export must not truncate).
        members: list = []
        cursor = ""
        while True:
            page = await self.server.groups.users_list(
                gid, limit=1000, cursor=cursor
            )
            members.extend(page.get("group_users", []))
            cursor = page.get("cursor", "")
            if not cursor:
                break
        return json_response({"group": group, "members": members})

    async def _h_group_member_add(self, request: _Request):
        """Console AddGroupUsers: direct member admission."""
        self._auth(request, write=True)
        try:
            body = request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        ids = body.get("user_ids") or []
        if not ids:
            return _err(400, "user_ids required")
        try:
            await self.server.groups.users_add(
                request.match_info["id"], ids, caller_id=""
            )
        except Exception as e:
            return _err(400, str(e))
        return json_response({})

    async def _group_members_action(self, request: _Request, action: str):
        self._auth(request, write=True)
        try:
            await getattr(self.server.groups, action)(
                request.match_info["id"],
                [request.match_info["user_id"]],
                caller_id="",
            )
        except Exception as e:
            return _err(400, str(e))
        return json_response({})

    async def _h_group_member_kick(self, request: _Request):
        """Console DeleteGroupUser."""
        return await self._group_members_action(request, "users_kick")

    async def _h_group_member_promote(self, request: _Request):
        return await self._group_members_action(request, "users_promote")

    async def _h_group_member_demote(self, request: _Request):
        return await self._group_members_action(request, "users_demote")

    # -------------------------------------------------------- console users

    async def _h_console_user_list(self, request: _Request):
        self._auth(request)
        rows = await self.server.db.fetch_all(
            "SELECT username, email, role, create_time, disable_time"
            " FROM console_user ORDER BY username"
        )
        return json_response({"users": [dict(r) for r in rows]})

    async def _h_console_user_create(self, request: _Request):
        """Operator account provisioning (reference console_user.go
        AddUser): admin-only."""
        role = self._auth(request, write=True)
        if role != ROLE_ADMIN:
            return _err(403, "admin role required")
        try:
            body = request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        username = body.get("username", "")
        password = body.get("password", "")
        if not username or len(password) < 8:
            return _err(400, "username and password (>= 8 chars) required")
        try:
            new_role = int(body.get("role", ROLE_READONLY))
        except (TypeError, ValueError):
            return _err(400, "invalid role")
        if new_role not in (
            ROLE_ADMIN, ROLE_DEVELOPER, ROLE_MAINTAINER, ROLE_READONLY
        ):
            return _err(400, "invalid role")
        try:
            await self.server.db.execute(
                "INSERT INTO console_user (id, username, email, password,"
                " role, create_time, update_time, disable_time)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, 0)",
                (
                    str(uuid.uuid4()),
                    username,
                    # email is NOT NULL UNIQUE; synthesize one if absent
                    # so two email-less operators don't collide on "".
                    body.get("email") or f"{username}@console.local",
                    core_auth.hash_password(password),
                    new_role,
                    time.time(),
                    time.time(),
                ),
            )
        except UniqueViolationError:
            return _err(409, "username already exists")
        return json_response({"username": username, "role": new_role})

    async def _h_console_user_delete(self, request: _Request):
        role = self._auth(request, write=True)
        if role != ROLE_ADMIN:
            return _err(403, "admin role required")
        n = await self.server.db.execute(
            "DELETE FROM console_user WHERE username = ?",
            (request.match_info["username"],),
        )
        if not n:
            return _err(404, "console user not found")
        return json_response({})

    async def _h_authenticate_logout(self, request: _Request):
        """Invalidate the presented console token (reference
        AuthenticateLogout): stateless JWTs get a revocation set checked
        by _auth."""
        self._auth(request)
        header = request.headers.get("authorization", "")
        token = header[7:] if header.startswith("Bearer ") else ""
        self._revoked.add(token)
        if len(self._revoked) > 4096:
            # Prune EXPIRED revocations only — clearing the set would
            # un-revoke live tokens and silently undo earlier logouts.
            live = set()
            for t in self._revoked:
                try:
                    session_token.parse(self.config.console.signing_key, t)
                except session_token.TokenError:
                    continue  # expired/invalid: safe to forget
                live.add(t)
            self._revoked = live
        return json_response({})

    # ------------------------------------------------------------ explorer

    async def _h_call_rpc(self, request: _Request):
        """API explorer: invoke any registered RPC as the console
        (reference console_api_explorer.go)."""
        self._auth(request, write=True)
        runtime = self.server.runtime
        if runtime is None:
            return _err(501, "runtime not loaded")
        fn = runtime.rpc(request.match_info["id"].lower())
        if fn is None:
            return _err(404, "rpc not found")
        payload = request.text()
        try:
            result = fn(runtime.context(mode="console"), payload)
            if asyncio.iscoroutine(result):
                result = await result
        except Exception as e:
            return _err(500, str(e))
        return json_response({"payload": result or ""})

    async def _h_list_endpoints(self, request: _Request):
        """Every REST endpoint of the main API listener (reference
        ListApiEndpoints feeding the console explorer)."""
        self._auth(request)
        endpoints = [
            {"method": m, "path": p}
            for m, p in self.server.api.routes
            if m not in ("HEAD", "OPTIONS")
        ]
        runtime = self.server.runtime
        return json_response(
            {
                "endpoints": sorted(
                    endpoints, key=lambda e: (e["path"], e["method"])
                ),
                "rpc_endpoints": runtime.rpc_ids() if runtime else [],
            }
        )

    async def _h_call_endpoint(self, request: _Request):
        """Invoke any api endpoint through the real API listener
        (reference CallApiEndpoint): the operator supplies
        method/path/body, optionally a user_id the call should act as —
        a short-lived session token is minted for it."""
        self._auth(request, write=True)
        try:
            body = request.json()
        except Exception:
            return _err(400, "invalid JSON body")
        method = str(body.get("method", "GET")).upper()
        path = str(body.get("path", ""))
        if not path.startswith("/v2/") or path.startswith("/v2/console"):
            return _err(400, "path must be a /v2/ api endpoint")
        headers = {}
        user_id = body.get("user_id", "")
        if user_id:
            row = await self.server.db.fetch_one(
                "SELECT username FROM users WHERE id = ?", (user_id,)
            )
            if row is None:
                return _err(404, "user not found")
            token, claims = session_token.generate(
                self.config.session.encryption_key,
                user_id,
                row["username"],
                60,
            )
            # Register with the session cache or the API's validity
            # check rejects the minted token.
            self.server.session_cache.add(
                user_id, claims.expires_at, claims.token_id
            )
            headers["Authorization"] = f"Bearer {token}"
        elif body.get("server_key_auth", True):
            key = self.config.socket.server_key
            headers["Authorization"] = "Basic " + base64.b64encode(
                f"{key}:".encode()
            ).decode()
        query = body.get("query") or None
        if query:
            path += ("&" if "?" in path else "?") + urllib.parse.urlencode(
                query
            )
        resp = await wsproto.request(
            "127.0.0.1",
            self.server.port,
            method,
            path,
            headers=headers,
            body=body.get("body"),
        )
        return json_response(
            {"status": resp.status, "body": resp.body.decode("utf-8")}
        )

    # ---------------------------------------------------------- bulk wipes

    async def _h_delete_all_data(self, request: _Request):
        """Wipe every domain table (reference DeleteAllData) — console
        users and migration history remain; in-RAM state (leaderboard
        caches, matchmaker pool, sessions) is reset to match."""
        self._auth(request, write=True)
        tables = (
            "user_edge", "user_device", "notification", "storage",
            "message", "leaderboard_record", "leaderboard",
            "wallet_ledger", "user_tombstone", "group_edge", "groups",
            "purchase", "purchase_receipt", "subscription", "users",
        )
        for t in tables:
            await self.server.db.execute(f"DELETE FROM {t}")
        self.server.leaderboards.clear_rank_state()
        await self.server.leaderboards.load()
        self.server.matchmaker.remove_all(self.server.matchmaker.node)
        # Deleted users' bearer tokens must die with their rows.
        self.server.session_cache.clear()
        for s in self.server.session_registry.all():
            await s.close("data deleted")
        return json_response({})

    async def _h_delete_accounts(self, request: _Request):
        """Delete ALL user accounts (reference DeleteAccounts)."""
        self._auth(request, write=True)
        rows = await self.server.db.fetch_all("SELECT id FROM users")
        for r in rows:
            await core_account.delete_account(
                self.server.db, r["id"], recorded=False
            )
        return json_response({"deleted": len(rows)})

    async def _h_storage_delete_all(self, request: _Request):
        """Wipe the whole object store (reference DeleteStorage)."""
        self._auth(request, write=True)
        await self.server.db.execute("DELETE FROM storage")
        return json_response({})

    async def _h_collections(self, request: _Request):
        """Distinct storage collections (reference
        ListStorageCollections)."""
        self._auth(request)
        rows = await self.server.db.fetch_all(
            "SELECT DISTINCT collection FROM storage ORDER BY collection"
        )
        return json_response(
            {"collections": [r["collection"] for r in rows]}
        )

    # ------------------------------------------------------ account extras

    async def _h_account_friends(self, request: _Request):
        """A user's friend list (reference GetFriends)."""
        self._auth(request)
        result = await self.server.friends.list(
            request.match_info["id"], limit=100
        )
        return json_response(result)

    async def _h_account_friend_delete(self, request: _Request):
        self._auth(request, write=True)
        await self.server.friends.delete(
            request.match_info["id"], request.match_info["friend_id"]
        )
        return json_response({})

    async def _h_account_groups(self, request: _Request):
        """A user's group memberships (reference GetGroups)."""
        self._auth(request)
        result = await self.server.groups.user_groups_list(
            request.match_info["id"], limit=100
        )
        return json_response(result)

    async def _h_wallet_ledger(self, request: _Request):
        """Dedicated ledger window (reference GetWalletLedger)."""
        self._auth(request)
        items, cursor = await self.server.wallets.list_ledger(
            request.match_info["id"],
            limit=int(request.query.get("limit", 100)),
            cursor=request.query.get("cursor", ""),
        )
        return json_response({"items": items, "cursor": cursor})

    async def _h_wallet_ledger_delete(self, request: _Request):
        """Remove one ledger entry (reference DeleteWalletLedger) — the
        wallet itself is untouched."""
        self._auth(request, write=True)
        n = await self.server.db.execute(
            "DELETE FROM wallet_ledger WHERE id = ? AND user_id = ?",
            (request.match_info["ledger_id"], request.match_info["id"]),
        )
        if not n:
            return _err(404, "ledger item not found")
        return json_response({})

    async def _h_account_unlink(self, request: _Request):
        """Per-provider unlink on behalf of a user (reference console
        UnlinkApple..UnlinkSteam)."""
        self._auth(request, write=True)
        user_id = request.match_info["id"]
        provider = request.match_info["provider"]
        fns = {
            "device": None,  # needs the device id from the body
            "email": core_link.unlink_email,
            "custom": core_link.unlink_custom,
            "apple": core_link.unlink_apple,
            "facebook": core_link.unlink_facebook,
            "facebookinstantgame": core_link.unlink_facebook_instant,
            "gamecenter": core_link.unlink_gamecenter,
            "google": core_link.unlink_google,
            "steam": core_link.unlink_steam,
        }
        if provider not in fns:
            return _err(400, "unknown provider")
        try:
            if provider == "device":
                try:
                    body = request.json()
                except Exception:
                    body = {}
                device_id = body.get("device_id", "")
                if not device_id:
                    return _err(400, "device_id required")
                await core_link.unlink_device(
                    self.server.db, user_id, device_id
                )
            else:
                await fns[provider](self.server.db, user_id)
        except Exception as e:
            return _err(400, str(e))
        return json_response({})

"""The `nk` server-function module handed to runtime user code.

Parity with the reference's RuntimeGoNakamaModule (reference
server/runtime_go_nakama.go — 125 functions over auth, accounts, storage,
wallets, leaderboards, tournaments, groups, friends, streams, matches,
notifications, metrics). Functions delegate to the same core functions the
API layer uses; the facade grows with the cores. All DB-touching functions
are async (user modules run on the server's event loop).

The port's copy of the JAX package's `runtime/nk.py`, with the same
public methods over the port's `core/`, `realtime/`, `match/`,
`leaderboard/`, `social/`, `iap/` and matchmaker.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import json
import time
import uuid as uuid_mod
from typing import Any

from ..core import account as core_account
from ..core import authenticate as core_auth
from ..core import link as core_link
from ..core import storage as core_storage
from ..realtime import PresenceMeta, Stream, StreamMode


class NakamaModule:
    """`nk` — constructed once at runtime load; every component is optional
    so partial wirings (tests, tools) degrade to clear errors instead of
    import-time failures."""

    def __init__(
        self,
        logger,
        config,
        *,
        db=None,
        session_cache=None,
        session_registry=None,
        tracker=None,
        router=None,
        stream_manager=None,
        status_registry=None,
        matchmaker=None,
        match_registry=None,
        party_registry=None,
        metrics=None,
        social=None,
        notifications=None,
        wallet=None,
        friends=None,
        groups=None,
        channels=None,
        leaderboards=None,
        tournaments=None,
        purchases=None,
        runtime=None,
    ):
        self.logger = logger.with_fields(subsystem="nk")
        self.config = config
        self.node = getattr(config, "name", "")
        self.db = db
        self.session_cache = session_cache
        self.session_registry = session_registry
        self.tracker = tracker
        self.router = router
        self.stream_manager = stream_manager
        self.status_registry = status_registry
        self.matchmaker = matchmaker
        self.match_registry = match_registry
        self.party_registry = party_registry
        self.metrics = metrics
        self.social = social
        self.notifications = notifications
        self.wallet = wallet
        self.friends = friends
        self.groups = groups
        self.channels = channels
        self.leaderboards = leaderboards
        self.tournaments = tournaments
        self.purchases = purchases
        self.runtime = runtime

    # ------------------------------------------------------------- helpers

    def _db(self):
        if self.db is None:
            raise RuntimeError("database not configured")
        return self.db

    def _component(self, name: str):
        c = getattr(self, name, None)
        if c is None:
            raise RuntimeError(f"{name} not configured")
        return c

    # ------------------------------------------------------ authentication

    async def authenticate_device(
        self, device_id: str, username: str = "", create: bool = True
    ):
        return await core_auth.authenticate_device(
            self._db(), device_id, username or None, create
        )

    async def authenticate_email(
        self, email: str, password: str, username: str = "",
        create: bool = True,
    ):
        return await core_auth.authenticate_email(
            self._db(), email, password, username or None, create
        )

    async def authenticate_custom(
        self, custom_id: str, username: str = "", create: bool = True
    ):
        return await core_auth.authenticate_custom(
            self._db(), custom_id, username or None, create
        )

    def authenticate_token_generate(
        self, user_id: str, username: str, expiry_sec: int = 0,
        vars: dict | None = None,
    ) -> tuple[str, int]:
        """Mint a session token for a user (reference AuthenticateTokenGenerate)."""
        from ..api import session_token

        expiry = expiry_sec or self.config.session.token_expiry_sec
        token, claims = session_token.generate(
            self.config.session.encryption_key,
            user_id,
            username,
            expiry,
            vars=vars or {},
        )
        if self.session_cache is not None:
            self.session_cache.add(
                user_id, claims.expires_at, claims.token_id
            )
        return token, claims.expires_at

    # Social-provider auth (each core verifies with the social client the
    # way the API layer does — reference runtime_go_nakama.go
    # AuthenticateApple..AuthenticateSteam).

    def _social(self):
        if self.social is None:
            raise RuntimeError("social client not configured")
        return self.social

    async def authenticate_apple(
        self, token: str, username: str = "", create: bool = True
    ):
        return await core_auth.authenticate_apple(
            self._db(), self._social(), self.config.social.apple_bundle_id,
            token, username or None, create,
        )

    async def authenticate_facebook(
        self, token: str, username: str = "", create: bool = True,
        import_friends: bool = False,
    ):
        return await core_auth.authenticate_facebook(
            self._db(), self._social(), token, username or None, create
        )

    async def authenticate_facebook_instant_game(
        self, signed_player_info: str, username: str = "",
        create: bool = True,
    ):
        return await core_auth.authenticate_facebook_instant(
            self._db(), self._social(),
            self.config.social.facebook_instant_app_secret,
            signed_player_info, username or None, create,
        )

    async def authenticate_game_center(
        self, player_id: str, bundle_id: str, timestamp: int, salt: str,
        signature: str, public_key_url: str, username: str = "",
        create: bool = True,
    ):
        return await core_auth.authenticate_gamecenter(
            self._db(), self._social(), player_id, bundle_id, timestamp,
            salt, signature, public_key_url, username or None, create,
        )

    async def authenticate_google(
        self, token: str, username: str = "", create: bool = True
    ):
        return await core_auth.authenticate_google(
            self._db(), self._social(), token, username or None, create
        )

    async def authenticate_steam(
        self, token: str, username: str = "", create: bool = True
    ):
        sc = self.config.social
        return await core_auth.authenticate_steam(
            self._db(), self._social(), sc.steam_app_id,
            sc.steam_publisher_key, token, username or None, create,
        )

    def session_logout(
        self, user_id: str, token: str = "", refresh_token: str = ""
    ) -> None:
        """Invalidate a user's session tokens (reference SessionLogout,
        runtime_go_nakama.go): specific tokens when given, else all."""
        cache = self._component("session_cache")
        from ..api import session_token

        key = self.config.session.encryption_key
        if not token and not refresh_token:
            cache.remove_all(user_id)
            return
        if token:
            claims = session_token.parse(key, token)
            cache.remove_session(user_id, claims.token_id)
        if refresh_token:
            claims = session_token.parse(
                self.config.session.refresh_encryption_key, refresh_token
            )
            cache.remove_refresh(user_id, claims.token_id)

    async def session_disconnect(
        self, session_id: str, reason: str = ""
    ) -> bool:
        return await self._component("session_registry").disconnect(
            session_id, reason
        )

    # ------------------------------------------------------------ accounts

    async def account_get_id(self, user_id: str) -> dict:
        return await core_account.get_account(self._db(), user_id)

    async def accounts_get_id(self, user_ids: list[str]) -> list[dict]:
        out = []
        for uid in user_ids:
            try:
                out.append(await core_account.get_account(self._db(), uid))
            except core_auth.AuthError:
                pass
        return out

    async def account_update_id(self, user_id: str, **fields) -> None:
        await core_account.update_account(self._db(), user_id, **fields)

    async def account_delete_id(
        self, user_id: str, recorded: bool = False
    ) -> None:
        await core_account.delete_account(self._db(), user_id, recorded)

    async def account_export_id(self, user_id: str) -> str:
        """One JSON document of everything held for a user (reference
        AccountExportId)."""
        return json.dumps(
            await core_account.export_account(self._db(), user_id)
        )

    async def users_get_id(self, user_ids: list[str]) -> list[dict]:
        return await core_account.get_users(self._db(), user_ids=user_ids)

    async def users_get_username(self, usernames: list[str]) -> list[dict]:
        return await core_account.get_users(self._db(), usernames=usernames)

    async def users_get_random(self, count: int) -> list[dict]:
        return await core_account.users_get_random(self._db(), count)

    async def users_ban_id(self, user_ids: list[str]) -> None:
        """Ban: disable accounts, invalidate cached sessions, disconnect
        live sockets (reference UsersBanId, runtime_go_nakama.go)."""
        await core_account.ban_users(self._db(), user_ids)
        if self.session_cache is not None:
            self.session_cache.ban(user_ids)
        if self.session_registry is not None:
            targets = set(user_ids)
            for s in self.session_registry.all():
                if s.user_id in targets:
                    await s.close("banned")

    async def users_unban_id(self, user_ids: list[str]) -> None:
        await core_account.unban_users(self._db(), user_ids)
        if self.session_cache is not None:
            self.session_cache.unban(user_ids)

    # ------------------------------------------------------------- linking

    async def link_device(self, user_id: str, device_id: str):
        await core_link.link_device(self._db(), user_id, device_id)

    async def unlink_device(self, user_id: str, device_id: str):
        await core_link.unlink_device(self._db(), user_id, device_id)

    async def link_email(self, user_id: str, email: str, password: str):
        await core_link.link_email(self._db(), user_id, email, password)

    async def unlink_email(self, user_id: str):
        await core_link.unlink_email(self._db(), user_id)

    async def link_custom(self, user_id: str, custom_id: str):
        await core_link.link_custom(self._db(), user_id, custom_id)

    async def unlink_custom(self, user_id: str):
        await core_link.unlink_custom(self._db(), user_id)

    async def link_apple(self, user_id: str, token: str):
        await core_link.link_apple(
            self._db(), self._social(), user_id,
            self.config.social.apple_bundle_id, token,
        )

    async def unlink_apple(self, user_id: str):
        await core_link.unlink_apple(self._db(), user_id)

    async def link_facebook(
        self, user_id: str, username: str, token: str,
        import_friends: bool = False,
    ):
        await core_link.link_facebook(
            self._db(), self._social(), user_id, token
        )

    async def unlink_facebook(self, user_id: str):
        await core_link.unlink_facebook(self._db(), user_id)

    async def link_facebook_instant_game(
        self, user_id: str, signed_player_info: str
    ):
        await core_link.link_facebook_instant(
            self._db(), self._social(), user_id,
            self.config.social.facebook_instant_app_secret,
            signed_player_info,
        )

    async def unlink_facebook_instant_game(self, user_id: str):
        await core_link.unlink_facebook_instant(self._db(), user_id)

    async def link_game_center(
        self, user_id: str, player_id: str, bundle_id: str, timestamp: int,
        salt: str, signature: str, public_key_url: str,
    ):
        await core_link.link_gamecenter(
            self._db(), self._social(), user_id, player_id, bundle_id,
            timestamp, salt, signature, public_key_url,
        )

    async def unlink_game_center(self, user_id: str):
        await core_link.unlink_gamecenter(self._db(), user_id)

    async def link_google(self, user_id: str, token: str):
        await core_link.link_google(
            self._db(), self._social(), user_id, token
        )

    async def unlink_google(self, user_id: str):
        await core_link.unlink_google(self._db(), user_id)

    async def link_steam(self, user_id: str, username: str, token: str):
        sc = self.config.social
        await core_link.link_steam(
            self._db(), self._social(), user_id, sc.steam_app_id,
            sc.steam_publisher_key, token,
        )

    async def unlink_steam(self, user_id: str):
        await core_link.unlink_steam(self._db(), user_id)

    # ------------------------------------------------------------- storage

    async def storage_read(self, reads: list[dict]) -> list[dict]:
        ops = [
            core_storage.StorageOpRead(
                collection=r["collection"],
                key=r["key"],
                user_id=r.get("user_id", ""),
            )
            for r in reads
        ]
        objects = await core_storage.storage_read_objects(
            self._db(), None, ops
        )
        return [o.as_dict() for o in objects]

    async def storage_write(self, writes: list[dict]) -> list[dict]:
        ops = [
            core_storage.StorageOpWrite(
                collection=w["collection"],
                key=w["key"],
                user_id=w.get("user_id", ""),
                value=(
                    w["value"]
                    if isinstance(w["value"], str)
                    else json.dumps(w["value"])
                ),
                version=w.get("version", ""),
                permission_read=int(w.get("permission_read", 1)),
                permission_write=int(w.get("permission_write", 1)),
            )
            for w in writes
        ]
        acks = await core_storage.storage_write_objects(
            self._db(), None, ops
        )
        return [
            {
                "collection": a.collection,
                "key": a.key,
                "user_id": a.user_id,
                "version": a.version,
            }
            for a in acks
        ]

    async def storage_delete(self, deletes: list[dict]) -> None:
        ops = [
            core_storage.StorageOpDelete(
                collection=d["collection"],
                key=d["key"],
                user_id=d.get("user_id", ""),
                version=d.get("version", ""),
            )
            for d in deletes
        ]
        await core_storage.storage_delete_objects(self._db(), None, ops)

    async def storage_list(
        self, user_id: str | None, collection: str, limit: int = 100,
        cursor: str = "",
    ):
        objects, next_cursor = await core_storage.storage_list_objects(
            self._db(),
            None,
            collection,
            user_id=user_id,
            limit=limit,
            cursor=cursor,
        )
        return [o.as_dict() for o in objects], next_cursor

    # -------------------------------------------------------------- wallet

    async def wallet_update(
        self, user_id: str, changeset: dict, metadata: dict | None = None,
        update_ledger: bool = True,
    ) -> tuple[dict, dict]:
        w = self._component("wallet")
        results = await w.update_wallets(
            [
                {
                    "user_id": user_id,
                    "changeset": changeset,
                    "metadata": metadata or {},
                }
            ],
            update_ledger,
        )
        r = results[0]
        return r["updated"], r["previous"]

    async def wallets_update(
        self, updates: list[dict], update_ledger: bool = True
    ) -> list[dict]:
        w = self._component("wallet")
        return await w.update_wallets(updates, update_ledger)

    async def wallet_ledger_list(
        self, user_id: str, limit: int = 100, cursor: str = ""
    ):
        w = self._component("wallet")
        return await w.list_ledger(user_id, limit, cursor)

    async def wallet_ledger_update(
        self, ledger_id: str, metadata: dict
    ) -> dict:
        w = self._component("wallet")
        return await w.ledger_update(ledger_id, metadata)

    async def multi_update(
        self,
        wallet_updates: list[dict] | None = None,
        storage_writes: list[dict] | None = None,
        account_updates: list[dict] | None = None,
        update_ledger: bool = True,
    ) -> dict:
        """Cross-entity transactional update (reference nk.MultiUpdate,
        core_multi.go)."""
        from ..core import storage as core_storage
        from ..core.wallet import multi_update as _multi

        ops = [
            core_storage.StorageOpWrite(
                collection=w["collection"],
                key=w["key"],
                user_id=w.get("user_id", ""),
                value=(
                    w["value"]
                    if isinstance(w["value"], str)
                    else json.dumps(w["value"])
                ),
                version=w.get("version", ""),
                permission_read=int(w.get("permission_read", 1)),
                permission_write=int(w.get("permission_write", 1)),
            )
            for w in storage_writes or []
        ]
        return await _multi(
            self._db(),
            self._component("wallet"),
            wallet_updates=wallet_updates,
            storage_writes=ops,
            account_updates=account_updates,
            update_ledger=update_ledger,
        )

    # ------------------------------------------------------- notifications

    async def notification_send(
        self, user_id: str, subject: str, content: dict, code: int,
        sender_id: str = "", persistent: bool = False,
    ) -> None:
        n = self._component("notifications")
        await n.send(
            user_id,
            subject=subject,
            content=content,
            code=code,
            sender_id=sender_id,
            persistent=persistent,
        )

    async def notifications_send(self, notifications: list[dict]) -> None:
        n = self._component("notifications")
        await n.send_many(notifications)

    async def notification_send_all(
        self, subject: str, content: dict, code: int,
        persistent: bool = False,
    ) -> None:
        n = self._component("notifications")
        await n.send_all(
            subject=subject, content=content, code=code, persistent=persistent
        )

    async def notifications_delete(
        self, user_id: str, ids: list[str]
    ) -> None:
        n = self._component("notifications")
        await n.delete(user_id, ids)

    # ----------------------------------------------- purchases/subscriptions

    async def purchase_validate_apple(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> list[dict]:
        p = self._component("purchases")
        return await p.validate_apple(user_id, receipt, persist)

    async def purchase_validate_google(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> list[dict]:
        p = self._component("purchases")
        return await p.validate_google(user_id, receipt, persist)

    async def purchase_validate_huawei(
        self, user_id: str, receipt: str, signature: str = "",
        persist: bool = True,
    ) -> list[dict]:
        p = self._component("purchases")
        return await p.validate_huawei(user_id, receipt, persist)

    async def purchase_get_by_transaction_id(
        self, transaction_id: str
    ) -> dict | None:
        p = self._component("purchases")
        return await p.get_by_transaction(transaction_id)

    async def purchases_list(
        self, user_id: str = "", limit: int = 100, cursor: str = ""
    ) -> dict:
        p = self._component("purchases")
        return await p.list_purchases(user_id, limit, cursor)

    async def subscription_validate_apple(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> dict:
        p = self._component("purchases")
        return await p.validate_subscription_apple(user_id, receipt, persist)

    async def subscription_validate_google(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> dict:
        p = self._component("purchases")
        return await p.validate_subscription_google(user_id, receipt, persist)

    async def subscription_get_by_product_id(
        self, user_id: str, product_id: str
    ) -> dict | None:
        p = self._component("purchases")
        return await p.get_subscription_by_product(user_id, product_id)

    async def subscriptions_list(
        self, user_id: str, limit: int = 100, cursor: str = ""
    ) -> dict:
        p = self._component("purchases")
        return await p.list_subscriptions(user_id, limit, cursor)

    # ------------------------------------------------------------- streams

    def _stream(self, stream: dict) -> Stream:
        return Stream(
            mode=StreamMode(int(stream.get("mode", 0))),
            subject=stream.get("subject", ""),
            subcontext=stream.get("subcontext", ""),
            label=stream.get("label", ""),
        )

    def stream_user_list(self, stream: dict) -> list[dict]:
        tracker = self._component("tracker")
        return [
            p.as_dict() for p in tracker.list_by_stream(self._stream(stream))
        ]

    def stream_user_join(
        self, stream: dict, user_id: str, session_id: str,
        hidden: bool = False, persistence: bool = True,
    ) -> bool:
        sm = self._component("stream_manager")
        success, _ = sm.user_join(
            self._stream(stream), user_id, session_id, hidden, persistence
        )
        return success

    def stream_user_leave(
        self, stream: dict, user_id: str, session_id: str
    ) -> None:
        sm = self._component("stream_manager")
        sm.user_leave(self._stream(stream), user_id, session_id)

    def stream_send(self, stream: dict, data: str, reliable: bool = True):
        router = self._component("router")
        s = self._stream(stream)
        router.send_to_stream(
            s,
            {
                "stream_data": {
                    "stream": {
                        "mode": int(s.mode),
                        "subject": s.subject,
                        "subcontext": s.subcontext,
                        "label": s.label,
                    },
                    "data": data,
                    "reliable": reliable,
                }
            },
        )

    def stream_count(self, stream: dict) -> int:
        tracker = self._component("tracker")
        return len(tracker.list_by_stream(self._stream(stream)))

    def stream_user_get(
        self, stream: dict, user_id: str, session_id: str
    ) -> dict | None:
        """Presence meta for one user on a stream (reference
        StreamUserGet)."""
        tracker = self._component("tracker")
        p = tracker.get_by_stream_user(self._stream(stream), session_id)
        if p is None or p.user_id != user_id:
            return None
        return p.as_dict()

    def stream_user_update(
        self, stream: dict, user_id: str, session_id: str,
        hidden: bool = False, persistence: bool = True, status: str = "",
    ) -> bool:
        sm = self._component("stream_manager")
        return sm.user_update(
            self._stream(stream), user_id, session_id, hidden, persistence,
            status,
        )

    def stream_user_kick(
        self, stream: dict, user_id: str, session_id: str
    ) -> None:
        """Force one presence off a stream (reference StreamUserKick —
        identical effect to a server-side leave)."""
        sm = self._component("stream_manager")
        sm.user_leave(self._stream(stream), user_id, session_id)

    def stream_close(self, stream: dict) -> None:
        """Untrack every presence on the stream (reference StreamClose)."""
        tracker = self._component("tracker")
        s = self._stream(stream)
        for p in list(tracker.list_by_stream(s)):
            tracker.untrack(p.id.session_id, s)

    def stream_send_raw(self, stream: dict, envelope: dict) -> None:
        """Deliver a raw rtapi envelope dict to a stream (reference
        StreamSendRaw — the caller owns the envelope shape)."""
        router = self._component("router")
        router.send_to_stream(self._stream(stream), envelope)

    # ------------------------------------------------------------- matches

    def match_create(self, module: str, params: dict | None = None) -> str:
        registry = self._component("match_registry")
        return registry.create_match(module, params or {})

    def match_get(self, match_id: str) -> dict | None:
        registry = self._component("match_registry")
        handler = registry.get(match_id)
        if handler is None:
            return None
        return {
            "match_id": handler.match_id,
            "authoritative": True,
            "label": handler.label,
            "size": len(handler.presences.list()),
            "tick_rate": handler.tick_rate,
        }

    def match_list(
        self, limit: int = 10, label: str | None = None,
        min_size: int | None = None, max_size: int | None = None,
        query: str | None = None,
    ) -> list[dict]:
        registry = self._component("match_registry")
        return registry.list_matches(
            limit,
            label=label,
            min_size=min_size,
            max_size=max_size,
            query=query,
        )

    async def match_signal(self, match_id: str, data: str) -> str:
        registry = self._component("match_registry")
        return await registry.signal(match_id, data)

    # ------------------------------------------------- leaderboards et al.

    async def leaderboard_create(self, id: str, **kwargs) -> dict:
        lb = self._component("leaderboards")
        return await lb.create(id, **kwargs)

    async def leaderboard_delete(self, id: str) -> None:
        lb = self._component("leaderboards")
        await lb.delete(id)

    async def leaderboard_record_write(
        self, id: str, owner_id: str, username: str = "", score: int = 0,
        subscore: int = 0, metadata: dict | None = None,
        override: str | None = None,
    ) -> dict:
        lb = self._component("leaderboards")
        return await lb.record_write(
            id, owner_id, username, score, subscore, metadata, override
        )

    async def leaderboard_records_list(self, id: str, **kwargs):
        lb = self._component("leaderboards")
        return await lb.records_list(id, **kwargs)

    def leaderboard_list(
        self, categories: list[int] | None = None
    ) -> list[dict]:
        lb = self._component("leaderboards")
        return [
            b.as_dict() for b in lb.list(categories=categories)
            if not b.is_tournament
        ]

    def leaderboards_get_id(self, ids: list[str]) -> list[dict]:
        lb = self._component("leaderboards")
        out = []
        for i in ids:
            b = lb.get(i)
            if b is not None and not b.is_tournament:
                out.append(b.as_dict())
        return out

    async def leaderboard_records_haystack(
        self, id: str, owner_id: str, limit: int = 100, **kwargs
    ) -> dict:
        lb = self._component("leaderboards")
        return await lb.records_haystack(id, owner_id, limit=limit, **kwargs)

    async def leaderboard_record_delete(self, id: str, owner_id: str):
        lb = self._component("leaderboards")
        await lb.record_delete(id, owner_id)

    async def tournament_create(self, id: str, **kwargs) -> dict:
        t = self._component("tournaments")
        return await t.create(id, **kwargs)

    async def tournament_delete(self, id: str) -> None:
        t = self._component("tournaments")
        await t.delete(id)

    async def tournament_join(
        self, id: str, user_id: str, username: str = ""
    ) -> None:
        t = self._component("tournaments")
        await t.join(id, user_id, username)

    async def tournament_record_write(
        self, id: str, owner_id: str, username: str = "", score: int = 0,
        subscore: int = 0, metadata: dict | None = None,
    ) -> dict:
        t = self._component("tournaments")
        return await t.record_write(
            id, owner_id, username, score, subscore, metadata
        )

    def tournament_list(
        self, categories: list[int] | None = None, active_only: bool = False
    ) -> list[dict]:
        t = self._component("tournaments")
        return t.list(categories=categories, active_only=active_only)

    def tournaments_get_id(self, ids: list[str]) -> list[dict]:
        t = self._component("tournaments")
        wanted = set(ids)
        return [d for d in t.list() if d["id"] in wanted]

    async def tournament_records_list(self, id: str, **kwargs) -> dict:
        t = self._component("tournaments")
        return await t.records_list(id, **kwargs)

    async def tournament_records_haystack(
        self, id: str, owner_id: str, limit: int = 100, **kwargs
    ) -> dict:
        t = self._component("tournaments")
        return await t.records_haystack(id, owner_id, limit=limit, **kwargs)

    async def tournament_record_delete(self, id: str, owner_id: str):
        t = self._component("tournaments")
        await t.record_delete(id, owner_id, caller_authoritative=True)

    async def tournament_add_attempt(
        self, id: str, owner_id: str, count: int
    ):
        t = self._component("tournaments")
        await t.add_attempt(id, owner_id, count)

    # ------------------------------------------------------ friends/groups

    async def friends_list(self, user_id: str, **kwargs):
        f = self._component("friends")
        return await f.list(user_id, **kwargs)

    async def friends_add(
        self, user_id: str, username: str, ids: list[str]
    ) -> None:
        f = self._component("friends")
        for target in ids:
            await f.add(user_id, username, target)

    async def friends_delete(self, user_id: str, ids: list[str]) -> None:
        f = self._component("friends")
        for target in ids:
            await f.delete(user_id, target)

    async def friends_block(
        self, user_id: str, username: str, ids: list[str]
    ) -> None:
        f = self._component("friends")
        for target in ids:
            await f.block(user_id, username, target)

    async def group_create(self, user_id: str, name: str, **kwargs) -> dict:
        g = self._component("groups")
        return await g.create(user_id, name, **kwargs)

    async def group_update(self, group_id: str, user_id: str, **kwargs):
        g = self._component("groups")
        await g.update(group_id, user_id, **kwargs)

    async def group_delete(self, group_id: str, user_id: str = "") -> None:
        g = self._component("groups")
        await g.delete(group_id, user_id)

    async def groups_get_id(self, group_ids: list[str]) -> list[dict]:
        g = self._component("groups")
        return await g.get_many(group_ids)

    async def group_users_list(self, group_id: str, **kwargs):
        g = self._component("groups")
        return await g.users_list(group_id, **kwargs)

    async def group_users_add(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        g = self._component("groups")
        await g.users_add(group_id, user_ids, caller_id)

    async def group_users_kick(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        g = self._component("groups")
        await g.users_kick(group_id, user_ids, caller_id)

    async def group_users_ban(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        g = self._component("groups")
        await g.users_ban(group_id, user_ids, caller_id)

    async def group_users_promote(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        g = self._component("groups")
        await g.users_promote(group_id, user_ids, caller_id)

    async def group_users_demote(
        self, group_id: str, user_ids: list[str], caller_id: str = ""
    ):
        g = self._component("groups")
        await g.users_demote(group_id, user_ids, caller_id)

    async def group_user_join(
        self, group_id: str, user_id: str, username: str = ""
    ):
        g = self._component("groups")
        await g.join(group_id, user_id, username)

    async def group_user_leave(
        self, group_id: str, user_id: str, username: str = ""
    ):
        g = self._component("groups")
        await g.leave(group_id, user_id)

    async def groups_list(
        self, name: str = "", lang_tag: str = "", open: bool | None = None,
        limit: int = 100, cursor: str = "",
    ) -> dict:
        g = self._component("groups")
        return await g.list(
            name=name or None, limit=limit, cursor=cursor, open=open,
            lang_tag=lang_tag or None,
        )

    async def groups_get_random(self, count: int) -> list[dict]:
        g = self._component("groups")
        return await g.get_random(count)

    async def user_groups_list(self, user_id: str, **kwargs):
        g = self._component("groups")
        return await g.user_groups_list(user_id, **kwargs)

    # ------------------------------------------------------------ channels

    async def channel_message_send(
        self, channel_id: str, content: dict, sender_id: str = "",
        sender_username: str = "", persist: bool = True,
    ) -> dict:
        ch = self._component("channels")
        return await ch.message_send(
            channel_id, content, sender_id, sender_username, persist
        )

    def channel_id_build(
        self, sender_id: str, target: str, chan_type: int
    ) -> str:
        ch = self._component("channels")
        return ch.channel_id_build(sender_id, target, chan_type)

    async def channel_messages_list(
        self, channel_id: str, limit: int = 100, forward: bool = True,
        cursor: str = "",
    ) -> dict:
        ch = self._component("channels")
        return await ch.messages_list(
            channel_id, limit=limit, forward=forward, cursor=cursor
        )

    async def channel_message_update(
        self, channel_id: str, message_id: str, content: dict,
        sender_id: str = "", sender_username: str = "",
    ) -> dict:
        ch = self._component("channels")
        return await ch.message_update(
            channel_id, message_id, content, sender_id, sender_username
        )

    async def channel_message_remove(
        self, channel_id: str, message_id: str, sender_id: str = "",
        sender_username: str = "",
    ) -> dict:
        ch = self._component("channels")
        return await ch.message_remove(
            channel_id, message_id, sender_id, sender_username,
            authoritative=True,
        )

    # -------------------------------------------------------------- events

    def event(self, name: str, properties: dict | None = None) -> None:
        """Queue a custom event to registered event handlers (reference
        nk.Event → RuntimeEventCustomFunction)."""
        rt = self._component("runtime")
        rt.fire_event(
            rt.context(mode="event"),
            {
                "name": name,
                "properties": properties or {},
                "timestamp": int(time.time()),
            },
        )

    def set_event_fn(self, fn) -> None:
        """Register a custom-event handler after init (reference
        SetEventFn, runtime_go_nakama.go)."""
        rt = self._component("runtime")
        rt._event_fns.append(fn)

    def read_file(self, relative_path: str) -> str:
        """Read a file under the runtime module path — the module data
        directory, never the host filesystem (reference ReadFile,
        runtime_go_nakama.go: rooted at the runtime path)."""
        import os

        path = getattr(self.config.runtime, "path", "")
        if not path:
            # Without a configured module directory there is no sandbox
            # root; rooting at the process CWD would expose host files.
            raise RuntimeError("runtime.path not configured")
        root = os.path.abspath(path)
        full = os.path.abspath(os.path.join(root, relative_path))
        if full == root or not full.startswith(root + os.sep):
            raise ValueError("path escapes the runtime directory")
        with open(full, "r", encoding="utf-8") as f:
            return f.read()

    # ------------------------------------------------------------- metrics

    def metrics_counter_add(self, name: str, tags: dict | None, delta: int):
        m = self._component("metrics")
        m.counter_add(name, delta, **(tags or {}))

    def metrics_gauge_set(self, name: str, tags: dict | None, value: float):
        m = self._component("metrics")
        m.gauge_set(name, value, **(tags or {}))

    def metrics_timer_record(
        self, name: str, tags: dict | None, value_ms: float
    ):
        m = self._component("metrics")
        m.timer_record(name, value_ms / 1000.0, **(tags or {}))

    # -------------------------------------------------------------- satori

    def get_satori(self):
        """The LiveOps client (reference nk.GetSatori,
        runtime_go_nakama.go); unconfigured clients raise on use so
        modules can feature-gate."""
        from ..social.satori import SatoriClient

        sc = getattr(self.config, "satori", None)
        if getattr(self, "_satori", None) is None:
            self._satori = SatoriClient(
                url=getattr(sc, "url", ""),
                api_key_name=getattr(sc, "api_key_name", ""),
                api_key=getattr(sc, "api_key", ""),
                signing_key=getattr(sc, "signing_key", ""),
            )
        return self._satori

    # ----------------------------------------------------------- utilities
    # (reference nk crypto/codec helpers, runtime_go_nakama.go)

    def uuid_v4(self) -> str:
        return str(uuid_mod.uuid4())

    def time_ms(self) -> int:
        return int(time.time() * 1000)

    def json_encode(self, value: Any) -> str:
        return json.dumps(value)

    def json_decode(self, value: str) -> Any:
        return json.loads(value)

    def base64_encode(self, data: bytes | str) -> str:
        if isinstance(data, str):
            data = data.encode()
        return base64.b64encode(data).decode()

    def base64_decode(self, data: str) -> bytes:
        return base64.b64decode(data)

    def sha256_hash(self, data: bytes | str) -> str:
        if isinstance(data, str):
            data = data.encode()
        return hashlib.sha256(data).hexdigest()

    def hmac_sha256_hash(self, data: bytes | str, key: bytes | str) -> str:
        if isinstance(data, str):
            data = data.encode()
        if isinstance(key, str):
            key = key.encode()
        return hmac_mod.new(key, data, hashlib.sha256).hexdigest()

"""Purchase + subscription persistence over the IAP validators.

Parity: reference server/core_purchase.go (validate→upsert keyed by
transaction id, seen-before detection, user association, cursored
listing) and core_subscription.go (subscription lifecycle rows keyed by
original transaction id with expiry tracking). The port's copy of the
JAX package's `core/purchase.py`, over the port's `iap/` and storage
engines.
"""

from __future__ import annotations

import json
import time

from ..iap import IAPError, ValidatedPurchase


class Purchases:
    def __init__(self, logger, db, config, fetch=None):
        self.logger = logger.with_fields(subsystem="purchase")
        self.db = db
        self.config = config
        self._fetch = fetch  # injectable for tests; None = real HTTPS

    # --------------------------------------------------------- validation

    async def validate_apple(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> list[dict]:
        from ..iap import validate_receipt_apple

        validated = await validate_receipt_apple(
            self.config.iap.apple_shared_password, receipt, self._fetch
        )
        return await self._store(user_id, validated, persist, receipt)

    async def validate_google(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> list[dict]:
        from ..iap import validate_receipt_google

        validated = await validate_receipt_google(
            self.config.iap.google_client_email,
            self.config.iap.google_private_key,
            receipt,
            self._fetch,
        )
        return await self._store(user_id, validated, persist, receipt)

    async def validate_huawei(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> list[dict]:
        from ..iap import validate_receipt_huawei

        validated = await validate_receipt_huawei(
            self.config.iap.huawei_client_id,
            self.config.iap.huawei_client_secret,
            receipt,
            self._fetch,
        )
        return await self._store(user_id, validated, persist, receipt)

    async def _store(
        self,
        user_id: str,
        validated: list[ValidatedPurchase],
        persist: bool,
        raw_receipt: str = "",
    ) -> list[dict]:
        now = time.time()
        seen: dict[str, bool] = {}
        owner_of: dict[str, str] = {}
        if persist:
            # One transaction for the whole receipt: a multi-item receipt
            # persists atomically, so a retried validation can't misreport
            # partially-committed items as seen_before (reference
            # StorePurchases batches in one tx).
            async with self.db.tx() as tx:
                for v in validated:
                    row = await tx.fetch_one(
                        "SELECT user_id FROM purchase"
                        " WHERE transaction_id = ?",
                        (v.transaction_id,),
                    )
                    seen[v.transaction_id] = row is not None
                    if row is not None:
                        # Replay detection must report the STORED owner —
                        # user B re-submitting user A's receipt sees A's
                        # association, not a phantom grant (reference
                        # returns the stored purchase row).
                        owner_of[v.transaction_id] = row["user_id"]
                    if row is None:
                        await tx.execute(
                            "INSERT INTO purchase (user_id, transaction_id,"
                            " product_id, store, raw_response,"
                            " purchase_time, create_time, update_time,"
                            " environment)"
                            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
                            (
                                user_id, v.transaction_id, v.product_id,
                                v.store, json.dumps(v.raw_response),
                                v.purchase_time, now, now, v.environment,
                            ),
                        )
                        if raw_receipt:
                            # Raw receipt retained for re-validation and
                            # refund audits (purchase_receipt table).
                            await tx.execute(
                                "INSERT OR IGNORE INTO purchase_receipt"
                                " (transaction_id, user_id, store,"
                                " receipt, create_time)"
                                " VALUES (?, ?, ?, ?, ?)",
                                (
                                    v.transaction_id, user_id, v.store,
                                    raw_receipt, now,
                                ),
                            )
        return [
            {
                "user_id": owner_of.get(v.transaction_id, user_id),
                "transaction_id": v.transaction_id,
                "product_id": v.product_id,
                "store": v.store,
                "purchase_time": v.purchase_time,
                "environment": v.environment,
                "seen_before": seen.get(v.transaction_id, False),
            }
            for v in validated
        ]

    # ------------------------------------------------------------ queries

    async def list(
        self, user_id: str | None = None, limit: int = 100, cursor: str = ""
    ) -> dict:
        limit = max(1, min(int(limit), 100))
        offset = int(cursor) if cursor else 0
        where, params = "", []
        if user_id:
            where = "WHERE user_id = ?"
            params.append(user_id)
        rows = await self.db.fetch_all(
            f"SELECT * FROM purchase {where}"
            " ORDER BY purchase_time DESC, transaction_id"
            " LIMIT ? OFFSET ?",
            (*params, limit + 1, offset),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        return {
            "validated_purchases": [
                {
                    "user_id": r["user_id"],
                    "transaction_id": r["transaction_id"],
                    "product_id": r["product_id"],
                    "store": r["store"],
                    "purchase_time": r["purchase_time"],
                    "refund_time": r["refund_time"],
                    "environment": r["environment"],
                }
                for r in rows
            ],
            "cursor": str(offset + limit) if has_more else "",
        }

    async def list_purchases(
        self, user_id: str = "", limit: int = 100, cursor: str = ""
    ) -> dict:
        """Validated-purchase listing, per user or store-wide (reference
        nk.PurchasesList runtime_go_nakama.go; console ListPurchases)."""
        limit = max(1, min(int(limit), 100))
        offset = int(cursor) if cursor else 0
        where, params = "", []
        if user_id:
            where = "WHERE user_id = ?"
            params.append(user_id)
        rows = await self.db.fetch_all(
            f"SELECT * FROM purchase {where}"
            " ORDER BY purchase_time DESC, transaction_id DESC"
            " LIMIT ? OFFSET ?",
            (*params, limit + 1, offset),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        return {
            "validated_purchases": [
                {
                    "user_id": r["user_id"],
                    "transaction_id": r["transaction_id"],
                    "product_id": r["product_id"],
                    "store": r["store"],
                    "purchase_time": r["purchase_time"],
                    "refund_time": r["refund_time"],
                    "environment": r["environment"],
                }
                for r in rows
            ],
            "cursor": str(offset + limit) if has_more else "",
        }

    async def get_subscription_by_product(
        self, user_id: str, product_id: str
    ) -> dict | None:
        """Reference nk.SubscriptionGetByProductId."""
        r = await self.db.fetch_one(
            "SELECT * FROM subscription WHERE user_id = ?"
            " AND product_id = ?",
            (user_id, product_id),
        )
        if r is None:
            return None
        import time as _time

        return {
            "user_id": r["user_id"],
            "original_transaction_id": r["original_transaction_id"],
            "product_id": r["product_id"],
            "store": r["store"],
            "purchase_time": r["purchase_time"],
            "expire_time": r["expire_time"],
            "active": r["expire_time"] > _time.time(),
            "environment": r["environment"],
        }

    async def get_by_transaction(self, transaction_id: str) -> dict | None:
        r = await self.db.fetch_one(
            "SELECT * FROM purchase WHERE transaction_id = ?",
            (transaction_id,),
        )
        if r is None:
            return None
        return {
            "user_id": r["user_id"],
            "transaction_id": r["transaction_id"],
            "product_id": r["product_id"],
            "store": r["store"],
            "purchase_time": r["purchase_time"],
            "refund_time": r["refund_time"],
            "environment": r["environment"],
        }

    # -------------------------------------------------------- subscriptions

    async def validate_subscription_apple(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> dict:
        """Client-facing subscription validation (reference
        apigrpc.proto:678 ValidateSubscriptionApple; iap.go:625)."""
        from ..iap import validate_subscription_apple

        v = await validate_subscription_apple(
            self.config.iap.apple_shared_password, receipt, self._fetch
        )
        return await self._store_subscription(user_id, v, persist)

    async def validate_subscription_google(
        self, user_id: str, receipt: str, persist: bool = True
    ) -> dict:
        """Reference apigrpc.proto:694 ValidateSubscriptionGoogle."""
        from ..iap import validate_subscription_google

        v = await validate_subscription_google(
            self.config.iap.google_client_email,
            self.config.iap.google_private_key,
            receipt,
            self._fetch,
        )
        return await self._store_subscription(user_id, v, persist)

    async def _store_subscription(self, user_id, v, persist: bool) -> dict:
        if persist:
            # Re-validating another user's receipt must fail loudly, not
            # half-update their row and return an inconsistent success
            # (the purchase path reports the stored owner; subscriptions
            # are owner-exclusive in the reference).
            existing = await self.get_subscription(
                v.original_transaction_id
            )
            if existing is not None and existing["user_id"] != user_id:
                from ..iap import IAPError

                raise IAPError(
                    "subscription belongs to another user", "invalid"
                )
            return await self.upsert_subscription(
                user_id,
                v.original_transaction_id,
                v.product_id,
                v.store,
                v.expire_time,
                environment=v.environment,
                raw_response=v.raw_response,
            )
        return {
            "user_id": user_id,
            "original_transaction_id": v.original_transaction_id,
            "product_id": v.product_id,
            "store": v.store,
            "purchase_time": v.purchase_time,
            "expire_time": v.expire_time,
            "active": v.expire_time > time.time(),
            "environment": v.environment,
        }

    async def upsert_subscription(
        self,
        user_id: str,
        original_transaction_id: str,
        product_id: str,
        store: int,
        expire_time: float,
        environment: int = 0,
        raw_response: dict | None = None,
    ) -> dict:
        now = time.time()
        await self.db.execute(
            "INSERT INTO subscription (user_id, original_transaction_id,"
            " product_id, store, raw_response, purchase_time, create_time,"
            " update_time, expire_time, environment)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)"
            " ON CONFLICT (original_transaction_id) DO UPDATE SET"
            " expire_time = ?, update_time = ?, raw_response = ?",
            (
                user_id, original_transaction_id, product_id, store,
                json.dumps(raw_response or {}), now, now, now, expire_time,
                environment,
                expire_time, now, json.dumps(raw_response or {}),
            ),
        )
        return await self.get_subscription(original_transaction_id)

    async def get_subscription(
        self, original_transaction_id: str
    ) -> dict | None:
        r = await self.db.fetch_one(
            "SELECT * FROM subscription WHERE original_transaction_id = ?",
            (original_transaction_id,),
        )
        if r is None:
            return None
        return {
            "user_id": r["user_id"],
            "original_transaction_id": r["original_transaction_id"],
            "product_id": r["product_id"],
            "store": r["store"],
            "purchase_time": r["purchase_time"],
            "expire_time": r["expire_time"],
            "active": r["expire_time"] > time.time(),
            "environment": r["environment"],
        }

    async def list_subscriptions(
        self, user_id: str = "", limit: int = 100, cursor: str = ""
    ) -> dict:
        """Per-user, or store-wide when user_id is empty (console
        ListSubscriptions, reference console.proto:330)."""
        limit = max(1, min(int(limit), 100))
        offset = int(cursor) if cursor else 0
        where, params = "", []
        if user_id:
            where = "WHERE user_id = ?"
            params.append(user_id)
        rows = await self.db.fetch_all(
            f"SELECT * FROM subscription {where}"
            " ORDER BY purchase_time DESC LIMIT ? OFFSET ?",
            (*params, limit + 1, offset),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        now = time.time()
        return {
            "subscriptions": [
                {
                    "user_id": r["user_id"],
                    "original_transaction_id": r["original_transaction_id"],
                    "product_id": r["product_id"],
                    "store": r["store"],
                    "purchase_time": r["purchase_time"],
                    "expire_time": r["expire_time"],
                    "active": r["expire_time"] > now,
                }
                for r in rows
            ],
            "cursor": str(offset + limit) if has_more else "",
        }

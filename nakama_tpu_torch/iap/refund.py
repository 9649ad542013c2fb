"""Google voided-purchase (refund) scheduler.

Parity: reference server/google_refund_scheduler.go:54 — periodically
polls Google's voidedpurchases list with the IAP service account, marks
matching purchase rows refunded, and invokes the runtime's purchase
notification hook so game logic can claw back entitlements. Polling is
inert unless Google IAP credentials are configured. The port's copy of
the JAX package's `iap/refund.py`.
"""

from __future__ import annotations

import asyncio
import json
import time


class GoogleRefundScheduler:
    def __init__(
        self,
        logger,
        db,
        config,
        runtime=None,
        fetch=None,
        poll_interval_sec: float = 15 * 60,
    ):
        self.logger = logger.with_fields(subsystem="iap.refund")
        self.db = db
        self.config = config
        self.runtime = runtime
        self.poll_interval_sec = poll_interval_sec
        if fetch is None:
            from ..utils.httpfetch import fetch as fetch_default

            fetch = fetch_default
        self._fetch = fetch
        self._task: asyncio.Task | None = None

    @property
    def configured(self) -> bool:
        iap = self.config.iap
        return bool(
            iap.google_client_email
            and iap.google_private_key
            and iap.google_package_name
        )

    def start(self):
        if self.configured and self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self):
        while True:
            try:
                await self.poll_once()
            except Exception as e:
                self.logger.error("refund poll failed", error=str(e))
            await asyncio.sleep(self.poll_interval_sec)

    async def poll_once(self) -> int:
        """One voided-purchases sweep (paginated); returns refunds applied
        (reference google_refund_scheduler.go loop body).

        Delivery is at-least-once: the hook runs BEFORE refund_time is
        committed, so a hook failure or mid-poll shutdown leaves the row
        unmarked and the next sweep retries — hooks must be idempotent,
        same as the reference's notification contract."""
        from .client import GOOGLE_PUBLISHER_URL, google_access_token

        iap = self.config.iap
        token = await google_access_token(
            iap.google_client_email, iap.google_private_key, self._fetch
        )
        base = (
            f"{GOOGLE_PUBLISHER_URL}/androidpublisher/v3/applications/"
            f"{iap.google_package_name}/purchases/voidedpurchases"
        )
        applied = 0
        page_token = ""
        while True:
            url = base + (f"?token={page_token}" if page_token else "")
            status, body = await self._fetch(
                url, headers={"Authorization": f"Bearer {token}"}
            )
            if status != 200:
                raise RuntimeError(f"voidedpurchases failed: HTTP {status}")
            data = json.loads(body)
            for v in data.get("voidedPurchases", []):
                applied += await self._apply(v)
            page_token = (
                (data.get("tokenPagination") or {}).get("nextPageToken", "")
            )
            if not page_token:
                break
        if applied:
            self.logger.info("google refunds applied", count=applied)
        return applied

    async def _apply(self, voided: dict) -> int:
        order_id = voided.get("orderId", "")
        if not order_id:
            return 0
        row = await self.db.fetch_one(
            "SELECT refund_time FROM purchase WHERE transaction_id = ?",
            (order_id,),
        )
        if row is None or row["refund_time"]:
            return 0
        if self.runtime is not None:
            hook = self.runtime.purchase_notification("google")
            if hook is not None:
                # Raises propagate: the row stays unmarked and the next
                # sweep retries the clawback.
                result = hook(
                    self.runtime.context(mode="refund"),
                    {"transaction_id": order_id, "refund": voided},
                )
                if asyncio.iscoroutine(result):
                    await result
        now = time.time()
        return await self.db.execute(
            "UPDATE purchase SET refund_time = ?, update_time = ?"
            " WHERE transaction_id = ? AND refund_time = 0",
            (now, now, order_id),
        )

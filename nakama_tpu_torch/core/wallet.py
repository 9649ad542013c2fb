"""Per-user wallets: atomic multi-user updates with a changeset ledger,
and the cross-entity MultiUpdate.

The port's copy of the JAX package's `core/wallet.py`, over the port's
storage engine (whose writes always group-commit).

Parity: reference server/core_wallet.go:52 `UpdateWallets` — every
changeset applies int64 deltas to the user's JSONB wallet in ONE
transaction across all target users; any resulting negative balance
aborts the whole batch; each applied change appends a `wallet_ledger`
row carrying the changeset + metadata. `core_multi.go` MultiUpdate runs
wallet updates, storage writes, and account updates in a single
transaction.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid

from ..storage.db import OCC_RETRIES, WriteConflictError


class WalletError(Exception):
    def __init__(self, message: str, code: str = "invalid"):
        super().__init__(message)
        self.code = code


class WalletLedgerMismatch(WalletError):
    pass


def _apply_changeset(wallet: dict, changeset: dict) -> dict:
    out = dict(wallet)
    for key, delta in changeset.items():
        if not isinstance(delta, int) or isinstance(delta, bool):
            raise WalletError(
                f"wallet changeset values must be integers: {key}"
            )
        current = out.get(key, 0)
        if not isinstance(current, int) or isinstance(current, bool):
            raise WalletError(
                f"wallet value is not an integer: {key}"
            )
        value = current + delta
        if value < 0:
            # Negative balances abort the whole batch (reference
            # ErrWalletLedgerInvalidCursor... ErrWalletInsufficientFunds).
            raise WalletError(
                f"insufficient funds for {key}", "insufficient_funds"
            )
        out[key] = value
    return out


class Wallets:
    def __init__(self, logger, db):
        self.logger = logger.with_fields(subsystem="wallet")
        self.db = db

    async def get(self, user_id: str) -> dict:
        row = await self.db.fetch_one(
            "SELECT wallet FROM users WHERE id = ?", (user_id,)
        )
        if row is None:
            raise WalletError("user not found", "not_found")
        return json.loads(row["wallet"] or "{}")

    async def update_wallets(
        self, updates: list[dict], update_ledger: bool = True
    ) -> list[dict]:
        """updates: [{user_id, changeset, metadata}]; all-or-nothing
        (reference UpdateWallets core_wallet.go:52).

        Hot path: optimistic read + ONE guarded write unit through the
        group-commit pipeline (storage/db.py submit_write) — concurrent
        wallet updates share a WAL commit instead of serializing on the
        exclusive writer lock. Each user's UPDATE is guarded on the
        exact wallet value read, so a concurrent change rolls the whole
        unit back (all-or-nothing preserved) and the update retries;
        after OCC_RETRIES conflicts the exclusive-transaction path takes
        over."""
        ids = [u["user_id"] for u in updates]
        if len(set(ids)) == len(ids):
            # A duplicate user in ONE call would deterministically trip
            # its own guard (the first UPDATE invalidates the second's
            # read) — such calls go straight to the tx path, which
            # re-reads between statements.
            for _ in range(OCC_RETRIES):
                try:
                    return await self._update_batched(
                        updates, update_ledger
                    )
                except WriteConflictError:
                    continue
        async with self.db.tx() as tx:
            return await self._update_in_tx(tx, updates, update_ledger)

    def _plan_update(
        self,
        u: dict,
        raw: str,
        now: float,
        update_ledger: bool,
        guard_wallet: bool,
    ) -> tuple[list[tuple], list[bool], dict]:
        """Plan one user's update from the wallet text read for it:
        returns ``(statements, guards, result)``. ONE body for both
        write paths so their semantics cannot diverge — the batched OCC
        path plans with ``guard_wallet=True`` (UPDATE conditioned AND
        guarded on the exact wallet text read, so a concurrent writer
        rolls the unit back for retry), the tx path with ``False`` (the
        open transaction already serializes)."""
        user_id = u["user_id"]
        changeset = u.get("changeset") or {}
        previous = json.loads(raw)
        updated = _apply_changeset(previous, changeset)
        stmts: list[tuple] = []
        guards: list[bool] = []
        if guard_wallet:
            stmts.append(
                (
                    "UPDATE users SET wallet = ?, update_time = ?"
                    " WHERE id = ? AND wallet = ?",
                    (json.dumps(updated), now, user_id, raw),
                )
            )
        else:
            stmts.append(
                (
                    "UPDATE users SET wallet = ?, update_time = ?"
                    " WHERE id = ?",
                    (json.dumps(updated), now, user_id),
                )
            )
        guards.append(guard_wallet)
        ledger_id = ""
        if update_ledger and changeset:
            ledger_id = str(uuid.uuid4())
            stmts.append(
                (
                    "INSERT INTO wallet_ledger (id, user_id, changeset,"
                    " metadata, create_time, update_time)"
                    " VALUES (?, ?, ?, ?, ?, ?)",
                    (
                        ledger_id,
                        user_id,
                        json.dumps(changeset),
                        json.dumps(u.get("metadata") or {}),
                        now,
                        now,
                    ),
                )
            )
            guards.append(False)
        result = {
            "user_id": user_id,
            "previous": previous,
            "updated": updated,
            "ledger_id": ledger_id,
        }
        return stmts, guards, result

    async def _update_batched(
        self, updates: list[dict], update_ledger: bool
    ) -> list[dict]:
        now = time.time()
        stmts: list[tuple] = []
        guards: list[bool] = []
        results = []
        # Concurrent reads: the coalescer collapses them into shared
        # reader-pool hops instead of one serial round trip per user.
        rows = await asyncio.gather(*(
            self.db.fetch_one(
                "SELECT wallet FROM users WHERE id = ?", (u["user_id"],)
            )
            for u in updates
        ))
        for u, row in zip(updates, rows):
            if row is None:
                raise WalletError("user not found", "not_found")
            s, g, result = self._plan_update(
                u, row["wallet"] or "{}", now, update_ledger,
                guard_wallet=True,
            )
            stmts += s
            guards += g
            results.append(result)
        if stmts:
            await self.db.submit_write(stmts, guards)
        return results

    async def _update_in_tx(
        self, tx, updates: list[dict], update_ledger: bool
    ) -> list[dict]:
        now = time.time()
        results = []
        for u in updates:
            row = await tx.fetch_one(
                "SELECT wallet FROM users WHERE id = ?", (u["user_id"],)
            )
            if row is None:
                raise WalletError("user not found", "not_found")
            s, _, result = self._plan_update(
                u, row["wallet"] or "{}", now, update_ledger,
                guard_wallet=False,
            )
            for sql, params in s:
                await tx.execute(sql, params)
            results.append(result)
        return results

    async def ledger_update(self, ledger_id: str, metadata: dict) -> dict:
        """Replace a ledger item's metadata (reference
        WalletLedgerUpdate, core_wallet.go)."""
        row = await self.db.fetch_one(
            "SELECT * FROM wallet_ledger WHERE id = ?", (ledger_id,)
        )
        if row is None:
            raise WalletError("ledger item not found", "not_found")
        now = time.time()
        await self.db.execute(
            "UPDATE wallet_ledger SET metadata = ?, update_time = ?"
            " WHERE id = ?",
            (json.dumps(metadata), now, ledger_id),
        )
        return {
            "id": row["id"],
            "user_id": row["user_id"],
            "changeset": json.loads(row["changeset"]),
            "metadata": metadata,
            "create_time": row["create_time"],
            "update_time": now,
        }

    async def list_ledger(
        self, user_id: str, limit: int = 100, cursor: str = ""
    ) -> tuple[list[dict], str]:
        limit = max(1, min(int(limit), 100))
        params: list = [user_id]
        where = "WHERE user_id = ?"
        if cursor:
            try:
                c_time, c_id = cursor.split("|", 1)
                c_time = float(c_time)
            except ValueError:
                raise WalletError("invalid cursor")
            where += " AND (create_time < ? OR (create_time = ? AND id < ?))"
            params.extend([c_time, c_time, c_id])
        rows = await self.db.fetch_all(
            f"SELECT * FROM wallet_ledger {where}"
            " ORDER BY create_time DESC, id DESC LIMIT ?",
            (*params, limit + 1),
        )
        has_more = len(rows) > limit
        rows = rows[:limit]
        items = [
            {
                "id": r["id"],
                "user_id": r["user_id"],
                "changeset": json.loads(r["changeset"]),
                "metadata": json.loads(r["metadata"] or "{}"),
                "create_time": r["create_time"],
            }
            for r in rows
        ]
        next_cursor = (
            f"{rows[-1]['create_time']}|{rows[-1]['id']}"
            if has_more and rows
            else ""
        )
        return items, next_cursor


async def multi_update(
    db,
    wallets: "Wallets",
    *,
    wallet_updates: list[dict] | None = None,
    storage_writes: list | None = None,
    account_updates: list[dict] | None = None,
    update_ledger: bool = True,
) -> dict:
    """Cross-entity transactional update (reference MultiUpdate,
    core_multi.go:72): wallets + storage + accounts commit or roll back
    together."""
    from . import storage as core_storage

    async with db.tx() as tx:
        wallet_results = []
        if wallet_updates:
            wallet_results = await wallets._update_in_tx(
                tx, wallet_updates, update_ledger
            )
        acks = []
        if storage_writes:
            acks = await core_storage.storage_write_objects_in_tx(
                tx, None, storage_writes
            )
        if account_updates:
            # Fixed field whitelist (reference MultiUpdate restricts
            # account updates to the account-update set) — update dicts
            # may carry client-derived keys, never interpolate them.
            allowed = (
                "username", "display_name", "timezone", "location",
                "lang_tag", "avatar_url", "metadata",
            )
            for au in account_updates:
                fields = {
                    k: (json.dumps(v) if k == "metadata" else v)
                    for k, v in au.items()
                    if k in allowed and v is not None
                }
                if not fields:
                    continue
                sets = ", ".join(f"{k} = ?" for k in fields)
                await tx.execute(
                    f"UPDATE users SET {sets}, update_time = ?"
                    " WHERE id = ?",
                    (*fields.values(), time.time(), au["user_id"]),
                )
        return {
            "wallets": wallet_results,
            "storage_acks": [
                {
                    "collection": a.collection,
                    "key": a.key,
                    "user_id": a.user_id,
                    "version": a.version,
                }
                for a in acks
            ],
        }

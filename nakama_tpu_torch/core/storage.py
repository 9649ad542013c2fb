"""Object storage core with per-object optimistic concurrency.

The port's copy of the JAX package's `core/storage.py` over the port's
storage engine (`storage/db.py`, whose writes always group-commit). It
re-implements the reference's collection/key/user object store (reference
server/core_storage.go:395-697):

- version = md5 hex of the value (core_storage.go: version computed from
  contents), so identical writes are idempotent;
- conditional semantics on write (core_storage.go:582-614):
  ``version == ""``  → unconditional upsert,
  ``version == "*"`` → insert only-if-absent,
  ``version == "<hash>"`` → update only-if-current-version-matches;
- permission model (read 0=no/1=owner/2=public, write 0=no/1=owner);
- batch writes are transactional: any rejected op rolls back the batch
  (core_storage.go:467 StorageWriteObjects);
- listing with base64 cursors over (collection, read filter, key order).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import time
from dataclasses import dataclass

from ..storage.db import (
    OCC_RETRIES,
    Database,
    UniqueViolationError,
    WriteConflictError,
)


class StorageError(Exception):
    pass


class StorageVersionError(StorageError):
    """OCC rejection — version check failed (reference maps this onto
    codes.InvalidArgument 'version check failed')."""


class StoragePermissionError(StorageError):
    pass


@dataclass
class StorageOpWrite:
    collection: str
    key: str
    user_id: str  # "" = system-owned object
    value: str  # JSON string
    version: str = ""  # "", "*", or expected version hash
    permission_read: int = 1
    permission_write: int = 1


@dataclass
class StorageObject:
    collection: str
    key: str
    user_id: str
    value: str
    version: str
    permission_read: int
    permission_write: int
    create_time: float = 0.0
    update_time: float = 0.0

    def as_dict(self) -> dict:
        return {
            "collection": self.collection,
            "key": self.key,
            "user_id": self.user_id,
            "value": self.value,
            "version": self.version,
            "permission_read": self.permission_read,
            "permission_write": self.permission_write,
            "create_time": self.create_time,
            "update_time": self.update_time,
        }


@dataclass
class StorageAck:
    collection: str
    key: str
    user_id: str
    version: str


def _version_of(value: str) -> str:
    return hashlib.md5(value.encode()).hexdigest()


def _validate_value(value: str) -> None:
    try:
        decoded = json.loads(value)
    except (TypeError, ValueError) as e:
        raise StorageError("value must be valid JSON") from e
    if not isinstance(decoded, dict):
        raise StorageError("value must be a JSON object")


async def storage_write_objects(
    db: Database,
    caller_id: str | None,
    ops: list[StorageOpWrite],
) -> list[StorageAck]:
    """Batch transactional write (reference StorageWriteObjects
    core_storage.go:467). `caller_id=None` is the system/runtime caller and
    bypasses ownership + write-permission checks; a client caller may only
    write its own objects and only where permission_write allows.

    Hot path: optimistic reads + one guarded write unit through the
    group-commit pipeline (storage/db.py submit_write), so concurrent
    storage writes share a WAL commit. Version checks stay exact: each
    UPDATE is guarded on the version read, an INSERT race surfaces as a
    unique violation, and either conflict retries the whole batch from
    fresh reads (all-or-nothing is the unit's savepoint). Falls back to
    the exclusive transaction after OCC_RETRIES conflicts."""
    keys = [(op.collection, op.key, op.user_id) for op in ops]
    if len(set(keys)) == len(keys):
        # A duplicate (collection, key, user_id) in ONE call would
        # deterministically conflict with itself (the first write
        # invalidates the second's version read) — straight to the tx
        # path, which re-reads between statements.
        for _ in range(OCC_RETRIES):
            try:
                return await _write_objects_batched(db, caller_id, ops)
            except (WriteConflictError, UniqueViolationError):
                continue
    async with db.tx() as tx:
        return await storage_write_objects_in_tx(tx, caller_id, ops)


def _validate_write_op(op: StorageOpWrite, caller_id: str | None) -> None:
    """Row-independent checks (fields, value JSON, permission values,
    ownership) — the batched path runs them BEFORE paying for any read,
    so invalid calls fail deterministically and cheaply."""
    if not op.collection or not op.key:
        raise StorageError("collection and key are required")
    _validate_value(op.value)
    if op.permission_read not in (0, 1, 2) or op.permission_write not in (0, 1):
        raise StorageError("invalid permission values")
    if caller_id is not None and op.user_id and op.user_id != caller_id:
        raise StoragePermissionError(
            "cannot write objects owned by another user"
        )
    if caller_id is not None and not op.user_id:
        raise StoragePermissionError(
            "cannot write system-owned objects"
        )


def _plan_write_op(
    op: StorageOpWrite,
    caller_id: str | None,
    row: dict | None,
    now: float,
    guard_version: bool,
) -> tuple[str, tuple, bool, StorageAck]:
    """Validate one write op against the row read for it and return
    ``(sql, params, guarded, ack)``. ONE body for both write paths so
    their permission/version semantics cannot diverge — the batched OCC
    path plans with ``guard_version=True`` (UPDATE conditioned AND
    guarded on the version read, so a concurrent writer rolls the unit
    back for retry; an INSERT race trips the primary key instead), the
    tx path with ``False`` (the open transaction already serializes)."""
    _validate_write_op(op, caller_id)
    new_version = _version_of(op.value)
    ack = StorageAck(op.collection, op.key, op.user_id, new_version)
    if row is None:
        # Insert path: fails OCC if a specific version was expected.
        if op.version and op.version != "*":
            raise StorageVersionError("version check failed")
        return (
            "INSERT INTO storage (collection, key, user_id, value,"
            " version, read, write, create_time, update_time)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                op.collection,
                op.key,
                op.user_id,
                op.value,
                new_version,
                op.permission_read,
                op.permission_write,
                now,
                now,
            ),
            False,
            ack,
        )
    if caller_id is not None and row["write"] != 1:
        raise StoragePermissionError("write permission denied")
    if op.version == "*":
        # If-not-exists write over an existing object.
        raise StorageVersionError("version check failed")
    if op.version and op.version != row["version"]:
        raise StorageVersionError("version check failed")
    sql = (
        "UPDATE storage SET value = ?, version = ?, read = ?,"
        " write = ?, update_time = ?"
        " WHERE collection = ? AND key = ? AND user_id = ?"
    )
    params = (
        op.value,
        new_version,
        op.permission_read,
        op.permission_write,
        now,
        op.collection,
        op.key,
        op.user_id,
    )
    if guard_version:
        sql += " AND version = ?"
        params += (row["version"],)
        if caller_id is not None:
            # Re-assert the validated write permission at commit time:
            # version is md5(value), so a concurrent permission-only
            # change leaves it unchanged and the version guard alone
            # cannot see the revocation (the tx path serializes the
            # check under the writer lock instead).
            sql += " AND write = 1"
    return sql, params, guard_version, ack


async def _write_objects_batched(
    db: Database,
    caller_id: str | None,
    ops: list[StorageOpWrite],
) -> list[StorageAck]:
    acks: list[StorageAck] = []
    stmts: list[tuple] = []
    guards: list[bool] = []
    now = time.time()
    # Cheap validation first: an invalid op fails before any read.
    for op in ops:
        _validate_write_op(op, caller_id)
    # Concurrent reads: the coalescer collapses them into shared
    # reader-pool hops instead of one serial round trip per op.
    rows = await asyncio.gather(*(
        db.fetch_one(
            "SELECT version, write FROM storage"
            " WHERE collection = ? AND key = ? AND user_id = ?",
            (op.collection, op.key, op.user_id),
        )
        for op in ops
    ))
    for op, row in zip(ops, rows):
        sql, params, guarded, ack = _plan_write_op(
            op, caller_id, row, now, guard_version=True
        )
        stmts.append((sql, params))
        guards.append(guarded)
        acks.append(ack)
    if stmts:
        await db.submit_write(stmts, guards)
    return acks


async def storage_write_objects_in_tx(
    tx,
    caller_id: str | None,
    ops: list[StorageOpWrite],
) -> list[StorageAck]:
    """Write body on an already-open transaction — the composition seam
    for MultiUpdate (reference core_multi.go runs storage writes inside
    the shared tx)."""
    acks: list[StorageAck] = []
    now = time.time()
    for op in ops:
        row = await tx.fetch_one(
            "SELECT version, write FROM storage"
            " WHERE collection = ? AND key = ? AND user_id = ?",
            (op.collection, op.key, op.user_id),
        )
        sql, params, _, ack = _plan_write_op(
            op, caller_id, row, now, guard_version=False
        )
        await tx.execute(sql, params)
        acks.append(ack)
    return acks


@dataclass
class StorageOpDelete:
    collection: str
    key: str
    user_id: str
    version: str = ""  # optional OCC condition


async def storage_delete_objects(
    db: Database,
    caller_id: str | None,
    ops: list[StorageOpDelete],
) -> None:
    """Batch transactional delete (reference StorageDeleteObjects
    core_storage.go:616-697). Deleting a missing object is a no-op unless a
    version condition was given."""
    async with db.tx() as tx:
        for op in ops:
            if caller_id is not None and op.user_id != caller_id:
                raise StoragePermissionError(
                    "cannot delete objects owned by another user"
                )
            row = await tx.fetch_one(
                "SELECT version, write FROM storage"
                " WHERE collection = ? AND key = ? AND user_id = ?",
                (op.collection, op.key, op.user_id),
            )
            if row is None:
                if op.version:
                    raise StorageVersionError("version check failed")
                continue
            if caller_id is not None and row["write"] != 1:
                raise StoragePermissionError("delete permission denied")
            if op.version and op.version != row["version"]:
                raise StorageVersionError("version check failed")
            await tx.execute(
                "DELETE FROM storage"
                " WHERE collection = ? AND key = ? AND user_id = ?",
                (op.collection, op.key, op.user_id),
            )


@dataclass
class StorageOpRead:
    collection: str
    key: str
    user_id: str = ""


async def storage_read_objects(
    db: Database,
    caller_id: str | None,
    ops: list[StorageOpRead],
) -> list[StorageObject]:
    """Batch read with permission filtering (reference StorageReadObjects
    core_storage.go:395): the system reads everything; an owner needs
    read >= 1; anyone else needs read == 2. Unreadable/missing objects are
    silently omitted, as the reference does."""
    out: list[StorageObject] = []
    for op in ops:
        row = await db.fetch_one(
            "SELECT * FROM storage"
            " WHERE collection = ? AND key = ? AND user_id = ?",
            (op.collection, op.key, op.user_id),
        )
        if row is None:
            continue
        if caller_id is not None:
            if row["user_id"] == caller_id:
                if row["read"] < 1:
                    continue
            elif row["read"] != 2:
                continue
        out.append(_row_to_object(row))
    return out


async def storage_list_objects(
    db: Database,
    caller_id: str | None,
    collection: str,
    user_id: str | None = None,
    limit: int = 100,
    cursor: str = "",
) -> tuple[list[StorageObject], str]:
    """Cursored listing (reference StorageListObjects core_storage.go).

    System caller lists everything in the collection (optionally one
    owner's); a client caller sees its own objects plus public-read ones.
    Returns (objects, next_cursor) where next_cursor == "" at the end.
    """
    limit = max(1, min(limit, 1000))
    after_key = ""
    after_user = ""
    if cursor:
        try:
            decoded = json.loads(base64.b64decode(cursor.encode()).decode())
            after_key = decoded["k"]
            after_user = decoded["u"]
        except Exception as e:
            raise StorageError("invalid cursor") from e

    clauses = ["collection = ?"]
    params: list = [collection]
    if user_id is not None:
        clauses.append("user_id = ?")
        params.append(user_id)
    if caller_id is not None:
        clauses.append("(user_id = ? OR read = 2)")
        params.append(caller_id)
        if caller_id != "":
            # Owner still needs read >= 1 on own objects.
            clauses.append("(user_id != ? OR read >= 1)")
            params.append(caller_id)
    if after_key:
        clauses.append("(key > ? OR (key = ? AND user_id > ?))")
        params.extend([after_key, after_key, after_user])
    rows = await db.fetch_all(
        f"SELECT * FROM storage WHERE {' AND '.join(clauses)}"
        " ORDER BY key, user_id LIMIT ?",
        (*params, limit + 1),
    )
    more = len(rows) > limit
    rows = rows[:limit]
    next_cursor = ""
    if more and rows:
        last = rows[-1]
        next_cursor = base64.b64encode(
            json.dumps({"k": last["key"], "u": last["user_id"]}).encode()
        ).decode()
    return [_row_to_object(r) for r in rows], next_cursor


def _row_to_object(row: dict) -> StorageObject:
    return StorageObject(
        collection=row["collection"],
        key=row["key"],
        user_id=row["user_id"],
        value=row["value"],
        version=row["version"],
        permission_read=row["read"],
        permission_write=row["write"],
        create_time=row["create_time"],
        update_time=row["update_time"],
    )

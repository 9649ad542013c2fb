"""PostgreSQL engine behind the db seam (second database engine).

The reference's durable state is a shared Postgres/CockroachDB service
(reference server/db.go:35, pgx driver). The port's copy of the JAX
package's `storage/pg.py`: no third-party driver, the client speaks the
PostgreSQL frontend/backend protocol v3 directly over asyncio (standard
library only): startup, cleartext/md5/SCRAM-SHA-256 auth, simple query
for DDL, extended query (Parse/Bind/Execute/Sync) for parameterized
statements in text format. Given the same SCRAM nonce (`os.urandom`),
it sends the JAX client's octets.

`PostgresDatabase` exposes the `Database` interface of the port's
SQLite engine (connect/close/execute/fetch_one/fetch_all/tx()/migrate +
the same UniqueViolationError mapping, pg code 23505 — reference
server/db_error.go), so every core runs unchanged, and it writes
through the same group-commit pipeline (`WriteBatcher`). The port's
config has no switch for the per-commit path: every write takes the
group path. The SQL dialect shim translates the codebase's
SQLite-flavoured statements:

- ``?`` placeholders -> ``$1..$n`` (quote-aware),
- ``INSERT OR IGNORE`` -> ``INSERT ... ON CONFLICT DO NOTHING``,
- ``INSERT OR REPLACE INTO t (a, b, ...)`` -> upsert on the first
  column with ``EXCLUDED`` assignments,
- DDL types ``BLOB`` -> ``BYTEA``, ``REAL`` -> ``DOUBLE PRECISION``.

Selected by DSN: `make_database()` (storage/__init__) routes
``postgres://`` / ``postgresql://`` addresses here.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import os
import random
import re
import struct
import time
from base64 import b64decode, b64encode
from typing import Any, Iterable
from urllib.parse import unquote, urlparse

from .. import faults
from ..faults import CircuitBreaker, jittered_backoff
from .db import (
    DB_DRAIN_RESTART_MAX,
    DatabaseError,
    GroupCommitObservability,
    UniqueViolationError,
    WriteBatcher,
    WriteConflictError,
    _normalize_unit,
)
from .migrations import MIGRATIONS

# Pre-COMMIT connection-loss retry budget (jittered exponential backoff,
# faults.py jittered_backoff): attempts beyond this fail the batch to
# its callers with DatabaseError instead of reconnect-storming a dead
# server. The writer breaker counts BATCH OUTCOMES (not individual
# connection attempts — a batch that retried twice and committed is one
# success): after PG_BREAKER_THRESHOLD consecutive failed batches it
# opens and writes fail FAST until a cooldown probe reconnects — the
# same ladder the matchmaker device path runs.
PG_WRITE_RETRY_MAX = 3
PG_RETRY_BASE_S = 0.05
PG_RETRY_MAX_S = 1.0
PG_BREAKER_THRESHOLD = 3
PG_BREAKER_COOLDOWN_S = 1.0


def scram_client_final(
    password: str,
    first_bare: str,
    server_first: str,
    gs2_header: bytes = b"n,,",
) -> tuple[str, str]:
    """Pure SCRAM-SHA-256 client computation (RFC 5802/7677): given the
    client-first-bare, the server-first message, and the password,
    derive (client-final message, expected base64 server signature).
    Factored out so RFC 7677's published exchange vectors pin it in
    tests — real external ground truth for the auth math, independent
    of this repo's own wire fixture."""
    fields = dict(p.split("=", 1) for p in server_first.split(","))
    r, s, i = fields["r"], fields["s"], int(fields["i"])
    salted = hashlib.pbkdf2_hmac(
        "sha256", password.encode(), b64decode(s), i
    )
    client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
    stored_key = hashlib.sha256(client_key).digest()
    final_nosig = f"c={b64encode(gs2_header).decode()},r={r}"
    auth_msg = ",".join([first_bare, server_first, final_nosig])
    client_sig = hmac.new(
        stored_key, auth_msg.encode(), hashlib.sha256
    ).digest()
    proof = b64encode(
        bytes(a ^ b for a, b in zip(client_key, client_sig))
    ).decode()
    server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
    server_sig = b64encode(
        hmac.new(server_key, auth_msg.encode(), hashlib.sha256).digest()
    ).decode()
    return f"{final_nosig},p={proof}", server_sig


class _CommitAckLost(Exception):
    """The writer socket died while the group COMMIT was in flight: the
    server may or may not have committed, so the batch must fail to its
    callers rather than retry (double-apply risk)."""


class PgProtocolError(DatabaseError):
    pass


class PgServerError(DatabaseError):
    def __init__(self, fields: dict):
        self.code = fields.get("C", "")
        self.detail = fields
        super().__init__(
            f"{fields.get('S', 'ERROR')} {self.code}:"
            f" {fields.get('M', '')}"
        )


# ------------------------------------------------------------- wire codec


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


class PgWireConnection:
    """One protocol-v3 connection (asyncio streams, text format)."""

    def __init__(self, host, port, user, password, database):
        self.host, self.port = host, port
        self.user, self.password, self.database = user, password, database
        self._r: asyncio.StreamReader | None = None
        self._w: asyncio.StreamWriter | None = None
        self.parameters: dict[str, str] = {}
        self._stmt_seq = 0

    # ------------------------------------------------------------ connect

    async def connect(self):
        self._r, self._w = await asyncio.open_connection(
            self.host, self.port
        )
        params = (
            _cstr("user") + _cstr(self.user)
            + _cstr("database") + _cstr(self.database)
            + _cstr("client_encoding") + _cstr("UTF8")
            + b"\0"
        )
        payload = struct.pack("!I", 196608) + params  # protocol 3.0
        self._w.write(struct.pack("!I", len(payload) + 4) + payload)
        await self._w.drain()
        await self._auth()
        # Drain until ReadyForQuery.
        while True:
            tag, body = await self._recv()
            if tag == b"Z":
                return
            if tag == b"S":
                k, v = body.split(b"\0")[:2]
                self.parameters[k.decode()] = v.decode()
            elif tag == b"E":
                raise PgServerError(_error_fields(body))
            # K (BackendKeyData), N (notices) — ignored

    async def _auth(self):
        while True:
            tag, body = await self._recv()
            if tag == b"E":
                raise PgServerError(_error_fields(body))
            if tag != b"R":
                # ParameterStatus may arrive early on some servers.
                if tag == b"S":
                    continue
                raise PgProtocolError(f"unexpected auth message {tag!r}")
            (code,) = struct.unpack("!I", body[:4])
            if code == 0:  # AuthenticationOk
                return
            if code == 3:  # cleartext
                self._send(b"p", _cstr(self.password))
                await self._drain_w()
            elif code == 5:  # md5
                salt = body[4:8]
                inner = hashlib.md5(
                    (self.password + self.user).encode()
                ).hexdigest()
                digest = hashlib.md5(
                    inner.encode() + salt
                ).hexdigest()
                self._send(b"p", _cstr("md5" + digest))
                await self._drain_w()
            elif code == 10:  # SASL: SCRAM-SHA-256
                await self._scram(body[4:])
            elif code in (11, 12):
                raise PgProtocolError(
                    "unexpected SASL continuation outside handshake"
                )
            else:
                raise PgProtocolError(
                    f"unsupported auth method {code}"
                )

    async def _scram(self, mechanisms_blob: bytes):
        mechs = [
            m.decode()
            for m in mechanisms_blob.split(b"\0")
            if m
        ]
        if "SCRAM-SHA-256" not in mechs:
            raise PgProtocolError(f"no supported SASL mechanism: {mechs}")
        nonce = b64encode(os.urandom(18)).decode()
        first_bare = f"n={_scram_escape(self.user)},r={nonce}"
        client_first = "n,," + first_bare
        init = (
            _cstr("SCRAM-SHA-256")
            + struct.pack("!I", len(client_first))
            + client_first.encode()
        )
        self._send(b"p", init)
        await self._drain_w()

        tag, body = await self._recv()
        if tag == b"E":
            raise PgServerError(_error_fields(body))
        (code,) = struct.unpack("!I", body[:4])
        if code != 11:  # SASLContinue
            raise PgProtocolError("expected SASLContinue")
        server_first = body[4:].decode()
        fields = dict(p.split("=", 1) for p in server_first.split(","))
        if not fields.get("r", "").startswith(nonce):
            raise PgProtocolError("server nonce mismatch")
        client_final, expect = scram_client_final(
            self.password, first_bare, server_first
        )
        self._send(b"p", client_final.encode())
        await self._drain_w()

        tag, body = await self._recv()
        if tag == b"E":
            raise PgServerError(_error_fields(body))
        (code,) = struct.unpack("!I", body[:4])
        if code != 12:  # SASLFinal
            raise PgProtocolError("expected SASLFinal")
        server_final = body[4:].decode()
        got = dict(
            p.split("=", 1) for p in server_final.split(",")
        ).get("v", "")
        if not hmac.compare_digest(expect, got):
            raise PgProtocolError("server signature mismatch")

    # -------------------------------------------------------------- query

    async def query(
        self, sql: str, params: tuple = ()
    ) -> tuple[list[dict], int]:
        """Extended-protocol round trip. Returns (rows, rowcount)."""
        if not params:
            return await self._simple(sql)
        # Parse (unnamed statement) / Bind / Describe / Execute / Sync.
        self._send(b"P", _cstr("") + _cstr(sql) + struct.pack("!H", 0))
        bind = _cstr("") + _cstr("")  # portal, statement
        bind += struct.pack("!H", 0)  # all params text format
        bind += struct.pack("!H", len(params))
        for p in params:
            encoded = _encode_param(p)
            if encoded is None:
                bind += struct.pack("!i", -1)
            else:
                bind += struct.pack("!I", len(encoded)) + encoded
        bind += struct.pack("!H", 0)  # results in text format
        self._send(b"B", bind)
        self._send(b"D", b"P" + _cstr(""))
        self._send(b"E", _cstr("") + struct.pack("!I", 0))
        self._send(b"S", b"")
        await self._drain_w()
        return await self._collect()

    async def _simple(self, sql: str) -> tuple[list[dict], int]:
        self._send(b"Q", _cstr(sql))
        await self._drain_w()
        return await self._collect(simple=True)

    async def _collect(self, simple=False) -> tuple[list[dict], int]:
        columns: list[tuple[str, int]] = []
        rows: list[dict] = []
        rowcount = 0
        error: PgServerError | None = None
        while True:
            tag, body = await self._recv()
            if tag == b"T":  # RowDescription
                (n,) = struct.unpack("!H", body[:2])
                off = 2
                columns = []
                for _ in range(n):
                    end = body.index(b"\0", off)
                    name = body[off:end].decode()
                    off = end + 1
                    (_tbl, _att, type_oid, _sz, _mod, _fmt) = struct.unpack(
                        "!IHIhih", body[off : off + 18]
                    )
                    off += 18
                    columns.append((name, type_oid))
            elif tag == b"D":  # DataRow
                (n,) = struct.unpack("!H", body[:2])
                off = 2
                row = {}
                for col in range(n):
                    (ln,) = struct.unpack("!i", body[off : off + 4])
                    off += 4
                    if ln < 0:
                        value = None
                    else:
                        raw = body[off : off + ln]
                        off += ln
                        value = _decode_value(raw, columns[col][1])
                    row[columns[col][0]] = value
                rows.append(row)
            elif tag == b"C":  # CommandComplete
                words = body.rstrip(b"\0").decode().split()
                if words and words[-1].isdigit():
                    rowcount = int(words[-1])
            elif tag == b"E":
                error = PgServerError(_error_fields(body))
            elif tag == b"Z":  # ReadyForQuery — end of round trip
                if error is not None:
                    raise error
                return rows, rowcount
            # 1/2/3 (parse/bind/close complete), n (no data), N, S: skip

    # ----------------------------------------------------------- plumbing

    def _send(self, tag: bytes, payload: bytes):
        self._w.write(_msg(tag, payload))

    async def _drain_w(self):
        await self._w.drain()

    async def _recv(self) -> tuple[bytes, bytes]:
        header = await self._r.readexactly(5)
        tag = header[:1]
        (length,) = struct.unpack("!I", header[1:5])
        body = await self._r.readexactly(length - 4)
        return tag, body

    async def close(self):
        if self._w is not None:
            try:
                self._w.write(_msg(b"X", b""))
                await self._w.drain()
            except Exception:
                pass
            self._w.close()
            try:
                await self._w.wait_closed()
            except Exception:
                pass
            self._w = None


def _scram_escape(s: str) -> str:
    return s.replace("=", "=3D").replace(",", "=2C")


def _error_fields(body: bytes) -> dict:
    out = {}
    for part in body.split(b"\0"):
        if part:
            out[chr(part[0])] = part[1:].decode(errors="replace")
    return out


def _encode_param(p) -> bytes | None:
    if p is None:
        return None
    if isinstance(p, bool):
        return b"t" if p else b"f"
    if isinstance(p, (bytes, bytearray, memoryview)):
        return b"\\x" + bytes(p).hex().encode()
    if isinstance(p, float):
        return repr(p).encode()
    return str(p).encode()


_INT_OIDS = {20, 21, 23, 26, 28}
_FLOAT_OIDS = {700, 701, 1700}
_BOOL_OID = 16
_BYTEA_OID = 17


def _decode_value(raw: bytes, oid: int):
    if oid in _INT_OIDS:
        return int(raw)
    if oid in _FLOAT_OIDS:
        return float(raw)
    if oid == _BOOL_OID:
        return raw == b"t"
    if oid == _BYTEA_OID:
        text = raw.decode()
        if text.startswith("\\x"):
            return bytes.fromhex(text[2:])
        return raw
    return raw.decode()


# ---------------------------------------------------------- SQL dialect


_QMARK = re.compile(r"\?")


def to_pg_sql(sql: str) -> str:
    """SQLite-flavoured statement -> Postgres dialect."""
    # ? -> $n outside quoted strings.
    out = []
    n = 0
    in_str = False
    i = 0
    while i < len(sql):
        c = sql[i]
        if c == "'":
            in_str = not in_str
            out.append(c)
        elif c == "?" and not in_str:
            n += 1
            out.append(f"${n}")
        else:
            out.append(c)
        i += 1
    text = "".join(out)
    upper = text.lstrip()[:40].upper()
    if upper.startswith("INSERT OR IGNORE INTO"):
        text = text.replace(
            "INSERT OR IGNORE INTO", "INSERT INTO", 1
        )
        text += " ON CONFLICT DO NOTHING"
    elif upper.startswith("INSERT OR REPLACE INTO"):
        m = re.match(
            r"\s*INSERT OR REPLACE INTO\s+(\S+)\s*\(([^)]*)\)",
            text,
            re.I,
        )
        if not m:
            raise DatabaseError(
                "cannot translate INSERT OR REPLACE without a column list"
            )
        cols = [c.strip() for c in m.group(2).split(",")]
        text = text.replace("INSERT OR REPLACE INTO", "INSERT INTO", 1)
        sets = ", ".join(
            f"{c} = EXCLUDED.{c}" for c in cols[1:]
        ) or f"{cols[0]} = EXCLUDED.{cols[0]}"
        text += f" ON CONFLICT ({cols[0]}) DO UPDATE SET {sets}"
    return text


def to_pg_ddl(sql: str) -> str:
    return (
        sql.replace(" BLOB", " BYTEA")
        .replace(" REAL", " DOUBLE PRECISION")
    )


# --------------------------------------------------------------- engine


class PostgresDatabase(GroupCommitObservability):
    """`Database`-interface engine over the stdlib wire client.

    Concurrency model mirrors the SQLite engine: ONE writer connection
    guarded by an asyncio lock (transactions own it for their scope),
    plus a small pool of reader connections for lock-free reads —
    Postgres gives readers full MVCC isolation, so the pool needs no
    WAL tricks."""

    def __init__(
        self,
        dsn: str | list[str],
        read_pool_size: int = 2,
        write_batch_max: int = 256,
        write_queue_depth: int = 4096,
        write_drain_deadline_ms: int = 0,
        db_drain_restart_max: int = DB_DRAIN_RESTART_MAX,
    ):
        self.addresses = [dsn] if isinstance(dsn, str) else list(dsn)
        self.path = self.addresses[0]
        self._conn: PgWireConnection | None = None
        self._readers: list[PgWireConnection] = []
        self._reader_locks: list[asyncio.Lock] = []
        self._read_pool_size = max(0, read_pool_size)
        self._rr = 0
        self._lock = asyncio.Lock()
        self._tx_owner: asyncio.Task | None = None
        self.peak_concurrent_reads = 0
        self._reads_in_flight = 0
        # Group-commit write pipeline: the same engine-agnostic batcher
        # as the SQLite engine (db.py WriteBatcher); this engine's
        # _run_write_group maps a batch onto one BEGIN..SAVEPOINT-per-
        # unit..COMMIT round over the writer connection — the pipelined
        # equivalent of pgx's batched WAL flush (reference db.go:35).
        self._write_knobs = (
            write_batch_max, write_queue_depth, write_drain_deadline_ms,
            db_drain_restart_max,
        )
        self._batcher = WriteBatcher(self, *self._write_knobs)
        self._closing = False
        # Writer-connection breaker (degradation ladder): consecutive
        # connection losses open it and group writes fail fast instead
        # of each batch paying the full reconnect-retry budget against
        # a dead server; a cooldown probe (the next batch) closes it.
        self._breaker = CircuitBreaker(
            threshold=PG_BREAKER_THRESHOLD,
            cooldown_s=PG_BREAKER_COOLDOWN_S,
            on_transition=self._on_breaker_transition,
        )
        self._retry_rng = random.Random()

    def _connected(self) -> bool:
        return self._conn is not None

    def _on_breaker_transition(self, old: str, new: str, reason: str):
        if self.tracing is not None:
            self.tracing.record_breaker(
                kind="pg_writer", old=old, new=new, reason=reason
            )

    @staticmethod
    def _parse(dsn: str):
        u = urlparse(dsn)
        return (
            u.hostname or "127.0.0.1",
            u.port or 5432,
            unquote(u.username or "postgres"),
            unquote(u.password or ""),
            (u.path or "/").lstrip("/") or "postgres",
        )

    async def _open(self, dsn: str) -> PgWireConnection:
        conn = PgWireConnection(*self._parse(dsn))
        await conn.connect()
        return conn

    async def connect(self, migrate: bool = True) -> None:
        # Fresh batcher per connect: its asyncio primitives bind to the
        # loop they first run on, and a reconnect may be on a new loop.
        # (Also resets the drain supervisor's fail-fast latch.)
        self._batcher = WriteBatcher(self, *self._write_knobs)
        self._closing = False
        last: Exception | None = None
        for dsn in self.addresses:
            try:
                self._conn = await self._open(dsn)
                self.path = dsn
                break
            except (OSError, DatabaseError) as e:
                last = e
        else:
            raise DatabaseError(f"no database address reachable: {last}")
        if migrate:
            await self.migrate()
        for _ in range(self._read_pool_size):
            try:
                self._readers.append(await self._open(self.path))
                self._reader_locks.append(asyncio.Lock())
            except (OSError, DatabaseError):
                break  # degraded: reads fall back to the writer

    async def close(self) -> None:
        # Shutdown under load mirrors the SQLite engine: queued units
        # reject with DatabaseError now, the in-flight batch finishes.
        self._closing = True
        self._batcher.fail_pending(DatabaseError("database closing"))
        await self._batcher.flush()
        for c in [self._conn, *self._readers]:
            if c is not None:
                await c.close()
        self._conn = None
        self._batcher.fail_pending(DatabaseError("database closed"))
        self._readers = []
        self._reader_locks = []

    async def migrate(self) -> list[str]:
        await self._conn.query(
            "CREATE TABLE IF NOT EXISTS migration_info ("
            " version INTEGER PRIMARY KEY, name TEXT NOT NULL,"
            " applied_at DOUBLE PRECISION NOT NULL)"
        )
        rows, _ = await self._conn.query(
            "SELECT version FROM migration_info"
        )
        applied = {r["version"] for r in rows}
        out = []
        for version, name, statements in MIGRATIONS:
            if version in applied:
                continue
            for stmt in statements:
                await self._conn.query(to_pg_ddl(stmt))
            await self._conn.query(
                "INSERT INTO migration_info (version, name, applied_at)"
                " VALUES ($1, $2, $3)",
                (version, name, time.time()),
            )
            out.append(name)
        return out

    async def migrate_down(self, limit: int = 1) -> list[str]:
        """Revert the newest `limit` migrations (same derived-DDL
        approach as the SQLite engine, storage/db.py migrate_down)."""
        from .migrations import down_statements

        by_version = {v: (name, stmts) for v, name, stmts in MIGRATIONS}
        rows, _ = await self._conn.query(
            "SELECT version FROM migration_info"
            " ORDER BY version DESC LIMIT $1",
            (limit,),
        )
        reverted = []
        for r in rows:
            version = r["version"]
            entry = by_version.get(version)
            if entry is None:  # unknown to this binary: leave it
                continue
            name, stmts = entry
            for stmt in down_statements(version, stmts):
                await self._conn.query(to_pg_ddl(stmt))
            await self._conn.query(
                "DELETE FROM migration_info WHERE version = $1",
                (version,),
            )
            reverted.append(name)
        return reverted

    # ---------------------------------------------------------- statements

    def _map_error(self, e: Exception) -> Exception:
        if isinstance(e, PgServerError) and e.code == "23505":
            return UniqueViolationError(str(e))
        if isinstance(e, DatabaseError):
            return e
        return DatabaseError(str(e))

    async def _writer_query(self, sql: str, params: tuple):
        try:
            return await self._conn.query(to_pg_sql(sql), params)
        except (OSError, asyncio.IncompleteReadError) as e:
            # Connection lost (server restart, LB idle kill): reconnect
            # across the configured addresses and retry ONCE — but never
            # inside an open transaction, whose state died with the
            # socket (the SQLite engine's failover seam, db.py connect).
            if asyncio.current_task() is self._tx_owner:
                raise DatabaseError(
                    f"connection lost mid-transaction: {e}"
                ) from e
            await self._reconnect_writer()
            try:
                return await self._conn.query(to_pg_sql(sql), params)
            except Exception as e2:
                raise self._map_error(e2) from e2
        except Exception as e:
            raise self._map_error(e) from e

    async def _reconnect_writer(self):
        old, self._conn = self._conn, None
        if old is not None:
            await old.close()
        last: Exception | None = None
        for dsn in self.addresses:
            try:
                self._conn = await self._open(dsn)
                self.path = dsn
                return
            except (OSError, DatabaseError) as e:
                last = e
        raise DatabaseError(f"no database address reachable: {last}")

    async def execute(self, sql: str, params: Iterable[Any] = ()) -> int:
        params = tuple(params)
        if asyncio.current_task() is self._tx_owner:
            _, count = await self._writer_query(sql, params)
            return count
        counts = await self._write_unit([(sql, params)], None)
        return counts[0]

    async def execute_many(
        self, sql: str, params_seq: Iterable[Iterable[Any]]
    ) -> int:
        """Same contract as the SQLite engine: the rows are ONE atomic
        unit inside the next group commit."""
        stmts = [(sql, tuple(p)) for p in params_seq]
        if not stmts:
            return 0
        if asyncio.current_task() is self._tx_owner:
            total = 0
            for s, p in stmts:
                _, count = await self._writer_query(s, p)
                total += count
            return total
        return sum(await self._write_unit(stmts, None))

    async def submit_write(
        self,
        stmts,
        guards=None,
    ) -> list[int]:
        """Atomic multi-statement unit with optional zero-row guards —
        identical semantics to the SQLite engine (db.py submit_write)."""
        norm, g = _normalize_unit(stmts, guards)
        if asyncio.current_task() is self._tx_owner:
            counts = []
            for (s, p), guarded in zip(norm, g):
                _, count = await self._writer_query(s, p)
                if guarded and count == 0:
                    raise WriteConflictError(
                        "guarded statement matched no rows"
                    )
                counts.append(count)
            return counts
        return await self._write_unit(norm, g)

    async def _write_unit(self, stmts, guards) -> list[int]:
        return await self._batcher.write_unit(stmts, guards)

    async def _run_write_group(self, units: list) -> list:
        """One BEGIN .. SAVEPOINT-per-unit .. COMMIT round over the
        writer connection (caller holds the writer lock); returns
        ``[(ok, rowcounts | exception), ...]`` unit-wise. A savepoint
        confines a failed unit's aborted-transaction state so the rest
        of the batch commits (Postgres aborts the whole transaction on
        error otherwise).

        Connection loss (server restart, LB idle kill) reconnects
        across the configured addresses and retries the group with a
        bounded jittered-backoff budget (PG_WRITE_RETRY_MAX) — the
        failover seam `_writer_query` gives the legacy path, hardened
        for the batched one — but ONLY when the loss happened before
        COMMIT was sent, which is the only point retry is provably
        safe. A socket death during the COMMIT query itself leaves the
        outcome unknown on the server, and retrying a whole batch would
        multiply the double-apply exposure across every caller sharing
        the commit — those units fail to their callers with an explicit
        commit-state-unknown error instead. Likewise once the per-unit
        SOLO fallback starts committing, a loss fails the remaining
        units rather than re-running units already made durable.

        The writer breaker wires the same degradation ladder as the
        matchmaker device path: consecutive losses open it and batches
        fail FAST (one DatabaseError, no reconnect storm) until the
        cooldown probe — the next batch — reconnects and closes it."""
        if not self._breaker.allow():
            err = DatabaseError(
                "database writer circuit open (recent connection losses);"
                " retry after cooldown"
            )
            return [(False, err) for _ in units]
        # The breaker records one outcome per BATCH (success after
        # retries is a success): recording every connection attempt
        # could open it mid-retry-loop and then discard the batch's own
        # success as stale, failing healthy writes for a full cooldown.
        attempt = 0
        while True:
            if self._conn is None:
                try:
                    await self._reconnect_writer()
                except Exception as e:
                    self._breaker.record_failure()
                    err = DatabaseError(f"no database address reachable: {e}")
                    return [(False, err) for _ in units]
            try:
                results = await self._run_group_once(units)
            except _CommitAckLost as e:
                self._breaker.record_failure()
                try:
                    await self._reconnect_writer()
                except Exception:
                    pass  # next write retries via this method
                err = DatabaseError(
                    f"connection lost during commit (outcome unknown): {e}"
                )
                return [(False, err) for _ in units]
            except (OSError, asyncio.IncompleteReadError) as e:
                attempt += 1
                if attempt > PG_WRITE_RETRY_MAX:
                    self._breaker.record_failure()
                    # Never leave the half-applied transaction's
                    # connection behind: the next batch's BEGIN would
                    # land inside it. Dropping the connection rolls the
                    # server side back.
                    try:
                        await self._reconnect_writer()
                    except Exception:
                        self._conn = None
                    err = DatabaseError(
                        f"connection lost before COMMIT; retries"
                        f" exhausted: {e}"
                    )
                    return [(False, err) for _ in units]
                # Pre-COMMIT loss: the server-side transaction died with
                # the socket, so a re-run cannot double-apply. Full
                # jitter decorrelates the reconnect stampede when many
                # engines lose the same server at once.
                await asyncio.sleep(jittered_backoff(
                    attempt, PG_RETRY_BASE_S, PG_RETRY_MAX_S,
                    rng=self._retry_rng,
                ))
                try:
                    await self._reconnect_writer()
                except Exception:
                    self._conn = None  # next loop pass retries/charges
                continue
            self._breaker.record_success()
            return results

    @staticmethod
    async def _apply_unit_stmts(conn, stmts, guards) -> list[int]:
        """Run one unit's statements over the wire, enforcing zero-row
        guards — THE definition of unit/guard semantics for this engine
        (db.py's sync `_apply_unit_stmts` is the SQLite twin)."""
        counts = []
        for (sql, params), guarded in zip(stmts, guards):
            _, count = await conn.query(to_pg_sql(sql), params)
            if guarded and count == 0:
                raise WriteConflictError(
                    "guarded statement matched no rows"
                )
            counts.append(count)
        return counts

    async def _run_group_once(self, units: list) -> list:
        conn = self._conn

        async def _unit_solo(unit) -> tuple:
            # Per-unit commit fallback when the group envelope failed.
            try:
                await conn.query("BEGIN")
                counts = await self._apply_unit_stmts(
                    conn, unit.stmts, unit.guards
                )
                await conn.query("COMMIT")
                return (True, counts)
            except (PgServerError, WriteConflictError) as e:
                try:
                    await conn.query("ROLLBACK")
                except Exception:
                    pass
                if isinstance(e, WriteConflictError):
                    return (False, e)
                return (False, self._map_error(e))

        async def _solo_all() -> list:
            # Units commit one-by-one from here on, so a connection
            # loss must NOT escape to the group-level retry: committed
            # units keep their results, the rest fail to their callers.
            results: list = []
            for u in units:
                try:
                    results.append(await _unit_solo(u))
                except (OSError, asyncio.IncompleteReadError) as e:
                    err = DatabaseError(f"connection lost: {e}")
                    results.extend(
                        [(False, err)] * (len(units) - len(results))
                    )
                    try:
                        await self._reconnect_writer()
                    except Exception:
                        pass  # next write retries via _run_write_group
                    break
            return results

        try:
            await conn.query("BEGIN")
        except PgServerError:
            return await _solo_all()
        results = []
        try:
            for i, unit in enumerate(units):
                sp = f"nk_gc_{i}"
                try:
                    await conn.query(f"SAVEPOINT {sp}")
                    counts = await self._apply_unit_stmts(
                        conn, unit.stmts, unit.guards
                    )
                    await conn.query(f"RELEASE {sp}")
                    results.append((True, counts))
                except (PgServerError, WriteConflictError) as e:
                    await conn.query(f"ROLLBACK TO {sp}")
                    await conn.query(f"RELEASE {sp}")
                    if isinstance(e, WriteConflictError):
                        results.append((False, e))
                    else:
                        results.append((False, self._map_error(e)))
        except BaseException:
            # Unexpected failure (e.g. the savepoint recovery itself):
            # never leave the connection inside the dead group
            # transaction — roll back before surfacing.
            try:
                await conn.query("ROLLBACK")
            except Exception:
                pass
            raise
        # Chaos: `pg.commit` injects a connection loss at the sharpest
        # retry-safe seam — every unit applied, COMMIT not yet sent (a
        # pre-COMMIT drop: the server-side transaction dies with the
        # socket, so the bounded retry above re-runs without
        # double-apply). A loss DURING the COMMIT round trip below is
        # the ambiguous case and fails the batch instead.
        faults.fire("pg.commit")
        try:
            await conn.query("COMMIT")
        except (OSError, asyncio.IncompleteReadError) as e:
            # The server may or may not have committed: retrying the
            # group risks double-apply, so surface the ambiguity.
            raise _CommitAckLost(str(e)) from e
        except PgServerError:
            try:
                await conn.query("ROLLBACK")
            except Exception:
                pass
            return await _solo_all()
        return results

    async def _read(self, sql: str, params: tuple) -> list[dict]:
        if asyncio.current_task() is self._tx_owner:
            rows, _ = await self._writer_query(sql, params)
            return rows
        if self._readers:
            idx = self._rr % len(self._readers)
            self._rr += 1
            self._reads_in_flight += 1
            self.peak_concurrent_reads = max(
                self.peak_concurrent_reads, self._reads_in_flight
            )
            try:
                async with self._reader_locks[idx]:
                    try:
                        rows, _ = await self._readers[idx].query(
                            to_pg_sql(sql), params
                        )
                        return rows
                    except (OSError, asyncio.IncompleteReadError):
                        # Dead reader: reopen in place and retry once.
                        await self._readers[idx].close()
                        try:
                            self._readers[idx] = await self._open(
                                self.path
                            )
                            rows, _ = await self._readers[idx].query(
                                to_pg_sql(sql), params
                            )
                            return rows
                        except Exception as e2:
                            raise self._map_error(e2) from e2
                    except Exception as e:
                        raise self._map_error(e) from e
            finally:
                self._reads_in_flight -= 1
        async with self._lock:
            rows, _ = await self._writer_query(sql, params)
            return rows

    async def fetch_all(
        self, sql: str, params: Iterable[Any] = ()
    ) -> list[dict]:
        return await self._read(sql, tuple(params))

    async def fetch_one(
        self, sql: str, params: Iterable[Any] = ()
    ) -> dict | None:
        rows = await self._read(sql, tuple(params))
        return rows[0] if rows else None

    def tx(self) -> "PgTransaction":
        return PgTransaction(self)


class PgTransaction:
    """Same contract as storage.db.Transaction: holds the writer lock,
    BEGIN..COMMIT/ROLLBACK around the scope."""

    def __init__(self, db: PostgresDatabase):
        self._db = db

    async def __aenter__(self) -> "PgTransaction":
        await self._db._lock.acquire()
        try:
            await self._db._conn.query("BEGIN")
        except BaseException:
            self._db._lock.release()
            raise
        self._db._tx_owner = asyncio.current_task()
        return self

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        try:
            if exc_type is None:
                await self._db._conn.query("COMMIT")
            else:
                await self._db._conn.query("ROLLBACK")
        finally:
            self._db._tx_owner = None
            self._db._lock.release()
        return False

    async def execute(self, sql: str, params: Iterable[Any] = ()) -> int:
        _, count = await self._db._writer_query(sql, tuple(params))
        return count

    async def fetch_all(
        self, sql: str, params: Iterable[Any] = ()
    ) -> list[dict]:
        rows, _ = await self._db._writer_query(sql, tuple(params))
        return rows

    async def fetch_one(
        self, sql: str, params: Iterable[Any] = ()
    ) -> dict | None:
        rows, _ = await self._db._writer_query(sql, tuple(params))
        return rows[0] if rows else None

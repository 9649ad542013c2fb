"""Persistence layer: the embedded SQLite engine + embedded migrations.

The port's copy of the JAX package's `storage/`: `Database` (db.py) is
the embedded SQLite engine — durable file or `:memory:`, WAL read pool,
group-commit write pipeline — over the same schema (migrations.py), so
either package opens a database file the other wrote.

`make_database()` picks the engine by address, as the JAX package's
does. The JAX package also has a Postgres engine over a stdlib wire
client (`storage/pg.py`); the port does not have it yet (ROADMAP.md §A,
"storage/pg.py"), so a `postgres://` address raises instead of quietly
opening a SQLite file of that name.
"""

from .db import (
    Database,
    DatabaseError,
    UniqueViolationError,
    WriteConflictError,
    migrate_status,
)


def make_database(
    addresses,
    read_pool_size: int = 4,
    write_batch_max: int = 256,
    write_queue_depth: int = 4096,
    write_drain_deadline_ms: int = 0,
    db_drain_restart_max: int = 8,
):
    """Engine factory over an address and the group-commit knobs: the
    embedded SQLite engine. A postgres:// DSN raises
    NotImplementedError (the Postgres engine is a later slice)."""
    addrs = [addresses] if isinstance(addresses, str) else list(addresses)
    if addrs and addrs[0].startswith(("postgres://", "postgresql://")):
        raise NotImplementedError(
            "the port has no Postgres engine yet (ROADMAP.md §A:"
            " storage/pg.py); use a SQLite file path or ':memory:'"
        )
    return Database(
        addrs,
        read_pool_size=read_pool_size,
        write_batch_max=write_batch_max,
        write_queue_depth=write_queue_depth,
        write_drain_deadline_ms=write_drain_deadline_ms,
        db_drain_restart_max=db_drain_restart_max,
    )


__all__ = [
    "Database",
    "DatabaseError",
    "UniqueViolationError",
    "WriteConflictError",
    "make_database",
    "migrate_status",
]

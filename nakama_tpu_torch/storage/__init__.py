"""Persistence layer: the embedded SQLite engine + embedded migrations.

The port's copy of the JAX package's `storage/`: `Database` (db.py) is
the embedded SQLite engine — durable file or `:memory:`, WAL read pool,
group-commit write pipeline — over the same schema (migrations.py), so
either package opens a database file the other wrote.

`PostgresDatabase` (pg.py) is the Postgres engine over a stdlib wire
client, the port's copy of the JAX package's. `make_database()` picks
the engine by address, as the JAX package's does.
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
    """Engine factory: postgres:// DSNs get the wire-protocol engine,
    everything else the embedded SQLite engine. Both take the same
    group-commit knobs (config.database.*) so the write-pipeline
    semantics are engine-independent."""
    addrs = [addresses] if isinstance(addresses, str) else list(addresses)
    knobs = dict(
        read_pool_size=read_pool_size,
        write_batch_max=write_batch_max,
        write_queue_depth=write_queue_depth,
        write_drain_deadline_ms=write_drain_deadline_ms,
        db_drain_restart_max=db_drain_restart_max,
    )
    if addrs and addrs[0].startswith(("postgres://", "postgresql://")):
        from .pg import PostgresDatabase

        return PostgresDatabase(addrs, **knobs)
    return Database(addrs, **knobs)


__all__ = [
    "Database",
    "DatabaseError",
    "UniqueViolationError",
    "WriteConflictError",
    "make_database",
    "migrate_status",
]

"""Embedded schema migrations.

The port's copy of the JAX package's `storage/migrations.py`, every
migration included: the schema is shared, so either package opens a
database file the other wrote (`matchmaker_journal` and
`matchmaker_checkpoint` are the tables the port's recovery plane uses).

Mirrors the reference's table inventory (reference migrate/sql/*.sql — 17
tables listed in SURVEY.md §2.2: users, user_device, user_edge,
notification, storage, message, leaderboard, leaderboard_record,
wallet_ledger, user_tombstone, groups, group_edge, console_user, purchase,
purchase_receipt, subscription) translated to SQLite idiom: UUIDs as TEXT,
JSONB as TEXT holding JSON, timestamps as REAL unix seconds. Each entry is
(version, name, [statements]); applied in order, tracked in `migration_info`
the way the reference's sql-migrate tracks `migration_info`
(reference migrate/migrate.go).

Down-migrations (reference migrate/migrate.go:108-111 `down`/`redo`) are
DERIVED rather than hand-written: every statement here is a CREATE TABLE /
CREATE INDEX, so the inverse is the reversed list of DROPs —
`down_statements()` parses the created object names out of the up
statements. A future migration that ALTERs instead of CREATEs must carry
an explicit down list via `EXPLICIT_DOWNS`.
"""

import re

# version -> explicit down statements, for migrations whose inverse is not
# mechanically derivable (none yet).
EXPLICIT_DOWNS: dict[int, list[str]] = {}

_CREATE_RE = re.compile(
    r"CREATE\s+(TABLE|INDEX)\s+(?:IF\s+NOT\s+EXISTS\s+)?([A-Za-z_][\w]*)",
    re.IGNORECASE,
)


def down_statements(version: int, statements: list[str]) -> list[str]:
    """The inverse of one migration: DROPs of everything it created, in
    reverse order (indexes drop with their tables in SQLite, but explicit
    DROP INDEX keeps the list faithful)."""
    explicit = EXPLICIT_DOWNS.get(version)
    if explicit is not None:
        return explicit
    drops: list[str] = []
    for stmt in reversed(statements):
        m = _CREATE_RE.search(stmt)
        if m is None:
            raise ValueError(
                f"migration v{version} statement is not mechanically "
                f"invertible; add EXPLICIT_DOWNS[{version}]: {stmt[:60]!r}"
            )
        kind, obj = m.group(1).upper(), m.group(2)
        drops.append(f"DROP {kind} IF EXISTS {obj}")
    return drops

MIGRATIONS: list[tuple[int, str, list[str]]] = [
    (
        1,
        "initial-schema",
        [
            # reference migrate/sql/20180103142001_initial_schema.sql
            """
            CREATE TABLE IF NOT EXISTS users (
                id            TEXT PRIMARY KEY,
                username      TEXT NOT NULL UNIQUE,
                display_name  TEXT,
                avatar_url    TEXT,
                lang_tag      TEXT DEFAULT 'en',
                location      TEXT,
                timezone      TEXT,
                metadata      TEXT NOT NULL DEFAULT '{}',
                wallet        TEXT NOT NULL DEFAULT '{}',
                email         TEXT UNIQUE,
                password      BLOB,
                facebook_id   TEXT UNIQUE,
                facebook_instant_game_id TEXT UNIQUE,
                google_id     TEXT UNIQUE,
                gamecenter_id TEXT UNIQUE,
                steam_id      TEXT UNIQUE,
                apple_id      TEXT UNIQUE,
                custom_id     TEXT UNIQUE,
                edge_count    INTEGER NOT NULL DEFAULT 0,
                create_time   REAL NOT NULL,
                update_time   REAL NOT NULL,
                verify_time   REAL NOT NULL DEFAULT 0,
                disable_time  REAL NOT NULL DEFAULT 0
            )
            """,
            """
            CREATE TABLE IF NOT EXISTS user_device (
                id      TEXT PRIMARY KEY,
                user_id TEXT NOT NULL REFERENCES users (id),
                preferences TEXT NOT NULL DEFAULT '{}'
            )
            """,
            "CREATE INDEX IF NOT EXISTS user_device_user_id_idx ON user_device (user_id)",
            # friend graph (state: 0 friend / 1 invite-sent / 2 invite-received / 3 blocked)
            """
            CREATE TABLE IF NOT EXISTS user_edge (
                source_id        TEXT NOT NULL REFERENCES users (id),
                destination_id   TEXT NOT NULL REFERENCES users (id),
                state            INTEGER NOT NULL DEFAULT 0,
                position         INTEGER NOT NULL,
                update_time      REAL NOT NULL,
                PRIMARY KEY (source_id, state, position),
                UNIQUE (source_id, destination_id)
            )
            """,
            """
            CREATE TABLE IF NOT EXISTS notification (
                id          TEXT PRIMARY KEY,
                user_id     TEXT NOT NULL,
                subject     TEXT NOT NULL,
                content     TEXT NOT NULL DEFAULT '{}',
                code        INTEGER NOT NULL,
                sender_id   TEXT,
                create_time REAL NOT NULL
            )
            """,
            "CREATE INDEX IF NOT EXISTS notification_user_id_idx ON notification (user_id, create_time, id)",
            # OCC object store (reference server/core_storage.go:467-614)
            """
            CREATE TABLE IF NOT EXISTS storage (
                collection  TEXT NOT NULL,
                key         TEXT NOT NULL,
                user_id     TEXT NOT NULL,
                value       TEXT NOT NULL DEFAULT '{}',
                version     TEXT NOT NULL,
                read        INTEGER NOT NULL DEFAULT 1,
                write       INTEGER NOT NULL DEFAULT 1,
                create_time REAL NOT NULL,
                update_time REAL NOT NULL,
                PRIMARY KEY (collection, key, user_id)
            )
            """,
            "CREATE INDEX IF NOT EXISTS storage_user_idx ON storage (user_id, collection, key)",
            # chat history (reference migrate message table; core_channel.go:293)
            """
            CREATE TABLE IF NOT EXISTS message (
                id           TEXT PRIMARY KEY,
                code         INTEGER NOT NULL DEFAULT 0,
                sender_id    TEXT NOT NULL,
                username     TEXT NOT NULL,
                stream_mode  INTEGER NOT NULL,
                stream_subject TEXT NOT NULL,
                stream_subcontext TEXT NOT NULL DEFAULT '',
                stream_label TEXT NOT NULL DEFAULT '',
                content      TEXT NOT NULL DEFAULT '{}',
                create_time  REAL NOT NULL,
                update_time  REAL NOT NULL
            )
            """,
            """
            CREATE INDEX IF NOT EXISTS message_stream_idx
            ON message (stream_mode, stream_subject, stream_subcontext, stream_label, create_time, id)
            """,
            """
            CREATE TABLE IF NOT EXISTS wallet_ledger (
                id          TEXT PRIMARY KEY,
                user_id     TEXT NOT NULL REFERENCES users (id),
                changeset   TEXT NOT NULL,
                metadata    TEXT NOT NULL DEFAULT '{}',
                create_time REAL NOT NULL,
                update_time REAL NOT NULL
            )
            """,
            "CREATE INDEX IF NOT EXISTS wallet_ledger_user_idx ON wallet_ledger (user_id, create_time, id)",
            """
            CREATE TABLE IF NOT EXISTS user_tombstone (
                user_id     TEXT PRIMARY KEY,
                create_time REAL NOT NULL
            )
            """,
        ],
    ),
    (
        2,
        "leaderboards",
        [
            # reference migrate/sql leaderboard + 20180805174141-tournaments.sql
            # (tournament columns live on leaderboard)
            """
            CREATE TABLE IF NOT EXISTS leaderboard (
                id             TEXT PRIMARY KEY,
                authoritative  INTEGER NOT NULL DEFAULT 0,
                sort_order     INTEGER NOT NULL DEFAULT 1,
                operator       INTEGER NOT NULL DEFAULT 0,
                reset_schedule TEXT,
                metadata       TEXT NOT NULL DEFAULT '{}',
                create_time    REAL NOT NULL,
                category       INTEGER NOT NULL DEFAULT 0,
                description    TEXT NOT NULL DEFAULT '',
                duration       INTEGER NOT NULL DEFAULT 0,
                end_time       REAL NOT NULL DEFAULT 0,
                join_required  INTEGER NOT NULL DEFAULT 0,
                max_size       INTEGER NOT NULL DEFAULT 0,
                max_num_score  INTEGER NOT NULL DEFAULT 0,
                start_time     REAL NOT NULL DEFAULT 0,
                title          TEXT NOT NULL DEFAULT ''
            )
            """,
            """
            CREATE TABLE IF NOT EXISTS leaderboard_record (
                leaderboard_id TEXT NOT NULL,
                owner_id       TEXT NOT NULL,
                username       TEXT,
                score          INTEGER NOT NULL DEFAULT 0,
                subscore       INTEGER NOT NULL DEFAULT 0,
                num_score      INTEGER NOT NULL DEFAULT 1,
                metadata       TEXT NOT NULL DEFAULT '{}',
                create_time    REAL NOT NULL,
                update_time    REAL NOT NULL,
                expiry_time    REAL NOT NULL DEFAULT 0,
                max_num_score  INTEGER NOT NULL DEFAULT 0,
                PRIMARY KEY (leaderboard_id, expiry_time, owner_id)
            )
            """,
            """
            CREATE INDEX IF NOT EXISTS leaderboard_record_rank_idx
            ON leaderboard_record (leaderboard_id, expiry_time, score, subscore)
            """,
        ],
    ),
    (
        3,
        "groups",
        [
            # reference migrate/sql groups + group_edge
            """
            CREATE TABLE IF NOT EXISTS groups (
                id           TEXT PRIMARY KEY,
                creator_id   TEXT NOT NULL,
                name         TEXT NOT NULL UNIQUE,
                description  TEXT,
                avatar_url   TEXT,
                lang_tag     TEXT DEFAULT 'en',
                metadata     TEXT NOT NULL DEFAULT '{}',
                state        INTEGER NOT NULL DEFAULT 0,
                edge_count   INTEGER NOT NULL DEFAULT 0,
                max_count    INTEGER NOT NULL DEFAULT 100,
                create_time  REAL NOT NULL,
                update_time  REAL NOT NULL,
                disable_time REAL NOT NULL DEFAULT 0
            )
            """,
            # state: 0 superadmin / 1 admin / 2 member / 3 join-request / 4 banned
            """
            CREATE TABLE IF NOT EXISTS group_edge (
                source_id      TEXT NOT NULL,
                destination_id TEXT NOT NULL,
                state          INTEGER NOT NULL,
                position       INTEGER NOT NULL,
                update_time    REAL NOT NULL,
                PRIMARY KEY (source_id, state, position),
                UNIQUE (source_id, destination_id)
            )
            """,
        ],
    ),
    (
        4,
        "console",
        [
            # reference migrate/sql/20201005180855-console.sql:18
            """
            CREATE TABLE IF NOT EXISTS console_user (
                id          TEXT PRIMARY KEY,
                username    TEXT NOT NULL UNIQUE,
                email       TEXT NOT NULL UNIQUE,
                password    BLOB,
                role        INTEGER NOT NULL DEFAULT 4,
                create_time REAL NOT NULL,
                update_time REAL NOT NULL,
                disable_time REAL NOT NULL DEFAULT 0
            )
            """,
        ],
    ),
    (
        5,
        "purchases",
        [
            # reference migrate/sql purchase / purchase_receipt / subscription
            """
            CREATE TABLE IF NOT EXISTS purchase (
                user_id          TEXT NOT NULL,
                transaction_id   TEXT PRIMARY KEY,
                product_id       TEXT NOT NULL,
                store            INTEGER NOT NULL,
                raw_response     TEXT NOT NULL DEFAULT '{}',
                purchase_time    REAL NOT NULL,
                create_time      REAL NOT NULL,
                update_time      REAL NOT NULL,
                refund_time      REAL NOT NULL DEFAULT 0,
                environment      INTEGER NOT NULL DEFAULT 0
            )
            """,
            "CREATE INDEX IF NOT EXISTS purchase_user_idx ON purchase (user_id, purchase_time, transaction_id)",
            """
            CREATE TABLE IF NOT EXISTS subscription (
                user_id              TEXT NOT NULL,
                original_transaction_id TEXT PRIMARY KEY,
                product_id           TEXT NOT NULL,
                store                INTEGER NOT NULL,
                raw_response         TEXT NOT NULL DEFAULT '{}',
                purchase_time        REAL NOT NULL,
                create_time          REAL NOT NULL,
                update_time          REAL NOT NULL,
                expire_time          REAL NOT NULL DEFAULT 0,
                refund_time          REAL NOT NULL DEFAULT 0,
                environment          INTEGER NOT NULL DEFAULT 0
            )
            """,
            "CREATE INDEX IF NOT EXISTS subscription_user_idx ON subscription (user_id, purchase_time)",
        ],
    ),
    (
        6,
        "purchase-receipts",
        [
            # reference migrate/sql purchase_receipt: the raw store
            # receipt blob keyed by transaction, kept for re-validation
            # and refund audits.
            """
            CREATE TABLE IF NOT EXISTS purchase_receipt (
                transaction_id TEXT PRIMARY KEY,
                user_id        TEXT NOT NULL,
                store          INTEGER NOT NULL,
                receipt        TEXT NOT NULL,
                create_time    REAL NOT NULL
            )
            """,
            "CREATE INDEX IF NOT EXISTS purchase_receipt_user_idx ON purchase_receipt (user_id, create_time)",
        ],
    ),
    (
        7,
        "matchmaker-journal",
        [
            # Crash-recovery plane (recovery.py): the append-only ticket
            # journal — one row per MatchmakerAdd/remove/matched outcome,
            # LSN-ordered, written through the group-commit write
            # pipeline — and the per-node checkpoint pointer row naming
            # the snapshot file + the LSN it covers (journal rows at or
            # below it are redundant and truncated with the pointer
            # update, in one atomic unit).
            """
            CREATE TABLE IF NOT EXISTS matchmaker_journal (
                lsn        INTEGER NOT NULL,
                op         TEXT NOT NULL,
                payload    TEXT NOT NULL,
                node       TEXT NOT NULL DEFAULT '',
                created_at REAL NOT NULL,
                PRIMARY KEY (node, lsn)
            )
            """,
            """
            CREATE TABLE IF NOT EXISTS matchmaker_checkpoint (
                node       TEXT PRIMARY KEY,
                lsn        INTEGER NOT NULL,
                path       TEXT NOT NULL,
                tickets    INTEGER NOT NULL,
                created_at REAL NOT NULL
            )
            """,
        ],
    ),
]

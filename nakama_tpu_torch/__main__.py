"""CLI dispatch (reference main.go:64): `--version`, `migrate
up|down|redo|status`, `check`, else run the server.

    python -m nakama_tpu_torch --socket.port 7350 ...

The server's matchmaker runs on the card (`matchmaker.backend` "cuda",
the default) unless `--matchmaker.backend cpu` asks for the host oracle.
`--runtime.path DIR` loads the `.py`, `.lua` and `.js` modules of DIR
(their rpcs, hooks and matches) when the server starts;
`--runtime.http_key` is the key of server-to-server `/v2/rpc` calls.
"""

from __future__ import annotations

import asyncio
import sys


def _migrate(argv: list[str]) -> int:
    """`migrate up|down|redo|status` against the configured database
    (reference migrate/migrate.go:104-111 CLI). `down`/`redo` revert the
    newest applied migration."""
    from .config import parse_args
    from .storage import make_database
    from .storage.db import migrate_status

    sub = argv[0] if argv else "status"
    config = parse_args(argv[1:])
    db = make_database((config.database.address or [":memory:"])[0])

    async def run():
        from .storage.migrations import MIGRATIONS

        if sub == "up":
            await db.connect()  # connect applies pending migrations
        elif sub in ("down", "redo"):
            await db.connect(migrate=False)
            reverted = await db.migrate_down(1)
            for name in reverted:
                print(f"reverted {name}")
            if sub == "redo":
                for name in await db.migrate():
                    print(f"re-applied {name}")
        elif sub == "status":
            # Status is read-only: connect WITHOUT applying, then report
            # pending entries from the embedded migration list.
            await db.connect(migrate=False)
        else:
            print(f"unknown migrate subcommand: {sub}", file=sys.stderr)
            return 2
        try:
            applied = {r["version"]: r for r in await migrate_status(db)}
        except Exception:
            applied = {}
        for version, name, _ in MIGRATIONS:
            state = "applied" if version in applied else "pending"
            print(f"{version:>3}  {name:<24} {state}")
        await db.close()
        return 0

    return asyncio.run(run())


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--version":
        from . import __version__

        print(__version__)
        return 0
    if argv and argv[0] == "migrate":
        return _migrate(argv[1:])
    if argv and argv[0] == "check":
        from .config import parse_args

        config = parse_args(argv[1:])
        warnings = config.check()
        for warning in warnings:
            print(f"warning: {warning}")
        print("config ok" + (f" ({len(warnings)} warnings)" if warnings else ""))
        return 0
    from .server import main as server_main

    server_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

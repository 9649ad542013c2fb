"""Leaderboard definitions cache + record operations.

Parity: reference server/leaderboard_cache.go:148 (definitions in RAM,
loaded at boot), server/core_leaderboard.go (record writes with operator
semantics best/set/incr/decr, cursored listings, haystack around-owner
queries, owner record deletes). Records carry the period's expiry time;
a reset rolls expiry forward so old rows age out of every query that
filters on expiry (the reference's scheme — history stays queryable by
passing an explicit expiry).
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field

from ..storage.db import (
    OCC_RETRIES,
    Database,
    UniqueViolationError,
    WriteConflictError,
)
from ..utils import cronexpr
from .rank_cache import LeaderboardRankCache

SORT_ASC = 0
SORT_DESC = 1
OP_BEST = 0
OP_SET = 1
OP_INCR = 2
OP_DECR = 3

_OPERATORS = {"best": OP_BEST, "set": OP_SET, "incr": OP_INCR,
              "increment": OP_INCR, "decr": OP_DECR, "decrement": OP_DECR}
_SORTS = {"asc": SORT_ASC, "ascending": SORT_ASC, "desc": SORT_DESC,
          "descending": SORT_DESC}


class LeaderboardError(Exception):
    def __init__(self, message: str, code: str = "invalid"):
        super().__init__(message)
        self.code = code


@dataclass
class Leaderboard:
    id: str
    authoritative: bool = False
    sort_order: int = SORT_DESC
    operator: int = OP_BEST
    reset_schedule: str | None = None
    metadata: dict = field(default_factory=dict)
    create_time: float = 0.0
    # Tournament-only columns (reference 20180805174141-tournaments.sql).
    category: int = 0
    description: str = ""
    duration: int = 0
    end_time: float = 0.0
    join_required: bool = False
    max_size: int = 0
    max_num_score: int = 0
    start_time: float = 0.0
    title: str = ""

    @property
    def is_tournament(self) -> bool:
        return self.duration > 0

    def expiry_at(self, now: float) -> float:
        """Expiry bucket a record written at `now` belongs to: the next
        reset after now; 0 when the board never resets."""
        if not self.reset_schedule:
            return 0.0
        return cronexpr.parse(self.reset_schedule).next(now)

    def as_dict(self) -> dict:
        return {
            "id": self.id,
            "authoritative": self.authoritative,
            "sort_order": self.sort_order,
            "operator": self.operator,
            "reset_schedule": self.reset_schedule or "",
            "metadata": self.metadata,
            "create_time": self.create_time,
            "category": self.category,
            "description": self.description,
            "duration": self.duration,
            "end_time": self.end_time,
            "join_required": self.join_required,
            "max_size": self.max_size,
            "max_num_score": self.max_num_score,
            "start_time": self.start_time,
            "title": self.title,
        }


def _op_value(operator) -> int:
    if isinstance(operator, str):
        try:
            return _OPERATORS[operator.lower()]
        except KeyError:
            raise LeaderboardError(f"unknown operator {operator!r}")
    return int(operator)


def _sort_value(sort_order) -> int:
    if isinstance(sort_order, str):
        try:
            return _SORTS[sort_order.lower()]
        except KeyError:
            raise LeaderboardError(f"unknown sort order {sort_order!r}")
    return int(sort_order)


class Leaderboards:
    """Cache + core ops (the API layer, nk module, and scheduler all come
    through here)."""

    def __init__(
        self,
        logger,
        db: Database,
        rank_cache: LeaderboardRankCache | None = None,
        device_engine=None,
    ):
        self.logger = logger.with_fields(subsystem="leaderboard")
        self.db = db
        self.ranks = rank_cache or LeaderboardRankCache()
        # Device rank engine (device.DeviceRankEngine, optional): large
        # boards mirror onto the device for batched reads; the rank
        # cache above stays the oracle and the breaker-routed fallback
        # (every device read helper returns None -> host serves).
        self.device = device_engine
        self._cache: dict[str, Leaderboard] = {}
        # Fired after any definition change so the reset scheduler can
        # re-arm (reference leaderboardScheduler.Update call sites).
        self.on_change = None

    # ------------------------------------------------------- routed reads

    def _rank_get(self, id: str, expiry: float, owner_id: str) -> int:
        if self.device is not None:
            ranks = self.device.get_many(id, expiry, [owner_id])
            if ranks is not None:
                return ranks[0]
        return self.ranks.get(id, expiry, owner_id)

    def _rank_get_many(
        self, id: str, expiry: float, owner_ids: list[str]
    ) -> list[int]:
        if self.device is not None:
            ranks = self.device.get_many(id, expiry, owner_ids)
            if ranks is not None:
                return ranks
        return self.ranks.get_many(id, expiry, owner_ids)

    def _rank_window(
        self, id: str, expiry: float, start: int, limit: int
    ) -> list[tuple[str, int]]:
        if self.device is not None:
            window = self.device.rank_window(id, expiry, start, limit)
            if window is not None:
                return window
        return self.ranks.rank_window(id, expiry, start, limit)

    def reward_sweep(self, id: str, expiry: float) -> list[dict]:
        """Final standings of one (board, expiry) bucket — the
        end-of-tournament reward sweep. Device path: a segmented sort
        over the board axis (engine.sweep_many); host fallback walks
        the oracle's sorted array."""
        if self.device is not None:
            swept = self.device.sweep_many([(id, expiry)])
            standings = swept.get((id, expiry))
            if standings is not None:
                return standings
        return self.ranks.standings(id, expiry)

    def clear_rank_state(self):
        """Drop every rank structure, host and device (console
        DeleteAllData)."""
        self.ranks.clear_all()
        if self.device is not None:
            self.device.clear_all()

    # -------------------------------------------------------------- cache

    async def load(self):
        """Bootstrap definitions (+rank cache) from the DB (reference
        NewLocalLeaderboardCache + rank preload goroutine)."""
        rows = await self.db.fetch_all("SELECT * FROM leaderboard")
        self._cache = {r["id"]: self._row_to_lb(r) for r in rows}
        now = time.time()
        for lb in self._cache.values():
            expiry = lb.expiry_at(now)
            records = await self.db.fetch_all(
                "SELECT owner_id, score, subscore FROM leaderboard_record"
                " WHERE leaderboard_id = ? AND expiry_time = ?"
                " ORDER BY update_time",
                (lb.id, expiry),
            )
            for r in records:
                self.ranks.insert(
                    lb.id, expiry, lb.sort_order,
                    r["owner_id"], r["score"], r["subscore"],
                )
                if self.device is not None:
                    self.device.record_upsert(
                        lb.id, expiry, lb.sort_order, r["owner_id"]
                    )
        self.logger.info("leaderboards loaded", count=len(self._cache))

    def get(self, id: str) -> Leaderboard | None:
        return self._cache.get(id)

    def list(
        self, categories: list[int] | None = None, with_tournaments=False
    ) -> list[Leaderboard]:
        out = []
        for lb in self._cache.values():
            if lb.is_tournament and not with_tournaments:
                continue
            if categories and lb.category not in categories:
                continue
            out.append(lb)
        return sorted(out, key=lambda lb: lb.id)

    # --------------------------------------------------------------- CRUD

    async def create(
        self,
        id: str,
        *,
        authoritative: bool = False,
        sort_order="desc",
        operator="best",
        reset_schedule: str | None = None,
        metadata: dict | None = None,
        **tournament_fields,
    ) -> Leaderboard:
        if not id:
            id = str(uuid.uuid4())
        if reset_schedule:
            cronexpr.parse(reset_schedule)  # validate
        existing = self._cache.get(id)
        if existing is not None:
            return existing  # reference: create is idempotent
        lb = Leaderboard(
            id=id,
            authoritative=bool(authoritative),
            sort_order=_sort_value(sort_order),
            operator=_op_value(operator),
            reset_schedule=reset_schedule,
            metadata=metadata or {},
            create_time=time.time(),
            **tournament_fields,
        )
        await self.db.execute(
            "INSERT OR IGNORE INTO leaderboard (id, authoritative,"
            " sort_order, operator, reset_schedule, metadata, create_time,"
            " category, description, duration, end_time, join_required,"
            " max_size, max_num_score, start_time, title)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                lb.id, int(lb.authoritative), lb.sort_order, lb.operator,
                lb.reset_schedule, json.dumps(lb.metadata), lb.create_time,
                lb.category, lb.description, lb.duration, lb.end_time,
                int(lb.join_required), lb.max_size, lb.max_num_score,
                lb.start_time, lb.title,
            ),
        )
        self._cache[lb.id] = lb
        if self.on_change is not None:
            self.on_change()
        return lb

    async def delete(self, id: str):
        if id not in self._cache:
            raise LeaderboardError("leaderboard not found", "not_found")
        async with self.db.tx() as tx:
            await tx.execute("DELETE FROM leaderboard WHERE id = ?", (id,))
            await tx.execute(
                "DELETE FROM leaderboard_record WHERE leaderboard_id = ?",
                (id,),
            )
        self._cache.pop(id, None)
        self.ranks.delete_leaderboard(id)
        if self.device is not None:
            self.device.delete_board(id)
        if self.on_change is not None:
            self.on_change()

    # ------------------------------------------------------------ records

    async def record_write(
        self,
        id: str,
        owner_id: str,
        username: str = "",
        score: int = 0,
        subscore: int = 0,
        metadata: dict | None = None,
        override_operator=None,
        caller_authoritative: bool = True,
        expiry_override: float | None = None,
        max_num_score: int = 0,
    ) -> dict:
        """Reference LeaderboardRecordWrite (core_leaderboard.go): apply the
        board's operator against the owner's current record in the current
        expiry period."""
        lb = self._cache.get(id)
        if lb is None:
            raise LeaderboardError("leaderboard not found", "not_found")
        if lb.authoritative and not caller_authoritative:
            raise LeaderboardError(
                "leaderboard only accepts authoritative writes",
                "permission_denied",
            )
        operator = (
            _op_value(override_operator)
            if override_operator is not None
            else lb.operator
        )
        now = time.time()
        expiry = (
            expiry_override if expiry_override is not None
            else lb.expiry_at(now)
        )

        _SELECT = (
            "SELECT score, subscore, num_score, metadata, create_time,"
            " max_num_score FROM leaderboard_record"
            " WHERE leaderboard_id = ? AND expiry_time = ?"
            " AND owner_id = ?"
        )

        def _plan(row):
            """Apply the operator against `row`; returns the new record
            fields (shared by the batched OCC path and the tx path)."""
            if row is None or row["num_score"] == 0:
                # No previous SCORE: a num_score=0 row is a tournament
                # join marker (Tournaments.join), not a submission — the
                # first real score must not be "bested" by its 0/0.
                new_score, new_sub = score, subscore
                num_score = 1
                create_time = row["create_time"] if row else now
                rank_changed = True
            else:
                num_score = row["num_score"] + 1
                create_time = row["create_time"]
                cur = (row["score"], row["subscore"])
                if operator == OP_SET:
                    new_score, new_sub = score, subscore
                elif operator == OP_INCR:
                    new_score, new_sub = cur[0] + score, cur[1] + subscore
                elif operator == OP_DECR:
                    new_score, new_sub = cur[0] - score, cur[1] - subscore
                else:  # best by sort direction
                    if lb.sort_order == SORT_DESC:
                        new_score, new_sub = max((score, subscore), cur)
                    else:
                        new_score, new_sub = min((score, subscore), cur)
                rank_changed = (new_score, new_sub) != cur
            # Per-record override first (TournamentAddAttempt writes it),
            # then the caller's, then the board default.
            row_max = row["max_num_score"] if row else 0
            limit = row_max or max_num_score or lb.max_num_score
            if limit and row is not None and row["num_score"] >= limit:
                raise LeaderboardError(
                    "maximum number of score attempts reached",
                    "invalid",
                )
            meta_json = (
                json.dumps(metadata)
                if metadata is not None
                else (row["metadata"] if row else "{}")
            )
            return new_score, new_sub, num_score, create_time, (
                rank_changed
            ), limit, meta_json

        done = False
        if getattr(self.db, "group_commit", False):
            # Hot path (score submits): optimistic read + one guarded
            # write through the group-commit pipeline, so concurrent
            # submits share a WAL commit. A fresh record INSERTs (a
            # first-writer race trips the PK -> retry); an existing one
            # UPDATEs guarded on the num_score read (a concurrent
            # submit bumps it -> zero rows -> unit rollback -> retry).
            for _ in range(OCC_RETRIES):
                row = await self.db.fetch_one(
                    _SELECT, (id, expiry, owner_id)
                )
                (new_score, new_sub, num_score, create_time,
                 rank_changed, limit, meta_json) = _plan(row)
                try:
                    if row is None:
                        await self.db.submit_write(
                            [(
                                "INSERT INTO leaderboard_record"
                                " (leaderboard_id, owner_id, username,"
                                " score, subscore, num_score, metadata,"
                                " create_time, update_time, expiry_time,"
                                " max_num_score)"
                                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                                (
                                    id, owner_id, username, new_score,
                                    new_sub, num_score, meta_json,
                                    create_time, now, expiry, limit,
                                ),
                            )]
                        )
                    else:
                        await self.db.submit_write(
                            [(
                                "UPDATE leaderboard_record SET score = ?,"
                                " subscore = ?, num_score = ?,"
                                " metadata = ?, username = ?,"
                                " update_time = ?"
                                " WHERE leaderboard_id = ?"
                                " AND expiry_time = ? AND owner_id = ?"
                                " AND num_score = ?",
                                (
                                    new_score, new_sub, num_score,
                                    meta_json, username, now,
                                    id, expiry, owner_id,
                                    row["num_score"],
                                ),
                            )],
                            guards=[True],
                        )
                    done = True
                    break
                except (WriteConflictError, UniqueViolationError):
                    continue
        if not done:
            async with self.db.tx() as tx:
                row = await tx.fetch_one(_SELECT, (id, expiry, owner_id))
                (new_score, new_sub, num_score, create_time,
                 rank_changed, limit, meta_json) = _plan(row)
                await tx.execute(
                    "INSERT INTO leaderboard_record (leaderboard_id,"
                    " owner_id, username, score, subscore, num_score,"
                    " metadata, create_time, update_time, expiry_time,"
                    " max_num_score)"
                    " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)"
                    " ON CONFLICT (leaderboard_id, expiry_time, owner_id) DO"
                    " UPDATE SET score = ?, subscore = ?, num_score = ?,"
                    " metadata = ?, username = ?, update_time = ?",
                    (
                        id, owner_id, username, new_score, new_sub,
                        num_score, meta_json, create_time, now, expiry,
                        limit,
                        new_score, new_sub, num_score, meta_json,
                        username, now,
                    ),
                )
        if rank_changed:
            rank = self.ranks.insert(
                id, expiry, lb.sort_order, owner_id, new_score, new_sub
            )
            if self.device is not None:
                self.device.record_upsert(
                    id, expiry, lb.sort_order, owner_id
                )
        else:
            # A no-op "best" write must not bump the tie-break sequence —
            # that would demote the owner behind equal-scored peers.
            rank = self.ranks.get(id, expiry, owner_id)
        return {
            "leaderboard_id": id,
            "owner_id": owner_id,
            "username": username,
            "score": new_score,
            "subscore": new_sub,
            "num_score": num_score,
            "metadata": json.loads(meta_json),
            "create_time": create_time,
            "update_time": now,
            "expiry_time": expiry,
            "rank": rank + 1 if rank >= 0 else 0,
        }

    def _order_sql(self, lb: Leaderboard) -> str:
        d = "DESC" if lb.sort_order == SORT_DESC else "ASC"
        return (
            f"ORDER BY score {d}, subscore {d}, update_time ASC,"
            " owner_id ASC"
        )

    async def records_list(
        self,
        id: str,
        limit: int = 100,
        cursor: str = "",
        owner_ids: list[str] | None = None,
        expiry_override: float | None = None,
    ) -> dict:
        """Cursored listing + optional owner filter (reference
        LeaderboardRecordsList). Ranks come from the rank cache in one
        batched query."""
        lb = self._cache.get(id)
        if lb is None:
            raise LeaderboardError("leaderboard not found", "not_found")
        limit = max(1, min(int(limit), 1000))
        now = time.time()
        expiry = (
            expiry_override if expiry_override is not None
            else lb.expiry_at(now)
        )
        params: list = [id, expiry]
        where = "WHERE leaderboard_id = ? AND expiry_time = ?"
        if owner_ids:
            where += (
                " AND owner_id IN ("
                + ",".join("?" * len(owner_ids))
                + ")"
            )
            params.extend(owner_ids)
        offset = 0
        if cursor:
            try:
                offset = max(0, int(cursor))
            except ValueError:
                raise LeaderboardError("invalid cursor")
        if owner_ids:
            # The primary key finds the named owners' rows; with the ORDER
            # BY the planner walks the rank index over every record of
            # the period instead (136 ms a haystack at 100,000 records,
            # PERF.md). The same order, applied here.
            sign = -1 if lb.sort_order == SORT_DESC else 1
            rows = sorted(
                await self.db.fetch_all(
                    f"SELECT * FROM leaderboard_record {where}", params
                ),
                key=lambda r: (
                    sign * r["score"], sign * r["subscore"],
                    r["update_time"], r["owner_id"],
                ),
            )[offset:offset + limit + 1]
        else:
            rows = await self.db.fetch_all(
                f"SELECT * FROM leaderboard_record {where} "
                + self._order_sql(lb)
                + " LIMIT ? OFFSET ?",
                (*params, limit + 1, offset),
            )
        has_more = len(rows) > limit
        rows = rows[:limit]
        records = [self._row_to_record(r) for r in rows]
        owners = [r["owner_id"] for r in records]
        ranks = self._rank_get_many(id, expiry, owners)
        for pos, (record, rank) in enumerate(zip(records, ranks)):
            # Cache miss (blacklisted board): the page position is the rank
            # since the SQL order IS the rank order.
            record["rank"] = rank + 1 if rank >= 0 else offset + pos + 1
        return {
            "records": records,
            "next_cursor": str(offset + limit) if has_more else "",
            "prev_cursor": str(max(0, offset - limit)) if offset else "",
        }

    async def records_haystack(
        self,
        id: str,
        owner_id: str,
        limit: int = 100,
        expiry_override: float | None = None,
    ) -> dict:
        """Window centred on the owner's rank (reference getLeaderboard
        RecordsHaystack): batched rank-window query on the cache, hydrated
        from the DB."""
        lb = self._cache.get(id)
        if lb is None:
            raise LeaderboardError("leaderboard not found", "not_found")
        now = time.time()
        expiry = (
            expiry_override if expiry_override is not None
            else lb.expiry_at(now)
        )
        rank = self._rank_get(id, expiry, owner_id)
        if rank < 0:
            return {"records": [], "next_cursor": "", "prev_cursor": ""}
        start = max(0, rank - limit // 2)
        window = self._rank_window(id, expiry, start, limit)
        if not window:
            return {"records": [], "next_cursor": "", "prev_cursor": ""}
        owners = [o for o, _ in window]
        listing = await self.records_list(
            id, limit=len(owners), owner_ids=owners,
            expiry_override=expiry,
        )
        rank_of = {o: r for o, r in window}
        for record in listing["records"]:
            record["rank"] = rank_of.get(record["owner_id"], -1) + 1
        listing["records"].sort(key=lambda r: r["rank"])
        listing["next_cursor"] = str(start + len(owners))
        listing["prev_cursor"] = str(max(0, start - limit))
        return listing

    async def record_delete(
        self, id: str, owner_id: str, caller_authoritative: bool = True
    ):
        lb = self._cache.get(id)
        if lb is None:
            raise LeaderboardError("leaderboard not found", "not_found")
        if (lb.authoritative or lb.is_tournament) and (
            not caller_authoritative
        ):
            # Clients cannot rewrite server-controlled standings
            # (reference LeaderboardRecordDelete authoritative gate;
            # tournament records are never client-deletable).
            raise LeaderboardError(
                "leaderboard records can only be deleted by the server",
                "permission_denied",
            )
        expiry = lb.expiry_at(time.time())
        deleted = await self.db.execute(
            "DELETE FROM leaderboard_record WHERE leaderboard_id = ?"
            " AND expiry_time = ? AND owner_id = ?",
            (id, expiry, owner_id),
        )
        self.ranks.delete(id, expiry, owner_id)
        if self.device is not None:
            self.device.record_delete(id, expiry, owner_id)
        return bool(deleted)

    async def records_around_owner(self, *a, **kw):
        return await self.records_haystack(*a, **kw)

    # -------------------------------------------------------------- utils

    def _row_to_lb(self, r: dict) -> Leaderboard:
        return Leaderboard(
            id=r["id"],
            authoritative=bool(r["authoritative"]),
            sort_order=r["sort_order"],
            operator=r["operator"],
            reset_schedule=r["reset_schedule"],
            metadata=json.loads(r["metadata"] or "{}"),
            create_time=r["create_time"],
            category=r["category"],
            description=r["description"],
            duration=r["duration"],
            end_time=r["end_time"],
            join_required=bool(r["join_required"]),
            max_size=r["max_size"],
            max_num_score=r["max_num_score"],
            start_time=r["start_time"],
            title=r["title"],
        )

    @staticmethod
    def _row_to_record(r: dict) -> dict:
        return {
            "leaderboard_id": r["leaderboard_id"],
            "owner_id": r["owner_id"],
            "username": r["username"] or "",
            "score": r["score"],
            "subscore": r["subscore"],
            "num_score": r["num_score"],
            "metadata": json.loads(r["metadata"] or "{}"),
            "create_time": r["create_time"],
            "update_time": r["update_time"],
            "expiry_time": r["expiry_time"],
        }

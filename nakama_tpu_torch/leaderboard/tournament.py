"""Tournaments — leaderboards with activity windows, join gating, size
caps, and score-attempt limits.

Parity: reference server/core_tournament.go (create/join/list, active
window from start_time/duration/reset cron, max_size with joined count,
join_required gating writes, max_num_score attempt caps) — tournament
state rides the leaderboard table's tournament columns
(migrate/sql/20180805174141-tournaments.sql).
"""

from __future__ import annotations

import time

from ..utils import cronexpr
from .core import LeaderboardError, Leaderboards


class TournamentError(LeaderboardError):
    pass


class Tournaments:
    def __init__(self, leaderboards: Leaderboards):
        self.lb = leaderboards
        self.db = leaderboards.db
        self.logger = leaderboards.logger.with_fields(
            subsystem="tournament"
        )
        # tournament id -> set of joined owner ids (size enforcement);
        # persisted via a leaderboard_record with num_score=0 for join-only
        # members, so it reloads from the DB.
        self._joined: dict[str, set[str]] = {}

    # --------------------------------------------------------------- CRUD

    async def create(
        self,
        id: str,
        *,
        title: str = "",
        description: str = "",
        category: int = 0,
        sort_order="desc",
        operator="best",
        duration: int = 0,
        reset_schedule: str | None = None,
        metadata: dict | None = None,
        join_required: bool = False,
        max_size: int = 0,
        max_num_score: int = 0,
        start_time: float = 0.0,
        end_time: float = 0.0,
        authoritative: bool = True,
    ):
        if duration <= 0:
            raise TournamentError("tournament duration must be > 0")
        if end_time and start_time and end_time < start_time:
            raise TournamentError("end_time before start_time")
        lb = await self.lb.create(
            id,
            authoritative=authoritative,
            sort_order=sort_order,
            operator=operator,
            reset_schedule=reset_schedule,
            metadata=metadata,
            title=title,
            description=description,
            category=category,
            duration=duration,
            join_required=bool(join_required),
            max_size=max_size,
            max_num_score=max_num_score,
            start_time=start_time or time.time(),
            end_time=end_time,
        )
        return lb

    async def delete(self, id: str):
        t = self._get(id)
        await self.lb.delete(t.id)
        self._joined.pop(id, None)

    def _get(self, id: str):
        lb = self.lb.get(id)
        if lb is None or not lb.is_tournament:
            raise TournamentError("tournament not found", "not_found")
        return lb

    # ------------------------------------------------------------ windows

    def active_window(self, t, now: float) -> tuple[float, float]:
        """Current active period [start, end) (reference
        calculateTournamentDeadlines): the period starts at the last reset
        (or start_time) and runs `duration` seconds."""
        if now < t.start_time:
            return (t.start_time, t.start_time + t.duration)
        if t.reset_schedule:
            sched = cronexpr.parse(t.reset_schedule)
            period_start = sched.prev(now)
            if not period_start or period_start < t.start_time:
                period_start = t.start_time
        else:
            period_start = t.start_time
        period_end = period_start + t.duration
        if t.end_time and period_end > t.end_time:
            period_end = t.end_time
        return (period_start, period_end)

    def is_active(self, t, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        if t.end_time and now >= t.end_time:
            return False
        start, end = self.active_window(t, now)
        return start <= now < end

    # --------------------------------------------------------------- join

    async def _load_joined(self, t) -> set[str]:
        joined = self._joined.get(t.id)
        if joined is None:
            rows = await self.db.fetch_all(
                "SELECT DISTINCT owner_id FROM leaderboard_record"
                " WHERE leaderboard_id = ?",
                (t.id,),
            )
            joined = {r["owner_id"] for r in rows}
            self._joined[t.id] = joined
        return joined

    async def join(self, id: str, owner_id: str, username: str = ""):
        t = self._get(id)
        now = time.time()
        if not self.is_active(t, now):
            raise TournamentError("tournament not active")
        joined = await self._load_joined(t)
        if owner_id in joined:
            return
        if t.max_size and len(joined) >= t.max_size:
            raise TournamentError("tournament is full")
        expiry = t.expiry_at(now)
        # Membership marker: a record with num_score=0 (no score yet).
        await self.db.execute(
            "INSERT OR IGNORE INTO leaderboard_record (leaderboard_id,"
            " owner_id, username, score, subscore, num_score, metadata,"
            " create_time, update_time, expiry_time, max_num_score)"
            " VALUES (?, ?, ?, 0, 0, 0, '{}', ?, ?, ?, ?)",
            (t.id, owner_id, username, now, now, expiry, t.max_num_score),
        )
        joined.add(owner_id)

    # ------------------------------------------------------------- scores

    async def record_write(
        self,
        id: str,
        owner_id: str,
        username: str = "",
        score: int = 0,
        subscore: int = 0,
        metadata: dict | None = None,
        caller_authoritative: bool = True,
    ) -> dict:
        t = self._get(id)
        now = time.time()
        if not self.is_active(t, now):
            raise TournamentError("tournament not active")
        if t.join_required:
            joined = await self._load_joined(t)
            if owner_id not in joined:
                raise TournamentError(
                    "must join tournament before submitting scores",
                    "permission_denied",
                )
        if t.max_size:
            joined = await self._load_joined(t)
            if owner_id not in joined and len(joined) >= t.max_size:
                raise TournamentError("tournament is full")
        result = await self.lb.record_write(
            id,
            owner_id,
            username,
            score,
            subscore,
            metadata,
            caller_authoritative=caller_authoritative,
            max_num_score=t.max_num_score,
        )
        joined = await self._load_joined(t)
        joined.add(owner_id)
        return result

    async def records_list(self, id: str, **kw) -> dict:
        self._get(id)
        return await self.lb.records_list(id, **kw)

    async def records_haystack(self, id: str, owner_id: str, **kw) -> dict:
        """Around-owner window on a tournament (reference
        TournamentRecordsHaystack, core_tournament.go:687)."""
        self._get(id)
        return await self.lb.records_haystack(id, owner_id, **kw)

    async def add_attempt(self, id: str, owner_id: str, count: int):
        """Grant extra score attempts to one owner by raising the
        per-record max_num_score override (reference TournamentAddAttempt,
        core_tournament.go; record_write prefers the record's own limit)."""
        t = self._get(id)
        expiry = t.expiry_at(time.time())
        row = await self.db.fetch_one(
            "SELECT num_score, max_num_score FROM leaderboard_record"
            " WHERE leaderboard_id = ? AND expiry_time = ? AND owner_id = ?",
            (id, expiry, owner_id),
        )
        if row is None:
            raise TournamentError("tournament record not found", "not_found")
        base = row["max_num_score"] or t.max_num_score
        await self.db.execute(
            "UPDATE leaderboard_record SET max_num_score = ?"
            " WHERE leaderboard_id = ? AND expiry_time = ? AND owner_id = ?",
            (max(1, base + int(count)), id, expiry, owner_id),
        )

    async def record_delete(
        self, id: str, owner_id: str, caller_authoritative: bool = False
    ):
        """Delete the owner's record in the current window (reference
        TournamentRecordDelete, core_tournament.go:661: clients may
        delete their own record unless the tournament is authoritative)."""
        t = self._get(id)
        if t.authoritative and not caller_authoritative:
            raise TournamentError(
                "tournament records can only be deleted by the server",
                "permission_denied",
            )
        expiry = t.expiry_at(time.time())
        await self.db.execute(
            "DELETE FROM leaderboard_record WHERE leaderboard_id = ?"
            " AND expiry_time = ? AND owner_id = ?",
            (id, expiry, owner_id),
        )
        self.lb.ranks.delete(id, expiry, owner_id)
        if self.lb.device is not None:
            self.lb.device.record_delete(id, expiry, owner_id)

    # ------------------------------------------------------------- rewards

    def reward_sweep(
        self, id: str, expiry_override: float | None = None
    ) -> list[dict]:
        """Final standings of the tournament's current (or given)
        expiry bucket — the end-of-tournament reward sweep (reference
        tournament-end hooks walk records; here one segmented device
        sort, oracle fallback). Each entry: owner_id, 1-based rank,
        score, subscore."""
        t = self._get(id)
        now = time.time()
        if expiry_override is not None:
            expiry = expiry_override
        elif t.end_time and now >= t.end_time:
            # After the end the "current" cron bucket has moved on;
            # sweep the bucket the final window's records live in.
            expiry = t.expiry_at(max(t.start_time, t.end_time - 1e-3))
        else:
            expiry = t.expiry_at(now)
        return self.lb.reward_sweep(id, expiry)

    # --------------------------------------------------------------- list

    def list(
        self,
        categories: list[int] | None = None,
        active_only: bool = False,
        now: float | None = None,
    ) -> list[dict]:
        now = time.time() if now is None else now
        out = []
        for lb in self.lb.list(categories=categories, with_tournaments=True):
            if not lb.is_tournament:
                continue
            if active_only and not self.is_active(lb, now):
                continue
            d = lb.as_dict()
            start, end = self.active_window(lb, now)
            d["can_enter"] = self.is_active(lb, now)
            d["next_reset"] = (
                cronexpr.parse(lb.reset_schedule).next(now)
                if lb.reset_schedule
                else 0
            )
            d["current_start"] = start
            d["current_end"] = end
            out.append(d)
        return out

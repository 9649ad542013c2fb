"""Timer-driven leaderboard/tournament reset + end scheduler.

Parity: reference server/leaderboard_scheduler.go:36 — one timer armed at
the earliest upcoming reset or tournament end across all cached
definitions; on fire it invokes the runtime's leaderboard-reset /
tournament-reset / tournament-end hooks and trims the expired rank-cache
buckets, then re-arms.
"""

from __future__ import annotations

import asyncio
import time

from ..utils import cronexpr
from .core import Leaderboards
from .tournament import Tournaments


class LeaderboardScheduler:
    def __init__(
        self,
        logger,
        leaderboards: Leaderboards,
        tournaments: Tournaments | None = None,
        runtime=None,
    ):
        self.logger = logger.with_fields(subsystem="leaderboard.scheduler")
        self.lb = leaderboards
        self.tournaments = tournaments
        self.runtime = runtime
        self._task: asyncio.Task | None = None
        self._wake = asyncio.Event()
        self._fired_resets: dict[str, float] = {}
        self._fired_ends: set[str] = set()

    def start(self):
        if self._task is None:
            # Boundaries that passed before boot were handled (or are
            # unknowable) — baseline them so the first fire doesn't replay
            # a pre-boot reset (e.g. double reward grants after restart).
            now = time.time()
            for lb in self.lb.list(with_tournaments=True):
                if lb.reset_schedule:
                    last = cronexpr.parse(lb.reset_schedule).prev(now)
                    if last:
                        self._fired_resets[lb.id] = last
                if lb.is_tournament and lb.end_time and lb.end_time <= now:
                    self._fired_ends.add(lb.id)
            self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def update(self):
        """Re-arm after definitions change (reference Update)."""
        self._wake.set()

    # ------------------------------------------------------------ internal

    def _next_fire(self, now: float) -> float | None:
        soonest: float | None = None
        for lb in self.lb.list(with_tournaments=True):
            if lb.reset_schedule:
                nxt = cronexpr.parse(lb.reset_schedule).next(now)
                if nxt and (soonest is None or nxt < soonest):
                    soonest = nxt
            if (
                lb.is_tournament
                and lb.end_time
                and lb.end_time > now
                and (soonest is None or lb.end_time < soonest)
            ):
                soonest = lb.end_time
        return soonest

    async def _run(self):
        while True:
            now = time.time()
            fire_at = self._next_fire(now)
            delay = 3600.0 if fire_at is None else max(0.05, fire_at - now)
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=delay)
                continue  # woken by update(): recompute
            except asyncio.TimeoutError:
                pass
            await self._fire(time.time())

    async def _fire(self, now: float):
        for lb in self.lb.list(with_tournaments=True):
            try:
                if lb.reset_schedule:
                    sched = cronexpr.parse(lb.reset_schedule)
                    last = sched.prev(now)
                    if last and self._fired_resets.get(lb.id) != last:
                        self._fired_resets[lb.id] = last
                        await self._on_reset(lb, last)
                if (
                    lb.is_tournament
                    and lb.end_time
                    and now >= lb.end_time
                    and lb.id not in self._fired_ends
                ):
                    self._fired_ends.add(lb.id)
                    await self._on_end(lb)
            except Exception as e:
                self.logger.error(
                    "scheduler fire error", id=lb.id, error=str(e)
                )
        self.lb.ranks.trim_expired(now)
        if self.lb.device is not None:
            # Device boards ride the same expiry buckets: a reset rolls
            # them out of every read path, so their columns free here.
            self.lb.device.trim_expired(now)

    def _sweep(self, lb, expiry: float) -> list[dict]:
        """Reward sweep of the closing bucket: final standings computed
        as one segmented device sort (oracle fallback), handed to the
        reset/end hooks so reward grants never re-walk the records."""
        try:
            return self.lb.reward_sweep(lb.id, expiry)
        except Exception as e:
            self.logger.warn(
                "reward sweep failed", id=lb.id, error=str(e)
            )
            return []

    async def _on_reset(self, lb, reset_time: float):
        self.logger.info("leaderboard reset", id=lb.id)
        if self.runtime is None:
            return
        hook = (
            self.runtime.tournament_reset()
            if lb.is_tournament
            else self.runtime.leaderboard_reset()
        )
        if hook is None:
            return
        # Records written during the closing period carry this reset
        # boundary as their expiry bucket — sweep it before trim drops
        # it from the rank structures. Only with a hook to hand it to:
        # the sweep is a full-board sort, not a free side effect.
        payload = lb.as_dict()
        payload["standings"] = self._sweep(lb, reset_time)
        result = hook(
            self.runtime.context(mode="reset"), payload, reset_time
        )
        if asyncio.iscoroutine(result):
            await result

    async def _on_end(self, lb):
        self.logger.info("tournament end", id=lb.id)
        if self.runtime is None:
            return
        hook = self.runtime.tournament_end()
        if hook is None:
            return
        final_expiry = lb.expiry_at(
            max(lb.start_time, (lb.end_time or time.time()) - 1e-3)
        )
        payload = lb.as_dict()
        payload["standings"] = self._sweep(lb, final_expiry)
        result = hook(
            self.runtime.context(mode="end"), payload, lb.end_time
        )
        if asyncio.iscoroutine(result):
            await result

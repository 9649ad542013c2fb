"""Cron expression parser + next-fire-time engine.

Parity with the reference's vendored cron engine (reference
internal/cronexpr/, 1,549 LoC Go) as used by tournament/leaderboard reset
schedules (reference server/leaderboard_scheduler.go). Supports the
standard 5-field form plus the aliases the reference accepts:

    minute hour day-of-month month day-of-week
    */n steps, a-b ranges, a,b,c lists, combined (a-b/n), month/day names,
    @hourly @daily @midnight @weekly @monthly @yearly @annually

Times are UTC epoch seconds, matching the reference's use of UTC for
expiry computation (leaderboard expiry is compared against time.Now UTC).
"""

from __future__ import annotations

import calendar
import time as _time
from dataclasses import dataclass

_MONTHS = {
    name.lower(): i
    for i, name in enumerate(calendar.month_abbr)
    if name
}
_DAYS = {name.lower(): i for i, name in enumerate(calendar.day_abbr)}
# calendar.day_abbr is Mon..Sun (0..6); cron uses Sun=0.
_DAYS = {name: (i + 1) % 7 for name, i in _DAYS.items()}

_ALIASES = {
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
}


class CronError(ValueError):
    pass


def _parse_field(
    spec: str, lo: int, hi: int, names: dict[str, int] | None = None
) -> frozenset[int]:
    values: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            raise CronError(f"empty cron field part in {spec!r}")
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError:
                raise CronError(f"bad step {step_s!r}")
            if step < 1:
                raise CronError(f"bad step {step}")
        if part == "*":
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            lo2, hi2 = _value(a, names, lo, hi), _value(b, names, lo, hi)
            if lo2 > hi2:
                raise CronError(f"inverted range {part!r}")
        else:
            lo2 = hi2 = _value(part, names, lo, hi)
            if step != 1:
                hi2 = hi  # "a/step" means "from a to max by step"
        values.update(range(lo2, hi2 + 1, step))
    return frozenset(values)


def _value(s: str, names: dict[str, int] | None, lo: int, hi: int) -> int:
    s = s.strip().lower()
    if names and s in names:
        return names[s]
    try:
        v = int(s)
    except ValueError:
        raise CronError(f"bad cron value {s!r}")
    if s and names is _DAYS and v == 7:
        v = 0  # both 0 and 7 mean Sunday
    if not (lo <= v <= hi):
        raise CronError(f"cron value {v} out of range [{lo},{hi}]")
    return v


@dataclass(frozen=True)
class CronSchedule:
    minutes: frozenset[int]
    hours: frozenset[int]
    days: frozenset[int]
    months: frozenset[int]
    weekdays: frozenset[int]
    dom_star: bool
    dow_star: bool

    def _day_matches(self, year: int, month: int, day: int) -> bool:
        # calendar.weekday: Mon=0..Sun=6 -> cron Sun=0..Sat=6.
        weekday = (calendar.weekday(year, month, day) + 1) % 7
        dom_ok = day in self.days
        dow_ok = weekday in self.weekdays
        # Vixie cron rule: if both day fields are restricted, either may
        # match; a starred field defers to the other.
        if self.dom_star and self.dow_star:
            return True
        if self.dom_star:
            return dow_ok
        if self.dow_star:
            return dom_ok
        return dom_ok or dow_ok

    def next(self, after: float) -> float:
        """First fire time strictly after `after` (epoch seconds, UTC).
        Returns 0.0 if none within ~5 years (reference returns zero time)."""
        t = int(after // 60) * 60 + 60  # next whole minute
        st = _time.gmtime(t)
        year, month, day = st.tm_year, st.tm_mon, st.tm_mday
        hour, minute = st.tm_hour, st.tm_min
        horizon = st.tm_year + 5

        while year <= horizon:
            if month not in self.months:
                month += 1
                if month > 12:
                    month, year = 1, year + 1
                day, hour, minute = 1, 0, 0
                continue
            if day > calendar.monthrange(year, month)[1] or not (
                self._day_matches(year, month, day)
            ):
                day += 1
                hour, minute = 0, 0
                if day > calendar.monthrange(year, month)[1]:
                    day = 1
                    month += 1
                    if month > 12:
                        month, year = 1, year + 1
                continue
            if hour not in self.hours:
                hour += 1
                minute = 0
                if hour > 23:
                    hour = 0
                    day += 1
                    if day > calendar.monthrange(year, month)[1]:
                        day = 1
                        month += 1
                        if month > 12:
                            month, year = 1, year + 1
                continue
            if minute not in self.minutes:
                minute += 1
                if minute > 59:
                    minute = 0
                    hour += 1
                    if hour > 23:
                        hour = 0
                        day += 1
                        if day > calendar.monthrange(year, month)[1]:
                            day = 1
                            month += 1
                            if month > 12:
                                month, year = 1, year + 1
                continue
            return float(calendar.timegm((year, month, day, hour, minute, 0)))
        return 0.0

    def prev(self, before: float) -> float:
        """Last fire time at or before `before` — the START of the current
        period (used for tournament active-window computation, reference
        calculateTournamentDeadlines). Returns 0.0 if none within ~5y."""
        # Scan backwards minute-aligned; bounded by the same horizon.
        t = int(before // 60) * 60
        lo = t - 5 * 366 * 86400
        # Walk back day-by-day using next() within each day for efficiency.
        day_start = (t // 86400) * 86400
        while day_start >= lo:
            candidate = 0.0
            fire = self.next(day_start - 60)
            while fire and fire <= t:
                candidate = fire
                fire = self.next(fire)
            if candidate:
                return candidate
            day_start -= 86400
        return 0.0


def parse(expr: str) -> CronSchedule:
    expr = (expr or "").strip()
    if not expr:
        raise CronError("empty cron expression")
    expr = _ALIASES.get(expr.lower(), expr)
    fields = expr.split()
    if len(fields) == 6:
        # Seconds-resolution form: the reference's engine accepts it;
        # drop the seconds field (resets are minute-grained).
        fields = fields[1:]
    if len(fields) != 5:
        raise CronError(
            f"cron expression needs 5 fields, got {len(fields)}: {expr!r}"
        )
    minutes = _parse_field(fields[0], 0, 59)
    hours = _parse_field(fields[1], 0, 23)
    days = _parse_field(fields[2], 1, 31)
    months = _parse_field(fields[3], 1, 12, _MONTHS)
    weekdays = _parse_field(fields[4], 0, 7, _DAYS)
    if 7 in weekdays:
        weekdays = frozenset(weekdays - {7} | {0})
    return CronSchedule(
        minutes=minutes,
        hours=hours,
        days=days,
        months=months,
        weekdays=weekdays,
        dom_star=fields[2].strip() == "*",
        dow_star=fields[4].strip() == "*",
    )


def next_after(expr: str, after: float | None = None) -> float:
    return parse(expr).next(_time.time() if after is None else after)

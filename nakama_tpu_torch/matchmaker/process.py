"""CPU oracle process loop — semantics-parity with the reference matchmaker.

This is the deterministic re-statement of the reference's per-interval match
formation (reference server/matchmaker_process.go:27-334 `processDefault`,
:336-576 `processCustom`, server/matchmaker.go:132-167 `groupIndexes`). It is
the correctness oracle for the CUDA backend and the 1k-ticket parity baseline
(BASELINE.md config 1).

Deliberate differences from the reference:
- Iteration over active tickets is oldest-first (created order) instead of Go
  map order — deterministic for tests.
- The reverse-query memo cache is unnecessary (pure functions, small N).
- After a count-multiple trim, the ACTIVE ticket's own min/max bounds are
  re-checked (the reference's final cross-check covers combo members only,
  matchmaker_process.go:287-296, so a trim could shrink a match below the
  searcher's min_count).
"""

from __future__ import annotations

from typing import Callable, Iterator

from .query import evaluate, matches
from .types import MatchmakerEntry, MatchmakerTicket


def search_pool(
    active: MatchmakerTicket,
    pool: dict[str, MatchmakerTicket],
    excluded: set[str],
) -> list[tuple[MatchmakerTicket, float]]:
    """All pool tickets matching `active`'s query + count-range compatibility,
    sorted by (-score, created_at) — the TopN search of processDefault
    (reference matchmaker_process.go:64-90) as a linear scan."""
    hits: list[tuple[MatchmakerTicket, float]] = []
    for t in pool.values():
        if t.ticket in excluded:
            continue
        # Range compatibility: hit.min_count >= mine, hit.max_count <= mine.
        if t.min_count < active.min_count or t.max_count > active.max_count:
            continue
        # Never match the active party with itself.
        if active.party_id and t.party_id == active.party_id:
            continue
        score = evaluate(active.parsed_query, t.document())
        if score is None:
            continue
        hits.append((t, score))
    hits.sort(key=lambda ts: (-ts[1], ts[0].created_at, ts[0].created_seq))
    return hits


def _mutual(hit: MatchmakerTicket, other: MatchmakerTicket) -> bool:
    """Does `hit`'s own query accept `other`'s document? (reference
    validateMatch, server/matchmaker.go:1042-1068 — minus the memo cache)."""
    return matches(hit.parsed_query, other.document())


def _session_overlap(a: set[str], b: set[str]) -> bool:
    return not a.isdisjoint(b)


def group_tickets(
    tickets: list[MatchmakerTicket], required: int
) -> list[tuple[list[MatchmakerTicket], float]]:
    """All subsets of `tickets` whose entry counts sum to exactly `required`,
    each with the average created_at of its members (reference groupIndexes,
    server/matchmaker.go:132-167)."""
    if not tickets or required <= 0:
        return []
    current, others = tickets[0], tickets[1:]
    results: list[tuple[list[MatchmakerTicket], float]] = []
    if current.count == required:
        results.append(([current], current.created_at))
    elif current.count < required:
        for fill, avg in group_tickets(others, required - current.count):
            n = len(fill)
            new_avg = (avg * n + current.created_at) / (n + 1)
            results.append((fill + [current], new_avg))
    results.extend(group_tickets(others, required))
    return results


def process_default(
    actives: list[MatchmakerTicket],
    pool: dict[str, MatchmakerTicket],
    *,
    max_intervals: int,
    rev_precision: bool,
) -> list[list[MatchmakerEntry]]:
    """One interval of default match formation over tickets whose
    `intervals` the caller already bumped (LocalMatchmaker does, for every
    backend). Returns the matched entry sets; the caller removes matched
    tickets from the pool (reference matchmaker.go:320-372)."""
    matched_entries: list[list[MatchmakerEntry]] = []
    selected: set[str] = set()

    for active in actives:
        # Already matched earlier in this same iteration (reference
        # matchmaker_process.go:48-51): skip without interval bookkeeping —
        # the caller removes it from the pool entirely.
        if active.ticket in selected:
            continue

        last_interval = (
            active.intervals >= max_intervals
            or active.min_count == active.max_count
        )

        # Exclude self by membership in `selected` for the duration of
        # the search instead of copying the (growing) selected set per
        # active — the copy was O(matched²) over an interval, real money
        # on the budgeted host-only fallback at 100k pools. Removed
        # below if no match forms; a formed match re-adds it anyway.
        selected.add(active.ticket)
        hits = search_pool(active, pool, selected)
        matched_before = len(matched_entries)

        active_sessions = active.session_ids
        entry_combos: list[list[MatchmakerEntry]] = []
        last_hit_counter = len(hits) - 1
        for hit_counter, (hit, _score) in enumerate(hits):
            if rev_precision and not _mutual(hit, active):
                continue
            # "Let them wait": prefer not to under-fill a hit that wants a
            # bigger match and can still wait (matchmaker_process.go:150-153).
            if (
                active.max_count < hit.max_count
                and hit.intervals <= max_intervals
            ):
                continue
            if _session_overlap(active_sessions, hit.session_ids):
                continue

            found_combo: list[MatchmakerEntry] | None = None
            found_combo_idx = -1
            for combo_idx, combo in enumerate(entry_combos):
                if len(combo) + hit.count + active.count > active.max_count:
                    continue
                conflict = False
                for entry in combo:
                    if entry.presence.session_id in hit.session_ids:
                        conflict = True
                        break
                    if rev_precision:
                        entry_ticket = pool.get(entry.ticket)
                        if entry_ticket is None:
                            continue
                        if not _mutual(hit, entry_ticket) or not _mutual(
                            entry_ticket, hit
                        ):
                            conflict = True
                            break
                if conflict:
                    continue
                combo.extend(hit.entries)
                found_combo = combo
                found_combo_idx = combo_idx
                break
            if found_combo is None:
                found_combo = list(hit.entries)
                entry_combos.append(found_combo)
                found_combo_idx = len(entry_combos) - 1

            size = len(found_combo) + active.count
            if not (
                size == active.max_count
                or (
                    last_interval
                    and active.min_count <= size <= active.max_count
                    and hit_counter >= last_hit_counter
                )
            ):
                continue

            rem = size % active.count_multiple
            if rem != 0:
                # Trim the combo down to a valid multiple by removing one
                # exact-size group of tickets (matchmaker_process.go:237-281).
                eligible_uniq: dict[str, MatchmakerTicket] = {}
                for entry in found_combo:
                    t = pool.get(entry.ticket)
                    if t is not None and t.count <= rem:
                        eligible_uniq[t.ticket] = t
                groups = group_tickets(list(eligible_uniq.values()), rem)
                if not groups:
                    continue
                groups.sort(key=lambda g: g[1])
                removed_tickets = {t.ticket for t in groups[0][0]}
                found_combo[:] = [
                    e for e in found_combo if e.ticket not in removed_tickets
                ]
                size = len(found_combo) + active.count
                if size % active.count_multiple != 0:
                    continue
                # Deliberate fix over the reference: re-check the active
                # ticket's own bounds after trimming (the reference's final
                # cross-check covers combo members only,
                # matchmaker_process.go:287-296, so a trim can shrink a match
                # below the searcher's min_count).
                if not (active.min_count <= size <= active.max_count):
                    continue

            # Final cross-member validation (matchmaker_process.go:287-296).
            ok = True
            for entry in found_combo:
                t = pool.get(entry.ticket)
                if t is not None and (
                    t.min_count > size
                    or t.max_count < size
                    or size % t.count_multiple != 0
                ):
                    ok = False
                    break
            if not ok:
                continue

            current = found_combo + list(active.entries)
            del entry_combos[found_combo_idx]
            matched_entries.append(current)
            for entry in current:
                selected.add(entry.ticket)
            break

        if len(matched_entries) == matched_before:
            # No match formed: the self-exclusion entry must not shadow
            # this ticket from later actives' searches.
            selected.discard(active.ticket)

    return matched_entries


def combine_tickets(
    tickets: list[MatchmakerTicket], lo: int, hi: int
) -> Iterator[list[MatchmakerTicket]]:
    """All subsets with total entry count in [lo, hi] (reference
    combineIndexes, matchmaker_process.go:578-612)."""
    n = len(tickets)
    for bits_ in range(1, 1 << n):
        combo: list[MatchmakerTicket] = []
        count = 0
        ok = True
        for i in range(n):
            if (bits_ >> i) & 1:
                count += tickets[i].count
                if count > hi:
                    ok = False
                    break
                combo.append(tickets[i])
        if ok and count >= lo:
            yield combo


def process_custom(
    actives: list[MatchmakerTicket],
    pool: dict[str, MatchmakerTicket],
    *,
    max_intervals: int,
    rev_precision: bool,
    override_fn: Callable[
        [list[list[MatchmakerEntry]]], list[list[MatchmakerEntry]]
    ],
) -> tuple[list[list[MatchmakerEntry]], list[str]]:
    """One interval of custom match formation: enumerate ALL candidate
    combinations per active ticket and let the runtime override choose
    (reference processCustom, matchmaker_process.go:336-576)."""
    candidates: list[list[MatchmakerEntry]] = []
    expired_actives: list[str] = []

    for active in actives:
        active.intervals += 1

    for active in actives:
        last_interval = (
            active.intervals >= max_intervals
            or active.min_count == active.max_count
        )
        if last_interval:
            expired_actives.append(active.ticket)

        hits_scored = search_pool(active, pool, {active.ticket})
        active_sessions = active.session_ids
        hit_tickets: list[MatchmakerTicket] = []
        for hit, _score in hits_scored:
            if rev_precision and not _mutual(hit, active):
                continue
            if (
                active.max_count < hit.max_count
                and hit.intervals <= max_intervals
            ):
                continue
            if _session_overlap(active_sessions, hit.session_ids):
                continue
            hit_tickets.append(hit)

        for combo in combine_tickets(
            hit_tickets,
            active.min_count - active.count,
            active.max_count - active.count,
        ):
            size = sum(t.count for t in combo) + active.count
            if not (active.min_count <= size <= active.max_count):
                continue
            if size % active.count_multiple != 0:
                continue
            reject = False
            for t in combo:
                if (
                    size > t.max_count
                    or size < t.min_count
                    or size % t.count_multiple != 0
                ):
                    reject = True
                    break
                # Hit under its preferred max and can still wait.
                if size < t.max_count and t.intervals <= max_intervals:
                    reject = True
                    break
            if reject:
                continue
            # Session and (optional) pairwise mutual-match conflicts.
            seen_sessions: set[str] = set()
            conflict = False
            for t in combo:
                if _session_overlap(seen_sessions, t.session_ids):
                    conflict = True
                    break
                seen_sessions |= t.session_ids
            if not conflict and rev_precision:
                group = combo + [active]
                for i in range(len(group)):
                    for j in range(i + 1, len(group)):
                        if not _mutual(group[i], group[j]) or not _mutual(
                            group[j], group[i]
                        ):
                            conflict = True
                            break
                    if conflict:
                        break
            if conflict:
                continue
            entries: list[MatchmakerEntry] = []
            for t in combo:
                entries.extend(t.entries)
            entries.extend(active.entries)
            candidates.append(entries)

    if not candidates:
        return [], expired_actives
    return override_fn(candidates), expired_actives

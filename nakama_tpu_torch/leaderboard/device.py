"""DeviceRankEngine: card-resident leaderboard and tournament ranks.

The port's second device workload, the counterpart of the JAX
package's `leaderboard/device.py`. The host `LeaderboardRankCache`
stays the oracle — every record write lands there first — but at read
scale (console listings, haystack windows, hooks fanning rank queries
over thousands of owners) N host bisects lose to ONE batched device
search. This engine holds each adopted board as a padded,
slot-allocated score tensor on the card (`cuda.py`):

- **Write side**: `record_upsert`/`record_delete` absorb into a host
  staging mirror at O(1) per write (dict + row write + dirty mark) and
  flush to the card as an in-place scatter + segmented sort on a
  dirty-threshold / interval cadence — never per write. The rows go up
  from pinned memory with non-blocking copies, so a flush never waits
  for the card.
- **Read side**: `get_many` (batched ranks), `rank_window` (top-K /
  around-owner), and `sweep_many` (end-of-tournament reward sweeps,
  scheduler resets) each cost one device call per *batch*.
- **Degradation ladder**: reads route through a circuit breaker. Only
  an armed `leaderboard.rank`/`leaderboard.flush` fault or CUDA
  out-of-memory (`faults.degrades`) feeds the breaker and returns None,
  so the caller serves from the host oracle; the half-open probe heals
  it. Any other error — from the card or from this code — raises: the
  oracle must not hide a broken device path. (The JAX engine catches
  every exception, and disables itself for good when jax fails to
  import.) A request's deadline never sends a read to the host: a
  board on the card is read there however little time is left, and an
  expired deadline fails the request (`DeadlineExceeded`) as storage
  and the matchmaker do. (The JAX engine serves from the oracle when
  less than `device_read_budget_ms` is left.) Spans wrap every device
  call, and checkpoints carry the board columns via
  `snapshot_state`/`restore_state`.

Staleness contract: device reads reflect the last flush; the lag is
bounded by `device_flush_dirty_threshold` writes or
`device_flush_interval_sec` seconds, whichever trips first, and a read
on a never-flushed or over-threshold board flushes synchronously (one
device call). Query keys always come from the *current* host oracle, so
an unflushed write ranks against the flushed tensor consistently.
Boards with keys outside int32 (scores beyond ±2^31, seq wrap) flip
host-only and fall back to the oracle forever.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from .. import faults
from .. import tracing as trace_api
from ..devobs import DEVOBS
from ..faults import (
    HALF_OPEN,
    STATE_CODE,
    CircuitBreaker,
    InjectedFault,
    classify_exception,
    degrades,
)
from ..overload import check_deadline
from . import cuda as programs

_INT32_LIMIT = 2**31 - 1


class _DeviceBoard:
    """Host staging mirror + device handles for one (board, expiry).

    Slots are handed out as the JAX package's free list hands them out
    (recycled slots last-in first-out, then never-used slots in
    ascending order), without materialising the never-used ones: a
    10M-entry board does not build a 16M-element list."""

    __slots__ = (
        "board_id", "expiry", "sort_order", "capacity", "keys",
        "owner_at", "slot_of", "free", "fresh", "pending_free", "count",
        "dirty", "dirty_since", "device_keys", "sorted_keys", "perm",
        "sorted_valid", "flushed_count", "full_upload", "host_only",
    )

    MIN_CAPACITY = 1024  # >= the largest window-limit pad bucket

    def __init__(self, board_id: str, expiry: float, sort_order: int,
                 capacity: int = 0):
        self.board_id = board_id
        self.expiry = expiry
        self.sort_order = sort_order
        self.capacity = programs.pad_pow2(max(capacity, self.MIN_CAPACITY))
        self.keys = np.full((self.capacity, 3), _INT32_LIMIT,
                            dtype=np.int64)
        self.owner_at = np.full(self.capacity, None, dtype=object)
        self.slot_of: dict[str, int] = {}
        # Recycled slots (popped first), then `fresh`, the lowest slot
        # never used, so the live region stays dense at the low end.
        self.free: list[int] = []
        self.fresh = 0
        # Freed slots park here until the flush that reflects their PAD
        # key lands on the card — a stale perm must keep resolving the
        # old owner, never a reused slot's new one.
        self.pending_free: list[int] = []
        self.count = 0
        self.dirty: set[int] = set()
        self.dirty_since: float | None = None
        self.device_keys = None     # int32 [C, 3], scatter target
        self.sorted_keys = None     # int32 [C, 3], read target
        self.perm = None            # int32 [C], rank -> slot
        self.sorted_valid = False
        self.flushed_count = 0
        self.full_upload = True
        self.host_only = False

    def _mark_dirty(self, slot: int):
        self.dirty.add(slot)
        if self.dirty_since is None:
            self.dirty_since = time.perf_counter()

    def _grow(self):
        old_cap = self.capacity
        self.capacity = programs.pad_pow2(old_cap * 2)
        keys = np.full((self.capacity, 3), _INT32_LIMIT, dtype=np.int64)
        keys[:old_cap] = self.keys
        self.keys = keys
        owner_at = np.full(self.capacity, None, dtype=object)
        owner_at[:old_cap] = self.owner_at
        self.owner_at = owner_at
        # Shapes changed: the device copies are dead.
        self.device_keys = self.sorted_keys = self.perm = None
        self.sorted_valid = False
        self.full_upload = True

    def _take_slot(self) -> int:
        if self.free:
            return self.free.pop()
        if self.fresh >= self.capacity:
            self._grow()
        self.fresh += 1
        return self.fresh - 1

    def upsert(self, owner: str, key: tuple) -> None:
        k0, k1, k2 = int(key[0]), int(key[1]), int(key[2])
        if not (
            -_INT32_LIMIT < k0 < _INT32_LIMIT
            and -_INT32_LIMIT < k1 < _INT32_LIMIT
            and 0 <= k2 < _INT32_LIMIT
        ):
            self.host_only = True  # sticky: oracle serves this board
            return
        slot = self.slot_of.get(owner)
        if slot is None:
            slot = self._take_slot()
            self.slot_of[owner] = slot
            self.owner_at[slot] = owner
            self.count += 1
        self.keys[slot, 0] = k0
        self.keys[slot, 1] = k1
        self.keys[slot, 2] = k2
        self._mark_dirty(slot)

    def load(self, owners: list[str], keys) -> None:
        """Bulk `upsert` of distinct owners into a fresh board: the same
        slots, keys and host-only verdict as one `upsert` each, at numpy
        speed (adoption and restore of a 10M-entry board). The rows are
        not marked one by one: a never-flushed board uploads whole."""
        n = len(owners)
        k = np.fromiter(
            itertools.chain.from_iterable(keys), dtype=np.int64, count=3 * n
        ).reshape(n, 3)
        ok = (
            (k[:, 0] > -_INT32_LIMIT) & (k[:, 0] < _INT32_LIMIT)
            & (k[:, 1] > -_INT32_LIMIT) & (k[:, 1] < _INT32_LIMIT)
            & (k[:, 2] >= 0) & (k[:, 2] < _INT32_LIMIT)
        )
        if not ok.all():
            self.host_only = True
            owners = [o for o, good in zip(owners, ok.tolist()) if good]
            k = k[ok]
            n = len(owners)
        while self.capacity < n:
            self._grow()
        self.keys[:n] = k
        self.owner_at[:n] = owners
        self.slot_of = dict(zip(owners, range(n)))
        self.fresh = self.count = n
        self.dirty_since = time.perf_counter() if n else None

    def delete(self, owner: str) -> None:
        slot = self.slot_of.pop(owner, None)
        if slot is None:
            return
        self.keys[slot] = _INT32_LIMIT
        self.count -= 1
        self.pending_free.append(slot)
        self._mark_dirty(slot)

    def keys32(self) -> np.ndarray:
        return self.keys.astype(np.int32)

    def live_entries(self) -> list[tuple[str, int, int, int]]:
        out = []
        for owner, slot in self.slot_of.items():
            k = self.keys[slot]
            out.append((owner, int(k[0]), int(k[1]), int(k[2])))
        return out


class DeviceRankEngine:
    """Batched device rank reads over host-staged board columns, with
    the host oracle as breaker-routed fallback (None = caller serves
    host-side).

    `device=None` is cuda:0 and raises without a CUDA device; "cpu"
    runs the same programs on the host (the tests)."""

    def __init__(self, config, logger, metrics=None, oracle=None,
                 device: torch.device | str | None = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceRankEngine needs a CUDA device (pass "
                    "device='cpu' to run its programs on the host)"
                )
            device = "cuda:0"
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self.logger = logger.with_fields(subsystem="leaderboard.device")
        self.metrics = None
        self.oracle = oracle
        self.min_board_size = int(
            getattr(config, "device_min_board_size", 4096)
        )
        self.dirty_threshold = max(1, int(
            getattr(config, "device_flush_dirty_threshold", 1024)
        ))
        self.flush_interval_s = float(
            getattr(config, "device_flush_interval_sec", 2.0)
        )
        self.breaker = CircuitBreaker(
            threshold=int(getattr(config, "device_breaker_threshold", 3)),
            cooldown_s=(
                int(getattr(config, "device_breaker_cooldown_ms", 30_000))
                / 1000.0
            ),
            on_transition=self._on_breaker_transition,
        )
        self._boards: dict[tuple[str, float], _DeviceBoard] = {}
        # Device telemetry: name this workload's entry points up front.
        for kernel in (
            "leaderboard.flush", "leaderboard.rank", "leaderboard.sweep",
        ):
            DEVOBS.register(kernel)
        # Ledger counters (console / tests / chip_smoke).
        self.device_reads = 0
        self.fallbacks = 0
        self.flushes = 0
        self.sweeps = 0
        self.last_flush_lag_s = 0.0
        if metrics is not None:
            self.bind_metrics(metrics)

    # ------------------------------------------------------------ plumbing

    def bind_metrics(self, metrics) -> None:
        self.metrics = metrics
        try:
            metrics.lb_device_state.set(STATE_CODE[self.breaker.state])
        except Exception:
            pass

    def _on_breaker_transition(self, old: str, new: str, reason: str):
        if self.metrics is not None:
            try:
                self.metrics.lb_device_state.set(STATE_CODE[new])
            except Exception:
                pass
        trace_api.add_event(
            "leaderboard.breaker", old=old, new=new, reason=reason
        )
        self.logger.warn(
            "leaderboard device breaker transition",
            old=old, new=new, reason=reason,
            cooldown_s=round(self.breaker.cooldown_s, 3),
        )

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """One host array, made for this call and not written again,
        onto the engine's device. On a card it goes through a freshly
        allocated pinned buffer with a non-blocking copy (PyTorch's
        pinned cache hands the block out again only once the copy has
        completed), so the caller never waits for the card; on the host
        the result shares `arr`'s memory."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._pin:
            return src
        buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf.to(self.device, non_blocking=True)

    def _update_mem(self) -> None:
        """Refresh the HBM ledger's board row: every adopted board's
        live device tensors (scatter target + sorted copy + perm)."""
        total = 0
        for b in self._boards.values():
            for arr in (b.device_keys, b.sorted_keys, b.perm):
                if arr is not None:
                    total += arr.numel() * arr.element_size()
        DEVOBS.mem_set("leaderboard.boards", total)

    # ----------------------------------------------------------- write side

    def record_upsert(
        self, board_id: str, expiry: float, sort_order: int, owner_id: str
    ) -> None:
        """Stage one upsert; the key is read from the oracle (the two
        structures share the exact lexicographic key, seq included, so
        tie-breaks agree bit-for-bit)."""
        if self.oracle is None:
            return
        key = self.oracle.key_for(board_id, expiry, owner_id)
        if key is None:
            return  # blacklisted board / raced delete
        b = self._boards.get((board_id, expiry))
        if b is None:
            if self.oracle.count(board_id, expiry) < self.min_board_size:
                return
            b = self._adopt(board_id, expiry, sort_order)
            if b is None:
                return
        b.upsert(owner_id, key)

    def record_delete(
        self, board_id: str, expiry: float, owner_id: str
    ) -> None:
        b = self._boards.get((board_id, expiry))
        if b is not None:
            b.delete(owner_id)

    def _adopt(
        self, board_id: str, expiry: float, sort_order: int
    ) -> _DeviceBoard | None:
        """Bootstrap a board's staging mirror from the oracle once it
        crosses the device-worthwhile size (one O(n) walk; the sort
        happens lazily at the first device read)."""
        entries = self.oracle.items(board_id, expiry)
        if entries is None:
            return None
        b = _DeviceBoard(board_id, expiry, sort_order,
                         capacity=len(entries) + 1)
        b.load(
            [owner for owner, _ in entries],
            (key[:3] for _, key in entries),
        )
        self._boards[(board_id, expiry)] = b
        self.logger.info(
            "board adopted onto device", board=board_id,
            expiry=expiry, entries=len(entries),
        )
        return b

    def adopt_board(
        self, board_id: str, expiry: float, sort_order: int
    ) -> bool:
        """Explicit adoption (restore resync, chip_smoke, tests)."""
        if self.oracle is None:
            return False
        return self._adopt(board_id, expiry, sort_order) is not None

    # -------------------------------------------------------------- lifecycle

    def delete_board(self, board_id: str) -> None:
        for key in [k for k in self._boards if k[0] == board_id]:
            del self._boards[key]
        self._update_mem()

    def trim_expired(self, now: float) -> int:
        gone = [
            k for k in self._boards if k[1] != 0 and k[1] <= now
        ]
        for k in gone:
            del self._boards[k]
        if gone:
            self._update_mem()
        return len(gone)

    def clear_all(self) -> None:
        self._boards.clear()
        self._update_mem()

    # ------------------------------------------------------------------ flush

    def _needs_flush(self, b: _DeviceBoard) -> bool:
        if not b.sorted_valid:
            return True
        if not b.dirty:
            return False
        if len(b.dirty) >= self.dirty_threshold:
            return True
        return (
            b.dirty_since is not None
            and time.perf_counter() - b.dirty_since >= self.flush_interval_s
        )

    def _flush_board(self, b: _DeviceBoard) -> bool | None:
        """Scatter the dirty rows in place and segmented-sort the board.
        True = flushed; None = an armed drop-mode `leaderboard.flush`
        discarded the round (staging retained, the stale sort keeps
        serving — through _guarded that is the no-success-no-failure
        path, so a dropped probe releases instead of closing the
        breaker). Raises on failure (the guarded caller decides)."""
        with trace_api.span(
            "leaderboard.flush", board=b.board_id, dirty=len(b.dirty)
        ):
            # Fault point fires BEFORE device work so an injected raise
            # can never strand a half-updated board.
            if faults.fire("leaderboard.flush"):
                if b.sorted_valid:
                    return None  # round dropped; staging retained
                # Nothing sorted to serve: the drop is a failed flush.
                raise InjectedFault("leaderboard.flush")
            lag = (
                None if b.dirty_since is None
                else time.perf_counter() - b.dirty_since
            )
            try:
                with DEVOBS.device_call(
                    "leaderboard.flush", device=self.device
                ):
                    if b.device_keys is None or b.full_upload:
                        full = b.keys32()
                        b.device_keys = self._h2d(full)
                        b.full_upload = False
                        DEVOBS.transfer(
                            "leaderboard.flush", "h2d", int(full.nbytes)
                        )
                    elif b.dirty:
                        idx = np.fromiter(
                            b.dirty, dtype=np.int64, count=len(b.dirty)
                        )
                        rows = b.keys[idx].astype(np.int32)
                        programs.scatter_keys(
                            b.device_keys, self._h2d(idx), self._h2d(rows)
                        )
                        DEVOBS.transfer(
                            "leaderboard.flush", "h2d",
                            int(idx.nbytes) + int(rows.nbytes),
                        )
                    skeys, perm = programs.sort_boards(b.device_keys[None])
                    b.sorted_keys = skeys[0]
                    b.perm = perm[0]
            except Exception:
                # The scatter target may be half-written: rebuild from
                # the host mirror on the next (post-breaker) attempt.
                b.device_keys = b.sorted_keys = b.perm = None
                b.sorted_valid = False
                b.full_upload = True
                raise
            b.dirty.clear()
            b.dirty_since = None
            b.sorted_valid = True
            b.flushed_count = b.count
            if b.pending_free:
                for slot in b.pending_free:
                    owner = b.owner_at[slot]
                    # get() != slot covers both a re-upserted owner (new
                    # slot) and a still-deleted one (None).
                    if owner is not None and b.slot_of.get(owner) != slot:
                        b.owner_at[slot] = None
                b.free.extend(b.pending_free)
                b.pending_free = []
            self.flushes += 1
            self._update_mem()
            if lag is not None:
                self.last_flush_lag_s = lag
                if self.metrics is not None:
                    try:
                        self.metrics.lb_flush_lag.observe(lag)
                    except Exception:
                        pass
        return True

    def flush_all(self) -> bool:
        """Explicit flush barrier (tests, chip_smoke, checkpoint): flush
        every dirty board through the guarded path; False when any
        board could not flush (breaker open / fault raised or
        dropped)."""
        ok = True
        for b in self._boards.values():
            if b.host_only or not (b.dirty or not b.sorted_valid):
                continue
            if self._guarded(lambda b=b: self._flush_board(b)) is not True:
                ok = False
        return ok

    # ------------------------------------------------------------- read side

    def _guarded(self, fn):
        """Breaker-routed device call: None means "serve host-side"
        (breaker open, injected drop, or an injected fault /
        out-of-memory that just fed the breaker). Any other exception
        raises. A request's deadline does not route a read to the host:
        a board on the card is read there, however little time is left,
        and an expired one raises `DeadlineExceeded`."""
        check_deadline("leaderboard device call")
        if not self.breaker.allow():
            self.fallbacks += 1
            return None
        probing = self.breaker.state == HALF_OPEN
        try:
            result = fn()
        except Exception as e:
            if not degrades(e):
                if probing:
                    self.breaker.release_probe()
                raise
            kind = classify_exception(e)
            self.breaker.record_failure(fatal=(kind == "fatal"))
            self.fallbacks += 1
            self.logger.warn(
                "leaderboard device call failed; host oracle serves",
                error=str(e), kind=kind, state=self.breaker.state,
            )
            return None
        if result is None and probing:
            # The granted probe never reached the device (drop-mode
            # fault): hand the slot back instead of wedging half-open.
            self.breaker.release_probe()
        if result is not None:
            self.breaker.record_success()
        else:
            self.fallbacks += 1
        return result

    def get_many(
        self, board_id: str, expiry: float, owner_ids: list[str]
    ) -> list[int] | None:
        """Batched owner ranks (device twin of the oracle's get_many);
        None routes the caller to the host oracle."""
        if not owner_ids:
            return []
        b = self._boards.get((board_id, expiry))
        if b is None or b.host_only:
            return None
        return self._guarded(
            lambda: self._ranks_locked(b, board_id, expiry, owner_ids)
        )

    def _ranks_locked(self, b, board_id, expiry, owner_ids):
        with trace_api.span(
            "leaderboard.rank", board=board_id, batch=len(owner_ids)
        ):
            if faults.fire("leaderboard.rank"):
                return None  # drop: this device read is discarded
            if self._needs_flush(b):
                self._flush_board(b)
            out = [-1] * len(owner_ids)
            keys = self.oracle.keys_for(board_id, expiry, owner_ids)
            q_pos: list[int] = []
            q_keys: list[tuple] = []
            if keys is not None:
                for i, key in enumerate(keys):
                    if key is not None:
                        q_pos.append(i)
                        q_keys.append(key)
            if q_pos:
                # One C-path conversion for the whole batch.
                q = np.asarray(
                    [k[:3] for k in q_keys], dtype=np.int64
                ).astype(np.int32)
                with DEVOBS.device_call(
                    "leaderboard.rank", device=self.device
                ):
                    ranks = programs.lex_ranks(
                        b.sorted_keys, self._h2d(q),
                        programs.n_search_iters(b.capacity),
                    ).cpu().tolist()
                DEVOBS.transfer(
                    "leaderboard.rank", "h2d", int(q.nbytes)
                )
                DEVOBS.transfer(
                    "leaderboard.rank", "d2h", 4 * len(ranks)
                )
                for j, i in enumerate(q_pos):
                    out[i] = ranks[j]
            self.device_reads += 1
            if self.metrics is not None:
                try:
                    self.metrics.lb_rank_batch_size.observe(len(owner_ids))
                except Exception:
                    pass
            return out

    def rank_window(
        self, board_id: str, expiry: float, start: int, limit: int
    ) -> list[tuple[str, int]] | None:
        """[start, start+limit) of the sorted board as (owner, rank) —
        one on-device slice + one `limit`-sized fetch."""
        b = self._boards.get((board_id, expiry))
        if b is None or b.host_only:
            return None
        return self._guarded(
            lambda: self._window_locked(b, board_id, start, limit)
        )

    def _window_locked(self, b, board_id, start, limit):
        with trace_api.span(
            "leaderboard.rank", board=board_id, window=limit
        ):
            if faults.fire("leaderboard.rank"):
                return None
            if self._needs_flush(b):
                self._flush_board(b)
            n = b.flushed_count
            if n <= 0 or start >= n:
                return []
            eff = min(limit, n - start)
            with DEVOBS.device_call(
                "leaderboard.rank", device=self.device
            ):
                slots = programs.window_slots(b.perm, start, eff)
                slots = slots.cpu().tolist()
            DEVOBS.transfer("leaderboard.window", "d2h", 4 * eff)
            out = []
            for i in range(eff):
                owner = b.owner_at[slots[i]]
                if owner is not None:
                    out.append((owner, start + i))
            self.device_reads += 1
            return out

    def percentile(
        self, board_id: str, expiry: float, owner_id: str
    ) -> tuple[int, int, float] | None:
        """(rank, flushed count, percentile in [0, 1]); None -> host."""
        ranks = self.get_many(board_id, expiry, [owner_id])
        if ranks is None:
            return None
        b = self._boards.get((board_id, expiry))
        n = b.flushed_count if b is not None else 0
        rank = ranks[0]
        if rank < 0 or n <= 0:
            return (rank, n, 1.0)
        return (rank, n, (rank + 1) / n)

    # ------------------------------------------------------------- sweeps

    def sweep_many(
        self, boards: list[tuple[str, float]]
    ) -> dict[tuple[str, float], list[dict]]:
        """End-of-tournament reward sweeps / scheduler resets: final
        standings for every requested board, computed as segmented
        sorts over the board axis — same-capacity boards stack into ONE
        [B, C, 3] sort. Boards the device cannot serve (unadopted,
        host-only, breaker open) are absent from the result; the caller
        sweeps those through the oracle."""
        groups: dict[int, list[_DeviceBoard]] = {}
        for key in boards:
            b = self._boards.get(key)
            if b is not None and not b.host_only:
                groups.setdefault(b.capacity, []).append(b)
        out: dict[tuple[str, float], list[dict]] = {}
        for cap, group in groups.items():
            res = self._guarded(lambda g=group: self._sweep_locked(g))
            if res is not None:
                out.update(res)
        return out

    def _sweep_locked(self, group):
        with trace_api.span(
            "leaderboard.sweep", boards=len(group),
            capacity=group[0].capacity,
        ):
            if faults.fire("leaderboard.rank"):
                return None
            stacked = np.stack([b.keys32() for b in group])
            with DEVOBS.device_call(
                "leaderboard.sweep", device=self.device
            ):
                _, perm = programs.sort_boards(self._h2d(stacked))
                perm = perm.cpu().numpy()
            DEVOBS.transfer(
                "leaderboard.sweep", "h2d", int(stacked.nbytes)
            )
            DEVOBS.transfer(
                "leaderboard.sweep", "d2h", int(perm.nbytes)
            )
            out = {}
            for i, b in enumerate(group):
                desc = b.sort_order == 1
                standings = []
                for r in range(b.count):
                    slot = int(perm[i, r])
                    owner = b.owner_at[slot]
                    if owner is None:
                        continue
                    k0 = int(b.keys[slot, 0])
                    k1 = int(b.keys[slot, 1])
                    standings.append({
                        "owner_id": owner,
                        "rank": len(standings) + 1,
                        "score": -k0 if desc else k0,
                        "subscore": -k1 if desc else k1,
                    })
                out[(b.board_id, b.expiry)] = standings
            self.sweeps += 1
            self.device_reads += 1
            return out

    # -------------------------------------------------- snapshot / restore

    def snapshot_state(self) -> dict:
        """Checkpoint section `leaderboard_device` (the JAX engine's
        layout): each adopted board's live entries with their exact
        lexicographic keys (seq included), so a warm restart preserves
        tie-break order bit-for-bit instead of re-deriving it from DB
        update_time ordering."""
        return {
            "version": 1,
            "boards": [
                {
                    "board_id": b.board_id,
                    "expiry": b.expiry,
                    "sort_order": b.sort_order,
                    "entries": b.live_entries(),
                }
                for b in self._boards.values()
                if not b.host_only
            ],
        }

    def restore_state(self, snap: dict | None) -> int:
        """Rebuild board staging from a checkpoint section (this
        engine's or the JAX engine's); also repopulates the oracle's
        boards (preserved seqs) so the post-restore `Leaderboards.load()`
        re-inserts become no-ops under the unchanged-score
        seq-preservation rule. Returns the number of boards restored;
        never raises (host work only: a malformed board is logged and
        left to lazy adoption)."""
        if not snap or snap.get("version") != 1:
            return 0
        restored = 0
        for bd in snap.get("boards", ()):
            try:
                board_id = bd["board_id"]
                expiry = float(bd["expiry"])
                sort_order = int(bd["sort_order"])
                entries = bd["entries"]
                if self.oracle is not None:
                    self.oracle.restore_board(
                        board_id, expiry, sort_order, entries
                    )
                b = _DeviceBoard(
                    board_id, expiry, sort_order,
                    capacity=len(entries) + 1,
                )
                b.load([e[0] for e in entries], (e[1:4] for e in entries))
                self._boards[(board_id, expiry)] = b
                restored += 1
            except Exception as e:
                self.logger.warn(
                    "leaderboard board restore failed; lazy adoption"
                    " will rebuild it", error=str(e),
                )
        if restored:
            self.logger.info(
                "leaderboard device boards restored", boards=restored
            )
        return restored

    # ------------------------------------------------------------- console

    def stats(self) -> dict:
        boards = []
        for (board_id, expiry), b in self._boards.items():
            boards.append({
                "board_id": board_id,
                "expiry": expiry,
                "entries": b.count,
                "capacity": b.capacity,
                "dirty": len(b.dirty),
                "flushed": b.sorted_valid,
                "host_only": b.host_only,
                # Projected per-board device bytes once flushed (the
                # live total is the `leaderboard.boards` ledger row).
                "device_bytes": (
                    programs.board_device_bytes(b.capacity)
                    if b.sorted_valid else 0
                ),
            })
        return {
            "enabled": True,
            "device": str(self.device),
            "breaker_state": self.breaker.state,
            "boards": boards,
            "device_reads": self.device_reads,
            "fallbacks": self.fallbacks,
            "flushes": self.flushes,
            "sweeps": self.sweeps,
            "last_flush_lag_ms": round(self.last_flush_lag_s * 1000, 3),
            "min_board_size": self.min_board_size,
            "dirty_threshold": self.dirty_threshold,
            "flush_interval_sec": self.flush_interval_s,
        }

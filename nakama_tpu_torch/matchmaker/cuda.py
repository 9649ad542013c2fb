"""CudaBackend: the matchmaker's device process path on an NVIDIA GPU.

Port of the JAX package's `matchmaker/tpu.py::TpuBackend`. Per interval
(the reference's LocalMatchmaker.Process hot loop re-framed):

1. flush the tail of the queued ticket updates (bulk updates stream to the
   device eagerly in chunks as tickets are added),
2. score actives against the pool on the device:
   - small pools: the exact blockwise top-K scan (device.py),
   - large pools (>= config.big_pool_threshold columns): the two-stage
     scan (device2.py) — the stage-1 CUDA kernel + exact re-rank,
3. while that runs, the CPU oracle serves host-only actives (regex or
   wildcard queries, field overflow),
4. pure-1v1 pools pair on the device (device2.pair_partners); other pools
   hand their candidate lists to the native C++ greedy assembler,
5. every formed match is validated on the host against exact (f64 /
   63-bit hash) query mirrors.

The device-to-host fetch, the native assembly and the validation run on a
worker thread per dispatch, so with pipelined intervals (the default) they
ride the gap to the next interval and `process_slots` only collects
finished cohorts. Host-side per-slot metadata lives in persistent numpy
arrays, so an interval never loops over the pool in Python.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np
import torch

from ..config import MatchmakerConfig
from ..logger import Logger
from .. import native
from .compile import (
    CLAMP,
    FULL_HI,
    FULL_LO,
    SOP_ALL,
    SOP_NUM_RANGE,
    SOP_STR_EQ,
    SOP_UNUSED,
    CompiledQuery,
    FieldRegistry,
    HostOnlyQuery,
    compile_features,
    compile_query,
    exact_features,
    hash_str,
)
from .device import (
    FLAG_HAS_MUST,
    FLAG_HAS_SHOULD,
    FLAG_NEVER,
    FLAG_VALID,
    PoolBuffer,
    pad_to,
    topk_candidates,
)
from .device2 import MAX_COLS, pair_partners, topk_candidates_big
from .process import _mutual, process_default
from .types import MatchBatch, MatchmakerTicket

_CQ_MISS = object()  # cache-miss sentinel (None is a valid cached value)

# assembler.cpp mirrors these should-clause opcodes.
assert (SOP_UNUSED, SOP_ALL, SOP_NUM_RANGE, SOP_STR_EQ) == (0, 1, 2, 3)


def _pow2_blocks(blocks: int) -> int:
    """Smallest power of two >= blocks (>=1)."""
    return 1 << max(0, blocks - 1).bit_length()


def big_cols(high_water: int, bn: int, capacity: int) -> int:
    """Scanned column extent of the two-stage path: column blocks pad to
    a power of two up to 16 blocks, then to multiples of 16. The JAX
    package chose these buckets to bound XLA compiles; here they are
    semantics — the block count sets the winners kept per block."""
    blocks = -(-high_water // bn)
    if blocks > 16:
        blocks = -(-blocks // 16) * 16
    else:
        blocks = _pow2_blocks(blocks)
    return min(capacity, blocks * bn)


def _work_ready(work: tuple) -> bool:
    """Has this dispatched work's fetch + host assembly completed?"""
    return "done" in work[0][0]


class CudaBackend:
    """ProcessBackend running the device path on a CUDA device.

    `device` defaults to `cuda:0` and construction raises when CUDA is
    absent; pass `device="cpu"` to run the same path on the CPU with the
    kernels' plain PyTorch versions (tests)."""

    def __init__(
        self,
        config: MatchmakerConfig,
        logger: Logger,
        device: torch.device | str | None = None,
        row_block: int = 256,
        col_block: int = 2048,
        big_row_block: int = 1024,
        big_col_block: int = 1024,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CudaBackend needs a CUDA device (pass device='cpu' to "
                    "run the plain PyTorch path on the host)"
                )
            device = "cuda:0"
        self.device = torch.device(device)
        self.config = config
        self.logger = logger.with_fields(subsystem="matchmaker.cuda")
        cap = config.pool_capacity
        self.fn = config.numeric_fields
        self.fs = config.string_fields
        self.s = config.max_constraints
        self.k = config.candidates_per_ticket
        self.row_block = row_block
        self.col_block = min(col_block, cap)
        self.big_row_block = big_row_block
        self.big_col_block = min(big_col_block, cap)
        if cap % self.col_block or cap % self.big_col_block:
            raise ValueError("pool_capacity must be a multiple of col blocks")
        if cap > MAX_COLS and config.big_pool_threshold <= cap:
            raise ValueError(
                f"pool_capacity {cap} exceeds the big-kernel column limit "
                f"{MAX_COLS}; raise big_pool_threshold above the capacity "
                f"to stay on the exact scan"
            )
        self.d = config.embedding_dims
        self.registry = FieldRegistry(self.fn, self.fs)
        self.pool = PoolBuffer(
            cap, self.fn, self.fs, self.s, self.d,
            on_flush=self._observe_chunk,
            device=self.device,
        )
        # Host-side per-slot metadata (SlotStore.meta) is bound at attach().
        self.store = None
        self.meta = None
        # Exact query/value mirrors for vectorized match validation.
        s = self.s
        self.exact = {
            "v_num": np.full((cap, self.fn), np.nan),
            "v_str": np.zeros((cap, self.fs), dtype=np.int64),
            "q_lo": np.full((cap, self.fn), -np.inf),
            "q_hi": np.full((cap, self.fn), np.inf),
            "q_flo": np.ones((cap, self.fn)),
            "q_fhi": np.full((cap, self.fn), -1.0),
            "q_req": np.zeros((cap, self.fs), dtype=np.int64),
            "q_forb": np.zeros((cap, self.fs), dtype=np.int64),
            "q_sh_op": np.zeros((cap, s), dtype=np.int32),
            "q_sh_fld": np.zeros((cap, s), dtype=np.int32),
            "q_sh_lo": np.zeros((cap, s)),
            "q_sh_hi": np.zeros((cap, s)),
            "q_sh_term": np.zeros((cap, s), dtype=np.int64),
            "q_has_must": np.zeros(cap, dtype=bool),
            "q_has_should": np.zeros(cap, dtype=bool),
            "q_exact_ok": np.zeros(cap, dtype=bool),
        }
        # Per-slot classification masks (O(batch) numpy updates).
        self.host_only_mask = np.zeros(cap, dtype=bool)
        self._should_mask = np.zeros(cap, dtype=bool)
        self._should_count = 0
        self._emb_mask = np.zeros(cap, dtype=bool)
        self._emb_count = 0
        # Pure-pairs tracking (device_pairing gate): a ticket is
        # "pair-shaped" iff solo 1v1 (min==max==2, one presence,
        # count_multiple 1|2).
        self._nonpair_mask = np.zeros(cap, dtype=bool)
        self._nonpair_count = 0
        # Per-process scratch: slots claimed by an accepted match this call.
        self._sel_mask = np.zeros(cap, dtype=bool)
        # Monotone lower bound on live created_seq: keeps the small scan's
        # wait-time tie-break penalty small on long-lived servers.
        self._created_base = 0
        # Pipelined-interval state: dispatched-but-uncollected work,
        # oldest first. A slot in flight is not re-dispatched (mask
        # cleared on collection and on slot reuse by a new add).
        self._pipeline_queue: deque = deque()
        self._in_flight_mask = np.zeros(cap, dtype=bool)
        # Insertion-ordered slot ring: adds append, so the ring IS the
        # (created_at, created_seq) dispatch order. Entries of reused slots
        # are voided on re-add; a non-monotone created_at flags the ring
        # unsorted and dispatch falls back to an exact lexsort until the
        # next compaction re-sorts it.
        self._ring = np.empty(2 * cap, dtype=np.int32)
        self._ring_valid = np.zeros(2 * cap, dtype=bool)
        self._ring_pos = np.full(cap, -1, dtype=np.int64)
        self._ring_n = 0
        self._ring_last_created = np.iinfo(np.int64).min
        self._ring_unsorted = False
        self._dev_mask_scratch = np.zeros(cap, dtype=bool)
        # query string -> CompiledQuery | None (None = host-only).
        self._cq_cache: dict[str, CompiledQuery | None] = {}
        # Observed numeric value range per field (the stage-1 bucket
        # grid); stale-wide ranges only cost precision, never correctness.
        self._grid_lo = np.full(self.fn, np.inf)
        self._grid_hi = np.full(self.fn, -np.inf)

    def attach(self, store):
        """Bind the LocalMatchmaker's SlotStore: one slot space shared by
        host metadata, reverse maps, and device rows."""
        self.store = store
        self.meta = store.meta

    # -------------------------------------------------- pool notifications

    def _observe_chunk(self, rows: dict[str, np.ndarray]):
        valid = (rows["flags"] & FLAG_VALID) != 0
        num = rows["num"][valid]
        if not len(num):
            return
        real = num < CLAMP  # excludes the MISSING sentinel
        masked_lo = np.where(real, num, np.inf).min(axis=0)
        masked_hi = np.where(real, num, -np.inf).max(axis=0)
        np.minimum(self._grid_lo, masked_lo, out=self._grid_lo)
        np.maximum(self._grid_hi, masked_hi, out=self._grid_hi)

    def on_add(self, ticket: MatchmakerTicket, slot: int, pool_id: int = 0):
        # Validate and compile everything BEFORE mutating backend state, so
        # a rejected add leaves the backend exactly as it was (the caller
        # rolls back its SlotStore registration on raise).
        emb = np.zeros(self.d, dtype=np.float32)
        if ticket.embedding is not None:
            e = np.asarray(ticket.embedding, dtype=np.float32)
            if e.shape != (self.d,):
                raise ValueError(f"embedding shape {e.shape} != ({self.d},)")
            emb = e

        num, strs, overflow = compile_features(ticket, self.registry)
        host_only = overflow
        cq: CompiledQuery | None = None
        if not host_only:
            # Compiled queries are pure functions of (query string,
            # registry assignments, constraint budget); the registry only
            # appends, so earlier compiles stay valid.
            hit = self._cq_cache.get(ticket.query, _CQ_MISS)
            if hit is not _CQ_MISS:
                cq = hit
            else:
                try:
                    cq = compile_query(ticket, self.registry, self.s)
                except HostOnlyQuery as e:
                    self.logger.debug(
                        "host-only query", ticket=ticket.ticket, reason=str(e)
                    )
                    cq = None
                if len(self._cq_cache) >= 8192:
                    self._cq_cache.clear()
                self._cq_cache[ticket.query] = cq
            if cq is None:
                host_only = True

        flags = FLAG_VALID
        if cq is not None:
            if cq.has_must:
                flags |= FLAG_HAS_MUST
            if cq.has_should:
                flags |= FLAG_HAS_SHOULD
            if cq.never:
                flags |= FLAG_NEVER

        fn, fs, s = self.fn, self.fs, self.s
        row = {
            "emb": emb,
            "num": num,
            "str": strs,
            # Host-only queries store accept-all constraints so the reverse
            # (mutual) direction treats them as accepting; the host
            # post-validation applies their real query.
            "n_lo": cq.n_lo if cq else np.full(fn, FULL_LO, np.float32),
            "n_hi": cq.n_hi if cq else np.full(fn, FULL_HI, np.float32),
            "n_flo": cq.n_flo if cq else np.ones(fn, np.float32),
            "n_fhi": cq.n_fhi if cq else np.full(fn, -1.0, np.float32),
            "s_req": cq.s_req if cq else np.zeros(fs, np.int32),
            "s_forb": cq.s_forb if cq else np.zeros(fs, np.int32),
            "sh_op": cq.sh_op if cq else np.zeros(s, np.int32),
            "sh_fld": cq.sh_fld if cq else np.zeros(s, np.int32),
            "sh_lo": cq.sh_lo if cq else np.zeros(s, np.float32),
            "sh_hi": cq.sh_hi if cq else np.zeros(s, np.float32),
            "sh_term": cq.sh_term if cq else np.zeros(s, np.int32),
            "sh_boost": cq.sh_boost if cq else np.zeros(s, np.float32),
            "min_count": np.int32(ticket.min_count),
            "max_count": np.int32(ticket.max_count),
            "party": np.int32(
                hash_str(ticket.party_id) if ticket.party_id else 0
            ),
            "pool_id": np.int32(pool_id),
            "created": np.int32(ticket.created_seq),
            "flags": np.int32(flags),
        }
        self.pool.add(slot, row)
        if len(self.store) == 1:
            self._created_base = ticket.created_seq
        self._ring_append(slot)
        self._in_flight_mask[slot] = False  # slot reuse: new ticket
        self.host_only_mask[slot] = host_only
        if host_only:
            # Host-only tickets run the O(actives x pool) oracle: few by
            # design, loud when they pile up.
            n = int(self.host_only_mask.sum())
            if n in (100, 1000, 10_000):
                self.logger.warn(
                    "host-only matchmaker tickets piling up — check "
                    "numeric_fields/string_fields/max_constraints sizing "
                    "(3 numeric + 2 string slots are builtin)",
                    count=n,
                )
        has_should = cq is not None and cq.has_should
        self._should_mask[slot] = has_should
        self._should_count += has_should
        has_emb = ticket.embedding is not None
        self._emb_mask[slot] = has_emb
        self._emb_count += has_emb
        nonpair = not (
            ticket.min_count == 2
            and ticket.max_count == 2
            and ticket.count == 1
            and ticket.count_multiple in (1, 2)
        )
        self._nonpair_mask[slot] = nonpair
        self._nonpair_count += nonpair

        ex = self.exact
        num64, str64 = exact_features(ticket, self.registry)
        ex["v_num"][slot] = num64
        ex["v_str"][slot] = str64
        if cq is not None:
            # Pure query bounds only: count-range compatibility is a
            # candidate-search filter plus the assembler's size check,
            # NOT part of mutual query acceptance.
            ex["q_lo"][slot] = cq.n_lo64
            ex["q_hi"][slot] = cq.n_hi64
            ex["q_flo"][slot] = cq.n_flo64
            ex["q_fhi"][slot] = cq.n_fhi64
            ex["q_req"][slot] = cq.s_req64
            ex["q_forb"][slot] = cq.s_forb64
            ex["q_sh_op"][slot] = cq.sh_op
            ex["q_sh_fld"][slot] = cq.sh_fld
            ex["q_sh_lo"][slot] = cq.sh_lo64
            ex["q_sh_hi"][slot] = cq.sh_hi64
            ex["q_sh_term"][slot] = cq.sh_term64
            ex["q_has_must"][slot] = cq.has_must
            ex["q_has_should"][slot] = cq.has_should
            ex["q_exact_ok"][slot] = True
        else:
            ex["q_exact_ok"][slot] = False

    def on_remove_slots(self, slots: np.ndarray):
        """Bulk removal by slot array (O(batch) numpy)."""
        if len(slots) == 0:
            return
        slots = np.asarray(slots, dtype=np.int32)
        self.pool.remove_slots(slots)
        self.host_only_mask[slots] = False
        self._should_count -= int(self._should_mask[slots].sum())
        self._should_mask[slots] = False
        self._emb_count -= int(self._emb_mask[slots].sum())
        self._emb_mask[slots] = False
        self._nonpair_count -= int(self._nonpair_mask[slots].sum())
        self._nonpair_mask[slots] = False
        self._in_flight_mask[slots] = False

    # -------------------------------------------------------------- process

    def process_slots(
        self,
        active_slots: np.ndarray,  # i32 [A], interval-bumped by the caller
        last_interval: np.ndarray,  # bool [A]
        *,
        max_intervals: int,
        rev_precision: bool,
    ) -> tuple[MatchBatch, np.ndarray, np.ndarray]:
        """One interval, fully columnar: returns (batch, matched_slots,
        reactivate_slots). The caller (LocalMatchmaker) owns interval
        bumping, expiry deactivation, and store removal of matched_slots.
        A device failure raises out of here (the caller keeps the tickets
        pooled and gives expiring actives their attempt back)."""
        pipelined = self.config.interval_pipelining
        host_sel = self.host_only_mask[active_slots]
        n_host = int(host_sel.sum())
        deferred_slots = None
        if n_host:
            host_slots = active_slots[host_sel]
            device_slots = active_slots[~host_sel]
            device_last = last_interval[~host_sel]
            budget = self.config.host_budget_per_interval
            if budget > 0 and n_host > budget:
                # Cap the O(actives x pool) oracle fallback per interval:
                # oldest tickets go first, the rest wait (still active).
                order = np.argsort(
                    self.meta["created"][host_slots], kind="stable"
                )
                deferred_slots = host_slots[order[budget:]]
                host_slots = host_slots[order[:budget]]
                self.logger.warn(
                    "host-only fallback over budget; deferring",
                    budget=budget,
                    deferred=n_host - budget,
                )
        else:
            host_slots = None
            device_slots = active_slots
            device_last = last_interval
        # Only work queued BEFORE this call may be collected this call:
        # this interval's own dispatch always gets one interval of overlap.
        collectable = len(self._pipeline_queue)

        if pipelined and self._pipeline_queue:
            # A slot dispatched and awaiting collection is not dispatched
            # again: its duplicate's matches would all drop as stale.
            ff = ~self._in_flight_mask[device_slots]
            device_slots = device_slots[ff]
            device_last = device_last[ff]

        sel = self._sel_mask
        sel[:] = False
        flat_parts: list[np.ndarray] = []
        size_parts: list[np.ndarray] = []
        # Slots whose pipelined match was dropped after they may already
        # have gone inactive, and budget-deferred host-only slots, get
        # another active interval.
        react_parts: list[np.ndarray] = []
        if deferred_slots is not None and len(deferred_slots):
            react_parts.append(deferred_slots.astype(np.int32))

        work = None
        if len(device_slots):
            device_slots, device_last = self._order_dispatch(
                device_slots, device_last
            )
            self.pool.flush()
            pending = self._dispatch(device_slots, device_last, rev_precision)
            gen_snap = self.store.gen.copy() if pipelined else self.store.gen
            work = (pending, device_slots, gen_snap)
            if pipelined:
                # Queued; collection drains only completed results, so the
                # device pass and its host tail overlap everything else
                # (ticket properties are immutable, so candidates cannot go
                # stale — only dead or reused slots, masked at collection).
                self._in_flight_mask[device_slots] = True
                self._pipeline_queue.append(work)
                work = None

        ready_works: list[tuple] = []
        if work is not None:
            ready_works.append(work)
        if pipelined:
            # Oldest first; stop at the first unfinished cohort. More than
            # two queued forces a blocking drain (backpressure).
            while collectable > 0 and (
                _work_ready(self._pipeline_queue[0])
                or len(self._pipeline_queue) > 2
            ):
                ready_works.append(self._pipeline_queue.popleft())
                collectable -= 1
            if (
                collectable > 0
                and not ready_works
                and not len(device_slots)
                and host_slots is None
            ):
                # Every remaining active is in flight and nothing came back
                # yet: block on the head instead of livelocking back-to-back
                # process() calls.
                ready_works.append(self._pipeline_queue.popleft())

        if host_slots is not None:
            # Runs while the device computes. The oracle's "let them wait"
            # rule reads ticket intervals: oracle_view syncs them first.
            host_actives, _, pool_view = self.store.oracle_view(host_slots)
            host_matched = process_default(
                host_actives,
                pool_view,
                max_intervals=max_intervals,
                rev_precision=rev_precision,
            )
            for entry_set in host_matched:
                uniq = list(dict.fromkeys(e.ticket for e in entry_set))
                slots_m = np.asarray(
                    [self.store.slot_by_id(t) for t in uniq], dtype=np.int32
                )
                flat_parts.append(slots_m)
                size_parts.append(np.asarray([len(slots_m)], dtype=np.int64))
                sel[slots_m] = True

        for work in ready_works:
            self._accept_work(
                work, sel, flat_parts, size_parts, react_parts, pipelined
            )
        return self._finalize_batch(sel, flat_parts, size_parts, react_parts)

    def collect_ready(self):
        """Drain completed pipelined cohorts outside process(), so a cohort
        delivers as soon as its device pass + host assembly finish.
        Returns (batch, matched_slots, reactivate) or None when nothing is
        ready."""
        if not self._pipeline_queue:
            return None
        ready_works: list[tuple] = []
        while self._pipeline_queue and _work_ready(self._pipeline_queue[0]):
            ready_works.append(self._pipeline_queue.popleft())
        if not ready_works:
            return None
        sel = self._sel_mask
        sel[:] = False
        flat_parts: list[np.ndarray] = []
        size_parts: list[np.ndarray] = []
        react_parts: list[np.ndarray] = []
        for work in ready_works:
            self._accept_work(
                work, sel, flat_parts, size_parts, react_parts, pipelined=True
            )
        return self._finalize_batch(sel, flat_parts, size_parts, react_parts)

    def pipeline_depth(self) -> int:
        return len(self._pipeline_queue)

    def _accept_work(
        self, work, sel, flat_parts, size_parts, react_parts, pipelined
    ):
        w_pending, w_slots, w_gen = work
        current = w_slots[w_gen[w_slots] == self.store.gen[w_slots]]
        if pipelined:
            # Release only slots whose in-flight claim is still THIS
            # cohort's: a slot freed, reused and re-dispatched by a later
            # queued cohort (gen changed) keeps its bit.
            self._in_flight_mask[current] = False
        try:
            n_matches, offsets, flat, ok = self._collect(w_pending)
        except Exception as e:
            # Cohort lost (worker or fetch error): its claims are released
            # above; the surviving tickets get another active interval.
            live = current[self.store.alive[current]].astype(np.int32)
            self.store.reactivate(live)
            self.logger.error(
                "cohort collect failed", error=str(e), reactivated=len(live)
            )
            return
        total = int(offsets[n_matches])
        flat_t = flat[:total]
        sizes = (offsets[1 : n_matches + 1] - offsets[:n_matches]).astype(
            np.int64
        )
        mid = np.repeat(np.arange(n_matches), sizes)
        # stale: slot reused between dispatch and collection; dead: removed
        # meanwhile; sel: claimed by an earlier accepted match this call.
        bad_e = (
            (w_gen[flat_t] != self.store.gen[flat_t])
            | ~self.store.alive[flat_t]
            | sel[flat_t]
        )
        bad = ~ok
        if bad_e.any():
            bad |= np.bincount(mid[bad_e], minlength=n_matches) > 0
        if pipelined and bad.any():
            # Only the pipeline lag can strand an inactive ticket;
            # non-pipelined drops keep reference single-shot semantics.
            dropped = flat_t[bad[mid]]
            dropped = dropped[self.store.alive[dropped] & ~sel[dropped]]
            react_parts.append(dropped)
        good = ~bad
        good_flat = flat_t[good[mid]]
        sel[good_flat] = True
        flat_parts.append(good_flat)
        size_parts.append(sizes[good])

    def _finalize_batch(self, sel, flat_parts, size_parts, react_parts):
        if flat_parts:
            matched_slots = np.concatenate(flat_parts).astype(
                np.int32, copy=False
            )
            all_sizes = np.concatenate(size_parts)
            offsets_out = np.zeros(len(all_sizes) + 1, dtype=np.int64)
            np.cumsum(all_sizes, out=offsets_out[1:])
        else:
            matched_slots = np.zeros(0, dtype=np.int32)
            offsets_out = np.zeros(1, dtype=np.int64)
        # Ticket snapshot deferred: LocalMatchmaker binds the removal
        # path's parked object array (same slots, same order).
        batch = MatchBatch(offsets_out, matched_slots, counts=self.meta["count"])
        if react_parts:
            reactivate = np.unique(np.concatenate(react_parts))
            reactivate = reactivate[~sel[reactivate]].astype(np.int32)
        else:
            reactivate = np.zeros(0, dtype=np.int32)
        return batch, matched_slots, reactivate

    def wait_idle(self, timeout: float | None = None):
        """Block until every dispatched cohort's fetch + host assembly
        completed (results stay queued for the next collection)."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        for work in list(self._pipeline_queue):
            left = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            work[0][1].join(left)

    # ----------------------------------------------------- dispatch order

    def _ring_append(self, slot: int):
        if self._ring_n == len(self._ring):
            self._ring_compact()
        old = self._ring_pos[slot]
        if old >= 0:
            self._ring_valid[old] = False  # slot reuse: void the old entry
        pos = self._ring_n
        self._ring[pos] = slot
        self._ring_valid[pos] = True
        self._ring_pos[slot] = pos
        self._ring_n = pos + 1
        created = self.meta["created"][slot]
        if created < self._ring_last_created:
            self._ring_unsorted = True
        else:
            self._ring_last_created = created

    def _ring_compact(self):
        """Drop voided/dead entries (and re-sort if flagged): runs when the
        ring fills, amortised O(1) per add."""
        n = self._ring_n
        ring = self._ring[:n]
        keep = self._ring_valid[:n] & self.store.alive[ring]
        # Dropped entries release their slots' back-pointers, or a reused
        # slot's stale position would void whatever entry sits there now.
        self._ring_pos[ring[~keep]] = -1
        live = ring[keep]
        if self._ring_unsorted:
            meta = self.meta
            order = np.lexsort(
                (meta["created_seq"][live], meta["created"][live])
            )
            live = live[order]
            self._ring_unsorted = False
        m = len(live)
        if m == len(self._ring):  # live <= capacity < ring size, always
            raise RuntimeError("slot ring compaction found no free space")
        self._ring[:m] = live
        self._ring_valid[:m] = True
        self._ring_valid[m:] = False
        self._ring_pos[live] = np.arange(m, dtype=np.int64)
        self._ring_n = m
        self._ring_last_created = (
            self.meta["created"][live[-1]] if m else np.iinfo(np.int64).min
        )

    def _order_dispatch(self, device_slots, device_last):
        """Order (device_slots, device_last) oldest-first by (created_at,
        created_seq). Fast path reads the insertion ring; the lexsort
        fallback covers unsorted rings and any ring/membership drift."""
        ordered = None
        if not self._ring_unsorted:
            dm = self._dev_mask_scratch
            dm[device_slots] = True
            ring = self._ring[: self._ring_n]
            keep = self._ring_valid[: self._ring_n] & dm[ring]
            ordered = np.ascontiguousarray(ring[keep])
            dm[device_slots] = False
            if len(ordered) != len(device_slots):
                ordered = None  # drift: resolve exactly
        if ordered is None:
            meta = self.meta
            order = np.lexsort(
                (
                    meta["created_seq"][device_slots],
                    meta["created"][device_slots],
                )
            )
            ordered = np.ascontiguousarray(device_slots[order])
            last = np.ascontiguousarray(device_last[order], dtype=np.uint8)
            return ordered, last
        lm = self._dev_mask_scratch
        lm[device_slots] = device_last.astype(bool)
        last = np.ascontiguousarray(lm[ordered], dtype=np.uint8)
        lm[device_slots] = False
        return ordered, last

    # ------------------------------------------------------------- dispatch

    def _dispatch(self, slots: np.ndarray, last: np.ndarray, rev: bool):
        """Launch the device top-K for the given active slots; returns a
        pending handle whose fetch and host assembly are already running
        on a worker thread."""
        hw = self.pool.high_water
        with_should = self._should_count > 0
        with_embedding = self._emb_count > 0
        dev = self.device
        if hw >= self.config.big_pool_threshold:
            bm, bn = self.big_row_block, self.big_col_block
            n_cols = big_cols(hw, bn, self.pool.capacity)
            # Rows pad to a power-of-two number of row blocks.
            a_pad = _pow2_blocks(-(-len(slots) // bm)) * bm
            use_pairs = self._use_pairs()
            grid_lo, grid_inv = self._grid_params()
            slots_dev = torch.from_numpy(pad_to(slots, a_pad, -1)).to(dev)
            cand_dev = topk_candidates_big(
                self.pool.tensors,
                slots_dev,
                torch.from_numpy(grid_lo).to(dev),
                torch.from_numpy(grid_inv).to(dev),
                fn=self.fn,
                fs=self.fs,
                n_cols=n_cols,
                # Pairs keep the full candidate width: coverage is set by
                # list diversity, not by handshake rounds.
                k=self.k,
                rev=rev,
                with_should=with_should,
                with_embedding=with_embedding,
                bn=bn,
                emb_scale=self.config.emb_score_scale,
                # The handshake needs eligible candidates, not the exact
                # (-score, created) order: skip stage 2's second sort.
                order_exact=not use_pairs,
            )
            if use_pairs:
                partner, proposer = pair_partners(
                    cand_dev, slots_dev, cap=self.pool.capacity
                )
                return self._bg_asm("pairs", (partner, proposer), slots, last, rev)
            return self._bg_asm("big", (cand_dev,), slots, last, rev)

        # Small-pool exact path.
        a_pad = self.row_block * _pow2_blocks(-(-len(slots) // self.row_block))
        col_blocks = -(-hw // self.col_block)
        n_cols = min(
            self.col_block * _pow2_blocks(col_blocks), self.pool.capacity
        )
        scores, cand = topk_candidates(
            self.pool.tensors,
            torch.from_numpy(pad_to(slots, a_pad, -1)).to(dev),
            k=min(self.k, n_cols),
            br=self.row_block,
            bc=self.col_block,
            rev=rev,
            n_cols=n_cols,
            with_should=with_should,
            with_embedding=with_embedding,
            created_base=int(self._created_base),
        )
        return self._bg_asm("small", (scores, cand), slots, last, rev)

    def _use_pairs(self) -> bool:
        """Device-side 1v1 grouping is eligible when configured and the
        whole pool is pure 1v1."""
        return self.config.device_pairing and self._nonpair_count == 0

    def _grid_params(self):
        """Bucket grid (lo, 1/width) per numeric field for stage 1."""
        width = self._grid_hi - self._grid_lo
        ok = np.isfinite(width) & (width >= 0)
        grid_lo = np.where(ok, self._grid_lo, 0.0).astype(np.float32)
        grid_inv = (
            1.0 / np.maximum(np.where(ok, width, 1.0), 1e-30)
        ).astype(np.float32)
        return grid_lo, grid_inv

    def _bg_asm(self, kind, dev_arrays, slots, last, rev):
        """Run the post-kernel tail on a worker thread: the D2H fetch
        (`.cpu()`, which waits for the device work queued before it, as
        C-contiguous numpy for the native assembler), the exact re-order
        of the small path's candidates, the native greedy assembly (ctypes
        drops the GIL), and the host validation of flagged matches. The
        numpy/C work reads only per-slot arrays whose staleness the accept
        step masks by gen/alive."""
        holder: dict = {}
        n_rows = len(slots)

        def _fetch(t):
            return np.ascontiguousarray(t.cpu().numpy())

        def _run(out=holder):
            try:
                if kind == "pairs":
                    partner = _fetch(dev_arrays[0])[:n_rows]
                    proposer = _fetch(dev_arrays[1])[:n_rows]
                    out["asm"] = self._assemble_pairs(
                        slots, partner, proposer, rev
                    )
                    return
                if kind == "big":
                    # Already ordered by (-score, created) on the device.
                    cand_np = _fetch(dev_arrays[0])[:n_rows]
                else:
                    scores_np = _fetch(dev_arrays[0])[:n_rows]
                    cand_np = _fetch(dev_arrays[1])[:n_rows]
                    cand_np = self._order_small(scores_np, cand_np)
                out["asm"] = self._assemble(slots, last, cand_np, rev)
            except Exception as e:  # surfaced at collect
                out["err"] = e
            finally:
                out["done"] = True

        thread = threading.Thread(target=_run, daemon=True)
        thread.start()
        return (holder, thread)

    def _assemble(self, slots, last, cand_np, rev):
        """Native greedy assembly with in-assembly exact validation (f64
        mirrors); only matches flagged needs_host (a member without an
        exact query mirror under mutual validation) take the AST check."""
        meta = self.meta
        n_matches, offsets, flat, needs_host = native.assemble_arrays(
            slots,
            last,
            cand_np,
            min_count=meta["min_count"],
            max_count=meta["max_count"],
            count_multiple=meta["count_multiple"],
            count=meta["count"],
            intervals=meta["intervals"],
            created=meta["created"],
            session_hashes=meta["session_hashes"],
            session_counts=meta["session_counts"],
            exact=self.exact,
            rev=rev,
        )
        ok = self._validate_flagged(n_matches, offsets, flat, needs_host, rev)
        return n_matches, offsets, flat, ok

    def _assemble_pairs(self, slots, partner, proposer, rev):
        """Host tail of the device-pairing path: exact (f64) validation of
        the device-formed pairs, vectorised over all pairs — forward query
        acceptance (both directions under rev) and session overlap. A pair
        failing here is dropped (its members retry next interval)."""
        idx = np.nonzero(proposer & (partner >= 0))[0]
        i_slots = slots[idx]
        j_slots = partner[idx].astype(np.int32)
        ok = self._exact_accepts_vec(i_slots, j_slots)
        needs_host = np.zeros(len(idx), dtype=np.uint8)
        if rev:
            j_ok = self.exact["q_exact_ok"][j_slots]
            back = self._exact_accepts_vec(j_slots, i_slots)
            ok &= np.where(j_ok, back, True)
            # Host-only passive member: its real query needs the AST check.
            needs_host = (~j_ok).astype(np.uint8)
        ok &= (
            self.meta["session_hashes"][i_slots, 0]
            != self.meta["session_hashes"][j_slots, 0]
        )
        i_slots, j_slots = i_slots[ok], j_slots[ok]
        needs_host = needs_host[ok]
        n = len(i_slots)
        offsets = np.arange(0, 2 * n + 2, 2, dtype=np.int32)
        flat = np.empty(2 * n, dtype=np.int32)
        flat[0::2] = i_slots
        flat[1::2] = j_slots
        okv = self._validate_flagged(n, offsets, flat, needs_host, rev)
        return n, offsets, flat, okv

    def _exact_accepts_vec(self, q, v):
        """Vectorised mirror of the assembler's Exact::accepts (f64
        mirrors, 63-bit hashes): does q's query accept v's values, for
        slot arrays q, v elementwise."""
        ex = self.exact
        lo, hi = ex["q_lo"][q], ex["q_hi"][q]
        x = ex["v_num"][v]
        unconstrained = np.isinf(lo) & (lo < 0) & np.isinf(hi) & (hi > 0)
        ok = np.all(unconstrained | ((x >= lo) & (x <= hi)), axis=1)
        ok &= ~np.any((x >= ex["q_flo"][q]) & (x <= ex["q_fhi"][q]), axis=1)
        req, forb = ex["q_req"][q], ex["q_forb"][q]
        sv = ex["v_str"][v]
        ok &= np.all(
            ((req == 0) | (sv == req)) & ((forb == 0) | (sv != forb)),
            axis=1,
        )
        pure_should = ~ex["q_has_must"][q] & ex["q_has_should"][q]
        if pure_should.any():
            op, fld = ex["q_sh_op"][q], ex["q_sh_fld"][q]
            fn = ex["v_num"].shape[1]
            fs = ex["v_str"].shape[1]
            r = np.arange(len(q))[:, None]
            xv = x[r, np.minimum(fld, fn - 1)]
            sv2 = sv[r, np.minimum(fld, fs - 1)]
            term = ex["q_sh_term"][q]
            hit = (
                (
                    (op == SOP_NUM_RANGE)
                    & (xv >= ex["q_sh_lo"][q])
                    & (xv <= ex["q_sh_hi"][q])
                )
                | ((op == SOP_STR_EQ) & (term != 0) & (sv2 == term))
                | (op == SOP_ALL)
            )
            ok &= ~pure_should | np.any(hit, axis=1)
        # Missing exact mirror (host-only query): not decidable here.
        ok &= ex["q_exact_ok"][q]
        return ok

    def _order_small(self, scores_np, cand_np):
        """Exact re-sort of each candidate list by (-score, created): the
        small scan's wait-time epsilon only biased the top-K cutoff."""
        created_of = self.meta["created"][np.maximum(cand_np, 0)]
        created_of = np.where(cand_np < 0, np.iinfo(np.int64).max, created_of)
        by_created = np.argsort(created_of, axis=1, kind="stable")
        s2 = np.take_along_axis(scores_np, by_created, axis=1)
        by_score = np.argsort(-s2, axis=1, kind="stable")
        order = np.take_along_axis(by_created, by_score, axis=1)
        return np.ascontiguousarray(np.take_along_axis(cand_np, order, axis=1))

    def _collect(self, pending):
        """The worker thread's finished (n_matches, offsets, flat, ok) —
        free when the cohort was ready, a blocking join otherwise."""
        holder, thread = pending
        thread.join()
        if "err" in holder:
            raise holder["err"]
        return holder["asm"]

    # ----------------------------------------------------------- validation

    def _validate_flagged(self, n_matches, offsets, flat, needs_host, rev):
        """AST-validate only the matches the assembler could not check
        exactly (a member without an exact query mirror under mutual
        validation — host-only queries; reference validateMatch,
        server/matchmaker.go:1042-1068)."""
        ok = np.ones(n_matches, dtype=bool)
        idx = np.nonzero(needs_host[:n_matches])[0]
        if not len(idx):
            return ok
        ticket_at = self.store.ticket_at
        for i in idx:
            tickets = [ticket_at[s] for s in flat[offsets[i] : offsets[i + 1]]]
            if any(t is None for t in tickets):
                ok[i] = False
                continue
            if rev:
                ok[i] = all(
                    _mutual(a, b) for a in tickets for b in tickets if a is not b
                )
            else:
                searcher = tickets[-1]
                ok[i] = all(_mutual(searcher, m) for m in tickets[:-1])
        return ok

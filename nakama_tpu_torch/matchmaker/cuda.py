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
finished cohorts; the worker signals the delivery stage (local.py) the
moment its cohort is ready. Host-side per-slot metadata lives in
persistent numpy arrays, so an interval never loops over the pool in
Python.

Injected faults and device memory pressure (`faults.degrades`) never
raise out of an interval: they are classified (faults.py) and counted on
a circuit breaker. Consecutive transient failures — or one fatal one —
open it, and intervals then route every active through the bounded host
oracle until a half-open probe dispatch comes back clean. Any other
failure — a hand-written kernel that fails to build or launch, a CUDA
error surfacing at a fetch — raises out of the interval: the ladder
never hides a broken kernel. Cohorts whose fetch or assembly fails or
wedges are reclaimed either way: their in-flight claims are released
and their tickets re-activated.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from .. import faults, native
from .. import tracing as trace_api
from ..config import MatchmakerConfig
from ..devobs import DEVOBS
from ..faults import (
    CLOSED, HALF_OPEN, STATE_CODE, CircuitBreaker, classify_exception, degrades,
)
from ..logger import Logger
from ..tracing import Tracing
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
    """Has this dispatched work's device pass + fetch + host assembly
    completed? The ready stamp (written before the completion signal
    fires) is authoritative: a collector woken BY the signal must see a
    ready head even though the worker thread is still unwinding its last
    microseconds; thread liveness is only the fallback."""
    holder = work[0][1]
    return "t_ready" in holder or not work[0][-1].is_alive()


def _work_deadline(work: tuple) -> float | None:
    """The cohort's delivery deadline (perf_counter seconds): dispatch
    time + one interval. Delivery past this point means the cohort
    slipped its own interval."""
    return work[0][1].get("deadline")


class CudaBackend:
    """ProcessBackend running the device path on a CUDA device.

    `device` defaults to `cuda:0` and construction raises when CUDA is
    absent; pass `device="cpu"` to run the same path on the CPU with the
    kernels' plain PyTorch versions (tests). `metrics` is an optional
    sink under the JAX package's metric names; the port has no registry
    of its own yet."""

    def __init__(
        self,
        config: MatchmakerConfig,
        logger: Logger,
        metrics=None,
        device: torch.device | str | None = None,
        row_block: int = 256,
        col_block: int = 2048,
        big_row_block: int = 1024,
        big_col_block: int = 1024,
        tracing: Tracing | None = None,
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
        self.metrics = metrics
        self.tracing = tracing if tracing is not None else Tracing()
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
        # Degradation ladder (faults.py): consecutive transient device
        # failures (dispatch or collect; fatal errors immediately) open
        # this breaker and intervals route every active through the
        # bounded host-oracle fallback until a half-open probe closes it.
        self.breaker = CircuitBreaker(
            threshold=config.breaker_threshold,
            cooldown_s=config.breaker_cooldown_ms / 1000.0,
            on_transition=self._on_breaker_transition,
        )
        self.inflight_reclaimed = 0  # ledger total (tests/console)
        self._sweep_tick = 0  # gates the O(capacity) orphan scan
        # Cohort-completion signal (event-driven delivery): called from
        # the cohort's worker thread the moment its device pass + host
        # assembly finish (success OR failure). None = nobody listening.
        self._ready_cb = None
        # Monotonic per-dispatch sequence: head_token identity (a freed
        # holder's id() can be reused by the next cohort's).
        self._dispatch_counter = 0
        # Cohorts accepted by the CURRENT process/collect call: (ledger
        # entry, matched slot array) pairs, so the ticket-trace closer
        # attributes each matched ticket to ITS cohort's stage chain.
        self._accepted_cohorts: list[tuple[dict, np.ndarray]] = []
        # Device telemetry: the named device entry points this backend
        # drives (device2.py adds its layers' clocks under the score).
        for kernel in (
            "matchmaker.scatter",
            "matchmaker.score",
            "matchmaker.assign",
            "matchmaker.fetch",
        ):
            DEVOBS.register(kernel)

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

    # ------------------------------------------------- degradation ladder

    def _on_breaker_transition(self, old: str, new: str, reason: str):
        if self.metrics is not None:
            self.metrics.mm_backend_state.set(STATE_CODE[new])
        self.tracing.record_breaker(
            kind="matchmaker_backend", old=old, new=new, reason=reason
        )
        log = self.logger.warn if new == "open" else self.logger.info
        log(
            "matchmaker backend breaker transition",
            old=old,
            new=new,
            reason=reason,
            cooldown_s=round(self.breaker.cooldown_s, 3),
        )

    def _note_backend_failure(
        self, stage: str, exc: Exception, crumb: dict, probe: bool = True
    ):
        """Classify + record one device-path failure (dispatch or
        collect) that the ladder absorbs (`faults.degrades`: injected
        faults, device memory pressure). Transient failures count
        toward the breaker threshold; a fatal one opens it immediately.

        `probe=False` marks a failure that is NOT the half-open probe's
        answer (a stale pre-outage cohort draining late): while a probe
        is being judged, such a failure is logged and counted but must
        not be booked as the probe failing."""
        kind = classify_exception(exc)
        if probe or self.breaker.state != HALF_OPEN:
            self.breaker.record_failure(fatal=(kind == "fatal"))
        # The failure (and the breaker state it drove) lands on the
        # active trace span too: an injected `device.dispatch` fault
        # yields a tail-kept error trace carrying its breaker event.
        trace_api.add_event(
            "breaker",
            stage=stage,
            kind=kind,
            error=str(exc),
            state=self.breaker.state,
        )
        key = f"{stage}_failed"
        crumb[key] = crumb.get(key, 0) + 1
        if self.metrics is not None:
            self.metrics.mm_backend_failures.labels(
                stage=stage, kind=kind
            ).inc()
        log = self.logger.error if kind == "fatal" else self.logger.warn
        log(
            "device backend failure",
            stage=stage,
            kind=kind,
            error=str(exc),
            breaker=self.breaker.state,
        )

    def _reclaim_inflight(self, slots: np.ndarray, why: str) -> int:
        """Re-activate the live ones of `slots` (their in-flight claims
        are the caller's to release) so they are matchable next
        interval. Returns the number reclaimed."""
        if not len(slots):
            return 0
        live = slots[self.store.alive[slots]].astype(np.int32)
        self.store.reactivate(live)
        n = len(live)
        if n:
            self.inflight_reclaimed += n
            if self.metrics is not None:
                self.metrics.mm_inflight_reclaimed.inc(n)
            self.tracing.record_breaker(
                kind="inflight_reclaim", slots=n, why=why
            )
        return n

    def _reclaim_stale(self):
        """Backstop sweep, run once per process_slots call: (1) abandon
        queued cohorts still unfinished `inflight_reclaim_deadline_ms`
        PAST their delivery deadline (a wedged fetch/assembly thread —
        its eventual results are dropped with the queue entry) and free
        their slots; (2) clear in-flight bits not covered by ANY queued
        cohort. Either way no ticket is ever stranded un-matchable
        behind a claim nobody will release."""
        grace = self.config.inflight_reclaim_deadline_ms / 1000.0
        now = time.perf_counter()
        abandoned = False
        while self._pipeline_queue:
            head = self._pipeline_queue[0]
            dl = _work_deadline(head)
            if dl is None or _work_ready(head) or now <= dl + grace:
                break
            self._pipeline_queue.popleft()
            abandoned = True
            _, w_slots, _, _, w_gen = head
            mine = w_slots[w_gen[w_slots] == self.store.gen[w_slots]]
            self._in_flight_mask[mine] = False
            n = self._reclaim_inflight(mine, "wedged cohort abandoned")
            if head[0][1].get("probe"):
                # The abandoned cohort WAS the half-open probe: book its
                # wedge as the probe's failure, or the breaker waits
                # half-open forever for an answer that can never come.
                self.breaker.record_failure()
            self._close_cohort_trace(
                head[0][1], status="error",
                message=f"wedged cohort abandoned {round(now - dl, 1)}s"
                " past deadline",
            )
            self.logger.warn(
                "abandoned wedged pipelined cohort",
                overdue_s=round(now - dl, 1),
                slots_reclaimed=n,
            )
        # The orphan scan costs O(capacity): gate it to the one event
        # that can orphan bits (a cohort abandoned above) plus a sparse
        # belt-and-braces cadence.
        self._sweep_tick += 1
        if not (abandoned or self._sweep_tick % 64 == 0):
            return
        if not self._in_flight_mask.any():
            return
        if self._pipeline_queue:
            covered = np.zeros(self.pool.capacity, dtype=bool)
            for w in self._pipeline_queue:
                covered[w[1]] = True
            orphan = self._in_flight_mask & ~covered
        else:
            orphan = self._in_flight_mask.copy()
        if orphan.any():
            slots = np.nonzero(orphan)[0].astype(np.int32)
            self._in_flight_mask[orphan] = False
            self._reclaim_inflight(slots, "orphaned in-flight claim")

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
        Injected faults and device memory pressure do not raise out of
        here: they go to the breaker, and their slots come back as
        reactivate_slots. Any other failure (a kernel that fails to
        build or launch, a CUDA error) raises: the ladder never serves a
        broken kernel's pool from the host oracle."""
        pipelined = self.config.interval_pipelining
        self._accepted_cohorts = []
        # Device telemetry: one warmup tick per interval (also folds in
        # the device times of calls whose events have completed).
        DEVOBS.interval_tick()
        # Backstop reclamation first: wedged/orphaned in-flight claims
        # must release BEFORE this interval filters its dispatch by the
        # in-flight mask, or a stranded slot stays invisible forever.
        self._reclaim_stale()
        # Degradation ladder: an OPEN breaker routes EVERY active
        # through the bounded host-oracle fallback (the path host-only
        # queries already take; host_budget_per_interval still caps it,
        # overflow defers oldest-first). A half-open probe lets one
        # dispatch through to test the device path.
        device_allowed = self.breaker.allow()
        probe_pending = device_allowed and self.breaker.state == HALF_OPEN
        if device_allowed:
            host_sel = self.host_only_mask[active_slots]
        else:
            host_sel = np.ones(len(active_slots), dtype=bool)
        n_host = int(host_sel.sum())
        # Per-interval breadcrumb: host stage timings under the JAX
        # package's crumb keys.
        crumb: dict = {
            "actives": len(active_slots),
            "host_actives": n_host,
        }
        if self.breaker.state != CLOSED:
            crumb["backend_state"] = self.breaker.state
        span = self.tracing.span
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
                deferred = n_host - budget
                crumb["host_deferred"] = deferred
                if self.metrics is not None:
                    self.metrics.counter_add(
                        "matchmaker_host_only_deferred", deferred
                    )
                self.logger.warn(
                    "host-only fallback over budget; deferring",
                    budget=budget,
                    deferred=deferred,
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
        # have gone inactive, budget-deferred host-only slots, and the
        # slots of a failed dispatch get another active interval.
        react_parts: list[np.ndarray] = []
        if deferred_slots is not None and len(deferred_slots):
            react_parts.append(deferred_slots.astype(np.int32))

        work = None
        probe_used = False
        if len(device_slots):
            device_slots, device_last = self._order_dispatch(
                device_slots, device_last
            )
            pending = None
            # Device-timeline window opens BEFORE the flush: the
            # cohort's ledger entry slices the kernel-event timeline
            # from here, so its scatter phase reads off the record too.
            t_window_wall = time.time()
            # Each dispatched cohort gets its own trace: root span over
            # flush+dispatch, held open until accept/abandon closes it
            # with the stage spans. A dispatch failure makes it an
            # error trace (tail-kept) carrying the breaker event.
            with trace_api.root_span(
                "matchmaker.cohort", actives=int(len(device_slots))
            ) as troot:
                try:
                    with span(crumb, "flush_s"):
                        self.pool.flush()
                    with span(crumb, "dispatch_s"):
                        pending = self._dispatch(
                            device_slots, device_last, rev_precision
                        )
                except Exception as e:
                    if not degrades(e):
                        raise
                    # A dispatch that dies strands nothing: no in-flight
                    # claim was taken yet, no cohort is queued, and the
                    # slots stay matchable next interval (the caller's
                    # expiry pass already deactivated min==max actives,
                    # so they re-activate via react_parts).
                    if troot is not None:
                        troot.set_status(
                            "error", f"{type(e).__name__}: {e}"
                        )
                    self._note_backend_failure("dispatch", e, crumb)
                    react_parts.append(device_slots.astype(np.int32))
                else:
                    pending[1]["t_window_wall"] = t_window_wall
                    if probe_pending:
                        # Only the probe cohort's successful collection
                        # may close the breaker (_accept_work).
                        pending[1]["probe"] = True
                        probe_used = True
                    if troot is not None:
                        # Keep the cohort trace open for the stage spans
                        # the accept path appends; released there, or by
                        # the reclaim path.
                        trace_api.TRACES.hold(troot.trace_id)
                        pending[1]["trace"] = (
                            troot.trace_id, troot.span_id,
                        )
                    gen_snap = (
                        self.store.gen.copy() if pipelined else self.store.gen
                    )
                    work = (
                        pending,
                        device_slots,
                        device_last,
                        len(device_slots),
                        gen_snap,
                    )
                    if pipelined:
                        # Queued; collection drains only completed
                        # results, so the device pass and its host tail
                        # overlap everything else (ticket properties are
                        # immutable, so candidates cannot go stale — only
                        # dead or reused slots, masked at collection).
                        self._in_flight_mask[device_slots] = True
                        self._pipeline_queue.append(work)
                        work = None
        if probe_pending and not probe_used:
            # The probe was granted but no dispatch launched: hand the
            # slot back so the next interval can probe.
            self.breaker.release_probe()

        ready_works: list[tuple] = []
        if work is not None:
            ready_works.append(work)
        if pipelined:
            # Oldest first; stop at the first unfinished cohort. More than
            # two queued forces a blocking drain (backpressure). An
            # overdue-but-unfinished head is NOT force-popped here: the
            # delivery stage's bounded join and the reclaim path own it.
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
                # Every remaining active is in flight and nothing came
                # back yet: block on the head instead of livelocking
                # back-to-back process() calls.
                ready_works.append(self._pipeline_queue.popleft())

        if host_slots is not None:
            # Runs while the device computes. The oracle's "let them wait"
            # rule reads ticket intervals: oracle_view syncs them first.
            with span(crumb, "host_s"):
                host_actives, _, pool_view = self.store.oracle_view(
                    host_slots
                )
                host_matched = process_default(
                    host_actives,
                    pool_view,
                    max_intervals=max_intervals,
                    rev_precision=rev_precision,
                )
                for entry_set in host_matched:
                    uniq = list(dict.fromkeys(e.ticket for e in entry_set))
                    slots_m = np.asarray(
                        [self.store.slot_by_id(t) for t in uniq],
                        dtype=np.int32,
                    )
                    flat_parts.append(slots_m)
                    size_parts.append(
                        np.asarray([len(slots_m)], dtype=np.int64)
                    )
                    sel[slots_m] = True

        for work in ready_works:
            self._accept_work(
                work, crumb, sel, flat_parts, size_parts, react_parts,
                pipelined,
            )
        batch, matched_slots, reactivate = self._finalize_batch(
            sel, flat_parts, size_parts, react_parts
        )
        crumb["matched_entries"] = batch.entry_count
        self.tracing.record(crumb)
        return batch, matched_slots, reactivate

    # ----------------------------------------------- pipeline state surface

    def set_ready_callback(self, cb):
        """Register the cohort-completion signal: `cb()` is invoked FROM
        THE COHORT'S WORKER THREAD whenever a dispatched cohort's device
        pass + host assembly finish (including on failure — a failed
        cohort must also be collected promptly so its slots reclaim).
        The callback must be cheap and thread-safe; the delivery stage
        passes a `loop.call_soon_threadsafe` wakeup. None unregisters."""
        self._ready_cb = cb

    def head_ready(self) -> bool:
        """Is the head cohort's device pass + assembly complete (its
        collection would be free, no blocking join)?"""
        return bool(self._pipeline_queue) and _work_ready(
            self._pipeline_queue[0]
        )

    def head_token(self):
        """Opaque identity of the current head cohort (None when the
        queue is empty): its monotonic dispatch sequence number, never
        reused. The delivery stage guard-joins each head at most once."""
        if not self._pipeline_queue:
            return None
        return self._pipeline_queue[0][0][1].get("dispatch_seq")

    def reclaim_stale(self):
        """Public reclamation entry for the delivery stage: abandon
        cohorts wedged `inflight_reclaim_deadline_ms` past their
        delivery deadline and clear orphaned in-flight claims BETWEEN
        process() calls."""
        self._reclaim_stale()

    def next_deadline(self) -> float | None:
        """Earliest delivery deadline among queued cohorts (perf_counter
        seconds), or None when nothing is in flight."""
        if not self._pipeline_queue:
            return None
        return _work_deadline(self._pipeline_queue[0])

    def pipeline_depth(self) -> int:
        return len(self._pipeline_queue)

    def pipeline_backlogged(self) -> bool:
        """True under genuine pipeline pressure — an unfinished head
        cohort that either already has a newer cohort stacked behind it
        or is close to its delivery deadline. The interval loop sheds
        its idle-gap work (GC pass, store drain, flush) for that gap."""
        if not self._pipeline_queue or _work_ready(self._pipeline_queue[0]):
            return False
        if len(self._pipeline_queue) > 1:
            return True
        deadline = _work_deadline(self._pipeline_queue[0])
        if deadline is None:
            return False
        guard = max(0.1, float(self.config.pipeline_deadline_guard_sec))
        return time.perf_counter() >= deadline - 2.0 * guard

    def join_head(self, until: float) -> bool:
        """Block (yielding the GIL to the cohort's worker thread) until
        the head cohort's assembly finishes or `until` (perf_counter
        seconds) passes. Returns readiness. Bounded twice: by the
        caller's `until`, and by the head's OWN interval — the join never
        blocks past `deadline + guard`, so a wedged worker costs the
        guard at most one bounded join; a head still unfinished past
        that belongs to the reclaim path."""
        try:
            # Runs in a worker thread (the delivery stage's to_thread)
            # while the event loop may pop the queue: the head can vanish
            # between an emptiness check and the subscript.
            head = self._pipeline_queue[0]
        except IndexError:
            return False
        dl = _work_deadline(head)
        if dl is not None:
            guard = max(0.1, float(self.config.pipeline_deadline_guard_sec))
            until = min(until, dl + guard)
        head[0][-1].join(max(0.0, until - time.perf_counter()))
        return _work_ready(head)

    def collect_ready(self, *, rev_precision: bool = False, block_until=None):
        """Drain completed pipelined cohorts outside process(), so a
        cohort delivers as soon as its device pass + host assembly
        finish. `block_until` (perf_counter seconds) bounds a blocking
        join of the head cohort. Returns (batch, matched_slots,
        reactivate) or None when nothing is ready."""
        if not self._pipeline_queue:
            return None
        self._accepted_cohorts = []
        if block_until is not None:
            self.join_head(block_until)
        ready_works: list[tuple] = []
        while self._pipeline_queue and _work_ready(self._pipeline_queue[0]):
            ready_works.append(self._pipeline_queue.popleft())
        if not ready_works:
            return None
        crumb: dict = {"midgap_collect": True}
        sel = self._sel_mask
        sel[:] = False
        flat_parts: list[np.ndarray] = []
        size_parts: list[np.ndarray] = []
        react_parts: list[np.ndarray] = []
        for work in ready_works:
            self._accept_work(
                work, crumb, sel, flat_parts, size_parts, react_parts,
                pipelined=True,
            )
        out = self._finalize_batch(sel, flat_parts, size_parts, react_parts)
        crumb["matched_entries"] = out[0].entry_count
        self.tracing.record(crumb)
        return out

    def _accept_work(
        self, work, crumb, sel, flat_parts, size_parts, react_parts,
        pipelined,
    ):
        span = self.tracing.span
        w_pending, w_slots, w_last, w_n, w_gen = work
        if pipelined:
            # Release only slots whose in-flight claim is still THIS
            # cohort's: a slot freed, reused and re-dispatched by a later
            # queued cohort (gen changed) keeps its bit.
            self._in_flight_mask[
                w_slots[w_gen[w_slots] == self.store.gen[w_slots]]
            ] = False
        with span(crumb, "collect_s"):
            # Fetch, ordering, native assembly and host validation ran on
            # the cohort's worker thread; a ready cohort hands back
            # finished matches and this join is free.
            try:
                n_matches, offsets, flat, ok = self._collect(w_pending)
            except Exception as e:
                # Cohort lost: its in-flight claims were released above,
                # so reclamation gives the surviving tickets another
                # active interval either way. An injected fault or
                # memory pressure goes to the breaker; anything else (an
                # illegal address surfacing at the fetch, an assembler
                # bug) raises once the slots are back.
                mine = w_slots[w_gen[w_slots] == self.store.gen[w_slots]]
                n = self._reclaim_inflight(mine, "cohort collect failed")
                crumb["collect_reclaimed"] = (
                    crumb.get("collect_reclaimed", 0) + n
                )
                self._close_cohort_trace(
                    w_pending[1], status="error",
                    message=f"collect failed: {e}",
                )
                if not degrades(e):
                    raise
                self._note_backend_failure(
                    "collect", e, crumb,
                    probe=bool(w_pending[1].get("probe")),
                )
                return
        # The cohort's full device→host round trip succeeded: reset the
        # breaker's failure streak; a half-open PROBE cohort closes it.
        if self.breaker.state == CLOSED or w_pending[1].get("probe"):
            self.breaker.record_success()
        holder = w_pending[1]
        t_disp = holder.get("t_dispatch")
        ledger = None  # written AFTER the accept span (accept_lag_s)
        if t_disp is not None:
            # Cohort delivery attribution, measured AFTER the join above
            # so a not-yet-ready cohort popped by backpressure (or the
            # synchronous path) charges its real wait to collect_lag.
            now = time.perf_counter()
            ready_lag = holder.get("t_ready", now) - t_disp
            fetch_lag = holder.get("t_fetched", now) - t_disp
            collect_lag = now - t_disp
            deadline = holder.get("deadline")
            slipped = pipelined and deadline is not None and now > deadline
            crumb.setdefault("cohort_ready_lag_ms", []).append(
                round(ready_lag * 1000, 1)
            )
            crumb.setdefault("cohort_fetch_lag_ms", []).append(
                round(fetch_lag * 1000, 1)
            )
            crumb.setdefault("cohort_collect_lag_ms", []).append(
                round(collect_lag * 1000, 1)
            )
            if slipped:
                crumb["cohort_slipped"] = crumb.get("cohort_slipped", 0) + 1
            # Per-cohort dispatch→delivered ledger, pipelined cohorts only
            # (the synchronous path's same-interval collects would
            # pollute it).
            if pipelined:
                ledger = dict(
                    ready_lag_s=round(ready_lag, 3),
                    fetch_lag_s=round(fetch_lag, 3),
                    collect_lag_s=round(collect_lag, 3),
                    slipped=bool(slipped),
                    dispatched_ts=holder.get("t_dispatch_wall"),
                    _pc_dispatch=t_disp,
                )
                if self.metrics is not None:
                    self.metrics.mm_delivery_lag.observe(collect_lag)
                    if slipped:
                        self.metrics.mm_cohort_slipped.inc()
            if slipped:
                self.logger.warn(
                    "cohort delivered past its interval deadline",
                    ready_lag_s=round(ready_lag, 2),
                    fetch_lag_s=round(fetch_lag, 2),
                    collect_lag_s=round(collect_lag, 2),
                    interval_sec=self.config.interval_sec,
                )
        with span(crumb, "accept_s"):
            total = int(offsets[n_matches])
            flat_t = flat[:total]
            sizes = (
                offsets[1 : n_matches + 1] - offsets[:n_matches]
            ).astype(np.int64)
            mid = np.repeat(np.arange(n_matches), sizes)
            # stale: slot reused between dispatch and collection; dead:
            # removed meanwhile; sel: claimed by an earlier accepted
            # match this call.
            sel_conflict_n = int(sel[flat_t].sum())
            stale = w_gen[flat_t] != self.store.gen[flat_t]
            dead = ~self.store.alive[flat_t]
            bad_e = stale | dead | sel[flat_t]
            bad = ~ok
            if bad_e.any():
                bad |= np.bincount(mid[bad_e], minlength=n_matches) > 0
            if pipelined and bad.any():
                # Only the pipeline lag can strand an inactive ticket;
                # non-pipelined drops keep reference single-shot
                # semantics.
                dropped = flat_t[bad[mid]]
                dropped = dropped[self.store.alive[dropped] & ~sel[dropped]]
                react_parts.append(dropped)
            if bad.any():
                # Why matches dropped at accept: validation, staleness,
                # death, or a same-call sel conflict.
                crumb["dropped_matches"] = crumb.get(
                    "dropped_matches", 0
                ) + int(bad.sum())
                crumb["dropped_invalid"] = crumb.get(
                    "dropped_invalid", 0
                ) + int((~ok).sum())
                crumb["dropped_stale_gen"] = crumb.get(
                    "dropped_stale_gen", 0
                ) + int(stale.sum())
                crumb["dropped_dead"] = crumb.get("dropped_dead", 0) + int(
                    dead.sum()
                )
                crumb["dropped_sel"] = crumb.get("dropped_sel", 0) + int(
                    sel_conflict_n
                )
            good = ~bad
            good_flat = flat_t[good[mid]]
            sel[good_flat] = True
            flat_parts.append(good_flat)
            size_parts.append(sizes[good])
        if ledger is not None:
            ledger["accept_lag_s"] = round(time.perf_counter() - t_disp, 3)
            # Device phases on the same record as the host stage chain:
            # kernel events between the cohort's flush and now.
            t_w0 = holder.get("t_window_wall") or holder.get(
                "t_dispatch_wall"
            )
            if t_w0 is not None:
                ledger["device_timeline"] = DEVOBS.timeline_between(
                    t_w0, time.time()
                )
            tctx = holder.get("trace")
            if tctx is not None:
                ledger["trace_id"] = tctx[0]
            entry = self.tracing.record_delivery(**ledger)
            self._accepted_cohorts.append((entry, good_flat))
        self._close_cohort_trace(holder)

    def _close_cohort_trace(
        self, holder: dict, status: str = "ok", message: str = ""
    ) -> None:
        """Append the cohort's stage spans (ready/fetched/collected,
        from the holder's perf stamps) to its trace and release the
        hold taken at dispatch. Pops the ctx so the reclaim path can
        never double-release."""
        tctx = holder.pop("trace", None)
        if tctx is None:
            return
        trace_id, parent = tctx
        t_disp_pc = holder.get("t_dispatch")
        base = holder.get("t_dispatch_wall") or time.time()
        if t_disp_pc is not None:
            for name, stamp in (
                ("cohort.ready", holder.get("t_ready")),
                ("cohort.fetched", holder.get("t_fetched")),
            ):
                if stamp is not None:
                    trace_api.emit_span(
                        trace_id, parent, name,
                        start_ts=base,
                        end_ts=base + (stamp - t_disp_pc),
                    )
            trace_api.emit_span(
                trace_id, parent, "cohort.collected",
                start_ts=base,
                end_ts=base + (time.perf_counter() - t_disp_pc),
                status=status, message=message,
                breaker=self.breaker.state,
            )
        trace_api.TRACES.release(trace_id)

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
        completed (results stay queued for the next collection): between
        intervals by benchmarks, and at shutdown so no worker thread
        outlives the matchmaker."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for work in list(self._pipeline_queue):
            left = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            work[0][-1].join(left)

    # ----------------------------------------------- snapshot / restore

    def snapshot_state(self) -> dict:
        """Checkpoint view of the backend: the compiled device pool rows
        (one D2H copy per column), exact query/value mirrors, and the
        per-slot classification masks — everything on_add derives, so a
        warm restart is bulk array restores + one H2D copy per column
        instead of ~pool_size per-ticket recompiles. Sliced to the
        high-water mark. Plain numpy arrays and tuples under the JAX
        package's keys, so a snapshot of either package restores into
        the other."""
        self.pool.flush()
        hw = self.pool.high_water
        return {
            "backend": "cuda",
            "schema": (
                self.pool.capacity, self.fn, self.fs, self.s, self.d,
            ),
            "pool": self.pool.snapshot(),
            "exact": {k: v[:hw].copy() for k, v in self.exact.items()},
            "host_only_mask": self.host_only_mask[:hw].copy(),
            "should_mask": self._should_mask[:hw].copy(),
            "emb_mask": self._emb_mask[:hw].copy(),
            "nonpair_mask": self._nonpair_mask[:hw].copy(),
            "created_base": int(self._created_base),
            "grid_lo": self._grid_lo.copy(),
            "grid_hi": self._grid_hi.copy(),
        }

    def restore_state(self, snap: dict) -> None:
        """Warm-restart restore onto a FRESH backend whose SlotStore was
        already restored. Pipeline state starts empty — no cohort
        survives a process."""
        schema = (self.pool.capacity, self.fn, self.fs, self.s, self.d)
        if tuple(snap["schema"]) != schema:
            raise ValueError(
                f"snapshot schema {tuple(snap['schema'])} != backend"
                f" schema {schema} (restore requires the same"
                " matchmaker config)"
            )
        self.pool.load(snap["pool"])
        hw = self.pool.high_water
        for k, v in snap["exact"].items():
            if k in self.exact:
                self.exact[k][:hw] = v
        self.host_only_mask[:hw] = snap["host_only_mask"]
        self._should_mask[:hw] = snap["should_mask"]
        self._should_count = int(self._should_mask.sum())
        self._emb_mask[:hw] = snap["emb_mask"]
        self._emb_count = int(self._emb_mask.sum())
        self._nonpair_mask[:hw] = snap["nonpair_mask"]
        self._nonpair_count = int(self._nonpair_mask.sum())
        self._created_base = int(snap["created_base"])
        self._grid_lo = np.asarray(snap["grid_lo"], dtype=np.float64).copy()
        self._grid_hi = np.asarray(snap["grid_hi"], dtype=np.float64).copy()
        self._rebuild_ring()

    def _rebuild_ring(self) -> None:
        """Reseed the insertion-ordered dispatch ring from the restored
        store: live slots in exact (created_at, created_seq) order."""
        meta = self.meta
        live = self.store.live_slots()
        order = np.lexsort((meta["created_seq"][live], meta["created"][live]))
        live = live[order]
        n = len(live)
        self._ring[:n] = live
        self._ring_valid[:n] = True
        self._ring_valid[n:] = False
        self._ring_pos[:] = -1
        self._ring_pos[live] = np.arange(n, dtype=np.int64)
        self._ring_n = n
        self._ring_last_created = (
            int(meta["created"][live[-1]]) if n else np.iinfo(np.int64).min
        )
        self._ring_unsorted = False

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
        faults.fire("device.dispatch")  # chaos: raise/stall the dispatch
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
            with DEVOBS.device_call("matchmaker.score", device=dev):
                slots_dev = torch.from_numpy(pad_to(slots, a_pad, -1)).to(dev)
                cand_dev = topk_candidates_big(
                    self.pool.tensors,
                    slots_dev,
                    torch.from_numpy(grid_lo).to(dev),
                    torch.from_numpy(grid_inv).to(dev),
                    fn=self.fn,
                    fs=self.fs,
                    n_cols=n_cols,
                    # Pairs keep the full candidate width: coverage is set
                    # by list diversity, not by handshake rounds.
                    k=self.k,
                    rev=rev,
                    with_should=with_should,
                    with_embedding=with_embedding,
                    bn=bn,
                    emb_scale=self.config.emb_score_scale,
                    # The handshake needs eligible candidates, not the
                    # exact (-score, created) order: skip stage 2's
                    # second sort.
                    order_exact=not use_pairs,
                )
            if use_pairs:
                with DEVOBS.device_call("matchmaker.assign", device=dev):
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
        with DEVOBS.device_call("matchmaker.score", device=dev):
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
        step masks by gen/alive. The worker issues no device work of its
        own: it only waits for the copies."""
        t_disp = time.perf_counter()
        self._dispatch_counter += 1
        holder: dict = {
            "dispatch_seq": self._dispatch_counter,
            "t_dispatch": t_disp,
            "t_dispatch_wall": time.time(),
            # Delivery deadline: the cohort must reach players before its
            # OWN interval ends.
            "deadline": t_disp + max(1.0, float(self.config.interval_sec)),
        }
        n_rows = len(slots)
        # HBM ledger: the candidate/partner tensors alive on the device
        # between launch and their fetch.
        dispatch_bytes = sum(t.numel() * t.element_size() for t in dev_arrays)
        DEVOBS.mem_add("matchmaker.dispatch", dispatch_bytes)

        def _fetch(t):
            # The blocking D2H read: the device pass's tail lands on this
            # (host) clock.
            with DEVOBS.device_call("matchmaker.fetch"):
                host = np.ascontiguousarray(t.cpu().numpy())
            DEVOBS.transfer("cohort.fetch", "d2h", int(host.nbytes))
            return host

        def _run(out=holder):
            try:
                # Chaos: stall delays this cohort's readiness; raise
                # surfaces at collect and walks the reclaim + breaker
                # path.
                faults.fire("device.collect")
                if kind == "pairs":
                    partner = _fetch(dev_arrays[0])[:n_rows]
                    proposer = _fetch(dev_arrays[1])[:n_rows]
                    out["t_fetched"] = time.perf_counter()
                    # The fetch waited for this cohort's device work:
                    # its kernel clocks' events have completed.
                    DEVOBS.resolve()
                    out["asm"] = self._assemble_pairs(
                        slots, partner, proposer, rev
                    )
                    return
                if kind == "big":
                    # Already ordered by (-score, created) on the device.
                    cand_np = _fetch(dev_arrays[0])[:n_rows]
                    out["t_fetched"] = time.perf_counter()
                else:
                    scores_np = _fetch(dev_arrays[0])[:n_rows]
                    cand_np = _fetch(dev_arrays[1])[:n_rows]
                    out["t_fetched"] = time.perf_counter()
                    cand_np = self._order_small(scores_np, cand_np)
                DEVOBS.resolve()
                out["asm"] = self._assemble(slots, last, cand_np, rev)
            except Exception as e:  # surfaced at collect
                out["err"] = e
            finally:
                DEVOBS.mem_add("matchmaker.dispatch", -dispatch_bytes)
                out["t_ready"] = time.perf_counter()
                # Completion signal LAST (after the ready stamp, so a
                # woken collector always sees a finished cohort). A
                # failing callback must never kill the worker before its
                # results are parked.
                cb = self._ready_cb
                if cb is not None:
                    try:
                        cb()
                    except Exception:
                        pass

        thread = threading.Thread(target=_run, daemon=True)
        thread.start()
        return (kind, holder, thread)

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
        free when the cohort was ready, a blocking join otherwise
        (synchronous mode, or the backpressure drain)."""
        _, holder, thread = pending
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

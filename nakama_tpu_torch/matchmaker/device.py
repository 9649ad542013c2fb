"""Device-resident ticket pool + the exact blockwise top-K scan.

Port of the JAX package's `matchmaker/device.py`. Instead of one inverted-
index search per active ticket (reference server/matchmaker_process.go:
27-334), all active tickets score all pool tickets in one blockwise pass
over column blocks with a running top-K per row, so the N×N score matrix
never materialises. Mutual match ("reverse precision") is the same
predicate transposed, evaluated in the same block.

Eligibility is evaluated in per-field form (see compile.py): a broadcast
compare-and-reduce over [col_block, row_block, F]. The should-clause
scoring path gathers per slot and runs only when the pool holds should
queries.

`PoolBuffer` keeps the ticket columns resident on the device and applies
queued add/remove updates in place (`index_copy_` / `index_fill_`) once
per flush, so `add` streams rows in instead of re-uploading the pool;
staged rows go up from pinned host memory without waiting for queued
device work.

Everything here is plain PyTorch and runs on whatever device its tensors
live on; the small-pool path has no hand-written kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devobs import DEVOBS
from .compile import SOP_ALL, SOP_NUM_RANGE, SOP_STR_EQ, SOP_UNUSED

NEG_INF = float("-inf")

# Flag bits in the "flags" column.
FLAG_VALID = 1
FLAG_HAS_MUST = 2
FLAG_HAS_SHOULD = 4
FLAG_NEVER = 8

# Tie-break: equal-score candidates prefer longer-waiting tickets. The host
# re-sorts each surviving candidate list exactly by (-score, created) before
# assembly (cuda.py), so this epsilon only biases WHICH candidates survive
# the top-K cutoff. The scan subtracts the pool's minimum live created_seq
# before scaling, keeping the penalty small on long-lived servers.
CREATED_EPS = np.float32(2.0**-24)


def pool_schema(
    capacity: int, fn: int, fs: int, s: int, d: int = 16
) -> dict[str, np.ndarray]:
    """Allocate host templates of the device pool columns."""
    return {
        "emb": np.zeros((capacity, d), dtype=np.float32),
        "num": np.zeros((capacity, fn), dtype=np.float32),
        "str": np.zeros((capacity, fs), dtype=np.int32),
        "n_lo": np.zeros((capacity, fn), dtype=np.float32),
        "n_hi": np.zeros((capacity, fn), dtype=np.float32),
        "n_flo": np.ones((capacity, fn), dtype=np.float32),
        "n_fhi": np.full((capacity, fn), -1.0, dtype=np.float32),
        "s_req": np.zeros((capacity, fs), dtype=np.int32),
        "s_forb": np.zeros((capacity, fs), dtype=np.int32),
        "sh_op": np.zeros((capacity, s), dtype=np.int32),
        "sh_fld": np.zeros((capacity, s), dtype=np.int32),
        "sh_lo": np.zeros((capacity, s), dtype=np.float32),
        "sh_hi": np.zeros((capacity, s), dtype=np.float32),
        "sh_term": np.zeros((capacity, s), dtype=np.int32),
        "sh_boost": np.zeros((capacity, s), dtype=np.float32),
        "min_count": np.zeros(capacity, dtype=np.int32),
        "max_count": np.zeros(capacity, dtype=np.int32),
        "party": np.zeros(capacity, dtype=np.int32),
        "pool_id": np.zeros(capacity, dtype=np.int32),
        "created": np.zeros(capacity, dtype=np.int32),  # monotone seq
        "flags": np.zeros(capacity, dtype=np.int32),
    }


def _to_device(host: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def _staging_spec(host: dict[str, np.ndarray], chunk: int) -> dict:
    """Shape and dtype of each buffer of a staging set: per column a
    [chunk, ...] buffer, plus the slot index."""
    spec = {
        k: ((chunk,) + v.shape[1:], torch.from_numpy(v[:0]).dtype)
        for k, v in host.items()
    }
    spec["_slots"] = ((chunk,), torch.int64)
    return spec


def _staging_set(spec: dict, pin: bool):
    """One host staging set for `PoolBuffer` (`_staging_spec`), as
    tensors and their numpy views. Pinned when the pool lives on a card,
    so a flushed chunk goes up with non-blocking copies (a copy from
    pageable memory waits for all queued device work — with pipelining,
    the in-flight cohort).

    A set serves one flush and is then dropped. PyTorch's pinned-memory
    cache records an event behind every non-blocking copy from a pinned
    block and hands the block out again only once that event has
    completed, so a staging buffer is never rewritten while the card may
    still read it — and neither the cache nor this code ever waits for
    the card to get there."""
    tensors = {
        k: torch.empty(shape, dtype=dt, pin_memory=pin)
        for k, (shape, dt) in spec.items()
    }
    return tensors, {k: v.numpy() for k, v in tensors.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PoolBuffer:
    """Slot-allocated, device-resident ticket pool with queued updates.

    Adds stage columnar into a [flush_chunk, ...] host staging set (pinned
    on a card) and flush eagerly once a chunk fills, so the H2D transfer
    rides the gaps between intervals; `flush()` at interval start pushes
    only the partial tail. Removals queue as slot arrays and clear the
    slots' flags. `on_flush(rows)` lets the backend observe value
    distributions (the stage-1 bucket grid) as rows stream in. The
    device columns' bytes are the HBM ledger's `matchmaker.pool` row."""

    def __init__(
        self,
        capacity: int,
        fn: int,
        fs: int,
        s: int,
        d: int = 16,
        flush_chunk: int = 2048,
        on_flush=None,
        device: torch.device | str = "cuda:0",
    ):
        self.capacity = capacity
        self.fn, self.fs, self.s, self.d = fn, fs, s, d
        self.flush_chunk = flush_chunk
        self.on_flush = on_flush
        self.device = torch.device(device)
        host = pool_schema(capacity, fn, fs, s, d)
        self.tensors = _to_device(host, self.device)
        self._ledger_pool_bytes()
        # Slot allocation lives in the caller's SlotStore (store.py); this
        # buffer only stages device-row updates by slot.
        self.high_water = 0
        # A removal of a just-staged add voids its staging position (slot
        # -1, compressed out at flush); an add after a removal of the same
        # slot is resolved by flush order (removals first, then adds).
        # The staging set is taken by the first add after a flush (on
        # the add path), never by the flush itself.
        self._spec = _staging_spec(host, flush_chunk)
        self._pin = self.device.type == "cuda"
        self._set = None  # (tensors, numpy views) or None
        self._stage_slots = np.full(flush_chunk, -1, dtype=np.int32)
        self._stage_n = 0
        self._stage_pos: dict[int, int] = {}  # slot -> staging row
        self._pending_add_mask = np.zeros(capacity, dtype=bool)
        self._pending_rm: list[np.ndarray] = []

    def _ledger_pool_bytes(self) -> None:
        DEVOBS.mem_set(
            "matchmaker.pool", sum(_nbytes(v) for v in self.tensors.values())
        )

    def add(self, slot: int, row: dict[str, np.ndarray]):
        if self._stage_n >= self.flush_chunk:
            self.flush()
        if self._set is None:
            self._set = _staging_set(self._spec, self._pin)
        self.high_water = max(self.high_water, slot + 1)
        old = self._stage_pos.get(slot)
        if old is not None:  # re-staged before flush: void the old row
            self._stage_slots[old] = -1
        pos = self._stage_n
        views = self._set[1]
        for k, v in row.items():
            views[k][pos] = v
        self._stage_slots[pos] = slot
        self._stage_pos[slot] = pos
        self._stage_n = pos + 1
        self._pending_add_mask[slot] = True

    def remove_slots(self, slots: np.ndarray):
        """Bulk removal by slot array. Applied at the next flush, which
        every dispatch runs first."""
        if len(slots) == 0:
            return
        slots = np.asarray(slots, dtype=np.int32)
        staged = slots[self._pending_add_mask[slots]]
        for s in staged:  # rare: removed before its add ever flushed
            pos = self._stage_pos.pop(int(s), None)
            if pos is not None:
                self._stage_slots[pos] = -1
        if len(staged):
            self._pending_add_mask[staged] = False
        self._pending_rm.append(slots)

    def snapshot(self) -> dict:
        """Host copy of the pool columns up to the high-water mark, in the
        JAX package's `PoolBuffer.snapshot()` layout. Flush first so
        staged adds are included."""
        hw = self.high_water
        # A copy even when the pool lives on the CPU (where `.cpu()` would
        # alias the live columns that later flushes overwrite).
        columns = {
            k: v[:hw].to("cpu", copy=True).numpy()
            for k, v in self.tensors.items()
        }
        DEVOBS.transfer(
            "pool.snapshot", "d2h",
            sum(int(v.nbytes) for v in columns.values()),
        )
        return {"high_water": hw, "columns": columns}

    def load(self, snap: dict) -> None:
        """Rebuild the device pool from a snapshot (this package's or the
        JAX package's — the layout is the same): one host template fill
        and one H2D copy per column. Staging state resets."""
        hw = int(snap["high_water"])
        if hw > self.capacity:
            raise ValueError(
                f"snapshot high_water {hw} > capacity {self.capacity}"
            )
        host = pool_schema(self.capacity, self.fn, self.fs, self.s, self.d)
        for k, v in snap["columns"].items():
            host[k][:hw] = v
        self.tensors = _to_device(host, self.device)
        DEVOBS.transfer(
            "pool.load", "h2d", sum(_nbytes(v) for v in self.tensors.values())
        )
        self._ledger_pool_bytes()
        self.high_water = hw
        self._stage_slots[:] = -1
        self._stage_n = 0
        self._stage_pos.clear()
        self._pending_add_mask[:] = False
        self._pending_rm = []

    def flush(self):
        """Apply queued updates in place: clear the flags of removed slots,
        then write the staged add rows — removals first, so a freed slot
        re-added in the same window ends up live. The rows and indices go
        up from pinned host memory (on a card) with non-blocking copies,
        and the set is dropped: the next add stages into a fresh one, so
        nothing here waits for the card. (The JAX package
        pads update counts to a few sizes to bound XLA compiles; eager
        PyTorch compiles nothing per shape, so the port writes exactly the
        rows it has.)"""
        if self._stage_n == 0 and not self._pending_rm:
            return
        dev = self.device
        rows = None
        sent = 0
        with DEVOBS.device_call("matchmaker.scatter", device=dev):
            rm_parts, self._pending_rm = self._pending_rm, []
            if rm_parts:
                rm = np.concatenate(rm_parts)
                buf = torch.empty(len(rm), dtype=torch.int64, pin_memory=self._pin)
                buf.numpy()[:] = rm
                idx = buf.to(dev, non_blocking=True)
                self.tensors["flags"].index_fill_(0, idx, 0)
                sent += 8 * len(rm)
            n = self._stage_n
            self._stage_n = 0
            self._stage_pos = {}
            valid = self._stage_slots[:n] >= 0
            u = int(valid.sum())
            if u:
                tens, views = self._set
                self._set = None
                idx_v = self._stage_slots[:n][valid]
                self._pending_add_mask[idx_v] = False
                if u < n:
                    # Compact voided rows out, in place (nothing reads the
                    # set before the copies below).
                    for k in self.tensors:
                        views[k][:u] = views[k][:n][valid]
                views["_slots"][:u] = idx_v
                idx = tens["_slots"][:u].to(dev, non_blocking=True)
                for k, col in self.tensors.items():
                    col.index_copy_(0, idx, tens[k][:u].to(dev, non_blocking=True))
                    sent += _nbytes(tens[k][:u])
                sent += 8 * u
                rows = {k: views[k][:u] for k in self.tensors}
        DEVOBS.transfer("pool.flush", "h2d", sent)
        if rows is not None and self.on_flush is not None:
            self.on_flush(rows)


def pool_from_reference(
    snapshot: dict, device, *, capacity: int | None = None
) -> PoolBuffer:
    """Carry a JAX `PoolBuffer.snapshot()` across into this port: a
    `PoolBuffer` on `device` holding the same rows. Widths come from the
    snapshot's columns; `capacity` defaults to its high-water mark."""
    cols = snapshot["columns"]
    hw = int(snapshot["high_water"])
    pool = PoolBuffer(
        hw if capacity is None else capacity,
        fn=cols["num"].shape[1],
        fs=cols["str"].shape[1],
        s=cols["sh_op"].shape[1],
        d=cols["emb"].shape[1],
        device=device,
    )
    pool.load(snapshot)
    return pool


def _accepts(q: dict, f: dict, with_should: bool):
    """Does each q-side ticket's query accept each f-side ticket's
    properties? `q` and `f` hold tensors whose leading (batch) dims
    broadcast against each other; per-field columns carry one trailing
    feature dim. Returns (ok, score or None) over the broadcast batch
    shape."""
    num = f["num"]
    ok_num = (
        (num >= q["n_lo"])
        & (num <= q["n_hi"])
        & ~((num >= q["n_flo"]) & (num <= q["n_fhi"]))
    ).all(dim=-1)
    sv = f["str"]
    req, forb = q["s_req"], q["s_forb"]
    ok_str = (((req == 0) | (sv == req)) & ((forb == 0) | (sv != forb))).all(
        dim=-1
    )
    flags = q["flags"]
    ok = ok_num & ok_str & ((flags & FLAG_NEVER) == 0)
    if not with_should:
        return ok, None

    # Should slots: each slot's candidate value, gathered from the field
    # the slot names (the index is clamped per table; a slot's value is
    # only read under the op that owns that table).
    op = q["sh_op"]
    batch = torch.broadcast_shapes(num.shape[:-1], op.shape[:-1])
    n_s = op.shape[-1]
    fld = q["sh_fld"].long()
    fn, fs = num.shape[-1], sv.shape[-1]
    numvals = torch.gather(
        num.expand(*batch, fn), -1, fld.clamp(max=fn - 1).expand(*batch, n_s)
    )
    strvals = torch.gather(
        sv.expand(*batch, fs), -1, fld.clamp(max=fs - 1).expand(*batch, n_s)
    )
    term = q["sh_term"]
    sat = torch.where(
        op == SOP_NUM_RANGE,
        (numvals >= q["sh_lo"]) & (numvals <= q["sh_hi"]),
        torch.where(
            op == SOP_STR_EQ,
            (strvals == term) & (term != 0),
            op == SOP_ALL,
        ),
    )
    used = op != SOP_UNUSED
    should_any = (used & sat).any(dim=-1)
    score = (q["sh_boost"] * (sat & used).float()).sum(dim=-1)
    has_must = (flags & FLAG_HAS_MUST) != 0
    has_should = (flags & FLAG_HAS_SHOULD) != 0
    ok = ok & (has_must | ~has_should | should_any)
    return ok, score


def _rows(d: dict, dim: int) -> dict:
    """Insert a broadcast axis at `dim` of every column (0: q side of a
    [cols, rows] grid, 1: f side)."""
    return {k: v.unsqueeze(dim) for k, v in d.items()}


def _block_eval(
    row, col, row_slot, col_base: int, rev: bool, with_should: bool,
    with_embedding: bool, created_base: int = 0,
):
    """Score one (row-block, column-block) pair → scores [Br, Bc]
    (−inf = ineligible)."""
    bc = col["num"].shape[0]

    ok, score = _accepts(_rows(row, 0), _rows(col, 1), with_should)  # [Bc, Br]
    if rev:
        rev_ok, _ = _accepts(_rows(col, 0), _rows(row, 1), with_should)
        ok = ok & rev_ok.T
    if score is None:
        score = torch.zeros((), dtype=torch.float32, device=ok.device)
    if with_embedding:
        score = score + col["emb"] @ row["emb"].T

    # Count-range compatibility + party/self/validity (reference
    # matchmaker_process.go:65-85) + shared-batch pool masking.
    col_valid = (col["flags"] & FLAG_VALID) != 0  # [Bc]
    minmax_ok = (col["min_count"][:, None] >= row["min_count"][None]) & (
        col["max_count"][:, None] <= row["max_count"][None]
    )
    party_ok = (row["party"][None] == 0) | (
        col["party"][:, None] != row["party"][None]
    )
    pool_ok = col["pool_id"][:, None] == row["pool_id"][None]
    col_idx = col_base + torch.arange(bc, dtype=torch.int64, device=ok.device)
    not_self = col_idx[:, None] != row_slot[None]

    eligible = (
        ok & col_valid[:, None] & minmax_ok & party_ok & pool_ok & not_self
    )
    age = (col["created"][:, None] - created_base).float()
    score = score - age * float(CREATED_EPS)
    return torch.where(eligible, score, NEG_INF).T  # [Br, Bc]


def scan_columns(
    pool_view: dict,
    row: dict,
    row_slots: torch.Tensor,
    row_valid: torch.Tensor,
    *,
    k: int,
    bc: int,
    n_col_blocks: int,
    rev: bool,
    with_should: bool,
    with_embedding: bool,
    created_base: int = 0,
):
    """Stream column blocks of `pool_view` against one row block, carrying
    a running top-k. Ties keep the lower position (the running best
    before the new block, lower columns first), as `lax.top_k` does: a
    stable descending sort of [best, block]."""
    br = row_valid.shape[0]
    dev = row_valid.device
    best_s = torch.full((br, k), NEG_INF, device=dev)
    best_i = torch.full((br, k), -1, dtype=torch.int32, device=dev)
    for cb in range(n_col_blocks):
        col = {key: v[cb * bc : (cb + 1) * bc] for key, v in pool_view.items()}
        s = _block_eval(
            row, col, row_slots, cb * bc, rev, with_should, with_embedding,
            created_base,
        )
        s = torch.where(row_valid[:, None], s, NEG_INF)
        idx = torch.arange(
            cb * bc, (cb + 1) * bc, dtype=torch.int32, device=dev
        )
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, idx.expand(br, bc)], dim=1)
        new_s, sel = torch.sort(cat_s, dim=1, descending=True, stable=True)
        best_s = new_s[:, :k]
        best_i = torch.gather(cat_i, 1, sel[:, :k])
    return best_s, best_i


def topk_candidates(
    pool: dict,
    active_slots: torch.Tensor,  # i32 [A_pad], padded with -1
    *,
    k: int,
    br: int,
    bc: int,
    rev: bool,
    n_cols: int,
    with_should: bool,
    with_embedding: bool = False,
    created_base: int = 0,
):
    """For each active ticket, the top-k eligible candidates by
    (score desc, created asc): returns (scores [A_pad, k], slots [A_pad, k]
    with -1 for empty). Only the first n_cols pool slots are scanned (the
    bucketed high-water mark)."""
    pool = {key: v[:n_cols] for key, v in pool.items()}
    a_pad = active_slots.shape[0]
    dev = active_slots.device
    scores = torch.full((a_pad, k), NEG_INF, device=dev)
    idxs = torch.full((a_pad, k), -1, dtype=torch.int32, device=dev)
    for rb in range(a_pad // br):
        slots = active_slots[rb * br : (rb + 1) * br]
        valid = slots >= 0
        if not bool(valid.any()):
            continue  # an all-padding block scores nothing
        safe = slots.clamp(min=0).long()
        row = {key: v[safe] for key, v in pool.items()}
        best_s, best_i = scan_columns(
            pool,
            row,
            safe,
            valid,
            k=k,
            bc=bc,
            n_col_blocks=n_cols // bc,
            rev=rev,
            with_should=with_should,
            with_embedding=with_embedding,
            created_base=created_base,
        )
        scores[rb * br : (rb + 1) * br] = best_s
        idxs[rb * br : (rb + 1) * br] = torch.where(
            best_s > NEG_INF, best_i, -1
        )
    return scores, idxs


def pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if x.shape[0] == size:
        return x
    out = np.full((size, *x.shape[1:]), fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out

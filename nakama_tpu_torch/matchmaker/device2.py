"""Two-stage matchmaker scan for large pools.

Port of the JAX package's `matchmaker/device2.py` (reference hot loop
replaced: server/matchmaker_process.go:27-334).

Stage 1 (`stage1`, hand-written CUDA kernels routed by `stage1_route`:
csrc/stage1_wgmma.cu for m <= 8 winners per block at D <= 1024 and
E <= 64, csrc/stage1_select.cu wherever it has a shared-memory plan,
csrc/stage1.cu for the rest): eligibility
as a matrix product. Every ticket's properties are encoded into a bucketed
0/1 vector v (one-hot value buckets per numeric field from a per-field
grid, hashed buckets per string field, a pool-id plane); every query into
an allowed-bucket mask u (conservative: any bucket intersecting the allowed
interval is set). ``dot(u_i, v_j) == F`` (F = number of field planes) is a
*necessary* condition for ticket j passing query i. A fused epilogue packs
(priority << 18 | column) into one int32 and keeps only the top-m words
per row of every 1024-column block, so the N×N score matrix never reaches
device memory and no sort runs. Per-pair jitter decorrelates
equal-priority candidates across rows — without it every row's winners
collapse onto the same oldest tickets and the greedy assembler starves.

Stage 2 (`_stage2`, plain PyTorch): the per-block winners are gathered and
re-checked exactly — full interval/term/forbidden compares, count range,
party/self/pool/validity, mutual (rev) when on, exact should-boost and
embedding scores — then ordered by (-score, created). Stage-1 false
positives die here. Stage 1 is a superset filter, but it keeps only m
winners a block: where a block holds more than m passers (tickets whose
fields collide by bucket included), a true candidate in it can lose its
slot to one that stage 2 then rejects, and a min = max ticket, active
for one interval only, can stay pooled for good with its only partner.

`pair_partners` forms 1v1 pairs on the device with a propose-accept
handshake, so pure-1v1 pools never ship their candidate matrix to the
host.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..devobs import DEVOBS
from .device import FLAG_NEVER, FLAG_VALID, _accepts, _rows

NUM_BUCKETS = 16  # per numeric field
STR_BUCKETS = 8  # per string field
POOL_BUCKETS = 8  # pool-id plane
COL_BITS = 18  # column index bits in the packed winner word
MAX_COLS = 1 << COL_BITS
PRIO_MAX = 8191  # 13-bit priority
JITTER_AMP = 256  # selection-jitter range (stays below 1 emb-score unit)
PACKED_NONE = -(2**31)
INT32_MAX = 2**31 - 1

# Every pool column the row (query) side of the scan reads.
ROWQ_KEYS = (
    "n_lo", "n_hi", "n_flo", "n_fhi", "s_req", "s_forb",
    "min_count", "max_count", "pool_id", "flags", "party",
    "num", "str", "emb", "created",
    "sh_op", "sh_fld", "sh_lo", "sh_hi", "sh_term", "sh_boost",
)


def encoding_dims(fn: int, fs: int) -> int:
    return fn * NUM_BUCKETS + fs * STR_BUCKETS + POOL_BUCKETS


# --------------------------------------------------------------- stage 1


def _bucket_of(x, grid_lo, grid_inv):
    """Bucket index of `x` per numeric field → i32, clipped to [0, NB-1].

    The ONE bucketing expression used for both value encoding and query
    mask bounds: monotone non-decreasing in x, so a query's allowed range
    [bucket_of(lo), bucket_of(hi)] covers the bucket of every value in
    [lo, hi] — the stage-1 superset property holds bit for bit. The clamp
    happens in float BEFORE the int cast: ±FULL bounds and the missing
    sentinel overflow to ±inf after the multiply, and an out-of-range
    float→int cast is undefined."""
    t = (x - grid_lo[None]) * grid_inv[None] * NUM_BUCKETS
    t = t.clamp(-(2.0**30), 2.0**30)
    return t.to(torch.int32).clamp(0, NUM_BUCKETS - 1)


def _one_hot(idx, n: int):
    return idx.unsqueeze(-1) == torch.arange(
        n, dtype=torch.int32, device=idx.device
    )


def _value_vectors(pool, n, fn, fs, grid_lo, grid_inv):
    """Bucket one-hot encodings of candidate values → [n, D] bf16."""
    b = _bucket_of(pool["num"][:n], grid_lo, grid_inv)
    oh_num = _one_hot(b, NUM_BUCKETS)
    oh_str = _one_hot(pool["str"][:n] & (STR_BUCKETS - 1), STR_BUCKETS)
    oh_pool = _one_hot(pool["pool_id"][:n] & (POOL_BUCKETS - 1), POOL_BUCKETS)
    valid = ((pool["flags"][:n] & FLAG_VALID) != 0)[:, None]
    v = torch.cat(
        [
            oh_num.reshape(n, fn * NUM_BUCKETS),
            oh_str.reshape(n, fs * STR_BUCKETS),
            oh_pool,
        ],
        dim=1,
    )
    return (v & valid).to(torch.bfloat16)


def _query_vectors(q, fn, fs, grid_lo, grid_inv, with_counts=True):
    """Allowed-bucket masks of queries → [rows, D] bf16; any bucket that
    *could* contain an accepted value is set (conservative).

    `with_counts=False` for the reverse (mutual) direction: count-range
    compatibility is a forward candidate-search filter only, not part of
    mutual query acceptance."""
    rows = q["n_lo"].shape[0]
    n_lo, n_hi = q["n_lo"], q["n_hi"]
    if with_counts:
        # Count-range compatibility as builtin-column bounds (reference
        # server/matchmaker_process.go:65-85): candidate.min_count >= mine
        # and candidate.max_count <= mine. Builtin columns 0 and 1.
        n_lo, n_hi = n_lo.clone(), n_hi.clone()
        n_lo[:, 0] = torch.maximum(n_lo[:, 0], q["min_count"].float())
        n_hi[:, 1] = torch.minimum(n_hi[:, 1], q["max_count"].float())

    bt = torch.arange(NUM_BUCKETS, dtype=torch.int32, device=n_lo.device)
    b_lo = _bucket_of(n_lo, grid_lo, grid_inv)[:, :, None]
    b_hi = _bucket_of(n_hi, grid_lo, grid_inv)[:, :, None]
    allowed = (bt >= b_lo) & (bt <= b_hi)  # [rows, fn, NB]
    # Buckets strictly between the forbidden bounds' buckets hold only
    # forbidden values; the boundary buckets may straddle and stay allowed.
    # Empty intervals (flo > fhi) cut nothing since b(flo) >= b(fhi).
    bf_lo = _bucket_of(q["n_flo"], grid_lo, grid_inv)[:, :, None]
    bf_hi = _bucket_of(q["n_fhi"], grid_lo, grid_inv)[:, :, None]
    allowed = allowed & ~((bt > bf_lo) & (bt < bf_hi))

    req = q["s_req"]  # [rows, fs]; 0 = unconstrained
    oh_req = _one_hot(req & (STR_BUCKETS - 1), STR_BUCKETS)
    str_allowed = (req[:, :, None] == 0) | oh_req
    pool_allowed = _one_hot(q["pool_id"] & (POOL_BUCKETS - 1), POOL_BUCKETS)
    u = torch.cat(
        [
            allowed.reshape(rows, fn * NUM_BUCKETS),
            str_allowed.reshape(rows, fs * STR_BUCKETS),
            pool_allowed,
        ],
        dim=1,
    )
    live = (q["flags"] & FLAG_NEVER) == 0
    return (u & live[:, None]).to(torch.bfloat16)


def _wrap32(x):
    """Two's-complement wrap of an int64 tensor into int32 range."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _mix(x):
    """The JAX package's int32 Knuth hash (`x * -1640531527`, wrapping,
    then `x ^ (x >> 13)` with an arithmetic shift), computed in int64 so
    the wrap is explicit → int32."""
    x = _wrap32(x.to(torch.int64) * -1640531527)
    return (x ^ (x >> 13)).to(torch.int32)


def stage1_plain(
    uq, vv, col_mix, col_gidx, row_mix, row_slot, *,
    fn: int, fs: int, m: int, bn: int, emb_scale: float,
    ue=None, ve=None, uv=None, vq=None,
):
    """The plain PyTorch version of the stage-1 kernel (any device).

    uq bf16 [A, D], vv bf16 [n, D]; col_mix/col_gidx i32 [n];
    row_mix/row_slot i32 [A]; ue/ve bf16 [·, E] when embeddings score;
    uv/vq bf16 [·, D] under mutual (rev) matching. Returns packed words
    i32 [A, (n // bn) * m]: per bn-column block j, the block's top-m words
    of each row in lanes [j*m, (j+1)*m), descending, INT32_MIN when
    fewer eligible columns exist. Rows are processed in chunks to bound
    the fp32 score matrix."""
    a, n = uq.shape[0], vv.shape[0]
    nb = n // bn
    mm = min(m, bn)
    thr = float(fn + fs + 1) - 0.5
    vv_t = vv.float().T
    vq_t = vq.float().T if uv is not None else None
    ve_t = ve.float().T if ue is not None else None
    out = torch.full((a, nb * m), PACKED_NONE, dtype=torch.int32, device=uq.device)
    chunk = max(1, (1 << 26) // max(n, 1))
    for r0 in range(0, a, chunk):
        r1 = min(a, r0 + chunk)
        elig = (uq[r0:r1].float() @ vv_t) > thr
        if uv is not None:
            elig &= (uv[r0:r1].float() @ vq_t) > thr
        jit = (row_mix[r0:r1, None] ^ col_mix[None]) & (JITTER_AMP - 1)
        prio = 4096 - jit
        if ue is not None:
            score = ue[r0:r1].float() @ ve_t
            # Truncation toward zero of the clipped product (astype int32).
            bump = (score * emb_scale).clamp(-4095.0, 4095.0).to(torch.int32)
            prio = (prio + bump).clamp(0, PRIO_MAX)
        not_self = col_gidx[None] != row_slot[r0:r1, None]
        win = torch.where(
            elig & not_self, (prio << COL_BITS) | col_gidx[None], PACKED_NONE
        )
        top = torch.topk(win.view(r1 - r0, nb, bn), mm, dim=2).values
        out.view(a, nb, m)[r0:r1, :, :mm] = top
    return out


def stage1_route(m: int, d: int, e: int = 0, rev: bool = False) -> kernels.Kernel:
    """The CUDA kernel that takes a stage-1 call with m winners per block,
    operand width d, embedding width e (0 without embeddings) and mutual
    matching `rev`:
    - csrc/stage1_wgmma.cu when m <= 8, d <= 1024 and e <= 64: every call
      of the main path at the default widths (D = 520, E = 16, and >= 32
      selection blocks give m <= 4) and k = 128 at >= 32 blocks;
    - else csrc/stage1_select.cu wherever `kernels.select_plan` finds it a
      shared-memory layout: e <= 128 and m up to 209 (rev with e = 128) to
      369 (neither flag), at any d (the row operand resident up to d = 2944
      without flags, streamed past it) — k = 256 at 32 to 63 blocks, pools
      of few blocks below a lowered big_pool_threshold, the self-check's
      m = 32, 48 numeric and 32 string fields (d = 1032);
    - else csrc/stage1.cu: e > 128, or m above that fit (k = 256 on a
      one-block pool gives m = 512)."""
    if (m <= kernels.WGMMA_MAX_M and d <= kernels.WGMMA_MAX_D
            and e <= kernels.WGMMA_MAX_E):
        return kernels.STAGE1_WGMMA
    if kernels.select_plan(m, d, e, rev) is not None:
        return kernels.STAGE1_SELECT
    return kernels.STAGE1


def stage1(
    uq, vv, col_mix, col_gidx, row_mix, row_slot, *,
    fn: int, fs: int, m: int, bn: int, emb_scale: float,
    ue=None, ve=None, uv=None, vq=None,
):
    """Stage-1 prefilter: runs `stage1_plain` for CPU tensors; for CUDA
    tensors launches the kernel `stage1_route` names (the Hopper wgmma
    kernel at m <= 8, D <= 1024 and E <= 64; its selection variant
    wherever that has a plan; else the first kernel), with no fallback.
    Same contract as `stage1_plain`."""
    if uq.device.type == "cpu":
        return stage1_plain(
            uq, vv, col_mix, col_gidx, row_mix, row_slot, fn=fn, fs=fs,
            m=m, bn=bn, emb_scale=emb_scale, ue=ue, ve=ve, uv=uv, vq=vq,
        )
    route = stage1_route(
        m, uq.shape[1], 0 if ue is None else ue.shape[1], uv is not None
    )
    # Each kernel's wrapper in `kernels` carries the kernel's name.
    return getattr(kernels, route.name)(
        uq, vv, col_mix, col_gidx, row_mix, row_slot,
        f_tot=float(fn + fs + 1), m=m, bn=bn, emb_scale=emb_scale,
        ue=ue, ve=ve, uv=uv, vq=vq,
    )


def stage1_inputs(
    pool_n, rowq, active_slots, grid_lo, grid_inv, *, fn, fs, rev,
    with_embedding,
):
    """Encode the stage-1 operands of one dispatch: query masks of the
    active rows, value vectors of the pool columns, the jitter hashes,
    and — only when their flag is on — the embedding and mutual operands.
    Returns a dict of `stage1` arguments."""
    n = pool_n["num"].shape[0]
    a_pad = active_slots.shape[0]
    dev = active_slots.device
    safe = active_slots.clamp(min=0)
    vv = _value_vectors(pool_n, n, fn, fs, grid_lo, grid_inv)
    uq = _query_vectors(rowq, fn, fs, grid_lo, grid_inv)
    uq = uq * (active_slots >= 0).to(torch.bfloat16)[:, None]
    col_idx = torch.arange(n, dtype=torch.int32, device=dev)
    args = dict(
        uq=uq,
        vv=vv,
        col_mix=_mix(col_idx + 1),
        col_gidx=col_idx,
        row_mix=_mix(torch.arange(a_pad, dtype=torch.int64, device=dev) * 7919 + 13),
        row_slot=safe.to(torch.int32),
    )
    if with_embedding:
        args["ue"] = rowq["emb"].to(torch.bfloat16)
        args["ve"] = pool_n["emb"].to(torch.bfloat16)
    if rev:
        args["uv"] = vv[safe.long()]
        args["vq"] = _query_vectors(
            pool_n, fn, fs, grid_lo, grid_inv, with_counts=False
        )
    return args


def winners_per_block(k: int, n_blocks: int) -> int:
    """Winners kept per column block: enough total candidate width even
    when the pool spans few blocks."""
    return max(1, -(-2 * k // n_blocks))


def topk_candidates_big(
    pool: dict,
    active_slots: torch.Tensor,  # i32 [A_pad] padded with -1
    grid_lo: torch.Tensor,  # f32 [fn]
    grid_inv: torch.Tensor,  # f32 [fn]
    *,
    fn: int,
    fs: int,
    n_cols: int,
    k: int,
    rev: bool,
    with_should: bool,
    with_embedding: bool,
    bn: int = 1024,
    emb_scale: float = 256.0,
    order_exact: bool = True,
):
    """Two-stage top-k: returns slots i32 [A_pad, <=k] ordered by exact
    (-score, created), -1 padded (or, with order_exact=False, the
    eligible candidates in stage-1 priority order — the pairing
    handshake's input)."""
    if n_cols > MAX_COLS:
        raise ValueError(f"n_cols {n_cols} > {MAX_COLS}")
    m = winners_per_block(k, n_cols // bn)
    dev = active_slots.device
    pool_n = {key: v[:n_cols] for key, v in pool.items()}
    # Each layer on its own kernel clock (host and CUDA-event time).
    with DEVOBS.device_call("matchmaker.encode", device=dev):
        safe = active_slots.clamp(min=0).long()
        rowq = {key: pool_n[key][safe] for key in ROWQ_KEYS}
        args = stage1_inputs(
            pool_n, rowq, active_slots, grid_lo, grid_inv, fn=fn, fs=fs,
            rev=rev, with_embedding=with_embedding,
        )
    with DEVOBS.device_call("matchmaker.stage1", device=dev):
        winners = stage1(fn=fn, fs=fs, m=m, bn=bn, emb_scale=emb_scale, **args)
    with DEVOBS.device_call("matchmaker.stage2", device=dev):
        return _stage2(
            pool_n,
            rowq,
            active_slots,
            winners,
            k=k,
            rev=rev,
            with_should=with_should,
            with_embedding=with_embedding,
            order_exact=order_exact,
        )


# --------------------------------------------------------------- stage 2


def _sort_by(keys, *vals):
    """Stable lexicographic sort along dim 1 by `keys` (most significant
    first); returns `vals` permuted."""
    order = None
    for key in reversed(keys):
        cur = key if order is None else torch.gather(key, 1, order)
        perm = torch.sort(cur, dim=1, stable=True).indices
        order = perm if order is None else torch.gather(order, 1, perm)
    return [torch.gather(v, 1, order) for v in vals]


def _stage2(
    pool_n, rowq, active_slots, winners, *, k, rev, with_should,
    with_embedding, order_exact=True,
):
    """Exact re-rank of the per-block winners: [A_pad, B] packed → slots
    [A_pad, min(k, B')] ordered by (-score, created)."""
    # Pre-trim the block winners to ~k by packed stage-1 priority before
    # any gather; 2x headroom over k so bucket-granular false positives
    # rarely crowd out true candidates.
    keep = min(winners.shape[1], max(2 * k, 8))
    if winners.shape[1] > keep:
        winners = torch.topk(winners, keep, dim=1).values
    cand = winners & (MAX_COLS - 1)  # [A, B]
    alive = winners != PACKED_NONE
    cand_l = cand.long()

    # Gather only what the exact checks read — the candidate's VALUES and
    # slot metadata always; its QUERY mirrors only under rev (mutual).
    needed = [
        "num", "str", "emb", "min_count", "max_count", "party", "pool_id",
        "flags", "created",
    ]
    if rev:
        needed += [
            "n_lo", "n_hi", "n_flo", "n_fhi", "s_req", "s_forb",
            "sh_op", "sh_fld", "sh_lo", "sh_hi", "sh_term", "sh_boost",
        ]
    col = {key: pool_n[key][cand_l] for key in needed}  # [A, B, ...]
    q_rows = _rows(rowq, 1)  # row-side columns against [A, B] candidates
    ok, score = _accepts(q_rows, col, with_should)
    if score is None:
        score = torch.zeros(ok.shape, dtype=torch.float32, device=ok.device)
    if rev:
        ok_r, _ = _accepts(col, q_rows, with_should)
        ok = ok & ok_r

    minmax_ok = (col["min_count"] >= rowq["min_count"][:, None]) & (
        col["max_count"] <= rowq["max_count"][:, None]
    )
    party_ok = (rowq["party"][:, None] == 0) | (
        col["party"] != rowq["party"][:, None]
    )
    pool_ok = col["pool_id"] == rowq["pool_id"][:, None]
    col_valid = (col["flags"] & FLAG_VALID) != 0
    not_self = cand != active_slots.clamp(min=0)[:, None]
    row_live = (active_slots >= 0)[:, None]
    eligible = (
        ok & alive & minmax_ok & party_ok & pool_ok & col_valid & not_self
        & row_live
    )
    if with_embedding:
        # bf16 operands summed in fp32: the reference's jitted bf16 einsum
        # followed by an fp32 cast compiles to an fp32-result product (the
        # bf16 round trip folds away), so the sum is not rounded to bf16.
        sim = (
            col["emb"].to(torch.bfloat16).float()
            * rowq["emb"].to(torch.bfloat16).float()[:, None]
        ).sum(dim=-1)
        score = score + sim

    # Truncate K' -> k by the stage-1 selection priority (jitter/score),
    # NOT by age: truncating oldest-first would re-concentrate every row's
    # list onto the same old tickets and resurrect assembler starvation.
    # Ineligible entries carry identical sentinel keys, so the order of
    # the survivors is fully determined by the eligible entries' unique
    # keys.
    neg_prio = torch.where(eligible, -winners.long(), INT32_MAX)
    neg_score = torch.where(eligible, -score, float("inf"))
    created = torch.where(eligible, col["created"], INT32_MAX)
    slot = torch.where(eligible, cand, INT32_MAX)
    s_k, c_k, slot_k = _sort_by([neg_prio], neg_score, created, slot)
    s_k, c_k, slot_k = s_k[:, :k], c_k[:, :k], slot_k[:, :k]
    if not order_exact:
        # Pairs path: the handshake needs eligible, compacted candidate
        # lists, not the exact (-score, created) order.
        return torch.where(slot_k == INT32_MAX, -1, slot_k)
    (ordered,) = _sort_by([s_k, c_k, slot_k], slot_k)
    return torch.where(ordered == INT32_MAX, -1, ordered)


# -------------------------------------------------------- device pairing


def pair_partners(
    cand: torch.Tensor,  # i32 [A, k] candidate slots, best-first, -1 pad
    active_slots: torch.Tensor,  # i32 [A] row slots, oldest-first, -1 pad
    *,
    cap: int,
    rounds: int = 8,
):
    """Greedy 1v1 assignment on the device: parallel propose-accept rounds
    over the ranked candidate lists, oldest-first priority.

    - every open row proposes to a still-available candidate — its
      top-ranked one in round 0, pseudo-randomly diffused afterwards
      (equal-score pools give every row the same candidate order, and
      un-diffused proposals serialise to one pair per round);
    - every proposed-to slot accepts its oldest proposer (min row index —
      rows arrive sorted by (created_at, created_seq));
    - a won proposal forms a pair unless its target is a row whose own
      proposal also won elsewhere; mutual top choices tie-break to the
      older row. Passive pool slots accept but never propose.

    Scatters that JAX writes with mode="drop" target a buffer padded with
    sink slots past `cap`. Returns (partner i32 [A] — the formed pair's
    target slot on the PROPOSER row, -1 elsewhere — and proposer bool
    [A] == partner >= 0)."""
    a = cand.shape[0]
    dev = cand.device
    i32 = torch.int32
    rows = torch.arange(a, dtype=i32, device=dev)
    big = INT32_MAX
    sink = cap + 1
    valid_row = active_slots >= 0
    slot_of_row = active_slots.clamp(min=0).long()
    # Pad rows (active_slots == -1) must not scatter into a real slot:
    # they write the sink.
    row_of_slot = torch.full((cap + 2,), -1, dtype=i32, device=dev)
    row_of_slot[torch.where(valid_row, slot_of_row, sink)] = rows
    cand_safe = cand.clamp(min=0).long()
    row_mix = (
        _mix(_wrap32(rows.to(torch.int64) * -1640531527) + 97).to(torch.int64)
        & 0x7FFFFFFF
    )

    avail_slot = torch.ones(cap + 2, dtype=torch.bool, device=dev)
    partner = torch.full((a,), -1, dtype=i32, device=dev)
    for r in range(rounds):
        row_open = valid_row & (partner < 0) & avail_slot[slot_of_row]
        cand_ok = (cand >= 0) & avail_slot[cand_safe] & row_open[:, None]
        navail = cand_ok.sum(dim=1)
        has = navail > 0
        if r > 0:
            # (row_mix * r) wraps in int32, then a floor-mod.
            j = torch.where(
                has, torch.remainder(_wrap32(row_mix * r), navail.clamp(min=1)), 0
            )
        else:
            j = torch.zeros_like(navail)
        csum = torch.cumsum(cand_ok.to(i32), dim=1)
        first = torch.argmax((csum == (j + 1)[:, None]).to(i32), dim=1)
        prop = torch.where(
            has, torch.gather(cand, 1, first[:, None])[:, 0], -1
        )
        prop_safe = prop.clamp(min=0).long()

        # Acceptance: the oldest proposer (min row index) per slot.
        win = torch.full((cap + 2,), big, dtype=i32, device=dev)
        win.scatter_reduce_(
            0, torch.where(prop >= 0, prop.long(), sink), rows, "amin",
            include_self=True,
        )
        pwin = (prop >= 0) & (win[prop_safe] == rows)

        trow = torch.where(prop >= 0, row_of_slot[prop_safe], -1)
        t_is_row = trow >= 0
        t_safe = trow.clamp(min=0).long()
        t_pwin = pwin[t_safe] & t_is_row
        t_prop = torch.where(t_is_row, prop[t_safe], -1)
        mutual = t_is_row & (t_prop == slot_of_row)
        ok_t = (~t_is_row) | (~t_pwin) | (mutual & (rows < trow))
        form = pwin & ok_t

        partner = torch.where(form, prop, partner)
        # One availability write: both sides of every formed pair. (A
        # fill, not `avail_slot[taken] = False`: assigning a Python scalar
        # through an index copies it to the device and synchronises,
        # which would make every dispatch wait for stage 1.)
        taken = torch.cat(
            [
                torch.where(form, slot_of_row, sink),
                torch.where(form, prop_safe, sink),
            ]
        )
        avail_slot.index_fill_(0, taken, False)
    return partner, partner >= 0

"""Device layer of the PyTorch/CUDA port held against the JAX package.

Pools are built by the JAX package's own backend from numpy-seeded
tickets, carried across with `pool_from_reference`, and both packages'
scans then run on them: the exact small-pool top-K (with engineered score
ties), the two-stage top-K in both output orders, and the 1v1 pairing
handshake. The pool buffer's add / remove / re-add staging is compared
snapshot for snapshot.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nakama_tpu.config import MatchmakerConfig as JaxConfig
from nakama_tpu.logger import test_logger as jax_quiet_logger
from nakama_tpu.matchmaker import LocalMatchmaker as JaxLocal
from nakama_tpu.matchmaker import MatchmakerPresence as JaxPresence
from nakama_tpu.matchmaker import device as jd
from nakama_tpu.matchmaker import device2 as jd2
from nakama_tpu.matchmaker.tpu import TpuBackend
from nakama_tpu_torch.matchmaker import device as td
from nakama_tpu_torch.matchmaker import device2 as td2
from nakama_tpu_torch.matchmaker.cuda import big_cols

FN = FS = 8
S = 8
BM = BN = 64


def ticket_specs(rng, n, *, emb=False, ties=False):
    specs = []
    for i in range(n):
        mode = int(rng.integers(0, 3))
        rank = int(rng.integers(0, 100))
        tier = ("gold", "silver", "none")[int(rng.integers(0, 3))]
        if ties:
            # Pure-should queries with a boost far above the wait-time
            # epsilon: every gold candidate scores exactly the same.
            query = "properties.tier:gold^1000 properties.tier:silver"
        else:
            query = (
                f"+properties.mode:m{mode} +properties.rank:>={rank - 30}"
                f" +properties.rank:<={rank + 30}"
            )
            if i % 3 == 0:
                query += " properties.tier:gold^3 properties.tier:silver"
            if i % 5 == 0:
                query += " -properties.region:eu"
        specs.append(
            dict(
                query=query,
                strs={
                    "mode": f"m{mode}",
                    "tier": tier,
                    "region": ("eu", "us")[i % 2],
                },
                nums={"rank": float(rank)},
                party=f"p{i // 2}" if i % 7 == 0 else "",
                # Multiples of 1/64 below 1/2: exact in bf16, and every
                # 16-term similarity is exact in fp32 whatever the order
                # of summation, so both frameworks score identically.
                emb=(
                    (rng.integers(-32, 33, 16) / 64).astype(np.float32)
                    if emb
                    else None
                ),
            )
        )
    return specs


def jax_pool(specs, cap=2048, k=16):
    """Tickets through the JAX package's own add path; returns its
    backend with the pool flushed."""
    cfg = JaxConfig(
        pool_capacity=cap, candidates_per_ticket=k, numeric_fields=FN,
        string_fields=FS, max_constraints=S, big_pool_threshold=64,
        interval_pipelining=False,
    )
    backend = TpuBackend(
        cfg, jax_quiet_logger(), row_block=8, col_block=64,
        big_row_block=BM, big_col_block=BN,
    )
    mm = JaxLocal(jax_quiet_logger(), cfg, backend=backend)
    for i, s in enumerate(specs):
        p = JaxPresence(user_id=f"u{i}", session_id=f"s{i}")
        mm.add(
            [p], p.session_id, s["party"], s["query"], 2, 2, 1, s["strs"],
            s["nums"], embedding=s["emb"], ticket_id=f"t{i}",
            created_at=1000.0 + i,
        )
    backend.pool.flush()
    return backend


def padded_slots(n_live, a_pad):
    slots = np.full(a_pad, -1, np.int32)
    slots[:n_live] = np.arange(n_live, dtype=np.int32)
    return slots


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("emb", [False, True])
def test_topk_candidates_big_matches_jax(rev, emb):
    rng = np.random.default_rng(11 + 2 * rev + emb)
    n_live, k = 150, 16
    jb = jax_pool(ticket_specs(rng, n_live, emb=emb), k=k)
    tpool = td.pool_from_reference(jb.pool.snapshot(), "cpu", capacity=2048)
    n_cols = big_cols(jb.pool.high_water, BN, 2048)
    slots = padded_slots(n_live, 256)
    grid_lo, grid_inv = jb._grid_params()
    kw = dict(
        fn=FN, fs=FS, n_cols=n_cols, k=k, rev=rev, with_should=True,
        with_embedding=emb, bn=BN, emb_scale=256.0,
    )
    for order_exact in (True, False):
        want = np.asarray(
            jd2.topk_candidates_big(
                jb.pool.device, jnp.asarray(slots), grid_lo, grid_inv,
                bm=BM, interpret=True, order_exact=order_exact, **kw,
            )
        )
        got = td2.topk_candidates_big(
            tpool.tensors, torch.from_numpy(slots),
            torch.from_numpy(grid_lo), torch.from_numpy(grid_inv),
            order_exact=order_exact, **kw,
        ).numpy()
        assert (want[:n_live] >= 0).sum() > n_live  # real candidate lists
        np.testing.assert_array_equal(got, want)


def test_topk_candidates_big_matches_jax_at_16_winners_a_block():
    """k = 32 on the four 64-column blocks of 150 tickets: stage 1 keeps
    m = 16 winners a block, the selection kernel's route on the card."""
    rng = np.random.default_rng(17)
    n_live, k = 150, 32
    jb = jax_pool(ticket_specs(rng, n_live, emb=True), k=k)
    tpool = td.pool_from_reference(jb.pool.snapshot(), "cpu", capacity=2048)
    n_cols = big_cols(jb.pool.high_water, BN, 2048)
    assert td2.winners_per_block(k, n_cols // BN) == 16
    slots = padded_slots(n_live, 256)
    grid_lo, grid_inv = jb._grid_params()
    kw = dict(
        fn=FN, fs=FS, n_cols=n_cols, k=k, rev=False, with_should=True,
        with_embedding=True, bn=BN, emb_scale=256.0,
    )
    want = np.asarray(
        jd2.topk_candidates_big(
            jb.pool.device, jnp.asarray(slots), grid_lo, grid_inv,
            bm=BM, interpret=True, **kw,
        )
    )
    got = td2.topk_candidates_big(
        tpool.tensors, torch.from_numpy(slots),
        torch.from_numpy(grid_lo), torch.from_numpy(grid_inv), **kw,
    ).numpy()
    assert (want[:n_live] >= 0).sum(axis=1).max() > 16  # beyond one block's m
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ties", [False, True])
def test_topk_candidates_small_matches_jax(ties):
    rng = np.random.default_rng(21)
    n_live = 120
    jb = jax_pool(ticket_specs(rng, n_live, ties=ties), cap=256)
    tpool = td.pool_from_reference(jb.pool.snapshot(), "cpu", capacity=256)
    slots = padded_slots(n_live, 128)
    kw = dict(
        k=32, br=8, bc=64, rev=False, n_cols=128, with_should=True,
        with_embedding=False, created_base=int(jb._created_base),
    )
    ws, wi = jd.topk_candidates(jb.pool.device, jnp.asarray(slots), **kw)
    gs, gi = td.topk_candidates(tpool.tensors, torch.from_numpy(slots), **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    if ties:
        # Engineered ties really occurred and were broken by position.
        s = np.asarray(ws)[:n_live]
        assert (s[:, 1:] == s[:, :-1])[s[:, 1:] > -np.inf].any()


def jax_pairs(cand, active, cap, rounds=8):
    partner, proposer = jd2.pair_partners(
        jnp.asarray(cand), jnp.asarray(active), cap=cap, rounds=rounds
    )
    return np.asarray(partner), np.asarray(proposer)


def torch_pairs(cand, active, cap, rounds=8):
    partner, proposer = td2.pair_partners(
        torch.from_numpy(cand), torch.from_numpy(active), cap=cap,
        rounds=rounds,
    )
    return partner.numpy(), proposer.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_partners_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, k, cap = 96, 12, 160
    active = np.full(a, -1, np.int32)
    active[:80] = rng.permutation(cap)[:80]  # 16 pad rows
    cand = rng.integers(0, cap, (a, k)).astype(np.int32)
    cand[rng.random((a, k)) < 0.3] = -1
    cand[active < 0] = -1
    want = jax_pairs(cand, active, cap)
    got = torch_pairs(cand, active, cap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1].sum() > 10  # pairs formed, diffused rounds included


def test_pair_partners_pad_rows_do_not_clobber_slot0():
    # Pad rows (active_slots == -1) must not scatter into slot 0's row
    # mapping, or the same pair reports from both sides.
    cand = np.asarray([[1, -1], [0, -1], [0, -1], [-1, -1]], np.int32)
    active = np.asarray([0, 1, 2, -1], np.int32)
    partner, proposer = torch_pairs(cand, active, cap=8, rounds=4)
    want = jax_pairs(cand, active, cap=8, rounds=4)
    np.testing.assert_array_equal(partner, want[0])
    pairs = {
        tuple(sorted((int(active[i]), int(partner[i]))))
        for i in np.nonzero(proposer)[0]
    }
    assert len(pairs) == int(proposer.sum())
    flat = [s for p in pairs for s in p]
    assert len(flat) == len(set(flat))


def test_pool_buffer_add_remove_readd_matches_jax():
    rng = np.random.default_rng(4)
    cap, chunk = 64, 16
    jpool = jd.PoolBuffer(cap, FN, FS, S, flush_chunk=chunk)
    tpool = td.PoolBuffer(cap, FN, FS, S, flush_chunk=chunk, device="cpu")
    template = td.pool_schema(1, FN, FS, S)

    def row():
        out = {}
        for key, v in template.items():
            shape = v.shape[1:]
            if v.dtype == np.float32:
                out[key] = rng.standard_normal(shape).astype(np.float32)
            else:
                out[key] = rng.integers(1, 1000, shape).astype(np.int32)
        return out

    ops = []
    for slot in range(40):  # crosses a chunk boundary: eager flushes
        ops.append(("add", slot, row()))
    ops.append(("rm", np.asarray([3, 5, 39], np.int32)))  # 39 still staged
    ops.append(("add", 5, row()))  # re-add of a removed slot
    ops.append(("add", 7, row()))  # re-stage of a flushed slot
    ops.append(("flush",))
    ops.append(("rm", np.asarray([7, 8], np.int32)))
    ops.append(("add", 8, row()))
    ops.append(("add", 50, row()))
    ops.append(("add", 50, row()))  # re-stage before flush: last wins
    for op in ops:
        for pool in (jpool, tpool):
            if op[0] == "add":
                pool.add(op[1], op[2])
            elif op[0] == "rm":
                pool.remove_slots(op[1])
            else:
                pool.flush()
    jpool.flush()
    tpool.flush()
    want, got = jpool.snapshot(), tpool.snapshot()
    assert got["high_water"] == want["high_water"] == 51
    for key in want["columns"]:
        np.testing.assert_array_equal(
            got["columns"][key], want["columns"][key], err_msg=key
        )
    # And back: a port snapshot loads into a fresh port buffer unchanged.
    again = td.pool_from_reference(got, "cpu", capacity=cap)
    for key, v in again.tensors.items():
        np.testing.assert_array_equal(
            v[:51].numpy(), got["columns"][key], err_msg=key
        )


def test_pool_buffer_staging_ring_keeps_in_flight_sets_and_pool_unchanged():
    """Each flush hands its staging set to the copies and drops it; the
    next add stages into a fresh set, so a set whose copy may still be in
    flight is never written again, and a flush never takes (or waits
    for) a set. Every flushed set still holds what it sent after all the
    later adds, and the flushed pool equals the JAX package's after the
    same operations, voided and re-staged rows included."""
    rng = np.random.default_rng(9)
    cap, chunk = 256, 8
    jpool = jd.PoolBuffer(cap, FN, FS, S, flush_chunk=chunk)
    tpool = td.PoolBuffer(cap, FN, FS, S, flush_chunk=chunk, device="cpu")
    sent = []  # (set's tensors, a copy of their contents at flush)
    real_flush = tpool.flush

    def flush_keeping_the_set():
        if tpool._stage_n:
            tens = tpool._set[0]
            sent.append((tens, None))
        real_flush()
        if sent and sent[-1][1] is None:
            tens = sent[-1][0]
            sent[-1] = (tens, {k: v.clone() for k, v in tens.items()})
            assert tpool._set is None  # the flush took no new set

    tpool.flush = flush_keeping_the_set
    template = td.pool_schema(1, FN, FS, S)

    def row():
        return {
            key: (
                rng.standard_normal(v.shape[1:]).astype(np.float32)
                if v.dtype == np.float32
                else rng.integers(1, 1000, v.shape[1:]).astype(np.int32)
            )
            for key, v in template.items()
        }

    for slot in range(200):  # 25 eager flushes
        r = row()
        for pool in (jpool, tpool):
            pool.add(slot, r)
        if slot % 13 == 5:  # void a staged row, then re-stage another
            for pool in (jpool, tpool):
                pool.remove_slots(np.asarray([slot, slot - 20], np.int32))
            r = row()
            for pool in (jpool, tpool):
                pool.add(slot - 20, r)
    jpool.flush()
    tpool.flush()
    assert len(sent) >= 25
    ids = {id(tens["_slots"]) for tens, _ in sent}
    assert len(ids) == len(sent)  # one set per flush, none handed out twice
    for tens, at_flush in sent:
        for k, v in tens.items():  # bit for bit: unused rows are raw memory
            assert v.numpy().tobytes() == at_flush[k].numpy().tobytes(), k
    want, got = jpool.snapshot(), tpool.snapshot()
    assert got["high_water"] == want["high_water"] == 200
    for key in want["columns"]:
        np.testing.assert_array_equal(
            got["columns"][key], want["columns"][key], err_msg=key
        )

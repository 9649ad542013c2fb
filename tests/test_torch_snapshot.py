"""Snapshot/restore, extract/insert and the runtime override of the port
held against the JAX package, across the two packages.

A snapshot is plain numpy arrays and tuples under the JAX package's
keys, so a snapshot of either package restores into the other. Each
round trip is followed by one interval on the original and on the
restored matchmaker: the match groups must be identical. The pools are
the mixed shape of `test_torch_slice.py` (squads, parties, host-only
regex queries, embeddings) on the two-stage path with the native
assembler, at capacity 2048 with 64-wide blocks and fn = fs = 8.
"""

import numpy as np
import pytest

from nakama_tpu.config import MatchmakerConfig as JaxConfig
from nakama_tpu.logger import test_logger as jax_quiet_logger
from nakama_tpu.matchmaker import LocalMatchmaker as JaxLocal
from nakama_tpu.matchmaker import MatchmakerPresence as JaxPresence
from nakama_tpu.matchmaker.tpu import TpuBackend
from nakama_tpu.matchmaker.types import MatchmakerExtract as JaxExtract
from nakama_tpu_torch.config import MatchmakerConfig
from nakama_tpu_torch.logger import test_logger as quiet_logger
from nakama_tpu_torch.matchmaker import LocalMatchmaker, MatchmakerPresence
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from nakama_tpu_torch.matchmaker.types import MatchmakerExtract
from test_torch_slice import add_ticket, groups, ticket_stream

BLOCKS = dict(row_block=8, col_block=64, big_row_block=64, big_col_block=64)
COMMON = dict(
    pool_capacity=2048, candidates_per_ticket=32, big_pool_threshold=64,
    numeric_fields=8, string_fields=8, max_constraints=8, max_intervals=3,
    interval_pipelining=False,
)


def make(jax: bool):
    if jax:
        cfg = JaxConfig(**COMMON)
        return JaxLocal(
            jax_quiet_logger(), cfg,
            backend=TpuBackend(cfg, jax_quiet_logger(), **BLOCKS),
        )
    cfg = MatchmakerConfig(**COMMON)
    return LocalMatchmaker(
        quiet_logger(), cfg,
        backend=CudaBackend(cfg, quiet_logger(), device="cpu", **BLOCKS),
    )


def filled(jax: bool, seed: int, n: int = 160):
    """A matchmaker holding `n` mixed tickets after one interval (so the
    pool carries intervals, inactive tickets and freed slots)."""
    mm = make(jax)
    rng = np.random.default_rng(seed)
    presence = JaxPresence if jax else MatchmakerPresence
    for spec in ticket_stream(rng, n, "mixed", 0):
        add_ticket(mm, spec, presence)
    mm.process()
    for spec in ticket_stream(rng, n // 2, "mixed", n):
        add_ticket(mm, spec, presence)
    mm.remove([f"t{i}" for i in range(3, n, 11)])
    return mm


@pytest.mark.parametrize(
    "src_jax,dst_jax", [(False, False), (True, False), (False, True)],
    ids=["port-to-port", "jax-to-port", "port-to-jax"],
)
def test_snapshot_restores_across_packages(src_jax, dst_jax):
    src = filled(src_jax, seed=11)
    snap = src.snapshot_state()
    live = src.store.live_slots()
    state = {
        "alive": src.store.alive.copy(), "active": src.store.active.copy(),
        "gen": src.store.gen.copy(),
        **{k: src.store.meta[k][live].copy()
           for k in ("intervals", "created", "created_seq", "count")},
    }
    # The source's interval runs BEFORE the restore: the snapshot must
    # not alias state the source goes on mutating.
    want = groups([src.process()])
    dst = make(dst_jax)
    dst.restore_state(snap)
    assert len(dst) == len(live)
    for key in ("alive", "active", "gen"):
        assert np.array_equal(getattr(dst.store, key), state[key]), key
    for key in ("intervals", "created", "created_seq", "count"):
        assert np.array_equal(dst.store.meta[key][live], state[key]), key
    got = groups([dst.process()])
    assert want and got == want
    # The created-sequence tie-break survives: a new add sorts after
    # every restored ticket.
    p = (JaxPresence if dst_jax else MatchmakerPresence)(
        user_id="new", session_id="new"
    )
    dst.add([p], "new", "", "*", 2, 2, ticket_id="t-new")
    assert dst.store.get("t-new").created_seq > snap["max_created_seq"]


def test_snapshot_holds_only_plain_data():
    """No class of either package inside a snapshot: numpy arrays,
    tuples, lists, dicts and scalars only."""
    snap = filled(False, seed=12).snapshot_state()

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            assert x is None or isinstance(
                x, (np.ndarray, np.generic, int, float, str, bool)
            ), type(x)

    walk(snap)


def _convert(ex, extract_cls, presence_cls):
    fields = dict(vars(ex))
    fields["presences"] = [presence_cls(**vars(p)) for p in ex.presences]
    return extract_cls(**fields)


@pytest.mark.parametrize("src_jax", [True, False], ids=["jax-to-port", "port-to-jax"])
def test_extract_insert_across_packages(src_jax):
    """A node-drain handover: one package's extract, carried field by
    field, inserted into the other; one interval on each side forms the
    same groups."""
    src = filled(src_jax, seed=13)
    extracts = src.extract()
    assert len(extracts) == len(src)
    dst = make(not src_jax)
    if src_jax:
        dst.insert([_convert(e, MatchmakerExtract, MatchmakerPresence) for e in extracts])
    else:
        dst.insert([_convert(e, JaxExtract, JaxPresence) for e in extracts])
    assert len(dst) == len(src)
    assert sorted(t.ticket for t in dst.store.live_tickets()) == sorted(
        t.ticket for t in src.store.live_tickets()
    )
    # insert() of a re-delivered batch is idempotent.
    dst.insert(dst.extract())
    assert len(dst) == len(src)
    # Inserted tickets carry their interval counts; the reference insert
    # re-sequences them, so hold a fresh pair with the same order.
    ref = make(src_jax)
    ref.insert(src.extract())
    want = groups([ref.process()])
    got = groups([dst.process()])
    assert want and got == want


def test_process_custom_override_matches_jax():
    """The runtime override (`override_fn`) gets the same candidate
    combinations in both packages and its choice is confirmed the same
    way: first set wins, overlapping sets drop."""
    seen = {}
    out = {}
    for jax in (True, False):
        mm = make(jax)
        rng = np.random.default_rng(14)
        presence = JaxPresence if jax else MatchmakerPresence
        # Few tickets: the override enumerates every combination.
        for spec in ticket_stream(rng, 14, "mixed", 0):
            add_ticket(mm, spec, presence)
        calls = []

        def override(candidates, calls=calls):
            calls.append(
                [tuple(e.presence.session_id for e in c) for c in candidates]
            )
            # Keep every other candidate: overlaps exercise the
            # first-set-wins confirmation.
            return candidates[::2]

        mm.override_fn = override
        out[jax] = [groups([mm.process()]) for _ in range(2)]
        seen[jax] = calls
    assert seen[False] == seen[True]
    assert out[False] == out[True]
    assert out[False][0]

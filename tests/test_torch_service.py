"""The port's matchmaker as a service — `start()`'s interval loop and
event-driven delivery stage — held against the JAX package's.

Both packages run their own loop on asyncio at `interval_sec` = 0.3 s
with the same numpy-seeded 1v1 tickets, added in waves: each wave goes
in once the previous wave's cohort was dispatched and delivered, in one
loop step, so the next interval dispatches exactly that wave. 1v1
tickets get one attempt each, so intervals without a new wave dispatch
nothing and the delivered groups are deterministic: they must be
identical, wave by wave. Wedged heads are made overdue by moving their
delivery deadline, never by waiting out a real interval.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

from nakama_tpu import faults as jfaults
from nakama_tpu import overload as joverload
from nakama_tpu.config import MatchmakerConfig as JaxConfig
from nakama_tpu.logger import test_logger as jax_quiet_logger
from nakama_tpu.matchmaker import LocalMatchmaker as JaxLocal
from nakama_tpu.matchmaker import MatchmakerPresence as JaxPresence
from nakama_tpu.matchmaker.local import PartialPublish as JaxPartialPublish
from nakama_tpu.matchmaker.tpu import TpuBackend
from nakama_tpu_torch import faults, overload
from nakama_tpu_torch.config import MatchmakerConfig
from nakama_tpu_torch.logger import test_logger as quiet_logger
from nakama_tpu_torch.matchmaker import LocalMatchmaker, MatchmakerPresence
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from nakama_tpu_torch.matchmaker.local import PartialPublish
from test_torch_slice import add_ticket, groups, ticket_stream

BLOCKS = dict(row_block=8, col_block=64, big_row_block=64, big_col_block=64)
INTERVAL = 0.3


@pytest.fixture(autouse=True)
def _clean_planes():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


def make(jax: bool, **overrides):
    """One matchmaker (capacity 2048, 8/64 blocks, fn = fs = 8, the
    exact small-pool scan) recording what it delivers."""
    common = dict(
        pool_capacity=2048, candidates_per_ticket=32, numeric_fields=8,
        string_fields=8, max_constraints=8, max_intervals=99,
        interval_sec=INTERVAL, pipeline_deadline_guard_sec=0.1,
        delivery_watchdog_sec=0.2,
    )
    common.update(overrides)
    got = []
    if jax:
        cfg = JaxConfig(**common)
        backend = TpuBackend(cfg, jax_quiet_logger(), **BLOCKS)
        mm = JaxLocal(
            jax_quiet_logger(), cfg, backend=backend, on_matched=got.append
        )
    else:
        cfg = MatchmakerConfig(**common)
        backend = CudaBackend(cfg, quiet_logger(), device="cpu", **BLOCKS)
        mm = LocalMatchmaker(
            quiet_logger(), cfg, backend=backend, on_matched=got.append
        )
    return mm, got


async def until(cond, timeout=20.0):
    t_end = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > t_end:
            raise TimeoutError("condition not reached")
        await asyncio.sleep(0.005)


def delivered(mm, failed: int = 0) -> bool:
    """Every cohort dispatched so far was delivered (`failed` of them
    were lost to a fault and reclaimed instead)."""
    b = mm.backend
    return b.pipeline_depth() == 0 and b.tracing.deliveries_total + failed >= (
        b._dispatch_counter
    )


async def serve_waves(mm, got, jax, waves, seed):
    """Run the loop; add each wave once everything dispatched so far was
    delivered. Returns the groups delivered after each wave."""
    presence = JaxPresence if jax else MatchmakerPresence
    rng = np.random.default_rng(seed)
    per_wave = []
    mm.start()
    try:
        start = 0
        for n in waves:
            before = mm.backend._dispatch_counter
            for spec in ticket_stream(rng, n, "1v1", start):
                add_ticket(mm, spec, presence)
            start += n
            await until(
                lambda: mm.backend._dispatch_counter > before and delivered(mm)
            )
            per_wave.append(groups(got))
            got.clear()
    finally:
        mm.stop()
    return per_wave


def run_both(waves, seed, **overrides):
    out = {}
    for jax in (True, False):
        mm, got = make(jax, **overrides)
        out[jax] = (mm, asyncio.run(serve_waves(mm, got, jax, waves, seed)))
    return out


def test_service_loop_delivers_waves_like_jax():
    """The loop dispatches each wave and the delivery stage publishes its
    cohort: same groups as the JAX package, in dispatch order, no ticket
    twice, and once drained no in-flight claim and no pipeline left."""
    out = run_both([40, 30, 30], seed=4)
    (jmm, want), (tmm, got) = out[True], out[False]
    assert got == want
    assert all(got), got
    deliveries = tmm.backend.tracing.recent_deliveries(100)
    pcs = [d["_pc_dispatch"] for d in deliveries]
    assert pcs == sorted(pcs) and len(pcs) == 3
    for d in deliveries:
        assert d["ready_lag_s"] <= d["collect_lag_s"] <= d["accept_lag_s"]
        assert d["accept_lag_s"] <= d["publish_lag_s"]
    seen = [t for wave in got for g in wave for t in g]
    assert len(seen) == len(set(seen))
    assert tmm.backend.pipeline_depth() == 0
    assert not tmm.backend._in_flight_mask.any()
    assert tmm.backend._ready_cb is None  # stop() unhooked the signal


def test_worker_thread_fires_ready_callback():
    """The cohort worker signals completion once per cohort, from its own
    thread, after the ready stamp — a woken collector always finds a
    collectable head."""
    mm, got = make(False, interval_sec=15)
    calls = []
    evt = threading.Event()

    def cb():
        calls.append(threading.current_thread() is not threading.main_thread())
        evt.set()

    mm.backend.set_ready_callback(cb)
    rng = np.random.default_rng(1)
    for spec in ticket_stream(rng, 20, "1v1", 0):
        add_ticket(mm, spec, MatchmakerPresence)
    mm.process()  # dispatch
    assert evt.wait(30)
    assert mm.backend.head_ready()
    assert mm.collect_pipelined() is not None and got
    assert calls == [True]
    (d,) = mm.backend.tracing.recent_deliveries(1)
    for key in ("ready_lag_s", "collect_lag_s", "accept_lag_s", "publish_lag_s"):
        assert isinstance(d[key], float), key
    mm.stop()


def test_collect_raise_reclaims_on_event_path_like_jax():
    """An armed device.collect failure surfaces through the delivery
    stage: the cohort's slots reclaim, the tickets re-dispatch on the
    next interval, and the same groups land as in the JAX package."""
    out = {}
    for jax in (True, False):
        mm, got = make(jax)
        (jfaults if jax else faults).arm("device.collect", "raise", count=1)

        async def drive():
            mm.start()
            try:
                rng = np.random.default_rng(6)
                for spec in ticket_stream(rng, 30, "1v1", 0):
                    add_ticket(mm, spec, JaxPresence if jax else MatchmakerPresence)
                await until(
                    lambda: mm.backend._dispatch_counter >= 2
                    and delivered(mm, failed=1)
                )
            finally:
                mm.stop()

        asyncio.run(drive())
        out[jax] = (groups(got), mm.backend.inflight_reclaimed)
        assert not mm.backend._in_flight_mask.any()
    assert out[False] == out[True]
    assert out[False][1] == 30 and out[False][0]


def test_publish_drop_and_partial_publish_are_contained():
    """delivery.publish in drop mode discards one publish (single-shot:
    the tickets left the pool) and the next cohort publishes; a handler
    raising PartialPublish reports its held tickets, as in the JAX
    package."""
    for jax in (True, False):
        mm, got = make(jax)
        (jfaults if jax else faults).arm("delivery.publish", "drop", count=1)
        presence = JaxPresence if jax else MatchmakerPresence
        rng = np.random.default_rng(2)
        specs = ticket_stream(rng, 24, "1v1", 0)
        for spec in specs[:12]:
            add_ticket(mm, spec, presence)
        mm.process()
        mm.backend.wait_idle(30)
        assert mm.collect_pipelined() and not got  # dropped
        for spec in specs[12:]:
            add_ticket(mm, spec, presence)
        mm.process()
        mm.backend.wait_idle(30)
        mm.collect_pipelined()
        assert got and len(mm.store) < 24
        exc = JaxPartialPublish if jax else PartialPublish

        def holding(batch, exc=exc):
            raise exc(["t1", "t2"], "origin node down")

        mm.on_matched = holding
        assert mm._publish(got[0]) == frozenset({"t1", "t2"})
        mm.stop()


def test_join_head_bounded_by_own_interval_and_booked_to_reclaim():
    """A wedged head never blocks the deadline guard past its own
    deadline + guard, whatever the caller's bound; the reclaim path then
    abandons it (slots freed, tickets reactivated) — in both packages."""
    for jax in (True, False):
        mm, _ = make(jax, inflight_reclaim_deadline_ms=50)
        (jfaults if jax else faults).arm(
            "device.collect", "stall", stall_s=1.0, count=1
        )
        rng = np.random.default_rng(3)
        for spec in ticket_stream(rng, 10, "1v1", 0):
            add_ticket(mm, spec, JaxPresence if jax else MatchmakerPresence)
        mm.process()  # dispatch; the worker wedges for 1 s
        holder = mm.backend._pipeline_queue[0][0][1]
        holder["deadline"] = time.perf_counter() + 0.1
        t0 = time.perf_counter()
        assert not mm.backend.join_head(time.perf_counter() + 60.0)
        assert time.perf_counter() - t0 < 0.6  # deadline + guard (0.1)
        t_end = time.perf_counter() + 2.0
        while mm.backend.pipeline_depth() and time.perf_counter() < t_end:
            mm.backend.reclaim_stale()
            time.sleep(0.02)
        assert mm.backend.pipeline_depth() == 0
        assert mm.backend.inflight_reclaimed == 10
        assert int(mm.store.active.sum()) == 10
        mm.stop()


def test_pause_resume_and_deadline_checked_add():
    """A paused loop dispatches nothing; resume picks the pool up. An add
    whose caller's deadline already passed is refused before it
    registers, in both packages."""
    mm, got = make(False)

    async def drive():
        mm.pause()
        mm.start()
        try:
            rng = np.random.default_rng(7)
            for spec in ticket_stream(rng, 12, "1v1", 0):
                add_ticket(mm, spec, MatchmakerPresence)
            await asyncio.sleep(2.5 * INTERVAL)
            assert mm.backend._dispatch_counter == 0
            mm.resume()
            await until(lambda: mm.backend._dispatch_counter and delivered(mm))
        finally:
            mm.stop()

    asyncio.run(drive())
    assert got
    for ov, mmx, presence in (
        (overload, mm, MatchmakerPresence),
        (joverload, make(True)[0], JaxPresence),
    ):
        mmx._stopped = False
        p = presence(user_id="late", session_id="late")
        with ov.deadline_scope(ov.Deadline(0.0)):
            with pytest.raises(ov.DeadlineExceeded):
                mmx.add([p], "late", "", "*", 2, 2)
        assert mmx.store.get("late") is None
        mmx.stop()


def test_kernel_failure_ends_the_service_and_stop_raises_it(monkeypatch):
    """A kernel that fails to launch inside the running loop is not
    absorbed: the interval task ends on the error, the delivery task
    stops with it, adds are refused, the breaker stays closed (the host
    oracle never takes the pool over), and `stop()` re-raises the
    error."""
    from nakama_tpu_torch.matchmaker import ErrNotAvailable

    mm, got = make(False)

    def failing(*a, **kw):
        raise RuntimeError("stage1_wgmma kernel launch failed: error 700")

    monkeypatch.setattr(mm.backend, "_dispatch", failing)

    async def drive():
        mm.start()
        rng = np.random.default_rng(11)
        for spec in ticket_stream(rng, 12, "1v1", 0):
            add_ticket(mm, spec, MatchmakerPresence)
        await until(lambda: mm.error is not None)
        await until(lambda: mm._delivery_task.done())
        with pytest.raises(ErrNotAvailable):
            add_ticket(mm, ticket_stream(rng, 1, "1v1", 12)[0], MatchmakerPresence)
        with pytest.raises(RuntimeError, match="launch failed"):
            mm.stop()

    asyncio.run(drive())
    assert mm._task is None and not got
    br = mm.backend.breaker
    assert br.state == "closed" and br.consecutive_failures == 0
    assert int(mm.store.active.sum()) == 12  # nothing claimed, nothing lost

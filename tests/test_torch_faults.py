"""The port's fault plane and degradation ladder held against the JAX
package's.

The same numpy-seeded tickets go through the JAX package's
`LocalMatchmaker` + `TpuBackend` and the port's `LocalMatchmaker` +
`CudaBackend(device="cpu")`, with the same faults armed on each
package's own plane. The breakers run on a fake clock, so no test sleeps
through a cooldown. Breaker transition sequences, per-interval match
groups (through failed, open host-oracle and half-open probe intervals)
and reclaimed slot counts must be identical. Wedged cohorts are made
overdue by moving their delivery deadline back, not by waiting for it.
"""

import numpy as np
import pytest
import torch

from nakama_tpu import faults as jfaults
from nakama_tpu.config import MatchmakerConfig as JaxConfig
from nakama_tpu.faults import CircuitBreaker as JaxBreaker
from nakama_tpu.faults import classify_exception as jax_classify
from nakama_tpu.logger import test_logger as jax_quiet_logger
from nakama_tpu.matchmaker import LocalMatchmaker as JaxLocal
from nakama_tpu.matchmaker import MatchmakerPresence as JaxPresence
from nakama_tpu.matchmaker.tpu import TpuBackend
from nakama_tpu_torch import faults
from nakama_tpu_torch.config import MatchmakerConfig
from nakama_tpu_torch.faults import (
    CircuitBreaker, InjectedFault, classify_exception, degrades,
)
from nakama_tpu_torch.logger import test_logger as quiet_logger
from nakama_tpu_torch.matchmaker import LocalMatchmaker, MatchmakerPresence
from nakama_tpu_torch.matchmaker import device2 as td2
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from test_torch_slice import add_ticket, groups, ticket_stream

BLOCKS = dict(row_block=8, col_block=64, big_row_block=64, big_col_block=64)


@pytest.fixture(autouse=True)
def _clean_planes():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


def make_pair(**overrides):
    """Both matchmakers on the two-stage pairing path (capacity 2048,
    64-wide blocks, fn = fs = 8), their breakers on one fake clock."""
    common = dict(
        pool_capacity=2048, candidates_per_ticket=32, big_pool_threshold=64,
        numeric_fields=8, string_fields=8, max_constraints=8,
        max_intervals=3, interval_pipelining=False,
        breaker_threshold=2, breaker_cooldown_ms=1000,
    )
    common.update(overrides)
    jcfg, tcfg = JaxConfig(**common), MatchmakerConfig(**common)
    jmm = JaxLocal(
        jax_quiet_logger(), jcfg,
        backend=TpuBackend(jcfg, jax_quiet_logger(), **BLOCKS),
    )
    tmm = LocalMatchmaker(
        quiet_logger(), tcfg,
        backend=CudaBackend(tcfg, quiet_logger(), device="cpu", **BLOCKS),
    )
    now = [0.0]
    for mm in (jmm, tmm):
        mm.backend.breaker._clock = lambda: now[0]
    return jmm, tmm, now


def add_wave(jmm, tmm, rng, n, start):
    for spec in ticket_stream(rng, n, "1v1", start):
        add_ticket(jmm, spec, JaxPresence)
        add_ticket(tmm, spec, MatchmakerPresence)
    return start + n


def flips(backend):
    return [
        (e["old"], e["new"])
        for e in backend.tracing.recent_breaker_events(64)
        if e.get("kind") == "matchmaker_backend"
    ]


def stranded(mm):
    """alive-but-inactive slots + leftover in-flight claims."""
    store = mm.store
    return int(store.alive.sum()) - int(store.active.sum()) + int(
        mm.backend._in_flight_mask.sum()
    )


def drain(mm, rounds=4):
    """Collect every queued cohort; returns the groups delivered."""
    out = []
    for _ in range(rounds):
        mm.backend.wait_idle(30)
        out += groups([mm.collect_pipelined() or []])
        if not mm.backend._pipeline_queue:
            break
    return out


# ------------------------------------------------------------ primitives


def test_fault_plane_modes_and_seeded_schedule_match_jax():
    plane, jplane = faults.FaultPlane(), jfaults.FaultPlane()
    for pl in (plane, jplane):
        pl.arm("p.raise", "raise", count=2)
    for pl, exc in ((plane, InjectedFault), (jplane, jfaults.InjectedFault)):
        for _ in range(2):
            with pytest.raises(exc):
                pl.fire("p.raise")
        assert pl.fire("p.raise") is False  # count exhausted
        assert pl.fired["p.raise"] == 2
    schedules = []
    for pl in (plane, jplane):
        pl.arm("p", "drop", probability=0.5, seed=42)
        schedules.append([pl.fire("p") for _ in range(64)])
    assert schedules[0] == schedules[1]
    assert 5 < sum(schedules[0]) < 59
    with plane.armed_ctx("p.stall", mode="stall", stall_s=0.0):
        assert plane.armed() == ["p", "p.stall"]
    assert plane.armed() == ["p"]


def test_classify_exception_table_and_cuda_counterparts():
    table = [
        OSError("reset"), TimeoutError(), ValueError("bug"), KeyError("k"),
        ConnectionResetError(), RuntimeError("boom"),
    ]
    for exc in table:
        assert classify_exception(exc) == jax_classify(exc), exc
    assert classify_exception(InjectedFault("p")) == "transient"
    assert classify_exception(InjectedFault("p", fatal=True)) == "fatal"
    # Device weather on the card: an allocation that may succeed later.
    assert classify_exception(torch.cuda.OutOfMemoryError("oom")) == "transient"
    # A hand-written kernel that fails to launch is a bug: fatal, the
    # breaker opens at once (kernels.py raises exactly this form).
    launch = RuntimeError("stage1_wgmma kernel launch failed: error 700")
    assert classify_exception(launch) == "fatal"
    # Which failures the ladder may absorb at all: injected faults and
    # device memory pressure. A kernel that fails to build or launch, or
    # any other error from the card, raises instead.
    assert degrades(InjectedFault("p")) and degrades(InjectedFault("p", fatal=True))
    assert degrades(torch.cuda.OutOfMemoryError("oom"))
    for exc in (launch, RuntimeError("CUDA error: an illegal memory access"),
                RuntimeError("nvcc failed"), OSError("reset"), ValueError()):
        assert not degrades(exc), exc


def test_breaker_ladder_with_fake_clock_matches_jax():
    runs = []
    for cls in (CircuitBreaker, JaxBreaker):
        now = [0.0]
        events = []
        br = cls(
            threshold=3, cooldown_s=10.0, clock=lambda: now[0],
            on_transition=lambda o, n, r: events.append((o, n, r)),
        )
        trail = [br.allow()]
        br.record_failure()
        br.record_failure()
        br.record_success()
        trail.append((br.state, br.consecutive_failures))
        for _ in range(3):
            br.record_failure()
        trail.append((br.state, br.allow()))
        now[0] += 9.9
        trail.append(br.allow())
        now[0] += 0.2
        trail += [br.allow(), br.state, br.allow()]
        br.record_failure()  # probe failed: cooldown doubles
        trail.append((br.state, br.cooldown_s))
        now[0] += 20.1
        trail.append(br.allow())
        br.record_success()
        trail.append((br.state, br.cooldown_s))
        br.record_failure(fatal=True)
        br.record_success()  # stale success must not close it
        trail.append(br.state)
        now[0] += br.cooldown_s + 0.1
        trail.append(br.allow())
        br.release_probe()
        trail.append(br.allow())
        runs.append((trail, events))
    assert runs[0] == runs[1]
    assert [e[:2] for e in runs[0][1]][:3] == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "open"),
    ]


# ----------------------------------------------------- matchmaker ladder


def test_breaker_opens_to_host_fallback_and_probes_back_like_jax():
    """Two failed dispatches open the breaker; the open interval serves
    every active from the host oracle; after the (fake) cooldown the
    half-open probe dispatch closes it. Groups, transitions and the
    untouched fault point match the JAX package interval by interval."""
    jmm, tmm, now = make_pair()
    rng = np.random.default_rng(21)
    start = add_wave(jmm, tmm, rng, 120, 0)
    for plane in (faults, jfaults):
        plane.arm("device.dispatch", "raise", count=2)
    got, want = [], []
    for _ in range(2):  # two failed dispatches: the breaker opens
        want.append(groups([jmm.process()]))
        got.append(groups([tmm.process()]))
    assert tmm.backend.breaker.state == "open"
    assert faults.PLANE.fired["device.dispatch"] == 2
    # Open: the interval runs the host oracle, the device path untouched.
    want.append(groups([jmm.process()]))
    got.append(groups([tmm.process()]))
    assert faults.PLANE.fired["device.dispatch"] == 2
    assert got[2] and not got[0] and not got[1]
    now[0] += 1.1  # past the cooldown
    start = add_wave(jmm, tmm, rng, 60, start)
    want.append(groups([jmm.process()]))  # the half-open probe
    got.append(groups([tmm.process()]))
    want.append(groups([jmm.process()]))
    got.append(groups([tmm.process()]))
    assert got == want
    assert got[3]  # the probe interval matched on the device
    expected = [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]
    assert flips(tmm.backend) == flips(jmm.backend) == expected
    assert tmm.backend.breaker.state == "closed"
    # 1v1 tickets get one attempt each (min == max): what is left is
    # inactive alike in both, and no in-flight claim survives.
    assert stranded(tmm) == stranded(jmm)
    assert not tmm.backend._in_flight_mask.any()


def test_kernel_launch_failure_opens_breaker_at_once(monkeypatch):
    """A stage-1 launch failure is a bug, not device weather: it raises
    out of the kernel wrapper and out of `process()`, and never reaches
    the breaker — the ladder must not serve a broken kernel's pool from
    the host oracle. What does open the breaker at once is a fatal
    failure the ladder absorbs (an injected fatal fault), on its first
    occurrence instead of after the threshold."""
    _, tmm, _ = make_pair(breaker_threshold=3)
    rng = np.random.default_rng(5)
    for spec in ticket_stream(rng, 100, "1v1", 0):
        add_ticket(tmm, spec, MatchmakerPresence)

    def failing(**kw):
        raise RuntimeError("stage1_wgmma kernel launch failed: error 700")

    with monkeypatch.context() as m:
        m.setattr(td2, "stage1", failing)
        with pytest.raises(RuntimeError, match="launch failed"):
            tmm.process()
    br = tmm.backend.breaker
    assert br.state == "closed" and br.consecutive_failures == 0
    assert stranded(tmm) == 0  # nothing dispatched, nothing claimed
    faults.arm("device.dispatch", "raise", count=1, fatal=True)
    assert not groups([tmm.process()])
    assert br.state == "open"
    assert tmm.backend.tracing.breadcrumbs[-1]["dispatch_failed"] == 1
    assert stranded(tmm) == 0  # the failed interval's actives came back


def test_cuda_error_at_collect_reclaims_then_raises():
    """An error from the card surfacing at a cohort's fetch (here an
    illegal address, raised where the fetch runs) reclaims the cohort's
    slots and then raises out of the collect; the breaker never hears of
    it, and the tickets match once the card is sound."""
    _, tmm, _ = make_pair(interval_pipelining=True, max_intervals=100)
    rng = np.random.default_rng(8)
    for spec in ticket_stream(rng, 100, "1v1", 0):
        add_ticket(tmm, spec, MatchmakerPresence)
    faults.arm(
        "device.collect", "raise", count=1,
        exc=RuntimeError("CUDA error: an illegal memory access was encountered"),
    )
    assert not groups([tmm.process()])
    tmm.backend.wait_idle(30)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tmm.collect_pipelined()
    assert tmm.backend.inflight_reclaimed == 100
    assert stranded(tmm) == 0
    br = tmm.backend.breaker
    assert br.state == "closed" and br.consecutive_failures == 0
    assert groups([tmm.process()]) + drain(tmm)


def test_collect_failure_reclaims_cohort_like_jax():
    jmm, tmm, _ = make_pair(interval_pipelining=True, max_intervals=100)
    rng = np.random.default_rng(8)
    add_wave(jmm, tmm, rng, 100, 0)
    for plane in (faults, jfaults):
        plane.arm("device.collect", "raise", count=1)
    got, want = [], []
    for mm, out in ((jmm, want), (tmm, got)):
        out.append(groups([mm.process()]))  # dispatch; the worker raises
        mm.backend.wait_idle(30)
        out.append(groups([mm.collect_pipelined() or []]))  # reclaims
        out.append(mm.backend.inflight_reclaimed)
        out.append(stranded(mm))
        out.append(groups([mm.process()]) + drain(mm))  # re-dispatch
        out.append(groups([mm.process()]) + drain(mm))
    assert got == want
    assert got[2] == 100 and got[3] == 0 and got[4]
    assert tmm.backend.breaker.consecutive_failures == 0  # later success


def wedge_head(mm):
    """Make the queued head cohort overdue past its reclaim grace."""
    mm.backend._pipeline_queue[0][0][1]["deadline"] -= 1000.0


def test_wedged_cohort_reclaimed_by_backstop_sweep_like_jax():
    jmm, tmm, _ = make_pair(interval_pipelining=True, max_intervals=100)
    rng = np.random.default_rng(9)
    add_wave(jmm, tmm, rng, 80, 0)
    for plane in (faults, jfaults):
        plane.arm("device.collect", "stall", stall_s=0.3, count=1)
    got, want = [], []
    for mm, out in ((jmm, want), (tmm, got)):
        mm.process()  # dispatch; the worker stalls
        wedge_head(mm)
        mm.backend.reclaim_stale()  # the sweep abandons the cohort
        out.append(mm.backend.pipeline_depth())
        out.append(mm.backend.inflight_reclaimed)
        out.append(stranded(mm))
        out.append(groups([mm.process()]) + drain(mm))
        out.append(groups([mm.process()]) + drain(mm))
        out.append(stranded(mm))
    assert got == want
    assert got[:3] == [0, 80, 0]
    assert got[3]


def test_wedged_probe_cohort_reopens_breaker_like_jax():
    """A half-open probe cohort that wedges and is abandoned is booked
    as the probe failing: open again (cooldown doubled), then a healthy
    probe closes it."""
    jmm, tmm, now = make_pair(
        interval_pipelining=True, max_intervals=100, breaker_threshold=1,
        breaker_cooldown_ms=100,
    )
    rng = np.random.default_rng(10)
    add_wave(jmm, tmm, rng, 80, 0)
    states = {}
    for mm, plane in ((jmm, jfaults), (tmm, faults)):
        trail = []
        plane.arm("device.dispatch", "raise", count=1)
        mm.process()
        trail.append(mm.backend.breaker.state)
        now[0] += 0.11
        plane.arm("device.collect", "stall", stall_s=0.3, count=1)
        mm.process()  # the probe dispatch; its worker wedges
        trail.append(mm.backend.breaker.state)
        wedge_head(mm)
        mm.process()  # the sweep abandons the wedged probe
        trail.append((mm.backend.breaker.state, mm.backend.breaker.cooldown_s))
        now[0] += 0.21
        mm.process()  # a fresh probe
        trail.append(mm.backend.breaker.state)
        drain(mm)
        mm.process()
        drain(mm)
        trail.append(mm.backend.breaker.state)
        trail.append(stranded(mm))
        trail.append(flips(mm.backend))
        states[mm is tmm] = trail
        now[0] = 0.0
    assert states[True] == states[False]
    assert states[True][:5] == [
        "open", "half_open", ("open", 0.2), "half_open", "closed",
    ]


def test_stale_cohort_failure_does_not_steal_the_probe_like_jax():
    jmm, tmm, now = make_pair(breaker_threshold=1, breaker_cooldown_ms=10)
    for mm in (jmm, tmm):
        br = mm.backend.breaker
        br.record_failure(fatal=True)
        now[0] += 0.02
        assert br.allow() and br.state == "half_open"
        mm.backend._note_backend_failure(
            "collect", OSError("stale cohort"), {}, probe=False
        )
        assert br.state == "half_open" and br._probe_inflight
        br.record_success()
        assert br.state == "closed"
        now[0] = 0.0

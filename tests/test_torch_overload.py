"""The port's overload plane held against the JAX package's.

The same inputs go through `nakama_tpu.overload` and
`nakama_tpu_torch.overload`: header parsing and deadlines, scripted
admission sequences (numpy-seeded: admits by class, releases, ladder
levels), the OK/WARN/SHED ladder over seeded signal sequences with
hysteresis, the signal builders, and the token-bucket rate limiter on a
fake clock. Every decision — admitted, parked, rejected and why — every
ladder level, the transitions the tracing ledgers record and the
metrics both registries hold must be identical.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest

from nakama_tpu import faults as jfaults
from nakama_tpu import overload as jov
from nakama_tpu import tracing as jtracing
from nakama_tpu.metrics import Metrics as JaxMetrics
from nakama_tpu_torch import faults as tfaults
from nakama_tpu_torch import overload as tov
from nakama_tpu_torch import tracing as ttracing
from nakama_tpu_torch.logger import test_logger as quiet_logger
from nakama_tpu_torch.metrics import Metrics

PKGS = {
    "jax": (jov, jtracing, JaxMetrics, jfaults),
    "port": (tov, ttracing, Metrics, tfaults),
}


@pytest.fixture(autouse=True)
def _clean_fault_planes():
    for f in (jfaults, tfaults):
        f.disarm()
        f.PLANE.fired.clear()
    yield
    for f in (jfaults, tfaults):
        f.disarm()
        f.PLANE.fired.clear()


def _events(tracing) -> list[dict]:
    """The overload ledger without its wall-clock stamps."""
    return [
        {k: v for k, v in e.items() if k != "ts"}
        for e in tracing.recent_overload_events(256)
    ]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize(
    "value", ["100m", "5S", "2H", "7M", "3u", "9n", "0m", "", "5", "-1S",
              "1.5S", "10x", " 12m "],
)
def test_grpc_timeout_parsing_agrees(value):
    assert _outcome(lambda: tov.parse_grpc_timeout(value)) == _outcome(
        lambda: jov.parse_grpc_timeout(value)
    )


@pytest.mark.parametrize(
    "headers",
    [{}, {"grpc-timeout": "250m"}, {"X-Request-Timeout": "1500"},
     {"X-Request-Timeout": "0"}, {"X-Request-Timeout": "abc"},
     {"grpc-timeout": "1S", "X-Request-Timeout": "9"}, {"grpc-timeout": "x"}],
)
def test_deadline_from_headers_agrees(headers):
    def read(mod):
        def f():
            dl = mod.deadline_from_headers(headers, default_ms=3000)
            return round(dl.remaining(), 1), dl.explicit
        return _outcome(f)

    assert read(tov) == read(jov)


def test_deadline_scope_and_checkpoint():
    with tov.deadline_scope(tov.Deadline(10.0)) as dl:
        assert tov.current_deadline() is dl
        tov.check_deadline("x")
    assert tov.current_deadline() is None
    with tov.deadline_scope(tov.Deadline(0.0)):
        with pytest.raises(tov.DeadlineExceeded, match="at db"):
            tov.check_deadline("db")


def admission_script(seed: int, n: int = 160) -> list[tuple]:
    """Ops: ("admit", cls), ("release",), ("level", level)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            ops.append(("admit", int(rng.integers(0, 3))))
        elif r < 0.9:
            ops.append(("release",))
        else:
            ops.append(("level", int(rng.integers(0, 3))))
    return ops


async def run_admission(pkg: str, ops: list[tuple]) -> tuple[list, dict, dict]:
    mod, _, metrics_cls, _ = PKGS[pkg]
    metrics = metrics_cls()
    adm = mod.AdmissionController(
        3, {mod.REALTIME: 4, mod.RPC: 2, mod.LIST: 2}, metrics=metrics
    )
    held = 0
    log = []
    for op in ops:
        if op[0] == "admit":
            try:
                fut = adm.try_admit(op[1])
            except mod.AdmissionRejected as e:
                log.append(("rejected", e.cls, e.reason, e.retry_after_sec))
                continue
            if fut is None:
                held += 1
                log.append(("admitted", op[1]))
            else:
                fut.add_done_callback(lambda f: None)
                log.append(("parked", op[1]))
        elif op[0] == "release":
            if held:
                held -= 1
                before = adm.admitted_total
                adm.release()
                # A release hands the permit to a parked waiter.
                held += adm.admitted_total - before
                log.append(("released", adm.inflight))
        else:
            adm.set_level(op[1])
            log.append(("level", op[1]))
        log.append(adm.stats()["queued"])
    await asyncio.sleep(0)
    return log, adm.stats(), metrics.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
async def test_admission_decisions_agree(seed):
    ops = admission_script(seed)
    j = await run_admission("jax", ops)
    t = await run_admission("port", ops)
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert t[2] == j[2]
    kinds = {entry[0] for entry in t[0] if isinstance(entry, tuple)}
    assert {"admitted", "parked", "rejected"} <= kinds


async def test_admission_deadline_bounded_wait_and_priority():
    adm = tov.AdmissionController(1, {tov.REALTIME: 2, tov.RPC: 2, tov.LIST: 2})
    await adm.admit(tov.RPC)
    with pytest.raises(tov.DeadlineExceeded):
        await adm.admit(tov.RPC, tov.Deadline(0.05))
    order = []

    async def waiter(cls):
        await adm.admit(cls)
        order.append(cls)

    tasks = [asyncio.ensure_future(waiter(c)) for c in (tov.LIST, tov.RPC,
                                                        tov.REALTIME)]
    await asyncio.sleep(0)
    for _ in range(3):
        adm.release()
        await asyncio.sleep(0)
    await asyncio.gather(*tasks)
    assert order == [tov.REALTIME, tov.RPC, tov.LIST]
    adm.release()
    assert adm.inflight == 0


def ladder_levels(seed: int, n: int = 60) -> list[tuple[int, int]]:
    rng = np.random.default_rng(seed)
    # Runs of one level, so that hysteresis has something to hold.
    out = []
    while len(out) < n:
        a = int(rng.choice(3, p=[0.6, 0.25, 0.15]))
        b = int(rng.choice(3, p=[0.8, 0.15, 0.05]))
        out.extend([(a, b)] * int(rng.integers(1, 5)))
    return out[:n]


def run_ladder(pkg: str, seq, recover: int, fault_at=()):
    mod, tr, metrics_cls, fplane = PKGS[pkg]
    metrics = metrics_cls()
    tracing = tr.Tracing()
    adm = mod.AdmissionController(4, {mod.REALTIME: 4, mod.RPC: 4, mod.LIST: 4})
    ov = mod.OverloadController(
        adm, recover_samples=recover, metrics=metrics, tracing=tracing,
    )
    cur = {"a": 0, "b": 0}
    ov.register_signal("a", lambda: cur["a"])
    ov.register_signal("b", lambda: cur["b"])
    ov.register_signal("broken", lambda: 1 / 0)
    levels = []
    for i, (a, b) in enumerate(seq):
        cur["a"], cur["b"] = a, b
        if i in fault_at:
            fplane.arm("overload.signal", "drop", count=1)
        levels.append((ov.sample(), adm.level))
    return (
        levels, ov.stats(), _events(tracing),
        metrics.snapshot()["nakama_overload_state"],
    )


@pytest.mark.parametrize("seed,recover", [(0, 1), (1, 2), (2, 3), (3, 3)])
def test_ladder_levels_agree(seed, recover):
    seq = ladder_levels(seed)
    j = run_ladder("jax", seq, recover, fault_at=(7, 30))
    t = run_ladder("port", seq, recover, fault_at=(7, 30))
    assert t == j
    levels = [lv for lv, _ in t[0]]
    assert levels[7] == tov.SHED and levels[30] == tov.SHED
    assert tfaults.PLANE.fired["overload.signal"] == 2


def test_drain_walks_the_ladder_to_shed():
    out = []
    for mod, tr, _, _ in PKGS.values():
        adm = mod.AdmissionController(2, {mod.REALTIME: 2, mod.RPC: 2, mod.LIST: 2})
        tracing = tr.Tracing()
        ov = mod.OverloadController(adm, tracing=tracing, logger=None)
        ov.enter_drain()
        out.append((ov.state, adm.level, _events(tracing)))
    assert out[0] == out[1]
    assert out[1][0] == tov.SHED


def test_signal_builders_agree():
    depth = {"v": 0}
    head = {"v": None}

    class Breaker:
        state = "closed"

    br = Breaker()
    sigs = {}
    for name, (mod, _, _, _) in PKGS.items():
        sigs[name] = [
            mod.db_queue_signal(lambda: depth["v"], 100, 0.5, 0.9),
            mod.breaker_signal(lambda: br),
            mod.breaker_signal(lambda: None),
            mod.interval_lag_signal(lambda: head["v"], 2.0, 15.0),
        ]
    rng = np.random.default_rng(5)
    for _ in range(50):
        depth["v"] = int(rng.integers(0, 120))
        br.state = str(rng.choice(["closed", "open", "half_open"]))
        r = rng.random()
        head["v"] = (
            None if r < 0.2 else time.perf_counter() - float(rng.uniform(-5, 25))
        )
        got = {name: [s() for s in ss] for name, ss in sigs.items()}
        assert got["port"] == got["jax"]


def test_slo_burn_signal_agrees():
    out = {}
    for name, (mod, tr, metrics_cls, _) in PKGS.items():
        metrics = metrics_cls()
        rec = tr.SloRecorder(
            {"matchmaker_interval": {"target": 0.99, "threshold_ms": 100}},
            metrics=metrics,
        )
        sig = mod.slo_burn_signal(rec, warn_burn=2.0, shed_burn=10.0)
        quiet = mod.slo_burn_signal(rec, 2.0, 10.0, escalate=False)
        levels = []
        for i, v in enumerate([50] * 50 + [500] * 2 + [50] * 10 + [500] * 20):
            rec.observe("matchmaker_interval", v)
            if i % 10 == 9:
                levels.append((sig(), quiet()))
        snap = metrics.snapshot()
        out[name] = (
            levels, rec.snapshot(),
            {k: v for k, v in snap.items() if k.startswith("nakama_slo_burn")},
        )
    assert out["port"] == out["jax"]
    assert {lv for lv, _ in out["port"][0]} == {tov.OK, tov.WARN, tov.SHED}


def test_rate_limiter_agrees_on_a_fake_clock(monkeypatch):
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    rng = np.random.default_rng(9)
    limiters = {
        name: mod.RateLimiter(rate=5.0, burst=3, max_keys=16)
        for name, (mod, _, _, _) in PKGS.items()
    }
    for _ in range(400):
        clock["t"] += float(rng.exponential(0.05))
        key = f"k{int(rng.integers(0, 24))}"
        got = {name: rl.allow(key) for name, rl in limiters.items()}
        assert got["port"] == got["jax"]
    assert list(limiters["port"]._buckets) == list(limiters["jax"]._buckets)
    assert tov.RateLimiter(0.0, 1).allow("x")


async def test_sampler_task_runs_and_stops():
    adm = tov.AdmissionController(2, {tov.REALTIME: 2, tov.RPC: 2, tov.LIST: 2})
    ov = tov.OverloadController(adm, recover_samples=1, logger=quiet_logger())
    level = {"v": tov.WARN}
    ov.register_signal("x", lambda: level["v"])
    ov.start(0.01)
    await asyncio.sleep(0.05)
    assert ov.state == tov.WARN
    level["v"] = tov.OK
    await asyncio.sleep(0.05)
    assert ov.state == tov.OK
    ov.stop()
    assert ov._task is None

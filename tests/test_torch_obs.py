"""The port's tracing, device telemetry and logger held against the JAX
package's.

The same inputs go through both packages' `Ledger`, W3C traceparent
parsing, tail sampling (decisions by trace id under one shared salt),
`emit_matched_spans` stage chains, the SLO burn math and the kernel-clock
percentile math; the results must be identical. The port's own additions
— device time from completed CUDA events, build-watch, the busy share
read off a profiler trace, trace ids on log lines — are checked on the
CPU with the card's parts stubbed where they would need one.
"""

import io
import json

import numpy as np
import pytest

from nakama_tpu import devobs as jdevobs
from nakama_tpu import tracing as jtracing
from nakama_tpu.config import MatchmakerConfig as JaxConfig
from nakama_tpu.logger import test_logger as jax_quiet_logger
from nakama_tpu.matchmaker import LocalMatchmaker as JaxLocal
from nakama_tpu.matchmaker import MatchmakerPresence as JaxPresence
from nakama_tpu.matchmaker.tpu import TpuBackend
from nakama_tpu_torch import devobs, logger, tracing
from nakama_tpu_torch.config import (
    DevObsConfig,
    MatchmakerConfig,
    TracingConfig,
    apply_observability,
)
from nakama_tpu_torch.logger import test_logger as quiet_logger
from nakama_tpu_torch.matchmaker import LocalMatchmaker, MatchmakerPresence
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from test_torch_slice import add_ticket, ticket_stream

BLOCKS = dict(row_block=8, col_block=64, big_row_block=64, big_col_block=64)


@pytest.fixture(autouse=True)
def _clean_stores():
    salts = (tracing._SAMPLE_SALT, jtracing._SAMPLE_SALT)
    for mod in (tracing, jtracing):
        mod.TRACES.reset()
    devobs.DEVOBS.reset()
    yield
    for mod in (tracing, jtracing):
        mod.TRACES.reset()
    devobs.DEVOBS.reset()
    tracing._SAMPLE_SALT, jtracing._SAMPLE_SALT = salts


def test_ledger_and_traceparent_match_jax():
    for mod in (tracing, jtracing):
        led = mod.Ledger(capacity=4)
        for i in range(10):
            led.append({"i": i})
        assert (len(led), led.total) == (4, 10)
        assert [e["i"] for e in led.recent(3)] == [7, 8, 9]
    tid, sid = "ab" * 16, "cd" * 8
    tp = tracing.format_traceparent(tid, sid)
    assert tp == jtracing.format_traceparent(tid, sid)
    assert tracing.parse_traceparent(tp) == jtracing.parse_traceparent(tp)
    for bad in ("", "00-xyz", f"00-{'0' * 32}-{sid}-01", f"00-{tid}-{sid}-zz"):
        for mod in (tracing, jtracing):
            with pytest.raises(ValueError):
                mod.parse_traceparent(bad)


def _traces(mod, ids):
    """One root span per trace id (ids via traceparent): every 5th an
    error, every 7th slow; returns the kept (id, reason) pairs."""
    mod.TRACES.configure(sample_rate=0.3, slow_ms=50.0, sample_salt="shared")
    for i, tid in enumerate(ids):
        try:
            with mod.root_span("req", traceparent=f"00-{tid}-{'1' * 16}-01") as sp:
                if i % 7 == 0:
                    sp._pc0 -= 1.0  # a slow root: extent >= slow_ms
                if i % 5 == 0:
                    raise RuntimeError("boom")
        except RuntimeError:
            pass
    return sorted((r["trace_id"], r["reason"]) for r in mod.TRACES.list(500))


def test_tail_sampling_decisions_by_trace_id_match_jax():
    rng = np.random.default_rng(0)
    ids = [f"{int(x):032x}" for x in rng.integers(1, 2**62, 200)]
    got, want = _traces(tracing, ids), _traces(jtracing, ids)
    assert got == want
    reasons = {r for _, r in got}
    assert reasons == {"error", "slow", "sampled"}
    for tid in ids[:50]:
        assert tracing.TraceStore._p_sample(tid, 0.3) == (
            jtracing.TraceStore._p_sample(tid, 0.3)
        )


def test_emit_matched_spans_stage_chain_matches_jax():
    entry = {
        "dispatched_ts": 1000.0, "ready_lag_s": 0.2, "fetch_lag_s": 0.1,
        "collect_lag_s": 0.25, "publish_lag_s": 0.3, "slipped": True,
        "trace_id": "ee" * 16,
    }
    chains = []
    for mod in (tracing, jtracing):
        mod.TRACES.configure(sample_rate=1.0)
        with mod.root_span("socket.add", traceparent=f"00-{'aa' * 16}-{'2' * 16}-01") as sp:
            mod.TRACES.hold(sp.trace_id)
            ctx = (sp.trace_id, sp.span_id)
        mod.emit_matched_spans(ctx, dict(entry))
        rec = mod.TRACES.get("aa" * 16)
        spans = rec["resourceSpans"][0]["scopeSpans"][0]["spans"]
        # The umbrella span ends "now"; the stage spans are fixed lags.
        chains.append(sorted(
            (s["name"],
             None if s["name"] == "matchmaker.matched" else s["durationMs"],
             bool(s.get("links")), s.get("attributes", {}).get("slipped"))
            for s in spans if s["name"] != "socket.add"
        ))
    assert chains[0] == chains[1]
    assert [c[0] for c in chains[0]] == [
        "matchmaker.collected", "matchmaker.dispatch_to_ready",
        "matchmaker.matched", "matchmaker.published",
    ]


def test_slo_burn_and_delivery_stage_stats_match_jax():
    rates, stats = [], []
    for mod in (tracing, jtracing):
        slo = mod.SloRecorder({"interval": {"target": 0.9, "threshold_ms": 100}})
        for v in (50, 150, 80, 300, 20, 99, 101):
            slo.observe("interval", v)
        rates.append(slo.burn_rates())
        tr = mod.Tracing()
        for lag in (0.1, 0.3, 0.2, 0.5):
            tr.record_delivery(ready_lag_s=lag, collect_lag_s=lag + 0.01,
                               _pc_dispatch=10.0)
        tr.mark_published(11.0, max_n=2)
        stats.append((tr.delivery_stage_stats(), tr.slip_count()))
    assert rates[0] == rates[1]
    assert stats[0] == stats[1]


def test_kernel_clock_percentiles_match_jax():
    rng = np.random.default_rng(3)
    durs = rng.exponential(0.004, 300).tolist()
    ours, theirs = devobs._KernelClock("k"), jdevobs._KernelClock("k")
    for d in durs:
        ours.record(d)
        theirs.record(d)
    a, b = ours.stats(), theirs.stats()
    for key in b:
        assert a[key] == b[key], key
    # The device ring uses the same nearest-rank math.
    for d in durs:
        ours.record_device(d)
    dev = ours.stats()
    assert (dev["device_p50_ms"], dev["device_p99_ms"]) == (
        a["p50_ms"], a["p99_ms"]
    )


class _Event:
    """A CUDA-event stand-in: completes when the test says so."""

    def __init__(self, t_ms, done):
        self.t_ms, self.done = t_ms, done

    def query(self):
        return self.done[0]

    def elapsed_time(self, other):
        if not (self.done[0] and other.done[0]):
            raise RuntimeError("event not ready")  # what CUDA would say
        return other.t_ms - self.t_ms


def test_device_clock_resolves_only_completed_events():
    """A call's device time is folded in only once both of its events
    have completed; resolve() never waits for them."""
    plane = devobs.DEVOBS
    with plane.device_call("matchmaker.score"):
        pass  # a CPU call: host clock only
    done = [False]
    clock = plane.register("matchmaker.score")
    event = plane.timeline[-1]
    plane._pending.append((clock, event, _Event(1.0, done), _Event(4.5, done)))
    assert plane.resolve() == 0 and event[3] is None
    assert plane.stats()["pending_device_events"] == 1
    done[0] = True
    plane.interval_tick()  # the interval path resolves lazily
    assert event[3] == 3.5
    stats = {k["kernel"]: k for k in plane.kernel_stats()}["matchmaker.score"]
    assert stats["calls"] == 1 and stats["device_calls"] == 1
    assert stats["device_p50_ms"] == 3.5
    t0 = event[1]
    (row,) = plane.timeline_between(t0 - 1, t0 + 1)
    assert row["device_ms"] == 3.5 and row["kernel"] == "matchmaker.score"


def test_build_watch_counts_builds_and_flags_hot_path_rebuilds():
    plane = devobs.DEVOBS
    plane.configure(warmup_intervals=1)
    plane.on_compile(2.0, kernel="stage1_wgmma")  # explicit build step
    plane.interval_tick()  # warm
    plane.on_compile(1.0, kernel="native")  # outside any device call
    assert plane.recompiles_total == 0
    with plane.device_call("matchmaker.score"):
        plane.on_compile(3.0, kernel="stage1_wgmma")  # a hot-path build
    with plane.device_call("matchmaker.score", expect_compile=True):
        plane.on_compile(3.0, kernel="stage1_wgmma")
    by = {k["kernel"]: k for k in plane.kernel_stats()}
    assert by["stage1_wgmma"]["compiles"] == 3
    assert by["stage1_wgmma"]["recompiles"] == 1
    assert plane.stats()["compiles"] == {"total": 4, "recompiles_total": 1}
    assert any("stage1_wgmma" in line for line in plane.report_lines())


def test_hbm_ledger_and_transfers_follow_the_pool_and_cohorts():
    cfg = MatchmakerConfig(
        pool_capacity=2048, candidates_per_ticket=32, big_pool_threshold=64,
        numeric_fields=8, string_fields=8, max_constraints=8,
    )
    backend = CudaBackend(cfg, quiet_logger(), device="cpu", **BLOCKS)
    mm = LocalMatchmaker(quiet_logger(), cfg, backend=backend)
    pool_bytes = sum(
        t.numel() * t.element_size() for t in backend.pool.tensors.values()
    )
    assert devobs.DEVOBS.memory_by_owner() == {"matchmaker.pool": pool_bytes}
    rng = np.random.default_rng(2)
    for spec in ticket_stream(rng, 100, "1v1", 0):
        add_ticket(mm, spec, MatchmakerPresence)
    mm.process()
    mm.backend.wait_idle(30)
    assert mm.collect_pipelined()
    # The cohort's candidate tensors were released at their fetch.
    assert devobs.DEVOBS.memory_by_owner() == {"matchmaker.pool": pool_bytes}
    assert devobs.DEVOBS.memory_high_water > pool_bytes
    sites = {(t["site"], t["direction"]) for t in devobs.DEVOBS.stats()["transfers"]}
    assert {("pool.flush", "h2d"), ("cohort.fetch", "d2h")} <= sites
    kernels = {k["kernel"] for k in devobs.DEVOBS.kernel_stats()}
    assert {
        "matchmaker.scatter", "matchmaker.score", "matchmaker.encode",
        "matchmaker.stage1", "matchmaker.stage2", "matchmaker.assign",
        "matchmaker.fetch",
    } <= kernels
    (entry,) = mm.backend.tracing.recent_deliveries(1)
    phases = {p["kernel"] for p in entry["device_timeline"]}
    assert {"matchmaker.stage1", "matchmaker.fetch"} <= phases
    mm.stop()


def test_busy_share_is_the_union_of_device_work_in_the_window():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "win", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 90, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 105, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 150, "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "d", "ts": 155, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "e", "ts": 195, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "f", "ts": 300, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "g", "ts": 120, "dur": 50},
    ]}
    out = tracing.busy_share(trace, "win")
    # [100,115) + [150,165) + [195,200): 35 of 100 us.
    assert out == {
        "window_us": 100.0, "busy_us": 35.0, "busy_share": 0.35,
        "device_events": 6,
    }
    with pytest.raises(ValueError):
        tracing.busy_share(trace, "missing")


def test_device_trace_writes_a_chrome_trace_with_its_window(tmp_path):
    import torch

    tr = tracing.Tracing()
    with tr.device_trace(str(tmp_path), name="capture"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tr.last_device_trace) as f:
        trace = json.load(f)
    out = tracing.busy_share(trace, "capture")
    assert out["window_us"] > 0 and out["device_events"] == 0  # no card


def test_log_lines_carry_trace_ids_and_node():
    buf = io.StringIO()
    log = logger.Logger(stream=buf)
    try:
        logger.set_node_name("node-a")
        with tracing.root_span("req") as sp:
            log.info("inside", trace_id_hint=1)
        log.info("outside")
    finally:
        logger.set_node_name("")
    inside, outside = (json.loads(line) for line in buf.getvalue().splitlines())
    assert (inside["trace_id"], inside["span_id"]) == (sp.trace_id, sp.span_id)
    assert inside["node"] == outside["node"] == "node-a"
    assert "trace_id" not in outside


def test_ticket_traces_held_until_matched_like_jax():
    """A ticket added inside a trace holds it open; once its cohort is
    delivered the trace closes with the add span and the cohort's stage
    spans — the same span names in both packages."""
    names = []
    for jax in (True, False):
        mod = jtracing if jax else tracing
        mod.TRACES.configure(sample_rate=1.0)
        common = dict(
            pool_capacity=2048, candidates_per_ticket=32, numeric_fields=8,
            string_fields=8, max_constraints=8,
        )
        if jax:
            cfg = JaxConfig(**common)
            mm = JaxLocal(jax_quiet_logger(), cfg,
                          backend=TpuBackend(cfg, jax_quiet_logger(), **BLOCKS))
        else:
            cfg = MatchmakerConfig(**common)
            mm = LocalMatchmaker(
                quiet_logger(), cfg,
                backend=CudaBackend(cfg, quiet_logger(), device="cpu", **BLOCKS),
            )
        mm.on_matched = lambda b: None
        presence = JaxPresence if jax else MatchmakerPresence
        specs = ticket_stream(np.random.default_rng(5), 2, "1v1", 0)
        for spec in specs:
            spec["query"] = "*"
        with mod.root_span("socket.add", traceparent=f"00-{'bb' * 16}-{'3' * 16}-01"):
            add_ticket(mm, specs[0], presence)
        add_ticket(mm, specs[1], presence)
        assert mod.TRACES.get("bb" * 16) is None  # held open
        mm.process()
        mm.backend.wait_idle(30)
        mm.collect_pipelined()
        rec = mod.TRACES.get("bb" * 16)
        spans = rec["resourceSpans"][0]["scopeSpans"][0]["spans"]
        names.append(sorted(s["name"] for s in spans))
        mm.stop()
    assert names[0] == names[1]
    assert "matchmaker.add" in names[0] and "matchmaker.published" in names[0]


def test_apply_observability_configures_the_planes():
    slo = apply_observability(
        TracingConfig(sample_rate=0.5, slow_trace_ms=7, capacity=9),
        DevObsConfig(warmup_intervals=5, timeline_depth=32),
    )
    assert (tracing.TRACES.sample_rate, tracing.TRACES.slow_ms) == (0.5, 7.0)
    assert tracing.TRACES.capacity == 9
    assert devobs.DEVOBS.warmup_intervals == 5
    assert devobs.DEVOBS.timeline.maxlen == 32
    assert set(slo.slos) == {
        "api_latency", "matchmaker_interval", "delivery_publish"}
    assert apply_observability(TracingConfig(enabled=False)) is None

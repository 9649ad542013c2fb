"""The port's metrics registry held against the JAX package's.

The JAX package exposes its metrics through `prometheus_client`; the
port renders the same exposition itself. Checked here: every metric of
the port's `Metrics` has the name, type and label names of the JAX
package's golden contract (`tests/test_logger_metrics.py`); after the
same calls, both scrapes parse to the same samples; both `snapshot()`s
hold the same keys and values.

Stated rule for the comparison: prometheus_client adds one `_created`
series (a creation timestamp) per series; the port emits none, so the
parsed JAX scrape drops every `_created` family before the comparison.
The one HELP text that differs (the device-time histogram's, which names
a TPU in the JAX package) is compared apart.

Also here: the audit that every `metrics.<name>` the port's code
records under exists in the port's registry, and one service loop of
the port run with a live `Metrics`.
"""

from __future__ import annotations

import asyncio
import os
import re
import threading

import numpy as np
import pytest

from nakama_tpu.metrics import Metrics as JaxMetrics
from nakama_tpu_torch import metrics as tmetrics
from nakama_tpu_torch.config import MatchmakerConfig
from nakama_tpu_torch.logger import test_logger as quiet_logger
from nakama_tpu_torch.matchmaker import LocalMatchmaker, MatchmakerPresence
from nakama_tpu_torch.matchmaker.cuda import CudaBackend
from nakama_tpu_torch.metrics import Counter, Gauge, Histogram, Metrics
from test_logger_metrics import GOLDEN_EXPOSITION

PORT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "nakama_tpu_torch",
)
_SAMPLE = re.compile(r"^([a-zA-Z_:][\w:]*)(\{.*\})? (\S+)$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse(text: bytes) -> tuple[dict, dict, list]:
    """A text exposition as (types, help, samples): samples are
    (name, sorted labels, value) in order; `_created` families dropped."""
    types, helps, samples = {}, {}, []
    skip = False
    for line in text.decode().splitlines():
        if line.startswith("# HELP "):
            name, _, doc = line[7:].partition(" ")
            skip = name.endswith("_created")
            if not skip:
                helps[name] = doc
        elif line.startswith("# TYPE "):
            name, _, kind = line[7:].partition(" ")
            if not skip:
                types[name] = kind
        elif not skip:
            m = _SAMPLE.match(line)
            assert m, line
            labels = tuple(sorted(_LABEL.findall(m.group(2) or "")))
            samples.append((m.group(1), labels, float(m.group(3))))
    return types, helps, samples


def drive_basic(m):
    m.mm_tickets.set(42)
    m.mm_active_tickets.set(7)
    m.mm_matched.inc(3)
    m.mm_process_time.observe(0.0123)
    m.mm_process_time.observe(2.6)
    m.db_group_commits.inc()
    m.db_write_batch_size.observe(5)
    m.db_write_batch_size.observe(512)
    m.gauge_set("big", 1e10)


def drive_labels(m):
    m.api_time.labels(rpc="x").observe(0.003)
    m.api_time.labels("y").observe(11.0)
    m.api_count.labels(rpc='a"b\\c\nd', code="0").inc()
    m.mm_delivery_wakeups.labels(cause="event").inc(2)
    m.mm_delivery_wakeups.labels(cause="watchdog").inc()
    m.mm_journal_records.labels(op="add").inc(1000)
    m.mm_checkpoints.labels(outcome="ok").inc()
    m.requests_shed.labels(**{"class": "list", "reason": "shed"}).inc()
    m.overload_state.set(2)
    m.device_memory.labels(owner="matchmaker.pool").set(149_934_080)
    m.faults_injected.labels(point="journal.append", mode="drop").inc()
    m.mm_backend_state.set(1)
    m.mm_backend_state.inc(-1)
    m.admission_inflight.inc(3)


def drive_custom(m):
    m.counter_add("my_events", 2, kind="a")
    m.counter_add("my_events", 1.5, kind="b")
    m.gauge_set("depth", -3.25)
    m.timer_record("op", 0.2, stage="x")
    m.timer_record("op", 0.0, stage="x")
    m.mm_delivery_lag.observe(0.3)
    m.mm_delivery_publish_lag.observe(61)


SCRIPTS = {"basic": drive_basic, "labels": drive_labels, "custom": drive_custom}


def test_registry_matches_the_golden_exposition():
    m = Metrics()
    found = {
        (v._name, type(v).__name__, tuple(v._labelnames))
        for v in vars(m).values()
        if isinstance(v, (Counter, Gauge, Histogram))
    }
    assert found == GOLDEN_EXPOSITION


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_parsed_scrapes_agree_after_the_same_calls(script):
    j, t = JaxMetrics(), Metrics()
    SCRIPTS[script](j)
    SCRIPTS[script](t)
    jt, jh, js = parse(j.scrape())
    tt, th, ts = parse(t.scrape())
    assert tt == jt
    assert ts == js
    differ = {k for k in jh if jh[k] != th.get(k)}
    assert differ == {"nakama_matchmaker_device_time_sec"}
    assert "TPU" not in th["nakama_matchmaker_device_time_sec"]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_snapshots_agree(script):
    j, t = JaxMetrics(), Metrics()
    SCRIPTS[script](j)
    SCRIPTS[script](t)
    assert t.snapshot() == j.snapshot()


def test_exposition_text_format():
    m = Metrics()
    m.mm_tickets.set(42)
    m.counter_add("my_events", kind="a")
    m.timer_record("op", 0.2)
    text = m.scrape().decode()
    assert "\nnakama_matchmaker_tickets 42.0\n" in text
    assert "# TYPE nakama_matchmaker_matched_total counter\n" in text
    assert 'nakama_custom_timer_op_bucket{le="+Inf"} 1.0\n' in text
    assert "\nnakama_custom_timer_op_count 1.0\n" in text
    assert "_created" not in text
    snap = m.snapshot()
    assert snap["nakama_custom_counter_my_events_total{kind=a}"] == 1.0
    assert tmetrics.float_to_go_string(1e10) == "1e+010"
    assert tmetrics.float_to_go_string(float("inf")) == "+Inf"


def test_label_misuse_raises_in_both_packages():
    for m in (JaxMetrics(), Metrics()):
        with pytest.raises(ValueError):
            m.api_time.observe(1.0)  # labeled metric without labels()
        with pytest.raises(ValueError):
            m.api_time.labels(nope="x")
        m.counter_add("ev", kind="a")
        with pytest.raises(ValueError):
            m.counter_add("ev", other="b")
        with pytest.raises(ValueError):
            m.mm_matched.inc(-1)


def test_concurrent_recording_loses_no_update():
    """Worker threads and the event loop record at once: every
    increment and observation lands."""
    import sys

    m = Metrics()
    n, per = 16, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            child = m.mm_delivery_wakeups.labels(cause=f"c{i % 3}")
            for _ in range(per):
                m.mm_matched.inc()
                child.inc()
                m.mm_process_time.observe(0.01)
                m.counter_add("ev", kind=f"k{i % 2}")

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = m.snapshot()
    assert snap["nakama_matchmaker_matched_total"] == n * per
    assert snap["nakama_matchmaker_process_time_sec_count"] == n * per
    assert sum(
        v for k, v in snap.items()
        if k.startswith("nakama_matchmaker_delivery_wakeups_total")
    ) == n * per
    assert sum(
        v for k, v in snap.items() if k.startswith("nakama_custom_counter_ev")
    ) == n * per


def referenced_metric_names() -> set[str]:
    """Every `<metrics sink>.<name>` the port's code records under: the
    `metrics` / `_metrics` attributes, and devobs' local `m` alias."""
    names = set()
    for root, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py") or f == "metrics.py":
                continue
            src = open(os.path.join(root, f)).read()
            names.update(re.findall(r"\b_?metrics\.([a-z_][a-z0-9_]*)", src))
            if "m = self.metrics" in src:
                names.update(re.findall(
                    r"\bm\.([a-z_][a-z0-9_]*)\.(?:labels|set|inc|observe)\(",
                    src,
                ))
    return names


def test_every_metric_the_port_records_exists():
    names = referenced_metric_names()
    # The audit reads the names the matchmaker, storage, recovery,
    # overload, fault, tracing and telemetry planes use.
    assert {
        "mm_gap_shed", "mm_delivery_wakeups", "mm_delivery_publish_lag",
        "request_deadline_exceeded", "mm_journal_records",
        "db_group_commits", "overload_state", "faults_injected",
        "device_memory", "slo_burn_rate", "counter_add",
    } <= names
    m = Metrics()
    missing = sorted(n for n in names if not hasattr(m, n))
    assert not missing, missing


def test_service_loop_records_into_a_live_registry():
    """`start()`'s interval loop and delivery stage on the CPU with a
    live `Metrics`: every metric call of the loop, the delivery stage,
    the backend and the add path goes to a real series."""
    cfg = MatchmakerConfig(
        pool_capacity=256, numeric_fields=8, string_fields=8,
        max_constraints=8, big_pool_threshold=64, interval_pipelining=True,
        interval_sec=0.3, pipeline_deadline_guard_sec=0.1,
    )
    m = Metrics()
    backend = CudaBackend(
        cfg, quiet_logger(), m, device="cpu", col_block=64,
        big_row_block=64, big_col_block=64,
    )
    got = []
    mm = LocalMatchmaker(
        quiet_logger(), cfg, metrics=m, backend=backend, on_matched=got.append
    )
    rng = np.random.default_rng(3)

    def add(i):
        p = MatchmakerPresence(user_id=f"u{i}", session_id=f"s{i}")
        r = float(rng.integers(0, 100))
        mm.add([p], p.session_id, "", f"+properties.rank:>={r - 30}"
               f" +properties.rank:<={r + 30}", 2, 2, 1, {}, {"rank": r})

    async def serve():
        mm.start()
        try:
            # Two waves, each dispatched by the loop and delivered by
            # the delivery stage.
            for wave in range(2):
                for i in range(60 * wave, 60 * (wave + 1)):
                    add(i)
                t_end = asyncio.get_running_loop().time() + 20
                while (
                    backend._dispatch_counter <= wave
                    or backend.pipeline_depth()
                ):
                    assert asyncio.get_running_loop().time() < t_end
                    await asyncio.sleep(0.02)
        finally:
            mm.stop()

    asyncio.run(serve())
    snap = m.snapshot()
    matched = sum(b.entry_count for b in got)
    assert matched > 0
    assert snap["nakama_matchmaker_matched_total"] == matched
    assert snap["nakama_matchmaker_process_time_sec_count"] >= 2
    assert snap["nakama_matchmaker_tickets"] == len(mm)
    assert sum(
        v for k, v in snap.items()
        if k.startswith("nakama_matchmaker_delivery_wakeups_total")
    ) >= 1
    assert snap["nakama_matchmaker_delivery_publish_lag_sec_count"] >= 1
    assert snap["nakama_matchmaker_backend_state"] == 0

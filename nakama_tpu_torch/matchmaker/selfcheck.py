"""Device-executed correctness assertions.

`run_chip_selfcheck()` runs the device paths of `CudaBackend` on the card
and asserts:

- small-pool exact scan: match-for-match parity with the CPU oracle,
- two-stage scan (stage-1 kernel) + native assembler: every formed match
  exactly valid with coverage no worse than the oracle's,
- device pairing, synchronous and pipelined: validity + coverage.

The CPU tests hold the same paths against the JAX package with the plain
PyTorch versions; this module is how a run on the card asserts the
hand-written kernels inside the real interval.
"""

from __future__ import annotations

import numpy as np

from ..config import MatchmakerConfig
from ..logger import test_logger
from .cuda import CudaBackend
from .local import CpuBackend, LocalMatchmaker
from .types import MatchmakerPresence


def _specs(rng, n):
    out = []
    for _ in range(n):
        mode = int(rng.integers(0, 3))
        rank = int(rng.integers(0, 100))
        out.append(
            dict(
                query=(
                    f"+properties.mode:m{mode}"
                    f" +properties.rank:>={max(0, rank - 25)}"
                    f" +properties.rank:<={rank + 25}"
                ),
                strs={"mode": f"m{mode}"},
                nums={"rank": float(rank)},
            )
        )
    return out


def _run(mm, specs, intervals):
    matched = []
    mm.on_matched = matched.append
    for i, s in enumerate(specs):
        p = MatchmakerPresence(user_id=f"u{i}", session_id=f"s{i}")
        mm.add(
            [p], p.session_id, "", s["query"], 2, 2, 1, s["strs"],
            s["nums"],
        )
    for _ in range(intervals):
        mm.process()
    wait = getattr(mm.backend, "wait_idle", None)
    if wait:
        wait(30)
        mm.process()  # collect any pipelined tail
    mm.stop()
    return matched


def _validate(matched, specs, label):
    total = 0
    for batch in matched:
        for entry_set in batch:
            assert len(entry_set) == 2, (label, "match size")
            a, b = entry_set
            ia = int(a.presence.user_id[1:])
            ib = int(b.presence.user_id[1:])
            assert a.presence.session_id != b.presence.session_id, label
            for x, y in ((ia, ib), (ib, ia)):
                sx, sy = specs[x], specs[y]
                assert sx["strs"]["mode"] == sy["strs"]["mode"], (
                    label, "mode", ia, ib,
                )
                lo = int(sx["query"].split(">=")[1].split(" ")[0])
                hi = int(sx["query"].split("<=")[1].split(" ")[0])
                assert lo <= sy["nums"]["rank"] <= hi, (label, ia, ib)
            total += 2
    return total


def _pairs(matched):
    return sorted(
        tuple(sorted(e.presence.user_id for e in s))
        for batch in matched
        for s in batch
    )


def run_chip_selfcheck(log=print, device="cuda:0") -> dict:
    """Run the device-path parity checks on `device`. Raises
    AssertionError on any violation; returns a summary dict."""
    results = {}

    def backend(cfg, **blocks):
        return CudaBackend(cfg, test_logger(), device=device, **blocks)

    def cpu_matches(specs, intervals=2):
        mm = LocalMatchmaker(
            test_logger(),
            MatchmakerConfig(max_intervals=2, backend="cpu"),
            backend=CpuBackend(),
        )
        return _run(mm, specs, intervals)

    # 1. Small-pool exact scan: match-for-match oracle parity
    # (synchronous intervals — parity needs same-interval delivery).
    rng = np.random.default_rng(7)
    specs = _specs(rng, 96)
    cpu = cpu_matches(specs)
    cfg = MatchmakerConfig(
        pool_capacity=256, candidates_per_ticket=256, numeric_fields=8,
        string_fields=8, max_constraints=8, max_intervals=2,
        interval_pipelining=False,
    )
    mm = LocalMatchmaker(test_logger(), cfg, backend=backend(cfg))
    dev = _run(mm, specs, 2)
    assert _pairs(dev) == _pairs(cpu), "small scan != oracle"
    results["small_exact_parity"] = len(_pairs(dev))
    log(f"selfcheck small scan: {results['small_exact_parity']} matches,"
        " exact oracle parity")

    # 2. Two-stage scan + native assembler: exact validity + oracle
    # coverage (device_pairing off pins the assembler path).
    rng = np.random.default_rng(11)
    specs = _specs(rng, 600)
    cpu_total = _validate(cpu_matches(specs), specs, "oracle")
    big = dict(big_row_block=256, big_col_block=256)
    cfg = MatchmakerConfig(
        pool_capacity=1024, candidates_per_ticket=64, numeric_fields=8,
        string_fields=8, max_constraints=8, max_intervals=2,
        big_pool_threshold=256, interval_pipelining=True,
        device_pairing=False,
    )
    mm = LocalMatchmaker(test_logger(), cfg, backend=backend(cfg, **big))
    dev = _run(mm, specs, 3)
    dev_total = _validate(dev, specs, "big")
    assert dev_total >= cpu_total - 4, (dev_total, cpu_total)
    results["big_valid_entries"] = dev_total
    log(f"selfcheck two-stage scan: {dev_total} valid entries"
        f" (oracle {cpu_total})")

    # 3. Device pairing (sync 1v1): validity + coverage.
    cfg = MatchmakerConfig(
        pool_capacity=1024, candidates_per_ticket=64, numeric_fields=8,
        string_fields=8, max_constraints=8, max_intervals=2,
        big_pool_threshold=256, interval_pipelining=False,
        device_pairing=True,
    )
    mm = LocalMatchmaker(test_logger(), cfg, backend=backend(cfg, **big))
    dev = _run(mm, specs, 2)
    pair_total = _validate(dev, specs, "pairs")
    assert pair_total >= cpu_total - 8, (pair_total, cpu_total)
    results["pairing_valid_entries"] = pair_total
    log(f"selfcheck device pairing: {pair_total} valid entries"
        f" (oracle {cpu_total})")

    # 4. Device pairing under pipelined intervals (the shipped default):
    # validity + coverage through the queued dispatch→collect flow.
    cfg = MatchmakerConfig(
        pool_capacity=1024, candidates_per_ticket=64, numeric_fields=8,
        string_fields=8, max_constraints=8, max_intervals=2,
        big_pool_threshold=256, interval_pipelining=True,
        device_pairing=True,
    )
    mm = LocalMatchmaker(test_logger(), cfg, backend=backend(cfg, **big))
    dev = _run(mm, specs, 3)
    pipe_total = _validate(dev, specs, "pairs-pipelined")
    assert pipe_total >= cpu_total - 8, (pipe_total, cpu_total)
    results["pairing_pipelined_valid_entries"] = pipe_total
    log(f"selfcheck pipelined device pairing: {pipe_total} valid entries"
        f" (oracle {cpu_total})")
    return results

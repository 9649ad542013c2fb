"""The port survives a SIGKILL: one leg of `chip_smoke.py`'s crash phase
on the CPU.

A child process (`chip_smoke.py --crash-child`, importing only the
port) serves a 256-ticket pool through `LocalMatchmaker.start()` with the
ticket journal and the checkpointer over a file database, on
`CudaBackend(device="cpu")`. It prints `ACKED` once its tickets are
journal-durable and `MATCHED` per published cohort; it is SIGKILLed
after its first match, a fresh child recovers from the files and runs
intervals to quiescence. Every acknowledged ticket must be matched
exactly once or back in the pool. The crash gate the phase prints is
held against the JAX package's (`bench.py`).
"""

from __future__ import annotations

import bench
import chip_smoke


def test_sigkill_leg_loses_no_acknowledged_ticket():
    leg = chip_smoke.crash_leg(
        "baseline", {}, True, device="cpu", tickets=256, kill_delay_s=1.0,
        timeout_s=120,
    )
    assert leg["survived"], leg.get("error")
    assert leg["acked"] == 256 and leg["observed_matched_precrash"] > 0
    assert leg["loss"] == 0, leg.get("lost_sample")
    assert leg["double"] == 0, leg.get("double_sample")
    assert leg["post_matched_twice"] == 0
    # The 32 tickets nobody can match are all back in the pool.
    assert leg["recovered_pool"] >= 256 // 8
    assert leg["breaker"] == {"state": "closed", "failures": 0, "opens": 0}


def test_crash_gate_is_the_jax_packages():
    cases = [
        (0, 0, 3, 3, 1.2, 0.02), (3, 0, 3, 3, 1.2, 0.02),
        (0, 1, 3, 3, 1.2, 0.02), (0, 0, 2, 3, 1.2, 0.02),
        (0, 0, 3, 3, 2.0, 0.02), (0, 0, 3, 3, 1.2, 1.0),
        (1, 2, 1, 3, 9.0, 5.0),
    ]
    for case in cases:
        assert chip_smoke.crash_recovery_regression(*case) == (
            bench.crash_recovery_regression(*case)
        )
    assert chip_smoke.CRASH_RECOVERY_BUDGET_S == bench.CRASH_RECOVERY_BUDGET_S
    assert chip_smoke.CRASH_INTERVAL_BUDGET_MS == bench.CRASH_INTERVAL_BUDGET_MS

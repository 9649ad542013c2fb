"""Matchmaker configuration of the PyTorch/CUDA port.

Field names and defaults follow the JAX package's `MatchmakerConfig`
(reference defaults: server/config.go:971-989), less the knobs of
subsystems this port does not carry yet (mesh sharding, the backend
circuit breaker, the delivery stage's deadlines and watchdog, the async
interval loop's cadence).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MatchmakerConfig:
    max_tickets: int = 3
    max_intervals: int = 2
    rev_precision: bool = False
    # "cuda": CudaBackend on cuda:0 (raises without a CUDA device);
    # "cpu": the exact host oracle (CpuBackend).
    backend: str = "cuda"
    pool_capacity: int = 131_072
    max_constraints: int = 16  # query constraint slots compiled per ticket
    candidates_per_ticket: int = 64  # device top-K candidate width
    numeric_fields: int = 24
    string_fields: int = 16
    max_party_size: int = 8
    embedding_dims: int = 16  # learned skill-embedding width
    # Pools whose scanned column extent reaches this switch from the exact
    # blockwise top-K scan to the two-stage kernel (device2.py).
    big_pool_threshold: int = 32_768
    emb_score_scale: float = 256.0  # stage-1 embedding-score quantisation
    # Pipelined intervals (the shipped default): process() dispatches the
    # current interval's device pass and collects completed earlier ones,
    # so the device pass and its host tail leave the interval's critical
    # path. False = synchronous reference semantics (same-interval
    # delivery).
    interval_pipelining: bool = True
    # Device-side 1v1 pair assignment (device2.pair_partners) when every
    # live ticket is a solo 1v1; only the partner vector crosses D2H.
    device_pairing: bool = True
    # Per-interval cap on host-only actives run through the CPU oracle
    # fallback (queries the device kernels cannot express); overflow
    # defers to the next interval, oldest first.
    host_budget_per_interval: int = 512

"""Device matchmaker (PyTorch/CUDA port).

The reference's per-interval CPU loop over an inverted ticket index
(reference server/matchmaker.go, server/matchmaker_process.go) re-designed
as: query→constraint-slot compilation, a device-resident ticket pool, a
blockwise pairwise-eligibility + top-K scan on the device, and a native C++
greedy assembler for the sequential combo formation.

Layers:
- `query`    — query-string parser + host evaluator (shared front end)
- `types`    — ticket/entry/extract data model
- `process`  — CPU oracle process loop (exact reference semantics)
- `local`    — LocalMatchmaker bookkeeping + per-interval processing
- `compile`  — query/properties → constraint-slot + feature tensors
- `store`    — slot-centric host ticket store
- `device`   — device pool buffer + the exact small-pool scan
- `device2`  — the two-stage large-pool scan (stage-1 kernel) + pairing
- `cuda`     — the CUDA ProcessBackend (device scan + native assembler)
"""

from .local import (
    CpuBackend,
    ErrDuplicateSession,
    ErrNotAvailable,
    ErrQueryInvalid,
    ErrTooManyTickets,
    LocalMatchmaker,
    MatchmakerError,
)
from .query import QueryError, evaluate, matches, parse_query
from .types import (
    MatchBatch,
    MatchmakerEntry,
    MatchmakerPresence,
    MatchmakerTicket,
)

__all__ = [
    "LocalMatchmaker",
    "CpuBackend",
    "MatchmakerError",
    "ErrTooManyTickets",
    "ErrQueryInvalid",
    "ErrDuplicateSession",
    "ErrNotAvailable",
    "QueryError",
    "parse_query",
    "evaluate",
    "matches",
    "MatchBatch",
    "MatchmakerEntry",
    "MatchmakerPresence",
    "MatchmakerTicket",
]

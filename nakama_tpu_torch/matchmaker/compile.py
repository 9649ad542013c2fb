"""Ticket → tensor compiler for the device matchmaker.

Lowers ticket properties and parsed queries (query.py AST) into fixed-shape
tensors evaluated pairwise on device. The key representation choice is
**per-field lowering** of the boolean (must / must-not) part of a query:

- every numeric field gets ONE allowed interval [lo, hi] — the intersection
  of all must-range clauses on that field — plus one forbidden interval for
  a must-not range;
- every string field gets ONE required hash and ONE forbidden hash;
- missing numeric values are the sentinel MISSING (3e38): constrained
  intervals are clamped to ±1e37 so a missing value always fails them, while
  the unconstrained default ±3.4e38 passes everything. (Documented domain
  limit: numeric property magnitudes must stay below 1e37.)

This makes the O(N²) eligibility kernel a gather-free broadcast
compare-and-reduce over [block, block, F] — a dense elementwise shape — instead of a per-query-slot walk (the reference evaluates a
parsed Bluge query per candidate, server/match_common.go:244).

`should` clauses (optional, scoring-only under constant-similarity — plus
the "no-must queries need ≥1 should" gate) keep a small slot form; must-only
queries score identically for every candidate, so their candidate order is
pure wait-time, matching the oracle's (-score, created_at) sort.

Queries that don't fit (regex/wildcard clauses, >1 must-not per field,
field-budget or slot-budget overflow) are flagged host-only: their own
searches run on the CPU oracle while their properties still live in the
device pool as candidates for everyone else.
"""

from __future__ import annotations

import hashlib
import zlib
from dataclasses import dataclass, field

import numpy as np

from .query import BooleanQuery, MatchAll, NumericEq, NumericRange, Term
from .types import MatchmakerTicket

# Should-slot op codes.
SOP_UNUSED = 0
SOP_ALL = 1
SOP_NUM_RANGE = 2
SOP_STR_EQ = 3

# Numeric domain encoding (see module docstring).
MISSING = np.float32(3.0e38)
CLAMP = np.float32(1.0e37)
FULL_LO = np.float32(-3.4e38)
FULL_HI = np.float32(3.4e38)

# Builtin fields present for every ticket.
BUILTIN_NUMERIC = ("min_count", "max_count", "created_at")
BUILTIN_STRING = ("party_id", "ticket")


def hash_str(value: str) -> int:
    """Stable 31-bit nonzero hash for string equality on device."""
    h = zlib.crc32(value.encode()) & 0x7FFFFFFF
    return h or 1


def hash64(value: str) -> int:
    """Stable 63-bit hash for session/party identity in the assembler."""
    d = hashlib.blake2b(value.encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") & 0x7FFF_FFFF_FFFF_FFFF


@dataclass
class FieldRegistry:
    """Maps property names to feature columns, separately for numeric and
    string values. Built-in ticket fields occupy the first columns."""

    numeric_capacity: int
    string_capacity: int
    numeric: dict[str, int] = field(default_factory=dict)
    string: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for name in BUILTIN_NUMERIC:
            self.numeric[name] = len(self.numeric)
        for name in BUILTIN_STRING:
            self.string[name] = len(self.string)

    def numeric_col(self, name: str) -> int | None:
        col = self.numeric.get(name)
        if col is None:
            if len(self.numeric) >= self.numeric_capacity:
                return None
            col = len(self.numeric)
            self.numeric[name] = col
        return col

    def string_col(self, name: str) -> int | None:
        col = self.string.get(name)
        if col is None:
            if len(self.string) >= self.string_capacity:
                return None
            col = len(self.string)
            self.string[name] = col
        return col


@dataclass
class CompiledQuery:
    """One ticket's query in device form."""

    # Per-numeric-field must intervals and one forbidden interval.
    n_lo: np.ndarray  # f32 [Fn]
    n_hi: np.ndarray  # f32 [Fn]
    n_flo: np.ndarray  # f32 [Fn] (forbidden; flo > fhi = none)
    n_fhi: np.ndarray  # f32 [Fn]
    # Per-string-field required / forbidden hashes (0 = none).
    s_req: np.ndarray  # i32 [Fs]
    s_forb: np.ndarray  # i32 [Fs]
    # Should slots (scoring + the no-must gate).
    sh_op: np.ndarray  # i32 [S]
    sh_fld: np.ndarray  # i32 [S]
    sh_lo: np.ndarray  # f32 [S]
    sh_hi: np.ndarray  # f32 [S]
    sh_term: np.ndarray  # i32 [S]
    sh_boost: np.ndarray  # f32 [S]
    has_must: bool
    has_should: bool
    never: bool  # contradictory query: matches nothing
    # Exact (f64 bounds, 63-bit hashes) mirror used by the vectorized host
    # validation of device-formed matches — immune to the f32 rounding and
    # 31-bit hash collisions the device tensors accept.
    n_lo64: np.ndarray | None = None  # f64 [Fn]
    n_hi64: np.ndarray | None = None
    n_flo64: np.ndarray | None = None
    n_fhi64: np.ndarray | None = None
    s_req64: np.ndarray | None = None  # i64 [Fs]
    s_forb64: np.ndarray | None = None
    sh_lo64: np.ndarray | None = None  # f64 [S]
    sh_hi64: np.ndarray | None = None
    sh_term64: np.ndarray | None = None  # i64 [S]


class HostOnlyQuery(Exception):
    """Raised when a query cannot be lowered to device form."""


def compile_features(
    ticket: MatchmakerTicket, registry: FieldRegistry
) -> tuple[np.ndarray, np.ndarray, bool]:
    """Compile a ticket's properties into (numeric f32 [Fn], string i32 [Fs],
    overflowed). Missing numerics are the MISSING sentinel. Overflow keeps
    excess properties off-device; tickets querying those fields become
    host-only, and device queries against them never match — same as a
    missing field."""
    num = np.full(registry.numeric_capacity, MISSING, dtype=np.float32)
    strs = np.zeros(registry.string_capacity, dtype=np.int32)
    overflow = False

    num[registry.numeric["min_count"]] = ticket.min_count
    num[registry.numeric["max_count"]] = ticket.max_count
    num[registry.numeric["created_at"]] = ticket.created_at
    if ticket.party_id:
        strs[registry.string["party_id"]] = hash_str(ticket.party_id)
    strs[registry.string["ticket"]] = hash_str(ticket.ticket)

    for name, value in ticket.numeric_properties.items():
        col = registry.numeric_col(f"properties.{name}")
        if col is None:
            overflow = True
            continue
        v = np.float32(value)
        if not np.isfinite(v) or abs(v) > CLAMP:
            v = MISSING  # out-of-domain values behave as missing
        num[col] = v
    for name, value in ticket.string_properties.items():
        col = registry.string_col(f"properties.{name}")
        if col is None:
            overflow = True
            continue
        strs[col] = hash_str(value)
    return num, strs, overflow


def exact_features(
    ticket: MatchmakerTicket, registry: FieldRegistry
) -> tuple[np.ndarray, np.ndarray]:
    """f64/63-bit-hash mirror of compile_features for host validation:
    (num64 f64 [Fn] with NaN = missing, str64 i64 [Fs] with 0 = unset)."""
    num = np.full(registry.numeric_capacity, np.nan, dtype=np.float64)
    strs = np.zeros(registry.string_capacity, dtype=np.int64)
    num[registry.numeric["min_count"]] = ticket.min_count
    num[registry.numeric["max_count"]] = ticket.max_count
    num[registry.numeric["created_at"]] = ticket.created_at
    if ticket.party_id:
        strs[registry.string["party_id"]] = hash64(ticket.party_id)
    strs[registry.string["ticket"]] = hash64(ticket.ticket)
    for name, value in ticket.numeric_properties.items():
        col = registry.numeric.get(f"properties.{name}")
        if col is not None:
            num[col] = float(value)
    for name, value in ticket.string_properties.items():
        col = registry.string.get(f"properties.{name}")
        if col is not None:
            strs[col] = hash64(value)
    return num, strs


def _range_bounds64(leaf) -> tuple[float, float]:
    """Exact f64 bounds with open endpoints nudged one ulp, matching the
    oracle evaluator's comparison semantics (query.py _leaf_match)."""
    if isinstance(leaf, NumericEq):
        # The oracle accepts |value - target| <= 1e-9 (query.py:283).
        v = float(leaf.value)
        return v - 1e-9, v + 1e-9
    lo, hi = float(leaf.lo), float(leaf.hi)
    if not leaf.incl_lo and np.isfinite(lo):
        lo = np.nextafter(lo, np.inf)
    if not leaf.incl_hi and np.isfinite(hi):
        hi = np.nextafter(hi, -np.inf)
    return lo, hi


def _range_bounds(leaf) -> tuple[np.float32, np.float32]:
    if isinstance(leaf, NumericEq):
        v = np.float32(leaf.value)
        return v, v
    lo = np.float32(leaf.lo) if np.isfinite(leaf.lo) else -CLAMP
    hi = np.float32(leaf.hi) if np.isfinite(leaf.hi) else CLAMP
    if not leaf.incl_lo and np.isfinite(leaf.lo):
        lo = np.nextafter(lo, np.float32(np.inf))
    if not leaf.incl_hi and np.isfinite(leaf.hi):
        hi = np.nextafter(hi, np.float32(-np.inf))
    return lo, hi


def compile_query(
    ticket: MatchmakerTicket, registry: FieldRegistry, should_slots: int
) -> CompiledQuery:
    """Lower a parsed query to device form; raises HostOnlyQuery when the
    query needs the host evaluator."""
    node = ticket.parsed_query
    fn = registry.numeric_capacity
    fs = registry.string_capacity
    c = CompiledQuery(
        n_lo=np.full(fn, FULL_LO, dtype=np.float32),
        n_hi=np.full(fn, FULL_HI, dtype=np.float32),
        n_flo=np.full(fn, 1.0, dtype=np.float32),
        n_fhi=np.full(fn, -1.0, dtype=np.float32),
        s_req=np.zeros(fs, dtype=np.int32),
        s_forb=np.zeros(fs, dtype=np.int32),
        sh_op=np.zeros(should_slots, dtype=np.int32),
        sh_fld=np.zeros(should_slots, dtype=np.int32),
        sh_lo=np.zeros(should_slots, dtype=np.float32),
        sh_hi=np.zeros(should_slots, dtype=np.float32),
        sh_term=np.zeros(should_slots, dtype=np.int32),
        sh_boost=np.zeros(should_slots, dtype=np.float32),
        has_must=False,
        has_should=False,
        never=False,
        n_lo64=np.full(fn, -np.inf),
        n_hi64=np.full(fn, np.inf),
        n_flo64=np.full(fn, 1.0),
        n_fhi64=np.full(fn, -1.0),
        s_req64=np.zeros(fs, dtype=np.int64),
        s_forb64=np.zeros(fs, dtype=np.int64),
        sh_lo64=np.zeros(should_slots),
        sh_hi64=np.zeros(should_slots),
        sh_term64=np.zeros(should_slots, dtype=np.int64),
    )

    if isinstance(node, MatchAll):
        return c
    if not isinstance(node, BooleanQuery):
        node = BooleanQuery(should=(node,))

    c.has_must = bool(node.must)
    c.has_should = bool(node.should)

    def clamp_range(col: int, lo: np.float32, hi: np.float32):
        # Intersect; clamped bounds exclude the MISSING sentinel.
        c.n_lo[col] = max(c.n_lo[col], max(lo, -CLAMP))
        c.n_hi[col] = min(c.n_hi[col], min(hi, CLAMP))

    for leaf in node.must:
        if isinstance(leaf, (NumericRange, NumericEq)):
            col = registry.numeric_col(leaf.field_name)
            if col is None:
                raise HostOnlyQuery(f"numeric field budget: {leaf.field_name}")
            lo, hi = _range_bounds(leaf)
            clamp_range(col, lo, hi)
            lo64, hi64 = _range_bounds64(leaf)
            c.n_lo64[col] = max(c.n_lo64[col], lo64)
            c.n_hi64[col] = min(c.n_hi64[col], hi64)
            if c.n_lo[col] > c.n_hi[col]:
                c.never = True
        elif isinstance(leaf, Term):
            col = registry.string_col(leaf.field_name)
            if col is None:
                raise HostOnlyQuery(f"string field budget: {leaf.field_name}")
            h = hash_str(leaf.value)
            if c.s_req[col] not in (0, h):
                c.never = True  # two different required values
            c.s_req[col] = h
            c.s_req64[col] = hash64(leaf.value)
        elif isinstance(leaf, MatchAll):
            pass
        else:
            raise HostOnlyQuery(f"must clause {type(leaf).__name__}")

    for leaf in node.must_not:
        if isinstance(leaf, (NumericRange, NumericEq)):
            col = registry.numeric_col(leaf.field_name)
            if col is None:
                raise HostOnlyQuery(f"numeric field budget: {leaf.field_name}")
            if c.n_flo[col] <= c.n_fhi[col]:
                raise HostOnlyQuery("two must-not ranges on one field")
            lo, hi = _range_bounds(leaf)
            c.n_flo[col] = lo
            c.n_fhi[col] = hi
            c.n_flo64[col], c.n_fhi64[col] = _range_bounds64(leaf)
        elif isinstance(leaf, Term):
            col = registry.string_col(leaf.field_name)
            if col is None:
                raise HostOnlyQuery(f"string field budget: {leaf.field_name}")
            h = hash_str(leaf.value)
            if c.s_forb[col] not in (0, h):
                raise HostOnlyQuery("two must-not terms on one field")
            c.s_forb[col] = h
            c.s_forb64[col] = hash64(leaf.value)
        elif isinstance(leaf, MatchAll):
            c.never = True
        else:
            raise HostOnlyQuery(f"must-not clause {type(leaf).__name__}")

    if len(node.should) > should_slots:
        raise HostOnlyQuery(f"{len(node.should)} should clauses > {should_slots}")
    for slot, leaf in enumerate(node.should):
        c.sh_boost[slot] = np.float32(getattr(leaf, "boost", 1.0))
        if isinstance(leaf, MatchAll):
            c.sh_op[slot] = SOP_ALL
        elif isinstance(leaf, (NumericRange, NumericEq)):
            col = registry.numeric_col(leaf.field_name)
            if col is None:
                raise HostOnlyQuery(f"numeric field budget: {leaf.field_name}")
            lo, hi = _range_bounds(leaf)
            c.sh_op[slot] = SOP_NUM_RANGE
            c.sh_fld[slot] = col
            c.sh_lo[slot] = max(lo, -CLAMP)
            c.sh_hi[slot] = min(hi, CLAMP)
            c.sh_lo64[slot], c.sh_hi64[slot] = _range_bounds64(leaf)
        elif isinstance(leaf, Term):
            col = registry.string_col(leaf.field_name)
            if col is None:
                raise HostOnlyQuery(f"string field budget: {leaf.field_name}")
            c.sh_op[slot] = SOP_STR_EQ
            c.sh_fld[slot] = col
            c.sh_term[slot] = hash_str(leaf.value)
            c.sh_term64[slot] = hash64(leaf.value)
        else:
            raise HostOnlyQuery(f"should clause {type(leaf).__name__}")
    return c

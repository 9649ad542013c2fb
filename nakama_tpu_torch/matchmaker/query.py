"""Matchmaker query language: parser + document evaluator.

Behavior parity with the reference's Bluge query-string matching under a
keyword analyzer and constant-score similarity (reference
server/match_common.go:244-269): whitespace-separated clauses, ``+`` must /
``-`` must-not prefixes, ``field:value`` terms matched verbatim, numeric
comparisons ``field:>=N`` ``field:<N`` …, numeric equality ``field:N``,
regex ``field:/re/`` (anchored full-match), wildcard values with ``*``/``?``,
quoted phrases, and ``^boost`` suffixes. ``*`` alone matches everything.

Scoring mirrors constant-score similarity: every matching leaf clause
contributes its boost (default 1.0); must-not contributes nothing. A query
with no must clauses requires at least one should clause to match.

This module is the CPU oracle's matcher AND the front half of the device
compiler: `compile.py` lowers these AST nodes to
constraint slots evaluated on device.
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import Any

INF = float("inf")


class QueryError(ValueError):
    pass


@dataclass(frozen=True)
class MatchAll:
    boost: float = 1.0


@dataclass(frozen=True)
class Term:
    field_name: str
    value: str
    boost: float = 1.0


@dataclass(frozen=True)
class NumericEq:
    field_name: str
    value: float
    boost: float = 1.0


@dataclass(frozen=True)
class NumericRange:
    field_name: str
    lo: float
    hi: float
    incl_lo: bool = True
    incl_hi: bool = True
    boost: float = 1.0


@dataclass(frozen=True)
class Regexp:
    field_name: str
    pattern: str
    boost: float = 1.0

    def compiled(self):
        return re.compile(self.pattern)


@dataclass(frozen=True)
class Wildcard:
    field_name: str
    pattern: str  # raw, backslash-escapes intact
    boost: float = 1.0

    def compiled(self):
        rx = []
        i = 0
        while i < len(self.pattern):
            ch = self.pattern[i]
            if ch == "\\" and i + 1 < len(self.pattern):
                rx.append(re.escape(self.pattern[i + 1]))
                i += 2
                continue
            if ch == "*":
                rx.append(".*")
            elif ch == "?":
                rx.append(".")
            else:
                rx.append(re.escape(ch))
            i += 1
        return re.compile("".join(rx))


@dataclass(frozen=True)
class BooleanQuery:
    # Tuples: parse_query results are cached and shared across every
    # ticket with the same query string, so the AST must be deeply
    # immutable.
    must: tuple = ()
    must_not: tuple = ()
    should: tuple = ()
    boost: float = 1.0


Query = Any  # union of the node types above


# ---------------------------------------------------------------- tokenizer

_WS = " \t\r\n"


def _split_clauses(q: str) -> list[str]:
    """Split on whitespace, respecting quotes, regex bodies, and escapes."""
    out: list[str] = []
    buf: list[str] = []
    i, n = 0, len(q)
    in_quote = in_regex = False
    while i < n:
        ch = q[i]
        if ch == "\\" and i + 1 < n:
            buf.append(ch)
            buf.append(q[i + 1])
            i += 2
            continue
        if in_quote:
            buf.append(ch)
            if ch == '"':
                in_quote = False
        elif in_regex:
            buf.append(ch)
            if ch == "/":
                in_regex = False
        elif ch == '"':
            buf.append(ch)
            in_quote = True
        elif ch == "/" and buf and buf[-1] == ":":
            buf.append(ch)
            in_regex = True
        elif ch in _WS:
            if buf:
                out.append("".join(buf))
                buf = []
        else:
            buf.append(ch)
        i += 1
    if in_quote or in_regex:
        raise QueryError(f"unterminated {'quote' if in_quote else 'regex'} in query: {q!r}")
    if buf:
        out.append("".join(buf))
    return out


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_BOOST_RE = re.compile(r"\^([+-]?(\d+\.?\d*|\.\d+))$")


def _unescape(s: str) -> str:
    return re.sub(r"\\(.)", r"\1", s)


def _parse_clause(tok: str):
    occur = "should"
    if tok.startswith("+"):
        occur, tok = "must", tok[1:]
    elif tok.startswith("-"):
        occur, tok = "must_not", tok[1:]
    if not tok:
        raise QueryError("empty clause")

    # Split field:value at the first unescaped colon.
    fld = ""
    value = tok
    m = re.match(r"^((?:[^:\\]|\\.)+):(.*)$", tok)
    if m:
        fld, value = _unescape(m.group(1)), m.group(2)
    if value == "":
        raise QueryError(f"clause {tok!r} has no value")

    boost = 1.0
    node: Query

    if value.startswith("/"):
        if not value.endswith("/") or len(value) < 2:
            bm = _BOOST_RE.search(value)
            if bm and value.endswith("/" + bm.group(0)):
                boost = float(bm.group(1))
                value = value[: -len(bm.group(0))]
            if not value.endswith("/") or len(value) < 2:
                raise QueryError(f"bad regex clause: {tok!r}")
        else:
            pass
        pattern = value[1:-1]
        try:
            re.compile(pattern)
        except re.error as e:
            raise QueryError(f"bad regex {pattern!r}: {e}") from e
        node = Regexp(fld, pattern, boost)
        return occur, node

    if value.startswith('"'):
        bm = _BOOST_RE.search(value)
        if bm:
            boost = float(bm.group(1))
            value = value[: -len(bm.group(0))]
        if not (value.endswith('"') and len(value) >= 2):
            raise QueryError(f"bad quoted clause: {tok!r}")
        node = Term(fld, _unescape(value[1:-1]), boost)
        return occur, node

    bm = _BOOST_RE.search(value)
    if bm:
        boost = float(bm.group(1))
        value = value[: -len(bm.group(0))]
        if not value:
            raise QueryError(f"clause {tok!r} has no value before boost")

    for op, make in (
        (">=", lambda v: NumericRange(fld, v, INF, True, True, boost)),
        ("<=", lambda v: NumericRange(fld, -INF, v, True, True, boost)),
        (">", lambda v: NumericRange(fld, v, INF, False, True, boost)),
        ("<", lambda v: NumericRange(fld, -INF, v, True, False, boost)),
    ):
        if value.startswith(op):
            num = value[len(op):]
            if not _NUM_RE.match(num):
                raise QueryError(f"bad numeric comparison: {tok!r}")
            return occur, make(float(num))

    if _NUM_RE.match(value):
        return occur, NumericEq(fld, float(value), boost)

    raw = value
    # Wildcard characters only count when unescaped.
    stripped = re.sub(r"\\.", "", raw)
    if "*" in stripped or "?" in stripped:
        # Keep the raw (escaped) pattern: Wildcard.compiled honours \* \?
        # as literals.
        return occur, Wildcard(fld, raw, boost)
    return occur, Term(fld, _unescape(raw), boost)


@functools.lru_cache(maxsize=8192)
def parse_query(q: str) -> Query:
    """Parse a matchmaker query string into an AST.

    Reference: ParseQueryString (server/match_common.go:244-251) — ``*``
    short-circuits to match-all. Cached: the AST is frozen dataclasses,
    and production pools repeat a small set of canonical query strings
    (mode buckets), so parsing is amortized to a dict hit per add."""
    q = q.strip()
    if q == "" or q == "*":
        return MatchAll()
    clauses = _split_clauses(q)
    buckets = {"must": [], "must_not": [], "should": []}
    for tok in clauses:
        if tok == "*":
            buckets["should"].append(MatchAll())
            continue
        occur, node = _parse_clause(tok)
        buckets[occur].append(node)
    if not buckets["must"] and not buckets["should"]:
        # Only must-not clauses: everything not excluded matches.
        buckets["should"].append(MatchAll())
    return BooleanQuery(
        must=tuple(buckets["must"]),
        must_not=tuple(buckets["must_not"]),
        should=tuple(buckets["should"]),
    )


# ---------------------------------------------------------------- evaluator

_EPS = 1e-9


def _leaf_match(node: Query, doc: dict[str, Any]) -> float | None:
    """Return the score contribution if the leaf matches this doc, else None."""
    if isinstance(node, MatchAll):
        return node.boost
    value = doc.get(node.field_name)
    if value is None:
        return None
    if isinstance(node, Term):
        if isinstance(value, str) and value == node.value:
            return node.boost
        return None
    if isinstance(node, NumericEq):
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            if abs(float(value) - node.value) <= _EPS:
                return node.boost
        return None
    if isinstance(node, NumericRange):
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            v = float(value)
            lo_ok = v >= node.lo if node.incl_lo else v > node.lo
            hi_ok = v <= node.hi if node.incl_hi else v < node.hi
            if lo_ok and hi_ok:
                return node.boost
        return None
    if isinstance(node, (Regexp, Wildcard)):
        if isinstance(value, str) and node.compiled().fullmatch(value):
            return node.boost
        return None
    raise TypeError(f"unknown query node: {node!r}")


def evaluate(node: Query, doc: dict[str, Any]) -> float | None:
    """Evaluate a query AST against a flattened ticket document.

    Returns the constant-similarity score (sum of matching clause boosts) if
    the doc matches, else None."""
    if isinstance(node, BooleanQuery):
        score = 0.0
        for child in node.must:
            s = evaluate(child, doc)
            if s is None:
                return None
            score += s
        for child in node.must_not:
            if evaluate(child, doc) is not None:
                return None
        matched_should = 0
        for child in node.should:
            s = evaluate(child, doc)
            if s is not None:
                matched_should += 1
                score += s
        if not node.must and node.should and matched_should == 0:
            return None
        return score * node.boost
    return _leaf_match(node, doc)


def matches(node: Query, doc: dict[str, Any]) -> bool:
    return evaluate(node, doc) is not None

"""Minimal structured logger: the surface the matchmaker uses.

One JSON object per line with bound fields (`with_fields`), four levels,
and a quiet logger for tests. A line logged inside an active trace
carries its `trace_id`/`span_id` (tracing.py), and every line the node
name set by `set_node_name`.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, TextIO

from .tracing import current_trace_ids

# Process-wide node attribution (set at boot, like the trace store's
# process-global posture): every record carries the node name next to
# its trace_id/span_id, so a merged fleet log stream attributes each
# line to the process that wrote it. Empty = single-process default, no
# extra key.
_NODE_NAME = ""


def set_node_name(name: str) -> None:
    global _NODE_NAME
    _NODE_NAME = name or ""


class Logger:
    """A leveled, structured logger with bound fields."""

    def __init__(
        self,
        level: int = logging.INFO,
        stream: TextIO | None = None,
        fields: dict[str, Any] | None = None,
    ):
        self._level = level
        self._stream = stream if stream is not None else sys.stdout
        self._fields = fields or {}

    def with_fields(self, **fields: Any) -> "Logger":
        return Logger(self._level, self._stream, {**self._fields, **fields})

    def _log(self, level: int, name: str, msg: str, kv: dict[str, Any]):
        if level < self._level:
            return
        record = {
            "level": name,
            "ts": round(time.time(), 3),
            "msg": msg,
            **self._fields,
            **kv,
        }
        # Logs↔traces correlation: one contextvar read per line;
        # explicit kv keys win over the ambient context.
        ids = current_trace_ids()
        if ids is not None:
            record.setdefault("trace_id", ids[0])
            record.setdefault("span_id", ids[1])
        if _NODE_NAME:
            record.setdefault("node", _NODE_NAME)
        self._stream.write(json.dumps(record, default=str) + "\n")

    def debug(self, msg: str, **kv: Any):
        self._log(logging.DEBUG, "debug", msg, kv)

    def info(self, msg: str, **kv: Any):
        self._log(logging.INFO, "info", msg, kv)

    def warn(self, msg: str, **kv: Any):
        self._log(logging.WARNING, "warn", msg, kv)

    warning = warn

    def error(self, msg: str, **kv: Any):
        self._log(logging.ERROR, "error", msg, kv)


def test_logger() -> Logger:
    """Quiet logger for tests: errors only, to stderr."""
    return Logger(level=logging.ERROR, stream=sys.stderr)

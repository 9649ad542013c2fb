"""Minimal structured logger: the surface the matchmaker uses.

One JSON object per line with bound fields (`with_fields`), four levels,
and a quiet logger for tests.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, TextIO


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

"""Structured logging: JSON, logfmt, stackdriver or text lines, with
bound fields.

The port's copy of the JAX package's `logger.py` (reference
server/logger.go:1-221): four levels, stdout and/or file sinks with
size-triggered rotation and count/age retention (`setup_logging`,
`RotatingFile`), cheap `with_fields` child loggers, and a quiet logger
for tests. A line logged inside an active trace carries its
`trace_id`/`span_id` (tracing.py), and every line the node name set by
`set_node_name`.
"""

from __future__ import annotations

import datetime
import gzip
import json
import logging
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, TextIO

from .tracing import current_trace_ids

_LOGFMT_BARE = re.compile(r"^[A-Za-z0-9_.\-/@:+]*$")

# Process-wide node attribution (set at boot, like the trace store's
# process-global posture): every record carries the node name next to
# its trace_id/span_id, so a merged fleet log stream attributes each
# line to the process that wrote it. Empty = single-process default, no
# extra key.
_NODE_NAME = ""


def set_node_name(name: str) -> None:
    global _NODE_NAME
    _NODE_NAME = name or ""


def _logfmt_value(v: Any) -> str:
    s = str(v)
    if _LOGFMT_BARE.match(s):
        return s
    return json.dumps(s, default=str)


class RotatingFile:
    """Size-triggered rotating file sink (lumberjack.Logger semantics,
    reference server/logger.go:118-125): when a write would push the
    file past max_size MB, the current file is renamed to
    ``name-<timestamp>.ext`` and a fresh one is opened; retention prunes
    rotated files beyond max_backups and older than max_age days, and
    compress gzips rotated files. Thread-safe like lumberjack."""

    def __init__(
        self,
        path: str,
        max_size_mb: int = 100,
        max_backups: int = 0,
        max_age_days: int = 0,
        local_time: bool = False,
        compress: bool = False,
    ):
        self.path = path
        self.max_bytes = max(1, max_size_mb) * 1024 * 1024
        self.max_backups = max_backups
        self.max_age_days = max_age_days
        self.local_time = local_time
        self.compress = compress
        self._lock = threading.Lock()
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._file = open(path, "ab", buffering=0)
        self._size = self._file.tell()

    # -- TextIO surface used by Logger ---------------------------------
    def write(self, s: str) -> int:
        # Size accounting in encoded bytes, not characters: multibyte
        # content must not let the file overshoot max_size.
        data = s.encode("utf-8")
        with self._lock:
            if self._size + len(data) > self.max_bytes and self._size > 0:
                self._rotate()
            self._file.write(data)
            self._size += len(data)
            return len(s)

    def flush(self):
        with self._lock:
            self._file.flush()

    def close(self):
        worker = getattr(self, "_bg_worker", None)
        if worker is not None and worker.is_alive():
            worker.join(timeout=30)
        with self._lock:
            try:
                self._file.flush()
                self._file.close()
            except ValueError:
                pass

    # -- rotation ------------------------------------------------------
    def _backup_name(self) -> str:
        root, ext = os.path.splitext(self.path)
        now = (
            datetime.datetime.now()
            if self.local_time
            else datetime.datetime.now(datetime.timezone.utc)
        )
        stamp = now.strftime("%Y-%m-%dT%H-%M-%S.%f")[:-3]
        name = f"{root}-{stamp}{ext}"
        # Millisecond stamps collide under same-millisecond rotations
        # (tiny max_size + a burst of large lines); os.replace would then
        # silently overwrite the earlier rotated file. De-collide with a
        # monotonic sequence suffix (lumberjack-style uniqueness;
        # retention order within the colliding millisecond is
        # approximate, loss-free).
        seq = 1
        while os.path.exists(name) or (
            self.compress and os.path.exists(name + ".gz")
        ):
            name = f"{root}-{stamp}.{seq}{ext}"
            seq += 1
        return name

    def _rotate(self):
        self._file.close()
        backup = self._backup_name()
        try:
            os.replace(self.path, backup)
        except OSError:
            backup = None
        self._file = open(self.path, "ab", buffering=0)
        self._size = 0
        # Compression + pruning run on a background thread (lumberjack
        # does the same in a goroutine): gzipping up to max_size MB and
        # stat-ing the directory under the write lock would stall every
        # logging thread for seconds.
        worker = threading.Thread(
            target=self._compress_and_prune, args=(backup,), daemon=True
        )
        worker.start()
        self._bg_worker = worker

    def _compress_and_prune(self, backup: str | None):
        if backup and self.compress:
            try:
                with open(backup, "rb") as src, gzip.open(
                    backup + ".gz", "wb"
                ) as dst:
                    shutil.copyfileobj(src, dst)
                os.remove(backup)
            except OSError:
                pass
        self._prune()

    def _backups(self) -> list[str]:
        root, ext = os.path.splitext(self.path)
        base = os.path.basename(root)
        directory = os.path.dirname(self.path) or "."
        out = []
        try:
            names = os.listdir(directory)
        except OSError:
            return []
        # Only names carrying OUR timestamp shape count as backups: a
        # bare prefix match would let retention delete unrelated sibling
        # logs like "server-errors.log" (lumberjack parses the stamp for
        # the same reason).
        stamp = re.compile(
            re.escape(base)
            + r"-\d{4}-\d{2}-\d{2}T\d{2}-\d{2}-\d{2}\.\d{3}(\.\d+)?"
            + re.escape(ext)
            + r"(\.gz)?$"
        )
        for name in names:
            if stamp.fullmatch(name):
                out.append(os.path.join(directory, name))
        out.sort()  # timestamp names sort chronologically
        return out

    def _prune(self):
        backups = self._backups()
        doomed = []
        if self.max_backups > 0 and len(backups) > self.max_backups:
            doomed.extend(backups[: len(backups) - self.max_backups])
        if self.max_age_days > 0:
            cutoff = time.time() - self.max_age_days * 86400
            for b in backups:
                try:
                    if os.path.getmtime(b) < cutoff:
                        doomed.append(b)
                except OSError:
                    pass
        for b in set(doomed):
            try:
                os.remove(b)
            except OSError:
                pass


_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

# Cloud Logging severity names (reference StackdriverLevelEncoder,
# server/logger.go:188): 'WARN' is NOT a recognized LogSeverity — Cloud
# Logging downgrades unknown names to DEFAULT, so warn lines would lose
# their level. Map through this table, never name.upper().
_STACKDRIVER_SEVERITY = {
    "debug": "DEBUG",
    "info": "INFO",
    "warn": "WARNING",
    "warning": "WARNING",
    "error": "ERROR",
}


class _Tee:
    """Several sinks behind one stream (stdout and a log file)."""

    def __init__(self, streams: list[TextIO]):
        self.streams = streams

    def write(self, s: str) -> int:
        for stream in self.streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self.streams:
            stream.flush()


class Logger:
    """A leveled, structured logger with bound fields."""

    def __init__(
        self,
        level: int = logging.INFO,
        stream: TextIO | None = None,
        fields: dict[str, Any] | None = None,
        fmt: str = "json",
    ):
        self._level = level
        self._stream = stream if stream is not None else sys.stdout
        self._fields = fields or {}
        self._fmt = fmt

    def with_fields(self, **fields: Any) -> "Logger":
        return Logger(
            self._level, self._stream, {**self._fields, **fields}, self._fmt
        )

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
        if self._fmt == "json":
            line = json.dumps(record, default=str)
        elif self._fmt == "logfmt":
            line = " ".join(
                f"{k}={_logfmt_value(v)}" for k, v in record.items()
            )
        elif self._fmt == "stackdriver":
            sd = {
                "severity": _STACKDRIVER_SEVERITY.get(name, name.upper()),
                "timestamp": datetime.datetime.fromtimestamp(
                    record["ts"], datetime.timezone.utc
                ).isoformat(),
                "message": msg,
                **{
                    k: v
                    for k, v in record.items()
                    if k not in ("level", "ts", "msg")
                },
            }
            line = json.dumps(sd, default=str)
        else:
            extras = " ".join(
                f"{k}={v}" for k, v in record.items() if k not in ("msg",)
            )
            line = f"{msg} {extras}"
        try:
            self._stream.write(line + "\n")
        except ValueError:  # closed file during shutdown
            pass

    def debug(self, msg: str, **kv: Any):
        self._log(logging.DEBUG, "debug", msg, kv)

    def info(self, msg: str, **kv: Any):
        self._log(logging.INFO, "info", msg, kv)

    def warn(self, msg: str, **kv: Any):
        self._log(logging.WARNING, "warn", msg, kv)

    warning = warn

    def error(self, msg: str, **kv: Any):
        self._log(logging.ERROR, "error", msg, kv)


def setup_logging(cfg) -> Logger:
    """The server's logger from its `LoggerConfig`: level, format, and
    stdout and/or a file sink (rotated when `rotation` is set)."""
    streams: list[TextIO] = []
    if cfg.stdout:
        streams.append(sys.stdout)
    if cfg.file:
        if cfg.rotation:
            streams.append(
                RotatingFile(
                    cfg.file,
                    max_size_mb=cfg.max_size,
                    max_backups=cfg.max_backups,
                    max_age_days=cfg.max_age,
                    local_time=cfg.local_time,
                    compress=cfg.compress,
                )
            )
        else:
            # Line-buffered so a crash loses at most the in-flight line.
            streams.append(open(cfg.file, "a", buffering=1))
    if not streams:
        streams = [sys.stdout]
    return Logger(
        level=_LEVELS.get(cfg.level.lower(), logging.INFO),
        stream=streams[0] if len(streams) == 1 else _Tee(streams),
        fmt=cfg.format,
    )


def test_logger() -> Logger:
    """Quiet logger for tests: errors only, to stderr."""
    return Logger(level=logging.ERROR, stream=sys.stderr)

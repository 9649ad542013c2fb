"""Overload-control plane, deadline part: request deadlines.

Port of the deadline half of the JAX package's `overload.py`: the
priority classes and load levels, `DeadlineExceeded`, the per-request
`Deadline` carried in a contextvar, and the checkpoints that read it.
`LocalMatchmaker.add` refuses a ticket whose caller's deadline already
passed (registering it would be dead work the client has given up on).
The admission controller, the rate limiter and the OK/WARN/SHED
overload ladder come with the server.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

# ------------------------------------------------------- priority classes

REALTIME = 0  # socket ops: match data, party, status, matchmaker adds
RPC = 1  # authenticated request/response: storage writes, rpc, account
LIST = 2  # list/read endpoints: cheapest to retry, first to shed

CLASS_NAMES = {REALTIME: "realtime", RPC: "rpc", LIST: "list"}

# ------------------------------------------------------------ load levels

OK = 0
WARN = 1
SHED = 2

LEVEL_NAMES = {OK: "ok", WARN: "warn", SHED: "shed"}


class OverloadError(Exception):
    pass


class DeadlineExceeded(OverloadError):
    """The caller's deadline passed — mapped to HTTP 504 / gRPC
    DEADLINE_EXCEEDED. Raised *before* dead work wherever a deadline
    checkpoint exists (admission, matchmaker add, storage drain)."""


# --------------------------------------------------------------- deadline


class Deadline:
    """Absolute expiry on the monotonic clock, carried per-request.

    `explicit` distinguishes a client-supplied timeout (grpc-timeout /
    X-Request-Timeout — the front door enforces it with a bounded wait)
    from a per-class config default (propagated for queue-drop
    checkpoints but not worth a wait_for task per request)."""

    __slots__ = ("expires_at", "explicit")

    def __init__(self, timeout_s: float, explicit: bool = False):
        self.expires_at = time.monotonic() + max(0.0, float(timeout_s))
        self.explicit = explicit

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at


# The propagation channel: contextvars follow the request through every
# awaited call on its task, so storage/matchmaker checkpoints read the
# caller's deadline without threading a parameter through every core
# signature.
_current_deadline: contextvars.ContextVar[Deadline | None] = (
    contextvars.ContextVar("nakama_request_deadline", default=None)
)


def current_deadline() -> Deadline | None:
    return _current_deadline.get()


def set_deadline(deadline: Deadline | None):
    """Install `deadline` for the current context; returns the reset
    token for `reset_deadline`."""
    return _current_deadline.set(deadline)


def reset_deadline(token) -> None:
    _current_deadline.reset(token)


@contextlib.contextmanager
def deadline_scope(deadline: Deadline | None):
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)


def check_deadline(where: str = "") -> None:
    """Short-circuit checkpoint: raise DeadlineExceeded if the current
    context's deadline already passed. One contextvar get + one clock
    read when a deadline is set; one contextvar get when not."""
    dl = _current_deadline.get()
    if dl is not None and dl.expired():
        raise DeadlineExceeded(
            f"deadline exceeded{f' at {where}' if where else ''}"
        )

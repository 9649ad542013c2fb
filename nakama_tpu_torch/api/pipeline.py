"""Realtime message pipeline.

Parity with the reference Pipeline (reference server/pipeline.go:63-189):
every incoming envelope is validated to exactly one known variant and
dispatched to its handler. The port's copy of the JAX package's
`api/pipeline.py` for this slice: the same `process` → realtime-class
admission and deadline → `_dispatch` path with one trace root span per
envelope, and the handlers of `ping`/`pong`, `matchmaker_add`/`remove`
and `status_follow`/`unfollow`/`update`. Every other request key
(`channel_*`, `match_*`, `party_*`, `rpc`) answers what the JAX
`_dispatch` answers for a key without a handler: BAD_INPUT
"{key} not available" (ROADMAP.md §A lists them as later slices).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any

from .. import overload
from .. import tracing as trace_api
from ..logger import Logger
from ..metrics import Metrics
from ..realtime import PresenceMeta, Stream, StreamMode
from .envelope import REQUEST_KEYS, ErrorCode, error, message_key


@dataclass
class Components:
    """Everything the pipeline can touch (reference Pipeline struct,
    server/pipeline.go:27)."""

    config: Any
    tracker: Any
    status_registry: Any
    matchmaker: Any = None
    db: Any = None  # user resolution (status follow)
    metrics: Metrics | None = None
    overload: Any = None  # OverloadController (overload.py); None in tests


class Pipeline:
    def __init__(self, logger: Logger, components: Components):
        self.logger = logger.with_fields(subsystem="pipeline")
        self.c = components

    # ------------------------------------------------------------ dispatch

    async def process(self, session, envelope: dict) -> bool:
        """Entry from the socket read loop: one trace root span per
        envelope (the socket has no traceparent header, so every
        envelope starts a fresh trace carrying session identity), then
        realtime-class admission + a per-envelope deadline
        (overload.py), then dispatch."""
        if not trace_api.TRACES.enabled:
            return await self._process_admitted(session, envelope, None)
        key = (
            message_key(envelope) if isinstance(envelope, dict) else None
        )
        with trace_api.root_span(
            f"ws.{key or 'envelope'}",
            session_id=getattr(session, "id", ""),
            user_id=getattr(session, "user_id", ""),
        ) as root:
            return await self._process_admitted(session, envelope, root)

    async def _process_admitted(self, session, envelope: dict, root) -> bool:
        """Realtime-class admission + a per-envelope deadline
        (overload.py), then dispatch. Socket ops are the HIGHEST
        priority class, but still bounded: past the realtime queue cap
        the envelope is answered with a retryable error instead of
        queueing without limit."""
        ov = self.c.overload
        if ov is None:
            return await self._dispatch(session, envelope)
        cid = envelope.get("cid", "") if isinstance(envelope, dict) else ""
        ocfg = getattr(self.c.config, "overload", None)
        default_ms = (
            (ocfg.deadline_realtime_ms or ocfg.deadline_default_ms)
            if ocfg is not None
            else 5_000
        )
        deadline = overload.Deadline(max(1, default_ms) / 1000.0)
        try:
            with trace_api.span("admission", **{"class": "realtime"}):
                await ov.admission.admit(overload.REALTIME, deadline)
        except overload.AdmissionRejected:
            if root is not None:
                root.set_status("error", "admission rejected")
            session.send(
                error(
                    ErrorCode.RUNTIME_EXCEPTION,
                    "server overloaded, retry later",
                    cid,
                )
            )
            return True
        except overload.DeadlineExceeded:
            self._note_deadline()
            if root is not None:
                root.set_status("error", "deadline exceeded")
            session.send(
                error(ErrorCode.RUNTIME_EXCEPTION, "deadline exceeded", cid)
            )
            return True
        token = overload.set_deadline(deadline)
        try:
            return await self._dispatch(session, envelope)
        finally:
            overload.reset_deadline(token)
            ov.admission.release()

    def _note_deadline(self):
        if self.c.metrics is not None:
            self.c.metrics.request_deadline_exceeded.labels(
                stage="pipeline"
            ).inc()

    async def _dispatch(self, session, envelope: dict) -> bool:
        key = message_key(envelope)
        cid = envelope.get("cid", "")
        if key is None:
            session.send(
                error(
                    ErrorCode.MISSING_PAYLOAD
                    if not [k for k in envelope if k != "cid"]
                    else ErrorCode.UNRECOGNIZED_PAYLOAD,
                    "exactly one message variant required",
                    cid,
                )
            )
            return True
        if key not in REQUEST_KEYS:
            session.send(
                error(
                    ErrorCode.UNRECOGNIZED_PAYLOAD,
                    f"unrecognized message: {key}",
                    cid,
                )
            )
            return True

        handler = getattr(self, f"_h_{key}", None)
        if handler is None:
            session.send(
                error(ErrorCode.BAD_INPUT, f"{key} not available", cid)
            )
            return True

        body = envelope[key]
        if not isinstance(body, dict):
            body = {}

        try:
            with trace_api.span(f"pipeline.{key}"):
                await _maybe_await(handler(session, cid, body))
        except PipelineError as e:
            session.send(error(e.code, str(e), cid))
        except overload.DeadlineExceeded as e:
            # A deep checkpoint (matchmaker add, storage submit) fired
            # on this envelope's deadline: a retryable error, not an
            # internal one.
            self._note_deadline()
            sp = trace_api.current_span()
            if sp is not None:
                sp.set_status("error", f"deadline exceeded: {e}")
            session.send(error(ErrorCode.RUNTIME_EXCEPTION, str(e), cid))
        except Exception as e:
            self.logger.error("pipeline handler error", key=key, error=str(e))
            sp = trace_api.current_span()
            if sp is not None:
                sp.set_status("error", f"{type(e).__name__}: {e}")
            session.send(error(ErrorCode.RUNTIME_EXCEPTION, "internal error", cid))
        return True

    # ---------------------------------------------------------------- ping

    def _h_ping(self, session, cid, body):
        out: dict = {"pong": {}}
        if cid:
            out["cid"] = cid
        session.send(out)

    def _h_pong(self, session, cid, body):
        pass

    # ---------------------------------------------------------- matchmaker

    def _h_matchmaker_add(self, session, cid, body):
        """Reference pipeline_matchmaker.go:23-101."""
        mm = _require(self.c.matchmaker, "matchmaker")
        min_count, max_count, multiple = _validate_counts(body)
        query = body.get("query") or "*"
        from ..matchmaker import MatchmakerError, MatchmakerPresence

        presence = MatchmakerPresence(
            user_id=session.user_id,
            session_id=session.id,
            username=session.username,
        )
        string_props = {
            k: str(v)
            for k, v in (body.get("string_properties") or {}).items()
        }
        numeric_props = {
            k: float(v)
            for k, v in (body.get("numeric_properties") or {}).items()
        }
        try:
            ticket, _ = mm.add(
                [presence],
                session.id,
                "",
                query,
                min_count,
                max_count,
                multiple,
                string_props,
                numeric_props,
            )
        except MatchmakerError as e:
            raise PipelineError(str(e) or type(e).__name__) from e
        out: dict = {"matchmaker_ticket": {"ticket": ticket}}
        if cid:
            out["cid"] = cid
        session.send(out)

    def _h_matchmaker_remove(self, session, cid, body):
        mm = _require(self.c.matchmaker, "matchmaker")
        ticket = body.get("ticket", "")
        if not ticket:
            raise PipelineError("ticket required")
        from ..matchmaker import MatchmakerError

        try:
            mm.remove_session(session.id, ticket)
        except MatchmakerError as e:
            raise PipelineError("ticket not found") from e
        out: dict = {}
        if cid:
            out["cid"] = cid
        if out:
            session.send(out)

    # -------------------------------------------------------------- status

    async def _h_status_follow(self, session, cid, body):
        """Reference pipeline_status.go statusFollow: targets may be user
        ids or usernames (resolved against the users table); only
        existing users are followed."""
        raw_ids = [u for u in (body.get("user_ids") or []) if u]
        usernames = [u for u in (body.get("usernames") or []) if u]
        if self.c.db is not None:
            user_ids = await _existing_user_ids(self.c.db, raw_ids, usernames)
        else:
            user_ids = set(raw_ids)
        self.c.status_registry.follow(session.id, user_ids)
        presences = []
        for uid in user_ids:
            for p in self.c.tracker.list_by_stream(
                Stream(StreamMode.STATUS, subject=uid)
            ):
                presences.append(
                    {
                        "user_id": p.user_id,
                        "username": p.meta.username,
                        "status": p.meta.status,
                    }
                )
        out: dict = {"status": {"presences": presences}}
        if cid:
            out["cid"] = cid
        session.send(out)

    def _h_status_unfollow(self, session, cid, body):
        self.c.status_registry.unfollow(
            session.id, set(body.get("user_ids") or [])
        )
        out: dict = {}
        if cid:
            out["cid"] = cid
            session.send(out)

    def _h_status_update(self, session, cid, body):
        status = str(body.get("status", ""))
        if len(status) > 2048:
            raise PipelineError("status too long")
        self.c.tracker.update(
            session.id,
            Stream(StreamMode.STATUS, subject=session.user_id),
            session.user_id,
            PresenceMeta(
                format=session.format,
                username=session.username,
                status=status,
            ),
        )
        out: dict = {}
        if cid:
            out["cid"] = cid
            session.send(out)


async def _existing_user_ids(db, user_ids: list[str], usernames: list[str]) -> set[str]:
    """Ids of the users named by id or username that exist (the JAX
    package's `core/account.py::get_users`, ids only)."""
    found: set[str] = set()
    for column, values in (("id", user_ids), ("username", usernames)):
        if values:
            marks = ", ".join("?" for _ in values)
            rows = await db.fetch_all(
                f"SELECT id FROM users WHERE {column} IN ({marks})", values
            )
            found.update(row["id"] for row in rows)
    return found


class PipelineError(Exception):
    def __init__(self, message: str, code: ErrorCode = ErrorCode.BAD_INPUT):
        super().__init__(message)
        self.code = code


def _validate_counts(body: dict) -> tuple[int, int, int]:
    """Matchmaker count validation (reference
    pipeline_matchmaker.go:27-71)."""
    min_count = int(body.get("min_count", 0))
    max_count = int(body.get("max_count", 0))
    multiple = int(body.get("count_multiple", 1) or 1)
    if min_count < 2:
        raise PipelineError("invalid min count")
    if max_count < min_count:
        raise PipelineError("invalid max count")
    if multiple < 1 or min_count % multiple or max_count % multiple:
        raise PipelineError("invalid count multiple")
    return min_count, max_count, multiple


def _require(component, name: str):
    if component is None:
        raise PipelineError(f"{name} not available")
    return component


async def _maybe_await(value):
    if asyncio.iscoroutine(value):
        return await value
    return value

"""Realtime message pipeline.

Parity with the reference Pipeline (reference server/pipeline.go:63-189):
every incoming envelope is validated to exactly one known variant and
dispatched to its handler. The port's copy of the JAX package's
`api/pipeline.py`: the same `process` → realtime-class admission and
deadline → `_dispatch` path with one trace root span per envelope, and
the handlers of `ping`/`pong`, `matchmaker_add`/`remove`,
`status_follow`/`unfollow`/`update`, `match_*`, `party_*` (one node:
the JAX package's cross-node join and data branches are left out) and
`channel_join`/`leave`/`message_send`/`update`/`remove` over the port's
`core/channel.py`, and `rpc` into the runtime's registered functions.
The runtime's before and after realtime hooks run around every handler
but `rpc`'s, as in the JAX pipeline.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
from dataclasses import dataclass
from typing import Any

from .. import overload
from .. import tracing as trace_api
from ..core import account as core_account
from ..core.channel import (
    ChannelError,
    channel_id_to_stream,
    channel_to_stream,
    stream_to_channel_id,
)
from ..core.group import ADMIN, MEMBER, SUPERADMIN
from ..logger import Logger
from ..match.party import PartyError
from ..metrics import Metrics
from ..realtime import Presence, PresenceID, PresenceMeta, Stream, StreamMode
from .envelope import REQUEST_KEYS, ErrorCode, error, message_key


def _b64_bytes(data) -> bytes:
    """Decode an envelope bytes field from its JSON representation.
    The proto3 JSON mapping accepts both base64 alphabets (protobuf's
    parser normalizes -_ to +/) and missing padding, so this does too."""
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    if not isinstance(data, str):
        raise PipelineError("data must be a base64 string")
    normalized = data.replace("-", "+").replace("_", "/")
    normalized += "=" * (-len(normalized) % 4)
    try:
        return base64.b64decode(normalized, validate=True)
    except (binascii.Error, ValueError) as e:
        raise PipelineError("data must be base64") from e


@dataclass
class Components:
    """Everything the pipeline can touch (reference Pipeline struct,
    server/pipeline.go:27)."""

    config: Any
    tracker: Any
    status_registry: Any
    router: Any = None
    matchmaker: Any = None
    match_registry: Any = None
    party_registry: Any = None
    channels: Any = None  # core/channel.py Channels
    groups: Any = None  # core/group.py Groups (channel-join membership gate)
    session_registry: Any = None
    db: Any = None  # user resolution (status follow)
    metrics: Metrics | None = None
    overload: Any = None  # OverloadController (overload.py); None in tests
    runtime: Any = None


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

        runtime = self.c.runtime
        if runtime is not None and key != "rpc":
            before = runtime.before_rt(key)
            if before is not None:
                try:
                    body = await _maybe_await(before(session, key, body))
                except Exception as e:
                    session.send(
                        error(ErrorCode.RUNTIME_EXCEPTION, str(e), cid)
                    )
                    return True
                if body is None:
                    # Hook rejected the message silently.
                    return True

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

        if runtime is not None and key != "rpc":
            after = runtime.after_rt(key)
            if after is not None:
                try:
                    await _maybe_await(after(session, key, body))
                except Exception as e:
                    self.logger.error("after hook error", key=key, error=str(e))
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
            users = await core_account.get_users(
                self.c.db, user_ids=raw_ids, usernames=usernames
            )
            user_ids = {u["id"] for u in users}
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


    # --------------------------------------------------------------- match

    def _presence_for(self, session, stream: Stream, hidden=False):
        return Presence(
            id=PresenceID(self.c.config.name, session.id),
            stream=stream,
            user_id=session.user_id,
            meta=PresenceMeta(
                format=session.format,
                username=session.username,
                hidden=hidden,
            ),
        )

    async def _h_match_create(self, session, cid, body):
        """Client match creation (reference pipeline_match.go:37): with a
        registered handler name → authoritative; bare → relayed."""
        name = (body.get("name") or "").strip()
        if name:
            registry = _require(self.c.match_registry, "match registry")
            from ..match import MatchError

            try:
                match_id = registry.create_match(name, body.get("params") or {})
            except MatchError as e:
                raise PipelineError(str(e)) from e
            await self._join_authoritative(session, cid, match_id, {})
            return
        import uuid

        match_id = f"{uuid.uuid4()}.{self.c.config.name}"
        self._join_relayed(session, cid, match_id)

    async def _h_match_join(self, session, cid, body):
        metadata = body.get("metadata") or {}
        match_id = body.get("match_id", "")
        token = body.get("token", "")
        if token:
            from . import session_token

            try:
                claims = session_token.parse(
                    self.c.config.session.encryption_key, token
                )
            except session_token.TokenError as e:
                raise PipelineError(f"invalid match token: {e}") from e
            if claims.vars.get("kind") != "match_token":
                raise PipelineError("invalid match token")
            match_id = claims.vars.get("mid", "")
        if not match_id or "." not in match_id:
            raise PipelineError("match id or token required")

        registry = self.c.match_registry
        handler = registry.get(match_id) if registry is not None else None
        if handler is not None:
            await self._join_authoritative(session, cid, match_id, metadata)
            return
        self._join_relayed(session, cid, match_id)

    def _leave_other_matches(self, session, joining_id: str):
        """session.single_match: joining a match leaves any previous one
        (reference SessionConfig SingleMatch). The match being joined is
        excluded — a self-rejoin must stay an idempotent no-op, not a
        leave+join that reaches the match loop and other clients."""
        if not self.c.config.session.single_match:
            return
        for stream in list(
            self.c.tracker.get_local_by_session(session.id)
        ):
            if stream.mode in (
                StreamMode.MATCH_RELAYED, StreamMode.MATCH_AUTHORITATIVE
            ) and stream.subject != joining_id:
                self.c.tracker.untrack(session.id, stream)

    def _leave_other_parties(self, session_id: str, joining_id: str):
        """session.single_party: joining/creating a party leaves any
        previous one (reference SessionConfig SingleParty). Excludes the
        party being joined (self-rejoin would otherwise destroy a
        single-member party / reassign leaders via the async leave)."""
        if not self.c.config.session.single_party:
            return
        for stream in list(self.c.tracker.get_local_by_session(session_id)):
            if (
                stream.mode == StreamMode.PARTY
                and stream.subject != joining_id
            ):
                self.c.tracker.untrack(session_id, stream)

    async def _join_authoritative(self, session, cid, match_id, metadata):
        registry = _require(self.c.match_registry, "match registry")
        stream = Stream(StreamMode.MATCH_AUTHORITATIVE, subject=match_id)
        presence = self._presence_for(session, stream)
        allow, reason, handler = await registry.join_attempt(
            match_id, presence, metadata
        )
        if allow:
            self._leave_other_matches(session, match_id)
        if not allow:
            session.send(
                error(
                    ErrorCode.MATCH_JOIN_REJECTED,
                    reason or "join rejected",
                    cid,
                )
            )
            return
        existing = [
            p.as_dict() for p in handler.presences.list()
        ]
        self.c.tracker.track(
            session.id, stream, session.user_id, presence.meta
        )
        out = {
            "match": {
                "match_id": match_id,
                "authoritative": True,
                "label": handler.label,
                "presences": existing,
                "self": presence.as_dict(),
            }
        }
        if cid:
            out["cid"] = cid
        session.send(out)

    def _join_relayed(self, session, cid, match_id):
        self._leave_other_matches(session, match_id)
        stream = Stream(StreamMode.MATCH_RELAYED, subject=match_id)
        presence = self._presence_for(session, stream)
        existing = [
            p.as_dict()
            for p in self.c.tracker.list_by_stream(stream)
        ]
        self.c.tracker.track(
            session.id, stream, session.user_id, presence.meta
        )
        out = {
            "match": {
                "match_id": match_id,
                "authoritative": False,
                "presences": existing,
                "self": presence.as_dict(),
            }
        }
        if cid:
            out["cid"] = cid
        session.send(out)

    def _h_match_leave(self, session, cid, body):
        match_id = body.get("match_id", "")
        if not match_id:
            raise PipelineError("match id required")
        for mode in (StreamMode.MATCH_RELAYED, StreamMode.MATCH_AUTHORITATIVE):
            self.c.tracker.untrack(
                session.id, Stream(mode, subject=match_id)
            )
        out: dict = {}
        if cid:
            out["cid"] = cid
            session.send(out)

    def _h_match_data_send(self, session, cid, body):
        """Reference pipeline_match.go:338-366.

        The envelope's `data` field is bytes (rtapi MatchDataSend.data,
        both here and in the reference realtime.proto); in the JSON
        representation bytes fields are base64 text per the proto3 JSON
        mapping, which json_format applies when bridging protobuf-mode
        sockets. The authoritative path decodes here so match cores see
        raw bytes."""
        match_id = body.get("match_id", "")
        op_code = int(body.get("op_code", 0))
        data = body.get("data", "")
        registry = self.c.match_registry
        handler = registry.get(match_id) if registry is not None else None
        if handler is not None:
            stream = Stream(StreamMode.MATCH_AUTHORITATIVE, subject=match_id)
            presence = self.c.tracker.get_by_stream_user(stream, session.id)
            if presence is None:
                raise PipelineError("not in match")
            raw = _b64_bytes(data)
            registry.send_data(
                match_id,
                presence,
                op_code,
                raw,
                bool(body.get("reliable", True)),
            )
            return
        stream = Stream(StreamMode.MATCH_RELAYED, subject=match_id)
        sender = self.c.tracker.get_by_stream_user(stream, session.id)
        if sender is None:
            raise PipelineError("not in match")
        # Validate + canonicalize on the relayed path too: a non-base64
        # payload relayed verbatim would blow up json_format.ParseDict
        # (bytes field) in a protobuf-format recipient's writer and kill
        # *their* socket.
        envelope = {
            "match_data": {
                "match_id": match_id,
                "presence": sender.as_dict(),
                "op_code": op_code,
                "data": base64.b64encode(_b64_bytes(data)).decode("ascii"),
            }
        }
        targets = [
            p.id
            for p in self.c.tracker.list_by_stream(stream)
            if p.id.session_id != session.id
        ]
        self.c.router.send_to_presence_ids(targets, envelope)

    # --------------------------------------------------------------- party

    def _party(self, party_id: str):
        registry = _require(self.c.party_registry, "party registry")
        handler = registry.get(party_id)
        if handler is None:
            raise PipelineError("party not found")
        return handler

    def _note_party_op(self, op: str, handler=None):
        """Party-operation accounting, as the JAX pipeline counts it (a
        single node never crosses to a remote authority)."""
        m = self.c.metrics
        if m is None:
            return
        m.cluster_party_ops.labels(op=op, crossed="false").inc()

    def _h_party_create(self, session, cid, body):
        """Reference pipeline_party.go partyCreate."""
        registry = _require(self.c.party_registry, "party registry")

        try:
            handler = registry.create(
                bool(body.get("open", True)),
                int(body.get("max_size", 256) or 256),
            )
        except PartyError as e:
            raise PipelineError(str(e)) from e
        self._leave_other_parties(session.id, handler.party_id)
        presence = self._presence_for(session, handler.stream)
        self.c.tracker.track(
            session.id, handler.stream, session.user_id, presence.meta
        )
        handler.on_joins([presence])
        self._note_party_op("create", handler)
        out = {"party": {**handler.as_dict(), "self": presence.as_dict()}}
        if cid:
            out["cid"] = cid
        session.send(out)

    async def _h_party_join(self, session, cid, body):
        """Reference pipeline_party.go partyJoin: the party's admission
        check, then the track."""
        handler = self._party(body.get("party_id", ""))

        stream = handler.stream
        presence = self._presence_for(session, stream)
        try:
            allowed = await _maybe_await(handler.request_join(presence))
        except PartyError as e:
            raise PipelineError(str(e)) from e
        self._note_party_op("join", handler)
        if allowed:
            self._leave_other_parties(session.id, handler.party_id)
            self.c.tracker.track(
                session.id, stream, session.user_id, presence.meta
            )
            handler.on_joins([presence])
            pd = handler.as_dict()
            out = {"party": {**pd, "self": presence.as_dict()}}
            if cid:
                out["cid"] = cid
            session.send(out)
        elif cid:
            session.send({"cid": cid})

    def _h_party_leave(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))
        self._note_party_op("leave", handler)
        self.c.tracker.untrack(session.id, handler.stream)
        if cid:
            session.send({"cid": cid})

    async def _h_party_promote(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))

        try:
            await _maybe_await(
                handler.promote(session.id, body.get("presence") or {})
            )
        except PartyError as e:
            raise PipelineError(str(e)) from e
        self._note_party_op("promote", handler)
        if cid:
            session.send({"cid": cid})

    async def _h_party_accept(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))

        try:
            presence = await _maybe_await(
                handler.accept(session.id, body.get("presence") or {})
            )
        except PartyError as e:
            raise PipelineError(str(e)) from e
        self._note_party_op("accept", handler)
        if presence is not None:
            target = (
                self.c.session_registry.get(presence.id.session_id)
                if self.c.session_registry is not None
                else None
            )
            if target is None:
                raise PipelineError("accepted session gone")
            self._leave_other_parties(
                presence.id.session_id, handler.party_id
            )
            self.c.tracker.track(
                presence.id.session_id,
                handler.stream,
                presence.user_id,
                presence.meta,
            )
            handler.on_joins([presence])
            target.send(
                {
                    "party": {
                        **handler.as_dict(),
                        "self": presence.as_dict(),
                    }
                }
            )
        if cid:
            session.send({"cid": cid})

    async def _h_party_remove(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))

        try:
            removed = await _maybe_await(
                handler.remove(session.id, body.get("presence") or {})
            )
        except PartyError as e:
            raise PipelineError(str(e)) from e
        self._note_party_op("remove", handler)
        if removed is not None:
            self.c.party_registry.untrack_presence(
                removed, handler.stream
            )
        if cid:
            session.send({"cid": cid})

    async def _h_party_close(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))

        try:
            await _maybe_await(handler.close(session.id, self.c.tracker))
        except PartyError as e:
            raise PipelineError(str(e)) from e
        self._note_party_op("close", handler)
        self.c.party_registry.remove(handler.party_id)
        if cid:
            session.send({"cid": cid})

    async def _h_party_join_request_list(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))

        try:
            pending = await _maybe_await(
                handler.join_request_list(session.id)
            )
        except PartyError as e:
            raise PipelineError(str(e)) from e
        self._note_party_op("list_requests", handler)
        out = {
            "party_join_request": {
                "party_id": handler.party_id,
                "presences": [
                    p if isinstance(p, dict) else p.as_dict()
                    for p in pending
                ],
            }
        }
        if cid:
            out["cid"] = cid
        session.send(out)

    async def _h_party_matchmaker_add(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))
        from ..matchmaker import MatchmakerError

        min_count, max_count, multiple = _validate_counts(body)
        try:
            ticket = await _maybe_await(
                handler.matchmaker_add(
                    session.id,
                    body.get("query") or "*",
                    min_count,
                    max_count,
                    multiple,
                    {
                        k: str(v)
                        for k, v in (
                            body.get("string_properties") or {}
                        ).items()
                    },
                    {
                        k: float(v)
                        for k, v in (
                            body.get("numeric_properties") or {}
                        ).items()
                    },
                )
            )
        except (PartyError, MatchmakerError) as e:
            raise PipelineError(str(e) or type(e).__name__) from e
        self._note_party_op("mm_add", handler)
        out = {
            "party_matchmaker_ticket": {
                "party_id": handler.party_id,
                "ticket": ticket,
            }
        }
        if cid:
            out["cid"] = cid
        session.send(out)

    async def _h_party_matchmaker_remove(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))
        from ..matchmaker import MatchmakerError

        try:
            await _maybe_await(
                handler.matchmaker_remove(
                    session.id, body.get("ticket", "")
                )
            )
        except (PartyError, MatchmakerError) as e:
            raise PipelineError(str(e) or type(e).__name__) from e
        self._note_party_op("mm_remove", handler)
        if cid:
            session.send({"cid": cid})

    async def _h_party_data_send(self, session, cid, body):
        handler = self._party(body.get("party_id", ""))

        try:
            # Same bytes-field contract as match data: validate and
            # canonicalize the base64 before relaying to members.
            await _maybe_await(
                handler.data_send(
                    session.id,
                    int(body.get("op_code", 0)),
                    base64.b64encode(
                        _b64_bytes(body.get("data", ""))
                    ).decode("ascii"),
                )
            )
        except PartyError as e:
            raise PipelineError(str(e)) from e
        self._note_party_op("data", handler)


    # ------------------------------------------------------------- channel

    async def _h_channel_join(self, session, cid, body):
        """Reference pipeline_channel.go channelJoin: map (type, target)
        to a stream, track, answer with the channel + current presences."""
        _require(self.c.channels, "channels")
        try:
            stream = channel_to_stream(
                int(body.get("type", 0)),
                str(body.get("target", "")),
                session.user_id,
            )
        except ChannelError as e:
            raise PipelineError(str(e)) from e
        if stream.mode == StreamMode.GROUP and self.c.groups is not None:
            # Group chat requires membership (reference
            # pipeline_channel.go channelJoin group gate).
            row = await self.c.groups.db.fetch_one(
                "SELECT state FROM group_edge WHERE source_id = ?"
                " AND destination_id = ?",
                (stream.subject, session.user_id),
            )
            state = None if row is None else row["state"]
            if state not in (SUPERADMIN, ADMIN, MEMBER):
                raise PipelineError("must be a group member")
        presence = Presence(
            id=PresenceID(self.c.config.name, session.id),
            stream=stream,
            user_id=session.user_id,
            meta=PresenceMeta(
                format=session.format,
                username=session.username,
                hidden=bool(body.get("hidden", False)),
                persistence=bool(body.get("persistence", True)),
            ),
        )
        existing = [
            p.as_dict()
            for p in self.c.tracker.list_by_stream(stream)
            if not p.meta.hidden
        ]
        self.c.tracker.track(
            session.id, stream, session.user_id, presence.meta
        )
        out: dict = {
            "channel": {
                "id": stream_to_channel_id(stream),
                "presences": existing,
                "self": presence.as_dict(),
            }
        }
        if stream.mode == StreamMode.CHANNEL:
            out["channel"]["room_name"] = stream.label
        elif stream.mode == StreamMode.GROUP:
            out["channel"]["group_id"] = stream.subject
        else:
            out["channel"]["user_id_one"] = stream.subject
            out["channel"]["user_id_two"] = stream.subcontext
        if cid:
            out["cid"] = cid
        session.send(out)

    def _h_channel_leave(self, session, cid, body):
        try:
            stream = channel_id_to_stream(body.get("channel_id", ""))
        except ChannelError as e:
            raise PipelineError(str(e)) from e
        self.c.tracker.untrack(session.id, stream)
        if cid:
            session.send({"cid": cid})

    def _in_channel(self, session, channel_id: str):
        try:
            stream = channel_id_to_stream(channel_id)
        except ChannelError as e:
            raise PipelineError(str(e)) from e
        if self.c.tracker.get_by_stream_user(stream, session.id) is None:
            raise PipelineError("must join channel before sending")
        return stream

    def _message_content(self, body: dict) -> dict:
        """The `content` of a send or update: a JSON object, or a string
        that holds one."""
        content = body.get("content")
        if isinstance(content, str):
            try:
                content = json.loads(content)
            except ValueError:
                content = None
        if not isinstance(content, dict):
            raise PipelineError("content must be a JSON object")
        return content

    async def _h_channel_message_send(self, session, cid, body):
        """Reference pipeline_channel.go channelMessageSend."""
        channels = _require(self.c.channels, "channels")
        channel_id = body.get("channel_id", "")
        self._in_channel(session, channel_id)
        content = self._message_content(body)
        try:
            message = await channels.message_send(
                channel_id,
                content,
                sender_id=session.user_id,
                sender_username=session.username,
            )
        except ChannelError as e:
            raise PipelineError(str(e)) from e
        self._message_ack(session, cid, message)

    async def _h_channel_message_update(self, session, cid, body):
        channels = _require(self.c.channels, "channels")
        channel_id = body.get("channel_id", "")
        self._in_channel(session, channel_id)
        content = self._message_content(body)
        try:
            message = await channels.message_update(
                channel_id,
                body.get("message_id", ""),
                content,
                sender_id=session.user_id,
                sender_username=session.username,
            )
        except ChannelError as e:
            raise PipelineError(str(e)) from e
        self._message_ack(session, cid, message)

    async def _h_channel_message_remove(self, session, cid, body):
        channels = _require(self.c.channels, "channels")
        channel_id = body.get("channel_id", "")
        self._in_channel(session, channel_id)
        try:
            message = await channels.message_remove(
                channel_id,
                body.get("message_id", ""),
                sender_id=session.user_id,
                sender_username=session.username,
            )
        except ChannelError as e:
            raise PipelineError(str(e)) from e
        self._message_ack(session, cid, message)

    def _message_ack(self, session, cid, message: dict):
        """`channel_message_ack` as the JAX handlers build it: the
        message's ids and code, the sender's username, its times (a send
        has a create_time) and persistence."""
        ack = {k: message[k] for k in ("channel_id", "message_id", "code")}
        ack["username"] = session.username
        for k in ("create_time", "update_time", "persistent"):
            if k in message:
                ack[k] = message[k]
        out: dict = {"channel_message_ack": ack}
        if cid:
            out["cid"] = cid
        session.send(out)

    # ----------------------------------------------------------------- rpc

    async def _h_rpc(self, session, cid, body):
        runtime = _require(self.c.runtime, "runtime")
        rpc_id = (body.get("id") or "").lower()
        fn = runtime.rpc(rpc_id)
        if fn is None:
            raise PipelineError(
                f"RPC function not found: {rpc_id}",
                ErrorCode.RUNTIME_FUNCTION_NOT_FOUND,
            )
        payload = body.get("payload", "")
        try:
            result = await _maybe_await(
                fn(
                    runtime.session_context(session),
                    payload,
                )
            )
        except Exception as e:
            raise PipelineError(
                str(e), ErrorCode.RUNTIME_FUNCTION_EXCEPTION
            ) from e
        out: dict = {"rpc": {"id": rpc_id, "payload": result or ""}}
        if cid:
            out["cid"] = cid
        session.send(out)


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

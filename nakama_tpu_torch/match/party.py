"""Parties: shared lobby groups with leader election and party matchmaking.

Parity with the reference PartyRegistry/PartyHandler (reference
server/party_registry.go:1-214, server/party_handler.go:1-647): open/closed
parties with max size, leader = first joiner with oldest-member promotion on
leader departure (:157-187, 277-300), join requests + leader-gated
accept/remove, party data relay (:598), and party matchmaking — the leader
submits ONE ticket carrying every member's presence (:540-578); any
membership change cancels the party's tickets (:240, :308).
"""

from __future__ import annotations

import uuid

from ..logger import Logger
from ..realtime import (
    Presence,
    PresenceID,
    PresenceMeta,
    Stream,
    StreamMode,
)


class PartyError(Exception):
    pass


class PartyHandler:
    # Cross-node proxies (cluster/ops.py RemotePartyHandler) flip this;
    # the pipeline uses it to skip local membership side effects that
    # the authority node performs instead.
    is_remote = False

    def __init__(
        self,
        logger: Logger,
        registry,
        party_id: str,
        open_: bool,
        max_size: int,
    ):
        self.logger = logger.with_fields(subsystem="party", pid=party_id)
        self.registry = registry
        self.party_id = party_id
        self.open = open_
        self.max_size = max_size
        self.stream = Stream(StreamMode.PARTY, subject=party_id)
        self.leader: Presence | None = None
        # Ordered membership (insertion order = join order for promotion).
        self.members: dict[PresenceID, Presence] = {}
        self.join_requests: dict[str, tuple[Presence, PresenceMeta]] = {}
        self.tickets: set[str] = set()

    @property
    def tracker(self):
        return self.registry.tracker

    @property
    def router(self):
        return self.registry.router

    def as_dict(self) -> dict:
        return {
            "party_id": self.party_id,
            "open": self.open,
            "max_size": self.max_size,
            "self": None,
            "leader": self.leader.as_dict() if self.leader else None,
            "presences": [p.as_dict() for p in self.members.values()],
        }

    # -------------------------------------------------------------- joins

    def can_accept(self) -> bool:
        return len(self.members) + len(self.join_requests) < self.max_size

    def request_join(self, presence: Presence) -> bool:
        """Returns True if immediately allowed (open party with room); False
        queues a join request for the leader (closed party)."""
        if self.open:
            if len(self.members) >= self.max_size:
                raise PartyError("party full")
            return True
        if not self.can_accept():
            raise PartyError("party full")
        self.join_requests[presence.id.session_id] = (
            presence,
            PresenceMeta(username=presence.meta.username),
        )
        if self.leader is not None:
            self.router.send_to_presence_ids(
                [self.leader.id],
                {
                    "party_join_request": {
                        "party_id": self.party_id,
                        "presences": [presence.as_dict()],
                    }
                },
            )
        return False

    def accept(self, leader_session: str, presence_dict: dict) -> Presence:
        """Leader accepts a pending join request."""
        self._require_leader(leader_session)
        sid = presence_dict.get("session_id", "")
        if sid not in self.join_requests:
            raise PartyError("no such join request")
        if len(self.members) >= self.max_size:
            # Keep the request queued so it can be accepted once there is
            # room again.
            raise PartyError("party full")
        return self.join_requests.pop(sid)[0]

    def remove(self, leader_session: str, presence_dict: dict) -> Presence | None:
        """Leader removes a member or declines a join request."""
        self._require_leader(leader_session)
        sid = presence_dict.get("session_id", "")
        entry = self.join_requests.pop(sid, None)
        if entry is not None:
            return None  # declined a request; nothing tracked yet
        for pid, p in self.members.items():
            if pid.session_id == sid:
                return p
        raise PartyError("not a member")

    def join_request_list(self, leader_session: str) -> list[Presence]:
        """Leader-only list of pending join requests (reference
        party_handler.go:519-527)."""
        self._require_leader(leader_session)
        return [p for p, _ in self.join_requests.values()]

    def promote(self, leader_session: str, presence_dict: dict) -> Presence:
        self._require_leader(leader_session)
        sid = presence_dict.get("session_id", "")
        for pid, p in self.members.items():
            if pid.session_id == sid:
                self._set_leader(p)
                return p
        raise PartyError("not a member")

    def _require_leader(self, session_id: str):
        if self.leader is None or self.leader.id.session_id != session_id:
            raise PartyError("only the party leader may do that")

    def _set_leader(self, presence: Presence):
        self.leader = presence
        self.router.send_to_stream(
            self.stream,
            {
                "party_leader": {
                    "party_id": self.party_id,
                    "presence": presence.as_dict(),
                }
            },
        )

    # ------------------------------------------------- membership listener

    def on_joins(self, joins: list[Presence]):
        """Idempotent: the pipeline applies joins synchronously at track time
        and the tracker pump re-delivers them."""
        new = [p for p in joins if p.id not in self.members]
        for p in new:
            self.members[p.id] = p
        if self.leader is None and self.members:
            self._set_leader(next(iter(self.members.values())))
        if new:
            self._cancel_tickets()

    def on_leaves(self, leaves: list[Presence]):
        removed = False
        for p in leaves:
            removed |= self.members.pop(p.id, None) is not None
        if removed:
            self._cancel_tickets()
        if not self.members:
            self.registry.remove(self.party_id)
            return
        if self.leader is not None and any(
            p.id == self.leader.id for p in leaves
        ):
            # Oldest remaining member becomes leader (party_handler.go:277).
            self._set_leader(next(iter(self.members.values())))

    def _cancel_tickets(self):
        """Membership changes invalidate in-flight party tickets."""
        mm = self.registry.matchmaker
        if mm is None or not self.tickets:
            self.tickets.clear()
            return
        mm.remove_party_all(self.party_id)
        self.tickets.clear()

    # --------------------------------------------------------- matchmaking

    def matchmaker_add(
        self,
        session_id: str,
        query: str,
        min_count: int,
        max_count: int,
        count_multiple: int = 1,
        string_properties: dict | None = None,
        numeric_properties: dict | None = None,
    ) -> str:
        """Leader-only: one ticket for the whole party (party_handler.go:540)."""
        self._require_leader(session_id)
        mm = self.registry.matchmaker
        if mm is None:
            raise PartyError("matchmaker not available")
        from ..matchmaker import MatchmakerPresence

        presences = [
            MatchmakerPresence(
                user_id=p.user_id,
                session_id=p.id.session_id,
                username=p.meta.username,
                # Cross-node parties: matched delivery routes each
                # member's envelope by its ORIGIN node, so the ticket
                # must carry it (empty = the pool's local default).
                node=p.id.node,
            )
            for p in self.members.values()
        ]
        ticket, _ = mm.add(
            presences,
            "",
            self.party_id,
            query,
            min_count,
            max_count,
            count_multiple,
            string_properties or {},
            numeric_properties or {},
        )
        self.tickets.add(ticket)
        return ticket

    def matchmaker_remove(self, session_id: str, ticket: str):
        self._require_leader(session_id)
        mm = self.registry.matchmaker
        if mm is None:
            raise PartyError("matchmaker not available")
        mm.remove_party(self.party_id, ticket)
        self.tickets.discard(ticket)

    def close(self, leader_session: str, tracker):
        """Leader closes the party: cancel tickets first (the registry entry
        disappears before the pump's leave events arrive), then untrack all
        members — routed per member node on a clustered registry (a
        cross-node member's untrack must run on the node that owns its
        session; the `tracker` parameter stays for call compatibility)."""
        self._require_leader(leader_session)
        self._cancel_tickets()
        for p in list(self.members.values()):
            self.registry.untrack_presence(p, self.stream)

    # ---------------------------------------------------------------- data

    def data_send(self, sender_session: str, op_code: int, data: str):
        sender = None
        for pid, p in self.members.items():
            if pid.session_id == sender_session:
                sender = p
                break
        if sender is None:
            raise PartyError("not a member")
        self.router.send_to_stream(
            self.stream,
            {
                "party_data": {
                    "party_id": self.party_id,
                    "presence": sender.as_dict(),
                    "op_code": op_code,
                    "data": data,
                }
            },
        )


class LocalPartyRegistry:
    def __init__(
        self,
        logger: Logger,
        tracker,
        router,
        matchmaker=None,
        node: str = "local",
        max_party_size: int = 256,
    ):
        self.logger = logger.with_fields(subsystem="party_registry")
        self.tracker = tracker
        self.router = router
        self.matchmaker = matchmaker
        self.node = node
        self.max_party_size = max_party_size
        self._parties: dict[str, PartyHandler] = {}

    def __len__(self) -> int:
        return len(self._parties)

    def create(self, open_: bool, max_size: int) -> PartyHandler:
        if not (1 <= max_size <= self.max_party_size):
            raise PartyError("invalid party max size")
        party_id = f"{uuid.uuid4()}.{self.node}"
        handler = PartyHandler(self.logger, self, party_id, open_, max_size)
        self._parties[party_id] = handler
        return handler

    def get(self, party_id: str) -> PartyHandler | None:
        return self._parties.get(party_id)

    def remove(self, party_id: str):
        self._parties.pop(party_id, None)

    def untrack_presence(self, presence: Presence, stream: Stream):
        """Untrack one member's presence. Node-local here; the cluster
        registry overrides this to route by the session's owning node."""
        self.tracker.untrack(presence.id.session_id, stream)

    def join_listener(self):
        """Tracker listener for PARTY streams (reference main.go:162-163)."""

        def on_event(joins: list[Presence], leaves: list[Presence]):
            by_party_j: dict[str, list[Presence]] = {}
            by_party_l: dict[str, list[Presence]] = {}
            for p in joins:
                by_party_j.setdefault(p.stream.subject, []).append(p)
            for p in leaves:
                by_party_l.setdefault(p.stream.subject, []).append(p)
            for party_id, ps in by_party_j.items():
                handler = self._parties.get(party_id)
                if handler is not None:
                    handler.on_joins(ps)
            for party_id, ps in by_party_l.items():
                handler = self._parties.get(party_id)
                if handler is not None:
                    handler.on_leaves(ps)

        return on_event

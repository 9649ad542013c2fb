"""Matchmaker matched-event routing.

Parity with the tail of the reference Process loop (reference
server/matchmaker.go:377-435): for each formed match, consult the runtime's
MatchmakerMatched hook — a returned match id sends users to an authoritative
match; otherwise mint a short-lived match token (30s JWT naming every user)
for relayed-match rendezvous — then route a `matchmaker_matched` envelope to
every matched presence.

The port's copy of the JAX package's `api/matchmaker_events.py`. It
iterates the port's columnar `MatchBatch`, whose entry lists materialize
per match as the loop reaches them, and calls the runtime's
`matchmaker_matched` hook (when one is registered) once for each group,
on the loop's thread, with that group's `MatchmakerEntry` list.
"""

from __future__ import annotations

from typing import Any

from ..logger import Logger
from ..matchmaker.types import MatchmakerEntry
from ..realtime import PresenceID
from . import session_token

MATCH_TOKEN_EXPIRY_SEC = 30


def make_matched_handler(
    logger: Logger,
    router: Any,
    node: str,
    encryption_key: str,
    runtime: Any = None,
):
    log = logger.with_fields(subsystem="matchmaker.matched")

    def on_matched(matched: list[list[MatchmakerEntry]]):
        for entries in matched:
            ticket_of = {e.presence.session_id: e.ticket for e in entries}
            match_id = ""
            if runtime is not None:
                hook = runtime.matchmaker_matched()
                if hook is not None:
                    try:
                        match_id = hook(entries) or ""
                    except Exception as e:
                        log.error("matchmaker matched hook error", error=str(e))

            if not match_id:
                import uuid as _uuid

                user_list = ",".join(
                    sorted(
                        f"{e.presence.user_id}:{e.presence.username}"
                        for e in entries
                    )
                )
                # The token names a relayed-match rendezvous id every matched
                # client can join (reference matchmaker.go:392-399).
                rendezvous = f"{_uuid.uuid4()}.{node}"
                token, _ = session_token.generate(
                    encryption_key,
                    user_list,
                    "",
                    MATCH_TOKEN_EXPIRY_SEC,
                    vars={
                        "kind": "match_token",
                        "node": node,
                        "mid": rendezvous,
                    },
                )

            users = [
                {
                    "presence": e.presence.as_dict(),
                    "party_id": e.party_id,
                    "string_properties": e.string_properties,
                    "numeric_properties": e.numeric_properties,
                }
                for e in entries
            ]
            for entry in entries:
                body: dict = {
                    "ticket": ticket_of[entry.presence.session_id],
                    "users": users,
                    "self": {"presence": entry.presence.as_dict()},
                }
                if match_id:
                    body["match_id"] = match_id
                else:
                    body["token"] = token
                # Cluster: a forwarded ticket's presences carry their
                # origin node — route the envelope there (the cluster
                # router ships it over the bus; single-node presences
                # carry no node and stay local).
                router.send_to_presence_ids(
                    [
                        PresenceID(
                            entry.presence.node or node,
                            entry.presence.session_id,
                        )
                    ],
                    {"matchmaker_matched": body},
                )

    return on_matched

"""Realtime protocol envelopes (JSON representation).

The envelope is a dict with an optional "cid" and exactly one message key —
the JSON shape of the reference's 50-variant Envelope oneof (reference
nakama-common rtapi/realtime.proto:37-135). MESSAGE_KEYS enumerates the
client→server and server→client variants; the pipeline validates membership
before dispatch.

The port's copy of the JAX package's `api/envelope.py`. The dict envelope
is the canonical in-process representation; api/protocol.py maps it to
the socket's encoding (JSON in the port).
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Reference rtapi Error.Code."""

    RUNTIME_EXCEPTION = 0
    UNRECOGNIZED_PAYLOAD = 1
    MISSING_PAYLOAD = 2
    BAD_INPUT = 3
    MATCH_NOT_FOUND = 4
    MATCH_JOIN_REJECTED = 5
    RUNTIME_FUNCTION_NOT_FOUND = 6
    RUNTIME_FUNCTION_EXCEPTION = 7


# Client → server request variants (dispatched by the pipeline).
REQUEST_KEYS = frozenset(
    {
        "channel_join",
        "channel_leave",
        "channel_message_send",
        "channel_message_update",
        "channel_message_remove",
        "match_create",
        "match_data_send",
        "match_join",
        "match_leave",
        "matchmaker_add",
        "matchmaker_remove",
        "party_create",
        "party_join",
        "party_leave",
        "party_promote",
        "party_accept",
        "party_remove",
        "party_close",
        "party_join_request_list",
        "party_matchmaker_add",
        "party_matchmaker_remove",
        "party_data_send",
        "ping",
        "pong",
        "rpc",
        "status_follow",
        "status_unfollow",
        "status_update",
    }
)

# Server → client variants (for documentation/validation of outgoing sends).
RESPONSE_KEYS = frozenset(
    {
        "channel",
        "channel_message",
        "channel_message_ack",
        "channel_presence_event",
        "error",
        "match",
        "match_data",
        "match_presence_event",
        "matchmaker_matched",
        "matchmaker_ticket",
        "notifications",
        "party",
        "party_join_request",
        "party_leader",
        "party_matchmaker_ticket",
        "party_presence_event",
        "party_data",
        "rpc",
        "status",
        "status_presence_event",
        "status_update",
        "stream_data",
        "stream_presence_event",
        "pong",
        "ping",
    }
)


def message_key(envelope: dict) -> str | None:
    """The single message variant key of an envelope, or None."""
    keys = [k for k in envelope if k != "cid"]
    if len(keys) != 1:
        return None
    return keys[0]


def error(
    code: ErrorCode, message: str, cid: str = "", context: dict | None = None
) -> dict:
    out: dict = {
        "error": {"code": int(code), "message": message}
    }
    if context:
        out["error"]["context"] = context
    if cid:
        out["cid"] = cid
    return out

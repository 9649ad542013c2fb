"""Wire format of the realtime envelope: JSON.

The dict envelope (api/envelope.py) is the canonical in-process
representation; this module maps it to the socket's encoding. The port
speaks `format=json` only: the JAX package's `format=protobuf` bridges
through `google.protobuf`, which the port does not use, so the acceptor
refuses that format at accept time (close 4000 "unsupported format", the
JAX acceptor's answer for a format it does not support) until a later
slice encodes the rtapi envelope itself.
"""

from __future__ import annotations

import json
from typing import Union

FORMAT_JSON = "json"
SUPPORTED_FORMATS = (FORMAT_JSON,)

Wire = Union[str, bytes]


class ProtocolError(ValueError):
    """Malformed inbound frame for the negotiated encoding."""


def encode(envelope: dict, fmt: str) -> Wire:
    if fmt != FORMAT_JSON:
        raise ProtocolError(f"unsupported format: {fmt}")
    return json.dumps(envelope)


def decode(raw: Wire, fmt: str) -> dict:
    if fmt != FORMAT_JSON:
        raise ProtocolError(f"unsupported format: {fmt}")
    try:
        envelope = json.loads(raw)
    except ValueError as e:
        raise ProtocolError(str(e)) from e
    if not isinstance(envelope, dict):
        raise ProtocolError("not an object")
    return envelope

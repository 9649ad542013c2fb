"""Wire-format codecs for the realtime envelope.

The JSON dict envelope (api/envelope.py) is the canonical in-process
representation; this module maps it to the socket's negotiated
encoding. `format=json` is a passthrough; `format=protobuf` goes
through the port's own rtapi codec (`nakama_tpu_torch/proto`), which
gives the bytes and dicts that the JAX package's `protocol.py` gets
from `google.protobuf.json_format`, so the pipeline, router and every
handler stay encoding-agnostic: one encode and one decode site per
socket (session_ws.py). A format outside `SUPPORTED_FORMATS` is refused
at accept time (close 4000 "unsupported format").
"""

from __future__ import annotations

import json
from typing import Union

from ..proto import EncodeError, ProtocolError, decode_envelope, encode_envelope

FORMAT_JSON = "json"
FORMAT_PROTOBUF = "protobuf"
SUPPORTED_FORMATS = (FORMAT_JSON, FORMAT_PROTOBUF)

Wire = Union[str, bytes]

__all__ = [
    "EncodeError", "FORMAT_JSON", "FORMAT_PROTOBUF", "ProtocolError",
    "SUPPORTED_FORMATS", "decode", "encode",
]


def encode(envelope: dict, fmt: str) -> Wire:
    if fmt == FORMAT_JSON:
        return json.dumps(envelope)
    if fmt == FORMAT_PROTOBUF:
        # Unknown keys are dropped (the JAX codec's ignore_unknown_fields):
        # an outgoing dict carrying a field the schema has not caught up
        # with degrades for binary clients rather than killing the socket.
        return encode_envelope(envelope)
    raise ProtocolError(f"unsupported format: {fmt}")


def decode(raw: Wire, fmt: str) -> dict:
    if fmt == FORMAT_JSON:
        try:
            envelope = json.loads(raw)
        except ValueError as e:
            raise ProtocolError(str(e)) from e
        if not isinstance(envelope, dict):
            raise ProtocolError("not an object")
        return envelope
    if fmt == FORMAT_PROTOBUF:
        if isinstance(raw, str):
            raw = raw.encode()
        return decode_envelope(raw)
    raise ProtocolError(f"unsupported format: {fmt}")

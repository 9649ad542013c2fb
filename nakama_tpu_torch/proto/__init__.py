"""The port's own rtapi codec: `format=protobuf` without `google.protobuf`.

`rtapi.proto` is the port's copy of the JAX package's schema;
`schema.py` reads it, `wire.py` is the protobuf wire format over the
plain dict messages it describes, and `json_map.py` the proto3 JSON
mapping between those dicts and the JSON envelope. `encode_envelope`
and `decode_envelope` are what the JAX package's `protocol.py` does
with `json_format` and `rtapi_pb2.Envelope`: the same bytes (wherever
the upb runtime's map order does not decide them) and the same dicts.
"""

from __future__ import annotations

from . import json_map, schema, wire
from .json_map import EncodeError
from .wire import ProtocolError

__all__ = [
    "EncodeError",
    "ProtocolError",
    "decode_envelope",
    "encode_envelope",
    "envelope_schema",
]


def envelope_schema() -> schema.Message:
    return schema.rtapi().message("Envelope")


def encode_envelope(envelope: dict) -> bytes:
    """`ParseDict(envelope, Envelope(), ignore_unknown_fields=True)
    .SerializeToString()`; raises `EncodeError` where `ParseDict`
    raises."""
    env = envelope_schema()
    return wire.encode(json_map.from_json(envelope, env), env)


def decode_envelope(raw: bytes) -> dict:
    """`MessageToDict(Envelope.FromString(raw),
    preserving_proto_field_name=True)`; raises `ProtocolError` for a
    frame that is not an Envelope."""
    env = envelope_schema()
    return json_map.to_json(wire.decode(raw, env), env)

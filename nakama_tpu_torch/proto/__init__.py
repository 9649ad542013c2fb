"""The port's own protobuf codec: `format=protobuf` sockets and the gRPC
front door without `google.protobuf`.

`rtapi.proto` and `api.proto` are the port's copies of the JAX
package's schemas; `schema.py` reads them, `wire.py` is the protobuf
wire format over the plain dict messages they describe, and
`json_map.py` the proto3 JSON mapping between those dicts and JSON.
`encode_envelope` and `decode_envelope` are what the JAX package's
`protocol.py` does with `json_format` and `rtapi_pb2.Envelope`;
`encode_message` and `decode_message` the same for any message of
`api.proto` by name, as the JAX gRPC gateway does with `api_pb2`: the
same bytes (wherever the upb runtime's map order does not decide them)
and the same dicts.
"""

from __future__ import annotations

from . import json_map, schema, wire
from .json_map import EncodeError
from .wire import ProtocolError

__all__ = [
    "EncodeError",
    "ProtocolError",
    "decode_envelope",
    "decode_message",
    "encode_envelope",
    "encode_message",
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


def encode_message(name: str, message: dict) -> bytes:
    """`ParseDict(message, api_pb2.<name>(), ignore_unknown_fields=True)
    .SerializeToString()` for a message of `api.proto` (by its name in
    the package or its full name); raises `EncodeError` where
    `ParseDict` raises."""
    msg = schema.api().message(name)
    return wire.encode(json_map.from_json(message, msg), msg)


def decode_message(name: str, raw: bytes) -> dict:
    """`MessageToDict(api_pb2.<name>.FromString(raw),
    preserving_proto_field_name=True)`; raises `ProtocolError` for bytes
    that are not such a message."""
    msg = schema.api().message(name)
    return json_map.to_json(wire.decode(raw, msg), msg)

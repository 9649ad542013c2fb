"""The protobuf wire format over a `schema.Message`.

A message travels here as a plain dict of the fields it holds: a scalar
as its Python value (str, bytes, bool, int, float; an enum as its
number), a sub-message as a dict, a repeated field as a list and a map
as a dict of key to value. `encode` writes what `SerializeToString`
writes for such a message: fields in field-number order, as the upb
runtime writes them; proto3 scalars at their default left out (a
double is default only as +0.0, bit for bit), a oneof member and a set
sub-message always written, map entries with both key and value, and
repeated numbers packed. `decode` reads what `FromString` reads:

- varints of up to ten bytes (an `int32` keeps the low 32 bits, so a
  negative one is ten bytes on the wire, as is a negative `int64`), 64-bit little-endian doubles,
  length-delimited strings (UTF-8 checked), bytes and sub-messages;
- a sub-message seen twice merges, a later oneof member clears the
  earlier one, a map entry's key repeats to the last value, and a map
  entry that holds an unknown field is left out of the map;
- repeated numbers packed or not;
- a field of unknown number, or of a known number on an unexpected wire
  type, skipped by its wire type (groups included);
- truncated input, a varint over ten bytes, field number 0, an end-group
  tag with no group open, wire types 6 and 7, invalid UTF-8 in a string
  and nesting more than 100 messages or groups below the top one:
  `ProtocolError`.
"""

from __future__ import annotations

import struct

from .schema import (
    TYPE_BOOL,
    TYPE_BYTES,
    TYPE_DOUBLE,
    TYPE_ENUM,
    TYPE_INT32,
    TYPE_INT64,
    TYPE_MESSAGE,
    TYPE_STRING,
    Message,
)

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_LEN = 2
WIRE_START_GROUP = 3
WIRE_END_GROUP = 4
WIRE_FIXED32 = 5

MAX_DEPTH = 100

_WIRE_OF = {
    TYPE_DOUBLE: WIRE_FIXED64,
    TYPE_INT32: WIRE_VARINT,
    TYPE_INT64: WIRE_VARINT,
    TYPE_BOOL: WIRE_VARINT,
    TYPE_ENUM: WIRE_VARINT,
    TYPE_STRING: WIRE_LEN,
    TYPE_BYTES: WIRE_LEN,
    TYPE_MESSAGE: WIRE_LEN,
}
_PACKABLE = (TYPE_DOUBLE, TYPE_INT32, TYPE_INT64, TYPE_BOOL, TYPE_ENUM)
_DOUBLE = struct.Struct("<d")
_ZERO_DOUBLE = _DOUBLE.pack(0.0)


class ProtocolError(ValueError):
    """Malformed inbound frame for the negotiated encoding."""


# ------------------------------------------------------------------ encode


def _varint(n: int, out: bytearray) -> None:
    n &= 0xFFFF_FFFF_FFFF_FFFF  # a negative int32/int64: 64-bit two's complement
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _is_default(ftype: int, value) -> bool:
    if ftype == TYPE_DOUBLE:
        return _DOUBLE.pack(value) == _ZERO_DOUBLE
    return not value


def _scalar(ftype: int, value, out: bytearray) -> None:
    if ftype == TYPE_DOUBLE:
        out += _DOUBLE.pack(value)
    elif ftype in (TYPE_INT32, TYPE_INT64, TYPE_ENUM, TYPE_BOOL):
        _varint(int(value), out)
    else:
        data = value.encode("utf-8") if ftype == TYPE_STRING else value
        _varint(len(data), out)
        out += data


def _value(f, value, out: bytearray) -> None:
    """One occurrence of field `f` (tag included)."""
    _varint(f.number << 3 | _WIRE_OF[f.type], out)
    if f.type == TYPE_MESSAGE:
        body = encode(value, f.message)
        _varint(len(body), out)
        out += body
    else:
        _scalar(f.type, value, out)


def encode(msg: dict, schema: Message) -> bytes:
    out = bytearray()
    for f in schema.ordered:
        if f.name not in msg:
            continue
        value = msg[f.name]
        if f.is_map:
            key_f, val_f = f.message.ordered
            for k, v in value.items():
                entry = bytearray()
                _value(key_f, k, entry)
                _value(val_f, v, entry)
                _varint(f.number << 3 | WIRE_LEN, out)
                _varint(len(entry), out)
                out += entry
        elif f.repeated:
            if not value:
                continue
            if f.type in _PACKABLE:
                body = bytearray()
                for v in value:
                    _scalar(f.type, v, body)
                _varint(f.number << 3 | WIRE_LEN, out)
                _varint(len(body), out)
                out += body
            else:
                for v in value:
                    _value(f, v, out)
        elif f.type == TYPE_MESSAGE or f.oneof or not _is_default(f.type, value):
            _value(f, value, out)
    return bytes(out)


# ------------------------------------------------------------------ decode


class _Buf:
    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int, end: int):
        self.data = data
        self.pos = pos
        self.end = end

    def varint(self) -> int:
        data, pos, end = self.data, self.pos, self.end
        result = shift = 0
        for _ in range(10):
            if pos >= end:
                raise ProtocolError("truncated varint")
            b = data[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                self.pos = pos
                return result & 0xFFFF_FFFF_FFFF_FFFF
            shift += 7
        raise ProtocolError("varint longer than ten bytes")

    def take(self, n: int) -> int:
        start = self.pos
        if n > self.end - start:
            raise ProtocolError("field runs past the end of its message")
        self.pos = start + n
        return start

    def length(self) -> int:
        n = self.varint()
        if n > 0x7FFF_FFFF:
            raise ProtocolError("length out of range")
        return n


def _tag(buf: _Buf) -> tuple[int, int]:
    tag = buf.varint()
    if tag > 0xFFFF_FFFF:
        raise ProtocolError("tag out of range")
    number, wire = tag >> 3, tag & 7
    if number == 0:
        raise ProtocolError("field number 0")
    return number, wire


def _skip(buf: _Buf, number: int, wire: int, depth: int) -> None:
    if wire == WIRE_VARINT:
        buf.varint()
    elif wire == WIRE_FIXED64:
        buf.take(8)
    elif wire == WIRE_LEN:
        buf.take(buf.length())
    elif wire == WIRE_FIXED32:
        buf.take(4)
    elif wire == WIRE_START_GROUP:
        depth += 1
        if depth > MAX_DEPTH:
            raise ProtocolError("nesting too deep")
        while True:
            if buf.pos >= buf.end:
                raise ProtocolError("unterminated group")
            n, w = _tag(buf)
            if w == WIRE_END_GROUP:
                if n != number:
                    raise ProtocolError("mismatched end-group tag")
                return
            _skip(buf, n, w, depth)
    else:
        raise ProtocolError(f"invalid wire type {wire}")


def _int32(n: int) -> int:
    n &= 0xFFFF_FFFF
    return n - (1 << 32) if n & 0x8000_0000 else n


def _read_scalar(buf: _Buf, ftype: int):
    if ftype == TYPE_DOUBLE:
        start = buf.take(8)
        return _DOUBLE.unpack_from(buf.data, start)[0]
    if ftype == TYPE_BOOL:
        return buf.varint() != 0
    if ftype in (TYPE_INT32, TYPE_ENUM):
        return _int32(buf.varint())
    if ftype == TYPE_INT64:
        n = buf.varint()
        return n - (1 << 64) if n >> 63 else n
    n = buf.length()
    start = buf.take(n)
    raw = bytes(buf.data[start:start + n])
    if ftype == TYPE_BYTES:
        return raw
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ProtocolError("string is not valid UTF-8") from e


def _default(f):
    if f.type == TYPE_MESSAGE:
        return {}
    return {TYPE_DOUBLE: 0.0, TYPE_STRING: "", TYPE_BYTES: b"",
            TYPE_BOOL: False}.get(f.type, 0)


def _decode_into(
    buf: _Buf, schema: Message, out: dict, depth: int
) -> bool:
    """Read one message's fields into `out`; True if any was skipped as
    unknown."""
    if depth > MAX_DEPTH:
        raise ProtocolError("nesting too deep")
    unknown = False
    while buf.pos < buf.end:
        number, wire = _tag(buf)
        if wire == WIRE_END_GROUP:
            raise ProtocolError("end-group tag with no group open")
        f = schema.by_number.get(number)
        if f is None:
            _skip(buf, number, wire, depth)
            unknown = True
            continue
        want = _WIRE_OF[f.type]
        if f.repeated and f.type in _PACKABLE and wire == WIRE_LEN:
            n = buf.length()
            start = buf.take(n)
            packed = _Buf(buf.data, start, start + n)
            items = out.setdefault(f.name, [])
            while packed.pos < packed.end:
                items.append(_read_scalar(packed, f.type))
            continue
        if wire != want:
            _skip(buf, number, wire, depth)
            unknown = True
            continue
        if f.type == TYPE_MESSAGE:
            n = buf.length()
            start = buf.take(n)
            sub = _Buf(buf.data, start, start + n)
            if f.is_map:
                entry: dict = {}
                if _decode_into(sub, f.message, entry, depth + 1):
                    # An entry holding an unknown field stays out of the
                    # map (upb keeps it among the parent's unknown
                    # fields).
                    continue
                key_f, val_f = f.message.ordered
                out.setdefault(f.name, {})[
                    entry.get("key", _default(key_f))
                ] = entry.get("value", _default(val_f))
                continue
            if f.repeated:
                item: dict = {}
                out.setdefault(f.name, []).append(item)
            else:
                item = out.get(f.name)
                if item is None:
                    item = out[f.name] = {}
            _decode_into(sub, f.message, item, depth + 1)
        else:
            value = _read_scalar(buf, f.type)
            if f.repeated:
                out.setdefault(f.name, []).append(value)
                continue
            out[f.name] = value
        if f.oneof:
            for other in schema.oneofs[f.oneof]:
                if other != f.name:
                    out.pop(other, None)
    return unknown


def decode(data: bytes, schema: Message) -> dict:
    out: dict = {}
    _decode_into(_Buf(memoryview(data), 0, len(data)), schema, out, 0)
    return out

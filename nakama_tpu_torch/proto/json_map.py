"""The proto3 JSON mapping, as `google.protobuf.json_format` applies it.

`from_json(js, schema)` is `ParseDict(js, Message(),
ignore_unknown_fields=True)` and `to_json(msg, schema)` is
`MessageToDict(msg, preserving_proto_field_name=True)`, over the plain
dict messages of `wire.py`. What each keeps of `json_format`:

- Output leaves out proto3 scalars at their default, and empty
  repeated and map fields; a sub-message or oneof member that is set
  comes out even when empty (`"ping": {}`). `bytes` come out as
  standard base64 with padding; a double that is not finite as "NaN",
  "Infinity" or "-Infinity"; an `int64` as a decimal string.
- Input takes a field by its proto name or its lowerCamelCase JSON
  name, and skips unknown keys at every depth. `bytes` accept both
  base64 alphabets and missing padding, and take characters outside
  the alphabet as `json_format` does (dropped: `"!!"` is empty bytes).
  `int32` and `int64` accept numeric strings and integral floats and
  refuse 1.5, booleans and values outside their width; a double accepts numbers,
  numeric strings and "NaN"/"Infinity"/"-Infinity"; a bool only a
  boolean; a string only a string without unpaired surrogates. `null`
  clears a field (or sets `null_value` in a `Value`).
- `google.protobuf.Struct`, `Value` and `ListValue` map to plain JSON; a
  Struct number comes back as a float, and a number that is not finite
  cannot go out (`json_format` raises for it too). A wrapper
  (`google.protobuf.Int32Value`, `BoolValue`, ...) maps to its bare
  value, and a wrapper that is set comes out even at zero (`"state": 0`
  is a filter, an absent `state` none).
- Two members of one oneof in one object, a key given twice under its
  two names, a `[name]` extension key, a list where an object belongs
  or the reverse: refused, as `ParseDict` refuses them.

Encode errors are `EncodeError`; an output error is `ProtocolError`.
"""

from __future__ import annotations

import base64
import math
import re

from .schema import (
    TYPE_BOOL,
    TYPE_BYTES,
    TYPE_DOUBLE,
    TYPE_ENUM,
    TYPE_INT32,
    TYPE_INT64,
    TYPE_MESSAGE,
    TYPE_STRING,
    WRAPPERS,
    Message,
)
from .wire import ProtocolError

MAX_RECURSION_DEPTH = 100

STRUCT = "google.protobuf.Struct"
VALUE = "google.protobuf.Value"
LIST_VALUE = "google.protobuf.ListValue"
NULL_VALUE = "google.protobuf.NullValue"

_EXTENSION_NAME = re.compile(r"\[[a-zA-Z0-9\._]*\]$")
_UNPAIRED_SURROGATE = re.compile(
    "[\ud800-\udbff](?![\udc00-\udfff])|(?<![\ud800-\udbff])[\udc00-\udfff]"
)
_INT_RANGE = {
    TYPE_INT32: (-(1 << 31), (1 << 31) - 1),
    TYPE_ENUM: (-(1 << 31), (1 << 31) - 1),
    TYPE_INT64: (-(1 << 63), (1 << 63) - 1),
}


class EncodeError(ValueError):
    """A dict the proto3 JSON mapping refuses for this message."""


# ------------------------------------------------------------------ output


def _double_out(value: float):
    if math.isinf(value):
        return "-Infinity" if value < 0 else "Infinity"
    if math.isnan(value):
        return "NaN"
    return value


def _scalar_out(ftype: int, value):
    if ftype == TYPE_BYTES:
        return base64.b64encode(value).decode("utf-8")
    if ftype == TYPE_DOUBLE:
        return _double_out(value)
    if ftype == TYPE_INT64:
        return str(value)
    return value


def _value_out(v: dict):
    """A `google.protobuf.Value` as plain JSON."""
    if "list_value" in v:
        return [_value_out(x) for x in v["list_value"].get("values", [])]
    if "struct_value" in v:
        return _struct_out(v["struct_value"])
    if "number_value" in v:
        n = v["number_value"]
        if math.isinf(n) or math.isnan(n):
            raise ProtocolError(
                "Value.number_value is not finite (it would read back as"
                " a string)"
            )
        return n
    if "string_value" in v:
        return v["string_value"]
    if "bool_value" in v:
        return v["bool_value"]
    return None  # null_value, or no kind set


def _struct_out(s: dict) -> dict:
    return {k: _value_out(v) for k, v in s.get("fields", {}).items()}


def _field_out(f, value):
    if f.type != TYPE_MESSAGE:
        return _scalar_out(f.type, value)
    return _message_out(value, f.message)


def _message_out(msg: dict, schema: Message):
    name = schema.full_name
    if name == STRUCT:
        return _struct_out(msg)
    if name == VALUE:
        return _value_out(msg)
    if name == LIST_VALUE:
        return [_value_out(x) for x in msg.get("values", [])]
    if name in WRAPPERS:
        f = schema.by_name["value"]
        return _scalar_out(f.type, msg.get("value", _ZERO[f.type]))
    out: dict = {}
    for f in schema.ordered:
        if f.name not in msg:
            continue
        value = msg[f.name]
        if f.is_map:
            if value:
                val_f = f.message.ordered[1]
                out[f.name] = {str(k): _field_out(val_f, v)
                               for k, v in value.items()}
        elif f.repeated:
            if value:
                out[f.name] = [_field_out(f, v) for v in value]
        elif f.type == TYPE_MESSAGE or f.oneof:
            out[f.name] = _field_out(f, value)
        elif f.type == TYPE_DOUBLE:
            if value != 0 or math.copysign(1.0, value) < 0 or value != value:
                out[f.name] = _double_out(value)
        elif value:
            out[f.name] = _scalar_out(f.type, value)
    return out


def to_json(msg: dict, schema: Message) -> dict:
    """`MessageToDict(msg, preserving_proto_field_name=True)`."""
    return _message_out(msg, schema)


# ------------------------------------------------------------------- input


_ZERO = {TYPE_DOUBLE: 0.0, TYPE_INT32: 0, TYPE_INT64: 0, TYPE_BOOL: False,
         TYPE_STRING: "", TYPE_BYTES: b""}


def _int_in(value, ftype: int) -> int:
    if isinstance(value, float) and not value.is_integer():
        raise EncodeError(f"Couldn't parse integer: {value}")
    if isinstance(value, str) and " " in value:
        raise EncodeError(f'Couldn\'t parse integer: "{value}"')
    if isinstance(value, bool):
        raise EncodeError(
            f"Bool value {value} is not acceptable for integer field"
        )
    try:
        n = int(value)
    except ValueError:
        f = float(value)  # a ValueError here refuses the value
        if not f.is_integer():
            raise EncodeError(
                f'Couldn\'t parse non-integer string: "{value}"'
            ) from None
        n = int(f)
    lo, hi = _INT_RANGE[ftype]
    if not lo <= n <= hi:
        raise EncodeError(f"Value out of range: {n}")
    return n


def _double_in(value) -> float:
    if isinstance(value, float) and (math.isnan(value) or math.isinf(value)):
        raise EncodeError("Couldn't parse a non-finite number; quote it")
    if value == "nan":
        raise EncodeError('Couldn\'t parse float "nan", use "NaN" instead')
    try:
        return float(value)
    except ValueError:
        special = {"-Infinity": -math.inf, "Infinity": math.inf,
                   "NaN": math.nan}
        if value in special:
            return special[value]
        raise EncodeError(f"Couldn't parse float: {value}") from None


def _scalar_in(ftype: int, value, key: bool = False):
    if ftype in _INT_RANGE:
        return _int_in(value, ftype)
    if ftype == TYPE_DOUBLE:
        return _double_in(value)
    if ftype == TYPE_BOOL:
        if key:
            if value in ("true", "false"):
                return value == "true"
            raise EncodeError(f'Expected "true" or "false", not {value}')
        if not isinstance(value, bool):
            raise EncodeError("Expected true or false without quotes")
        return value
    if ftype == TYPE_BYTES:
        encoded = value.encode("utf-8") if isinstance(value, str) else value
        padded = encoded + b"=" * (4 - len(encoded) % 4)
        return base64.urlsafe_b64decode(padded)
    if _UNPAIRED_SURROGATE.search(value):  # a non-str raises TypeError
        raise EncodeError("Unpaired surrogate")
    return value


class _Parser:
    def __init__(self):
        self.depth = 0

    def message(self, js, schema: Message) -> dict:
        self.depth += 1
        if self.depth > MAX_RECURSION_DEPTH:
            raise EncodeError(
                f"Message too deep. Max recursion depth is"
                f" {MAX_RECURSION_DEPTH}"
            )
        name = schema.full_name
        if name == STRUCT:
            out = self.struct(js)
        elif name == VALUE:
            out = self.value(js)
        elif name == LIST_VALUE:
            out = self.list_value(js)
        elif name in WRAPPERS:
            out = {"value": _scalar_in(schema.by_name["value"].type, js)}
        else:
            out = self.fields(js, schema)
        self.depth -= 1
        return out

    def value(self, js) -> dict:
        if isinstance(js, dict):
            return {"struct_value": self.struct(js)}
        if isinstance(js, (list, tuple)):
            return {"list_value": self.list_value(js)}
        if js is None:
            return {"null_value": 0}
        if isinstance(js, bool):
            return {"bool_value": js}
        if isinstance(js, str):
            return {"string_value": js}
        if isinstance(js, (int, float)):
            return {"number_value": float(js)}
        raise EncodeError(f"Value {js} has unexpected type {type(js)}")

    def list_value(self, js) -> dict:
        if not isinstance(js, (list, tuple)):
            raise EncodeError(f"ListValue must be in [] which is {js}")
        return {"values": [self.value(x) for x in js]}

    def struct(self, js) -> dict:
        if not isinstance(js, dict):
            raise EncodeError(f"Struct must be in a dict which is {js}")
        fields = {}
        for k, v in js.items():
            if not isinstance(k, str):
                raise EncodeError(f"Struct key {k!r} is not a string")
            fields[k] = self.value(v)
        return {"fields": fields}

    def fields(self, js, schema: Message) -> dict:
        out: dict = {}
        names: list = []
        for name in js:  # an object; a list or string iterates as ParseDict's does
            try:
                f = schema.by_json_name.get(name) or schema.by_name.get(name)
                if f is None:
                    if _EXTENSION_NAME.match(name):
                        raise EncodeError(
                            f"Message type {schema.full_name} does not have"
                            " extensions"
                        )
                    continue
                if name in names:
                    raise EncodeError(
                        f'Message type "{schema.full_name}" should not have'
                        f' multiple "{name}" fields'
                    )
                names.append(name)
                value = js[name]
                if f.oneof and value is not None:
                    if f.oneof in names:
                        raise EncodeError(
                            f'Message type "{schema.full_name}" should not'
                            f' have multiple "{f.oneof}" oneof fields'
                        )
                    names.append(f.oneof)
                    for other in schema.oneofs[f.oneof]:
                        out.pop(other, None)
                if value is None:
                    if f.type == TYPE_MESSAGE and f.type_name == VALUE:
                        out[f.name] = {"null_value": 0}
                    elif f.type == TYPE_ENUM and f.type_name == NULL_VALUE:
                        out[f.name] = 0
                    else:
                        out.pop(f.name, None)
                    continue
                if f.is_map:
                    out[f.name] = self.map(value, f)
                elif f.repeated:
                    if not isinstance(value, (list, tuple)):
                        raise EncodeError(
                            f"repeated field {name} must be in [] which is"
                            f" {value}"
                        )
                    if any(v is None for v in value) and f.type_name != VALUE:
                        raise EncodeError(
                            "null is not allowed to be used as an element"
                            " in a repeated field"
                        )
                    if f.type == TYPE_MESSAGE:
                        out[f.name] = [self.message(v, f.message)
                                       for v in value]
                    else:
                        out[f.name] = [_scalar_in(f.type, v) for v in value]
                elif f.type == TYPE_MESSAGE:
                    out[f.name] = self.message(value, f.message)
                else:
                    out[f.name] = _scalar_in(f.type, value)
            except EncodeError:
                raise
            except (ValueError, TypeError, OverflowError) as e:
                raise EncodeError(f"Failed to parse {name} field: {e}") from e
        return out

    def map(self, value, f) -> dict:
        if not isinstance(value, dict):
            raise EncodeError(
                f"Map field {f.name} must be in a dict which is {value}"
            )
        key_f, val_f = f.message.ordered
        out = {}
        for k in value:
            key = _scalar_in(key_f.type, k, key=True)
            v = value[k]
            if val_f.type == TYPE_MESSAGE:
                out[key] = self.message(v, val_f.message)
            else:
                out[key] = _scalar_in(val_f.type, v)
        return out


def from_json(js, schema: Message) -> dict:
    """`ParseDict(js, Message(), ignore_unknown_fields=True)`, as a wire
    dict. Raises `EncodeError` where `ParseDict` raises."""
    try:
        return _Parser().message(js, schema)
    except EncodeError:
        raise
    except (ValueError, TypeError, OverflowError) as e:
        raise EncodeError(str(e)) from e

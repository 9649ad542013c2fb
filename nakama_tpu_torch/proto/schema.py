"""A small proto3 reader: the rtapi and api schemas without `protoc`.

Reads the subset of proto3 that `rtapi.proto` and `api.proto` use:
`syntax`, `package`, `import` (of `google/protobuf/struct.proto` and
`google/protobuf/wrappers.proto`, whose texts are kept here), `option`
(ignored), messages and nested messages, enums, `repeated` fields,
`map<,>` fields (read as nested `...Entry` messages, as `protoc`
synthesizes them), `oneof` groups, `reserved` (ignored), the scalar
types `string`, `bytes`, `bool`, `int32`, `int64` and `double`, and
`service` blocks (each rpc's name and its input and output messages,
kept in `Schema.services`). Type names resolve by proto scoping,
innermost scope first.

Every field yields its name, number, type and label, numbered as
`descriptor.proto` numbers them (`TYPE_*`, `LABEL_*`), so the schema
can be held against a compiled descriptor field for field.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

TYPE_DOUBLE = 1
TYPE_INT64 = 3
TYPE_INT32 = 5
TYPE_BOOL = 8
TYPE_STRING = 9
TYPE_MESSAGE = 11
TYPE_BYTES = 12
TYPE_ENUM = 14

LABEL_OPTIONAL = 1
LABEL_REPEATED = 3

SCALAR_TYPES = {
    "double": TYPE_DOUBLE,
    "int32": TYPE_INT32,
    "int64": TYPE_INT64,
    "bool": TYPE_BOOL,
    "string": TYPE_STRING,
    "bytes": TYPE_BYTES,
}

# The one import rtapi.proto makes, as google/protobuf/struct.proto
# declares it (comments and options left out).
STRUCT_PROTO = """
syntax = "proto3";
package google.protobuf;
message Struct {
  map<string, Value> fields = 1;
}
message Value {
  oneof kind {
    NullValue null_value = 1;
    double number_value = 2;
    string string_value = 3;
    bool bool_value = 4;
    Struct struct_value = 5;
    ListValue list_value = 6;
  }
}
enum NullValue {
  NULL_VALUE = 0;
}
message ListValue {
  repeated Value values = 1;
}
"""

# The wrappers api.proto uses, as google/protobuf/wrappers.proto
# declares them (comments and options left out, and the wrappers of the
# types this reader does not read: float, uint32, uint64).
WRAPPERS_PROTO = """
syntax = "proto3";
package google.protobuf;
message DoubleValue {
  double value = 1;
}
message Int64Value {
  int64 value = 1;
}
message Int32Value {
  int32 value = 1;
}
message BoolValue {
  bool value = 1;
}
message StringValue {
  string value = 1;
}
message BytesValue {
  bytes value = 1;
}
"""

KNOWN_IMPORTS = {
    "google/protobuf/struct.proto": STRUCT_PROTO,
    "google/protobuf/wrappers.proto": WRAPPERS_PROTO,
}
# Messages the JSON mapping writes as their bare `value`.
WRAPPERS = frozenset(
    f"google.protobuf.{n}Value"
    for n in ("Double", "Int64", "Int32", "Bool", "String", "Bytes")
)


class SchemaError(ValueError):
    """A .proto text this reader does not accept."""


@dataclass
class Field:
    name: str
    number: int
    type: int
    label: int = LABEL_OPTIONAL
    # Full name of the message or enum type (TYPE_MESSAGE, TYPE_ENUM).
    type_name: str = ""
    # Name of the oneof group the field belongs to, "" for none.
    oneof: str = ""
    # The message type, once resolved (TYPE_MESSAGE only).
    message: "Message | None" = field(default=None, repr=False)

    @property
    def repeated(self) -> bool:
        return self.label == LABEL_REPEATED

    @property
    def is_map(self) -> bool:
        return self.message is not None and self.message.map_entry

    @property
    def json_name(self) -> str:
        """lowerCamelCase name, as `protoc` derives `json_name`."""
        head, *rest = self.name.split("_")
        return head + "".join(p[:1].upper() + p[1:] for p in rest)


@dataclass
class Message:
    full_name: str
    fields: list[Field] = field(default_factory=list)
    map_entry: bool = False
    # oneof name -> member field names, in declaration order.
    oneofs: dict[str, list[str]] = field(default_factory=dict)

    def __post_init__(self):
        self.by_name: dict[str, Field] = {}
        self.by_number: dict[int, Field] = {}
        self.by_json_name: dict[str, Field] = {}
        self.ordered: list[Field] = []

    def _index(self) -> None:
        self.by_name = {f.name: f for f in self.fields}
        self.by_number = {f.number: f for f in self.fields}
        self.by_json_name = {f.json_name: f for f in self.fields}
        # Field-number order: the order the encoder writes.
        self.ordered = sorted(self.fields, key=lambda f: f.number)


@dataclass
class Method:
    name: str
    input: Message
    output: Message


@dataclass
class Service:
    full_name: str
    # rpc name -> method, in declaration order.
    methods: dict[str, Method] = field(default_factory=dict)


@dataclass
class Schema:
    package: str
    messages: dict[str, Message]  # full name -> message
    enums: dict[str, dict[str, int]]  # full name -> value name -> number
    # full name -> service
    services: dict[str, Service] = field(default_factory=dict)

    def message(self, name: str) -> Message:
        """A message by full name, or by its name within the package."""
        if name in self.messages:
            return self.messages[name]
        return self.messages[f"{self.package}.{name}"]


_TOKEN = re.compile(
    r'\s+|//[^\n]*|/\*.*?\*/|"(?:[^"\\]|\\.)*"|\'(?:[^\'\\]|\\.)*\''
    r"|[A-Za-z_.][A-Za-z0-9_.]*|-?\d+|[{}\[\]<>;=,()]",
    re.S,
)


def _tokens(text: str) -> list[str]:
    out: list[str] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise SchemaError(f"unexpected character {text[pos]!r} at {pos}")
        tok = m.group()
        pos = m.end()
        if tok.isspace() or tok.startswith(("//", "/*")):
            continue
        out.append(tok)
    return out


def _camel(name: str) -> str:
    return "".join(p[:1].upper() + p[1:] for p in name.split("_"))


class _Reader:
    def __init__(self, text: str, schema: Schema):
        self.toks = _tokens(text)
        self.i = 0
        self.schema = schema
        self.package = ""
        # (message, scope) pairs whose field types resolve at the end.
        self.pending: list[tuple[Message, str]] = []
        # (service, rpc name, input type, output type), resolved at the end.
        self.rpcs: list[tuple[Service, str, str, str]] = []

    def peek(self) -> str:
        return self.toks[self.i] if self.i < len(self.toks) else ""

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise SchemaError("unexpected end of file")
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect(self, want: str) -> None:
        got = self.next()
        if got != want:
            raise SchemaError(f"expected {want!r}, got {got!r}")

    def skip_statement(self) -> None:
        while self.next() != ";":
            pass

    def skip_options(self) -> None:
        if self.peek() == "[":
            while self.next() != "]":
                pass

    def file(self) -> None:
        while self.i < len(self.toks):
            tok = self.next()
            if tok == "syntax":
                self.expect("=")
                if self.next().strip("\"'") != "proto3":
                    raise SchemaError("only proto3 is read")
                self.expect(";")
            elif tok == "package":
                self.package = self.next()
                self.expect(";")
            elif tok == "import":
                path = self.next().strip("\"'")
                self.expect(";")
                if path not in KNOWN_IMPORTS:
                    raise SchemaError(f"unknown import {path!r}")
                sub = _Reader(KNOWN_IMPORTS[path], self.schema)
                sub.file()
            elif tok == "option":
                self.skip_statement()
            elif tok == "message":
                self.message(self.package)
            elif tok == "enum":
                self.enum(self.package)
            elif tok == "service":
                self.service()
            elif tok == ";":
                continue
            else:
                raise SchemaError(f"unexpected {tok!r} at file level")
        for msg, scope in self.pending:
            for f in msg.fields:
                self.resolve(f, scope)
            msg._index()
        for svc, name, req, resp in self.rpcs:
            svc.methods[name] = Method(
                name, self.resolve_message(req, self.package),
                self.resolve_message(resp, self.package))

    def service(self) -> None:
        svc = Service(f"{self.package}.{self.next()}".lstrip("."))
        self.schema.services[svc.full_name] = svc
        self.expect("{")
        while (tok := self.next()) != "}":
            if tok == "option":
                self.skip_statement()
                continue
            if tok == ";":
                continue
            if tok != "rpc":
                raise SchemaError(f"unexpected {tok!r} in a service")
            name = self.next()
            self.expect("(")
            req = self.next()
            if req == "stream":
                raise SchemaError("streaming rpcs are not read")
            self.expect(")")
            self.expect("returns")
            self.expect("(")
            resp = self.next()
            if resp == "stream":
                raise SchemaError("streaming rpcs are not read")
            self.expect(")")
            if self.peek() == "{":  # a body of options
                self.next()
                depth = 1
                while depth:
                    t = self.next()
                    depth += (t == "{") - (t == "}")
            else:
                self.expect(";")
            self.rpcs.append((svc, name, req, resp))

    def enum(self, scope: str) -> None:
        full = f"{scope}.{self.next()}".lstrip(".")
        values: dict[str, int] = {}
        self.expect("{")
        while (tok := self.next()) != "}":
            if tok in ("option", "reserved"):
                self.skip_statement()
                continue
            self.expect("=")
            values[tok] = int(self.next())
            self.skip_options()
            self.expect(";")
        self.schema.enums[full] = values

    def message(self, scope: str) -> None:
        full = f"{scope}.{self.next()}".lstrip(".")
        msg = Message(full)
        self.schema.messages[full] = msg
        self.pending.append((msg, full))
        self.expect("{")
        while (tok := self.next()) != "}":
            if tok == "message":
                self.message(full)
            elif tok == "enum":
                self.enum(full)
            elif tok in ("option", "reserved"):
                self.skip_statement()
            elif tok == "oneof":
                name = self.next()
                msg.oneofs[name] = []
                self.expect("{")
                while (t := self.next()) != "}":
                    if t == "option":
                        self.skip_statement()
                        continue
                    f = self.field(t, LABEL_OPTIONAL)
                    f.oneof = name
                    msg.oneofs[name].append(f.name)
                    msg.fields.append(f)
            elif tok == "map":
                msg.fields.append(self.map_field(full))
            elif tok == ";":
                continue
            elif tok == "repeated":
                msg.fields.append(self.field(self.next(), LABEL_REPEATED))
            else:
                if tok == "optional":
                    raise SchemaError("proto3 `optional` is not read")
                msg.fields.append(self.field(tok, LABEL_OPTIONAL))

    def field(self, type_tok: str, label: int) -> Field:
        name = self.next()
        self.expect("=")
        number = int(self.next())
        self.skip_options()
        self.expect(";")
        f = Field(name, number, SCALAR_TYPES.get(type_tok, 0), label)
        if not f.type:
            f.type_name = type_tok  # resolved at the end of the file
        return f

    def map_field(self, scope: str) -> Field:
        self.expect("<")
        key_type = self.next()
        self.expect(",")
        value_type = self.next()
        self.expect(">")
        name = self.next()
        self.expect("=")
        number = int(self.next())
        self.skip_options()
        self.expect(";")
        if key_type not in SCALAR_TYPES or key_type in ("double", "bytes"):
            raise SchemaError(f"map key type {key_type!r} is not read")
        entry = Message(f"{scope}.{_camel(name)}Entry", map_entry=True)
        entry.fields = [
            Field("key", 1, SCALAR_TYPES[key_type]),
            Field("value", 2, SCALAR_TYPES.get(value_type, 0)),
        ]
        if not entry.fields[1].type:
            entry.fields[1].type_name = value_type
        self.schema.messages[entry.full_name] = entry
        self.pending.append((entry, scope))
        return Field(name, number, TYPE_MESSAGE, LABEL_REPEATED,
                     type_name=entry.full_name)

    @staticmethod
    def candidates(name: str, scope: str) -> list[str]:
        if name.startswith("."):
            return [name[1:]]
        parts = scope.split(".") if scope else []
        return [".".join(parts[:k] + [name]) for k in range(len(parts), -1, -1)]

    def resolve_message(self, name: str, scope: str) -> Message:
        for cand in self.candidates(name, scope):
            if cand in self.schema.messages:
                return self.schema.messages[cand]
        raise SchemaError(f"unknown message {name!r} in {scope}")

    def resolve(self, f: Field, scope: str) -> None:
        if f.type and f.type != TYPE_MESSAGE:
            return
        name = f.type_name
        for cand in self.candidates(name, scope):
            if cand in self.schema.messages:
                f.type = TYPE_MESSAGE
                f.type_name = cand
                f.message = self.schema.messages[cand]
                return
            if cand in self.schema.enums:
                f.type = TYPE_ENUM
                f.type_name = cand
                return
        raise SchemaError(f"unknown type {name!r} in {scope}")


def parse(text: str) -> Schema:
    """Read one proto3 file (and the imports it names) into a Schema."""
    schema = Schema(package="", messages={}, enums={})
    reader = _Reader(text, schema)
    reader.file()
    schema.package = reader.package
    return schema


_READ: dict[str, Schema] = {}


def _read(name: str) -> Schema:
    if name not in _READ:
        path = os.path.join(os.path.dirname(__file__), name)
        with open(path, encoding="utf-8") as f:
            _READ[name] = parse(f.read())
    return _READ[name]


def rtapi() -> Schema:
    """The schema of the port's `rtapi.proto`, read once."""
    return _read("rtapi.proto")


def api() -> Schema:
    """The schema of the port's `api.proto` (the `NakamaApi` service and
    its messages), read once."""
    return _read("api.proto")

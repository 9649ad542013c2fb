"""The port's rtapi codec (`nakama_tpu_torch/proto/`, through
`api/protocol.py`) held against the JAX package's `protocol.py`, which
encodes with `google.protobuf.json_format` + `SerializeToString` and
decodes with `Envelope.FromString` + `MessageToDict`:

- the port's schema, read from its own `rtapi.proto`, equals
  `rtapi_pb2.Envelope.DESCRIPTOR` message by message (field names,
  numbers, types, labels, map-ness, oneof membership), and every
  envelope key of the port's `envelope.py` is a oneof member;
- seeded random envelopes of every oneof variant (non-ASCII strings,
  negative int32, doubles, bytes, one-key maps, nested Structs with
  lists and nulls, empty sub-messages): the port's bytes equal the JAX
  bytes wherever no map holds more than one key (a Struct is a map: the
  upb runtime does not write its keys in insertion order), else each
  side decodes the other's bytes to the same dict; the port's decode of
  the JAX bytes equals the JAX decode; the frozen matchmaker_add golden;
- malformed frames raise `ProtocolError` where the JAX decode does
  (truncated varint, a length past the end, a bad wire type, and a
  seeded mutation fuzz over valid frames), refused dicts fail on encode
  where `ParseDict` fails, and lenient ones pass where it passes.

Stated tolerance: none — bytes and dicts must be equal."""

import base64

import numpy as np
import pytest
from google.protobuf import struct_pb2
from test_wire_contract import GOLDENS

from nakama_tpu.api import protocol as jax_protocol
from nakama_tpu.proto import rtapi_pb2
from nakama_tpu_torch import proto
from nakama_tpu_torch.api import envelope as port_envelope
from nakama_tpu_torch.api import protocol as port_protocol
from nakama_tpu_torch.proto import schema as port_schema

PB = "protobuf"
SCHEMA = port_schema.rtapi()
ENVELOPE = SCHEMA.message("Envelope")
VARIANTS = ENVELOPE.oneofs["message"]
# Variants whose messages hold a Struct (a map of any number of keys).
STRUCT_VARIANTS = {"channel_message_send", "channel_message_update",
                   "match_create", "match_join", "notifications"}


def _descriptors():
    """Every message of rtapi.proto and struct.proto, map entries
    included, by full name."""
    out = {}

    def walk(d):
        out[d.full_name] = d
        for nested in d.nested_types:
            walk(nested)

    for file in (rtapi_pb2.DESCRIPTOR, struct_pb2.DESCRIPTOR):
        for d in file.message_types_by_name.values():
            walk(d)
    return out


def test_schema_equals_the_compiled_descriptor():
    descriptors = _descriptors()
    assert set(SCHEMA.messages) == set(descriptors)
    for name, msg in SCHEMA.messages.items():
        d = descriptors[name]
        assert msg.map_entry == d.GetOptions().map_entry, name
        mine = [(f.name, f.number, f.type, f.label, f.type_name, f.is_map,
                 f.oneof) for f in msg.fields]
        theirs = [
            (f.name, f.number, f.type,
             port_schema.LABEL_REPEATED if f.is_repeated
             else port_schema.LABEL_OPTIONAL,
             (f.message_type or f.enum_type).full_name
             if f.message_type or f.enum_type else "",
             bool(f.message_type and f.message_type.GetOptions().map_entry),
             f.containing_oneof.name if f.containing_oneof else "")
            for f in d.fields
        ]
        assert mine == theirs, name
        assert msg.oneofs == {
            o.name: [f.name for f in o.fields] for o in d.oneofs}, name
    keys = port_envelope.REQUEST_KEYS | port_envelope.RESPONSE_KEYS
    assert keys <= set(VARIANTS)


# ------------------------------------------------------ random envelopes


class Gen:
    """Seeded random JSON for a message of the port's schema."""

    WORDS = ["alpha", "β-team", "ранг", "名前", "🙂ok", "", "x" * 20, "a b"]

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def pick(self, seq):
        return seq[int(self.rng.integers(len(seq)))]

    def string(self) -> str:
        return self.pick(self.WORDS) + str(int(self.rng.integers(0, 100)))

    def scalar(self, ftype: int):
        r = self.rng
        if ftype == port_schema.TYPE_STRING:
            return self.string()
        if ftype == port_schema.TYPE_INT32:
            return int(self.pick([0, 1, -1, -(1 << 31), (1 << 31) - 1,
                                  int(r.integers(-1000, 1000))]))
        if ftype == port_schema.TYPE_DOUBLE:
            return float(self.pick([0.0, -2.5, 1e-7, 12345.678,
                                    float(r.normal() * 1e3)]))
        if ftype == port_schema.TYPE_BOOL:
            return bool(r.integers(2))
        if ftype == port_schema.TYPE_BYTES:
            raw = r.integers(0, 256, size=int(r.integers(0, 12)),
                             dtype=np.uint8).tobytes()
            return base64.b64encode(raw).decode()
        raise AssertionError(ftype)

    def value(self, depth: int):
        kind = int(self.rng.integers(0, 6 if depth < 3 else 4))
        if kind == 0:
            return None
        if kind == 1:
            return float(self.rng.integers(-50, 50)) / 4
        if kind == 2:
            return self.string()
        if kind == 3:
            return bool(self.rng.integers(2))
        if kind == 4:
            return [self.value(depth + 1)
                    for _ in range(int(self.rng.integers(0, 3)))]
        return self.struct(depth + 1)

    def struct(self, depth: int = 0) -> dict:
        return {f"k{j}": self.value(depth)
                for j in range(int(self.rng.integers(0, 3)))}

    def message(self, msg, depth: int = 0) -> dict:
        if msg.full_name == "google.protobuf.Struct":
            return self.struct()
        out = {}
        for f in msg.fields:
            if self.rng.random() < 0.35:
                continue  # absent
            if f.is_map:
                val_f = f.message.by_name["value"]
                out[f.name] = {self.string(): self.scalar(val_f.type)}
            elif f.type == port_schema.TYPE_MESSAGE:
                n = int(self.rng.integers(0, 3)) if f.repeated else 1
                if depth > 2 and f.message.full_name != "google.protobuf.Struct":
                    items = [{} for _ in range(n)]  # empty sub-messages
                else:
                    items = [self.message(f.message, depth + 1)
                             for _ in range(n)]
                out[f.name] = items if f.repeated else items[0]
            elif f.repeated:
                out[f.name] = [self.scalar(f.type)
                               for _ in range(int(self.rng.integers(0, 3)))]
            else:
                out[f.name] = self.scalar(f.type)
        return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_random_envelopes_encode_and_decode_as_the_jax_codec(variant):
    gen = Gen(seed=VARIANTS.index(variant) + 1)
    sub = ENVELOPE.by_name[variant].message
    for n in range(12):
        env = {variant: gen.message(sub) if n else {}}
        if n % 3 == 0:
            env["cid"] = gen.string()
        jax_bytes = jax_protocol.encode(env, PB)
        port_bytes = port_protocol.encode(env, PB)
        assert isinstance(port_bytes, bytes)
        want = jax_protocol.decode(jax_bytes, PB)
        assert port_protocol.decode(jax_bytes, PB) == want
        if variant in STRUCT_VARIANTS:
            assert jax_protocol.decode(port_bytes, PB) == want
            assert port_protocol.decode(port_bytes, PB) == want
        else:
            assert port_bytes == jax_bytes, (env, port_bytes.hex())
        # A text frame on a protobuf socket is read as its bytes.
        if all(b < 0x80 for b in jax_bytes):
            assert port_protocol.decode(jax_bytes.decode(), PB) == want


def test_frozen_golden_and_round_trips():
    name, env, golden_hex = GOLDENS[0]
    assert port_protocol.encode(env, PB).hex() == golden_hex
    for name, env, _ in GOLDENS:
        wire = port_protocol.encode(env, PB)
        assert port_protocol.decode(wire, PB) == env, name
        assert jax_protocol.decode(wire, PB) == env, name


# --------------------------------------------------------------- refusals


def _jax_refuses(raw) -> bool:
    try:
        jax_protocol.decode(raw, PB)
    except jax_protocol.ProtocolError:
        return True
    return False


@pytest.mark.parametrize("hex_frame", [
    "0a",            # a string field with no length
    "0a80",          # a truncated varint length
    "08",            # a varint field with no value
    "0a05616263",    # a length past the end
    "0f",            # wire type 7
    "0e00",          # wire type 6
    "0c",            # an end-group tag with no group open
    "0b",            # an unterminated group
    "00",            # field number 0
    "0a02c328",      # invalid UTF-8 in a string
    "c201028001",    # a truncated varint inside a sub-message
    "c2010b08ffffffffffffffffffff01",  # a varint over ten bytes
])
def test_malformed_frames_raise_protocol_error(hex_frame):
    raw = bytes.fromhex(hex_frame)
    assert _jax_refuses(raw)
    with pytest.raises(port_protocol.ProtocolError):
        port_protocol.decode(raw, PB)


def test_mutated_frames_fail_or_decode_as_the_jax_codec():
    rng = np.random.default_rng(17)
    frames = [jax_protocol.encode(env, PB) for _, env, _ in GOLDENS]
    for _ in range(1500):
        raw = bytearray(frames[int(rng.integers(len(frames)))])
        for _ in range(int(rng.integers(1, 4))):
            op = int(rng.integers(4))
            if op == 0 and raw:
                raw[int(rng.integers(len(raw)))] = int(rng.integers(256))
            elif op == 1 and raw:
                del raw[int(rng.integers(len(raw))):]
            elif op == 2:
                raw.insert(int(rng.integers(len(raw) + 1)),
                           int(rng.integers(256)))
            else:
                raw += frames[int(rng.integers(len(frames)))]
        raw = bytes(raw)
        try:
            want = jax_protocol.decode(raw, PB)
        except jax_protocol.ProtocolError:
            with pytest.raises(port_protocol.ProtocolError):
                port_protocol.decode(raw, PB)
            continue
        assert port_protocol.decode(raw, PB) == want, raw.hex()


@pytest.mark.parametrize("env", [
    {"ping": {}, "pong": {}},                              # two oneof members
    {"match_data_send": {"op_code": 1.5}},                 # int32 1.5
    {"match_data_send": {"op_code": 1 << 31}},             # int32 range
    {"match_data_send": {"op_code": True}},                # bool for int32
    {"match_data_send": {"data": "a"}},                    # bad base64 length
    {"matchmaker_add": {"query": 5}},                      # int for string
    {"matchmaker_add": {"string_properties": {"a": 1}}},   # int map value
    {"status_follow": {"user_ids": ["a", None]}},          # null in a list
    {"status_follow": {"user_ids": "ab"}},                 # string for a list
    {"match_create": {"params": []}},                      # list for a Struct
    {"ping": 5},                                           # number for a message
    {"[ext]": 1},                                          # extension key
    {"channel_message": {"create_time": "nan"}},
    {"channel_message": {"persistent": 1}},                # int for bool
])
def test_refused_dicts_fail_on_encode_as_parse_dict_fails(env):
    with pytest.raises(Exception):
        jax_protocol.encode(env, PB)
    with pytest.raises(proto.EncodeError):
        port_protocol.encode(env, PB)


@pytest.mark.parametrize("env", [
    {"match_data_send": {"op_code": "3"}},                 # numeric string
    {"match_data_send": {"op_code": 3.0}},                 # integral float
    {"match_data_send": {"data": "!!"}},                   # empty bytes
    {"match_data_send": {"data": "-_8"}},                  # URL-safe, no padding
    {"matchmaker_add": {"minCount": 3, "unknown": {"x": 1}}},
    {"ping": {}, "pong": None},                            # null clears
    {"channel_message": {"create_time": "NaN", "update_time": -0.0}},
    {"matchmaker_add": {"numeric_properties": {"r": "1.5"}}},
])
def test_lenient_dicts_pass_where_parse_dict_passes(env):
    want = jax_protocol.encode(env, PB)
    assert port_protocol.encode(env, PB) == want
    assert port_protocol.decode(want, PB) == jax_protocol.decode(want, PB)


def test_a_struct_number_that_is_not_finite_cannot_go_out():
    raw = jax_protocol.encode({"match_create": {"params": {"a": float("inf")}}}, PB)
    with pytest.raises(Exception):
        jax_protocol.decode(raw, PB)
    with pytest.raises(port_protocol.ProtocolError):
        port_protocol.decode(raw, PB)


def test_unknown_formats_are_refused():
    with pytest.raises(port_protocol.ProtocolError):
        port_protocol.encode({"ping": {}}, "xml")
    with pytest.raises(port_protocol.ProtocolError):
        port_protocol.decode(b"", "xml")
    assert port_protocol.SUPPORTED_FORMATS == jax_protocol.SUPPORTED_FORMATS

"""HPACK (RFC 7541): header compression for the port's HTTP/2 transport.

What it holds: the static table (Appendix A); the dynamic table, with
its size updates and the eviction of its oldest entries (section 4);
integer and string literals (section 5); the Huffman code of Appendix B,
decoding and encoding; and every representation of section 6 — indexed,
and literal with incremental indexing, without indexing or never
indexed — in both directions.

`Decoder.decode(block)` reads one header block into `(name, value)`
pairs of `str` (each octet one character, as latin-1 maps them: gRPC
metadata is ASCII, a `-bin` value base64). A block it refuses raises
`HpackError`, which the connection answers with COMPRESSION_ERROR: an
index of 0 or past both tables, a truncated integer or string, an
integer over 2^32, a size update over the limit or after a field,
Huffman padding longer than 7 bits or not all ones, EOS inside a
string.

`Encoder.encode(headers)` writes one block: each header as an index
where both tables hold it, else as a literal that names it by index
where they hold the name; literals are indexed into the dynamic table
unless a header asks otherwise (`(name, value, NO_INDEX)` or
`NEVER_INDEX`), and Huffman-coded where that is not longer, as
Appendix C.4 and C.6 code them.
"""

from __future__ import annotations

NO_INDEX = "no-index"
NEVER_INDEX = "never-index"
DEFAULT_TABLE_SIZE = 4096
# A decoded integer past this is refused (a length or index no
# header block can hold).
_MAX_INT = 1 << 32


class HpackError(ValueError):
    """A header block this decoder refuses (COMPRESSION_ERROR)."""


STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""),
    ("content-type", ""), ("cookie", ""), ("date", ""), ("etag", ""),
    ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""), ("last-modified", ""),
    ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""),
    ("retry-after", ""), ("server", ""), ("set-cookie", ""),
    ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", ""),
)
_STATIC_EXACT: dict = {}
_STATIC_NAME: dict = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE, 1):
    _STATIC_EXACT.setdefault((_n, _v), _i)
    _STATIC_NAME.setdefault(_n, _i)

# Appendix B: (code, bit length) of symbols 0-255 and EOS (256), as the
# RFC lists them. The code is canonical: codes of one length run in
# symbol order, each length's first code follows the previous length's
# last.
HUFFMAN = [
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
]
EOS = 256


def _decode_plan():
    """Per code length, the first code, left-aligned to 30 bits past the
    last code of that length (the limit), and where its symbols start in
    canonical order."""
    order = sorted(range(len(HUFFMAN)), key=lambda s: (HUFFMAN[s][1], s))
    plan = []
    start = 0
    for length in sorted({bits for _, bits in HUFFMAN}):
        syms = [s for s in order if HUFFMAN[s][1] == length]
        first = HUFFMAN[syms[0]][0]
        plan.append((length, (first + len(syms)) << (30 - length), first,
                     start))
        start += len(syms)
    return tuple(plan), tuple(order)


_PLAN, _CANONICAL = _decode_plan()


def huffman_encode(data: bytes) -> bytes:
    out = bytearray()
    acc = nbits = 0
    for b in data:
        code, bits = HUFFMAN[b]
        acc = (acc << bits) | code
        nbits += bits
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:
        # Padding: the most significant bits of EOS (all ones).
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_length(data: bytes) -> int:
    return (sum(HUFFMAN[b][1] for b in data) + 7) // 8


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    acc = nbits = i = 0
    n = len(data)
    while True:
        while nbits < 30 and i < n:
            acc = (acc << 8) | data[i]
            i += 1
            nbits += 8
        if nbits == 0:
            break
        if nbits >= 30:
            window = acc >> (nbits - 30)
        else:  # past the end the window reads ones, as padding does
            window = (acc << (30 - nbits)) | ((1 << (30 - nbits)) - 1)
        for length, limit, first, start in _PLAN:
            if window < limit:
                break
        if length > nbits:
            # What is left is padding: at most 7 bits, all ones.
            if nbits > 7 or acc != (1 << nbits) - 1:
                raise HpackError("invalid Huffman padding")
            break
        sym = _CANONICAL[start + (window >> (30 - length)) - first]
        if sym == EOS:
            raise HpackError("EOS inside a Huffman-coded string")
        out.append(sym)
        nbits -= length
        acc &= (1 << nbits) - 1
    return bytes(out)


# ----------------------------------------------------------- primitives


def encode_integer(value: int, prefix: int, flags: int = 0) -> bytearray:
    """Section 5.1: `value` on an N-bit prefix, `flags` in the first
    octet's high bits."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytearray((flags | value,))
    out = bytearray((flags | limit,))
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return out


def decode_integer(data: bytes, pos: int, prefix: int) -> tuple[int, int]:
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        if value > _MAX_INT:
            raise HpackError("integer out of range")
        if not b & 0x80:
            return value, pos
        shift += 7


def encode_string(text: str, huffman: bool = True) -> bytearray:
    raw = text.encode("latin-1")
    if huffman and huffman_length(raw) <= len(raw):
        coded = huffman_encode(raw)
        return encode_integer(len(coded), 7, 0x80) + coded
    return encode_integer(len(raw), 7) + raw


def decode_string(data: bytes, pos: int) -> tuple[str, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huffman = data[pos] & 0x80
    length, pos = decode_integer(data, pos, 7)
    end = pos + length
    if end > len(data):
        raise HpackError("string runs past the end of the block")
    raw = bytes(data[pos:end])
    if huffman:
        raw = huffman_decode(raw)
    return raw.decode("latin-1"), end


def entry_size(name: str, value: str) -> int:
    """Section 4.1: the octets of both plus 32."""
    return len(name.encode("latin-1")) + len(value.encode("latin-1")) + 32


class _Table:
    """The dynamic table: newest entry first (index 62)."""

    def __init__(self, max_size: int):
        self.entries: list[tuple[str, str]] = []
        self.size = 0
        self.max_size = max_size

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict(0)

    def _evict(self, room: int) -> None:
        while self.entries and self.size + room > self.max_size:
            self.size -= entry_size(*self.entries.pop())

    def add(self, name: str, value: str) -> None:
        size = entry_size(name, value)
        self._evict(size)
        if size <= self.max_size:
            self.entries.insert(0, (name, value))
            self.size += size
        # An entry larger than the table empties it (section 4.4).

    def get(self, index: int) -> tuple[str, str]:
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        dyn = index - len(STATIC_TABLE) - 1
        if index <= 0 or dyn >= len(self.entries):
            raise HpackError(f"index {index} is in neither table")
        return self.entries[dyn]


class Decoder:
    """One connection's inbound header state."""

    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        # The limit this endpoint advertised (SETTINGS_HEADER_TABLE_SIZE):
        # a size update may not pass it.
        self.max_allowed = max_table_size
        self.table = _Table(max_table_size)

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        headers: list[tuple[str, str]] = []
        pos = 0
        n = len(block)
        while pos < n:
            b = block[pos]
            if b & 0x80:  # indexed
                index, pos = decode_integer(block, pos, 7)
                if index == 0:
                    raise HpackError("index 0")
                headers.append(self.table.get(index))
                continue
            if b & 0xE0 == 0x20:  # dynamic table size update
                if headers:
                    raise HpackError("table size update after a header field")
                size, pos = decode_integer(block, pos, 5)
                if size > self.max_allowed:
                    raise HpackError(
                        f"table size update {size} over the limit"
                        f" {self.max_allowed}")
                self.table.resize(size)
                continue
            indexing = b & 0xC0 == 0x40
            index, pos = decode_integer(block, pos, 6 if indexing else 4)
            if index:
                name = self.table.get(index)[0]
            else:
                name, pos = decode_string(block, pos)
            value, pos = decode_string(block, pos)
            if indexing:
                self.table.add(name, value)
            headers.append((name, value))
        return headers


class Encoder:
    """One connection's outbound header state."""

    def __init__(self, table_size: int = DEFAULT_TABLE_SIZE):
        self.table = _Table(table_size)
        # Size updates owed at the start of the next block: the smallest
        # limit since the last block, then the last one (section 4.2).
        self._pending: list[int] = []

    def resize(self, max_size: int) -> None:
        """The peer's SETTINGS_HEADER_TABLE_SIZE changed."""
        if not self._pending:
            self._pending = [max_size]
        elif max_size < min(self._pending):
            self._pending = [max_size]
        else:
            self._pending = [min(self._pending), max_size]

    def _find(self, name: str, value: str) -> tuple[int, int]:
        """(index of the header, index of its name); 0 where absent."""
        exact = _STATIC_EXACT.get((name, value), 0)
        named = _STATIC_NAME.get(name, 0)
        if exact:
            return exact, named
        base = len(STATIC_TABLE) + 1
        for i, (n, v) in enumerate(self.table.entries):
            if n == name:
                if v == value:
                    return base + i, named or base + i
                named = named or base + i
        return 0, named

    def encode(self, headers, huffman: bool = True) -> bytes:
        out = bytearray()
        for size in self._pending:
            self.table.resize(size)
            out += encode_integer(size, 5, 0x20)
        self._pending = []
        for header in headers:
            name, value = header[0], header[1]
            mode = header[2] if len(header) > 2 else None
            index, named = self._find(name, value)
            if index and mode != NEVER_INDEX:
                out += encode_integer(index, 7, 0x80)
                continue
            if mode == NEVER_INDEX:
                out += encode_integer(named, 4, 0x10)
            elif mode == NO_INDEX:
                out += encode_integer(named, 4, 0x00)
            else:
                out += encode_integer(named, 6, 0x40)
            if not named:
                out += encode_string(name, huffman)
            out += encode_string(value, huffman)
            if mode is None:
                self.table.add(name, value)
        return bytes(out)

"""Lua 5.1 lexer — tokens for the subset grammar (parser.py).

Original implementation (reference embeds gopher-lua; this is not a
port): one forward scan producing (kind, value, line) tuples.
"""

from __future__ import annotations

KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for",
    "function", "if", "in", "local", "nil", "not", "or", "repeat",
    "return", "then", "true", "until", "while",
}

# Longest-first so '..' wins over '.', '==' over '=' etc.
SYMBOLS = [
    "...", "..", "==", "~=", "<=", ">=", "<", ">", "=", "(", ")", "{",
    "}", "[", "]", ";", ":", ",", ".", "+", "-", "*", "/", "%", "^", "#",
]


class LuaSyntaxError(SyntaxError):
    pass


class Token:
    __slots__ = ("kind", "value", "line")

    def __init__(self, kind: str, value, line: int):
        self.kind = kind  # name | keyword | number | string | sym | eof
        self.value = value
        self.line = line

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Token({self.kind}, {self.value!r}, L{self.line})"


def tokenize(src: str, chunk: str = "?") -> list[Token]:
    tokens: list[Token] = []
    i, n, line = 0, len(src), 1

    def err(msg: str):
        raise LuaSyntaxError(f"{chunk}:{line}: {msg}")

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        # comments: -- line, --[[ long ]]
        if src.startswith("--", i):
            if src.startswith("--[[", i):
                end = src.find("]]", i + 4)
                if end < 0:
                    err("unterminated long comment")
                line += src.count("\n", i, end)
                i = end + 2
            else:
                nl = src.find("\n", i)
                i = n if nl < 0 else nl
            continue
        # long strings [[ ... ]]
        if src.startswith("[[", i):
            end = src.find("]]", i + 2)
            if end < 0:
                err("unterminated long string")
            text = src[i + 2 : end]
            tokens.append(Token("string", text, line))
            line += text.count("\n")
            i = end + 2
            continue
        if c in "'\"":
            quote = c
            j = i + 1
            out = []
            while True:
                if j >= n:
                    err("unterminated string")
                ch = src[j]
                if ch == "\\":
                    if j + 1 >= n:
                        err("unterminated string escape")
                    e = src[j + 1]
                    out.append(
                        {
                            "n": "\n", "t": "\t", "r": "\r", "a": "\a",
                            "b": "\b", "f": "\f", "v": "\v", "\\": "\\",
                            '"': '"', "'": "'", "\n": "\n",
                        }.get(e)
                        or (e if not e.isdigit() else None)
                        or ""
                    )
                    if e.isdigit():  # \ddd decimal escape
                        k = j + 1
                        num = ""
                        while k < n and src[k].isdigit() and len(num) < 3:
                            num += src[k]
                            k += 1
                        out[-1] = chr(int(num))
                        j = k
                        continue
                    j += 2
                    continue
                if ch == quote:
                    break
                if ch == "\n":
                    err("unterminated string")
                out.append(ch)
                j += 1
            tokens.append(Token("string", "".join(out), line))
            i = j + 1
            continue
        if c.isdigit() or (
            c == "." and i + 1 < n and src[i + 1].isdigit()
        ):
            j = i
            is_hex = src.startswith(("0x", "0X"), i)
            if is_hex:
                j = i + 2
                while j < n and (src[j] in "0123456789abcdefABCDEF"):
                    j += 1
                if j == i + 2:  # bare "0x"
                    err("malformed number near '0x'")
                value = float(int(src[i:j], 16))
            else:
                while j < n and (src[j].isdigit() or src[j] == "."):
                    j += 1
                if j < n and src[j] in "eE":
                    j += 1
                    if j < n and src[j] in "+-":
                        j += 1
                    while j < n and src[j].isdigit():
                        j += 1
                try:
                    value = float(src[i:j])
                except ValueError:
                    err(f"malformed number near {src[i:j]!r}")
            tokens.append(Token("number", value, line))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            tokens.append(
                Token(
                    "keyword" if word in KEYWORDS else "name", word, line
                )
            )
            i = j
            continue
        for sym in SYMBOLS:
            if src.startswith(sym, i):
                tokens.append(Token("sym", sym, line))
                i += len(sym)
                break
        else:
            err(f"unexpected character {c!r}")
    tokens.append(Token("eof", None, line))
    return tokens

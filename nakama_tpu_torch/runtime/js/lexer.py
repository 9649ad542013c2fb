"""JS tokenizer for the sandboxed guest runtime (see __init__ for the
documented subset). Original implementation — not a port of any engine."""

from __future__ import annotations


class JsSyntaxError(SyntaxError):
    pass


KEYWORDS = {
    "var", "let", "const", "function", "return", "if", "else", "while",
    "do", "for", "break", "continue", "true", "false", "null",
    "undefined", "typeof", "throw", "try", "catch", "finally", "new",
    "delete", "in", "of", "instanceof", "switch", "case", "default",
    "this", "class", "void",
}

# Longest-first operator table.
OPERATORS = [
    "===", "!==", ">>>", "**=", "...",
    "=>", "==", "!=", "<=", ">=", "&&", "||", "++", "--", "+=", "-=",
    "*=", "/=", "%=", "&=", "|=", "^=", "<<", ">>", "**",
    "+", "-", "*", "/", "%", "=", "<", ">", "!", "?", ":", ";", ",",
    ".", "(", ")", "[", "]", "{", "}", "&", "|", "^", "~",
]


class Token:
    __slots__ = ("kind", "value", "line", "nl_before")

    def __init__(self, kind, value, line, nl_before):
        self.kind = kind  # name | keyword | num | str | op | eof
        self.value = value
        self.line = line
        self.nl_before = nl_before  # a newline separates it from the prev

    def __repr__(self):  # pragma: no cover
        return f"Token({self.kind}, {self.value!r}, L{self.line})"


_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f", "v": "\v",
    "0": "\0", "'": "'", '"': '"', "\\": "\\", "\n": "", "`": "`",
    "/": "/",
}


def tokenize(src: str, chunk: str = "?") -> list[Token]:
    out: list[Token] = []
    i, n, line = 0, len(src), 1
    nl = False

    def err(msg):
        raise JsSyntaxError(f"{chunk}:{line}: {msg}")

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            nl = True
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                err("unterminated block comment")
            line += src.count("\n", i, j)
            nl = nl or "\n" in src[i:j]
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF":
                    j += 1
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
                    err(f"malformed number {src[i:j]!r}")
            if j < n and (src[j].isalpha() or src[j] == "_"):
                err(f"malformed number {src[i:j+1]!r}")
            out.append(Token("num", value, line, nl))
            nl = False
            i = j
            continue
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_$"):
                j += 1
            word = src[i:j]
            kind = "keyword" if word in KEYWORDS else "name"
            out.append(Token(kind, word, line, nl))
            nl = False
            i = j
            continue
        if c in "'\"`":
            if c == "`":
                err("template literals are not supported in this subset")
            quote = c
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    err("unterminated string")
                ch = src[j]
                if ch == quote:
                    break
                if ch == "\n":
                    err("unterminated string")
                if ch == "\\":
                    if j + 1 >= n:
                        err("unterminated string")
                    esc = src[j + 1]
                    if esc == "u":
                        if src[j + 2 : j + 3] == "{":
                            k = src.find("}", j + 3)
                            if k < 0:
                                err("bad unicode escape")
                            buf.append(chr(int(src[j + 3 : k], 16)))
                            j = k + 1
                            continue
                        buf.append(chr(int(src[j + 2 : j + 6], 16)))
                        j += 6
                        continue
                    if esc == "x":
                        buf.append(chr(int(src[j + 2 : j + 4], 16)))
                        j += 4
                        continue
                    buf.append(_ESCAPES.get(esc, esc))
                    j += 2
                    continue
                buf.append(ch)
                j += 1
            out.append(Token("str", "".join(buf), line, nl))
            nl = False
            i = j + 1
            continue
        for op in OPERATORS:
            if src.startswith(op, i):
                out.append(Token("op", op, line, nl))
                nl = False
                i += len(op)
                break
        else:
            err(f"unexpected character {c!r}")
    out.append(Token("eof", None, line, nl))
    return out

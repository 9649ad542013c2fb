"""Lua stdlib subset + host/guest value conversion.

Only pure functions plus json — no io/os/require/load: the sandbox's
capability surface is exactly what install() places in globals plus the
`nk` bridge (runtime.py). Patterns in string.find/gmatch/gsub support
the common Lua classes (%a %d %s %w %p %l %u, quantifiers, anchors,
captures) by translation to Python regex.
"""

from __future__ import annotations

import json as _json
import re

from .interp import (
    FuelExhausted,
    Interp,
    LuaRuntimeError,
    LuaTable,
    lua_tonumber,
    lua_tostring,
    lua_truthy,
    lua_type,
)

# ------------------------------------------------------------ conversion


def to_lua(value):
    """Python -> guest value (deep)."""
    if value is None or isinstance(value, (bool, str)):
        return value
    if isinstance(value, (bytes, bytearray)):
        # Lua strings are byte strings; latin-1 is the lossless mapping.
        return bytes(value).decode("latin-1")
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, dict):
        t = LuaTable()
        for k, v in value.items():
            t.set(to_lua(k), to_lua(v))
        return t
    if isinstance(value, (list, tuple)):
        t = LuaTable()
        for i, v in enumerate(value):
            t.set(float(i + 1), to_lua(v))
        return t
    if callable(value):
        return value
    # Opaque host objects do not cross into the sandbox.
    return lua_tostring(str(value))


def from_lua(value, _depth: int = 0):
    """Guest -> Python (deep). A table whose keys are exactly 1..n maps
    to a list; otherwise a dict with stringified-where-needed keys."""
    if _depth > 32:
        raise LuaRuntimeError("value nesting too deep")
    if value is None or isinstance(value, (bool, str)):
        return value
    if isinstance(value, float):
        return int(value) if value.is_integer() else value
    if isinstance(value, LuaTable):
        n = value.length()
        if n and len(value.data) == n:
            return [
                from_lua(value.data[i + 1], _depth + 1) for i in range(n)
            ]
        out = {}
        for k, v in value.data.items():
            key = k if isinstance(k, str) else lua_tostring(
                float(k) if isinstance(k, int) else k
            )
            out[key] = from_lua(v, _depth + 1)
        return out
    return value  # functions pass through as host callables


# --------------------------------------------------------------- patterns

_CLASS = {
    "a": "[a-zA-Z]", "A": "[^a-zA-Z]",
    "d": "[0-9]", "D": "[^0-9]",
    "l": "[a-z]", "L": "[^a-z]",
    "s": "[ \\t\\n\\r\\f\\v]", "S": "[^ \\t\\n\\r\\f\\v]",
    "u": "[A-Z]", "U": "[^A-Z]",
    "w": "[a-zA-Z0-9]", "W": "[^a-zA-Z0-9]",
    "p": "[\\!-/\\:-@\\[-`\\{-~]", "P": "[^\\!-/\\:-@\\[-`\\{-~]",
}


# Class -> set-body expansion for use INSIDE [...] (no surrounding
# brackets; negated classes cannot be embedded in a positive set).
_CLASS_BODY = {
    "a": "a-zA-Z", "d": "0-9", "l": "a-z", "u": "A-Z",
    "s": " \\t\\n\\r\\f\\v", "w": "a-zA-Z0-9",
    "p": "\\!-/\\:-@\\[-`\\{-~",
}


def _lua_pattern_to_re(pat: str) -> str:
    out = []
    i, n = 0, len(pat)
    while i < n:
        c = pat[i]
        if c == "[":
            # Bracket set: '-' is a RANGE here (not the lazy quantifier)
            # and %classes expand to bare set bodies.
            j = i + 1
            body = []
            if j < n and pat[j] == "^":
                body.append("^")
                j += 1
            first = True
            while j < n and (pat[j] != "]" or first):
                first = False
                ch = pat[j]
                if ch == "%":
                    if j + 1 >= n:
                        raise LuaRuntimeError(
                            "malformed pattern (ends with %)"
                        )
                    nxt = pat[j + 1]
                    if nxt in _CLASS_BODY:
                        body.append(_CLASS_BODY[nxt])
                    elif nxt.isupper() and nxt.lower() in _CLASS_BODY:
                        raise LuaRuntimeError(
                            f"negated class %{nxt} inside a set is not"
                            " supported"
                        )
                    else:
                        body.append(re.escape(nxt))
                    j += 2
                    continue
                if ch == "-":
                    body.append("-")
                elif ch in "\\^]":
                    body.append("\\" + ch)
                else:
                    body.append(ch)
                j += 1
            if j >= n:
                raise LuaRuntimeError("malformed pattern (missing ']')")
            out.append("[" + "".join(body) + "]")
            i = j + 1
            continue
        if c == "%":
            if i + 1 >= n:
                raise LuaRuntimeError("malformed pattern (ends with %)")
            nxt = pat[i + 1]
            if nxt in _CLASS:
                out.append(_CLASS[nxt])
            else:
                out.append(re.escape(nxt))
            i += 2
            continue
        if c == "-":
            # Lua's lazy 'zero or more' quantifier.
            out.append("*?")
            i += 1
            continue
        if c in "().^$*+?":
            # These align with regex enough for the supported subset:
            # anchors, captures, greedy quantifiers.
            out.append(c)
            i += 1
            continue
        out.append(re.escape(c))
        i += 1
    return "".join(out)


def _compile_pat(pat: str) -> re.Pattern:
    try:
        return re.compile(_lua_pattern_to_re(pat))
    except re.error as e:
        raise LuaRuntimeError(f"malformed pattern: {e}")


# ----------------------------------------------------------------- stdlib


def _arg(args, i, default=None):
    return args[i] if i < len(args) else default


def install(g: LuaTable, print_fn=None):
    """Populate the sandbox globals. `print_fn(str)` receives print
    output (defaults to discarding)."""

    def reg(name, fn):
        g.set(name, fn)

    def _print(interp, *args):
        text = "\t".join(lua_tostring(a) for a in args)
        if print_fn is not None:
            print_fn(text)

    reg("print", _print)
    reg("type", lambda interp, v=None: lua_type(v))
    reg("tostring", lambda interp, v=None: lua_tostring(v))
    reg("tonumber", lambda interp, v=None, base=None: (
        float(int(v, int(base))) if base is not None and isinstance(v, str)
        else lua_tonumber(v)
    ))

    def _error(interp, message=None, level=None):
        raise LuaRuntimeError(message)

    reg("error", _error)

    def _assert(interp, *args):
        if not args or not lua_truthy(args[0]):
            raise LuaRuntimeError(
                _arg(args, 1, "assertion failed!")
            )
        return args

    reg("assert", _assert)

    def _pcall(interp, fn=None, *args):
        try:
            out = interp.call(fn, args)
            return (True,) + out
        except FuelExhausted:
            raise  # the budget is not catchable in-guest
        except LuaRuntimeError as e:
            return (False, e.value if e.value is not None else str(e))

    reg("pcall", _pcall)

    def _ipairs_iter(interp, t=None, i=None):
        i = (i or 0.0) + 1
        v = t.get(i) if isinstance(t, LuaTable) else None
        if v is None:
            return (None,)
        return (i, v)

    reg("ipairs", lambda interp, t=None: (_ipairs_iter, t, 0.0))

    def _next(interp, t=None, k=None):
        if not isinstance(t, LuaTable):
            raise LuaRuntimeError("bad argument to 'next' (table expected)")
        keys = list(t.data.keys())
        if k is None:
            idx = 0
        else:
            nk_ = k
            if isinstance(k, float) and k.is_integer():
                nk_ = int(k)
            try:
                idx = keys.index(nk_) + 1
            except ValueError:
                return (None,)
        if idx >= len(keys):
            return (None,)
        key = keys[idx]
        out_key = float(key) if isinstance(key, int) else key
        return (out_key, t.data[key])

    reg("next", _next)
    reg("pairs", lambda interp, t=None: (_next, t, None))

    def _select(interp, what=None, *args):
        if what == "#":
            return float(len(args))
        i = int(lua_tonumber(what) or 0)
        if i < 1:
            raise LuaRuntimeError("bad argument to 'select'")
        return args[i - 1:]

    reg("select", _select)

    def _unpack(interp, t=None, i=None, j=None):
        if not isinstance(t, LuaTable):
            raise LuaRuntimeError("bad argument to 'unpack'")
        lo = int(i or 1)
        hi = int(j if j is not None else t.length())
        if hi - lo >= 1_000_000:
            raise LuaRuntimeError("unpack range too large")
        return tuple(t.get(float(k)) for k in range(lo, hi + 1))

    reg("unpack", _unpack)
    reg(
        "rawget",
        lambda interp, t=None, k=None: (
            t.get(k) if isinstance(t, LuaTable) else None
        ),
    )

    def _rawset(interp, t=None, k=None, v=None):
        if not isinstance(t, LuaTable):
            raise LuaRuntimeError("bad argument to 'rawset'")
        t.set(k, v)
        return t

    reg("rawset", _rawset)

    # ------------------------------------------------------------- string
    strlib = LuaTable()
    g.set("string", strlib)

    def _norm_idx(i, length, default):
        if i is None:
            i = default
        i = int(i)
        if i < 0:
            i = max(length + i + 1, 1)
        elif i == 0:
            i = 1
        return i

    def _sub(interp, s=None, i=None, j=None):
        s = s or ""
        length = len(s)
        lo = _norm_idx(i, length, 1)
        hi = j if j is not None else -1
        hi = int(hi)
        if hi < 0:
            hi = length + hi + 1
        else:
            hi = min(hi, length)
        if lo > hi:
            return ""
        return s[lo - 1 : hi]

    strlib.set("sub", _sub)
    strlib.set("len", lambda interp, s="": float(len(s)))
    strlib.set("upper", lambda interp, s="": s.upper())
    strlib.set("lower", lambda interp, s="": s.lower())
    def _rep(interp, s="", n=0):
        count = int(lua_tonumber(n) or 0)
        if len(s) * max(count, 0) > 8_000_000:
            # Fuel can't see inside one host call: cap allocation so a
            # single rep can't take the process's memory.
            raise LuaRuntimeError("string.rep result too large")
        return s * count

    strlib.set("rep", _rep)
    strlib.set(
        "byte",
        lambda interp, s="", i=None: (
            float(ord(s[int(i or 1) - 1])) if s else None
        ),
    )
    strlib.set(
        "char",
        lambda interp, *cs: "".join(chr(int(c)) for c in cs),
    )

    def _format(interp, fmt=None, *args):
        if fmt is None:
            raise LuaRuntimeError("bad argument to 'format'")
        out = []
        ai = 0
        i = 0
        while i < len(fmt):
            c = fmt[i]
            if c != "%":
                out.append(c)
                i += 1
                continue
            j = i + 1
            while j < len(fmt) and fmt[j] in "-+ #0123456789.":
                j += 1
            if j >= len(fmt):
                raise LuaRuntimeError("invalid format string")
            spec, conv = fmt[i : j + 1], fmt[j]
            i = j + 1
            if conv == "%":
                out.append("%")
                continue
            value = _arg(args, ai)
            ai += 1
            if conv in "di":
                out.append(spec[:-1].replace("%", "%") % 0 if False else (
                    (spec[:-1] + "d") % int(lua_tonumber(value) or 0)
                ))
            elif conv in "fgGeE":
                out.append(spec % (lua_tonumber(value) or 0.0))
            elif conv == "x":
                out.append(spec % int(lua_tonumber(value) or 0))
            elif conv == "s":
                out.append(spec % lua_tostring(value))
            elif conv == "q":
                out.append(_json.dumps(lua_tostring(value)))
            else:
                raise LuaRuntimeError(
                    f"unsupported format option '%{conv}'"
                )
        return "".join(out)

    strlib.set("format", _format)

    def _find(interp, s=None, pat=None, init=None, plain=None):
        s = s or ""
        start = max(int(init or 1) - 1, 0)
        if lua_truthy(plain):
            idx = s.find(pat, start)
            if idx < 0:
                return (None,)
            return (float(idx + 1), float(idx + len(pat)))
        m = _compile_pat(pat).search(s, start)
        if m is None:
            return (None,)
        return (float(m.start() + 1), float(m.end())) + tuple(
            m.groups()
        )

    strlib.set("find", _find)

    def _match(interp, s=None, pat=None, init=None):
        s = s or ""
        m = _compile_pat(pat).search(s, max(int(init or 1) - 1, 0))
        if m is None:
            return (None,)
        if m.groups():
            return m.groups()
        return (m.group(0),)

    strlib.set("match", _match)

    def _gmatch(interp, s=None, pat=None):
        it = _compile_pat(pat).finditer(s or "")

        def step(interp2, *_ignored):
            for m in it:
                if m.groups():
                    return m.groups()
                return (m.group(0),)
            return (None,)

        return step

    strlib.set("gmatch", _gmatch)

    def _gsub(interp, s=None, pat=None, repl=None, n=None):
        s = s or ""
        count = [0]
        limit = int(n) if n is not None else -1
        if limit == 0:
            # Lua: n=0 replaces nothing; Python re.sub's count=0 means
            # unlimited — divergent semantics, handle explicitly.
            return (s, 0.0)

        def do_repl(m: re.Match) -> str:
            count[0] += 1
            if isinstance(repl, str):
                out = []
                i = 0
                while i < len(repl):
                    if repl[i] == "%" and i + 1 < len(repl):
                        d = repl[i + 1]
                        if d.isdigit():
                            gi = int(d)
                            out.append(
                                m.group(0) if gi == 0 else (m.group(gi) or "")
                            )
                            i += 2
                            continue
                        out.append(d)
                        i += 2
                        continue
                    out.append(repl[i])
                    i += 1
                return "".join(out)
            if isinstance(repl, LuaTable):
                v = repl.get(m.group(1) if m.groups() else m.group(0))
                return lua_tostring(v) if lua_truthy(v) else m.group(0)
            # function replacement
            args = m.groups() if m.groups() else (m.group(0),)
            out = interp.call(repl, args)
            v = out[0] if out else None
            return lua_tostring(v) if lua_truthy(v) else m.group(0)

        result = _compile_pat(pat).sub(
            do_repl, s, 0 if limit < 0 else limit
        )
        return (result, float(count[0]))

    strlib.set("gsub", _gsub)

    # -------------------------------------------------------------- table
    tablib = LuaTable()
    g.set("table", tablib)

    def _insert(interp, t=None, a=None, b=None):
        if not isinstance(t, LuaTable):
            raise LuaRuntimeError("bad argument to 'insert'")
        if b is None:
            t.set(float(t.length() + 1), a)
        else:
            pos = int(a)
            n = t.length()
            for i in range(n, pos - 1, -1):
                t.set(float(i + 1), t.get(float(i)))
            t.set(float(pos), b)

    tablib.set("insert", _insert)

    def _remove(interp, t=None, pos=None):
        if not isinstance(t, LuaTable):
            raise LuaRuntimeError("bad argument to 'remove'")
        n = t.length()
        if n == 0:
            return None
        p = int(pos) if pos is not None else n
        v = t.get(float(p))
        for i in range(p, n):
            t.set(float(i), t.get(float(i + 1)))
        t.set(float(n), None)
        return v

    tablib.set("remove", _remove)

    def _concat(interp, t=None, sep=None, i=None, j=None):
        if not isinstance(t, LuaTable):
            raise LuaRuntimeError("bad argument to 'concat'")
        lo = int(i or 1)
        hi = int(j if j is not None else t.length())
        if hi - lo >= 1_000_000:
            raise LuaRuntimeError("concat range too large")
        return (sep or "").join(
            lua_tostring(t.get(float(k))) for k in range(lo, hi + 1)
        )

    tablib.set("concat", _concat)

    def _sort(interp, t=None, cmp=None):
        if not isinstance(t, LuaTable):
            raise LuaRuntimeError("bad argument to 'sort'")
        n = t.length()
        items = [t.get(float(i)) for i in range(1, n + 1)]
        if cmp is None:
            items.sort(key=lambda v: (lua_type(v), v))
        else:
            import functools

            def compare(a, b):
                out = interp.call(cmp, (a, b))
                return -1 if (out and lua_truthy(out[0])) else 1

            items.sort(key=functools.cmp_to_key(compare))
        for i, v in enumerate(items):
            t.set(float(i + 1), v)

    tablib.set("sort", _sort)

    # --------------------------------------------------------------- math
    import math as _math

    mathlib = LuaTable()
    g.set("math", mathlib)
    mathlib.set("floor", lambda interp, x=0.0: float(_math.floor(
        lua_tonumber(x) or 0.0)))
    mathlib.set("ceil", lambda interp, x=0.0: float(_math.ceil(
        lua_tonumber(x) or 0.0)))
    mathlib.set("abs", lambda interp, x=0.0: abs(lua_tonumber(x) or 0.0))
    mathlib.set("sqrt", lambda interp, x=0.0: _math.sqrt(
        lua_tonumber(x) or 0.0))
    mathlib.set("max", lambda interp, *xs: max(
        lua_tonumber(x) for x in xs))
    mathlib.set("min", lambda interp, *xs: min(
        lua_tonumber(x) for x in xs))
    mathlib.set("fmod", lambda interp, a=0.0, b=1.0: _math.fmod(
        lua_tonumber(a) or 0.0, lua_tonumber(b) or 1.0))
    mathlib.set("pow", lambda interp, a=0.0, b=0.0: float(
        (lua_tonumber(a) or 0.0) ** (lua_tonumber(b) or 0.0)))
    mathlib.set("huge", float("inf"))
    mathlib.set("pi", _math.pi)

    # --------------------------------------------------------------- json
    jsonlib = LuaTable()
    g.set("json", jsonlib)

    def _encode(interp, v=None):
        try:
            return _json.dumps(from_lua(v))
        except (TypeError, ValueError) as e:
            raise LuaRuntimeError(f"json.encode: {e}")

    def _decode(interp, s=None):
        try:
            return to_lua(_json.loads(s or ""))
        except ValueError as e:
            raise LuaRuntimeError(f"json.decode: {e}")

    jsonlib.set("encode", _encode)
    jsonlib.set("decode", _decode)

    return g


def new_globals(print_fn=None) -> LuaTable:
    g = LuaTable()
    install(g, print_fn)
    return g


def new_interp(print_fn=None, fuel: int | None = None) -> Interp:
    return Interp(new_globals(print_fn), fuel=fuel)

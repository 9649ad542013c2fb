"""Pure stdlib subset + host<->guest conversions for the JS guest.

Capabilities: NOTHING ambient — no filesystem, network, process, import
or timers (Date.now is deliberately absent: guest code must use the nk
bridge's time()). Math.random is excluded for determinism. Everything
here is a pure function of its inputs, mirroring the Lua guest's
sandbox posture (runtime/lua/stdlib.py).
"""

from __future__ import annotations

import json as _json
import math

from .interp import (
    UNDEFINED,
    Env,
    JSArray,
    JSFunction,
    JSObject,
    JsRuntimeError,
    JsThrow,
    _num,
    _num_key,
    _prop_key,
    _strict_eq,
    _truthy,
)


def js_to_string(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return _num_key(v)
    if isinstance(v, str):
        return v
    if isinstance(v, JSArray):
        return ",".join(
            "" if x is None or x is UNDEFINED else js_to_string(x)
            for x in v.items
        )
    if isinstance(v, JSObject):
        return "[object Object]"
    if isinstance(v, JSFunction):
        return f"function {v.name}() {{ ... }}"
    if callable(v):
        return "function () { [native code] }"
    return str(v)


# ----------------------------------------------------------- conversions


def to_js(v):
    """Host Python value -> guest value (by conversion, never reference)."""
    if v is None or v is UNDEFINED:
        return v
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return v
    if isinstance(v, bytes):
        return v.decode("latin-1")
    if isinstance(v, (list, tuple)):
        return JSArray([to_js(x) for x in v])
    if isinstance(v, dict):
        return JSObject({str(k): to_js(x) for k, x in v.items()})
    if isinstance(v, (JSObject, JSArray)):
        return v
    as_dict = getattr(v, "as_dict", None)
    if callable(as_dict):
        return to_js(as_dict())
    import dataclasses

    if dataclasses.is_dataclass(v):
        return to_js(dataclasses.asdict(v))
    # Opaque host objects do not cross into the sandbox.
    return str(v)


def from_js(v):
    """Guest value -> plain Python (dict/list/str/float/bool/None)."""
    if v is UNDEFINED:
        return None
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, float):
        return int(v) if v.is_integer() and abs(v) < 2**53 else v
    if isinstance(v, JSArray):
        return [from_js(x) for x in v.items]
    if isinstance(v, JSObject):
        return {k: from_js(x) for k, x in v.props.items()}
    if isinstance(v, JSFunction) or callable(v):
        raise JsRuntimeError("cannot pass a function across the boundary")
    return v


def _json_default(v):
    if v is UNDEFINED:
        return None
    raise TypeError(str(type(v)))


def _to_jsonable(v):
    if v is UNDEFINED:
        return None
    if isinstance(v, JSArray):
        return [_to_jsonable(x) for x in v.items]
    if isinstance(v, JSObject):
        return {
            k: _to_jsonable(x)
            for k, x in v.props.items()
            if x is not UNDEFINED and not (
                isinstance(x, JSFunction) or callable(x)
            )
        }
    if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
        return int(v)
    if isinstance(v, (JSFunction,)) or callable(v):
        return None
    return v


# ---------------------------------------------------------------- methods

_STR_METHODS = {}
_ARR_METHODS = {}


def _str_method(name):
    def deco(fn):
        _STR_METHODS[name] = fn
        return fn

    return deco


def _arr_method(name):
    def deco(fn):
        _ARR_METHODS[name] = fn
        return fn

    return deco


def _idx(v, length, default):
    if v is UNDEFINED or v is None:
        return default
    f = _num(v)
    if math.isnan(f):  # JS coerces NaN indices to 0
        return 0
    if math.isinf(f):
        return length if f > 0 else 0
    i = int(f)
    if i < 0:
        i = max(0, length + i)
    return min(i, length)


# ---- string methods


@_str_method("slice")
def _s_slice(interp, s, start=UNDEFINED, end=UNDEFINED):
    return s[_idx(start, len(s), 0) : _idx(end, len(s), len(s))]


@_str_method("substring")
def _s_substring(interp, s, start=UNDEFINED, end=UNDEFINED):
    a, b = _idx(start, len(s), 0), _idx(end, len(s), len(s))
    return s[min(a, b) : max(a, b)]


@_str_method("indexOf")
def _s_indexof(interp, s, needle=UNDEFINED, start=UNDEFINED):
    return float(s.find(js_to_string(needle), _idx(start, len(s), 0)))


@_str_method("lastIndexOf")
def _s_lastindexof(interp, s, needle=UNDEFINED):
    return float(s.rfind(js_to_string(needle)))


@_str_method("includes")
def _s_includes(interp, s, needle=UNDEFINED):
    return js_to_string(needle) in s


@_str_method("startsWith")
def _s_startswith(interp, s, needle=UNDEFINED):
    return s.startswith(js_to_string(needle))


@_str_method("endsWith")
def _s_endswith(interp, s, needle=UNDEFINED):
    return s.endswith(js_to_string(needle))


@_str_method("toUpperCase")
def _s_upper(interp, s):
    return s.upper()


@_str_method("toLowerCase")
def _s_lower(interp, s):
    return s.lower()


@_str_method("trim")
def _s_trim(interp, s):
    return s.strip()


@_str_method("split")
def _s_split(interp, s, sep=UNDEFINED, limit=UNDEFINED):
    if sep is UNDEFINED:
        return JSArray([s])
    sep = js_to_string(sep)
    parts = list(s) if sep == "" else s.split(sep)
    if limit is not UNDEFINED:
        parts = parts[: int(_num(limit))]
    return JSArray(parts)


@_str_method("replace")
def _s_replace(interp, s, old=UNDEFINED, new=UNDEFINED):
    return s.replace(js_to_string(old), js_to_string(new), 1)


@_str_method("replaceAll")
def _s_replaceall(interp, s, old=UNDEFINED, new=UNDEFINED):
    return s.replace(js_to_string(old), js_to_string(new))


@_str_method("charAt")
def _s_charat(interp, s, i=UNDEFINED):
    idx = int(_num(i)) if i is not UNDEFINED else 0
    return s[idx] if 0 <= idx < len(s) else ""


@_str_method("charCodeAt")
def _s_charcodeat(interp, s, i=UNDEFINED):
    idx = int(_num(i)) if i is not UNDEFINED else 0
    return float(ord(s[idx])) if 0 <= idx < len(s) else math.nan


@_str_method("repeat")
def _s_repeat(interp, s, n=UNDEFINED):
    f = _num(n)
    count = 0 if math.isnan(f) else int(f)
    if count < 0:
        raise JsThrow(JSObject({"message": "invalid repeat count"}))
    interp.burn(count * max(1, len(s)) // 16 + 1)
    return s * count


@_str_method("padStart")
def _s_padstart(interp, s, width=UNDEFINED, fill=UNDEFINED):
    f = js_to_string(fill) if fill is not UNDEFINED else " "
    w = int(_num(width))
    pad_len = w - len(s)
    if pad_len <= 0 or not f:
        return s
    # Fuel proportional to the allocation (sandbox guarantee), and the
    # pad builds left-to-right then truncates — JS semantics for
    # multi-char fills ("5".padStart(6, "abc") == "abcab5").
    interp.burn(pad_len // 16 + 1)
    pad = (f * (pad_len // len(f) + 1))[:pad_len]
    return pad + s


@_str_method("padEnd")
def _s_padend(interp, s, width=UNDEFINED, fill=UNDEFINED):
    f = js_to_string(fill) if fill is not UNDEFINED else " "
    w = int(_num(width))
    pad_len = w - len(s)
    if pad_len <= 0 or not f:
        return s
    interp.burn(pad_len // 16 + 1)
    pad = (f * (pad_len // len(f) + 1))[:pad_len]
    return s + pad


@_str_method("toString")
def _s_tostring(interp, s):
    return s


# ---- array methods


@_arr_method("push")
def _a_push(interp, arr, *vals):
    arr.items.extend(vals)
    return float(len(arr.items))


@_arr_method("pop")
def _a_pop(interp, arr):
    return arr.items.pop() if arr.items else UNDEFINED


@_arr_method("shift")
def _a_shift(interp, arr):
    return arr.items.pop(0) if arr.items else UNDEFINED


@_arr_method("unshift")
def _a_unshift(interp, arr, *vals):
    arr.items[:0] = vals
    return float(len(arr.items))


@_arr_method("slice")
def _a_slice(interp, arr, start=UNDEFINED, end=UNDEFINED):
    n = len(arr.items)
    return JSArray(arr.items[_idx(start, n, 0) : _idx(end, n, n)])


@_arr_method("splice")
def _a_splice(interp, arr, start=UNDEFINED, count=UNDEFINED, *vals):
    n = len(arr.items)
    a = _idx(start, n, 0)
    c = n - a if count is UNDEFINED else max(0, int(_num(count)))
    removed = arr.items[a : a + c]
    arr.items[a : a + c] = list(vals)
    return JSArray(removed)


@_arr_method("concat")
def _a_concat(interp, arr, *others):
    out = list(arr.items)
    for o in others:
        if isinstance(o, JSArray):
            out.extend(o.items)
        else:
            out.append(o)
    return JSArray(out)


@_arr_method("indexOf")
def _a_indexof(interp, arr, needle=UNDEFINED):
    for i, x in enumerate(arr.items):
        if _strict_eq(x, needle):
            return float(i)
    return -1.0


@_arr_method("includes")
def _a_includes(interp, arr, needle=UNDEFINED):
    return any(_strict_eq(x, needle) for x in arr.items)


@_arr_method("join")
def _a_join(interp, arr, sep=UNDEFINED):
    s = "," if sep is UNDEFINED else js_to_string(sep)
    return s.join(
        "" if x is None or x is UNDEFINED else js_to_string(x)
        for x in arr.items
    )


@_arr_method("reverse")
def _a_reverse(interp, arr):
    arr.items.reverse()
    return arr


@_arr_method("map")
def _a_map(interp, arr, fn=UNDEFINED):
    return JSArray(
        [
            interp.call_function(fn, [x, float(i), arr])
            for i, x in enumerate(list(arr.items))
        ]
    )


@_arr_method("filter")
def _a_filter(interp, arr, fn=UNDEFINED):
    return JSArray(
        [
            x
            for i, x in enumerate(list(arr.items))
            if _truthy(interp.call_function(fn, [x, float(i), arr]))
        ]
    )


@_arr_method("forEach")
def _a_foreach(interp, arr, fn=UNDEFINED):
    for i, x in enumerate(list(arr.items)):
        interp.call_function(fn, [x, float(i), arr])
    return UNDEFINED


@_arr_method("find")
def _a_find(interp, arr, fn=UNDEFINED):
    for i, x in enumerate(list(arr.items)):
        if _truthy(interp.call_function(fn, [x, float(i), arr])):
            return x
    return UNDEFINED


@_arr_method("some")
def _a_some(interp, arr, fn=UNDEFINED):
    return any(
        _truthy(interp.call_function(fn, [x, float(i), arr]))
        for i, x in enumerate(list(arr.items))
    )


@_arr_method("every")
def _a_every(interp, arr, fn=UNDEFINED):
    return all(
        _truthy(interp.call_function(fn, [x, float(i), arr]))
        for i, x in enumerate(list(arr.items))
    )


@_arr_method("reduce")
def _a_reduce(interp, arr, fn=UNDEFINED, init=UNDEFINED):
    items = list(arr.items)
    if init is UNDEFINED:
        if not items:
            raise JsThrow(
                JSObject({"message": "reduce of empty array"})
            )
        acc, start = items[0], 1
    else:
        acc, start = init, 0
    for i in range(start, len(items)):
        acc = interp.call_function(fn, [acc, items[i], float(i), arr])
    return acc


@_arr_method("sort")
def _a_sort(interp, arr, fn=UNDEFINED):
    import functools

    if fn is UNDEFINED:
        arr.items.sort(key=js_to_string)
    else:
        def cmp(a, b):
            out = _num(interp.call_function(fn, [a, b]))
            return -1 if out < 0 else (1 if out > 0 else 0)

        arr.items.sort(key=functools.cmp_to_key(cmp))
    return arr


@_arr_method("toString")
def _a_tostring(interp, arr):
    return js_to_string(arr)


def member_of(interp, obj, name: str):
    """Property/method resolution for every guest value kind."""
    if isinstance(obj, JSObject):
        if name in obj.props:
            return obj.props[name]
        return UNDEFINED
    if isinstance(obj, JSArray):
        if name == "length":
            return float(len(obj.items))
        m = _ARR_METHODS.get(name)
        if m is not None:
            return _bind(m)
        try:
            i = int(name)
        except ValueError:
            return UNDEFINED
        return (
            obj.items[i] if 0 <= i < len(obj.items) else UNDEFINED
        )
    if isinstance(obj, str):
        if name == "length":
            return float(len(obj))
        m = _STR_METHODS.get(name)
        if m is not None:
            return _bind(m)
        return UNDEFINED
    if isinstance(obj, float):
        if name == "toFixed":
            def to_fixed(i2, this, digits=UNDEFINED):
                d = int(_num(digits)) if digits is not UNDEFINED else 0
                return f"{obj:.{d}f}"

            return to_fixed
        if name == "toString":
            return lambda i2, this: js_to_string(obj)
        return UNDEFINED
    if obj is None or obj is UNDEFINED:
        raise JsRuntimeError(
            f"cannot read property {name!r} of {js_to_string(obj)}"
        )
    if isinstance(obj, JSFunction) or callable(obj):
        if name == "call":
            target = obj

            def js_call(i2, this, new_this=UNDEFINED, *args):
                return i2.call_function(target, list(args), new_this)

            return js_call
        if name == "apply":
            target = obj

            def js_apply(i2, this, new_this=UNDEFINED, args=UNDEFINED):
                arglist = args.items if isinstance(args, JSArray) else []
                return i2.call_function(target, list(arglist), new_this)

            return js_apply
        return UNDEFINED
    if isinstance(obj, bool):
        if name == "toString":
            return lambda i2, this: js_to_string(obj)
        return UNDEFINED
    return UNDEFINED


def _bind(method):
    def bound(interp, this, *args):
        return method(interp, this, *args)

    return bound


# ----------------------------------------------------------------- globals


def new_globals(print_fn=None) -> Env:
    g = Env()
    printer = print_fn or (lambda text: None)

    def console_log(interp, this, *args):
        printer(" ".join(js_to_string(a) for a in args))
        return UNDEFINED

    console = JSObject(
        {
            "log": console_log,
            "info": console_log,
            "warn": console_log,
            "error": console_log,
        }
    )
    g.declare("console", console)

    def json_stringify(interp, this, v=UNDEFINED, _r=UNDEFINED,
                       indent=UNDEFINED):
        kw = {}
        if indent is not UNDEFINED:
            kw["indent"] = int(_num(indent))
        try:
            return _json.dumps(_to_jsonable(v), **kw)
        except (TypeError, ValueError) as e:
            raise JsThrow(JSObject({"message": f"JSON.stringify: {e}"}))

    def json_parse(interp, this, s=UNDEFINED):
        try:
            return to_js(_json.loads(js_to_string(s)))
        except ValueError as e:
            raise JsThrow(JSObject({"message": f"JSON.parse: {e}"}))

    g.declare(
        "JSON",
        JSObject({"stringify": json_stringify, "parse": json_parse}),
    )

    def _m1(fn):
        # JS math semantics: NaN/inf propagate as values; domain errors
        # and overflow yield NaN/Infinity — never a host exception.
        def call(interp, this, x=UNDEFINED):
            v = _num(x)
            if math.isnan(v):
                return math.nan
            try:
                return float(fn(v))
            except ValueError:
                return math.nan
            except OverflowError:
                return math.inf if v > 0 else -math.inf

        return call

    def _js_log(x):
        if x == 0:
            return -math.inf
        if x < 0:
            raise ValueError("log domain")
        return math.log(x)

    math_obj = JSObject(
        {
            "floor": _m1(math.floor),
            "ceil": _m1(math.ceil),
            "round": _m1(lambda x: math.floor(x + 0.5)),
            "trunc": _m1(math.trunc),
            "abs": _m1(abs),
            "sqrt": _m1(math.sqrt),
            "log": _m1(_js_log),
            "exp": _m1(math.exp),
            "sign": _m1(lambda x: (x > 0) - (x < 0)),
            "min": lambda interp, this, *a: (
                float(min((_num(x) for x in a), default=math.inf))
            ),
            "max": lambda interp, this, *a: (
                float(max((_num(x) for x in a), default=-math.inf))
            ),
            "pow": lambda interp, this, a=UNDEFINED, b=UNDEFINED: (
                _num(a) ** _num(b)
            ),
            "PI": math.pi,
            "E": math.e,
        }
    )
    g.declare("Math", math_obj)

    def object_keys(interp, this, o=UNDEFINED):
        if isinstance(o, JSObject):
            return JSArray(list(o.props.keys()))
        if isinstance(o, JSArray):
            return JSArray([_num_key(float(i)) for i in range(len(o.items))])
        raise JsThrow(JSObject({"message": "Object.keys needs an object"}))

    def object_values(interp, this, o=UNDEFINED):
        if isinstance(o, JSObject):
            return JSArray(list(o.props.values()))
        if isinstance(o, JSArray):
            return JSArray(list(o.items))
        raise JsThrow(JSObject({"message": "Object.values needs an object"}))

    def object_entries(interp, this, o=UNDEFINED):
        if isinstance(o, JSObject):
            return JSArray(
                [JSArray([k, v]) for k, v in o.props.items()]
            )
        raise JsThrow(JSObject({"message": "Object.entries needs an object"}))

    def object_assign(interp, this, target=UNDEFINED, *sources):
        if not isinstance(target, JSObject):
            raise JsThrow(
                JSObject({"message": "Object.assign needs an object"})
            )
        for s in sources:
            if isinstance(s, JSObject):
                target.props.update(s.props)
        return target

    g.declare(
        "Object",
        JSObject(
            {
                "keys": object_keys,
                "values": object_values,
                "entries": object_entries,
                "assign": object_assign,
            }
        ),
    )

    def array_is_array(interp, this, v=UNDEFINED):
        return isinstance(v, JSArray)

    g.declare("Array", JSObject({"isArray": array_is_array}))

    def parse_int(interp, this, s=UNDEFINED, base=UNDEFINED):
        text = js_to_string(s).strip()
        b = int(_num(base)) if base is not UNDEFINED else 10
        sign = 1
        if text[:1] in "+-":
            sign = -1 if text[0] == "-" else 1
            text = text[1:]
        if text.lower().startswith("0x") and (
            base is UNDEFINED or b == 16
        ):
            # JS auto-detects the 0x prefix when no radix is given.
            b = 16
            text = text[2:]
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:b]
        out = 0
        seen = False
        for ch in text.lower():
            d = digits.find(ch)
            if d < 0:
                break
            out = out * b + d
            seen = True
        return float(sign * out) if seen else math.nan

    def parse_float(interp, this, s=UNDEFINED):
        import re as _re

        # JS parseFloat: longest decimal prefix, never hex.
        m = _re.match(
            r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?",
            js_to_string(s),
        )
        return float(m.group(0)) if m else math.nan

    g.declare("parseInt", parse_int)
    g.declare("parseFloat", parse_float)
    g.declare(
        "isNaN", lambda interp, this, v=UNDEFINED: math.isnan(_num(v))
    )
    g.declare(
        "isFinite",
        lambda interp, this, v=UNDEFINED: math.isfinite(_num(v)),
    )
    g.declare("NaN", math.nan)
    g.declare("Infinity", math.inf)

    def string_ctor(interp, this, v=UNDEFINED):
        return js_to_string(v) if v is not UNDEFINED else ""

    def number_ctor(interp, this, v=UNDEFINED):
        return _num(v) if v is not UNDEFINED else 0.0

    def boolean_ctor(interp, this, v=UNDEFINED):
        return _truthy(v)

    g.declare("String", string_ctor)
    g.declare("Number", number_ctor)
    g.declare("Boolean", boolean_ctor)

    def error_ctor(interp, this, msg=UNDEFINED):
        return JSObject(
            {"message": js_to_string(msg) if msg is not UNDEFINED else ""}
        )

    g.declare("Error", error_ctor)
    return g

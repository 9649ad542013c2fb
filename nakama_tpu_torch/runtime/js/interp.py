"""Tree-walking evaluator for the JS subset, with an instruction-fuel
budget and a call-depth cap (same sandbox discipline as the Lua guest:
runtime/lua/interp.py). Original implementation.

Value mapping: numbers are Python floats (JS numbers are IEEE doubles),
strings str, booleans bool, null is None, undefined the UNDEFINED
sentinel, objects JSObject (insertion-ordered string-keyed dict), arrays
JSArray (list wrapper), functions JSFunction (closures) or host
callables.
"""

from __future__ import annotations

import math


class JsError(Exception):
    """Host-visible guest failure (syntax/uncaught throw)."""

    def __init__(self, message, value=None):
        super().__init__(message)
        self.value = value if value is not None else message


class JsRuntimeError(JsError):
    pass


class JsAbortError(JsRuntimeError):
    """Aborts guest execution unconditionally — neither guest catch nor
    guest finally runs during its unwind (the interpreter may no longer
    be safe to execute on this thread, e.g. after module-lock loss)."""


class JsFuelError(JsAbortError):
    """Budget exhaustion — deliberately NOT catchable by guest try/catch."""


class JsThrow(Exception):
    """In-flight guest `throw` — carries the thrown JS value."""

    def __init__(self, value):
        super().__init__(_to_display(value))
        self.value = value


class _Undefined:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


UNDEFINED = _Undefined()


class JSObject:
    __slots__ = ("props", "jsclass")

    def __init__(self, props=None):
        self.props = props or {}
        # The JSClass this object was constructed from (method lookup
        # falls back to the class chain); plain objects carry None.
        self.jsclass = None

    def get(self, key):
        return self.props.get(key, UNDEFINED)

    def set(self, key, value):
        self.props[key] = value


class JSArray:
    __slots__ = ("items",)

    def __init__(self, items=None):
        self.items = items if items is not None else []


class JSFunction:
    __slots__ = (
        "name", "params", "body", "env", "is_arrow", "this", "home"
    )

    def __init__(self, name, params, body, env, is_arrow, this=UNDEFINED):
        self.name = name or "anonymous"
        self.params = params
        self.body = body
        self.env = env
        self.is_arrow = is_arrow
        self.this = this  # captured lexically for arrows
        # The JSClass a method was defined on: `super` resolves from
        # here (the parent of the DEFINING class, not the instance's —
        # the ES home-object rule). Plain functions carry None.
        self.home = None


class JSClass:
    """A `class` declaration's value: constructor + method tables with
    a parent link. Instances are ordinary JSObjects whose `jsclass`
    points here — method lookup walks the chain, so there is no
    per-instance copying and overrides are the nearest-class-wins
    rule."""

    __slots__ = ("name", "parent", "ctor", "methods", "statics")

    def __init__(self, name, parent=None):
        self.name = name
        self.parent = parent
        self.ctor = None
        self.methods = {}
        self.statics = {}

    def find_method(self, name):
        cls = self
        while cls is not None:
            fn = cls.methods.get(name)
            if fn is not None:
                return fn
            cls = cls.parent
        return None

    def find_static(self, name):
        cls = self
        while cls is not None:
            fn = cls.statics.get(name)
            if fn is not None:
                return fn
            cls = cls.parent
        return None


class JSSuper:
    """The `super` binding inside a constructor/method: calling it runs
    the parent constructor chain on the SAME instance; `super.m(...)`
    resolves `m` on the parent chain and calls it with the original
    instance as `this`."""

    __slots__ = ("cls", "obj")

    def __init__(self, cls, obj):
        self.cls = cls  # the parent class of the method's home
        self.obj = obj  # the instance under construction / receiver


class Env:
    __slots__ = ("vars", "parent", "consts")

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent
        self.consts = set()

    def lookup(self, name):
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        raise JsRuntimeError(f"{name} is not defined")

    def assign(self, name, value):
        env = self
        while env is not None:
            if name in env.vars:
                if name in env.consts:
                    raise JsRuntimeError(
                        f"assignment to constant variable {name}"
                    )
                env.vars[name] = value
                return
            env = env.parent
        raise JsRuntimeError(f"{name} is not defined")

    def declare(self, name, value, const=False):
        self.vars[name] = value
        if const:
            self.consts.add(name)


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


MAX_DEPTH = 120


def _num_key(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)


def _to_display(v) -> str:
    from .stdlib import js_to_string

    return js_to_string(v)


class Interp:
    def __init__(self, global_env: Env):
        self.globals = global_env
        self.fuel = 1_000_000
        self.depth = 0

    # ----------------------------------------------------------- plumbing

    def burn(self, units=1):
        self.fuel -= units
        if self.fuel <= 0:
            raise JsFuelError("instruction budget exhausted")

    def run_chunk(self, program):
        self.exec_block(program, Env(self.globals))

    def call(self, fn, args, this=UNDEFINED):
        """Host entry: invoke a guest (or host) function value."""
        return self.call_function(fn, list(args), this)

    # --------------------------------------------------------- statements

    def exec_block(self, node, env):
        for stmt in node[1]:
            self.exec_stmt(stmt, env)

    def exec_stmt(self, node, env):
        self.burn()
        kind = node[0]
        if kind == "expr":
            self.eval(node[1], env)
        elif kind == "decl":
            _, kw, decls = node
            for name, init in decls:
                value = UNDEFINED if init is None else self.eval(init, env)
                env.declare(name, value, const=(kw == "const"))
        elif kind == "block":
            inner = Env(env)
            for stmt in node[1]:
                self.exec_stmt(stmt, inner)
        elif kind == "if":
            if _truthy(self.eval(node[1], env)):
                self.exec_stmt(node[2], env)
            elif node[3] is not None:
                self.exec_stmt(node[3], env)
        elif kind == "while":
            while _truthy(self.eval(node[1], env)):
                self.burn()
                try:
                    self.exec_stmt(node[2], env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "dowhile":
            while True:
                self.burn()
                try:
                    self.exec_stmt(node[2], env)
                except _Break:
                    break
                except _Continue:
                    pass
                if not _truthy(self.eval(node[1], env)):
                    break
        elif kind == "for":
            _, init, cond, step, body = node
            loop_env = Env(env)
            if init is not None:
                self.exec_stmt(init, loop_env)
            while cond is None or _truthy(self.eval(cond, loop_env)):
                self.burn()
                try:
                    self.exec_stmt(body, loop_env)
                except _Break:
                    break
                except _Continue:
                    pass
                if step is not None:
                    self.eval(step, loop_env)
        elif kind == "forin":
            _, mode, name, obj_node, body = node
            obj = self.eval(obj_node, env)
            if mode == "of":
                if isinstance(obj, JSArray):
                    seq = list(obj.items)
                elif isinstance(obj, str):
                    seq = list(obj)
                else:
                    raise JsRuntimeError("for..of needs an array or string")
            else:  # in: keys
                if isinstance(obj, JSArray):
                    seq = [_num_key(float(i)) for i in range(len(obj.items))]
                elif isinstance(obj, JSObject):
                    seq = list(obj.props.keys())
                elif obj is None or obj is UNDEFINED:
                    seq = []
                else:
                    raise JsRuntimeError("for..in needs an object")
            for item in seq:
                self.burn()
                loop_env = Env(env)
                loop_env.declare(name, item)
                try:
                    self.exec_stmt(body, loop_env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif kind == "return":
            raise _Return(
                UNDEFINED if node[1] is None else self.eval(node[1], env)
            )
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()
        elif kind == "throw":
            raise JsThrow(self.eval(node[1], env))
        elif kind == "try":
            _, body, catch_name, catch_body, finally_body = node
            aborted = False
            try:
                try:
                    self.exec_stmt(body, env)
                except JsAbortError:
                    raise  # fuel / lock loss: not guest-catchable
                except JsThrow as e:
                    if catch_body is not None:
                        catch_env = Env(env)
                        if catch_name:
                            catch_env.declare(catch_name, e.value)
                        self.exec_stmt(catch_body, catch_env)
                    else:
                        raise
                except JsRuntimeError as e:
                    if catch_body is not None:
                        catch_env = Env(env)
                        if catch_name:
                            err_obj = JSObject({"message": str(e)})
                            catch_env.declare(catch_name, err_obj)
                        self.exec_stmt(catch_body, catch_env)
                    else:
                        raise
            except JsAbortError:
                # From the body or the catch handler: guest finally must
                # not run either — the interpreter may be unsafe on this
                # thread (lock loss) or out of budget.
                aborted = True
                raise
            finally:
                if finally_body is not None and not aborted:
                    self.exec_stmt(finally_body, env)
        elif kind == "switch":
            _, disc_node, cases = node
            disc = self.eval(disc_node, env)
            matched = False
            try:
                for test, body in cases:
                    if not matched:
                        if test is None:
                            continue
                        if not _strict_eq(disc, self.eval(test, env)):
                            continue
                        matched = True
                    for stmt in body:
                        self.exec_stmt(stmt, env)
                if not matched:
                    seen_default = False
                    for test, body in cases:
                        if test is None:
                            seen_default = True
                        if seen_default:
                            for stmt in body:
                                self.exec_stmt(stmt, env)
            except _Break:
                pass
        elif kind == "classdecl":
            _, name, parent_node, ctor_node, methods, statics = node
            parent = None
            if parent_node is not None:
                parent = self.eval(parent_node, env)
                if not isinstance(parent, JSClass):
                    raise JsRuntimeError(
                        f"class {name} can only extend another class"
                    )
            cls = JSClass(name, parent)

            def mk(fn_node):
                _, fname, params, body, _arrow = fn_node
                fn = JSFunction(fname, params, body, env, False)
                fn.home = cls
                return fn

            if ctor_node is not None:
                cls.ctor = mk(ctor_node)
            for mname, fn_node in methods:
                cls.methods[mname] = mk(fn_node)
            for mname, fn_node in statics:
                cls.statics[mname] = mk(fn_node)
            env.declare(name, cls)
        elif kind == "empty":
            pass
        else:  # pragma: no cover
            raise JsRuntimeError(f"unknown statement {kind}")

    # -------------------------------------------------------- expressions

    def eval(self, node, env, this=UNDEFINED):
        self.burn()
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "str":
            return node[1]
        if kind == "bool":
            return node[1]
        if kind == "null":
            return None
        if kind == "undef":
            return UNDEFINED
        if kind == "this":
            return env.lookup("this") if _has(env, "this") else UNDEFINED
        if kind == "name":
            return env.lookup(node[1])
        if kind == "array":
            return JSArray([self.eval(x, env) for x in node[1]])
        if kind == "object":
            obj = JSObject()
            for key_node, value_node in node[1]:
                if key_node[0] == "const_key":
                    key = key_node[1]
                else:
                    key = _prop_key(self.eval(key_node, env))
                obj.set(key, self.eval(value_node, env))
            return obj
        if kind == "function":
            _, name, params, body, is_arrow = node
            this_val = UNDEFINED
            if is_arrow and _has(env, "this"):
                this_val = env.lookup("this")
            return JSFunction(name, params, body, env, is_arrow, this_val)
        if kind == "member":
            obj = self.eval(node[1], env)
            return self.get_member(obj, node[2])
        if kind == "index":
            obj = self.eval(node[1], env)
            key = self.eval(node[2], env)
            return self.get_index(obj, key)
        if kind == "call":
            return self.eval_call(node, env)
        if kind == "logic":
            left = self.eval(node[2], env)
            if node[1] == "&&":
                return self.eval(node[3], env) if _truthy(left) else left
            return left if _truthy(left) else self.eval(node[3], env)
        if kind == "bin":
            return self.binop(
                node[1], self.eval(node[2], env), self.eval(node[3], env)
            )
        if kind == "unary":
            return self.unop(node[1], node[2], env)
        if kind == "cond":
            if _truthy(self.eval(node[1], env)):
                return self.eval(node[2], env)
            return self.eval(node[3], env)
        if kind == "assign":
            return self.eval_assign(node, env)
        if kind == "update":
            return self.eval_update(node, env)
        if kind == "comma":
            self.eval(node[1], env)
            return self.eval(node[2], env)
        if kind == "new":
            return self.eval_new(node, env)
        raise JsRuntimeError(f"unknown expression {kind}")  # pragma: no cover

    def eval_new(self, node, env):
        """`new Ctor(args)`: prototype-less object construction — a
        fresh JSObject bound as `this`, the constructor body run, and
        the object returned unless the body explicitly returns an
        object/array (the ES constructor contract; primitive returns
        are discarded)."""
        _, callee, arg_nodes = node
        fn = self.eval(callee, env)
        args = []
        for a in arg_nodes:
            if a[0] == "spread":
                args.extend(self._spread_values(self.eval(a[1], env)))
            else:
                args.append(self.eval(a, env))
        if isinstance(fn, JSClass):
            obj = JSObject()
            obj.jsclass = fn
            self._construct(fn, args, obj)
            return obj
        if not isinstance(fn, JSFunction) or fn.is_arrow:
            raise JsRuntimeError("not a constructor")
        obj = JSObject()
        result = self.call_function(fn, args, this=obj)
        if isinstance(result, (JSObject, JSArray)):
            return result
        return obj

    def _construct(self, cls, args, obj):
        """Run the constructor chain: the nearest own constructor (its
        `super(...)` continues the chain explicitly), or the ES default
        derived constructor — pass the same args up."""
        if cls.ctor is not None:
            self.call_function(cls.ctor, args, this=obj)
        elif cls.parent is not None:
            self._construct(cls.parent, args, obj)

    def eval_call(self, node, env):
        _, callee, arg_nodes = node
        this = UNDEFINED
        if callee[0] == "member":
            obj = self.eval(callee[1], env)
            fn = self.get_member(obj, callee[2])
            this = obj
        elif callee[0] == "index":
            obj = self.eval(callee[1], env)
            fn = self.get_index(obj, self.eval(callee[2], env))
            this = obj
        else:
            fn = self.eval(callee, env)
        args = []
        for a in arg_nodes:
            if a[0] == "spread":
                args.extend(self._spread_values(self.eval(a[1], env)))
            else:
                args.append(self.eval(a, env))
        return self.call_function(fn, args, this)

    def _spread_values(self, value):
        """Flatten one `...expr` call argument (arrays and strings —
        the iterables this subset has)."""
        if isinstance(value, JSArray):
            return list(value.items)
        if isinstance(value, str):
            return list(value)
        raise JsRuntimeError("spread argument is not iterable")

    def call_function(self, fn, args, this=UNDEFINED):
        if isinstance(fn, JSSuper):
            # `super(...)`: continue the constructor chain on the same
            # instance.
            self._construct(fn.cls, args, fn.obj)
            return UNDEFINED
        if isinstance(fn, JSClass):
            raise JsRuntimeError(
                f"class {fn.name} must be called with new"
            )
        if isinstance(fn, JSFunction):
            if self.depth >= MAX_DEPTH:
                raise JsRuntimeError("call depth limit exceeded")
            self.burn(4)
            call_env = Env(fn.env)
            for i, p in enumerate(fn.params):
                if isinstance(p, tuple):  # ("rest", name): the tail
                    call_env.declare(p[1], JSArray(list(args[i:])))
                    break
                call_env.declare(p, args[i] if i < len(args) else UNDEFINED)
            call_env.declare(
                "arguments", JSArray(list(args))
            )
            call_env.declare("this", fn.this if fn.is_arrow else this)
            if fn.home is not None and fn.home.parent is not None:
                call_env.declare("super", JSSuper(fn.home.parent, this))
            self.depth += 1
            try:
                self.exec_stmt(fn.body, call_env)
            except _Return as r:
                return r.value
            finally:
                self.depth -= 1
            return UNDEFINED
        if callable(fn):
            self.burn(4)
            try:
                return fn(self, this, *args)
            except (
                JsThrow, JsRuntimeError, _Break, _Continue, _Return
            ):
                raise
            except (ValueError, OverflowError, ZeroDivisionError,
                    TypeError) as e:
                # Sandbox boundary: a host-level numeric/argument error
                # from a stdlib builtin must surface as a guest-catchable
                # exception, never escape as a raw Python error.
                raise JsThrow(
                    JSObject({"message": f"{type(e).__name__}: {e}"})
                )
        raise JsRuntimeError(f"{_to_display(fn)} is not a function")

    # ------------------------------------------------------ member/index

    def get_member(self, obj, name):
        if isinstance(obj, JSSuper):
            m = obj.cls.find_method(name)
            if m is None:
                raise JsRuntimeError(f"super has no method {name!r}")
            inst = obj.obj
            # Bound: `this` inside the parent method is the ORIGINAL
            # instance, whatever receiver the call site used.
            return lambda interp, this, *a: interp.call_function(
                m, list(a), this=inst
            )
        if isinstance(obj, JSClass):
            s = obj.find_static(name)
            if s is not None:
                return s
            if name == "name":
                return obj.name
            raise JsRuntimeError(
                f"class {obj.name} has no static {name!r}"
            )
        if (
            isinstance(obj, JSObject)
            and obj.jsclass is not None
            and name not in obj.props
        ):
            m = obj.jsclass.find_method(name)
            if m is not None:
                return m
        from .stdlib import member_of

        return member_of(self, obj, name)

    def get_index(self, obj, key):
        if isinstance(obj, JSArray) and isinstance(key, float):
            if not key.is_integer():  # arr[1.5] is undefined, not arr[1]
                return UNDEFINED
            i = int(key)
            if 0 <= i < len(obj.items):
                return obj.items[i]
            return UNDEFINED
        if isinstance(obj, str) and isinstance(key, float):
            if not key.is_integer():
                return UNDEFINED
            i = int(key)
            return obj[i] if 0 <= i < len(obj) else UNDEFINED
        return self.get_member(obj, _prop_key(key))

    def set_member(self, obj, name, value):
        if isinstance(obj, JSObject):
            obj.set(name, value)
            return
        if isinstance(obj, JSArray):
            try:
                i = int(float(name))
            except (TypeError, ValueError):
                raise JsRuntimeError("arrays take numeric indices")
            if i < 0:
                raise JsRuntimeError("negative array index")
            while len(obj.items) <= i:
                self.burn()
                obj.items.append(UNDEFINED)
            obj.items[i] = value
            return
        raise JsRuntimeError(
            f"cannot set property on {_to_display(obj)}"
        )

    def set_index(self, obj, key, value):
        if isinstance(obj, JSArray) and isinstance(key, float):
            self.set_member(obj, _num_key(key), value)
            return
        self.set_member(obj, _prop_key(key), value)

    # ---------------------------------------------------------- operators

    def binop(self, op, a, b):
        if op == "+":
            if isinstance(a, str) or isinstance(b, str):
                return _to_display(a) + _to_display(b)
            return _num(a) + _num(b)
        if op == "-":
            return _num(a) - _num(b)
        if op == "*":
            return _num(a) * _num(b)
        if op == "/":
            bb = _num(b)
            aa = _num(a)
            if bb == 0:
                if aa == 0 or math.isnan(aa):
                    return math.nan
                return math.inf if aa > 0 else -math.inf
            return aa / bb
        if op == "%":
            bb = _num(b)
            aa = _num(a)
            if bb == 0:
                return math.nan
            return math.fmod(aa, bb)
        if op == "**":
            return _num(a) ** _num(b)
        if op in ("<", ">", "<=", ">="):
            if isinstance(a, str) and isinstance(b, str):
                pass
            else:
                a, b = _num(a), _num(b)
                if math.isnan(a) or math.isnan(b):
                    return False
            if op == "<":
                return a < b
            if op == ">":
                return a > b
            if op == "<=":
                return a <= b
            return a >= b
        if op == "===":
            return _strict_eq(a, b)
        if op == "!==":
            return not _strict_eq(a, b)
        if op == "==":
            return _loose_eq(a, b)
        if op == "!=":
            return not _loose_eq(a, b)
        if op in ("&", "|", "^", "<<", ">>", ">>>"):
            ia, ib = _int32(a), _int32(b)
            if op == "&":
                r = ia & ib
            elif op == "|":
                r = ia | ib
            elif op == "^":
                r = ia ^ ib
            elif op == "<<":
                r = _wrap32(ia << (ib & 31))
            elif op == ">>":
                r = ia >> (ib & 31)
            else:  # >>>
                r = (ia & 0xFFFFFFFF) >> (ib & 31)
                return float(r)
            return float(_wrap32(r))
        if op == "in":
            if isinstance(b, JSObject):
                return _prop_key(a) in b.props
            if isinstance(b, JSArray):
                try:
                    i = int(_num(a))
                except (ValueError, OverflowError):
                    return False
                return 0 <= i < len(b.items)
            raise JsRuntimeError("'in' needs an object")
        raise JsRuntimeError(f"unknown operator {op}")  # pragma: no cover

    def unop(self, op, operand_node, env):
        if op == "typeof":
            if operand_node[0] == "name":
                # typeof undeclaredName is "undefined", not an error —
                # ONLY for a bare name; real errors inside a compound
                # operand (null deref, fuel) must propagate.
                try:
                    v = self.eval(operand_node, env)
                except JsAbortError:
                    raise
                except JsRuntimeError:
                    return "undefined"
            else:
                v = self.eval(operand_node, env)
            return _typeof(v)
        if op == "delete":
            if operand_node[0] == "member":
                obj = self.eval(operand_node[1], env)
                key = operand_node[2]
            else:
                obj = self.eval(operand_node[1], env)
                key = _prop_key(self.eval(operand_node[2], env))
            if isinstance(obj, JSObject):
                obj.props.pop(key, None)
                return True
            return False
        v = self.eval(operand_node, env)
        if op == "!":
            return not _truthy(v)
        if op == "-":
            return -_num(v)
        if op == "+":
            return _num(v)
        if op == "~":
            return float(_wrap32(~_int32(v)))
        if op == "void":
            return UNDEFINED
        raise JsRuntimeError(f"unknown unary {op}")  # pragma: no cover

    def _resolve_ref(self, target, env):
        """Evaluate an assignment target's object/key subexpressions
        ONCE: compound assignment and ++/-- must not re-run their side
        effects (a[i++] += x would otherwise bump i twice and write the
        wrong element)."""
        if target[0] == "name":
            return ("name", target[1], None)
        if target[0] == "member":
            return ("member", self.eval(target[1], env), target[2])
        return ("index", self.eval(target[1], env),
                self.eval(target[2], env))

    def _ref_read(self, ref, env):
        kind, a, b = ref
        if kind == "name":
            return env.lookup(a)
        if kind == "member":
            return self.get_member(a, b)
        return self.get_index(a, b)

    def _ref_write(self, ref, value, env):
        kind, a, b = ref
        if kind == "name":
            env.assign(a, value)
        elif kind == "member":
            self.set_member(a, b, value)
        else:
            self.set_index(a, b, value)

    def eval_assign(self, node, env):
        _, op, target, value_node = node
        ref = self._resolve_ref(target, env)
        if op != "=":
            # JS order: the target's OLD value reads before the RHS runs
            # (a += (a = 5, 2) is old_a + 2, not 7).
            old = self._ref_read(ref, env)
            value = self.binop(op[:-1], old, self.eval(value_node, env))
        else:
            value = self.eval(value_node, env)
        self._ref_write(ref, value, env)
        return value

    def eval_update(self, node, env):
        _, op, target, prefix = node
        ref = self._resolve_ref(target, env)
        current = _num(self._ref_read(ref, env))
        updated = current + (1.0 if op == "++" else -1.0)
        self._ref_write(ref, updated, env)
        return updated if prefix else current


# ------------------------------------------------------------- coercions


def _has(env, name):
    e = env
    while e is not None:
        if name in e.vars:
            return True
        e = e.parent
    return False


def _truthy(v) -> bool:
    if v is None or v is UNDEFINED:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        return not (v == 0 or math.isnan(v))
    if isinstance(v, str):
        return len(v) > 0
    return True


def _num(v) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, float):
        return v
    if v is None:
        return 0.0
    if v is UNDEFINED:
        return math.nan
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0.0
        try:
            return float(int(s, 16)) if s.lower().startswith("0x") else float(s)
        except ValueError:
            return math.nan
    if isinstance(v, JSArray):
        if not v.items:
            return 0.0
        if len(v.items) == 1:
            return _num(v.items[0])
        return math.nan
    return math.nan


def _int32(v) -> int:
    f = _num(v)
    if math.isnan(f) or math.isinf(f):
        return 0
    return _wrap32(int(f))


def _wrap32(i: int) -> int:
    i &= 0xFFFFFFFF
    return i - 0x100000000 if i >= 0x80000000 else i


def _typeof(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "object"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (JSFunction, JSClass)) or callable(v):
        return "function"
    return "object"


def _strict_eq(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return False
        return a == b
    if type(a) is not type(b):
        return a is b
    if isinstance(a, (str,)):
        return a == b
    return a is b


def _loose_eq(a, b) -> bool:
    nullish_a = a is None or a is UNDEFINED
    nullish_b = b is None or b is UNDEFINED
    if nullish_a or nullish_b:
        return nullish_a and nullish_b
    if isinstance(a, bool):
        return _loose_eq(_num(a), b)
    if isinstance(b, bool):
        return _loose_eq(a, _num(b))
    if isinstance(a, float) and isinstance(b, str):
        return _loose_eq(a, _num(b))
    if isinstance(a, str) and isinstance(b, float):
        return _loose_eq(_num(a), b)
    return _strict_eq(a, b)


def _prop_key(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, float):
        return _num_key(v)
    return _to_display(v)

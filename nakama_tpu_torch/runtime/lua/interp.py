"""Tree-walking interpreter for the Lua subset (sandbox core).

Original implementation. Values map: nil=None, boolean=bool,
number=float, string=str, table=LuaTable, function=LuaFunction or a
host Python callable. Multiple returns travel as Python tuples only at
the call boundary (`MULTI` contexts); everywhere else a single value.

Sandboxing: the environment root is a plain globals LuaTable populated
ONLY by stdlib.install() — there is no path from guest code to Python
objects except host callables explicitly placed there. A fuel budget
(decremented per evaluated node) bounds CPU; FuelExhausted is NOT
catchable by guest pcall, so a hostile module cannot absorb it.
"""

from __future__ import annotations


class LuaError(Exception):
    """Base for guest-visible errors (syntax + runtime)."""


class LuaRuntimeError(LuaError):
    """error() / type errors — catchable by guest pcall."""

    def __init__(self, value):
        super().__init__(lua_tostring(value))
        self.value = value


class FuelExhausted(LuaError):
    """Instruction budget exhausted — NOT catchable by guest pcall."""


class BreakSignal(Exception):
    pass


class ReturnSignal(Exception):
    def __init__(self, values: tuple):
        self.values = values


def _normkey(k):
    if isinstance(k, float) and k.is_integer():
        return int(k)
    if isinstance(k, bool):  # booleans are valid table keys in Lua
        return k
    return k


class LuaTable:
    __slots__ = ("data",)

    def __init__(self, data: dict | None = None):
        self.data = data or {}

    def get(self, k):
        return self.data.get(_normkey(k))

    def set(self, k, v):
        if k is None:
            raise LuaRuntimeError("table index is nil")
        k = _normkey(k)
        if v is None:
            self.data.pop(k, None)
        else:
            self.data[k] = v

    def length(self) -> int:
        n = 0
        while (n + 1) in self.data:
            n += 1
        return n

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"LuaTable({self.data!r})"


class LuaFunction:
    __slots__ = ("params", "is_vararg", "body", "env", "name")

    def __init__(self, params, is_vararg, body, env, name="?"):
        self.params = params
        self.is_vararg = is_vararg
        self.body = body
        self.env = env
        self.name = name


class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: "Env | None" = None):
        self.vars: dict = {}
        self.parent = parent

    def lookup(self, name: str):
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars
            env = env.parent
        return None


def lua_truthy(v) -> bool:
    return v is not None and v is not False


def lua_type(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    return "function"


def lua_tostring(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if v.is_integer() and abs(v) < 1e16:
            return str(int(v))
        return repr(v)
    if isinstance(v, str):
        return v
    if isinstance(v, LuaTable):
        return f"table: 0x{id(v):x}"
    return f"function: 0x{id(v):x}"


def lua_tonumber(v):
    if isinstance(v, float):
        return v
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, str):
        s = v.strip()
        try:
            if s.lower().startswith(("0x", "-0x")):
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return None
    return None


class Interp:
    DEFAULT_FUEL = 5_000_000
    # Each guest frame costs ~6 Python frames in this tree-walker; the
    # cap must trip well before CPython's own recursion limit (1000).
    MAX_DEPTH = 110

    def __init__(self, globals_table: LuaTable, fuel: int | None = None):
        self.globals = globals_table
        self.fuel = fuel if fuel is not None else self.DEFAULT_FUEL
        self.depth = 0

    # ------------------------------------------------------------ plumbing

    def burn(self):
        self.fuel -= 1
        if self.fuel <= 0:
            raise FuelExhausted("lua instruction budget exhausted")

    def run_chunk(self, block, chunk_env: Env | None = None):
        env = chunk_env or Env()
        try:
            self.exec_block(block, env)
        except ReturnSignal as r:
            return r.values
        return ()

    # ----------------------------------------------------------- execution

    def exec_block(self, block, env: Env):
        for stmt in block:
            self.exec_stmt(stmt, env)

    def exec_stmt(self, stmt, env: Env):
        self.burn()
        kind = stmt[0]
        if kind == "local":
            _, names, exprs = stmt
            values = self.eval_multi(exprs, env, len(names))
            for name, value in zip(names, values):
                env.vars[name] = value
        elif kind == "assign":
            _, targets, exprs = stmt
            values = self.eval_multi(exprs, env, len(targets))
            for tgt, value in zip(targets, values):
                self.assign(tgt, value, env)
        elif kind == "callstat":
            self.eval_expr_tuple(stmt[1], env)
        elif kind == "if":
            _, arms, else_block = stmt
            for cond, body in arms:
                if lua_truthy(self.eval_expr(cond, env)):
                    self.exec_block(body, Env(env))
                    return
            if else_block is not None:
                self.exec_block(else_block, Env(env))
        elif kind == "while":
            _, cond, body = stmt
            while lua_truthy(self.eval_expr(cond, env)):
                self.burn()
                try:
                    self.exec_block(body, Env(env))
                except BreakSignal:
                    break
        elif kind == "repeat":
            _, body, cond = stmt
            while True:
                self.burn()
                scope = Env(env)
                try:
                    self.exec_block(body, scope)
                except BreakSignal:
                    break
                # until-cond sees the body's locals (Lua 5.1 scoping)
                if lua_truthy(self.eval_expr(cond, scope)):
                    break
        elif kind == "fornum":
            _, var, e_start, e_stop, e_step, body = stmt
            start = self._want_num(self.eval_expr(e_start, env), "for")
            stop = self._want_num(self.eval_expr(e_stop, env), "for")
            step = (
                self._want_num(self.eval_expr(e_step, env), "for")
                if e_step is not None
                else 1.0
            )
            if step == 0:
                raise LuaRuntimeError("'for' step is zero")
            i = start
            while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                self.burn()
                scope = Env(env)
                scope.vars[var] = i
                try:
                    self.exec_block(body, scope)
                except BreakSignal:
                    break
                i += step
        elif kind == "forin":
            _, names, exprs, body = stmt
            it, state, control = (
                tuple(self.eval_multi(exprs, env, 3))
            )
            while True:
                self.burn()
                results = self.call(it, (state, control))
                control = results[0] if results else None
                if control is None:
                    break
                scope = Env(env)
                for idx, name in enumerate(names):
                    scope.vars[name] = (
                        results[idx] if idx < len(results) else None
                    )
                try:
                    self.exec_block(body, scope)
                except BreakSignal:
                    break
        elif kind == "do":
            self.exec_block(stmt[1], Env(env))
        elif kind == "return":
            raise ReturnSignal(
                tuple(self.eval_multi(stmt[1], env, -1))
            )
        elif kind == "break":
            raise BreakSignal()
        elif kind == "localfunc":
            _, name, func = stmt
            env.vars[name] = None  # visible to its own body (recursion)
            env.vars[name] = LuaFunction(
                func[1], func[2], func[3], env, name
            )
        elif kind == "nop":
            pass
        else:  # pragma: no cover - parser emits only the kinds above
            raise LuaRuntimeError(f"unknown statement {kind}")

    def assign(self, target, value, env: Env):
        if target[0] == "name":
            name = target[1]
            scope = env.lookup(name)
            if scope is not None:
                scope[name] = value
            else:
                self.globals.set(name, value)
            return
        # index
        obj = self.eval_expr(target[1], env)
        key = self.eval_expr(target[2], env)
        if not isinstance(obj, LuaTable):
            raise LuaRuntimeError(
                f"attempt to index a {lua_type(obj)} value"
            )
        obj.set(key, value)

    # ---------------------------------------------------------- evaluation

    def eval_multi(self, exprs, env: Env, want: int) -> list:
        """Evaluate an expression list with Lua's spread rule: every
        expr yields one value except the LAST, which spreads all its
        returns. want=-1 keeps everything; otherwise pad/truncate."""
        values: list = []
        for i, e in enumerate(exprs):
            if i == len(exprs) - 1:
                values.extend(self.eval_expr_tuple(e, env))
            else:
                values.append(self.eval_expr(e, env))
        if want >= 0:
            while len(values) < want:
                values.append(None)
            del values[want:]
        return values

    def eval_expr_tuple(self, e, env: Env) -> tuple:
        """Evaluate in multi-value context (calls and ... spread)."""
        kind = e[0]
        if kind == "call":
            fn = self.eval_expr(e[1], env)
            args = tuple(self.eval_multi(e[2], env, -1))
            return self.call(fn, args)
        if kind == "method":
            obj = self.eval_expr(e[1], env)
            if isinstance(obj, LuaTable):
                fn = obj.get(e[2])
            elif isinstance(obj, str):
                # s:upper() resolves through the string library (stands
                # in for Lua's string metatable, absent in the subset).
                strlib = self.globals.get("string")
                fn = strlib.get(e[2]) if isinstance(
                    strlib, LuaTable
                ) else None
            else:
                raise LuaRuntimeError(
                    f"attempt to index a {lua_type(obj)} value"
                )
            args = (obj,) + tuple(self.eval_multi(e[3], env, -1))
            return self.call(fn, args)
        if kind == "vararg":
            scope = env.lookup("...")
            return scope["..."] if scope is not None else ()
        v = self.eval_expr(e, env)
        return (v,)

    def call(self, fn, args: tuple) -> tuple:
        self.burn()
        if isinstance(fn, LuaFunction):
            self.depth += 1
            if self.depth > self.MAX_DEPTH:
                self.depth -= 1
                raise LuaRuntimeError("stack overflow (depth cap)")
            try:
                scope = Env(fn.env)
                for i, p in enumerate(fn.params):
                    scope.vars[p] = args[i] if i < len(args) else None
                if fn.is_vararg:
                    scope.vars["..."] = args[len(fn.params):]
                try:
                    self.exec_block(fn.body, scope)
                except ReturnSignal as r:
                    return r.values
                return ()
            finally:
                self.depth -= 1
        if callable(fn):
            # Host function: receives (interp, *args), returns tuple/
            # value/None. ANY host-level exception (bad guest argument
            # hitting int()/float()/ord()/...) must surface as a guest
            # error catchable by pcall — never abort the chunk with a
            # raw Python traceback (sandbox containment).
            try:
                out = fn(self, *args)
            except (LuaError, BreakSignal, ReturnSignal):
                raise
            except Exception as e:
                raise LuaRuntimeError(
                    f"{type(e).__name__}: {e}"
                ) from e
            if out is None:
                return ()
            if isinstance(out, tuple):
                return out
            return (out,)
        raise LuaRuntimeError(
            f"attempt to call a {lua_type(fn)} value"
        )

    def eval_expr(self, e, env: Env):
        self.burn()
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "str":
            return e[1]
        if kind == "nil":
            return None
        if kind == "true":
            return True
        if kind == "false":
            return False
        if kind == "name":
            scope = env.lookup(e[1])
            if scope is not None:
                return scope[e[1]]
            return self.globals.get(e[1])
        if kind == "index":
            obj = self.eval_expr(e[1], env)
            key = self.eval_expr(e[2], env)
            if isinstance(obj, LuaTable):
                return obj.get(key)
            if isinstance(obj, str):
                # string methods: s:upper() sugar resolves via the
                # global string table (no metatables in the subset).
                strlib = self.globals.get("string")
                if isinstance(strlib, LuaTable):
                    return strlib.get(key)
            raise LuaRuntimeError(
                f"attempt to index a {lua_type(obj)} value"
            )
        if kind in ("call", "method", "vararg"):
            out = self.eval_expr_tuple(e, env)
            return out[0] if out else None
        if kind == "paren":
            return self.eval_expr(e[1], env)
        if kind == "func":
            return LuaFunction(e[1], e[2], e[3], env)
        if kind == "and":
            left = self.eval_expr(e[1], env)
            if not lua_truthy(left):
                return left
            return self.eval_expr(e[2], env)
        if kind == "or":
            left = self.eval_expr(e[1], env)
            if lua_truthy(left):
                return left
            return self.eval_expr(e[2], env)
        if kind == "unop":
            return self.unop(e[1], self.eval_expr(e[2], env))
        if kind == "binop":
            return self.binop(
                e[1],
                self.eval_expr(e[2], env),
                self.eval_expr(e[3], env),
            )
        if kind == "table":
            t = LuaTable()
            _, array, fields = e
            idx = 1
            for i, item in enumerate(array):
                if i == len(array) - 1:
                    for v in self.eval_expr_tuple(item, env):
                        t.set(float(idx), v)
                        idx += 1
                else:
                    t.set(float(idx), self.eval_expr(item, env))
                    idx += 1
            for k_expr, v_expr in fields:
                t.set(
                    self.eval_expr(k_expr, env),
                    self.eval_expr(v_expr, env),
                )
            return t
        raise LuaRuntimeError(f"unknown expression {kind}")

    # ----------------------------------------------------------- operators

    @staticmethod
    def _want_num(v, what: str):
        n = lua_tonumber(v) if not isinstance(v, bool) else None
        if n is None:
            raise LuaRuntimeError(
                f"attempt to perform arithmetic on a {lua_type(v)}"
                f" value ({what})"
            )
        return n

    def unop(self, op: str, v):
        if op == "not":
            return not lua_truthy(v)
        if op == "-":
            return -self._want_num(v, "unary minus")
        if op == "#":
            if isinstance(v, str):
                return float(len(v))
            if isinstance(v, LuaTable):
                return float(v.length())
            raise LuaRuntimeError(
                f"attempt to get length of a {lua_type(v)} value"
            )
        raise LuaRuntimeError(f"unknown unary op {op}")

    def binop(self, op: str, a, b):
        if op == "..":
            if isinstance(a, (str, float)) and isinstance(b, (str, float)):
                return lua_tostring(a) + lua_tostring(b)
            raise LuaRuntimeError(
                f"attempt to concatenate a "
                f"{lua_type(b if isinstance(a, (str, float)) else a)} value"
            )
        if op == "==":
            return self._eq(a, b)
        if op == "~=":
            return not self._eq(a, b)
        if op in ("<", "<=", ">", ">="):
            if isinstance(a, float) and isinstance(b, float):
                pass
            elif isinstance(a, str) and isinstance(b, str):
                pass
            else:
                raise LuaRuntimeError(
                    f"attempt to compare {lua_type(a)} with {lua_type(b)}"
                )
            if op == "<":
                return a < b
            if op == "<=":
                return a <= b
            if op == ">":
                return a > b
            return a >= b
        x = self._want_num(a, op)
        y = self._want_num(b, op)
        if op == "+":
            return x + y
        if op == "-":
            return x - y
        if op == "*":
            return x * y
        if op == "/":
            if y == 0:
                return float("inf") if x > 0 else (
                    float("-inf") if x < 0 else float("nan")
                )
            return x / y
        if op == "%":
            if y == 0:
                return float("nan")
            return x - (x // y) * y  # Lua modulo (floor)
        if op == "^":
            return float(x**y)
        raise LuaRuntimeError(f"unknown operator {op}")

    @staticmethod
    def _eq(a, b) -> bool:
        if type(a) is not type(b):
            # bool vs float etc. are never equal in Lua
            if isinstance(a, bool) or isinstance(b, bool):
                return a is b
            if not (
                isinstance(a, type(b)) or isinstance(b, type(a))
            ):
                return False
        if isinstance(a, (LuaTable,)) or callable(a):
            return a is b
        return a == b


def lua_call(interp: Interp, fn, args: tuple) -> tuple:
    """Host-side entry: call a guest function with converted args."""
    return interp.call(fn, args)

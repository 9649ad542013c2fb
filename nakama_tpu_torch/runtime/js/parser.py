"""Recursive-descent + Pratt parser for the JS subset.

AST nodes are plain tuples, first element the node kind — compact and
cheap for the tree-walking interpreter. Statement terminators follow a
restricted ASI: a statement ends at ';', '}', EOF, or a line break
before the next token.
"""

from __future__ import annotations

from .lexer import JsSyntaxError, tokenize

# Binary operator precedence (higher binds tighter).
BINOPS = {
    "||": 1, "&&": 2,
    "|": 3, "^": 4, "&": 5,
    "==": 6, "!=": 6, "===": 6, "!==": 6,
    "<": 7, ">": 7, "<=": 7, ">=": 7, "in": 7, "instanceof": 7,
    "<<": 8, ">>": 8, ">>>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
    "**": 11,
}
ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^="}


class Parser:
    def __init__(self, src: str, chunk: str = "?"):
        self.toks = tokenize(src, chunk)
        self.chunk = chunk
        self.pos = 0

    # ------------------------------------------------------------ helpers

    def peek(self, ahead=0):
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at(self, kind, value=None):
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def at_op(self, *ops):
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def at_kw(self, *kws):
        t = self.peek()
        return t.kind == "keyword" and t.value in kws

    def expect(self, kind, value=None):
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            self.err(f"expected {value or kind}, got {t.value!r}", t)
        return t

    def err(self, msg, tok=None):
        tok = tok or self.peek()
        raise JsSyntaxError(f"{self.chunk}:{tok.line}: {msg}")

    def end_statement(self):
        """Restricted ASI: ';' consumes; '}'/eof/newline terminate."""
        if self.at_op(";"):
            self.next()
            return
        t = self.peek()
        if t.kind == "eof" or (t.kind == "op" and t.value == "}"):
            return
        if t.nl_before:
            return
        self.err(f"expected ';' before {t.value!r}")

    # ---------------------------------------------------------- statements

    def parse_program(self):
        body = []
        while not self.at("eof"):
            body.append(self.statement())
        return ("block", body)

    def block(self):
        self.expect("op", "{")
        body = []
        while not self.at_op("}"):
            if self.at("eof"):
                self.err("expected '}'")
            body.append(self.statement())
        self.next()
        return ("block", body)

    def statement(self):
        if self.at_op("{"):
            return self.block()
        if self.at_op(";"):
            self.next()
            return ("empty",)
        if self.at_kw("var", "let", "const"):
            kw = self.next().value
            decls = []
            while True:
                name = self.expect("name").value
                init = None
                if self.at_op("="):
                    self.next()
                    init = self.assignment()
                decls.append((name, init))
                if self.at_op(","):
                    self.next()
                    continue
                break
            self.end_statement()
            return ("decl", kw, decls)
        if self.at_kw("function"):
            self.next()
            name = self.expect("name").value
            fn = self.function_tail(name)
            return ("decl", "var", [(name, fn)])
        if self.at_kw("if"):
            self.next()
            self.expect("op", "(")
            cond = self.expression()
            self.expect("op", ")")
            then = self.statement()
            other = None
            if self.at_kw("else"):
                self.next()
                other = self.statement()
            return ("if", cond, then, other)
        if self.at_kw("while"):
            self.next()
            self.expect("op", "(")
            cond = self.expression()
            self.expect("op", ")")
            return ("while", cond, self.statement())
        if self.at_kw("do"):
            self.next()
            body = self.statement()
            self.expect("keyword", "while")
            self.expect("op", "(")
            cond = self.expression()
            self.expect("op", ")")
            self.end_statement()
            return ("dowhile", cond, body)
        if self.at_kw("for"):
            return self.for_statement()
        if self.at_kw("return"):
            t = self.next()
            value = None
            nxt = self.peek()
            if not (
                nxt.nl_before
                or (nxt.kind == "op" and nxt.value in (";", "}"))
                or nxt.kind == "eof"
            ):
                value = self.expression()
            self.end_statement()
            return ("return", value)
        if self.at_kw("break"):
            self.next()
            self.end_statement()
            return ("break",)
        if self.at_kw("continue"):
            self.next()
            self.end_statement()
            return ("continue",)
        if self.at_kw("throw"):
            t = self.next()
            if self.peek().nl_before:
                self.err("newline after throw")
            value = self.expression()
            self.end_statement()
            return ("throw", value)
        if self.at_kw("try"):
            self.next()
            body = self.block()
            catch_name, catch_body, finally_body = None, None, None
            if self.at_kw("catch"):
                self.next()
                if self.at_op("("):
                    self.next()
                    catch_name = self.expect("name").value
                    self.expect("op", ")")
                catch_body = self.block()
            if self.at_kw("finally"):
                self.next()
                finally_body = self.block()
            if catch_body is None and finally_body is None:
                self.err("try needs catch or finally")
            return ("try", body, catch_name, catch_body, finally_body)
        if self.at_kw("switch"):
            return self.switch_statement()
        if self.at_kw("class"):
            return self.class_statement()
        expr = self.expression()
        self.end_statement()
        return ("expr", expr)

    def class_statement(self):
        """`class Name [extends Parent] { ... }` declarations: methods,
        `static` methods, one `constructor`. `extends`/`static`/`super`
        are contextual (they lex as names); the body desugars to a
        ("classdecl", name, parent_expr, ctor_fn, methods, statics)
        node the interpreter turns into a JSClass value. Fields and
        getters/setters stay outside the subset — TS compilers targeting
        ES6 emit constructor assignments for fields anyway."""
        self.expect("keyword", "class")
        name = self.expect("name").value
        parent = None
        if self.at("name", "extends"):
            self.next()
            parent = self.call_member(self.primary())
        self.expect("op", "{")
        ctor = None
        methods = []  # (name, fn_node) in declaration order
        statics = []
        while not self.at_op("}"):
            if self.at("eof"):
                self.err("expected '}' closing class body")
            if self.at_op(";"):
                self.next()
                continue
            static = False
            if self.at("name", "static") and not (
                self.peek(1).kind == "op" and self.peek(1).value == "("
            ):
                # `static m() {}` — but `static() {}` is a method
                # literally named "static".
                self.next()
                static = True
            mt = self.next()
            if mt.kind not in ("name", "str", "keyword"):
                self.err("expected method name", mt)
            mname = str(mt.value)
            fn = self.function_tail(mname)
            if not static and mname == "constructor":
                if ctor is not None:
                    self.err("duplicate constructor", mt)
                ctor = fn
            elif static:
                statics.append((mname, fn))
            else:
                methods.append((mname, fn))
        self.next()
        return ("classdecl", name, parent, ctor, methods, statics)

    def for_statement(self):
        self.expect("keyword", "for")
        self.expect("op", "(")
        init = None
        decl_kw = None
        if self.at_op(";"):
            self.next()
        elif self.at_kw("var", "let", "const"):
            decl_kw = self.next().value
            name = self.expect("name").value
            if self.at_kw("in", "of"):
                mode = self.next().value
                obj = self.expression()
                self.expect("op", ")")
                return ("forin", mode, name, obj, self.statement())
            init_expr = None
            if self.at_op("="):
                self.next()
                init_expr = self.assignment()
            decls = [(name, init_expr)]
            while self.at_op(","):
                self.next()
                nm = self.expect("name").value
                ie = None
                if self.at_op("="):
                    self.next()
                    ie = self.assignment()
                decls.append((nm, ie))
            init = ("decl", decl_kw, decls)
            self.expect("op", ";")
        else:
            init = ("expr", self.expression())
            self.expect("op", ";")
        cond = None if self.at_op(";") else self.expression()
        self.expect("op", ";")
        step = None if self.at_op(")") else self.expression()
        self.expect("op", ")")
        return ("for", init, cond, step, self.statement())

    def switch_statement(self):
        self.expect("keyword", "switch")
        self.expect("op", "(")
        disc = self.expression()
        self.expect("op", ")")
        self.expect("op", "{")
        cases = []  # (test_expr | None, [stmts])
        while not self.at_op("}"):
            if self.at_kw("case"):
                self.next()
                test = self.expression()
                self.expect("op", ":")
            elif self.at_kw("default"):
                self.next()
                self.expect("op", ":")
                test = None
            else:
                self.err("expected case/default")
            body = []
            while not (self.at_kw("case", "default") or self.at_op("}")):
                body.append(self.statement())
            cases.append((test, body))
        self.next()
        return ("switch", disc, cases)

    # --------------------------------------------------------- expressions

    def expression(self):
        expr = self.assignment()
        while self.at_op(","):
            self.next()
            right = self.assignment()
            expr = ("comma", expr, right)
        return expr

    def assignment(self):
        left = self.conditional()
        if self.at_op(*ASSIGN_OPS):
            op = self.next().value
            right = self.assignment()
            if left[0] not in ("name", "member", "index"):
                self.err("invalid assignment target")
            return ("assign", op, left, right)
        return left

    def conditional(self):
        cond = self.binary(0)
        if self.at_op("?"):
            self.next()
            then = self.assignment()
            self.expect("op", ":")
            other = self.assignment()
            return ("cond", cond, then, other)
        return cond

    def binary(self, min_prec):
        left = self.unary()
        while True:
            t = self.peek()
            op = t.value if t.kind in ("op", "keyword") else None
            prec = BINOPS.get(op)
            if prec is None or prec < min_prec:
                return left
            if op == "instanceof":
                self.err("instanceof is not supported in this subset")
            self.next()
            # ** is right-associative; the rest left.
            right = self.binary(prec if op == "**" else prec + 1)
            if op in ("&&", "||"):
                left = ("logic", op, left, right)
            else:
                left = ("bin", op, left, right)

    def unary(self):
        if self.at_op("!", "-", "+", "~"):
            op = self.next().value
            return ("unary", op, self.unary())
        if self.at_kw("typeof", "void", "delete"):
            op = self.next().value
            operand = self.unary()
            if op == "delete" and operand[0] not in ("member", "index"):
                self.err("delete needs a property reference")
            return ("unary", op, operand)
        if self.at_op("++", "--"):
            op = self.next().value
            target = self.unary()
            if target[0] not in ("name", "member", "index"):
                self.err("invalid increment target")
            return ("update", op, target, True)
        return self.postfix()

    def postfix(self):
        expr = self.call_member(self.primary())
        if self.at_op("++", "--") and not self.peek().nl_before:
            op = self.next().value
            if expr[0] not in ("name", "member", "index"):
                self.err("invalid increment target")
            return ("update", op, expr, False)
        return expr

    def call_member(self, expr):
        while True:
            if self.at_op("."):
                self.next()
                t = self.next()
                if t.kind not in ("name", "keyword"):
                    self.err("expected property name")
                expr = ("member", expr, t.value)
            elif self.at_op("["):
                self.next()
                idx = self.expression()
                self.expect("op", "]")
                expr = ("index", expr, idx)
            elif self.at_op("("):
                self.next()
                args = []
                while not self.at_op(")"):
                    if self.at_op("..."):
                        # Spread in call position (TS compilers emit
                        # `fn.apply(void 0, args)` variants AND plain
                        # `fn(...args)` depending on target): the arg
                        # node flattens at call evaluation.
                        self.next()
                        args.append(("spread", self.assignment()))
                    else:
                        args.append(self.assignment())
                    if self.at_op(","):
                        self.next()
                self.next()
                expr = ("call", expr, args)
            else:
                return expr

    def _arrow_ahead(self):
        """Lookahead: '(' params ')' '=>' — distinguishes arrows from
        parenthesized expressions."""
        depth = 0
        i = self.pos
        while i < len(self.toks):
            t = self.toks[i]
            if t.kind == "op" and t.value == "(":
                depth += 1
            elif t.kind == "op" and t.value == ")":
                depth -= 1
                if depth == 0:
                    nxt = self.toks[i + 1] if i + 1 < len(self.toks) else None
                    return (
                        nxt is not None
                        and nxt.kind == "op"
                        and nxt.value == "=>"
                    )
            elif t.kind == "eof":
                return False
            i += 1
        return False

    def param_list(self, closer=")"):
        """Function parameter list: plain names plus one trailing rest
        param (`...xs`, TS-compiled var-arg forwarders) encoded as
        ("rest", name) — the interpreter binds it to an array of the
        remaining arguments."""
        params = []
        while not self.at_op(closer):
            if self.at_op("..."):
                self.next()
                params.append(("rest", self.expect("name").value))
                if self.at_op(","):
                    self.err("rest param must be last")
                break
            params.append(self.expect("name").value)
            if self.at_op(","):
                self.next()
        self.expect("op", closer)
        return params

    def function_tail(self, name):
        self.expect("op", "(")
        params = self.param_list()
        body = self.block()
        return ("function", name, params, body, False)

    def primary(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            return ("num", t.value)
        if t.kind == "str":
            self.next()
            return ("str", t.value)
        if t.kind == "name":
            # Arrow shorthand: name => expr
            nxt = self.peek(1)
            if nxt.kind == "op" and nxt.value == "=>":
                self.next()
                self.next()
                return self.arrow_body([t.value])
            self.next()
            return ("name", t.value)
        if t.kind == "keyword":
            if t.value in ("true", "false"):
                self.next()
                return ("bool", t.value == "true")
            if t.value == "null":
                self.next()
                return ("null",)
            if t.value == "undefined":
                self.next()
                return ("undef",)
            if t.value == "this":
                self.next()
                return ("this",)
            if t.value == "function":
                self.next()
                name = None
                if self.at("name"):
                    name = self.next().value
                return self.function_tail(name)
            if t.value == "new":
                # `new Ctor(args)`: constructor functions (TS compilers
                # emit these for ES5-target classes). The callee is a
                # member/index chain WITHOUT call application — the
                # first '(…)' binds to the `new` as constructor args;
                # `new Foo` without parens is the zero-arg form.
                self.next()
                callee = self.primary()
                while True:
                    if self.at_op("."):
                        self.next()
                        pt = self.next()
                        if pt.kind not in ("name", "keyword"):
                            self.err("expected property name")
                        callee = ("member", callee, pt.value)
                    elif self.at_op("["):
                        self.next()
                        idx = self.expression()
                        self.expect("op", "]")
                        callee = ("index", callee, idx)
                    else:
                        break
                args = []
                if self.at_op("("):
                    self.next()
                    while not self.at_op(")"):
                        if self.at_op("..."):
                            self.next()
                            args.append(("spread", self.assignment()))
                        else:
                            args.append(self.assignment())
                        if self.at_op(","):
                            self.next()
                    self.next()
                return ("new", callee, args)
            self.err(f"unexpected keyword {t.value!r}")
        if t.kind == "op":
            if t.value == "(":
                if self._arrow_ahead():
                    self.next()
                    params = self.param_list()
                    self.expect("op", "=>")
                    return self.arrow_body(params)
                self.next()
                expr = self.expression()
                self.expect("op", ")")
                return expr
            if t.value == "[":
                self.next()
                items = []
                while not self.at_op("]"):
                    items.append(self.assignment())
                    if self.at_op(","):
                        self.next()
                self.next()
                return ("array", items)
            if t.value == "{":
                self.next()
                props = []
                while not self.at_op("}"):
                    kt = self.next()
                    if kt.kind in ("name", "str", "keyword"):
                        key = ("const_key", str(kt.value))
                    elif kt.kind == "num":
                        key = ("const_key", _num_key(kt.value))
                    elif kt.kind == "op" and kt.value == "[":
                        key = self.assignment()
                        self.expect("op", "]")
                    else:
                        self.err("bad object key")
                    if self.at_op(":"):
                        self.next()
                        value = self.assignment()
                    elif kt.kind == "name" and self.at_op(",", "}"):
                        value = ("name", kt.value)  # shorthand {a}
                    elif self.at_op("("):
                        value = self.function_tail(str(kt.value))  # {m(){}}
                    else:
                        self.err("expected ':' in object literal")
                    props.append((key, value))
                    if self.at_op(","):
                        self.next()
                self.next()
                return ("object", props)
        self.err(f"unexpected token {t.value!r}")

    def arrow_body(self, params):
        if self.at_op("{"):
            body = self.block()
        else:
            body = ("block", [("return", self.assignment())])
        return ("function", None, params, body, True)  # arrow


def _num_key(v: float) -> str:
    # Single source of truth for number -> property-key formatting.
    from .interp import _num_key as key

    return key(float(v))


def parse(src: str, chunk: str = "?"):
    return Parser(src, chunk).parse_program()

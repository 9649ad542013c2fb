"""Recursive-descent parser for the Lua 5.1 subset → tuple AST.

Nodes are plain tuples (kind, ...) — the interpreter (interp.py)
dispatches on kind. Original implementation for this framework.
"""

from __future__ import annotations

from .lexer import LuaSyntaxError, Token, tokenize

# Binary operator precedence (Lua 5.1 manual §2.5.6). '..' and '^' are
# right-associative.
BINPREC = {
    "or": 1,
    "and": 2,
    "<": 3, ">": 3, "<=": 3, ">=": 3, "~=": 3, "==": 3,
    "..": 4,
    "+": 5, "-": 5,
    "*": 6, "/": 6, "%": 6,
    "^": 8,
}
RIGHT_ASSOC = {"..", "^"}
UNARY_PREC = 7


class Parser:
    def __init__(self, src: str, chunk: str = "?"):
        self.tokens = tokenize(src, chunk)
        self.pos = 0
        self.chunk = chunk

    # ------------------------------------------------------------ plumbing

    @property
    def tok(self) -> Token:
        return self.tokens[self.pos]

    def next(self) -> Token:
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def err(self, msg: str):
        raise LuaSyntaxError(f"{self.chunk}:{self.tok.line}: {msg}")

    def check(self, kind: str, value=None) -> bool:
        t = self.tok
        return t.kind == kind and (value is None or t.value == value)

    def accept(self, kind: str, value=None) -> bool:
        if self.check(kind, value):
            self.pos += 1
            return True
        return False

    def expect(self, kind: str, value=None) -> Token:
        if not self.check(kind, value):
            self.err(
                f"expected {value or kind}, got {self.tok.value!r}"
            )
        return self.next()

    # --------------------------------------------------------------- entry

    def parse_chunk(self):
        block = self.block()
        if self.tok.kind != "eof":
            self.err(f"unexpected {self.tok.value!r}")
        return block

    BLOCK_ENDERS = {"end", "else", "elseif", "until"}

    def block(self):
        stmts = []
        while True:
            t = self.tok
            if t.kind == "eof" or (
                t.kind == "keyword" and t.value in self.BLOCK_ENDERS
            ):
                return stmts
            if t.kind == "keyword" and t.value == "return":
                self.next()
                exprs = []
                if not (
                    self.tok.kind == "eof"
                    or (
                        self.tok.kind == "keyword"
                        and self.tok.value in self.BLOCK_ENDERS
                    )
                    or self.check("sym", ";")
                ):
                    exprs = self.exprlist()
                self.accept("sym", ";")
                stmts.append(("return", exprs))
                return stmts
            stmts.append(self.statement())
        return stmts

    # ---------------------------------------------------------- statements

    def statement(self):
        t = self.tok
        if t.kind == "sym" and t.value == ";":
            self.next()
            return ("nop",)
        if t.kind == "keyword":
            kw = t.value
            if kw == "local":
                return self.local_stat()
            if kw == "if":
                return self.if_stat()
            if kw == "while":
                self.next()
                cond = self.expr()
                self.expect("keyword", "do")
                body = self.block()
                self.expect("keyword", "end")
                return ("while", cond, body)
            if kw == "repeat":
                self.next()
                body = self.block()
                self.expect("keyword", "until")
                cond = self.expr()
                return ("repeat", body, cond)
            if kw == "for":
                return self.for_stat()
            if kw == "function":
                return self.func_stat()
            if kw == "do":
                self.next()
                body = self.block()
                self.expect("keyword", "end")
                return ("do", body)
            if kw == "break":
                self.next()
                return ("break",)
            self.err(f"unexpected keyword {kw!r}")
        # expression statement: call, or assignment
        e = self.suffixed_expr()
        if self.check("sym", "=") or self.check("sym", ","):
            targets = [e]
            while self.accept("sym", ","):
                targets.append(self.suffixed_expr())
            self.expect("sym", "=")
            exprs = self.exprlist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    self.err("cannot assign to this expression")
            return ("assign", targets, exprs)
        if e[0] not in ("call", "method"):
            self.err("syntax error: expression is not a statement")
        return ("callstat", e)

    def local_stat(self):
        self.next()  # local
        if self.accept("keyword", "function"):
            name = self.expect("name").value
            func = self.func_body()
            return ("localfunc", name, func)
        names = [self.expect("name").value]
        while self.accept("sym", ","):
            names.append(self.expect("name").value)
        exprs = []
        if self.accept("sym", "="):
            exprs = self.exprlist()
        return ("local", names, exprs)

    def if_stat(self):
        self.next()  # if
        arms = []
        cond = self.expr()
        self.expect("keyword", "then")
        arms.append((cond, self.block()))
        else_block = None
        while True:
            if self.accept("keyword", "elseif"):
                c = self.expr()
                self.expect("keyword", "then")
                arms.append((c, self.block()))
                continue
            if self.accept("keyword", "else"):
                else_block = self.block()
            self.expect("keyword", "end")
            return ("if", arms, else_block)

    def for_stat(self):
        self.next()  # for
        first = self.expect("name").value
        if self.accept("sym", "="):
            start = self.expr()
            self.expect("sym", ",")
            stop = self.expr()
            step = None
            if self.accept("sym", ","):
                step = self.expr()
            self.expect("keyword", "do")
            body = self.block()
            self.expect("keyword", "end")
            return ("fornum", first, start, stop, step, body)
        names = [first]
        while self.accept("sym", ","):
            names.append(self.expect("name").value)
        self.expect("keyword", "in")
        exprs = self.exprlist()
        self.expect("keyword", "do")
        body = self.block()
        self.expect("keyword", "end")
        return ("forin", names, exprs, body)

    def func_stat(self):
        self.next()  # function
        target = ("name", self.expect("name").value)
        is_method = False
        while True:
            if self.accept("sym", "."):
                target = ("index", target, ("str", self.expect("name").value))
                continue
            if self.accept("sym", ":"):
                target = ("index", target, ("str", self.expect("name").value))
                is_method = True
            break
        func = self.func_body(is_method=is_method)
        return ("assign", [target], [func])

    def func_body(self, is_method: bool = False):
        self.expect("sym", "(")
        params = ["self"] if is_method else []
        is_vararg = False
        if not self.check("sym", ")"):
            while True:
                if self.accept("sym", "..."):
                    is_vararg = True
                    break
                params.append(self.expect("name").value)
                if not self.accept("sym", ","):
                    break
        self.expect("sym", ")")
        body = self.block()
        self.expect("keyword", "end")
        return ("func", tuple(params), is_vararg, body)

    # --------------------------------------------------------- expressions

    def exprlist(self):
        out = [self.expr()]
        while self.accept("sym", ","):
            out.append(self.expr())
        return out

    def expr(self, limit: int = 0):
        t = self.tok
        if t.kind == "keyword" and t.value == "not":
            self.next()
            left = ("unop", "not", self.expr(UNARY_PREC))
        elif t.kind == "sym" and t.value == "-":
            self.next()
            left = ("unop", "-", self.expr(UNARY_PREC))
        elif t.kind == "sym" and t.value == "#":
            self.next()
            left = ("unop", "#", self.expr(UNARY_PREC))
        else:
            left = self.simple_expr()
        while True:
            t = self.tok
            op = None
            if t.kind == "sym" and t.value in BINPREC:
                op = t.value
            elif t.kind == "keyword" and t.value in ("and", "or"):
                op = t.value
            if op is None:
                return left
            prec = BINPREC[op]
            if prec <= limit and not (
                op in RIGHT_ASSOC and prec == limit
            ):
                return left
            self.next()
            right = self.expr(prec - 1 if op in RIGHT_ASSOC else prec)
            if op == "and":
                left = ("and", left, right)
            elif op == "or":
                left = ("or", left, right)
            else:
                left = ("binop", op, left, right)

    def simple_expr(self):
        t = self.tok
        if t.kind == "number":
            self.next()
            return ("num", t.value)
        if t.kind == "string":
            self.next()
            return ("str", t.value)
        if t.kind == "keyword":
            if t.value == "nil":
                self.next()
                return ("nil",)
            if t.value == "true":
                self.next()
                return ("true",)
            if t.value == "false":
                self.next()
                return ("false",)
            if t.value == "function":
                self.next()
                return self.func_body()
        if t.kind == "sym":
            if t.value == "...":
                self.next()
                return ("vararg",)
            if t.value == "{":
                return self.table_expr()
        return self.suffixed_expr()

    def primary_expr(self):
        t = self.tok
        if t.kind == "name":
            self.next()
            return ("name", t.value)
        if t.kind == "sym" and t.value == "(":
            self.next()
            e = self.expr()
            self.expect("sym", ")")
            # Parenthesised expressions truncate multiple returns to one.
            return ("paren", e)
        self.err(f"unexpected {t.value!r}")

    def suffixed_expr(self):
        e = self.primary_expr()
        while True:
            t = self.tok
            if t.kind == "sym" and t.value == ".":
                self.next()
                e = ("index", e, ("str", self.expect("name").value))
            elif t.kind == "sym" and t.value == "[":
                self.next()
                k = self.expr()
                self.expect("sym", "]")
                e = ("index", e, k)
            elif t.kind == "sym" and t.value == ":":
                self.next()
                name = self.expect("name").value
                e = ("method", e, name, self.call_args())
            elif t.kind == "sym" and t.value == "(":
                e = ("call", e, self.call_args())
            elif t.kind == "string":
                self.next()
                e = ("call", e, [("str", t.value)])
            elif t.kind == "sym" and t.value == "{":
                e = ("call", e, [self.table_expr()])
            else:
                return e

    def call_args(self):
        self.expect("sym", "(")
        args = []
        if not self.check("sym", ")"):
            args = self.exprlist()
        self.expect("sym", ")")
        return args

    def table_expr(self):
        self.expect("sym", "{")
        array = []
        fields = []  # (key_expr, value_expr)
        while not self.check("sym", "}"):
            if self.check("sym", "["):
                self.next()
                k = self.expr()
                self.expect("sym", "]")
                self.expect("sym", "=")
                fields.append((k, self.expr()))
            elif (
                self.tok.kind == "name"
                and self.tokens[self.pos + 1].kind == "sym"
                and self.tokens[self.pos + 1].value == "="
            ):
                k = ("str", self.next().value)
                self.next()  # =
                fields.append((k, self.expr()))
            else:
                array.append(self.expr())
            if not (self.accept("sym", ",") or self.accept("sym", ";")):
                break
        self.expect("sym", "}")
        return ("table", array, fields)


def parse(src: str, chunk: str = "?"):
    return Parser(src, chunk).parse_chunk()

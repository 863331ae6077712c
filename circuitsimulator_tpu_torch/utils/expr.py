"""Arithmetic expression engine for `.PARAM`, `{...}` netlist values, and
behavioral B sources (extension; the reference has no parameter system —
every value in its grammar is a literal, utils.hpp:20-74).

A small recursive-descent parser over:

  * SPICE numbers with magnitude suffixes (2.2k, 1meg, 10u, ...),
  * parameter names (case-insensitive, resolved via a bindings dict),
  * constants ``pi`` and ``e``,
  * operators ``+ - * / % **`` (also ``^`` for power), unary ``+/-``,
  * functions: sin cos tan asin acos atan atan2 sinh cosh tanh exp ln
    log log10 sqrt abs floor ceil pow min max,
  * parentheses,
  * (behavioral mode only) circuit probes ``v(node)``, ``v(a,b)``,
    ``i(element)`` and the variable ``time``.

Two consumers:

- ``eval_expr(s, bindings)``: immediate host evaluation (floats) — for
  `.PARAM` resolution and `{...}` substitution.  Parameters are
  compile-time constants of a netlist; `.STEP` re-binds and re-evaluates.
  No Python ``eval`` is involved.
- ``parse_expr(s, probes=True)`` -> AST and ``probe_refs``: the parser
  checks behavioral-source expressions with them.  B sources are not
  simulated by this package yet, so nothing compiles the AST.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .numbers import parse_spice_number

_FUNCS1 = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "asin": math.asin, "acos": math.acos, "atan": math.atan,
    "sinh": math.sinh, "cosh": math.cosh, "tanh": math.tanh,
    "exp": math.exp, "ln": math.log, "log": math.log,
    "log10": math.log10, "sqrt": math.sqrt, "abs": abs,
    "floor": math.floor, "ceil": math.ceil,
}
_FUNCS2 = {
    "pow": math.pow, "atan2": math.atan2, "min": min, "max": max,
}
_CONSTS = {"pi": math.pi, "e": math.e}


class ExprError(ValueError):
    pass


def _tokenize(s: str) -> List[Tuple[str, str]]:
    """[(kind, text)]; kinds: num, name, op, lpar, rpar, comma."""
    toks = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
        elif c.isdigit() or (c == "." and i + 1 < n and s[i + 1].isdigit()):
            j = i
            while j < n and (s[j].isdigit() or s[j] == "."):
                j += 1
            if j < n and s[j] in "eE":
                k = j + 1
                if k < n and s[k] in "+-":
                    k += 1
                if k < n and s[k].isdigit():
                    j = k
                    while j < n and s[j].isdigit():
                        j += 1
            while j < n and s[j].isalpha():   # magnitude suffix (k, meg, ...)
                j += 1
            toks.append(("num", s[i:j]))
            i = j
        elif c.isalpha() or c == "_":
            # '.' allowed inside names: hierarchical node names from
            # subcircuit flattening / macro expansion (X1.n, E1.x1)
            j = i
            while j < n and (s[j].isalnum() or s[j] in "_."):
                j += 1
            toks.append(("name", s[i:j]))
            i = j
        elif c == "*" and i + 1 < n and s[i + 1] == "*":
            toks.append(("op", "**"))
            i += 2
        elif c in "+-*/%^":
            toks.append(("op", c))
            i += 1
        elif c == "(":
            toks.append(("lpar", c))
            i += 1
        elif c == ")":
            toks.append(("rpar", c))
            i += 1
        elif c == ",":
            toks.append(("comma", c))
            i += 1
        else:
            raise ExprError(f"unexpected character {c!r} in expression {s!r}")
    return toks


# AST node tuples:
#   ("num", float)  ("name", str)  ("neg", a)  ("bin", op, a, b)
#   ("call", fname, [args])  ("probe_v", n1, n2|None)  ("probe_i", elem)
class _Parser:
    def __init__(self, toks: List[Tuple[str, str]], probes: bool):
        self.toks = toks
        self.pos = 0
        self.probes = probes

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        t = self.peek()
        if t is None:
            raise ExprError("unexpected end of expression")
        self.pos += 1
        return t

    def expect(self, kind: str) -> Tuple[str, str]:
        t = self.next()
        if t[0] != kind:
            raise ExprError(f"expected {kind}, got {t[1]!r}")
        return t

    # additive <- multiplicative (('+'|'-') multiplicative)*
    def additive(self):
        v = self.multiplicative()
        while True:
            t = self.peek()
            if t and t[0] == "op" and t[1] in "+-":
                self.next()
                v = ("bin", t[1], v, self.multiplicative())
            else:
                return v

    def multiplicative(self):
        v = self.unary()
        while True:
            t = self.peek()
            if t and t[0] == "op" and t[1] in ("*", "/", "%"):
                self.next()
                v = ("bin", t[1], v, self.unary())
            else:
                return v

    def unary(self):
        t = self.peek()
        if t and t[0] == "op" and t[1] in "+-":
            self.next()
            v = self.unary()
            return ("neg", v) if t[1] == "-" else v
        return self.power()

    # right-associative power binds tighter than unary minus on the left
    # of the base (matches ngspice: -2**2 = -4)
    def power(self):
        v = self.atom()
        t = self.peek()
        if t and t[0] == "op" and t[1] in ("**", "^"):
            self.next()
            return ("bin", "**", v, self.unary())
        return v

    def atom(self):
        t = self.next()
        if t[0] == "num":
            try:
                return ("num", parse_spice_number(t[1]))
            except ValueError as err:
                raise ExprError(f"bad number {t[1]!r}: {err}")
        if t[0] == "name":
            name = t[1].lower()
            nxt = self.peek()
            if nxt and nxt[0] == "lpar":
                if self.probes and name in ("v", "i"):
                    return self._probe(name)
                self.next()
                args = [self.additive()]
                while self.peek() and self.peek()[0] == "comma":
                    self.next()
                    args.append(self.additive())
                self.expect("rpar")
                if name in _FUNCS1 and len(args) == 1:
                    return ("call", name, args)
                if name in _FUNCS2 and len(args) == 2:
                    return ("call", name, args)
                raise ExprError(f"unknown function {name}/{len(args)}")
            return ("name", t[1])
        if t[0] == "lpar":
            v = self.additive()
            self.expect("rpar")
            return v
        raise ExprError(f"unexpected token {t[1]!r}")

    def _probe(self, kind: str):
        """v(node[,ref]) / i(element): args are raw names or numbers."""
        self.next()                               # consume '('
        a = self.next()
        if a[0] not in ("name", "num"):
            raise ExprError(f"bad probe argument {a[1]!r}")
        if kind == "i":
            self.expect("rpar")
            return ("probe_i", a[1])
        b = None
        if self.peek() and self.peek()[0] == "comma":
            self.next()
            bt = self.next()
            if bt[0] not in ("name", "num"):
                raise ExprError(f"bad probe argument {bt[1]!r}")
            b = bt[1]
        self.expect("rpar")
        return ("probe_v", a[1], b)


def parse_expr(s: str, probes: bool = False):
    """Parse to an AST; probes=True enables v()/i()/time (behavioral)."""
    toks = _tokenize(s)
    if not toks:
        raise ExprError("empty expression")
    p = _Parser(toks, probes)
    ast = p.additive()
    if p.peek() is not None:
        raise ExprError(f"trailing tokens after expression in {s!r}")
    return ast


def _eval_ast(ast, bindings: Dict[str, float]) -> float:
    kind = ast[0]
    if kind == "num":
        return ast[1]
    if kind == "name":
        name = ast[1].lower()
        if name in bindings:
            return float(bindings[name])
        if name in _CONSTS:
            return _CONSTS[name]
        raise ExprError(f"undefined parameter {ast[1]!r}")
    if kind == "neg":
        return -_eval_ast(ast[1], bindings)
    if kind == "bin":
        a = _eval_ast(ast[2], bindings)
        b = _eval_ast(ast[3], bindings)
        op = ast[1]
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            return math.fmod(a, b)
        return math.pow(a, b)
    if kind == "call":
        args = [_eval_ast(a, bindings) for a in ast[2]]
        f = _FUNCS1.get(ast[1]) if len(args) == 1 else _FUNCS2.get(ast[1])
        return float(f(*args))
    raise ExprError(f"probes not allowed here: {ast!r}")


def eval_expr(s: str, bindings: Optional[Dict[str, float]] = None) -> float:
    """Evaluate an expression string with the given parameter bindings
    (names matched case-insensitively).  Raises ExprError on any problem."""
    ast = parse_expr(s, probes=False)
    b = {k.lower(): v for k, v in (bindings or {}).items()}
    try:
        v = _eval_ast(ast, b)
    except ZeroDivisionError:
        raise ExprError(f"division by zero in {s!r}")
    except (ValueError, OverflowError) as e:
        if isinstance(e, ExprError):
            raise
        raise ExprError(f"math error in {s!r}: {e}")
    if not math.isfinite(v):
        raise ExprError(f"non-finite result for {s!r}")
    return float(v)


def probe_refs(ast) -> List[tuple]:
    """All distinct probe nodes of an AST, in first-appearance order:
    [("v", node, ref|None) | ("i", elem)], plus ("time",) if used."""
    out: List[tuple] = []

    def walk(a):
        k = a[0]
        if k == "probe_v":
            r = ("v", a[1], a[2])
            if r not in out:
                out.append(r)
        elif k == "probe_i":
            r = ("i", a[1])
            if r not in out:
                out.append(r)
        elif k == "name" and a[1].lower() == "time":
            r = ("time",)
            if r not in out:
                out.append(r)
        elif k == "neg":
            walk(a[1])
        elif k == "bin":
            walk(a[2])
            walk(a[3])
        elif k == "call":
            for x in a[2]:
                walk(x)

    walk(ast)
    return out


def free_names(ast) -> List[str]:
    """Bare parameter names referenced by an AST (lowercased, first-
    appearance order), excluding `time` and the built-in constants."""
    out: List[str] = []

    def walk(a):
        k = a[0]
        if k == "name":
            n = a[1].lower()
            if n not in ("time",) and n not in _CONSTS and n not in out:
                out.append(n)
        elif k == "neg":
            walk(a[1])
        elif k == "bin":
            walk(a[2])
            walk(a[3])
        elif k == "call":
            for x in a[2]:
                walk(x)

    walk(ast)
    return out


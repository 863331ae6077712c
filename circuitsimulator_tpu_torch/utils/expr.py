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
- ``parse_expr(s, probes=True)`` -> AST, plus ``compile_tape(ast, ...)``:
  a postfix program for behavioral B sources.  One definition serves the
  whole package: ``eval_tape`` runs it in PyTorch (the non-fused path and
  the fused chunk's plain version) and the fused chunk's CUDA kernel
  (``csrc/fused_step.cu``) interprets the same opcodes.  The Newton
  linearisation comes from forward-mode partials carried beside each value
  with the derivative rules of ``jax.value_and_grad`` (the JAX package's
  ``compile_jax``), not from ``torch.autograd``, whose rules differ at
  kinks (``abs'(0)`` is 0 there, 1 in JAX).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .numbers import parse_spice_number
from .shapes import broadcast_shapes

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



# ---- behavioral expressions as postfix programs -------------------------
# An instruction is one int32: opcode | operand << 8.  PUSH_NUM's operand
# indexes the tape's literals, PUSH_PROBE's the probe values, PUSH_CONST's
# the source's slice of params["b_consts"].  POWC is ** (or pow) whose
# exponent depends on no probe: its exponent partial is never formed, so
# x ** 3.0 at x = -2 has gradient 12 where the log(x) x^y term would be NaN.
OPS = ("PUSH_NUM", "PUSH_PROBE", "PUSH_TIME", "PUSH_CONST", "NEG",
       "ADD", "SUB", "MUL", "DIV", "MOD", "POW", "POWC",
       "SIN", "COS", "TAN", "ASIN", "ACOS", "ATAN", "SINH", "COSH", "TANH",
       "EXP", "LOG", "LOG10", "SQRT", "ABS", "FLOOR", "CEIL",
       "ATAN2", "MIN", "MAX")
OP = {name: i for i, name in enumerate(OPS)}
_BIN_OPS = {"+": "ADD", "-": "SUB", "*": "MUL", "/": "DIV", "%": "MOD"}
_CALL_OPS = {"ln": "LOG", "log": "LOG", "atan2": "ATAN2", "min": "MIN",
             "max": "MAX"}
INV_LN10 = 0.4342944819032518   # jnp.log10 = log(x) * (1 / log(10))


@dataclasses.dataclass(frozen=True)
class Tape:
    """A compiled behavioral expression: ``ops`` (int32 instructions),
    ``lits`` (float64 literals) and ``depth`` (the stack depth it needs)."""
    ops: np.ndarray
    lits: np.ndarray
    depth: int


def compile_tape(ast, ref_index: Dict[tuple, int],
                 const_index: Optional[Dict[str, int]] = None) -> Tape:
    """Compile an AST of ``parse_expr(s, probes=True)`` to a ``Tape``.

    ref_index maps probe tuples (as from ``probe_refs``, without
    ("time",)) to their position in the probe values; const_index maps
    referenced .PARAM names to their position in the source's constants.
    As in ``compile_jax``, an operator between two literals (numbers, pi,
    e) is folded in Python floats at compile time; calls are not."""
    ci = {k.lower(): v for k, v in (const_index or {}).items()}
    ops: List[int] = []
    lits: List[float] = []
    depth = [0, 0]              # current, maximum

    def emit(name, arg=0, pushes=0):
        ops.append(OP[name] | (arg << 8))
        depth[0] += pushes
        depth[1] = max(depth[1], depth[0])

    def literal(a):
        """The Python float of a literal subtree, else None."""
        k = a[0]
        if k == "num":
            return a[1]
        if k == "name" and a[1].lower() in _CONSTS \
                and a[1].lower() not in ci:
            return _CONSTS[a[1].lower()]
        if k == "neg":
            v = literal(a[1])
            return None if v is None else -v
        if k == "bin" and a[1] != "%":
            x, y = literal(a[2]), literal(a[3])
            if x is None or y is None:
                return None
            op = a[1]
            if op == "+":
                return x + y
            if op == "-":
                return x - y
            if op == "*":
                return x * y
            if op == "/":
                return x / y
            return x ** y
        return None

    def probed(a):
        """Does the subtree read a probe?"""
        k = a[0]
        if k in ("probe_v", "probe_i"):
            return True
        if k == "neg":
            return probed(a[1])
        if k == "bin":
            return probed(a[2]) or probed(a[3])
        if k == "call":
            return any(probed(x) for x in a[2])
        return False

    def walk(a):
        v = literal(a)
        if v is not None:
            lits.append(float(v))
            emit("PUSH_NUM", len(lits) - 1, 1)
            return
        k = a[0]
        if k == "name":
            name = a[1].lower()
            if name == "time":
                emit("PUSH_TIME", 0, 1)
            elif name in ci:
                emit("PUSH_CONST", ci[name], 1)
            else:
                raise ExprError(f"undefined parameter {a[1]!r}")
        elif k in ("probe_v", "probe_i"):
            key = ("v", a[1], a[2]) if k == "probe_v" else ("i", a[1])
            emit("PUSH_PROBE", ref_index[key], 1)
        elif k == "neg":
            walk(a[1])
            emit("NEG")
        elif k == "bin":
            walk(a[2])
            walk(a[3])
            if a[1] == "**":
                emit("POW" if probed(a[3]) else "POWC", 0, -1)
            else:
                emit(_BIN_OPS[a[1]], 0, -1)
        elif k == "call":
            for x in a[2]:
                walk(x)
            name = a[1]
            if name == "pow":
                emit("POW" if probed(a[2][1]) else "POWC", 0, -1)
            elif len(a[2]) == 2:
                emit(_CALL_OPS[name], 0, -1)
            else:
                emit(_CALL_OPS.get(name, name.upper()))
        else:
            raise ExprError(f"cannot compile node {a!r}")

    walk(ast)
    return Tape(ops=np.asarray(ops, np.int32),
                lits=np.asarray(lits, np.float64), depth=depth[1])


def eval_tape(tape: Tape, vals, t, consts):
    """Value and gradient of a compiled expression over any lane shape:
    vals (..., m) probe values, t the time (a float or a tensor), consts
    (..., n) the source's constants -> (e0 (...), grads (..., m)).

    Each stack entry is a value and its partials in the probes it depends
    on; a partial outside that set is a symbolic zero that no rule
    multiplies (as in JAX's jvp), so sqrt(v1) + v2 at v1 = 0 has the
    v2-partial 1, not inf * 0.  The rules are JAX's
    (``jax/_src/lax/lax.py``): abs' = 1 at 0, min/max split a tie 0.5/0.5,
    floor' = ceil' = 0, fmod's x-partial 1, a probed exponent's partial
    log(x or 1) x^y.  Literals and a probe's unit partial stay Python
    floats (scalars to the device kernels, no tensor per push)."""
    import torch

    dtype, dev = vals.dtype, vals.device
    rules = _unary_rules()
    stack = []

    def ten(v):
        """A Python float as a 0-dim host tensor of the working type."""
        return v if isinstance(v, torch.Tensor) else torch.tensor(
            v, dtype=dtype)

    def tie(x, y, r):
        one = torch.ones_like(r)
        return torch.where(x == r, one, 0.0) / torch.where(y == r, 2.0, one)

    def abs_rule(g, a, r):
        if not isinstance(g, torch.Tensor):
            g = torch.full_like(a, g)
        return torch.where(a >= 0.0, g, -g)

    binary_rules = {
        "ADD": (lambda a, b: a + b, lambda g, a, b, r: g,
                lambda g, a, b, r: g),
        "SUB": (lambda a, b: a - b, lambda g, a, b, r: g,
                lambda g, a, b, r: -g),
        "MUL": (lambda a, b: a * b, lambda g, a, b, r: g * b,
                lambda g, a, b, r: a * g),
        "DIV": (lambda a, b: a / b, lambda g, a, b, r: g / b,
                lambda g, a, b, r: (-g * a) * (1.0 / (b * b))),
        "MOD": (lambda a, b: torch.fmod(ten(a), ten(b)),
                lambda g, a, b, r: g,
                lambda g, a, b, r: -g * (torch.sign(a / b)
                                         * torch.floor(torch.abs(a / b)))),
        "POW": (lambda a, b: torch.pow(ten(a), ten(b)),
                lambda g, a, b, r: g * (b * torch.pow(ten(a), b - 1.0)),
                lambda g, a, b, r: g * (torch.log(torch.where(
                    ten(a) == 0.0, 1.0, ten(a))) * r)),
        "ATAN2": (lambda a, b: torch.atan2(ten(a), ten(b)),
                  lambda g, a, b, r: g * (b / (a * a + b * b)),
                  lambda g, a, b, r: g * (-a / (a * a + b * b))),
        "MIN": (lambda a, b: torch.minimum(ten(a), ten(b)),
                lambda g, a, b, r: g * tie(a, b, r),
                lambda g, a, b, r: g * tie(b, a, r)),
        "MAX": (lambda a, b: torch.maximum(ten(a), ten(b)),
                lambda g, a, b, r: g * tie(a, b, r),
                lambda g, a, b, r: g * tie(b, a, r)),
    }
    binary_rules["POWC"] = binary_rules["POW"][:2] + (None,)

    for word in tape.ops.tolist():
        code, arg = OPS[word & 0xFF], word >> 8
        if code == "PUSH_NUM":
            stack.append((float(tape.lits[arg]), {}))
        elif code == "PUSH_PROBE":
            stack.append((vals[..., arg], {arg: 1.0}))
        elif code == "PUSH_TIME":
            stack.append((t, {}))
        elif code == "PUSH_CONST":
            stack.append((consts[..., arg], {}))
        elif code == "NEG":
            a, da = stack.pop()
            stack.append((-a, {j: -g for j, g in da.items()}))
        elif code in binary_rules:
            # pop b, a; the partials of probes in both sum the two terms
            val, ra, rb = binary_rules[code]
            b, db = stack.pop()
            a, da = stack.pop()
            r = val(a, b)
            d = {}
            for j in sorted(set(da) | set(db)):
                terms = []
                if j in da:
                    terms.append(ra(da[j], a, b, r))
                if j in db and rb is not None:
                    terms.append(rb(db[j], a, b, r))
                d[j] = terms[0] if len(terms) == 1 else terms[0] + terms[1]
            stack.append((r, d))
        elif code in ("FLOOR", "CEIL"):
            a, _ = stack.pop()
            fn = torch.floor if code == "FLOOR" else torch.ceil
            stack.append((fn(ten(a)), {}))
        else:
            fn, rule = ((torch.abs, abs_rule) if code == "ABS"
                        else rules[code])
            a, da = stack.pop()
            a = ten(a)
            r = fn(a)
            stack.append((r, {j: rule(g, a, r) for j, g in da.items()}))
    (e0, d), = stack
    e0 = ten(e0).to(dev)
    lead = vals.shape[:-1]
    if e0.dim() and e0.shape != lead:
        lead = broadcast_shapes(e0.shape, lead)
    grads = [d[j].to(dev).expand(lead) if isinstance(d.get(j), torch.Tensor)
             else torch.full(lead, d.get(j, 0.0), dtype=dtype, device=dev)
             for j in range(vals.shape[-1])]
    grads = (torch.stack(grads, -1) if grads else
             torch.zeros(lead + (0,), dtype=dtype, device=dev))
    return e0.expand(lead), grads


@functools.lru_cache(maxsize=None)
def _unary_rules():
    """opcode -> (value function, partial rule(g, a, r)) of the unary
    functions, r the value."""
    import torch

    def rsqrt1m(a):
        return torch.rsqrt(1.0 - a * a)

    return {
        "SIN": (torch.sin, lambda g, a, r: g * torch.cos(a)),
        "COS": (torch.cos, lambda g, a, r: -(g * torch.sin(a))),
        "TAN": (torch.tan, lambda g, a, r: g * (1.0 + r * r)),
        "ASIN": (torch.asin, lambda g, a, r: g * rsqrt1m(a)),
        "ACOS": (torch.acos, lambda g, a, r: g * -rsqrt1m(a)),
        "ATAN": (torch.atan, lambda g, a, r: g / (1.0 + a * a)),
        "SINH": (torch.sinh, lambda g, a, r: g * torch.cosh(a)),
        "COSH": (torch.cosh, lambda g, a, r: g * torch.sinh(a)),
        "TANH": (torch.tanh, lambda g, a, r: (g + g * r) * (1.0 - r)),
        "EXP": (torch.exp, lambda g, a, r: g * r),
        "LOG": (torch.log, lambda g, a, r: g / a),
        "LOG10": (lambda a: torch.log(a) * INV_LN10,
                  lambda g, a, r: (g / a) * INV_LN10),
        "SQRT": (torch.sqrt, lambda g, a, r: g * (0.5 / r)),
    }

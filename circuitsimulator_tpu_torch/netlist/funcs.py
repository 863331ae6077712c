"""`.FUNC` user-defined expression functions (extension).

Text-level macro expansion, the same tier as `.INCLUDE`
(netlist/include.py): it runs in Simulator.from_file/from_text before
either frontend parses, so the pure-Python and native C++ parsers see
identical, fully-expanded input and need no .FUNC knowledge of their own.

    .FUNC fmax(a,b) {0.5*(a+b+abs(a-b))}
    .FUNC sq(x)=x*x                       (ngspice `=` form)

Calls expand by textual substitution with parenthesized arguments
(ngspice semantics: `sq(1+2)` -> `((1+2)*(1+2))`), wherever parameter
expressions are evaluated:

- inside every `{...}` brace group on any line,
- anywhere on a `.PARAM` line,
- in a behavioral `B` source expression (after its `V=`/`I=`).

Functions may call other .FUNCs (bounded depth); a later definition of
the same name wins; names shadowing the builtin expression functions
(utils/expr.py) are rejected with a warning.  Definition lines are
replaced by comments so downstream line numbers are preserved.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Tuple

from ..utils.expr import _FUNCS1, _FUNCS2

_MAX_DEPTH = 8
_DEF_RE = re.compile(r"^\s*([A-Za-z_]\w*)\s*\(([^)]*)\)\s*=?\s*(.*)$")
_CALL_RE = re.compile(r"(?<![\w.])([A-Za-z_]\w*)\s*\(")


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr)


def _parse_def(body_text: str):
    m = _DEF_RE.match(body_text)
    if not m:
        return None
    name = m.group(1).lower()
    params = [a.strip().lower() for a in m.group(2).split(",") if a.strip()]
    body = m.group(3).strip()
    if body.startswith("{") and body.endswith("}"):
        body = body[1:-1].strip()
    if not body:
        return None
    return name, params, body


def _expand_calls(s: str, funcs: Dict[str, Tuple[List[str], str]],
                  depth: int = 0) -> str:
    if depth > _MAX_DEPTH:
        _warn(f".FUNC expansion depth exceeded in {s!r}")
        return s
    out = []
    i = 0
    while i < len(s):
        m = _CALL_RE.search(s, i)
        if not m:
            out.append(s[i:])
            break
        name = m.group(1).lower()
        if name not in funcs:
            out.append(s[i:m.end()])
            i = m.end()
            continue
        # balanced-paren scan collecting top-level comma-separated args
        j = m.end()
        level = 1
        args, cur = [], []
        while j < len(s) and level:
            c = s[j]
            if c == "(":
                level += 1
                cur.append(c)
            elif c == ")":
                level -= 1
                if level:
                    cur.append(c)
            elif c == "," and level == 1:
                args.append("".join(cur))
                cur = []
            else:
                cur.append(c)
            j += 1
        if level:
            _warn(f"unbalanced parentheses in .FUNC call {name}(...)")
            out.append(s[i:])
            break
        args.append("".join(cur))
        params, body = funcs[name]
        if len(args) != len(params):
            _warn(f".FUNC {name} expects {len(params)} args, "
                  f"got {len(args)}")
            out.append(s[i:j])
            i = j
            continue
        repl = body
        for p, a in zip(params, args):
            repl = re.sub(rf"(?<![\w.]){re.escape(p)}(?![\w])",
                          "(" + a.strip() + ")", repl, flags=re.I)
        out.append(s[i:m.start()])
        # squeeze whitespace: the expansion may land in an unbraced
        # .PARAM expression where spaces would split tokens
        expanded = re.sub(r"\s+", "", _expand_calls(repl, funcs, depth + 1))
        out.append("(" + expanded + ")")
        i = j
    return "".join(out)


def _expand_line(line: str, funcs) -> str:
    stripped = line.lstrip()
    low = stripped.lower()
    if low.startswith(".param"):
        return _expand_calls(line, funcs)
    if low[:1] == "b":
        # behavioral source: expand the expression after V=/I=
        m = re.search(r"[vi]\s*=", line, re.I)
        if m:
            return line[: m.end()] + _expand_calls(line[m.end():], funcs)
        return line
    if "{" not in line:
        return line
    # expand inside each {...} group (groups may contain spaces)
    out = []
    i = 0
    while i < len(line):
        if line[i] != "{":
            out.append(line[i])
            i += 1
            continue
        level = 0
        j = i
        while j < len(line):
            if line[j] == "{":
                level += 1
            elif line[j] == "}":
                level -= 1
                if level == 0:
                    break
            j += 1
        if level:
            out.append(line[i:])
            break
        out.append("{" + _expand_calls(line[i + 1:j], funcs) + "}")
        i = j + 1
    return "".join(out)


def expand_funcs(text: str) -> str:
    """Collect `.FUNC` definitions (with `+` continuations) and expand all
    call sites; definition lines become comments.  No-op when the deck has
    no .FUNC card."""
    if ".func" not in text.lower():
        return text
    lines = text.split("\n")
    funcs: Dict[str, Tuple[List[str], str]] = {}
    consumed: List[int] = []
    i = 0
    while i < len(lines):
        if not lines[i].lstrip().lower().startswith(".func"):
            i += 1
            continue
        block = [i]
        body = lines[i].lstrip()[5:]
        j = i + 1
        while j < len(lines) and lines[j].lstrip().startswith("+"):
            body += " " + lines[j].lstrip()[1:]
            block.append(j)
            j += 1
        d = _parse_def(body)
        if d is None:
            _warn(f"invalid .FUNC definition: {lines[i].strip()!r}")
        elif d[0] in _FUNCS1 or d[0] in _FUNCS2:
            _warn(f".FUNC {d[0]} shadows a builtin function; ignored")
        else:
            funcs[d[0]] = (d[1], d[2])
        consumed.extend(block)
        i = j
    for k in consumed:
        lines[k] = "* " + lines[k]
    if not funcs:
        return "\n".join(lines)
    for k, line in enumerate(lines):
        if k in consumed or not line or line.lstrip()[:1] in ("*", ";"):
            continue
        lines[k] = _expand_line(line, funcs)
    return "\n".join(lines)

"""Hierarchical netlists: `.SUBCKT name ports... / .ENDS` + `Xinst`
instances (extension — the reference parser is flat-only), with scoped
subcircuit parameters (`PARAMS:` defaults + per-instance overrides).

Flattening is a statement-level rewrite that runs before parsing proper,
so every downstream stage (Python or native device parsing, lowering,
analyses) sees an ordinary flat netlist:

- instance element names keep their leading type letter (the device
  dispatch key): `R1` inside `X1` becomes `R1@X1`, nested `R1@X2@X1`;
- internal nodes become `<instancepath>.<node>`: `n` in `X1` -> `X1.n`;
  ports map to the caller's (already flattened) nets; ground names
  (`0`/`gnd`) are always global;
- `.MODEL` cards found inside a definition are hoisted to the top level
  (the model registry is global, matching the two-pass prescan);
- `.GLOBAL n1 [n2 ...]` declares nodes that keep their name inside every
  definition (supply rails) instead of being instance-scoped; ground
  (`0`/`gnd`) is always implicitly global;
- other dot cards inside a definition are ignored with a warning —
  EXCEPT `.PARAM`, which defines instance-local parameters;
- nested instances are supported to MAX_DEPTH; nested *definitions* are
  not (a warning is emitted and the inner definition is still registered
  globally, which matches most SPICE dialects' effective behavior).

Parameter scoping (extension, ngspice-flavored):

- `.SUBCKT name p1 p2 PARAMS: w=1k l={w*2}` declares defaults; the
  `PARAMS:` keyword is optional (any `name=expr` token after the port
  list starts the default block).  Defaults are evaluated left-to-right
  and may reference global `.PARAM` values and earlier defaults.
- `X1 a b name PARAMS: w=2k` (keyword again optional) overrides
  defaults; override expressions are evaluated in the CALLER's scope,
  so a parent subcircuit can pass its own parameters down
  (`X2 p q name w={w/2}` inside another definition).
- `.PARAM` cards inside a definition body are instance-local.
- Inside an expanded body every `{expr}` is substituted with its value
  under scope = global `.PARAM` table (with any `.STEP` overrides)
  overlaid with the instance's bindings.  Braces that do not evaluate
  (e.g. referencing nothing in scope) are left untouched for the
  parser's global substitution pass, which owns the warning.

Top-level statements are never rewritten here beyond X expansion — the
parser's own `.PARAM` pre-pass (netlist/parser.py:290) handles them, so
flat netlists behave exactly as before.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, Tuple

from .lexer import Statement
from ..utils.numbers import is_ground_name

MAX_DEPTH = 20

# token index ranges [lo, hi) holding node names, keyed by element letter
_NODE_RANGES = {
    "R": (1, 3), "C": (1, 3), "L": (1, 3), "V": (1, 3), "I": (1, 3),
    "M": (1, 4), "D": (1, 3), "Q": (1, 4), "E": (1, 5), "G": (1, 5),
    "F": (1, 3), "H": (1, 3), "S": (1, 5), "W": (1, 3), "J": (1, 4),
    "T": (1, 5),
    # B: only the two terminal tokens are renamed; v()/i() references
    # inside the expression are NOT rewritten (they resolve at lowering,
    # so a reference to a subckt-internal node fails loudly there)
    "B": (1, 3),
}
# token indices referring to another element (renamed like element names)
_ELEM_REFS = {"F": (3,), "H": (3,), "K": (1, 2), "W": (3,)}


def _warn(line_no: int, msg: str) -> None:
    print(f"Line {line_no}: {msg}", file=sys.stderr)


def _merge_brace_groups(tokens: List[str]) -> List[str]:
    """Re-join tokens so each {...} group (which may contain spaces)
    becomes part of a single token (mirror of the parser's)."""
    out: List[str] = []
    buf = None
    depth = 0
    for tok in tokens:
        if buf is None:
            if "{" not in tok or tok.count("{") == tok.count("}"):
                out.append(tok)
                continue
            buf = tok
            depth = tok.count("{") - tok.count("}")
        else:
            buf += " " + tok
            depth += tok.count("{") - tok.count("}")
        if depth <= 0:
            out.append(buf)
            buf = None
    if buf is not None:
        out.append(buf)          # unbalanced; surfaces as a parse error
    return out


def _split_assignments(tokens: List[str],
                       line_no: int) -> Tuple[List[str],
                                              List[Tuple[str, str]],
                                              List[str]]:
    """Partition a token tail into (plain tokens, [(name, expr)], raw
    assignment tokens).  The assignment block starts at the first
    `PARAMS:` keyword or `name=expr` token; `=` may be space-padded."""
    text = re.sub(r"\s*=\s*", "=", " ".join(tokens))
    plain: List[str] = []
    assigns: List[Tuple[str, str]] = []
    raw: List[str] = []
    in_assigns = False
    for tok in _merge_brace_groups(text.split()):
        if tok.lower() in ("params:", "param:"):
            in_assigns = True
            continue
        if "=" in tok:
            in_assigns = True
            name, expr = tok.split("=", 1)
            expr = expr.strip()
            if expr.startswith("{") and expr.endswith("}"):
                expr = expr[1:-1]
            if not name or not expr:
                _warn(line_no, f"invalid parameter assignment: {tok!r}")
                continue
            assigns.append((name.lower(), expr))
            raw.append(tok)
        elif in_assigns:
            _warn(line_no, f"stray token {tok!r} after parameter "
                           "assignments; ignored")
        else:
            plain.append(tok)
    return plain, assigns, raw


def _split_instance(toks: List[str], line_no: int):
    """`Xn net... subname [PARAMS:] [name=expr ...]` ->
    (nets, subname, [(name, expr)], raw_assign_tokens).
    Returns None if malformed."""
    plain, assigns, raw = _split_assignments(toks[1:], line_no)
    if not plain:
        return None
    return plain[:-1], plain[-1], assigns, raw


def _eval_or_none(expr: str, scope: Dict[str, float]):
    from ..utils.expr import eval_expr, ExprError
    try:
        return eval_expr(expr, scope)
    except ExprError:
        return None


def _substitute_scoped(st: Statement, scope: Dict[str, float]) -> Statement:
    """Replace each {expr} group that evaluates under `scope`; groups
    that do not evaluate keep their token verbatim for the parser's
    global substitution pass (which owns the warning)."""
    if not any("{" in tok for tok in st.tokens):
        return st
    out: List[str] = []
    for tok in _merge_brace_groups(st.tokens):
        if "{" not in tok:
            out.append(tok)
            continue
        res: List[str] = []
        i = 0
        failed = False
        while i < len(tok):
            if tok[i] == "{":
                j = tok.find("}", i)
                if j < 0:
                    failed = True
                    break
                val = _eval_or_none(tok[i + 1:j], scope)
                if val is None:
                    failed = True
                    break
                res.append(repr(val))
                i = j + 1
            else:
                res.append(tok[i])
                i += 1
        out.append(tok if failed else "".join(res))
    return Statement(line_no=st.line_no, raw=" ".join(out), tokens=out)


def _rename(st: Statement, mapping: Dict[str, str], prefix: str,
            global_nodes=frozenset()) -> Statement:
    """Apply instance-context renaming to one body statement."""
    toks = list(st.tokens)
    c0 = toks[0][0].upper()
    toks[0] = f"{toks[0]}@{prefix}"

    def map_node(t: str) -> str:
        if is_ground_name(t) or t in global_nodes:
            return t
        if t in mapping:
            return mapping[t]
        return f"{prefix}.{t}"

    poly = (c0 in "EGFH" and len(toks) > 3
            and re.fullmatch(r"poly\((\d+)\)", toks[3].lower()))
    if c0 == "X":
        # only the net tokens are renamed; the subckt name and any
        # parameter assignments pass through untouched (the rebuilt
        # statement keeps only valid assignment tokens, so expand()'s
        # re-split cannot warn twice)
        split = _split_instance(toks, st.line_no)
        if split is not None:
            nets, subname, _, raw_assigns = split
            toks = ([toks[0]] + [map_node(t) for t in nets]
                    + [subname] + raw_assigns)
    elif poly:
        # POLY(n) controlled source: output nodes, then n node pairs (E/G)
        # or n controlling V-source names (F/H); coefficients untouched
        n = int(poly.group(1))
        toks[1] = map_node(toks[1])
        toks[2] = map_node(toks[2])
        if c0 in "EG":
            for j in range(4, min(4 + 2 * n, len(toks))):
                toks[j] = map_node(toks[j])
        else:
            for j in range(4, min(4 + n, len(toks))):
                toks[j] = f"{toks[j]}@{prefix}"
    else:
        lo, hi = _NODE_RANGES.get(c0, (1, 1))
        for j in range(lo, min(hi, len(toks))):
            toks[j] = map_node(toks[j])
        for j in _ELEM_REFS.get(c0, ()):
            if j < len(toks):
                toks[j] = f"{toks[j]}@{prefix}"
    return Statement(line_no=st.line_no, raw=" ".join(toks), tokens=toks)


def flatten_subcircuits(
        stmts: List[Statement],
        param_overrides: Optional[Dict[str, float]] = None,
) -> List[Statement]:
    """Collect .SUBCKT definitions and expand X instances recursively."""
    # defs: name -> (ports, [(param, default_expr)], body)
    defs: Dict[str, Tuple[List[str], List[Tuple[str, str]],
                          List[Statement]]] = {}
    top: List[Statement] = []

    def collect(seq: List[Statement], sink: List[Statement],
                nested: bool) -> None:
        i = 0
        while i < len(seq):
            st = seq[i]
            head = st.tokens[0].lower() if st.tokens else ""
            if head == ".subckt":
                if nested:
                    _warn(st.line_no, "nested .SUBCKT definition; "
                          "registering it globally")
                if len(st.tokens) < 2:
                    _warn(st.line_no, f"invalid .SUBCKT: {st.raw}")
                name = st.tokens[1].lower() if len(st.tokens) > 1 else ""
                body: List[Statement] = []
                depth = 1
                i += 1
                while i < len(seq):
                    h2 = seq[i].tokens[0].lower() if seq[i].tokens else ""
                    if h2 == ".subckt":
                        depth += 1
                    elif h2 == ".ends":
                        depth -= 1
                        if depth == 0:
                            break
                    body.append(seq[i])
                    i += 1
                else:
                    _warn(st.line_no, f".SUBCKT {name} missing .ENDS")
                i += 1  # skip the .ends
                inner: List[Statement] = []
                collect(body, inner, nested=True)
                if name:
                    ports, defaults, _ = _split_assignments(
                        st.tokens[2:], st.line_no)
                    defs[name] = (ports, defaults, inner)
            elif head == ".ends":
                _warn(st.line_no, ".ENDS without .SUBCKT; ignored")
                i += 1
            elif head == ".model":
                # global model registry: hoist out of definitions
                top.append(st) if nested else sink.append(st)
                i += 1
            else:
                sink.append(st)
                i += 1

    collect(stmts, top, nested=False)
    # `.GLOBAL` cards (extension): nodes that keep their name inside
    # every definition (supply rails); the cards themselves are dropped
    global_nodes = set()
    kept = []
    for st in top:
        if st.tokens and st.tokens[0].lower() == ".global":
            global_nodes.update(st.tokens[1:])
        else:
            kept.append(st)
    top = kept
    if not defs and not any(
            st.tokens and st.tokens[0][0].upper() == "X" for st in top):
        return top

    # global `.PARAM` table (same resolution as the parser's pre-pass:
    # last definition wins, forward references by iteration, `.STEP`
    # overrides pre-seeded) — so instance bindings and body braces see
    # the same values the parser will
    gdefs: List[Tuple[str, str]] = []
    for st in top:
        if st.tokens and st.tokens[0].lower() == ".param":
            _, assigns, _ = _split_assignments(st.tokens[1:], st.line_no)
            gdefs.extend(assigns)
    table: Dict[str, str] = {}
    for n, e in gdefs:
        table[n] = e
    global_values: Dict[str, float] = {
        k.lower(): float(v) for k, v in (param_overrides or {}).items()}
    for _ in range(len(table) + 1):
        missing = [n for n in table if n not in global_values]
        if not missing:
            break
        progress = False
        for n in missing:
            v = _eval_or_none(table[n], global_values)
            if v is not None:
                global_values[n] = v
                progress = True
        if not progress:
            break

    out: List[Statement] = []

    def expand(st: Statement, depth: int,
               caller_scope: Dict[str, float]) -> None:
        toks = st.tokens
        if not toks or toks[0][0].upper() != "X":
            out.append(st)
            return
        if depth > MAX_DEPTH:
            _warn(st.line_no, "subcircuit nesting too deep (cycle?); "
                  f"dropping {toks[0]}")
            return
        if len(toks) < 2:
            _warn(st.line_no, f"invalid instance: {st.raw}")
            return
        split = _split_instance(toks, st.line_no)
        if split is None:
            _warn(st.line_no, f"invalid instance: {st.raw}")
            return
        nets, subtok, overrides, _ = split
        subname = subtok.lower()
        if subname not in defs:
            _warn(st.line_no, f"unknown subcircuit {subtok!r}; "
                  f"dropping {toks[0]}")
            return
        ports, defaults, body = defs[subname]
        if len(nets) != len(ports):
            _warn(st.line_no,
                  f"{toks[0]}: {len(nets)} nets for {len(ports)} ports "
                  f"of {subname}; dropping instance")
            return
        mapping = dict(zip(ports, nets))
        # bind parameters: defaults left-to-right (may reference globals
        # and earlier defaults), then instance overrides evaluated in the
        # CALLER's scope
        bindings: Dict[str, float] = {}
        default_names = {n for n, _ in defaults}
        for n, e in defaults:
            v = _eval_or_none(e, {**global_values, **bindings})
            if v is None:
                _warn(st.line_no, f"{toks[0]}: cannot resolve default "
                                  f"{n}={e!r} of {subname}")
            else:
                bindings[n] = v
        for n, e in overrides:
            if n not in default_names:
                _warn(st.line_no, f"{toks[0]}: {n!r} is not a parameter "
                                  f"of {subname}; binding anyway")
            v = _eval_or_none(e, caller_scope)
            if v is None:
                _warn(st.line_no, f"{toks[0]}: cannot resolve parameter "
                                  f"{n}={e!r}")
            else:
                bindings[n] = v
        scope = {**global_values, **bindings}
        # instance-local `.PARAM` cards: order-independent within the
        # body (same forward-reference iteration as the global table)
        ldefs: List[Tuple[str, str, int]] = []
        for bst in body:
            if bst.tokens and bst.tokens[0].lower() == ".param":
                _, assigns, _ = _split_assignments(bst.tokens[1:],
                                                   bst.line_no)
                ldefs.extend((n, e, bst.line_no) for n, e in assigns)
        ltable = {n: e for n, e, _ in ldefs}
        resolved: Dict[str, float] = {}
        for _ in range(len(ltable) + 1):
            todo = [n for n in ltable if n not in resolved]
            if not todo:
                break
            progress = False
            for n in todo:
                v = _eval_or_none(ltable[n], {**scope, **resolved})
                if v is not None:
                    resolved[n] = v
                    progress = True
            if not progress:
                break
        for n, e, ln in ldefs:
            if n not in resolved:
                _warn(ln, f"{toks[0]}: cannot resolve local "
                          f".PARAM {n}={e!r}")
        scope.update(resolved)
        for bst in body:
            if bst.tokens and bst.tokens[0].lower() == ".param":
                continue
            expand(_substitute_scoped(
                       _rename(bst, mapping, toks[0],
                               frozenset(global_nodes)),
                       scope),
                   depth + 1, scope)

    for st in top:
        expand(st, 0, global_values)
    return out

"""`E... LAPLACE` s-domain transfer-function sources (extension).

Text-level macro expansion (same tier as `.FUNC`/URC, shared by both
frontends):

    Ename out ref LAPLACE nc+ nc- b0 [b1 ...] / a0 [a1 ...]
    Gname out ref LAPLACE nc+ nc- b0 [b1 ...] / a0 [a1 ...]

realizes  V(out,ref) = H(s) * V(nc+,nc-)  (E form; the G form drives a
current  I(out->ref) = H(s) * V(nc+,nc-) through a POLY VCCS)  with
H(s) = (b0 + b1 s + ... + bm s^m)/(a0 + a1 s + ... + an s^n), m <= n,
as the controllable-canonical integrator chain built ONLY from existing
primitives — per state k a 1 F capacitor node `Ename.x<k>` plus VCCS
injections, and a POLY VCVS output:

    x_k' = x_{k+1}                (G 0 x_k x_{k+1} 0  1)
    x_n' = -sum a_{i-1}/a_n x_i + u
    y    = sum c_i x_i + d u,  d = b_n/a_n,  c_i = (b_{i-1} - a_{i-1} d)/a_n

Because the expansion is ordinary G/C/E elements, the source works in
every analysis (DC gain b0/a0, exact AC H(jw), transient convolution via
the integrators, noise shaping).  States are not frequency-normalized:
for an f0-scale filter the injection gms are O(f0) — fine in float64;
prefer re-normalizing very high-f0 coefficients by hand in float32.
"""

from __future__ import annotations

import re
import sys
from typing import List

from ..utils.numbers import parse_spice_number


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr)


def _collect_params(lines: List[str]):
    """Resolve .PARAM values at text level so LAPLACE coefficients may be
    `{expr}` groups (no spaces inside braces on these lines).  Mirrors the
    parser's fixed-point resolution for plain name=expr pairs."""
    from ..utils.expr import eval_expr, ExprError
    from .parser import NetlistParser
    table = {}
    for line in lines:
        t = line.split()
        if not t or t[0].lower() != ".param":
            continue
        text = re.sub(r"\s*=\s*", "=", " ".join(t[1:]))
        for tok in NetlistParser._merge_brace_groups(text.split()):
            if "=" not in tok:
                continue
            name, expr = tok.split("=", 1)
            expr = expr.strip()
            if expr.startswith("{") and expr.endswith("}"):
                expr = expr[1:-1]
            if name and expr:
                table[name.lower()] = expr
    values = {}
    for _ in range(len(table) + 1):
        progress = False
        for nm, expr in table.items():
            if nm in values:
                continue
            try:
                values[nm] = eval_expr(expr, values)
                progress = True
            except ExprError:
                pass
        if not progress:
            break
    return values


_PURE_NUM = re.compile(r"[+-]?[\d.]+([eE][+-]?\d+)?[a-zA-Z]*$")


def _coeff(tok: str, values) -> float:
    from ..utils.expr import eval_expr
    tok = tok.strip()
    if tok.startswith("{") and tok.endswith("}"):
        tok = tok[1:-1]
    # parse_spice_number is deliberately lenient (leading-number quirk),
    # so only route PURE numbers through it — anything else is an expr
    if _PURE_NUM.fullmatch(tok):
        return parse_spice_number(tok)
    return eval_expr(tok, values)       # ExprError surfaces to caller


def _expand_one(tokens: List[str], raw: str, values=None) -> List[str]:
    name = tokens[0]
    out_p, out_m = tokens[1], tokens[2]
    ncp, ncm = tokens[4], tokens[5]
    coeffs = tokens[6:]
    if "/" not in " ".join(coeffs):
        _warn(f"LAPLACE needs 'num / den' coefficients: {raw!r}")
        return [raw]
    # '/' may be glued to a number or stand alone; a '/' INSIDE a {...}
    # coefficient expression is division, not the num/den separator
    flat: List[str] = []
    for tok in coeffs:
        depth = 0
        cur: List[str] = []
        for ch in tok:
            if ch == "{":
                depth += 1
                cur.append(ch)
            elif ch == "}":
                depth -= 1
                cur.append(ch)
            elif ch == "/" and depth == 0:
                if cur:
                    flat.append("".join(cur))
                    cur = []
                flat.append("/")
            else:
                cur.append(ch)
        if cur:
            flat.append("".join(cur))
    if "/" not in flat:
        _warn(f"LAPLACE needs 'num / den' coefficients: {raw!r}")
        return [raw]
    split = flat.index("/")
    from ..utils.expr import ExprError
    try:
        num = [_coeff(tok, values or {}) for tok in flat[:split]]
        den = [_coeff(tok, values or {}) for tok in flat[split + 1:]
               if tok != "/"]
    except (ValueError, ExprError) as e:
        _warn(f"cannot parse LAPLACE coefficients: {e} in {raw!r}")
        return [raw]
    if not num or not den or den[-1] == 0.0:
        _warn(f"LAPLACE needs nonempty num and den (a_n != 0): {raw!r}")
        return [raw]
    n = len(den) - 1
    if len(num) > len(den):
        _warn(f"LAPLACE numerator order exceeds denominator: {raw!r}")
        return [raw]
    an = den[-1]
    alpha = [a / an for a in den[:-1]]              # alpha_0 .. alpha_{n-1}
    beta = [(num[i] if i < len(num) else 0.0) / an for i in range(n + 1)]
    d = beta[n]
    c = [beta[i] - alpha[i] * d for i in range(n)]  # c for x_1 .. x_n

    kind = name[0].upper()          # 'E' (VCVS out) or 'G' (VCCS out)
    if n == 0:
        # pure gain b0/a0
        return [f"* {raw}  (LAPLACE expanded: gain {d:.6g})",
                f"{kind}{name}.y {out_p} {out_m} {ncp} {ncm} {d:.9e}"]

    xs = [f"{name}.x{k}" for k in range(1, n + 1)]
    out = [f"* {raw}  (LAPLACE expanded: order {n})"]
    for k, node in enumerate(xs):
        out.append(f"C{name}.x{k + 1} {node} 0 1")
    for k in range(n - 1):                          # x_k' = x_{k+1}
        out.append(f"G{name}.i{k + 1} 0 {xs[k]} {xs[k + 1]} 0 1")
    for i in range(n):                              # x_n' feedback row
        if alpha[i] != 0.0:
            out.append(f"G{name}.f{i + 1} 0 {xs[-1]} {xs[i]} 0 "
                       f"{-alpha[i]:.9e}")
    out.append(f"G{name}.u 0 {xs[-1]} {ncp} {ncm} 1")
    ctrl = " ".join(f"{x} 0" for x in xs) + f" {ncp} {ncm}"
    cvals = " ".join(f"{v:.9e}" for v in c + [d])
    out.append(f"{kind}{name}.y {out_p} {out_m} POLY({n + 1}) "
               f"{ctrl} 0 {cvals}")
    return out


def expand_laplace(text: str) -> str:
    """Expand every `E... LAPLACE ...` line; no-op without the keyword."""
    if "laplace" not in text.lower():
        return text
    lines = text.split("\n")
    values = _collect_params(lines)
    out = []
    for line in lines:
        t = line.split()
        if (len(t) >= 7 and t[0][:1].lower() in ("e", "g")
                and t[3].lower() == "laplace"):
            out.extend(_expand_one(t, line, values))
        else:
            out.append(line)
    return "\n".join(out)

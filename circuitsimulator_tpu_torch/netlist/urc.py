"""`U` uniform-distributed-RC lines (URC, extension).

Text-level macro expansion, the same tier as `.INCLUDE`/`.FUNC`: a `U`
line plus its `.MODEL id URC` card expand into an N-lump RC pi-ladder
before either frontend parses, so both see identical primitive R/C
elements and need no URC knowledge of their own.

    Uname n1 n2 ncap model [L=len] [N=lumps]
    .MODEL id URC [RPERL=ohm/m] [CPERL=F/m] [L=len] [N=lumps]

Expansion (uniform lumping; SPICE3's geometric-progression refinement is
not replicated):

    total R = RPERL*L   split into N series resistors Uname.r<k>
    total C = CPERL*L   as a pi-ladder: C/(2N) at each end node,
                        C/N at each internal node, all to `ncap`
    internal nodes      Uname.n<k>

Defaults: RPERL=1000 ohm/m, CPERL=1e-12 F/m, L=1 m, N=5 (the `U` line's
L=/N= override the model's).  The Elmore delay of the expanded ladder
converges to the distributed line's 0.5*R*C as N grows.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List

from ..utils.numbers import parse_spice_number


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr)


def _kv(tokens: List[str]) -> Dict[str, float]:
    out = {}
    for tok in tokens:
        key, eq, val = tok.partition("=")
        if eq and val:
            try:
                out[key.lower()] = parse_spice_number(val)
            except ValueError:
                pass
    return out


def expand_urc(text: str) -> str:
    """Expand every U line against its `.MODEL id URC` card; both the U
    lines and the URC model cards become comments.  No-op without URC."""
    low = text.lower()
    if not re.search(r"^\s*u", low, re.M) or "urc" not in low:
        return text
    lines = text.split("\n")
    # pass 1: URC model cards (models may be defined after the U lines)
    models: Dict[str, Dict[str, float]] = {}
    model_lines = []
    for i, line in enumerate(lines):
        t = line.split()
        if (len(t) >= 3 and t[0].lower() == ".model"
                and t[2].lower().split("(")[0] == "urc"):
            models[t[1].lower()] = _kv(t[3:])
            model_lines.append(i)
    if not models:
        return text
    out = list(lines)
    for i in model_lines:
        out[i] = "* " + lines[i]
    for i, line in enumerate(lines):
        t = line.split()
        if not t or not t[0][:1].lower() == "u" or t[0].startswith("*"):
            continue
        if len(t) < 5:
            continue
        name, n1, n2, ncap = t[0], t[1], t[2], t[3]
        model = None
        for tok in t[4:]:
            if "=" not in tok and tok.lower() in models:
                model = models[tok.lower()]
                break
        if model is None:
            _warn(f"URC line references unknown model: {line.strip()!r}")
            continue
        over = _kv(t[4:])
        rperl = model.get("rperl", 1000.0)
        cperl = model.get("cperl", 1e-12)
        length = over.get("l", model.get("l", 1.0))
        n = int(over.get("n", model.get("n", 5.0)))
        n = max(1, n)
        r_tot, c_tot = rperl * length, cperl * length
        nodes = [n1] + [f"{name}.n{k}" for k in range(1, n)] + [n2]
        repl = [f"* {line.strip()}  (URC expanded: N={n}, "
                f"R={r_tot:.6g}, C={c_tot:.6g})"]
        # element names must start with their kind letter (dispatch is by
        # first character): R<U-name>.<k> / C<U-name>.<k>
        for k in range(n):
            repl.append(f"R{name}.{k + 1} {nodes[k]} {nodes[k + 1]} "
                        f"{r_tot / n:.9e}")
        for k, node in enumerate(nodes):
            frac = 0.5 if k in (0, len(nodes) - 1) else 1.0
            repl.append(f"C{name}.{k} {node} {ncap} "
                        f"{frac * c_tot / n:.9e}")
        out[i] = "\n".join(repl)
    return "\n".join(out)

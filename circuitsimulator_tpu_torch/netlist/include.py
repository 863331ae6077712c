"""`.INCLUDE` / `.LIB` file expansion (extension; the reference reads a
single netlist file only).

Runs as a *text* pre-processing pass before either frontend parses, so
the pure-Python and native C++ parsers see identical, fully-expanded
input (Simulator.from_file/from_text wire it in with the netlist's
directory as the search base).

Supported forms (case-insensitive, quoted or bare paths):

    .INCLUDE file        .INC file
    .LIB file            (same as .INCLUDE)
    .LIB file section    (splice only the `.LIB section` ... `.ENDL`
                          block of the file, ngspice-style)

Relative paths resolve against the directory of the including file, so
nested includes work the way SPICE decks expect.  Missing files and
include cycles warn to stderr and drop the line (the reference's
attitude to broken input: diagnose, skip, continue).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Set

MAX_DEPTH = 10


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr)


def _split_path(rest: str):
    """(path, remainder) from the text after the directive keyword.
    Quoted paths may contain spaces; bare paths end at whitespace."""
    rest = rest.strip()
    if rest and rest[0] in "'\"":
        q = rest[0]
        end = rest.find(q, 1)
        if end > 0:
            return rest[1:end], rest[end + 1:].strip()
    parts = rest.split(None, 1)
    if not parts:
        return "", ""
    return parts[0], parts[1].strip() if len(parts) > 1 else ""


def _extract_section(lines: List[str], section: str,
                     path: str) -> List[str]:
    """Lines between `.LIB <section>` and `.ENDL` in a library file."""
    out: List[str] = []
    inside = False
    low_sec = section.lower()
    for line in lines:
        toks = line.split()
        head = toks[0].lower() if toks else ""
        if not inside:
            if head == ".lib" and len(toks) >= 2 \
                    and toks[1].lower() == low_sec:
                inside = True
        else:
            if head in (".endl", ".endlib"):
                return out
            out.append(line)
    if not inside:
        _warn(f".LIB: section {section!r} not found in {path}")
    return out


def expand_includes(text: str, base_dir: str = ".",
                    _depth: int = 0,
                    _seen: Optional[Set[str]] = None) -> str:
    """Expanded netlist text; safe to call on decks without includes
    (returns the text unchanged apart from nothing at all — lines are
    only touched when a .INCLUDE/.LIB directive is found)."""
    if ".inc" not in text.lower() and ".lib" not in text.lower():
        return text
    seen = _seen if _seen is not None else set()
    out: List[str] = []
    for line in text.splitlines():
        toks = line.split()
        head = toks[0].lower() if toks else ""
        if head not in (".include", ".inc", ".lib"):
            out.append(line)
            continue
        if len(toks) < 2:
            _warn(f"invalid {head.upper()} line: {line.strip()!r}")
            continue
        if _depth >= MAX_DEPTH:
            _warn(f"{head.upper()}: max include depth exceeded; skipped")
            continue
        path, remainder = _split_path(line.split(None, 1)[1])
        if not path:
            _warn(f"invalid {head.upper()} line: {line.strip()!r}")
            continue
        full = path if os.path.isabs(path) else os.path.join(base_dir, path)
        full = os.path.normpath(full)
        section = (remainder.split()[0]
                   if head == ".lib" and remainder else None)
        key = (full, section)
        # `seen` is the stack of the CURRENT include chain only: the key is
        # removed after the recursive expansion, so diamond includes (two
        # siblings pulling the same library) splice twice like SPICE does,
        # while true cycles are still cut
        if key in seen:
            _warn(f"{head.upper()}: circular include of {full}; skipped")
            continue
        try:
            with open(full, "r", errors="replace") as f:
                sub = f.read()
        except OSError:
            _warn(f"cannot open {head.upper()} file {full}")
            continue
        seen.add(key)
        try:
            if section is not None:
                sub = "\n".join(_extract_section(sub.splitlines(), section,
                                                 full))
            out.append(expand_includes(sub, os.path.dirname(full),
                                       _depth + 1, seen))
        finally:
            seen.discard(key)
    return "\n".join(out)

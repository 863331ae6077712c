"""Netlist lexer: physical lines -> logical statements.

Behavioral contract (reference: src/parser.cpp:59-135 `NetlistParser::lex`):

- CR stripped from CRLF lines.
- ``$`` starts an inline comment (everything from the first ``$`` dropped).
- Lines whose first non-blank character is ``*`` or ``;`` are full-line
  comments and are skipped entirely (they do NOT break a continuation chain).
- A line whose first non-blank character is ``+`` continues the previous
  logical line (joined with a single space); a leading ``+`` with no previous
  logical line starts a new one from the remainder.
- Statements are whitespace-tokenized; empty statements dropped.
- Each statement records the line number of its first physical line.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Statement:
    line_no: int
    raw: str
    tokens: List[str]


def _strip_inline_comment(s: str) -> str:
    pos = s.find("$")
    return s if pos < 0 else s[:pos]


def _is_full_line_comment(s: str) -> bool:
    t = s.lstrip()
    return bool(t) and t[0] in "*;"


def lex_lines(lines) -> List[Statement]:
    stmts: List[Statement] = []
    logical = ""
    logical_start = 0

    def flush():
        nonlocal logical
        if not logical:
            return
        s = _strip_inline_comment(logical).strip()
        logical = ""
        if not s:
            return
        tokens = s.split()
        if tokens:
            stmts.append(Statement(line_no=logical_start, raw=s, tokens=tokens))

    for line_no, physical in enumerate(lines, start=1):
        physical = physical.rstrip("\n")
        if physical.endswith("\r"):
            physical = physical[:-1]
        s = _strip_inline_comment(physical).strip()
        if not s:
            continue
        if _is_full_line_comment(s):
            continue
        if s.startswith("+"):
            rest = s[1:].lstrip()
            if logical:
                logical += " " + rest
            else:
                logical_start = line_no
                logical = rest
        else:
            if logical:
                flush()
            logical_start = line_no
            logical = s
    flush()
    return stmts


def lex_text(text: str) -> List[Statement]:
    return lex_lines(text.splitlines())


def lex_file(path: str) -> List[Statement]:
    with open(path, "r", errors="replace") as f:
        return lex_lines(f)

"""SPICE number parsing.

Behavioral contract (reference: include/utils.hpp:20-74 `parseSpiceNumber`):
the token is lowercased, the longest numeric prefix is parsed like C++
``std::stod`` (sign, digits, optional fraction, optional complete exponent),
and any remainder is treated as a SPICE magnitude suffix.  Unknown suffixes
multiply by 1.  If the token has no leading numeric prefix, everything before
the first alphabetic character is parsed as the number instead (raising if
that is empty, mirroring the uncaught ``std::stod`` exception), with the rest
again treated as a suffix.  If the token contains neither a numeric prefix nor
an alphabetic character, 0.0 is returned.
"""

from __future__ import annotations

import re

_SUFFIX_FACTORS = {
    "f": 1e-15,
    "p": 1e-12,
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "k": 1e3,
    "meg": 1e6,
    "g": 1e9,
    "t": 1e12,
}

# std::stod-style longest numeric prefix: optional sign, then either
# "digits[.digits]" or ".digits", then an optional *complete* exponent.
_STOD_PREFIX = re.compile(r"^[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


def suffix_factor(suffix: str) -> float:
    return _SUFFIX_FACTORS.get(suffix, 1.0)


def parse_spice_number(token: str) -> float:
    s = token.lower()
    m = _STOD_PREFIX.match(s)
    if m and m.group(0):
        base = float(m.group(0))
        rest = s[m.end():]
        if not rest:
            return base
        return base * suffix_factor(rest)

    # No numeric prefix: find the first alphabetic character and treat the
    # part before it as the number (utils.hpp:47-72 fallback).
    pos = None
    for i, c in enumerate(s):
        if c.isalpha():
            pos = i
            break
    if pos is None:
        return 0.0
    head = s[:pos]
    m2 = _STOD_PREFIX.match(head)
    if not (m2 and m2.group(0)):
        raise ValueError(f"cannot parse number: {token!r}")
    return float(m2.group(0)) * suffix_factor(s[pos:])


def is_ground_name(name: str) -> bool:
    """Ground detection by *name* (utils.hpp:76-79)."""
    low = name.lower()
    return low == "0" or low == "gnd"


def clamp01(x: float) -> float:
    if x < 0.0:
        return 0.0
    if x > 1.0:
        return 1.0
    return x

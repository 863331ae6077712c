"""Netlist frontend: SPICE lexer, parser and the text expansions.

The port keeps its own copy of the frontend (``lexer``, ``parser``,
``circuit``, ``subckt``, ``include``, ``funcs``, ``urc``, ``laplace`` and
``utils/numbers.py``, ``utils/expr.py``), taken from the JAX package, which
remains the reference it is tested against (tests/test_torch_frontend.py).
"""

from __future__ import annotations

import os

from ..utils.numbers import is_ground_name, parse_spice_number
from .circuit import (Circuit, KIND_B, KIND_C, KIND_D, KIND_E, KIND_F,
                      KIND_G, KIND_H, KIND_I, KIND_J, KIND_K, KIND_L, KIND_M,
                      KIND_Q, KIND_R, KIND_S, KIND_T, KIND_V, KIND_W,
                      WAVE_EXP, WAVE_NONE, WAVE_PULSE, WAVE_PWL, WAVE_SFFM,
                      WAVE_SIN)
from .funcs import expand_funcs
from .include import expand_includes
from .laplace import expand_laplace
from .parser import parse_netlist_text
from .urc import expand_urc


def read_netlist(path: str) -> str:
    """Read a deck and expand .INCLUDE/.LIB, .FUNC, URC and Laplace cards,
    the text pipeline of the JAX ``Simulator.from_file``."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    return expand_text(text, os.path.dirname(os.path.abspath(path)))


def expand_text(text: str, base_dir: str = ".") -> str:
    return expand_laplace(expand_urc(expand_funcs(
        expand_includes(text, base_dir))))

"""Netlist frontend, shared with the JAX package without importing JAX.

The frontend (``circuitsimulator_tpu/netlist/*.py`` with
``utils/numbers.py`` and ``utils/expr.py``) is pure Python, but importing it
as ``circuitsimulator_tpu.netlist`` would run ``circuitsimulator_tpu/__init__``,
which imports the JAX simulator.  So the JAX package's directory is
registered here under a private alias package whose ``__init__`` is never
executed: ``parser.py``'s relative imports resolve inside the alias and one
copy of the frontend serves both packages.  The real name
``circuitsimulator_tpu`` is never touched, so both packages can live in one
process.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types

_ALIAS = "_circuitsimulator_tpu_frontend"


def _frontend_package() -> types.ModuleType:
    pkg = sys.modules.get(_ALIAS)
    if pkg is not None:
        return pkg
    # find_spec locates the top-level package without executing it
    spec = importlib.util.find_spec("circuitsimulator_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise ImportError("the netlist frontend lives in the circuitsimulator_tpu "
                          "package, which is not importable from sys.path")
    pkg = types.ModuleType(_ALIAS, "alias of circuitsimulator_tpu "
                           "(frontend modules only; __init__ not run)")
    pkg.__path__ = list(spec.submodule_search_locations)
    pkg.__package__ = _ALIAS
    sys.modules[_ALIAS] = pkg
    return pkg


def _frontend(name: str) -> types.ModuleType:
    _frontend_package()
    return importlib.import_module(f"{_ALIAS}.{name}")


_parser = _frontend("netlist.parser")
_circuit = _frontend("netlist.circuit")

parse_netlist_text = _parser.parse_netlist_text
Circuit = _circuit.Circuit
expand_includes = _frontend("netlist.include").expand_includes
expand_funcs = _frontend("netlist.funcs").expand_funcs
expand_urc = _frontend("netlist.urc").expand_urc
expand_laplace = _frontend("netlist.laplace").expand_laplace
_numbers = _frontend("utils.numbers")
is_ground_name = _numbers.is_ground_name
parse_spice_number = _numbers.parse_spice_number

KIND_R, KIND_C, KIND_L = _circuit.KIND_R, _circuit.KIND_C, _circuit.KIND_L
KIND_V, KIND_I, KIND_M = _circuit.KIND_V, _circuit.KIND_I, _circuit.KIND_M
KIND_D, KIND_Q, KIND_J = _circuit.KIND_D, _circuit.KIND_Q, _circuit.KIND_J
KIND_E, KIND_G, KIND_F = _circuit.KIND_E, _circuit.KIND_G, _circuit.KIND_F
KIND_H, KIND_K, KIND_T = _circuit.KIND_H, _circuit.KIND_K, _circuit.KIND_T
KIND_S, KIND_W, KIND_B = _circuit.KIND_S, _circuit.KIND_W, _circuit.KIND_B
WAVE_NONE, WAVE_PULSE = _circuit.WAVE_NONE, _circuit.WAVE_PULSE
WAVE_SIN, WAVE_PWL = _circuit.WAVE_SIN, _circuit.WAVE_PWL
WAVE_EXP, WAVE_SFFM = _circuit.WAVE_EXP, _circuit.WAVE_SFFM


def read_netlist(path: str) -> str:
    """Read a deck and expand .INCLUDE/.LIB, .FUNC, URC and Laplace cards,
    the text pipeline of the JAX ``Simulator.from_file``."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    return expand_text(text, os.path.dirname(os.path.abspath(path)))


def expand_text(text: str, base_dir: str = ".") -> str:
    return expand_laplace(expand_urc(expand_funcs(
        expand_includes(text, base_dir))))
